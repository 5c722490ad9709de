from .kernel import build, flash_attention
from .ops import flash_attention_bshd
from .ref import flash_attention_ref
