from .kernel import build, build_bwd, flash_attention, flash_attention_bwd
from .ops import flash_attention_bshd
from .ref import (attention_lse_ref, flash_attention_bwd_ref,
                  flash_attention_ref)
