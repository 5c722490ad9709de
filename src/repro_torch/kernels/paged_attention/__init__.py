from .kernel import build, paged_attention
from .ops import dense_to_pages, streamed_pages_per_step
from .ref import paged_attention_ref
