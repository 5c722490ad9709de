"""Model code of the port: GQA decoders with a dense FFN (smollm, olmo,
starcoder2, chameleon, and gemma3's windowed and global layers), over dense
caches or a paged pool (beside ring caches for windowed layers)."""
from .common import resolve_device
from .model import forward, init, loss_fn, param_specs
