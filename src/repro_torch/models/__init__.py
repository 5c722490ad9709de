"""Model code of the port: the all-full-attention GQA decoders with a dense
FFN (smollm, olmo, starcoder2, chameleon), over dense caches or a paged
pool."""
from .common import resolve_device
from .model import forward, init, loss_fn, param_specs
