"""Model code of the port: the dense GQA family (smollm), over dense caches
or a paged pool."""
from .common import resolve_device
from .model import forward, init, param_specs
