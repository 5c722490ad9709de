"""Flash prefill attention: wrapper of the hand-written CUDA kernels.

The source, ``repro_torch/csrc/flash_attention.cu``, replaces the Pallas
TPU kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``
with two kernels chosen by dtype: bf16 runs on the tensor cores (``wgmma``
fed by TMA, 128-row query tiles against K/V tiles of 128 keys, 64 at
D = 128; fp32 online softmax; P.V as two bf16 products of P split into hi
and lo parts), f32 on the CUDA cores in fp32.  The source's header note says what bounds each and
what the design does about that.  It is built at first use with ``nvcc``
for ``sm_90a`` (``repro_torch.kernels._nvcc``).

``flash_attention`` takes its plain version (``ref.flash_attention_ref``)
only when every tensor it is given lies on the CPU.  For CUDA tensors it
launches the kernel of their dtype or raises; ``launches`` counts every
launch and ``tc_launches`` the tensor-core kernel's alone.  It reads q, k
and v through their strides (head_dim contiguous) and can write into a
strided ``out``, so the model layout (B,S,H,D) needs no copy
(``ops.flash_attention_bshd``).  The bf16 kernel reads q, k and v by TMA,
which needs 16-byte aligned bases and strides (``tma_strides``); anything
else raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from .._nvcc import CSRC, build_library
from .ref import flash_attention_ref

# kernel launches made by ``flash_attention`` (CPU calls do not count):
# every launch, and the tensor-core (bf16) kernel's alone
launches = 0
tc_launches = 0

HEAD_DIMS = (16, 64, 128)        # template instances in the source
_SRC = CSRC / "flash_attention.cu"
_ENTRY = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_tc_launch"}
_lib = None
_lock = threading.Lock()
build_log = ""          # nvcc's output (-Xptxas -v) of the last build here


def build():
    """Compile the kernel for sm_90a (once per source version) and return
    the shared library's path."""
    global build_log
    lib, log = build_library(_SRC)
    build_log = log or build_log
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                               + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            lib.flash_attention_smem.argtypes = [ctypes.c_int] * 2
            lib.flash_attention_smem.restype = ctypes.c_int
            lib.flash_attention_error_string.argtypes = [ctypes.c_int]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def smem_bytes(tc: bool, D: int) -> int:
    """Dynamic shared memory of one block of the tensor-core (``tc``) or
    the f32 kernel at head dim D, as the library launches it."""
    return _load().flash_attention_smem(int(tc), D)


def tma_strides(shape, strides, itemsize, data_ptr):
    """The (b, h, s) element strides with which the bf16 kernel reads (q,
    k, v by TMA) or writes (out, in bf16 pairs) a (B, heads, S, D) tensor.

    A dim of size 1 is never stepped over, so torch may give it any stride:
    it gets the stride of a contiguous tensor of that shape.  TMA needs a
    16-byte aligned base and strides that are positive multiples of 16
    bytes; anything else raises ``ValueError`` (there is no other route for
    bf16 on the card)."""
    B, heads, S, D = shape
    dense = (heads * S * D, S * D, D)
    if data_ptr % 16:
        raise ValueError(f"the bf16 kernel reads by TMA, which needs a "
                         f"16-byte aligned base; got address {data_ptr:#x}")
    out = []
    for size, stride, fill in zip((B, heads, S), strides[:3], dense):
        stride = fill if size == 1 else stride
        if stride <= 0 or stride * itemsize % 16:
            raise ValueError(f"the bf16 kernel reads by TMA, which needs "
                             f"positive strides of a multiple of 16 bytes; "
                             f"got element strides {tuple(strides)} "
                             f"({itemsize} bytes each) for shape "
                             f"{tuple(shape)}")
        out.append(stride)
    return tuple(out)


def _check(q, k, v, out, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B,H,Sq,D) and k/v (B,KH,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, KH, Sk, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of the kernel's "
                         f"instances {HEAD_DIMS}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} kv "
                         "heads")
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (k, v, out):
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v and out must share a dtype; got "
                            f"{q.dtype} and {t.dtype}")
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")
    for t in (q, k, v, out):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError("flash_attention needs head_dim contiguous "
                             f"(stride 1), got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k/v: (B,KH,Sk,D), f32 or bf16 -> (B,H,Sq,D) in q's
    dtype (written into ``out`` when given, which may be a strided view).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    global launches, tc_launches
    given = [t for t in (q, k, v, out) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        res = flash_attention_ref(q, k, v, causal=causal, window=window)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check(q, k, v, out, window)
    if out.numel() == 0:      # nothing to compute: no launch, none counted
        return out
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    tc = q.dtype == torch.bfloat16
    if tc:
        strides = [s for t in (q, k, v, out)
                   for s in tma_strides(t.shape, t.stride(), t.element_size(),
                                        t.data_ptr())]
    else:
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[q.dtype])(
            D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
            H, KH, Sq, Sk, *strides, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{rc} ({msg})")
    launches += 1
    tc_launches += tc
    return out
