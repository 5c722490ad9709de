"""Paged decode attention: wrapper of the hand-written CUDA kernel.

The kernel, ``repro_torch/csrc/paged_attention.cu``, replaces the Pallas TPU
kernel ``repro/kernels/paged_attention/kernel.py::paged_attention``.  It is
bound by bytes on the card: the live K/V pages of every sequence are read
once, by one block per (sequence, kv head) that serves all G query heads of
its kv head from one shared-memory tile, and dead pages are never read (the
source's header note says more).

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the repository root, as a shared library with a
plain C entry point that ``ctypes`` loads.

``paged_attention`` takes its plain version (``ref.paged_attention_ref``)
only when every tensor it is given lies on the CPU.  For CUDA tensors it
launches the kernel or raises; ``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from .._nvcc import CSRC, build_library
from .ref import paged_attention_ref

# kernel launches made by ``paged_attention`` (CPU calls do not count)
launches = 0

_SRC = CSRC / "paged_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
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
            fn = lib.paged_attention_launch
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                           + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.paged_attention_error_string.argtypes = [ctypes.c_int]
            lib.paged_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B,H,D) and pages (P,page,KH,D); got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape
    P, page, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"k/v pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} kv heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quant = k_scales is not None
    want = torch.int8 if quant else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pages must be {want} for q {q.dtype}"
                        f"{' with scales' if quant else ''}; got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, NP), got "
                         f"{tuple(block_tables.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if quant:
        for s in (k_scales, v_scales):
            if s.shape != (P, KH) or s.dtype != torch.float32:
                raise ValueError(f"scales must be ({P},{KH}) float32, got "
                                 f"{tuple(s.shape)} {s.dtype}")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quant:
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous tensors")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,D) f32|bf16; k/v_pages: (P,page,KH,D) in q's dtype, or int8
    with ``k_scales``/``v_scales`` (P,KH) f32; block_tables: (B,NP) int32;
    lengths: (B,) int32 -> (B,H,D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    global launches
    given = [t for t in (q, k_pages, v_pages, block_tables, lengths,
                         k_scales, v_scales) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales)
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    NP = block_tables.shape[1]
    lib = _load()
    out = torch.empty_like(q)
    quant = k_scales is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KH, D, page, NP, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    launches += 1
    return out
