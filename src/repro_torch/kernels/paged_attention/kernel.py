"""Paged decode attention: wrapper of the hand-written CUDA kernels.

The source, ``repro_torch/csrc/paged_attention.cu``, replaces the Pallas TPU
kernel ``repro/kernels/paged_attention/kernel.py::paged_attention``.  It is
bound by bytes on the card, and is a split-K (flash-decoding) design: the
grid is (sequence x kv head, split), each split reads its contiguous range
of live table entries through a ring of cp.async stages with 16-byte loads,
and with more than one split a second, small kernel merges the splits'
partial softmax states (the source's header note says more).  The number of
splits comes from shapes alone (``num_splits``), so a call reads no device
value on the host and can be captured in a CUDA graph.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the repository root, as a shared library with a
plain C entry point that ``ctypes`` loads.

``paged_attention`` takes its plain version (``ref.paged_attention_ref``)
only when every tensor it is given lies on the CPU.  For CUDA tensors it
launches the kernel or raises; ``launches`` counts the calls that launched
it, ``split_launches`` those that ran more than one split and the combine
kernel.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from .._nvcc import CSRC, build_library
from .ref import paged_attention_ref

# calls of ``paged_attention`` that launched the kernel (CPU calls and empty
# batches do not count), and those of them that ran more than one split and
# the combine kernel
launches = 0
split_launches = 0

HEAD_DIMS = (16, 64, 128, 256)   # head dims the kernel takes
MAX_GROUP = 16                   # query heads per kv head, at most
# split choice: at most this many blocks on each SM (one wave: every
# instance keeps 4 blocks of 128 threads resident on an SM), and no split
# shorter than this many tokens of table capacity
BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 128
MAX_SPLITS = 65535               # the grid's y dimension

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
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.paged_attention_smem.argtypes = [ctypes.c_int] * 2
            lib.paged_attention_smem.restype = ctypes.c_int
            lib.paged_attention_error_string.argtypes = [ctypes.c_int]
            lib.paged_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def smem_bytes(kv_dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of one block of the split kernel for pages of
    ``kv_dtype`` at head dim D, as the library launches it."""
    return _load().paged_attention_smem(_DTYPE_CODES[kv_dtype], D)


def num_splits(B: int, KH: int, NP: int, page: int, sms: int) -> int:
    """How many splits of each sequence's table the kernel runs, from shapes
    alone (never the lengths, so the call needs no host sync).

    As many (sequence x kv head x split) blocks as fit on the card at once
    (``BLOCKS_PER_SM`` on each of ``sms`` SMs: one wave, so no block waits
    for a second), but no split shorter than ``MIN_SPLIT_TOKENS`` tokens of
    table capacity and no more splits than table entries: 1 for short
    tables (the serving decode's NP = 4 at page 16) or a batch that fills
    the card by itself, many for one long sequence."""
    if B * KH <= 0 or NP <= 0:
        return 1
    want = BLOCKS_PER_SM * sms // (B * KH)
    most = NP * page // MIN_SPLIT_TOKENS
    return max(1, min(want, most, NP, MAX_SPLITS))


_num_splits = num_splits     # the wrapper's keyword of that name shadows it


def split_bounds(NP: int, splits: int):
    """The table entries [lo, hi) of each split, as the kernel computes
    them: split s owns [s*NP // splits, (s+1)*NP // splits)."""
    return [(s * NP // splits, (s + 1) * NP // splits)
            for s in range(splits)]


def check_launch(D: int, G: int, itemsize: int, data_ptrs) -> None:
    """What the kernel takes, on plain numbers: D one of ``HEAD_DIMS``, G
    query heads per kv head from 1 to ``MAX_GROUP``, a token's D values a
    whole number of 16-byte words, and 16-byte aligned page pools (their
    ``data_ptrs``).  Anything else raises ``ValueError``; the kernel has no
    other route."""
    if D * itemsize % 16:
        raise ValueError(f"paged_attention reads pages in 16-byte words: "
                         f"D x element size = {D} x {itemsize} bytes is not "
                         f"a multiple of 16")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"paged_attention takes 1 to {MAX_GROUP} query "
                         f"heads per kv head, got {G}")
    for ptr in data_ptrs:
        if ptr % 16:
            raise ValueError(f"paged_attention reads pages in 16-byte "
                             f"words, which needs a 16-byte aligned base; "
                             f"got address {ptr:#x}")


def sm_count(device: torch.device) -> int:
    """The card's SM count, the one device property ``num_splits`` reads."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                    v_scales: Optional[torch.Tensor] = None,
                    num_splits: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,D) f32|bf16; k/v_pages: (P,page,KH,D) in q's dtype, or int8
    with ``k_scales``/``v_scales`` (P,KH) f32; block_tables: (B,NP) int32;
    lengths: (B,) int32 -> (B,H,D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise.  ``num_splits`` forces the number of
    splits (1 to NP) where ``num_splits()`` would choose it; the result is
    the same function (it changes the order of the fp32 sums)."""
    global launches, split_launches
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
    G = H // KH
    check_launch(D, G, k_pages.element_size(),
                 (k_pages.data_ptr(), v_pages.data_ptr()))
    out = torch.empty_like(q)
    if B == 0:
        return out
    if num_splits is None:
        splits = _num_splits(B, KH, NP, page, sm_count(q.device))
    elif not 1 <= num_splits <= min(NP, MAX_SPLITS):
        raise ValueError(f"num_splits must be 1 to {min(NP, MAX_SPLITS)} "
                         f"(the table's {NP} entries), got {num_splits}")
    else:
        splits = int(num_splits)
    lib = _load()
    ws = (torch.empty(B * KH * splits * G * (D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    quant = k_scales is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            B, H, KH, D, page, NP, splits, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    launches += 1
    split_launches += splits > 1
    return out
