"""Flash prefill attention: wrapper of the hand-written CUDA kernels.

The source, ``repro_torch/csrc/flash_attention.cu``, replaces the Pallas
TPU kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``
with two kernels chosen by dtype: bf16 runs on the tensor cores (``wgmma``
fed by TMA, 128-row query tiles against K/V tiles of 128 keys, 64 at
D = 128 and 256; at D = 256 the CTA is two consumer warpgroups with no
producer warpgroup; fp32 online softmax; P.V as two bf16 products of P
split into hi and lo parts), f32 on the CUDA cores in fp32.  Its
instances (``INSTANCES``) pair a query/key dim D with a value dim DV:
(D, D) for D in 16, 64, 128 and 256 (``HEAD_DIMS``), and (192, 128),
MLA's (deepseek-v2: q/k of nope 128 + rope 64 against v of 128).  The
source's header note says what bounds each and what the design does
about that.  It is built at first use with
``nvcc`` for ``sm_90a`` (``repro_torch.kernels._nvcc``).

``flash_attention`` takes its plain version (``ref.flash_attention_ref``)
only when every tensor it is given lies on the CPU.  For CUDA tensors it
launches the kernel of their dtype or raises; ``launches`` counts every
launch, ``tc_launches`` the tensor-core kernel's alone and
``window_launches`` those with a sliding window.  It reads q, k
and v through their strides (head_dim contiguous) and can write into a
strided ``out``, so the model layout (B,S,H,D) needs no copy
(``ops.flash_attention_bshd``).  The bf16 kernel reads q, k and v by TMA,
which needs 16-byte aligned bases and strides (``tma_strides``); anything
else raises ``ValueError``.

``flash_attention`` also writes, into an optional ``lse`` (B,H,Sq) fp32
tensor, each query row's log-sum-exp of its scaled scores in the log2
domain (+inf for a row that sees no key; ``ref.attention_lse_ref``), with
no extra launch and ``out`` unchanged.  ``flash_attention_bwd`` is the
gradient of the same function with respect to q, k and v, from that
``lse``: three kernels of ``repro_torch/csrc/flash_attention_bwd.cu``
(rowsum(dO * O); dK and dV per key tile; dQ per query tile), bf16 on the
tensor cores (``wgmma`` fed by TMA, P and dS split into bf16 hi and lo
parts; at D = 256 the dK/dV kernel's two warpgroups hold dV and dK
apart, each CTA one 64-key tile, and the dQ kernel's ring 32-key tiles),
f32 on the CUDA cores (32-row tiles at D = 256).  D is one of
``BWD_HEAD_DIMS``, the forward's ``HEAD_DIMS``.  Its plain version is
``ref.flash_attention_bwd_ref``, taken only when every tensor lies on the
CPU (where a missing ``lse`` is recomputed); on CUDA tensors ``lse`` is
required, and a value dim unlike D (MLA's) raises: that backward is
ROADMAP queue 2 item 10.  ``bwd_launches`` counts each of its kernels'
launches (``BWD_KERNELS`` a call), ``bwd_window_launches`` those with a
sliding window.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from .._nvcc import CSRC, build_library
from .ref import (attention_lse_ref, flash_attention_bwd_ref,
                  flash_attention_ref)

# kernel launches made by ``flash_attention`` (CPU calls do not count):
# every launch, the tensor-core (bf16) kernel's alone, and those with a
# sliding window (window > 0)
launches = 0
tc_launches = 0
window_launches = 0
# kernel launches made by ``flash_attention_bwd``: BWD_KERNELS a call, and
# those with a sliding window
bwd_launches = 0
bwd_window_launches = 0
BWD_KERNELS = 3

# template instances in the source: (query/key dim D, value dim DV)
INSTANCES = ((16, 16), (64, 64), (128, 128), (256, 256), (192, 128))
HEAD_DIMS = tuple(d for d, dv in INSTANCES if d == dv)
# the backward's instances (flash_attention_bwd.cu): D = DV, HEAD_DIMS
BWD_HEAD_DIMS = HEAD_DIMS
_SRC = CSRC / "flash_attention.cu"
_ENTRY = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_tc_launch"}
_BWD_SRC = CSRC / "flash_attention_bwd.cu"
# the backward's kernels, by index in ``flash_attention_bwd_smem``
BWD_KERNEL_KINDS = ("delta", "dkdv_f32", "dq_f32", "dkdv_tc", "dq_tc")
_lib = None
_bwd_lib = None
_lock = threading.Lock()
build_log = ""          # nvcc's output (-Xptxas -v) of the last build here
bwd_build_log = ""      # the same for the backward's source


def build():
    """Compile the kernel for sm_90a (once per source version) and return
    the shared library's path."""
    global build_log
    lib, log = build_library(_SRC)
    build_log = log or build_log
    return lib


def build_bwd():
    """Compile the backward's kernels for sm_90a (once per source version)
    and return the shared library's path."""
    global bwd_build_log
    lib, log = build_library(_BWD_SRC)
    bwd_build_log = log or bwd_build_log
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                               + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            lib.flash_attention_smem.argtypes = [ctypes.c_int] * 3
            lib.flash_attention_smem.restype = ctypes.c_int
            lib.flash_attention_error_string.argtypes = [ctypes.c_int]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    with _lock:
        if _bwd_lib is None:
            lib = ctypes.CDLL(str(build_bwd()))
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int] * 2
            lib.flash_attention_bwd_smem.restype = ctypes.c_int
            lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
            lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
            _bwd_lib = lib
    return _bwd_lib


def bwd_smem_bytes(kernel: str, D: int) -> int:
    """Dynamic shared memory of one block of the backward's ``kernel`` (one
    of ``BWD_KERNEL_KINDS``) at head dim D, as the library launches it."""
    return _load_bwd().flash_attention_bwd_smem(
        BWD_KERNEL_KINDS.index(kernel), D)


def smem_bytes(tc: bool, D: int, DV: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of the tensor-core (``tc``) or
    the f32 kernel at query/key dim D and value dim DV (default D), as the
    library launches it."""
    return _load().flash_attention_smem(int(tc), D, D if DV is None else DV)


def tma_strides(shape, strides, itemsize, data_ptr,
                reader="the bf16 kernel reads by TMA"):
    """The (b, h, s) element strides with which the bf16 kernel reads (q,
    k, v by TMA) or writes (out, in bf16 pairs) a (B, heads, S, D) tensor.

    A dim of size 1 is never stepped over, so torch may give it any stride:
    it gets the stride of a contiguous tensor of that shape.  TMA needs a
    16-byte aligned base and strides that are positive multiples of 16
    bytes; anything else raises ``ValueError`` (there is no other route for
    bf16 on the card).  The backward's 16-byte loads of o and dO need the
    same, in either dtype: ``reader`` names the reason in the message."""
    B, heads, S, D = shape
    dense = (heads * S * D, S * D, D)
    if data_ptr % 16:
        raise ValueError(f"{reader}, which needs a 16-byte aligned base; "
                         f"got address {data_ptr:#x}")
    out = []
    for size, stride, fill in zip((B, heads, S), strides[:3], dense):
        stride = fill if size == 1 else stride
        if stride <= 0 or stride * itemsize % 16:
            raise ValueError(f"{reader}, which needs positive strides of a "
                             f"multiple of 16 bytes; got element strides "
                             f"{tuple(strides)} ({itemsize} bytes each) for "
                             f"shape {tuple(shape)}")
        out.append(stride)
    return tuple(out)


def _check_lse(lse, q):
    """``lse`` must be a contiguous fp32 (B,H,Sq) tensor beside q."""
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 "
                         f"{tuple(q.shape[:3])} tensor on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def _check(q, k, v, out, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B,H,Sq,D), k (B,KH,Sk,D) and v "
                         f"(B,KH,Sk,DV); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, KH, Sk, _ = k.shape
    DV = v.shape[3]
    if (v.shape[:3] != k.shape[:3] or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if (D, DV) not in INSTANCES:
        raise ValueError(f"head dims (D, DV) = ({D}, {DV}) are not one of "
                         f"the kernel's instances {INSTANCES}")
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
    if out.shape != (B, H, Sq, DV):
        raise ValueError(f"out {tuple(out.shape)} != (B,H,Sq,DV) "
                         f"{(B, H, Sq, DV)}")
    for t in (q, k, v, out):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError("flash_attention needs head_dim contiguous "
                             f"(stride 1), got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: Optional[torch.Tensor] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k: (B,KH,Sk,D); v: (B,KH,Sk,DV), f32 or bf16 ->
    (B,H,Sq,DV) in q's dtype (written into ``out`` when given, which may
    be a strided view); (D, DV) one of ``INSTANCES``, the scale
    1/sqrt(D).
    ``lse``, when given (contiguous fp32 (B,H,Sq)), receives each row's
    log2-domain log-sum-exp (``ref.attention_lse_ref``), which
    ``flash_attention_bwd`` takes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    global launches, tc_launches, window_launches
    given = [t for t in (q, k, v, out, lse) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        res = flash_attention_ref(q, k, v, causal=causal, window=window)
        if lse is not None:
            _check_lse(lse, q)
            lse.copy_(attention_lse_ref(q, k, causal=causal, window=window))
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if out is None:
        out = q.new_empty(q.shape[:3] + v.shape[3:])
    _check(q, k, v, out, window)
    if lse is not None:
        _check_lse(lse, q)
    if out.numel() == 0:      # nothing to compute: no launch, none counted
        return out
    B, H, Sq, D = q.shape
    DV = v.shape[3]
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
            D, DV, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, KH, Sq, Sk,
            *strides, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{rc} ({msg})")
    launches += 1
    tc_launches += tc
    window_launches += window > 0
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        out: Optional[tuple] = None,
                        lse: Optional[torch.Tensor] = None):
    """Gradient of ``flash_attention`` with respect to q, k and v.

    q, o (the forward's output) and do (the gradient arriving at it):
    (B,H,Sq,D); k/v: (B,KH,Sk,D); one dtype, f32 or bf16, head_dim
    contiguous; lse: the forward's ``lse`` output (contiguous fp32
    (B,H,Sq)).  Returns (dq, dk, dv) in that dtype, written into ``out``
    (three tensors of q's, k's and v's shapes, possibly strided views)
    when given.  CPU tensors run the plain version, which recomputes a
    missing ``lse``; CUDA tensors need ``lse`` (``ValueError`` without
    it: nothing recomputes it there) and launch the three kernels on the
    current stream or raise; D is one of ``BWD_HEAD_DIMS`` (16, 64, 128,
    256).  bf16 tensors are read by TMA and the gradients written in bf16
    pairs, and o and do (either dtype) in 16-byte loads: those bases
    16-byte aligned and strides a multiple of 16 bytes, else
    ``ValueError``."""
    global bwd_launches, bwd_window_launches
    given = (q, k, v, o, do) + tuple(out or ()) + (
        () if lse is None else (lse,))
    if all(t.device.type == "cpu" for t in given):
        if lse is not None:
            _check_lse(lse, q)
        res = flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                      window=window, lse=lse)
        if out is None:
            return res
        for dst, r in zip(out, res):
            dst.copy_(r)
        return tuple(out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    if out is None:
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in (q, k, v))
    dq, dk, dv = out
    _check(q, k, v, o, window)
    if v.shape[3] != q.shape[3]:
        raise NotImplementedError(
            f"flash_attention_bwd has no kernel for value dim {v.shape[3]} "
            f"!= query dim {q.shape[3]} (MLA's training: ROADMAP queue 2 "
            "item 10)")
    for t, like in ((do, q), (dq, q), (dk, k), (dv, v)):
        if t.shape != like.shape or t.dtype != q.dtype:
            raise ValueError(f"a gradient tensor {tuple(t.shape)} "
                             f"{t.dtype} does not match {tuple(like.shape)} "
                             f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError("flash_attention_bwd needs head_dim contiguous "
                             f"(stride 1), got strides {t.stride()}")
    if lse is None:
        raise ValueError("flash_attention_bwd on CUDA tensors needs the "
                         "forward's lse (flash_attention(..., lse=...))")
    _check_lse(lse, q)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if q.numel() == 0:        # no query: dk = dv = 0, no launch
        dq.zero_()
        dk.zero_()
        dv.zero_()
        return out
    delta = torch.empty_like(lse)
    bf16 = q.dtype == torch.bfloat16
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        if bf16:
            strides += tma_strides(t.shape, t.stride(), t.element_size(),
                                   t.data_ptr())
        elif t is o or t is do:       # the delta kernel's 16-byte loads
            strides += tma_strides(t.shape, t.stride(), t.element_size(),
                                   t.data_ptr(), reader="the backward reads "
                                   "o and dO in 16-byte loads")
        else:
            strides += t.stride()[:3]
    strides = (ctypes.c_longlong * 24)(*strides)
    lib = _load_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_bwd_launch(
            int(q.dtype == torch.bfloat16), D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, H, KH, Sq, Sk, strides, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"error {rc} ({msg})")
    bwd_launches += BWD_KERNELS
    bwd_window_launches += BWD_KERNELS * (window > 0)
    return out
