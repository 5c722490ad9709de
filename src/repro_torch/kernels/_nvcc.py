"""Build of the port's hand-written CUDA kernels.

Each kernel source in ``repro_torch/csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repository root
(git-ignored), as a shared library with a plain C entry point that
``ctypes`` loads.  The library's name carries a hash of its source and of
the headers beside it (``*.cuh``, which the sources include), so an edited
source or header is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# at the root of the checkout (src/repro_torch/kernels/_nvcc.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def build_library(src: Path) -> Tuple[Path, str]:
    """Compile ``src`` for sm_90a once per version of it and of the
    headers.  Returns the shared library's path and nvcc's output (-Xptxas
    -v; empty when the library was already built)."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):"
                           f"\n{log}")
    os.replace(tmp, lib)
    return lib, log
