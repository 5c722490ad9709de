"""Checkpointing with atomic commit and restart support — counterpart of
``repro.training.checkpoint``.

Layout (one directory per step), the reference's:
    <dir>/step_00000120.tmp/...   (write)
    <dir>/step_00000120/          (atomic rename on success)
        index.json              leaf paths, shapes, dtypes + metadata
        arr_00000.npy ...       one file per leaf (np.save)

Leaves are numbered in ``jax.tree.leaves`` order (dict keys sorted).  A
bf16 leaf is written as its raw 2-byte words under the header numpy
writes for the reference's ``ml_dtypes.bfloat16`` (descr '<V2'), with
"bfloat16" recorded, so each leaf's file equals the reference's for the
same state.  One
difference: the index is JSON, where the reference writes msgpack.

Writes can run on a background thread (``AsyncCheckpointer``) so the
train loop does not stall; ``wait()`` joins before the next save.
Restore picks the newest complete step directory — interrupted writes are
invisible because of the rename commit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.common import tree_leaves, tree_paths, tree_unflatten

INDEX = "index.json"
_BF16_RAW = np.dtype("V2")


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (a tensor or a numpy array) and its dtype's
    name; bf16 as its raw 2-byte words."""
    if isinstance(leaf, np.ndarray):
        return leaf.copy(), str(leaf.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RAW), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; bf16 words under the header numpy writes for the
    reference's ``ml_dtypes.bfloat16`` (descr '<V2'), so the whole file
    equals the reference's."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write(directory: str, step: int, paths, hosted,
           metadata: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {"step": step, "num_leaves": len(hosted), "treedef": paths,
             "metadata": metadata or {}, "leaves": []}
    for i, (arr, dtype) in enumerate(hosted):
        _save_npy(os.path.join(tmp, f"arr_{i:05d}.npy"), arr, dtype)
        index["leaves"].append({"dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(tmp, INDEX), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save(directory: str, step: int, tree, metadata: Optional[Dict] = None
         ) -> str:
    return _write(directory, step, tree_paths(tree),
                  [_host(x) for x in tree_leaves(tree)], metadata)


def _steps(directory: str):
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                  if n.startswith("step_") and not n.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory) if os.path.exists(
        os.path.join(directory, f"step_{s:08d}", INDEX))]
    return max(steps) if steps else None


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def restore(directory: str, step: Optional[int], tree_template
            ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_template`` (leaf count and
    shapes validated); each leaf takes its template's dtype and device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    leaves_t = tree_leaves(tree_template)
    assert index["num_leaves"] == len(leaves_t), \
        f"leaf count mismatch: ckpt {index['num_leaves']} vs template {len(leaves_t)}"
    out = []
    for i, (meta, tmpl) in enumerate(zip(index["leaves"], leaves_t)):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(tmpl.shape)}")
        out.append(_to_torch(arr, meta["dtype"]).to(device=tmpl.device,
                                                    dtype=tmpl.dtype))
    return tree_unflatten(tree_template, out), step, index["metadata"]


class AsyncCheckpointer:
    """Background-thread checkpoint writer (overlap with training)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, step: int, tree, metadata: Optional[Dict] = None):
        self.wait()
        # host copies on the caller's thread (the next step may reuse the
        # device memory)
        paths = tree_paths(tree)
        hosted = [_host(x) for x in tree_leaves(tree)]

        def _run():
            try:
                _write(self.directory, step, paths, hosted, metadata)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
