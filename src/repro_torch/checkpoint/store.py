"""Atomic, async checkpointing of trees of tensors.

The port of ``repro.checkpoint.store``, with its layout (one directory per
step):

    <dir>/step_00000100.tmp/ ... -> atomic rename -> <dir>/step_00000100/
        manifest.json            tree paths, shapes, dtypes, extra
        host0000.npz             every leaf, by flattened path

* **atomic publish** — readers only ever see complete checkpoints (tmp dir
  + rename; rename is atomic on POSIX); ``latest_step`` never picks a
  ``.tmp``.
* **async** — ``AsyncCheckpointer`` copies every leaf to host memory before
  ``save`` returns (training goes on updating the tensors in place) and
  writes in a background thread; ``wait()`` joins before the next save or
  on exit.
* **integrity** — leaf paths, shapes and dtypes are checked against the
  manifest.

A tree is nested dicts (and lists or tuples) whose leaves are tensors,
numpy arrays or numbers.  numpy has no bfloat16, so a bfloat16 leaf is
stored as its ``uint16`` view and the manifest records ``"bfloat16"``.
Restoring onto another layout (the reference's ``shardings=``) waits for
sharded execution, ROADMAP A16.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/0": leaf} of a nested tree (the reference's path naming)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with its leaves taken from ``leaves``."""
    if isinstance(like, Mapping):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    return leaves[prefix]


def _host(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place updates do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _to_numpy(t: torch.Tensor):
    """(array to store, dtype name): bfloat16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: dict | None = None) -> str:
    """Synchronous save with atomic publish; returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for path, leaf in _flatten(tree).items():
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
            else _host(leaf)
        arr, dtype = _to_numpy(t)
        arrays[path.replace("/", "__")] = arr
        manifest["leaves"][path] = {"shape": list(arr.shape),
                                    "dtype": dtype}
    np.savez(os.path.join(tmp, "host0000.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list:
    return [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in _steps(ckpt_dir) if os.path.exists(
        os.path.join(ckpt_dir, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of ``like``: each leaf a tensor in the
    like leaf's dtype, on its device when it is a tensor.  Returns (tree,
    extra, step)."""
    if shardings is not None:
        raise NotImplementedError("restoring onto shardings waits for "
                                  "sharded execution, ROADMAP A16")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "host0000.npz"))
    flat_like = _flatten(like)
    if set(manifest["leaves"]) != set(flat_like):
        missing = set(flat_like) ^ set(manifest["leaves"])
        raise ValueError(f"checkpoint structure mismatch: {sorted(missing)[:5]}")
    out = {}
    for path, leaf in flat_like.items():
        arr = data[path.replace("/", "__")]
        want = manifest["leaves"][path]
        stored = "uint16" if want["dtype"] == "bfloat16" else want["dtype"]
        if list(arr.shape) != want["shape"] or str(arr.dtype) != stored:
            raise ValueError(f"{path}: corrupt shard {arr.shape} "
                             f"{arr.dtype} != {want['shape']} "
                             f"{want['dtype']}")
        t = _from_numpy(arr, want["dtype"])
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        else:
            t = t.to(_host(leaf).dtype)
        out[path] = t
    return _unflatten(like, out), manifest["extra"], manifest["step"]


class AsyncCheckpointer:
    """Background-thread writer with at-most-one outstanding save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # snapshot to host synchronously: the tensors are updated in place
        host_tree = _unflatten(tree, {p: _host(v) for p, v in
                                      _flatten(tree).items()})

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir))[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
