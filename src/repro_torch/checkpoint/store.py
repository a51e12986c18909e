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

**Sharded trees** (DTensor leaves, one process a rank).  A save gathers
each DTensor whole (``full_tensor()``, a collective: every rank saves, and
in the same order) and only rank 0 writes and collects old steps, so the
files are the unsharded layout (``host0000.npz`` of whole arrays) and a
checkpoint written under one mesh restores under another, or under none.
``AsyncCheckpointer.wait`` ends with a barrier after a sharded save, so no
rank reads ``latest_step`` before rank 0 has published; the directory is
one every rank sees.  ``restore_checkpoint(..., shardings=)`` places each
leaf given a ``dist.sharding.NamedSharding`` (every rank reads the whole
array and keeps its slice, the reference's elastic path); a leaf without
one stays whole.
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


def _mesh_of(leaves):
    """The mesh of the first DTensor among ``leaves``, or None."""
    from torch.distributed.tensor import DTensor

    return next((t.device_mesh for t in leaves if isinstance(t, DTensor)),
                None)


def _writes(mesh) -> bool:
    """Whether this process writes a tree over ``mesh``: rank 0 of a
    sharded tree, any process of an unsharded one."""
    return mesh is None or torch.distributed.get_rank() == 0


def _host(leaf, keep: bool = True):
    """A host copy of ``leaf`` that later in-place updates do not reach;
    a DTensor gathered whole first (a collective), and dropped when not
    ``keep``."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
        if not keep:
            return None
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
    """Synchronous save with atomic publish; returns the step's directory.
    A tree of DTensors is saved from every rank, and written by rank 0."""
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    flat = _flatten(tree)
    writes = _writes(_mesh_of(flat.values()))
    flat = {p: _host(v, keep=writes) for p, v in flat.items()}
    if not writes:
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for path, t in flat.items():
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
    like leaf's dtype, on its device when it is a tensor.  ``shardings``
    (a tree matching ``like``, or a prefix of it, whose leaves are
    ``dist.sharding.NamedSharding`` or None) places a leaf as a DTensor on
    its mesh; a leaf without one stays whole.  Returns (tree, extra,
    step)."""
    from ..dist.sharding import NamedSharding, place

    shard_flat = _flatten(shardings) if shardings is not None else {}
    bad = [p for p, v in shard_flat.items()
           if v is not None and not isinstance(v, NamedSharding)]
    if bad:
        raise TypeError(f"shardings leaves {bad[:5]} are neither a "
                        "NamedSharding nor None")
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
        sharding = shard_flat.get(path)
        if isinstance(sharding, NamedSharding):
            t = place(t.to(leaf.dtype), sharding)
        elif isinstance(leaf, torch.Tensor):
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
        self._sharded = False

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # snapshot to host synchronously: the tensors are updated in place
        flat = _flatten(tree)
        mesh = _mesh_of(flat.values())
        writes = _writes(mesh)
        host = {p: _host(v, keep=writes) for p, v in flat.items()}
        self._sharded = mesh is not None
        if not writes:
            return
        host_tree = _unflatten(tree, host)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; after a sharded save, then meet every rank at a
        barrier, so that rank 0's publish precedes any rank's next read."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir))[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
