"""A mesh of torch devices (the port of ``repro.dist.sharding.make_auto_mesh``).

The reference's distributed executor is single-controller: one process
holds a ``jax.sharding.Mesh`` and ``shard_map`` runs the program on every
device of it.  The port keeps that shape: one process holds a
:class:`Mesh` whose every coordinate names a ``torch.device``; each shard
of a field is a tensor on its coordinate's device, and a halo slab moves
to a neighbour's device by a device-to-device copy (peer to peer over
NVLink between cards, a plain copy on one card).

Several coordinates may name one device (``devices=["cuda:0"] * 4``): the
shards then run one after another on it, which exercises every exchange
and every kernel at a shard origin on a single card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Mesh:
    """An n-dimensional array of ``torch.device``\\ s with named axes — the
    attributes the schedule helpers read from a ``jax.sharding.Mesh``:
    ``shape`` (axis name -> size, in axis order), ``axis_names`` and
    ``devices`` (an object ndarray of ``torch.device``, one per mesh
    coordinate)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        names = tuple(str(a) for a in axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"{devs.ndim}-d device array for "
                             f"{len(names)} axis names {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis name in {names}")
        out = np.empty(devs.shape, dtype=object)
        for i, d in np.ndenumerate(devs):
            out[i] = torch.device(d)
        self.devices = out
        self.axis_names = names
        self.shape = dict(zip(names, (int(n) for n in devs.shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """The distinct devices of the mesh, in coordinate order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({axes}; "
                f"{', '.join(str(d) for d in self.distinct_devices())})")


def make_auto_mesh(shape, axes, devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` with axis names ``axes``.

    ``devices=None`` takes the cards ``cuda:0 ... cuda:n-1`` in order, one
    shard a card; it raises when there is no card or fewer cards than
    shards, and never places shards on the CPU nor several on one card.
    An explicit ``devices`` list (``["cpu"] * n``, ``["cuda:0"] * n``)
    fills the mesh in C order, coordinate by coordinate.
    """
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         "in length")
    n = int(np.prod(shape)) if shape else 1
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} shards needs {n} CUDA devices, found {have}; "
                "pass devices= to place shards explicitly (for example "
                "devices=['cuda:0'] * n to stack them on one card, or "
                "devices=['cpu'] * n for the CPU)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} takes {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)
