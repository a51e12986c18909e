"""A mesh of torch devices for the stencil executor, and the LM's sharding
rules over a ``torch.distributed`` ``DeviceMesh``: the port of
``repro.dist.sharding``.

**The stencil mesh** (:class:`Mesh`, :func:`make_auto_mesh`).

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

**The LM's sharding rules** (:class:`ShardingRules`).  One declarative
object names the mesh axes each parallelism style uses: ``tp`` (Megatron
weight sharding), ``fsdp`` (parameter storage), ``dp`` (the batch),
``seq_sharding`` (Megatron-SP activations) and ``kv_seq_shard`` (KV caches
over their length).  A spec is a tuple with one entry a tensor dimension:
``None``, an axis name, or a tuple of axis names (a ``PartitionSpec``);
:func:`placements` turns it into DTensor placements.  Assignment is
shape-driven and divisibility-guarded, as in the reference: a dimension
is sharded only when the axes divide it.

The reference shards *stacked* leaves of shape (L, ...); the port's block
leaves are per layer.  A block leaf takes the reference's spec of its
stacked shape with the layer entry dropped, so a rank-1 norm keeps the TP
on d its (L, d) stack takes there.  Where the layer entry carried an axis
(FSDP on L, the largest dimension it divides once TP took d), the port
puts the axis on the leaf's largest free dimension it divides, and
leaves the leaf replicated over it when none does: a norm scale whose d
took TP is then replicated over the FSDP axis.  ``tests/
test_torch_dryrun.py`` lists every such leaf with its bytes a device
under both.  (Replicating every rank-1 block leaf instead, as the
reference's rule does for unstacked rank-1 leaves, was tried: DTensor
then keeps the residual stream whole on ``model`` and gathers more,
Danube's train_4k step 7.1 s of priced collectives against 1.9 s.)
Serving layouts (the reference's ``unstacked`` decode trees) take the
spec of the per-layer shape itself (``per_layer=True``).

:func:`shard_activation` is the reference's ``with_sharding_constraint``:
inside an :func:`activation_context` it redistributes a DTensor activation
to its spec; outside one, or on a plain tensor, it returns its input.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping, Sequence

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


# --------------------------------------------------------------------------
# the LM's sharding rules
# --------------------------------------------------------------------------

def _as_tuple(axes) -> tuple:
    if axes is None:
        return ()
    if isinstance(axes, (tuple, list)):
        return tuple(a for a in axes if a)
    return (axes,)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


@dataclasses.dataclass
class ShardingRules:
    mesh: object
    tp: str | None = None
    fsdp: object = None          # str | tuple | None
    dp: tuple = ()
    seq_sharding: bool = False
    kv_seq_shard: bool = False

    def batch_axes(self) -> tuple:
        return _as_tuple(self.dp)

    def fsdp_axes(self) -> tuple:
        return _as_tuple(self.fsdp)

    def axis_size(self, axes) -> int:
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in _as_tuple(axes):
            n *= sizes[a]
        return n


def _divides(rules: ShardingRules, axes, dim: int) -> bool:
    axes = _as_tuple(axes)
    return bool(axes) and dim % rules.axis_size(axes) == 0


def _entry(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def _param_spec(shape, rules: ShardingRules) -> tuple:
    """TP on the innermost divisible matmul dim, FSDP on the largest
    remaining one.  Rank<2 leaves (norm scales, counts) stay replicated."""
    if len(shape) < 2:
        return (None,) * len(shape)
    entries: list = [None] * len(shape)
    if rules.tp is not None:
        for ax in (len(shape) - 1, len(shape) - 2):
            if _divides(rules, rules.tp, shape[ax]):
                entries[ax] = rules.tp
                break
    fs = rules.fsdp_axes()
    if fs:
        free = [ax for ax in range(len(shape)) if entries[ax] is None]
        free.sort(key=lambda ax: -shape[ax])
        for ax in free:
            if _divides(rules, fs, shape[ax]):
                entries[ax] = _entry(fs)
                break
    return tuple(entries)


#: prefixes of the per-layer leaves the reference stacks, and the config
#: field holding their layer count
STACKS = {"blocks": "n_layers", "enc_blocks": "n_enc_layers",
          "dec_blocks": "n_layers"}


def stacked_spec(cfg, name: str, shape, rules: ShardingRules) -> tuple | None:
    """The reference's spec of block leaf ``name``'s stacked shape (L,
    *shape), or None for a leaf the reference does not stack."""
    stack = name.split(".", 1)[0]
    if stack not in STACKS or not name.split(".")[1].isdigit():
        return None
    return _param_spec((getattr(cfg, STACKS[stack]), *shape), rules)


def leaf_spec(cfg, name: str, shape, rules: ShardingRules,
              per_layer: bool = False) -> tuple:
    """The port's spec of parameter ``name`` (a per-layer leaf keeps its
    stacked spec minus the layer entry; see the module docstring)."""
    spec = None if per_layer else stacked_spec(cfg, name, shape, rules)
    if spec is None:
        return _param_spec(shape, rules)
    entries, lost = list(spec[1:]), _as_tuple(spec[0])
    if lost:
        free = [ax for ax in range(len(shape)) if entries[ax] is None]
        for ax in sorted(free, key=lambda ax: -shape[ax]):
            if _divides(rules, lost, shape[ax]):
                entries[ax] = _entry(lost)
                break
    return tuple(entries)


def _named_shapes(params) -> dict:
    if isinstance(params, Mapping):
        return {k: tuple(v) for k, v in params.items()}
    return {k: tuple(p.shape) for k, p in params.named_parameters()}


def param_specs(cfg, params, rules: ShardingRules,
                per_layer: bool = False) -> dict:
    """{parameter name: spec} for a module's parameters (or a mapping of
    names to shapes)."""
    return {k: leaf_spec(cfg, k, s, rules, per_layer)
            for k, s in _named_shapes(params).items()}


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements over ``mesh`` of a spec: ``Shard(d)`` on every
    mesh axis named in entry ``d``, ``Replicate()`` on the others.  The
    axes of one entry must come in mesh order, the order in which DTensor
    nests its shards."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named_shardings(cfg, params, rules: ShardingRules,
                    per_layer: bool = False) -> dict:
    """{parameter name: DTensor placements over ``rules.mesh``}."""
    return {k: placements(s, rules.mesh)
            for k, s in param_specs(cfg, params, rules, per_layer).items()}


def _cache_spec(shape, rules: ShardingRules) -> tuple:
    """(B, L, H, dh)-shaped entries: batch over dp, heads over tp — or the
    length dim over tp under flash-decoding.  SSM states shard batch only."""
    entries: list = [None] * len(shape)
    if shape and _divides(rules, rules.batch_axes(), shape[0]):
        entries[0] = _entry(rules.batch_axes())
    if rules.tp is not None and len(shape) >= 3:
        if rules.kv_seq_shard and _divides(rules, rules.tp, shape[1]):
            entries[1] = rules.tp
        elif _divides(rules, rules.tp, shape[-2]):
            entries[-2] = rules.tp
    return tuple(entries)


def cache_specs(cfg, cache, rules: ShardingRules):
    """The cache's structure (lists, dicts, tuples) with a spec for every
    tensor (or shape tuple of ints) in it."""
    if isinstance(cache, torch.Tensor) or (
            isinstance(cache, tuple) and all(isinstance(n, int)
                                             for n in cache)):
        return _cache_spec(tuple(cache.shape) if isinstance(
            cache, torch.Tensor) else cache, rules)
    if isinstance(cache, Mapping):
        return {k: cache_specs(cfg, v, rules) for k, v in cache.items()}
    return type(cache)(cache_specs(cfg, v, rules) for v in cache)


def local_shape(shape, places, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` placed by
    ``places`` over ``mesh`` (the rules shard only dimensions their axes
    divide)."""
    out = list(shape)
    sizes = list(mesh.shape)
    for i, pl in enumerate(places):
        d = getattr(pl, "dim", None)
        if d is not None:
            if out[d] % sizes[i]:
                raise ValueError(f"mesh axis {i} ({sizes[i]}) does not "
                                 f"divide dim {d} of {tuple(shape)}")
            out[d] //= sizes[i]
    return tuple(out)


def sharded_empty(shape, dtype, device, spec: tuple, mesh, zeros=False):
    """A DTensor of ``shape`` placed by ``spec`` over ``mesh`` whose local
    shard is an empty (or zero) tensor on ``device``: on ``"meta"`` it
    allocates nothing."""
    from torch.distributed.tensor import DTensor

    places = placements(spec, mesh)
    make = torch.zeros if zeros else torch.empty
    local = make(local_shape(shape, places, mesh), dtype=dtype,
                 device=device)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def cache_zeros(shape, dtype, device):
    """Zeros for a KV cache or recurrent state: inside an
    :func:`activation_context`, a DTensor placed by the cache rules, of
    which each device holds its shard (the reference's jitted ``zeros``,
    which XLA shards by propagation); a plain tensor outside one."""
    rules = _ACTIVE.get()
    if rules is None or rules.mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return sharded_empty(shape, dtype, device, _cache_spec(tuple(shape),
                                                           rules),
                         rules.mesh, zeros=True)


def batch_sharding(rules: ShardingRules) -> tuple:
    """Placements of a batch-major tensor: dim 0 over the batch axes."""
    ba = rules.batch_axes()
    return placements((_entry(ba) if ba else None,), rules.mesh)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def activation_context(rules: ShardingRules | None):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _activation_spec(shape, kind: str, rules: ShardingRules) -> tuple | None:
    entries: list = [None] * len(shape)
    changed = False
    if shape and _divides(rules, rules.batch_axes(), shape[0]):
        entries[0] = _entry(rules.batch_axes())
        changed = True
    if rules.tp is not None:
        if kind == "logits" and shape and _divides(rules, rules.tp, shape[-1]):
            entries[-1] = rules.tp
            changed = True
        elif kind == "residual" and rules.seq_sharding and len(shape) >= 3 \
                and _divides(rules, rules.tp, shape[1]):
            entries[1] = rules.tp       # Megatron-SP: shard the seq dim
            changed = True
        elif kind == "cache" and len(shape) >= 3:
            ax = 1 if rules.kv_seq_shard else len(shape) - 2
            if _divides(rules, rules.tp, shape[ax]):
                entries[ax] = rules.tp
                changed = True
    return tuple(entries) if changed else None


def shard_activation(x, kind: str = "residual"):
    """Redistribute a DTensor activation to its spec inside an
    :func:`activation_context`; ``x`` itself otherwise (one device, plain
    tensors)."""
    rules = _ACTIVE.get()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = _activation_spec(tuple(x.shape), kind, rules)
    if spec is None:
        return x
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))
