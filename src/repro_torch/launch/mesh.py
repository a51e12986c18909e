"""Production meshes of H100 clusters for the dry run.

``make_production_mesh`` is a function, so importing this module touches
no process group; it needs one of the mesh's size already open (the dry
run opens a fake one, :func:`repro_torch.launch.dryrun.fake_world`).  The
reference's TPU pods of 256 and 512 chips become H100 clusters of the same
chip counts:

Single cluster: (32, 8) = 256 GPUs, axes (data, model): 32 DGX H100 nodes,
tensor parallelism inside a node's eight NVLink-joined cards.
Two clusters:   (2, 32, 8) = 512 GPUs, axes (pod, data, model): the "pod"
axis is pure data parallelism between them.
"""

from __future__ import annotations

from ..dist.sharding import ShardingRules

#: (shape, axis names) of the production meshes
SINGLE = ((32, 8), ("data", "model"))
MULTI = ((2, 32, 8), ("pod", "data", "model"))


def mesh_label(multi_pod: bool) -> str:
    return "x".join(str(n) for n in (MULTI if multi_pod else SINGLE)[0])


def make_production_mesh(*, multi_pod: bool = False):
    """The ``DeviceMesh`` of the cluster (device type ``"cuda"``, so
    DTensor takes the card's collectives)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MULTI if multi_pod else SINGLE
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_rules(mesh, *, kind: str = "train", variant: str = "baseline",
               seq_sharding: bool = False) -> ShardingRules:
    """Sharding rules per workload kind.

    train: TP over 'model', FSDP over 'data', DP over ('pod','data').
    serve: TP over 'model', params replicated over 'data' (no per-token
           FSDP gathers), batch over ('pod','data').

    ``variant`` composes levers with '+':
      sp       — sequence-parallel activations (Megatron-SP)
      dp_remap — no TP: treat the whole mesh as data parallel, FSDP over
                 every axis (right answer for small models)
      kvseq    — shard KV caches over the length dim (flash-decoding
                 across chips)
    """
    multi = "pod" in mesh.mesh_dim_names
    dp = ("pod", "data") if multi else ("data",)
    levers = set(variant.split("+"))
    tp = "model"
    fsdp = "data" if kind == "train" else None
    kv_seq = "kvseq" in levers
    if "sp" in levers:
        seq_sharding = True
    if "dp_remap" in levers:
        tp = None
        dp = dp + ("model",)
        fsdp = (("data", "model") if kind == "train" else None)
    return ShardingRules(
        mesh=mesh, tp=tp, fsdp=fsdp, dp=dp, seq_sharding=seq_sharding,
        kv_seq_shard=kv_seq)


def stencil_mesh_axes(mesh):
    """Grid-axis -> mesh-axis mapping for distributed stencils:
    x over 'data', y over 'model', z over 'pod' (if present)."""
    if "pod" in mesh.mesh_dim_names:
        return ("data", "model", "pod")
    return ("data", "model", None)
