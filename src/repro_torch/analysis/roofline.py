"""Roofline terms of the LM dry run over an H100 cluster (the port of
``repro.analysis.roofline``).

Three terms per (arch x shape x mesh), per device:

    compute    = FLOPs / peak bf16 FLOP/s
    memory     = bytes moved / HBM bandwidth
    collective = sum over collectives of wire bytes / the link's rate

:func:`analytic_flops`, :func:`analytic_traffic` and
:class:`RooflineTerms` are the reference's, as they are (arithmetic on the
config).  :func:`roofline_report` differs in its source: the reference
reads XLA's ``cost_analysis()`` and the collectives in the compiled HLO
text; the port takes the inventory its own trace records
(:mod:`repro_torch.launch.dryrun`): every collective the DTensor program
issues, with its op, result bytes, group size and mesh axes, and the
FLOPs and bytes each device's operations touch.  Each collective is priced
with the reference's ring formulas (group size g, result bytes b):

    all-gather       b·(g-1)/g
    reduce-scatter   b·(g-1)
    all-reduce       2·b·(g-1)/g
    all-to-all       b·(g-1)/g
    collective-permute  b

at NVLink's rate when its axes lie within ``model`` (one node's NVLink
domain: the production meshes put ``model`` on a node's eight cards) and
at InfiniBand's when it crosses ``data`` or ``pod`` (``hw.H100``'s data-
sheet rates).  The report has two sets of terms:

  * ``terms_traced``: the traced FLOPs, bytes and collectives;
  * ``terms_primary``: analytic MODEL_FLOPS for compute, the analytic
    traffic model for memory, the traced collectives for the wire.

The reference's ``terms_hlo`` and ``terms_corrected`` are gone.  XLA counts
a ``lax.scan`` body once, so the reference multiplies its HLO numbers by
the layer and microbatch trip counts (``scan_correction``); the port's
trace runs its Python loops over layers and microbatches unrolled, so
every operation and collective is recorded as many times as it runs and
there is nothing to correct.  For the same reason the primary collective
term is the traced one, where the reference takes the larger of its HLO
count and the analytic wire: the analytic wire is kept beside it as a
cross-check (``analytic_wire_per_dev``).  The terms are priced from data-
sheet rates, not measured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import hw
from ..configs.base import ModelConfig, ShapeConfig

#: collectives whose axes lie within these mesh axes run over NVLink
NVLINK_AXES = frozenset({"model"})


def ring_wire_bytes(op: str, out_bytes: int, group: int) -> int:
    """Wire bytes a device sends for one collective of result size
    ``out_bytes`` over a group of ``group`` (the reference's ring
    formulas)."""
    if op == "collective-permute":
        return out_bytes
    if group <= 1:
        return 0
    if op in ("all-gather", "all-to-all"):
        return out_bytes * (group - 1) // group
    if op == "all-reduce":
        return 2 * out_bytes * (group - 1) // group
    if op == "reduce-scatter":
        return out_bytes * (group - 1)
    raise ValueError(f"unknown collective {op!r}")


def link_rate(axes, spec=hw.H100) -> float:
    """Bytes/s of the link a collective over mesh ``axes`` runs on."""
    return (spec.nvlink_bandwidth if set(axes) <= NVLINK_AXES
            else spec.network_bandwidth)


# --------------------------------------------------------------------------
# analytic model FLOPs
# --------------------------------------------------------------------------

def _attn_flops_per_layer(cfg: ModelConfig, S: int, B: int, kind: str,
                          causal_half=True) -> float:
    ctx = min(cfg.window, S) if (kind == "local" and cfg.window) else S
    # scores + weighted sum: 2 * 2 * B * H * S * ctx * Dh  (x0.5 causal)
    f = 4.0 * B * cfg.n_heads * S * ctx * cfg.d_head
    return f * (0.5 if causal_half and ctx == S else 1.0)


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Forward/step FLOPs (per executed step, whole cluster)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = B            # one new token per sequence
        S_ctx = S
    else:
        tokens = B * S
        S_ctx = S
    n_active = cfg.num_active_params()
    matmul_fwd = 2.0 * n_active * tokens
    attn = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if cfg.family == "xlstm":
            continue
        if shape.kind == "decode":
            ctx = min(cfg.window, S_ctx) if (kind == "local" and cfg.window) \
                else S_ctx
            attn += 4.0 * B * cfg.n_heads * ctx * cfg.d_head
        else:
            attn += _attn_flops_per_layer(cfg, S, B, kind)
    fwd = matmul_fwd + attn
    if shape.kind == "train":
        return {"fwd": fwd, "total": 3.0 * fwd,   # bwd = 2x fwd
                "model_flops": 6.0 * n_active * tokens + 3 * attn}
    return {"fwd": fwd, "total": fwd,
            "model_flops": 2.0 * n_active * tokens + attn}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    def as_dict(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant}


def roofline_report(*, chips: int, collectives: list,
                    flops_per_dev: float, bytes_per_dev: float,
                    model_flops: float | None = None,
                    analytic: Optional[dict] = None,
                    spec=hw.H100) -> dict:
    """The terms of one traced step.

    ``collectives``: the trace's inventory, one ``{"op", "bytes",
    "group", "axes"}`` a collective (result bytes; ``op`` in the
    reference's names); ``flops_per_dev`` and ``bytes_per_dev``: what the
    trace counted on one device; ``analytic``: :func:`analytic_traffic`'s
    ``{"bytes_per_dev", "wire_per_dev"}`` for the primary terms."""
    coll = [dict(c, wire=ring_wire_bytes(c["op"], c["bytes"], c["group"]))
            for c in collectives]
    for c in coll:
        c["seconds"] = c["wire"] / link_rate(c["axes"], spec)
    wire = sum(c["wire"] for c in coll)
    coll_s = sum(c["seconds"] for c in coll)
    traced = RooflineTerms(
        compute_s=flops_per_dev / spec.peak_bf16_flops,
        memory_s=bytes_per_dev / spec.hbm_bandwidth,
        collective_s=coll_s)
    report = {
        "chips": chips,
        "traced_flops_per_dev": flops_per_dev,
        "traced_bytes_per_dev": bytes_per_dev,
        "collectives": _summarise(coll),
        "wire_per_dev": wire,
        "wire_per_dev_nvlink": sum(c["wire"] for c in coll
                                   if set(c["axes"]) <= NVLINK_AXES),
        "terms_traced": traced.as_dict(),
    }
    if model_flops is not None:
        report["model_flops_total"] = model_flops
        report["model_compute_s"] = model_flops / chips / spec.peak_bf16_flops
        denom = flops_per_dev * chips
        report["useful_flops_ratio"] = (model_flops / denom
                                        if denom else float("nan"))
    if analytic is not None:
        primary = RooflineTerms(
            compute_s=(model_flops / chips / spec.peak_bf16_flops
                       if model_flops else traced.compute_s),
            memory_s=analytic["bytes_per_dev"] / spec.hbm_bandwidth,
            collective_s=coll_s)
        report["analytic_bytes_per_dev"] = analytic["bytes_per_dev"]
        report["analytic_wire_per_dev"] = analytic["wire_per_dev"]
        report["terms_primary"] = primary.as_dict()
    return report


def _summarise(coll: list) -> dict:
    """{op over axes: count, result bytes, wire bytes, seconds}."""
    agg: dict = {}
    for c in coll:
        key = f"{c['op']} over {'+'.join(c['axes'])}"
        a = agg.setdefault(key, {"count": 0, "bytes": 0, "wire": 0,
                                 "seconds": 0.0})
        a["count"] += 1
        a["bytes"] += c["bytes"]
        a["wire"] += c["wire"]
        a["seconds"] += c["seconds"]
    return agg


# --------------------------------------------------------------------------
# analytic traffic model (HBM bytes + ICI wire per device)
# --------------------------------------------------------------------------

def analytic_traffic(cfg: ModelConfig, shape: ShapeConfig, *, chips: int,
                     tp: int, fsdp: int, dp_total: int,
                     remat: bool = True) -> dict:
    """Documented first-principles traffic model per device per step.

    HBM bytes (train):
      params      fwd read 2·P_bf16 + bwd read 2·P_bf16 (post-gather copies)
                  + optimizer: read P_f32+mu+nu, write P_f32+mu+nu
                  + grads f32 write+read — sharded terms /(fsdp·tp)
      activations c_act r/w passes of L·B_loc·S·D·2 bytes; remat doubles the
                  forward-activation traffic; attention adds score traffic
                  2·B_loc·H_loc·S·ctx·2 per layer (flash: logits never hit
                  HBM — counted once at bf16)
      logits      4 passes of B_loc·S·V_tp·4
    HBM bytes (decode): whole (sharded) param set read once per token +
      KV cache read/write + small activations.
    ICI wire (per device):
      TP  : fwd 2 AR + bwd 2 AR per layer of B_loc·S·D·2 -> 2·bytes·(g-1)/g
      FSDP: params all-gather fwd+bwd 2·2·P_shard_bf16·(g-1) ... expressed
            on the gathered size; grad reduce-scatter 4·P·(g-1)/g /g
      DP(pod): grad all-reduce of the fsdp shard 2·(4P/fsdp)·(g-1)/g
    Capacity-drop MoE buffers are counted at capacity_factor.
    """
    B, S = shape.global_batch, shape.seq_len
    L, D = cfg.n_layers, cfg.d_model
    P = cfg.num_params()
    P_active = cfg.num_active_params()
    dp = max(dp_total, 1)
    B_loc = max(B // dp, 1)
    V_tp = cfg.vocab // tp if cfg.vocab % tp == 0 else cfg.vocab
    H_loc = max(cfg.n_heads // tp, 1)
    tok_loc = B_loc * (1 if shape.kind == "decode" else S)

    # ---------------- HBM ----------------
    if shape.kind == "train":
        p_sh = P / (fsdp * tp) if fsdp else P / tp
        params_b = (2 * 2 * P_active / tp * 2  # fwd+bwd reads of gathered bf16
                    + 8 * p_sh               # grads f32 write+read
                    + (4 + 4 + 4) * p_sh     # opt reads p,mu,nu
                    + (4 + 4 + 4) * p_sh)    # opt writes p,mu,nu
        act_pass = 2.0 if remat else 1.0     # recompute doubles fwd traffic
        c_act = 14.0                         # proj/norm/residual r+w passes
        acts_b = (1 + act_pass) * c_act * L * tok_loc * D * 2
        attn_b = 0.0
        for i in range(L):
            ctx = min(cfg.window, S) if (cfg.layer_kind(i) == "local"
                                         and cfg.window) else S
            # fwd + 2x bwd passes over the (never-materialised-in-HBM-if-
            # flash) score tile traffic, counted once at bf16
            attn_b += 3 * 2.0 * B_loc * H_loc * S * ctx * 2
        if cfg.family == "xlstm":
            attn_b = 0.0
        logits_b = 4.0 * tok_loc * V_tp * 4
        bytes_dev = params_b + acts_b + attn_b + logits_b
    elif shape.kind == "prefill":
        params_b = 2 * P_active / tp
        acts_b = 14.0 * L * tok_loc * D * 2
        attn_b = 0.0
        for i in range(L):
            ctx = min(cfg.window, S) if (cfg.layer_kind(i) == "local"
                                         and cfg.window) else S
            attn_b += 2.0 * B_loc * H_loc * S * ctx * 2
        cache_b = 2 * L * B_loc * S * max(cfg.n_kv_heads // tp, 1) \
            * cfg.d_head * 2
        bytes_dev = params_b + acts_b + attn_b + cache_b + tok_loc * V_tp * 4
    else:  # decode: memory-bound by params + cache
        params_b = 2 * P_active / tp
        cache_tot = 0.0
        shard = tp if (cfg.n_kv_heads % tp == 0 or cfg.d_head % tp == 0) \
            else 1
        for i in range(L):
            kind = cfg.layer_kind(i)
            if cfg.family == "xlstm":
                di = cfg.ssm_expand * D
                cache_tot += 2 * B_loc * (di / tp) * (di // cfg.n_heads) * 4
                continue
            ctx = min(cfg.window, S) if (kind == "local" and cfg.window) \
                else S
            # read K and V over the context each step (+1 slot write)
            cache_tot += 2 * B_loc * ctx * cfg.n_kv_heads * cfg.d_head \
                * 2 / shard
        acts_b = 14.0 * L * B_loc * D * 2
        bytes_dev = params_b + cache_tot + acts_b + B_loc * V_tp * 4

    # ---------------- ICI wire ----------------
    wire = 0.0
    act_bytes = tok_loc * D * 2
    if tp > 1:
        n_ar = 4 if shape.kind == "train" else 2     # fwd(+bwd) ARs
        wire += n_ar * L * 2 * act_bytes * (tp - 1) / tp
        # logits all-reduce for the loss (train) or sampling gather
        wire += 2 * tok_loc * 4 * (tp - 1) / tp * (2 if shape.kind == "train"
                                                   else 1)
    if shape.kind == "train" and fsdp > 1:
        p_bf16 = 2 * P_active / tp
        wire += 2 * p_bf16 * (fsdp - 1) / fsdp       # AG fwd + bwd ~ 2x
        wire += 4 * P / tp * (fsdp - 1) / fsdp / 1   # grad reduce-scatter f32
    pod = dp / fsdp if (shape.kind == "train" and fsdp) else dp
    if shape.kind == "train" and pod > 1:
        wire += 2 * (4 * P / (tp * max(fsdp, 1))) * (pod - 1) / pod
    return {"bytes_per_dev": float(bytes_dev), "wire_per_dev": float(wire)}
