"""Transformer building blocks of the decoder path: norms, RoPE, the
attention family, the MLP and the MoE MLP, in PyTorch.

The port of ``repro.models.layers``.  Parameters live in ``nn.Module``s
whose attribute names are the reference's pytree keys (``Attention.wq``,
``Norm.scale``, ...), so a reference tree carries across by name
(:func:`repro_torch.interop.lm_params_from_reference`).  The ``*_apply``
functions take such a module and tensors, batch-first ``(B, S, ...)``, and
compute in the tensors' dtype with the reference's float32 islands
(norms, RoPE, softmax).

Attention paths, as in the reference:

* dense masked attention for short sequences;
* blockwise flash (a loop over KV chunks, running max and denominator) for
  prefill longer than ``spec.chunk``;
* sliding-window attention for local layers longer than the window: on the
  card the CUDA kernel (:func:`repro_torch.kernels.ops.
  sliding_window_attention`), which computes no logit softcap, so a layer
  with a softcap, and every CPU run, takes the torch slab path
  :func:`swa_attention`;
* decode attention over a (possibly ring-buffer) KV cache.

The MoE MLP (:func:`moe_apply`) is the reference's GShard-style capacity
dispatch, plain PyTorch as the reference's is plain jnp.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops


# --------------------------------------------------------------------------
# initialisers and parameter modules
# --------------------------------------------------------------------------

def _dense_init(generator, shape, in_axis_size, dtype, device) -> nn.Parameter:
    """Normal / sqrt(fan-in) from ``generator``; uninitialised (for a copy
    to fill) when ``generator`` is None."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        scale = 1.0 / math.sqrt(max(in_axis_size, 1))
        t = (torch.randn(shape, generator=generator, device=device)
             * scale).to(dtype)
    return nn.Parameter(t, requires_grad=False)


class Norm(nn.Module):
    """``scale`` (ones), and ``bias`` (zeros) for a layernorm."""

    def __init__(self, d: int, kind: str = "rmsnorm",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                 device=device),
                                     requires_grad=False)


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    d_head: int
    causal: bool = True
    window: int = 0            # 0 = global
    softcap: float = 0.0
    chunk: int = 1024          # blockwise path threshold/size
    qk_norm: bool = False


class Attention(nn.Module):
    """``wq`` (d, H, Dh), ``wk``/``wv`` (d, KV, Dh), ``wo`` (H, Dh, d), and
    ``q_norm``/``k_norm`` with ``spec.qk_norm``."""

    def __init__(self, d_model: int, spec: AttnSpec, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
        init = dict(dtype=dtype, device=device)
        self.wq = _dense_init(generator, (d_model, h, dh), d_model, **init)
        self.wk = _dense_init(generator, (d_model, kv, dh), d_model, **init)
        self.wv = _dense_init(generator, (d_model, kv, dh), d_model, **init)
        self.wo = _dense_init(generator, (h, dh, d_model), h * dh, **init)
        if spec.qk_norm:
            self.q_norm = Norm(dh, **init)
            self.k_norm = Norm(dh, **init)


class MoE(nn.Module):
    """``router`` (d, E) float32, ``w_in`` (E, d, F), ``w_out`` (E, F, d),
    and ``w_gate`` (E, d, F) when gated."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 glu: bool = True, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        self.router = _dense_init(generator, (d_model, n_experts), d_model,
                                  torch.float32, device)
        self.w_in = _dense_init(generator, (n_experts, d_model, d_ff),
                                d_model, **init)
        self.w_out = _dense_init(generator, (n_experts, d_ff, d_model), d_ff,
                                 **init)
        if glu:
            self.w_gate = _dense_init(generator, (n_experts, d_model, d_ff),
                                      d_model, **init)


class MLP(nn.Module):
    """``w_in`` (d, F), ``w_out`` (F, d), and ``w_gate`` (d, F) when gated."""

    def __init__(self, d_model: int, d_ff: int, glu: bool = True,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        self.w_in = _dense_init(generator, (d_model, d_ff), d_model, **init)
        self.w_out = _dense_init(generator, (d_ff, d_model), d_ff, **init)
        if glu:
            self.w_gate = _dense_init(generator, (d_model, d_ff), d_model,
                                      **init)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_apply(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (nrm * p.scale.float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p.scale + p.bias).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,) absolute positions.
    Rotates interleaved channel pairs ``(x[..., 0::2], x[..., 1::2])``."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (d/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # (B,S,d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _local_heads(spec: AttnSpec, q, k) -> AttnSpec:
    """``spec`` with the head counts of the local q and k of one rank."""
    return dataclasses.replace(spec, n_heads=q.shape[2],
                               n_kv_heads=k.shape[2])


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def flat_ready(t: torch.Tensor, first: int, last: int,
               to: int | None = None) -> torch.Tensor:
    """``t`` ready for an einsum that flattens its dims ``first..last``
    into one: a DTensor whose mesh axes shard an inner dim of that group
    (any but ``first``) is redistributed, each such axis moved to dim
    ``to`` (``first`` by default) where it divides that dim and replicated
    where not.  DTensor cannot flatten a group sharded on an inner dim
    without redistributing, which a view may not do (torch 2.11 raises;
    later releases keep a strided shard).  The rules put TP on a
    projection's head dim, its innermost divisible dim, so ``wq``, ``wk``,
    ``wv`` (d, heads, head dim) and ``wo`` (heads, head dim, d) arrive so;
    and DTensor may shard an activation's sequence over TP, which the next
    product's (batch, sequence) flatten cannot take.  A plain tensor is
    returned as it is."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    to = first if to is None else to
    places, sizes = list(t.placements), list(t.device_mesh.shape)
    moved = False
    for i, pl in enumerate(places):
        if isinstance(pl, Shard) and first < pl.dim <= last:
            on_to = math.prod(sizes[j] for j, q in enumerate(places)
                              if isinstance(q, Shard) and q.dim == to)
            places[i] = (Shard(to) if t.shape[to] % (on_to * sizes[i]) == 0
                         else Replicate())
            moved = True
    return t.redistribute(t.device_mesh, places) if moved else t


class _RowsReady(torch.autograd.Function):
    """:func:`flat_ready` over the leading dims, on the tensor and on its
    gradient: a product's backward flattens the gradient of its output the
    way its forward flattened the input."""

    @staticmethod
    def forward(ctx, x):
        return flat_ready(x, 0, x.dim() - 2, to=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return flat_ready(g, 0, g.dim() - 2, to=g.dim() - 1)


def rows_ready(x: torch.Tensor) -> torch.Tensor:
    """An activation ready for a product that flattens its leading dims
    (batch, sequence) into rows, forward and backward: :func:`flat_ready`
    over them, an axis that shards an inner one moved to the feature dim
    (the product's contraction) where it divides it, on ``x`` and on the
    gradient that comes back to it.  A plain tensor is returned as it
    is."""
    return _RowsReady.apply(x) if _is_dtensor(x) else x


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    kvh = k.shape[-2]
    if kvh == n_heads:
        return k
    return k.repeat_interleave(n_heads // kvh, dim=-2)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _scores(q, k, scale):
    """(B,Sq,H,D) x (B,Sk,H,D) -> f32 logits (B,H,Sq,Sk): the reference's
    ``preferred_element_type=float32`` product (exact products, f32 sums)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _dense_scores(q, k, spec: AttnSpec, qpos, kpos):
    """(B,Sq,H,D)x(B,Sk,H,D) -> masked f32 logits (B,H,Sq,Sk)."""
    logits = _softcap(_scores(q, k, 1.0 / math.sqrt(spec.d_head)),
                      spec.softcap)
    dq, dk = qpos[:, None], kpos[None, :]
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=q.device)
    if spec.causal:
        ok &= dk <= dq
    if spec.window:
        ok &= dk > dq - spec.window
    return torch.where(ok, logits, -1e30)


def dense_attention(q, k, v, spec: AttnSpec, qpos=None, kpos=None):
    Sq, Sk = q.shape[1], k.shape[1]
    if qpos is None:
        qpos = torch.arange(Sq, device=q.device)
    if kpos is None:
        kpos = torch.arange(Sk, device=q.device)
    k = _repeat_kv(k, spec.n_heads)
    v = _repeat_kv(v, spec.n_heads)
    w = torch.softmax(_dense_scores(q, k, spec, qpos, kpos), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def flash_attention(q, k, v, spec: AttnSpec):
    """Blockwise attention, O(S·chunk) memory: a loop over KV chunks with a
    running max and denominator."""
    B, S, H, D = q.shape
    C = min(spec.chunk, S)
    if S % C:
        raise ValueError(f"seq {S} not divisible by chunk {C}")
    k = _repeat_kv(k, spec.n_heads)
    v = _repeat_kv(v, spec.n_heads)
    scale = 1.0 / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)
    # the running statistics made like q's rows (B,H,S) and q (B,H,S,D):
    # a sharded q (the dry run's DTensor) gives statistics sharded alike
    m = torch.full_like(q[..., 0], -math.inf,
                        dtype=torch.float32).transpose(1, 2)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q, dtype=torch.float32).transpose(1, 2)
    for blk in range(S // C):
        kb, vb = k[:, blk * C:(blk + 1) * C], v[:, blk * C:(blk + 1) * C]
        kpos = blk * C + torch.arange(C, device=q.device)
        logits = _softcap(_scores(q, kb, scale), spec.softcap)
        ok = torch.ones((S, C), dtype=torch.bool, device=q.device)
        if spec.causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if spec.window:
            ok &= kpos[None, :] > qpos[:, None] - spec.window
        logits = torch.where(ok, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                   # (B,S,H,D)


def swa_attention(q, k, v, spec: AttnSpec):
    """Sliding-window attention via per-q-block KV slabs (stencil pattern).

    Query tile i attends to KV positions [i·Bq − w, (i+1)·Bq): an overlapping
    window slab.  O(S·(w + Bq)) compute and memory.  As in the reference,
    the softmax weights are cast to q's dtype before the PV product.
    """
    B, S, H, D = q.shape
    w = spec.window
    Bq = min(max(spec.chunk // 2, 128), S)
    if S % Bq:
        raise ValueError(f"seq {S} not divisible by q-block {Bq}")
    k = _repeat_kv(k, spec.n_heads)
    v = _repeat_kv(v, spec.n_heads)
    slab = w + Bq
    # pad KV on the left by w so every slab is in range
    kp = F.pad(k, (0, 0, 0, 0, w, 0))
    vp = F.pad(v, (0, 0, 0, 0, w, 0))
    scale = 1.0 / math.sqrt(D)
    rows = torch.arange(Bq, device=q.device)[:, None]
    cols = torch.arange(slab, device=q.device)[None, :]
    out = []
    for i in range(S // Bq):
        q_blk = q[:, i * Bq:(i + 1) * Bq]
        k_blk, v_blk = kp[:, i * Bq:i * Bq + slab], vp[:, i * Bq:i * Bq + slab]
        qpos, kpos = i * Bq + rows, i * Bq - w + cols
        logits = _softcap(_scores(q_blk, k_blk, scale), spec.softcap)
        ok = (kpos <= qpos) & (kpos > qpos - w) & (kpos >= 0)
        logits = torch.where(ok, logits, -1e30)
        wgt = torch.softmax(logits, -1).to(q.dtype)
        out.append(torch.einsum("bhqk,bkhd->bqhd", wgt, v_blk))
    return torch.cat(out, dim=1)


def project_qkv(p: Attention, x, spec: AttnSpec, positions=None,
                rope_theta=10000.0, use_rope=True, norm_kind="rmsnorm"):
    """q (B,S,H,Dh) and k, v (B,S,KV,Dh) of a self-attention block, after
    qk-norm and RoPE: what :func:`attention_apply` attends over, and what
    prefill writes to the cache."""
    x = rows_ready(x)
    q = torch.einsum("bsd,dhk->bshk", x, flat_ready(p.wq, 1, 2))
    k = torch.einsum("bsd,dhk->bshk", x, flat_ready(p.wk, 1, 2))
    v = torch.einsum("bsd,dhk->bshk", x, flat_ready(p.wv, 1, 2))
    if spec.qk_norm:
        q = norm_apply(p.q_norm, q, norm_kind)
        k = norm_apply(p.k_norm, k, norm_kind)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attend(q, k, v, spec: AttnSpec):
    """Causal self-attention of projected q, k, v, by sequence length: SWA
    beyond the window (the CUDA kernel on the card when the layer has no
    softcap), flash beyond ``spec.chunk``, else dense.  On DTensors
    (sharded training) it runs on each rank's batch rows and heads
    (``ops.on_shards``): DTensor cannot flatten the (batch, heads) of a
    product sharded on both without redistributing, and the kernel reads
    local tensors."""
    if _is_dtensor(q):
        return ops.on_shards(lambda q, k, v: attend(
            q, k, v, _local_heads(spec, q, k)), q, k, v)
    S = q.shape[1]
    if spec.window and S > spec.window:
        if q.device.type == "cuda" and not spec.softcap:
            return ops.sliding_window_attention(q, k, v, window=spec.window)
        return swa_attention(q, k, v, spec)
    if S > spec.chunk:
        return flash_attention(q, k, v, spec)
    return dense_attention(q, k, v, spec)


def attention_apply(p: Attention, x, spec: AttnSpec, positions=None,
                    rope_theta=10000.0, use_rope=True, kv_override=None,
                    norm_kind="rmsnorm"):
    """Full attention block: proj -> rope -> attend -> out-proj.

    ``kv_override``: (k, v) (B, Sk, KV, Dh) from an encoder, for
    cross-attention: only q is projected (RoPE, with ``use_rope``, on q
    alone), and the attention is dense and non-causal with no window,
    whatever ``spec`` says, as in the reference.
    """
    if kv_override is None:
        q, k, v = project_qkv(p, x, spec, positions, rope_theta, use_rope,
                              norm_kind)
        return torch.einsum("bshk,hkd->bsd", attend(q, k, v, spec),
                            flat_ready(p.wo, 0, 1))
    q = torch.einsum("bsd,dhk->bshk", x, flat_ready(p.wq, 1, 2))
    k, v = kv_override
    if spec.qk_norm:
        q = norm_apply(p.q_norm, q, norm_kind)
        k = norm_apply(p.k_norm, k, norm_kind)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions, rope_theta)
    cross = dataclasses.replace(spec, causal=False, window=0)
    if _is_dtensor(q):
        out = ops.on_shards(lambda q, k, v: dense_attention(
            q, k, v, _local_heads(cross, q, k)), q, k, v)
    else:
        out = dense_attention(q, k, v, cross)
    return torch.einsum("bshk,hkd->bsd", out, flat_ready(p.wo, 0, 1))


# -------------------------------------------------------------------- decode

def decode_attention(p: Attention, x, cache_k, cache_v, pos: int,
                     spec: AttnSpec, rope_theta=10000.0, use_rope=True,
                     ring=False, norm_kind="rmsnorm"):
    """One-token attention against a KV cache.

    ``ring=True`` (SWA layers): the cache is a ring buffer of length
    ``window``; new KV overwrite slot ``pos % window``.  The new k and v are
    written into ``cache_k``/``cache_v`` in place (the reference returns
    updated copies); returns (attn_out, cache_k, cache_v).
    """
    B = x.shape[0]
    q = torch.einsum("bd,dhk->bhk", x, p.wq)[:, None]       # (B,1,H,D)
    k = torch.einsum("bd,dhk->bhk", x, p.wk)[:, None]
    v = torch.einsum("bd,dhk->bhk", x, p.wv)[:, None]
    if spec.qk_norm:
        q = norm_apply(p.q_norm, q, norm_kind)
        k = norm_apply(p.k_norm, k, norm_kind)
    if use_rope:
        posv = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    L = cache_k.shape[1]
    slot = (pos % L) if ring else min(pos, L - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    # grouped-query form: the KV heads are not repeated
    KV = cache_k.shape[2]
    G = spec.n_heads // KV
    qg = q[:, 0].reshape(B, KV, G, spec.d_head)                # (B,KV,G,D)
    scale = 1.0 / math.sqrt(spec.d_head)
    logits = torch.einsum("bkgd,blkd->bkgl", qg.float(),
                          cache_k.float()) * scale
    logits = _softcap(logits, spec.softcap)
    if not (ring and pos >= L):      # a full ring holds only valid slots
        valid = torch.arange(L, device=x.device) <= pos
        logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, -1)
    out = torch.einsum("bkgl,blkd->bkgd", w, cache_v.float())  # (B,KV,G,D)
    out = out.reshape(B, spec.n_heads, spec.d_head).to(q.dtype)
    return torch.einsum("bhk,hkd->bd", out, p.wo), cache_k, cache_v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_apply(p: MLP, x, act="silu"):
    x = rows_ready(x)
    h = rows_ready(torch.einsum("...d,df->...f", x, p.w_in))
    g = (rows_ready(torch.einsum("...d,df->...f", x, p.w_gate))
         if hasattr(p, "w_gate") else None)
    return rows_ready(torch.einsum("...f,fd->...d",
                                   rows_ready(_gated(h, g, act)), p.w_out))


def _gated(h, g, act):
    """The MLP's nonlinearity: ``act(g) * h`` when gated, else ``act(h)``."""
    return _ACTS[act](h) if g is None else _ACTS[act](g) * h


def moe_apply(p: MoE, x, top_k=2, act="silu", capacity_factor=1.25,
              no_drop=False, stats=None):
    """Capacity-factor scatter dispatch (GShard-style).

    x: (B, S, D) -> ((B, S, D), aux).  The router runs in float32; each
    token's top-k experts are renormalised; assignment ``j`` of token
    ``t`` is ranked in its expert token-major (``t0k0, t0k1, t1k0, ...``)
    and dropped (contributes zero) past ``cap = max(int(capacity_factor *
    T * k / E), 1)``.  ``no_drop=True`` (decode) sizes ``cap`` at ``T``,
    or, when ``T * k <= E``, gathers only the chosen experts' weights.
    ``aux`` is the Switch load-balance loss.  ``stats``, a dict when
    given, receives ``top_i`` (T, k) and ``dropped`` (assignments dropped,
    a 0-d tensor) without a host sync.
    """
    B, S, D = x.shape
    E = p.router.shape[-1]
    T = B * S
    xf = x.reshape(T, D)
    probs = torch.softmax(xf.float() @ p.router.float(), -1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)             # (T,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    gated = hasattr(p, "w_gate")
    aux = _load_balance_loss(probs, top_i, E)
    if stats is not None:
        stats["top_i"] = top_i

    if no_drop and T * top_k <= E:
        # decode fast path (tiny T): only the chosen experts' weights
        h = torch.einsum("td,tkdf->tkf", xf, p.w_in[top_i])    # (T,k,F)
        g = (torch.einsum("td,tkdf->tkf", xf, p.w_gate[top_i]) if gated
             else None)
        out = torch.einsum("tkf,tkfd->tkd", _gated(h, g, act),
                           p.w_out[top_i])
        y = (out * top_p[..., None].to(x.dtype)).sum(1)
        if stats is not None:
            stats["dropped"] = torch.zeros((), dtype=torch.long,
                                           device=x.device)
        return y.reshape(B, S, D), aux

    eid = top_i.reshape(-1)                                     # (T*k,)
    tid = torch.arange(T, device=x.device).repeat_interleave(top_k)
    cap = T if no_drop else max(int(capacity_factor * T * top_k / E), 1)
    onehot = F.one_hot(eid, E)                                  # (T*k, E)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, eid[:, None])[:, 0]
    keep = rank < cap
    rank = torch.where(keep, rank, 0)
    if stats is not None:
        stats["dropped"] = (~keep).sum()

    buf = torch.zeros((E, cap, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((eid, rank), torch.where(keep[:, None], xf[tid], 0),
                        accumulate=True)
    h = torch.einsum("ecd,edf->ecf", buf, p.w_in)
    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate) if gated else None
    out_e = torch.einsum("ecf,efd->ecd", _gated(h, g, act), p.w_out)
    gathered = torch.where(keep[:, None], out_e[eid, rank], 0)
    # tid groups each token's k assignments together, in order
    y = (gathered * top_p.reshape(-1, 1).to(x.dtype)).reshape(T, top_k, D)
    return y.sum(1).reshape(B, S, D), aux


def _load_balance_loss(probs, top_i, E):
    """Switch-style auxiliary load-balancing loss (the first choice's
    fraction of tokens times the mean router probability, per expert)."""
    fraction = F.one_hot(top_i[:, 0], E).float().mean(0)
    return E * (fraction * probs.mean(0)).sum()
