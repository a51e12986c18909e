"""State-space and recurrent blocks in PyTorch: the Mamba-style selective
SSM (hymba's head beside attention) and xLSTM's mLSTM and sLSTM cells.

The port of ``repro.models.ssm``.  All three are linear-in-sequence
recurrences carrying a bounded state: the sequence-dimension analogue of
the paper's shift buffer.  Parameters are ``nn.Module``s named by the
reference's pytree keys, as in :mod:`.layers`.

* Mamba (:func:`mamba_apply`): the causal depthwise conv, then the
  selective scan ``h_t = exp(ld_t) * h_{t-1} + dr_t`` chunk by chunk
  (``_CHUNK`` positions, the whole sequence when it does not divide),
  the state carried across chunks.  The reference runs a
  ``lax.associative_scan`` inside a chunk; here :func:`_linear_scan` runs
  the same recurrence in two levels, which differs from it only in float
  rounding.  ``log_decay`` and ``drive`` (B, c, d_inner, N) are built a
  chunk at a time, never over the whole sequence.
* mLSTM (:func:`mlstm_apply`): the stabilised chunkwise form for
  sequences, the O(1) update for a decode step.
* sLSTM (:func:`slstm_apply`): a true recurrence through ``h``, a loop
  over the sequence as the reference's ``lax.scan`` is.

Plain PyTorch on tensors, as the reference's are plain jnp: no kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import on_head_shards
from .layers import (Norm, _dense_init, _is_dtensor, _reduced, batch_only,
                     group_ready, norm_apply, rows_ready, to_heads)

_CHUNK = 256
#: positions a sub-block of :func:`_linear_scan` steps through in turn
_SUB = 16


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _const(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Mamba(nn.Module):
    """``w_in`` (d, 2·di), ``conv_w`` (K, di), ``conv_b`` (di,), ``w_bc``
    (di, 2N), ``w_dt`` (di, 1), ``dt_bias`` (di,), ``A_log`` (di, N)
    float32, ``D_skip`` (di,), ``w_out`` (di, d); di = expand·d."""

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2,
                 conv: int = 4, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        di = expand * d_model
        init = dict(dtype=dtype, device=device)
        self.w_in = _dense_init(generator, (d_model, 2 * di), d_model, **init)
        self.conv_w = _dense_init(generator, (conv, di), conv, **init)
        self.conv_b = _const(torch.zeros(di, **init))
        self.w_bc = _dense_init(generator, (di, 2 * d_state), di, **init)
        self.w_dt = _dense_init(generator, (di, 1), di, **init)
        self.dt_bias = _const(torch.full((di,), -4.0, **init))  # small dt
        n = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
        self.A_log = _const(torch.log(n).repeat(di, 1))
        self.D_skip = _const(torch.ones(di, **init))
        self.w_out = _dense_init(generator, (di, d_model), di, **init)


class MLSTM(nn.Module):
    """``w_up`` (d, 2·di), ``wq``/``wk``/``wv`` (di, H, dh), ``w_if`` (di,
    2H) float32, ``if_bias`` (2H,) float32 (input gates 0, forget gates 3),
    ``out_norm`` (dh, float32 rmsnorm), ``w_down`` (di, d)."""

    def __init__(self, d_model: int, n_heads: int, expand: int = 2,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        di = expand * d_model
        dh = di // n_heads
        init = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w_up = _dense_init(generator, (d_model, 2 * di), d_model, **init)
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _dense_init(generator, (di, n_heads, dh), di,
                                            **init))
        self.w_if = _dense_init(generator, (di, 2 * n_heads), di, **f32)
        self.if_bias = _const(torch.cat([torch.zeros(n_heads, **f32),
                                         torch.full((n_heads,), 3.0, **f32)]))
        self.out_norm = Norm(dh, **f32)
        self.w_down = _dense_init(generator, (di, d_model), di, **init)


class SLSTM(nn.Module):
    """``w_gates``/``r_gates`` (d, 4d), ``g_bias`` (4d,) float32,
    ``out_norm`` (d, float32 rmsnorm), ``w_down`` (d, d)."""

    def __init__(self, d_model: int, n_heads: int, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.w_gates = _dense_init(generator, (d_model, 4 * d_model), d_model,
                                   **init)
        self.r_gates = _dense_init(generator, (d_model, 4 * d_model), d_model,
                                   **init)
        self.g_bias = _const(torch.zeros(4 * d_model, **f32))
        self.out_norm = Norm(d_model, **f32)
        self.w_down = _dense_init(generator, (d_model, d_model), d_model,
                                  **init)


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

def _on_shards(fn, roles_of, args, outs):
    """``fn(*args)`` on each rank's shards through ``local_map``, for a
    recurrence by batch row and channel (sharded training, the dry run).
    ``roles_of``: placements of a (B, S, C) activation: a mesh axis that
    shards its dim 0 splits the batch, one that shards its dim 2 the
    channels, any other leaves every tensor whole.  ``args``: (tensor,
    batch dim, channel dim), a dim None where the tensor has none; each is
    redistributed to ``Shard`` of its dim on the axes of that role and
    ``Replicate`` elsewhere, and its gradient comes back so, ``Partial``
    where it has no dim of an axis's role (each rank's share of a sum over
    that axis's shards), reduced to its placements by the
    redistribution's backward.  ``outs``: (batch dim, channel dim) of each
    output.  The computation runs on plain local tensors: DTensor's own
    padding of a sharded tensor failed on torch 2.11 (a target placement
    list shorter than the mesh)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    roles = ["b" if pl == Shard(0) else "c" if pl == Shard(2) else None
             for pl in roles_of]
    mesh = next(t for t, _, _ in args if _is_dtensor(t)).device_mesh

    def place(bd, cd, grad=False):
        out = []
        for r in roles:
            d = bd if r == "b" else cd if r == "c" else None
            out.append(Shard(d) if d is not None
                       else Partial() if grad and r else Replicate())
        return tuple(out)
    out = [place(bd, cd) for bd, cd in outs]
    # one output's placements a list: local_map reads a tuple as several
    return local_map(
        fn, out_placements=list(out[0]) if len(out) == 1 else tuple(out),
        in_placements=tuple(place(bd, cd) for _, bd, cd in args),
        in_grad_placements=tuple(place(bd, cd, True) for _, bd, cd in args),
        device_mesh=mesh)(*(t.redistribute(mesh, place(bd, cd))
                            for t, bd, cd in args))


def _causal_conv1d(x, w, b):
    """x: (B, S, C), depthwise causal conv with kernel (K, C): K shifted
    adds, as the reference unrolls them.  On DTensors it runs on each
    rank's rows and channels (:func:`_on_shards`; the sequence whole)."""
    if _is_dtensor(x):
        return _on_shards(_causal_conv1d, x.placements,
                          [(x, 0, 2), (w, None, 1), (b, None, 0)], [(0, 2)])
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _linear_scan(a, dr, h0, sub=_SUB):
    """Every ``h_t = a_t * h_{t-1} + dr_t`` along axis 1 of ``a``, ``dr``
    (B, c, ...), from ``h0`` (B, ...).

    Two levels, out of place (autograd differentiates it): each sub-block
    of ``sub`` positions runs the recurrence from zero and the product of
    its decays, all sub-blocks at once, one position at a time; then each
    sub-block's incoming state, block by block; then ``h = local +
    decay_product * incoming``.
    """
    B, c = a.shape[:2]
    rest = a.shape[2:]
    nb = -(-c // sub)
    pad = (0, 0) * len(rest) + (0, nb * sub - c)
    a = F.pad(a, pad, value=1.0).reshape(B, nb, sub, *rest)
    dr = F.pad(dr, pad).reshape(B, nb, sub, *rest)
    local, decay = [dr[:, :, 0]], [a[:, :, 0]]
    for j in range(1, sub):
        local.append(torch.addcmul(dr[:, :, j], a[:, :, j], local[-1]))
        decay.append(decay[-1] * a[:, :, j])
    incoming = [h0]
    for blk in range(nb - 1):
        incoming.append(torch.addcmul(local[-1][:, blk], decay[-1][:, blk],
                                      incoming[-1]))
    h = torch.addcmul(torch.stack(local, 2), torch.stack(decay, 2),
                      torch.stack(incoming, 1)[:, :, None])
    return h.reshape(B, nb * sub, *rest)[:, :c]


def _decay_and_drive(dt, A, Bm, xf, sl):
    """The log decay ``dt * A`` and the drive ``dt * B * x`` (B, c, di, N)
    of positions ``sl``."""
    d = dt[:, sl, :, None]
    return d * A, d * Bm[:, sl, None, :] * xf[:, sl, :, None]


def _scan(dt, A, Bm, Cm, xf, chunk):
    """The selective scan from a zero state, chunk by chunk (the
    reference's one-chunk fallback where ``chunk`` does not divide S):
    (y (B, S, di) before the skip, the last state (B, di, N)), float32."""
    B, S = xf.shape[:2]
    c = min(chunk, S)
    if S % c:
        c = S
    h = torch.zeros((B,) + tuple(A.shape), dtype=torch.float32,
                    device=xf.device)
    ys = []
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        ld, dr = _decay_and_drive(dt, A, Bm, xf, sl)
        hs = _linear_scan(torch.exp(ld), dr, h)
        ys.append(torch.einsum("bscn,bsn->bsc", hs, Cm[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def mamba_apply(p: Mamba, x, state=None, chunk=_CHUNK):
    """x: (B, S, d) -> (y, (h, conv_tail)).

    ``state`` None: the chunked scan over S (training / prefill), the
    raw (pre-conv) tail kept for decode; ``state = (h, conv_tail)``: one
    decode step (S == 1).
    """
    B, S, _ = x.shape
    K = p.conv_w.shape[0]
    # sharded, the sequence stays whole (the scan splits it into chunks
    # by views) and TP takes the channels
    xi, z = map(rows_ready, torch.einsum("bsd,de->bse", rows_ready(x),
                                         p.w_in).chunk(2, -1))
    if state is None:
        conv_tail = xi[:, -(K - 1):]       # raw (pre-conv) tail for decode
        xi = _causal_conv1d(xi, p.conv_w, p.conv_b)
    else:
        if S != 1:
            raise ValueError(f"a Mamba decode step takes one token, got {S}")
        seq = torch.cat([state[1], xi], 1)
        conv_tail = seq[:, -(K - 1):]
        xi = (seq[:, -K:] * p.conv_w).sum(1, keepdim=True) + p.conv_b
    xi = F.silu(xi)
    # sharded, Bm and Cm are whole on every rank of a batch row: TP on
    # w_bc's 2N columns would leave them sharded on N, or (after the
    # split) on the sequence
    Bm, Cm = batch_only(torch.einsum("bsc,ce->bse", xi, p.w_bc)
                        ).float().chunk(2, -1)
    # sharded, the products over the channels are summed where they are
    # made: a Partial meeting a Shard needs Shard -> Partial, which torch
    # 2.11 cannot redistribute
    dt = F.softplus(_reduced(torch.einsum("bsc,co->bso", xi, p.w_dt)).float()
                    + p.dt_bias.float())                        # (B,S,di)
    A = -torch.exp(p.A_log)          # in the weights' dtype, as the reference
    xf = xi.float()
    if state is None:
        if _is_dtensor(xf):
            # on each rank's rows and channels, Bm and Cm whole
            y, h = _on_shards(
                lambda *a: _scan(*a, chunk), xi.placements,
                [(dt, 0, 2), (A, None, 0), (Bm, 0, None), (Cm, 0, None),
                 (xf, 0, 2)], [(0, 2), (0, 1)])
        else:
            y, h = _scan(dt, A, Bm, Cm, xf, chunk)
    else:
        ld, dr = _decay_and_drive(dt, A, Bm, xf, slice(0, 1))
        h = torch.exp(ld[:, 0]) * state[0] + dr[:, 0]
        y = torch.einsum("bcn,bn->bc", h, Cm[:, 0])[:, None]
    y = y + p.D_skip.float() * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    return (rows_ready(_reduced(torch.einsum("bsc,cd->bsd", rows_ready(y),
                                             p.w_out))), (h, conv_tail))


def mamba_init_state(p: Mamba, batch: int, dtype=torch.float32):
    """(h (batch, di, N) float32, conv_tail (batch, K-1, di) ``dtype``)."""
    di, N = p.A_log.shape
    K = p.conv_w.shape[0]
    dev = p.A_log.device
    return (torch.zeros((batch, di, N), dtype=torch.float32, device=dev),
            torch.zeros((batch, K - 1, di), dtype=dtype, device=dev))


# --------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise form) and sLSTM (sequential)
# --------------------------------------------------------------------------

def _mlstm_chunk(carry, qb, kb, vb, lf, ii):
    """One chunk of the stabilised chunkwise mLSTM (per head; carry (C,
    n, m)): intra ``D_ij = exp(F_i - F_j + i_j - m_i)`` for j <= i, inter
    the carried C at decay ``exp(F_i + m - m_i)``; returns (the new carry,
    y (B, c, H, dh))."""
    Cst, nst, mst = carry
    qb, kb, vb = qb.float(), kb.float(), vb.float()
    c = qb.shape[1]
    Fc = torch.cumsum(lf, 1)                                  # (B,c,H)
    intra = Fc[:, :, None] - Fc[:, None, :] + ii[:, None, :, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=qb.device).tril()
    intra = torch.where(causal[None, :, :, None], intra, -math.inf)
    inter = Fc + mst[:, None]                                 # (B,c,H)
    m_i = torch.clamp(torch.maximum(intra.detach().amax(2), inter.detach()),
                      min=0.0)
    dintra = torch.exp(intra - m_i[:, :, None])
    dinter = torch.exp(inter - m_i)
    wmat = torch.einsum("bqhx,bkhx->bqkh", qb, kb) * dintra
    y_intra = torch.einsum("bqkh,bkhd->bqhd", wmat, vb)
    y_inter = torch.einsum("bqhk,bhkd->bqhd", qb, Cst) * dinter[..., None]
    # q·n = sum_j wmat[q, j] + dinter·(q·n_st)
    den_inter = torch.einsum("bqhk,bhk->bqh", qb, nst) * dinter
    den = torch.maximum((wmat.sum(2) + den_inter).abs(), torch.exp(-m_i))
    y = (y_intra + y_inter) / den[..., None]
    F_tot = Fc[:, -1]                                         # (B,H)
    m_up = torch.maximum(F_tot + mst, (F_tot[:, None] - Fc + ii).amax(1))
    sc_old = torch.exp(F_tot + mst - m_up)
    sc_tok = torch.exp(F_tot[:, None] - Fc + ii - m_up[:, None])
    C_new = sc_old[..., None, None] * Cst + torch.einsum(
        "bkh,bkhx,bkhd->bhxd", sc_tok, kb, vb)
    n_new = sc_old[..., None] * nst + torch.einsum("bkh,bkhx->bhx", sc_tok,
                                                    kb)
    return (C_new, n_new, m_up), y


def mlstm_apply(p: MLSTM, x, state=None, chunk=_CHUNK):
    """Stabilised mLSTM, x: (B, S, d) -> (y, (C, n, m)).  The chunkwise
    form over sequences (from ``state`` or zeros); the O(1) update for one
    token with a ``state``."""
    B, S, _ = x.shape
    H, dh = p.wq.shape[1], p.wq.shape[2]
    xi, z = map(rows_ready, torch.einsum("bsd,de->bse", rows_ready(x),
                                         p.w_up).chunk(2, -1))
    q = to_heads(xi, p.wq) / math.sqrt(dh)
    k = to_heads(xi, p.wk) / math.sqrt(dh)
    v = to_heads(xi, p.wv)
    gates = (torch.einsum("bse,eg->bsg", xi.float(), p.w_if.float())
             + p.if_bias)
    ig, fg = gates.chunk(2, -1)                               # (B,S,H)
    log_f = -F.softplus(-fg)
    st = mlstm_init_state_b(B, H, dh, x.device) if state is None else state

    if S == 1 and state is not None:
        C_prev, n_prev, m_prev = st
        lf, ii = log_f[:, 0], ig[:, 0]
        m_new = torch.maximum(lf + m_prev, ii)
        fsc = torch.exp(lf + m_prev - m_new)
        isc = torch.exp(ii - m_new)
        qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        C = fsc[..., None, None] * C_prev + isc[..., None, None] * \
            torch.einsum("bhk,bhd->bhkd", kf, vf)
        n = fsc[..., None] * n_prev + isc[..., None] * kf
        num = torch.einsum("bhk,bhkd->bhd", qf, C)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, None]
        new_state = (C, n, m_new)
    else:
        c = min(chunk, S)
        if S % c:
            c = S

        def chunks(q, k, v, log_f, ig, *st):
            if not st:
                st = mlstm_init_state_b(q.shape[0], q.shape[2], dh,
                                        q.device)
            ys = []
            for s0 in range(0, S, c):
                sl = slice(s0, s0 + c)
                st, y = _mlstm_chunk(st, q[:, sl], k[:, sl], v[:, sl],
                                     log_f[:, sl], ig[:, sl])
                ys.append(y)
            return (torch.cat(ys, 1), *st)
        if _is_dtensor(q):
            # per batch row and head, on each rank's shard: DTensor cannot
            # flatten the (batch, heads) of the chunks' products when both
            # are sharded
            st = () if state is None else tuple(st)
            y, *new_state = on_head_shards(
                chunks, (q, k, v, log_f, ig, *st),
                (2, 2, 2, 2, 2, 1, 1, 1)[:5 + len(st)],
                [(4, 2), (4, 1), (3, 1), (2, 1)])
        else:
            y, *new_state = chunks(q, k, v, log_f, ig, *st)
        new_state = tuple(new_state)

    # sharded, the head dim's shard (the norm's scale takes TP on it)
    # leaves it before the (heads, head dim) flatten
    y = group_ready(norm_apply(p.out_norm, y.to(x.dtype)), 2, 3)
    y = rows_ready(y.reshape(B, S, -1) * F.silu(z))
    return rows_ready(torch.einsum("bse,ed->bsd", y, p.w_down)), new_state


def mlstm_init_state_b(batch: int, H: int, dh: int, device=None):
    """(C (batch, H, dh, dh), n (batch, H, dh), m (batch, H)), float32
    zeros."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, dh, dh), **f32),
            torch.zeros((batch, H, dh), **f32),
            torch.zeros((batch, H), **f32))


def mlstm_init_state(p: MLSTM, batch: int):
    return mlstm_init_state_b(batch, p.wq.shape[1], p.wq.shape[2],
                              p.wq.device)


def _slstm_steps(wx, R, c, n, h, m):
    """The sLSTM's recurrence over wx (B, S, 4d) from the state (c, n, h,
    m): (the hidden states (B, S, d), the last state)."""
    hs = []
    for t in range(wx.shape[1]):
        zt, it, ft, ot = (wx[:, t] + h @ R).chunk(4, -1)
        lf = -F.softplus(-ft)
        m_new = torch.maximum(lf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(zt)
        n = f_s * n + i_s
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), c, n, h, m


def slstm_apply(p: SLSTM, x, state=None):
    """sLSTM with exponential gating, x: (B, S, d) -> (y, (c, n, h, m)):
    the hidden-to-gate feedback makes it sequential, one step a token.
    On DTensors the steps run on each rank's batch rows, every channel on
    every rank (:func:`_on_shards`; ``h @ R`` mixes them all)."""
    B, S, D = x.shape
    wx = torch.einsum("bsd,dg->bsg", rows_ready(x).float(),
                      p.w_gates.float())
    R = p.r_gates.float()
    if _is_dtensor(wx):
        def steps(wx, bias, R, *st):
            if not st:              # zeros of this rank's rows
                st = (wx.new_zeros((wx.shape[0], R.shape[0])),) * 4
            return _slstm_steps(wx + bias, R, *st)
        rows = batch_only(wx)
        hs, *state = _on_shards(
            steps, rows.placements,
            [(rows, 0, None), (p.g_bias, None, None), (R, None, None)]
            + [(t, 0, None) for t in state or ()], [(0, None)] * 5)
    else:
        if state is None:
            state = slstm_init_state(p, B)
        hs, *state = _slstm_steps(wx + p.g_bias, R, *state)
    y = rows_ready(norm_apply(p.out_norm, hs.to(x.dtype)))
    return (rows_ready(torch.einsum("bsd,de->bse", y, p.w_down)),
            tuple(state))


def slstm_init_state(p: SLSTM, batch: int):
    """(c, n, h, m), each (batch, d) float32 zeros."""
    z = torch.zeros((batch, p.w_down.shape[0]), dtype=torch.float32,
                    device=p.w_down.device)
    return (z, z, z, z)
