"""The port's state-space and recurrent blocks against the JAX package, on
the CPU.

``repro_torch.models.ssm`` against ``repro.models.ssm`` on the same weights
and inputs (made from numpy seeds):

* ``mamba_apply``: S a multiple of the 256-position chunk (two chunks), S
  that is not (the reference's one-chunk fallback), S shorter than a
  chunk, decode steps after the prefill (the conv tail and the scan
  state), and its gradients; ``_linear_scan`` against the recurrence step
  by step;
* ``mlstm_apply``: the chunkwise form (two chunks, one odd chunk, from a
  carried state) and O(1) decode steps, and its gradients;
* ``slstm_apply``: from zeros and from a state, one-token steps, and its
  gradients;
* the state initialisers, the modules' names, shapes and float32 leaves,
  and each new leaf's round trip through ``interop`` (hymba's ``ssm``,
  xlstm's superset ``mlstm``/``slstm`` on every layer).

Tolerances are relative to the compared tensor's own max abs, as
``test_torch_lm.py``'s ``LAYER_TOL``: 1e-5 in float32 (sums in another
order; the scan's two levels against the reference's tree), 2e-2 in
bfloat16; gradients 1e-4 in float32, as ``test_torch_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import init_lm as ref_init_lm
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.interop import (lm_params_from_reference,
                                 lm_tree_to_reference,
                                 opt_state_from_reference)
from repro_torch.models import ssm

LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
D, H = 32, 4


def _rel(got, want) -> float:
    g = np.asarray(torch.as_tensor(got).detach().float(), np.float32)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float32)
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    return err / scale if scale > 0 else err


def _port(module, tree, dtype):
    """``module`` holding the reference tree ``tree`` (every leaf in
    ``dtype``, as the reference's ``cast_params`` casts them)."""
    for name, v in _flat(tree).items():
        obj = module
        *path, leaf = name.split(".")
        for k in path:
            obj = getattr(obj, k)
        getattr(obj, leaf).data = torch.tensor(
            np.asarray(jnp.asarray(v).astype(jnp.float32))).to(
                getattr(torch, dtype))
    return module


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), tree)


def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.as_tensor(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _mamba(dtype, seed=0):
    rp = _cast(ref_ssm.init_mamba(jax.random.PRNGKey(seed), D, 8, 2, 4),
               dtype)
    return rp, _port(ssm.Mamba(D, 8, 2, 4), rp, dtype)


def _mlstm(dtype, seed=1):
    rp = _cast(ref_ssm.init_mlstm(jax.random.PRNGKey(seed), D, H, 2), dtype)
    return rp, _port(ssm.MLSTM(D, H, 2), rp, dtype)


def _slstm(dtype, seed=2):
    rp = _cast(ref_ssm.init_slstm(jax.random.PRNGKey(seed), D, H), dtype)
    return rp, _port(ssm.SLSTM(D, H), rp, dtype)


def _assert_states(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), (what, i)
        assert g.dtype == getattr(torch, str(w.dtype)), (what, i)
        assert _rel(g, w) <= tol, (what, i, _rel(g, w))


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sub", [16, 5])
@pytest.mark.parametrize("c", [1, 16, 37, 256])
def test_linear_scan_matches_the_recurrence(c, sub):
    """Every h_t of h_t = a_t h_{t-1} + dr_t, sub-blocks that divide the
    chunk and that do not."""
    rng = np.random.default_rng(c)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, c, 3, 4)).astype(
        np.float32))
    dr = torch.as_tensor(rng.standard_normal((2, c, 3, 4)).astype(
        np.float32))
    h0 = torch.as_tensor(rng.standard_normal((2, 3, 4)).astype(np.float32))
    want, h = [], h0
    for t in range(c):
        h = a[:, t] * h + dr[:, t]
        want.append(h)
    got = ssm._linear_scan(a, dr, h0, sub=sub)
    assert got.shape == (2, c, 3, 4)
    assert _rel(got, torch.stack(want, 1).numpy()) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [512, 100, 64])
def test_mamba_prefill_then_decode_matches_reference(S, dtype):
    """The chunked scan (512: two chunks; 100: one chunk of 100, the
    reference's fallback; 64: one short chunk), its state (h, raw conv
    tail), then three decode steps from that state."""
    rp, p = _mamba(dtype)
    jx, tx = _x((2, S + 3, D), S, dtype)
    tol = LAYER_TOL[dtype]
    want, wst = ref_ssm.mamba_apply(rp, jx[:, :S])
    got, st = ssm.mamba_apply(p, tx[:, :S])
    assert got.dtype == tx.dtype and got.shape == (2, S, D)
    assert _rel(got, want) <= tol
    _assert_states(st, wst, tol, "prefill state")
    for t in range(S, S + 3):
        want, wst = ref_ssm.mamba_apply(rp, jx[:, t:t + 1], wst)
        got, st = ssm.mamba_apply(p, tx[:, t:t + 1], st)
        assert _rel(got, want) <= tol, t
        _assert_states(st, wst, tol, f"decode state {t}")


def test_mamba_decode_takes_one_token():
    rp, p = _mamba("float32")
    with pytest.raises(ValueError, match="one token"):
        ssm.mamba_apply(p, torch.zeros(1, 2, D),
                        ssm.mamba_init_state(p, 1))


def test_mamba_gradients_match_jax_grad():
    """d(sum(y * r))/d(x and every weight) over two chunks (S 512): the
    scan's backward through both levels and the carried state."""
    rp, p = _mamba("float32", seed=3)
    S = 512
    jx, tx = _x((1, S, D), 4, "float32")
    r = np.random.default_rng(5).standard_normal((1, S, D)).astype(
        np.float32)
    gp, gx = jax.grad(lambda q, x: jnp.sum(ref_ssm.mamba_apply(q, x)[0] * r),
                      argnums=(0, 1))(rp, jx)
    p.requires_grad_(True)
    tx.requires_grad_(True)
    names = dict(p.named_parameters())
    y, _ = ssm.mamba_apply(p, tx)
    grads = torch.autograd.grad((y * torch.as_tensor(r)).sum(),
                                [tx, *names.values()])
    assert _rel(grads[0], gx) <= GRAD_TOL
    for (k, _), g in zip(names.items(), grads[1:]):
        assert _rel(g, gp[k]) <= GRAD_TOL, k


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [512, 100])
def test_mlstm_chunkwise_then_decode_matches_reference(S, dtype):
    """The chunkwise form (two chunks; one chunk of 100), its state, a
    second sequence from that state (chunkwise, carried), then three O(1)
    decode steps."""
    rp, p = _mlstm(dtype)
    jx, tx = _x((2, S + 16 + 3, D), S + 1, dtype)
    tol = LAYER_TOL[dtype]
    want, wst = ref_ssm.mlstm_apply(rp, jx[:, :S])
    got, st = ssm.mlstm_apply(p, tx[:, :S])
    assert got.dtype == tx.dtype and got.shape == (2, S, D)
    assert _rel(got, want) <= tol
    _assert_states(st, wst, tol, "chunkwise state")
    want, wst = ref_ssm.mlstm_apply(rp, jx[:, S:S + 16], wst)
    got, st = ssm.mlstm_apply(p, tx[:, S:S + 16], st)
    assert _rel(got, want) <= tol
    _assert_states(st, wst, tol, "carried state")
    for t in range(S + 16, S + 19):
        want, wst = ref_ssm.mlstm_apply(rp, jx[:, t:t + 1], wst)
        got, st = ssm.mlstm_apply(p, tx[:, t:t + 1], st)
        assert _rel(got, want) <= tol, t
        _assert_states(st, wst, tol, f"decode state {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_matches_reference(dtype):
    """From zeros over 24 tokens, then from that state over 8, then one
    token at a time."""
    rp, p = _slstm(dtype)
    jx, tx = _x((2, 35, D), 9, dtype)
    tol = LAYER_TOL[dtype]
    want, wst = ref_ssm.slstm_apply(rp, jx[:, :24])
    got, st = ssm.slstm_apply(p, tx[:, :24])
    assert got.dtype == tx.dtype and _rel(got, want) <= tol
    _assert_states(st, wst, tol, "state")
    for lo, hi in ((24, 32), (32, 33), (33, 34), (34, 35)):
        want, wst = ref_ssm.slstm_apply(rp, jx[:, lo:hi], wst)
        got, st = ssm.slstm_apply(p, tx[:, lo:hi], st)
        assert _rel(got, want) <= tol, lo
        _assert_states(st, wst, tol, f"state {lo}")


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_cell_gradients_match_jax_grad(cell):
    """d(sum(y * r))/d(x and every weight), float32; the mLSTM over two
    chunks of 256 (its stabiliser under ``detach``, as the reference's
    ``stop_gradient``)."""
    rp, p = (_mlstm if cell == "mlstm" else _slstm)("float32", seed=6)
    ref_apply = getattr(ref_ssm, f"{cell}_apply")
    apply = getattr(ssm, f"{cell}_apply")
    S = 512 if cell == "mlstm" else 20
    jx, tx = _x((1, S, D), 7, "float32")
    r = np.random.default_rng(8).standard_normal((1, S, D)).astype(
        np.float32)
    gp, gx = jax.grad(lambda q, x: jnp.sum(ref_apply(q, x)[0] * r),
                      argnums=(0, 1))(rp, jx)
    gp = _flat(gp)
    p.requires_grad_(True)
    tx.requires_grad_(True)
    names = dict(p.named_parameters())
    y, _ = apply(p, tx)
    grads = torch.autograd.grad((y * torch.as_tensor(r)).sum(),
                                [tx, *names.values()])
    assert _rel(grads[0], gx) <= GRAD_TOL
    for (k, _), g in zip(names.items(), grads[1:]):
        assert _rel(g, gp[k]) <= GRAD_TOL, k


# --------------------------------------------------------------------------
# structure: states, names, interop
# --------------------------------------------------------------------------

def test_state_initialisers_match_reference():
    for dtype in ("float32", "bfloat16"):
        rp, p = _mamba("float32")
        _assert_states(ssm.mamba_init_state(p, 3, getattr(torch, dtype)),
                       ref_ssm.mamba_init_state(rp, 3, getattr(jnp, dtype)),
                       0.0, "mamba")
    rp, p = _mlstm("float32")
    _assert_states(ssm.mlstm_init_state(p, 3),
                   ref_ssm.mlstm_init_state(rp, 3), 0.0, "mlstm")
    _assert_states(ssm.mlstm_init_state_b(2, 4, 8),
                   ref_ssm.mlstm_init_state_b(2, 4, 8), 0.0, "mlstm_b")
    rp, p = _slstm("float32")
    _assert_states(ssm.slstm_init_state(p, 3),
                   ref_ssm.slstm_init_state(rp, 3), 0.0, "slstm")


@pytest.mark.parametrize("name,args", [("mamba", (D, 8, 2, 4)),
                                       ("mlstm", (D, H, 2)),
                                       ("slstm", (D, H))])
def test_modules_have_the_reference_names_shapes_and_dtypes(name, args):
    """Leaves by name, shape and dtype with bfloat16 weights (the
    reference keeps ``A_log``, ``w_if``, ``if_bias``, ``g_bias`` and the
    out norms float32), and the constant leaves' values."""
    want = jax.eval_shape(
        lambda k: getattr(ref_ssm, f"init_{name}")(k, *args,
                                                   dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    cls = {"mamba": ssm.Mamba, "mlstm": ssm.MLSTM, "slstm": ssm.SLSTM}[name]
    p = cls(*args, generator=torch.Generator().manual_seed(0),
            dtype=torch.bfloat16)
    got = {k: (tuple(v.shape), v.dtype) for k, v in p.state_dict().items()}
    assert got == {k: (tuple(v.shape), getattr(torch, str(v.dtype)))
                   for k, v in _flat(want).items()}
    ref = _flat(getattr(ref_ssm, f"init_{name}")(jax.random.PRNGKey(0),
                                                 *args))
    for k in ("conv_b", "dt_bias", "A_log", "D_skip", "if_bias", "g_bias",
              "out_norm.scale"):
        if k in ref:       # A_log: log(n), within an ulp of XLA's log
            np.testing.assert_allclose(p.state_dict()[k].float().numpy(),
                                       np.asarray(ref[k]), rtol=1e-6)


@pytest.mark.parametrize("arch,cell", [("hymba_1_5b", "ssm"),
                                       ("xlstm_350m", "mlstm"),
                                       ("xlstm_350m", "slstm")])
def test_new_leaves_round_trip_through_interop(arch, cell):
    """The reference's LM tree into the port's modules and back, leaf for
    leaf, and an optimizer state keyed by the same names: hymba's Mamba
    head, and both cells on every xlstm layer (the reference's superset)."""
    tree = jax.tree.map(np.asarray, ref_init_lm(ref_configs.get_smoke(arch),
                                                jax.random.PRNGKey(2)))
    cfg = configs.get_smoke(arch)
    lm = lm_params_from_reference(cfg, tree, device="cpu")
    for blk in lm.blocks:
        assert hasattr(blk, cell)
    back = lm_tree_to_reference(cfg, dict(lm.named_parameters()))
    want, got = _flat(tree["blocks"][cell]), _flat(back["blocks"][cell])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    moments = {"mu": tree, "nu": tree, "count": np.int32(3)}
    state = opt_state_from_reference(cfg, moments, device="cpu")
    assert set(state["mu"]) == set(dict(lm.named_parameters()))
