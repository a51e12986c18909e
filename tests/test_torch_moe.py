"""The port's MoE MLP against the JAX package, on the CPU.

``repro_torch.models.layers.moe_apply`` against ``repro.models.layers.
moe_apply`` on the same weights and inputs (made from numpy seeds): the
capacity dispatch with and without ``no_drop``, the decode fast path
(``T * k <= E``), a forced capacity overflow (a router biased towards one
expert, so the same assignments must drop in the same token-major order),
an ungated expert MLP, the load-balance ``aux`` term, the count of dropped
assignments, and every gradient against ``jax.grad``.  Tolerances are
relative to the compared tensor's own max abs: 1e-5 in float32, 2e-2 in
bfloat16 (a few ulps of bf16 products), as ``test_torch_lm.py``'s
``LAYER_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import init_lm as ref_init_lm
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.interop import lm_params_from_reference, lm_tree_to_reference
from repro_torch.models import layers

LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
D, FF, E = 32, 48, 4


def _rel(got, want) -> float:
    g = np.asarray(torch.as_tensor(got).detach().float(), np.float32)
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    return err / scale if scale > 0 else err


def _moe(dtype, glu=True, seed=0, bias_to=None):
    """The reference's ``init_moe`` tree in ``dtype`` (the router cast
    too, as the reference's ``cast_params`` casts it) and the port's
    ``MoE`` holding the same values.  ``bias_to``: add 3 to that expert's
    router weight from feature 0 (which :func:`_x` may hold at 3), so
    most tokens pick it first."""
    rp = ref_layers.init_moe(jax.random.PRNGKey(seed), D, FF, E, glu)
    if bias_to is not None:
        rp["router"] = rp["router"].at[0, bias_to].add(3.0)
    rp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), rp)
    p = layers.MoE(D, FF, E, glu)
    for k, v in rp.items():
        getattr(p, k).data = torch.tensor(
            np.asarray(v.astype(jnp.float32))).to(getattr(torch, dtype))
    return rp, p


def _x(shape, seed, dtype, feature0=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if feature0 is not None:
        a[..., 0] = feature0
    t = torch.as_tensor(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _expected_drops(top_i, cap):
    """Token-major ranks of (T, k) choices: which assignments drop."""
    seen, drop = {}, np.zeros(top_i.shape, bool)
    for t in range(top_i.shape[0]):
        for j in range(top_i.shape[1]):
            e = int(top_i[t, j])
            drop[t, j] = seen.get(e, 0) >= cap
            seen[e] = seen.get(e, 0) + 1
    return drop


CASES = {
    # name: (B, S, capacity_factor, no_drop)
    "capacity": (2, 24, 1.25, False),
    "tight_capacity": (2, 24, 0.5, False),
    "no_drop": (2, 24, 1.25, True),
    "decode_fast_path": (2, 1, 1.25, True),
    "one_token_capacity": (1, 1, 1.25, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, dtype):
    B, S, cf, no_drop = CASES[case]
    rp, p = _moe(dtype)
    jx, tx = _x((B, S, D), 1, dtype)
    want, want_aux = ref_layers.moe_apply(rp, jx, 2, "silu", cf, no_drop)
    stats = {}
    got, aux = layers.moe_apply(p, tx, 2, "silu", cf, no_drop, stats=stats)
    assert got.shape == (B, S, D) and got.dtype == tx.dtype
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    T = B * S
    cap = T if no_drop else max(int(cf * T * 2 / E), 1)
    drops = _expected_drops(stats["top_i"].numpy(), cap)
    fast = no_drop and T * 2 <= E
    assert int(stats["dropped"]) == (0 if fast else int(drops.sum()))
    if case == "tight_capacity":
        assert drops.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_overflow_drops_the_same_assignments(dtype):
    """A router biased to expert 2: every token chooses it, at least twice
    its capacity (capacity factor 0.5).  The rows of the tokens whose
    choice of expert 2 drops must match the reference's, which holds only
    their second expert's share; the count of drops is the token-major
    count."""
    rp, p = _moe(dtype, bias_to=2)
    B, S, cf = 2, 32, 0.5
    jx, tx = _x((B, S, D), 2, dtype, feature0=3.0)
    want, want_aux = ref_layers.moe_apply(rp, jx, 2, "silu", cf)
    stats = {}
    got, aux = layers.moe_apply(p, tx, 2, "silu", cf, stats=stats)
    top_i = stats["top_i"].numpy()
    cap = int(cf * B * S * 2 / E)
    drops = _expected_drops(top_i, cap)
    overloaded = (top_i == 2).sum()
    assert overloaded > 2 * cap
    assert drops[top_i == 2].sum() == overloaded - cap
    # the first `cap` tokens that chose expert 2 keep it, token-major
    kept_rows = np.nonzero((top_i == 2).any(1))[0][:cap]
    assert not drops[kept_rows][top_i[kept_rows] == 2].any()
    assert int(stats["dropped"]) == int(drops.sum())
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]
    dropped_rows = np.nonzero(drops.any(1))[0]
    assert _rel(got.reshape(B * S, D)[dropped_rows],
                np.asarray(want.astype(jnp.float32)).reshape(B * S, D)[
                    dropped_rows]) <= LAYER_TOL[dtype]
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("act,glu", [("gelu", True), ("relu2", False)])
def test_moe_apply_activations_match_reference(act, glu):
    """Grok's gelu experts, and an ungated MoE (no ``w_gate``)."""
    rp, p = _moe("float32", glu=glu, seed=3)
    assert hasattr(p, "w_gate") == glu
    jx, tx = _x((2, 16, D), 4, "float32")
    for no_drop in (False, True):
        want, _ = ref_layers.moe_apply(rp, jx, 2, act, 1.25, no_drop)
        got, _ = layers.moe_apply(p, tx, 2, act, 1.25, no_drop)
        assert _rel(got, want) <= LAYER_TOL["float32"]


@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_gradients_match_jax_grad(no_drop):
    """d(sum(y * r) + aux)/d(x, router, w_in, w_gate, w_out) at 1e-4 of
    each gradient's max abs (float32), with drops (cf 1.0) and without."""
    rp, p = _moe("float32", seed=5)
    jx, tx = _x((2, 16, D), 6, "float32")
    r = np.random.default_rng(7).standard_normal((2, 16, D)).astype(
        np.float32)

    def ref_fn(params, x):
        y, aux = ref_layers.moe_apply(params, x, 2, "silu", 1.0, no_drop)
        return jnp.sum(y * r) + aux

    gp, gx = jax.grad(ref_fn, argnums=(0, 1))(rp, jx)
    p.requires_grad_(True)
    tx.requires_grad_(True)
    y, aux = layers.moe_apply(p, tx, 2, "silu", 1.0, no_drop)
    names = dict(p.named_parameters())
    grads = torch.autograd.grad((y * torch.as_tensor(r)).sum() + aux,
                                [tx, *names.values()])
    assert _rel(grads[0], gx) <= 1e-4
    for (k, _), g in zip(names.items(), grads[1:]):
        assert _rel(g, gp[k]) <= 1e-4, k
    assert float(grads[1 + list(names).index("router")].abs().max()) > 0


def test_moe_module_names_shapes_and_router_dtype():
    """The reference's ``init_moe`` keys and shapes; the router stays
    float32 when the experts' weights are bfloat16, as the reference's."""
    want = jax.eval_shape(lambda k: ref_layers.init_moe(
        k, D, FF, E, True, jnp.bfloat16), jax.random.PRNGKey(0))
    p = layers.MoE(D, FF, E, True, torch.Generator().manual_seed(0),
                   dtype=torch.bfloat16)
    got = {k: (tuple(v.shape), v.dtype) for k, v in p.state_dict().items()}
    assert got == {k: (tuple(v.shape), getattr(torch, str(v.dtype)))
                   for k, v in want.items()}
    assert float(p.w_in.float().std()) > 0


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "grok_1_314b"])
def test_moe_leaves_round_trip_through_interop(arch):
    """The reference's MoE LM tree into the port's modules and back, leaf
    for leaf (the router's float32 included)."""
    rcfg = ref_configs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, ref_init_lm(rcfg, jax.random.PRNGKey(1)))
    cfg = configs.get_smoke(arch)
    lm = lm_params_from_reference(cfg, tree, device="cpu")
    assert lm.blocks[0].moe.router.dtype == torch.float32
    back = lm_tree_to_reference(cfg, dict(lm.named_parameters()))
    assert set(back["blocks"]["moe"]) == set(tree["blocks"]["moe"])
    for k, v in tree["blocks"]["moe"].items():
        np.testing.assert_array_equal(back["blocks"]["moe"][k], v)
    assert "mlp" not in back["blocks"]
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    lm16 = lm_params_from_reference(bf, tree, device="cpu")
    assert lm16.blocks[1].moe.router.dtype == torch.float32
    assert lm16.blocks[1].moe.w_in.dtype == torch.bfloat16
