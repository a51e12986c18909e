"""Parity of the port's kernel path with the JAX reference on the CPU, on
plans the other parity tests do not reach: multi-group plans (every fuse
``strategy``) and bfloat16 in fused loops under both schedules.

The same seeded numpy inputs (``test_torch_parity.app_data``) go through
the reference's ``compile_program`` (``pallas`` in interpret mode, as its
own tests run it) and the port's (``cuda`` with ``device="cpu"``: the
orchestrators over each kernel's plain PyTorch version).

Tolerances are the reference's own: 1e-5 for every strategy, single step
and fused (``tests/test_fused_loop.py``'s multi-group test); bfloat16
against the reference's float32 result at its bfloat16 bound, 0.15
absolute and relative (``tests/test_backends_parity.py``).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from repro.core import compile_program as ref_compile
from repro_torch import compile_program
from repro_torch.core import TileDemotionWarning
from test_torch_parity import APPS, BOUNDARIES, app_data


@functools.lru_cache(maxsize=None)
def _reference(name, boundary, grid, steps=None, strategy="auto"):
    """The reference's float32 ``pallas`` outputs (single step) or final
    fields (``steps``) as numpy arrays, and its plan's fuse groups."""
    ref_app, _, ref_upd, _ = APPS[name]
    fields, scalars, coeffs = app_data(name, grid)
    kw = {} if steps is None else dict(steps=steps, update=ref_upd())
    ex = ref_compile(ref_app(boundary), grid, backend="pallas",
                     strategy=strategy, **kw)
    out = {k: np.asarray(v) for k, v in ex(fields, scalars, coeffs).items()}
    return out, [list(g) for g in ex.plan.groups]


def _port(name, boundary, grid, steps=None, **kw):
    _, app, _, upd = APPS[name]
    fields, scalars, coeffs = app_data(name, grid)
    if steps is not None:
        kw.update(steps=steps, update=upd())
    ex = compile_program(app(boundary), grid, backend="cuda", device="cpu",
                         **kw)
    return ex, ex(fields, scalars, coeffs)


@pytest.mark.parametrize("steps", [None, 2])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
@pytest.mark.parametrize("strategy", ["fused", "per_field", "auto"])
def test_kernel_backend_matches_pallas_for_every_strategy(strategy, name,
                                                          boundary, steps):
    """Every fuse strategy, single step and two fused steps: the port
    splits the program into the reference's groups, and inter-group
    fields re-padded between kernels give the reference's results."""
    grid = (6, 8, 64)
    want, groups = _reference(name, boundary, grid, steps, strategy)
    ex, got = _port(name, boundary, grid, steps, strategy=strategy)
    assert [list(g) for g in ex.plan.groups] == groups
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                   rtol=1e-5, err_msg=f"{strategy} {k}")


@pytest.mark.parametrize("schedule,time_tile", [("block", 1), ("stream", 2)])
@pytest.mark.parametrize("name", sorted(APPS))
def test_bfloat16_fused_loop_within_the_reference_bound(name, schedule,
                                                        time_tile):
    """Four fused bfloat16 steps (zero boundary) under the block schedule
    and under the stream schedule at ``time_tile=2`` (pw_advection chains
    two steps a sweep; tracer_advection's regions demote the chain to 1),
    as float32, against the reference's float32 loop."""
    grid = (8, 8, 64)
    want, _ = _reference(name, "zero", grid, steps=4)
    kw = {} if schedule == "block" else dict(schedule="stream",
                                             time_tile=time_tile)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ex, got = _port(name, "zero", grid, steps=4, dtype="bfloat16", **kw)
    if schedule == "stream":
        chained = name == "pw_advection"
        assert ex.plan.stream.time_tile == (time_tile if chained else 1)
        assert any(issubclass(w.category, TileDemotionWarning)
                   for w in seen) != chained
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(got[k].float().numpy(), want[k],
                                   atol=0.15, rtol=0.15, err_msg=k)
