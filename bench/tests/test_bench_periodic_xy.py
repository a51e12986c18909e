"""The doubly periodic cell, ``pw134m.fused10.block.periodic``, on the CPU:
its reference copy against ``advection.py`` and the port, its limit
against the bfloat16 control, the run and its faults, and the wraparound
slabs' hand count at the cell's grid.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_periodic_xy.py
"""

import time

import pytest
import torch

from bench import calibrate, compare, harness, inputs, wrap

CELL = "pw134m.fused10.block.periodic"
SMALL = (16, 12, 8)


def _cell(root):
    return harness.load_cell(root, CELL)


def test_the_reference_copy_is_advection_away_from_the_sides(root):
    """One step of the doubly periodic reference equals ``advection.py``'s
    wherever no lateral side is read (pw reads one point along each axis),
    bit for bit, and differs at the sides."""
    cfg = _cell(root).config
    xy = harness.reference(root, "advection_periodic_xy")
    zero = harness.reference(root, "advection")
    f, s, c = inputs.make(cfg, SMALL, 2**31 + 7, "cpu")
    a = xy.run("pw", f, s, c, 1, dt=0.1)
    b = zero.run("pw", f, s, c, 1, dt=0.1)
    for k in cfg["writes"]:
        assert torch.equal(a[k][1:-1, 1:-1], b[k][1:-1, 1:-1]), k
        assert not torch.equal(a[k], b[k]), k


def test_the_reference_copy_wraps_x_and_y_and_not_z(root):
    ref = harness.reference(root, "advection_periodic_xy")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(ref.shift(x, (1, 0, 0)), x[[1, 0]])
    assert torch.equal(ref.shift(x, (0, -1, 0)), x[:, [2, 0, 1]])
    want = torch.zeros_like(x)
    want[..., :3] = x[..., 1:]
    assert torch.equal(ref.shift(x, (0, 0, 1)), want)


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_the_reference_copy_matches_the_naive_backend(root, seed):
    from repro_torch import apps, compile_program

    cell = _cell(root)
    cfg = cell.config
    f, s, c = inputs.make(cfg, SMALL, seed, "cpu")
    ex = compile_program(apps.pw_advection(cfg["boundary"]), SMALL, steps=10,
                         update=apps.pw_advection_update(0.1),
                         backend="torch_naive", device="cpu")
    want = ex(f, s, c)
    got = harness.reference(root, "advection_periodic_xy").run(
        "pw", f, s, c, 10, dt=0.1)
    for k in cfg["writes"]:
        assert compare.rel_err(got[k], want[k]) < 1e-6, k


def test_the_limit_lies_between_the_readings(root):
    r = calibrate.readings(_cell(root), [1, 2, 3], [4, 5, 6], device="cpu",
                           grid=SMALL)
    limit = _cell(root).limits["rel_err"]
    assert r["lower"] < limit < r["upper"]
    assert r["upper"] > 3 * limit


def _run(root, wrap_ex=None, trace=False):
    res, rows = harness.run_cell(_cell(root), 2**31 + 5, 0.3, trace,
                                 t0=time.perf_counter(), device="cpu",
                                 grid=SMALL, wrap=wrap_ex)
    return res


def test_a_cpu_run_is_correct_and_counts_the_wrap(root):
    res = _run(root)
    assert res["correct"] and res["failed"] == 0
    assert {"gpts_per_s", "call_p95_ms", "setup_s"} <= set(res["metrics"])
    traced = _run(root, trace=True)
    assert traced["correct"]
    # the counter reads on the CPU; the spans' device time needs a card
    assert traced["metrics"]["wrap_gb_per_step"]["value"] > 0
    assert "wrap_roofline" not in traced["metrics"]


def test_the_zero_boundary_in_its_place_is_not_correct(root):
    """The lateral wrap left out: the zero-boundary program's fields."""
    from repro_torch import apps, compile_program

    zero = compile_program(apps.pw_advection("zero"), SMALL, steps=10,
                           update=apps.pw_advection_update(0.1),
                           device="cpu")
    res = _run(root, wrap_ex=lambda ex: zero)
    assert not res["correct"]


def test_the_slab_bytes_are_the_hand_count(root):
    """At 1024 x 512 x 256 float32: u, v, w, each one plane on either side
    of x (512 x 256 points) and of y (1024 x 256), read once and written
    once."""
    cfg = _cell(root).config
    hand = 3 * 2 * (512 * 256 + 1024 * 256) * 2 * 4
    assert hand == 18_874_368
    assert wrap.periodic_axes(cfg) == [0, 1]
    assert wrap.slab_bytes(cfg, cfg["grid"]) == hand
    assert wrap.least_time(cfg, cfg["grid"]) == pytest.approx(5.634e-6,
                                                              rel=1e-3)
    zero = harness.load_json(root / "bench" / "configs"
                             / "pw_advection_134m.json")
    assert wrap.slab_bytes(zero, zero["grid"]) == 0
