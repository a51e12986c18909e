"""The plain reference against the port's ``torch_naive`` backend on the
CPU, and the lower-precision control against each cell's limit.

    PYTHONPATH=src python -m pytest -q bench/tests
"""

import pytest
import torch

from bench import calibrate, compare, harness, inputs

CELLS = ["pw134m.fused10.block", "tracer134m.fused4.block",
         "pw134m.fused10.stream_t2", "tracer134m.fused4.stream",
         "pw2g.mesh2x2.fused10.block"]
SMALL = (12, 10, 8)


def _naive(cell, grid, fields, scalars, coeffs):
    """The cell's program through the port's op-at-a-time torch backend."""
    from repro_torch import apps, compile_program

    cfg = cell.config
    p = getattr(apps, cfg["program"])(cfg["boundary"])
    upd = getattr(apps, cfg["update"]["rule"])(*cfg["update"]["args"])
    ex = compile_program(p, grid, steps=int(cell.traffic["steps"]),
                         update=upd, backend="torch_naive", device="cpu")
    return ex(fields, scalars, coeffs)


def _reference(cell, fields, scalars, coeffs, dtype=torch.float32):
    cfg = cell.config
    ref = harness.reference(cell.root, cfg["reference"]["module"])
    return ref.run(cfg["reference"]["scheme"], fields, scalars, coeffs,
                   int(cell.traffic["steps"]), dtype=dtype,
                   **cfg["reference"].get("args", {}))


@pytest.mark.parametrize("name", ["pw134m.fused10.block",
                                  "tracer134m.fused4.block"])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_matches_naive_backend(root, name, seed):
    cell = harness.load_cell(root, name)
    f, s, c = inputs.make(cell.config, SMALL, seed, "cpu")
    want = _naive(cell, SMALL, f, s, c)
    got = _reference(cell, f, s, c)
    for k in cell.config["writes"]:
        assert compare.rel_err(got[k], want[k]) < 1e-6, k


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_limit(root, name):
    cell = harness.load_cell(root, name)
    limit = cell.limits["rel_err"]
    for seed in (3, 4, 5):
        f, s, c = inputs.make(cell.config, SMALL, seed, "cpu")
        want = _reference(cell, f, s, c)
        low = _reference(cell, f, s, c, torch.bfloat16)
        worst = max(compare.rel_err(low[k], want[k])
                    for k in cell.config["writes"])
        assert worst > 3 * limit, (seed, worst, limit)


@pytest.mark.parametrize("name", ["pw134m.fused10.block",
                                  "tracer134m.fused4.block",
                                  "pw2g.mesh2x2.fused10.block"])
def test_limit_lies_between_the_readings(root, name):
    cell = harness.load_cell(root, name)
    r = calibrate.readings(cell, [1, 2, 3], [4, 5, 6], device="cpu",
                           grid=SMALL)
    assert r["lower"] < cell.limits["rel_err"] < r["upper"]


def test_reference_shift_is_zero_outside():
    from bench.reference.advection import shift

    x = torch.arange(1.0, 5.0).reshape(4, 1, 1)
    assert shift(x, (1, 0, 0)).flatten().tolist() == [2.0, 3.0, 4.0, 0.0]
    assert shift(x, (-1, 0, 0)).flatten().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert shift(x, (5, 0, 0)).abs().sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(root, card, name):
    """The control at a grid of 8M points on the card, three seeds."""
    cell = harness.load_cell(root, name)
    if torch.cuda.device_count() < cell.entry["chips"]:
        pytest.skip(f"needs {cell.entry['chips']} CUDA cards")
    r = calibrate.readings(cell, [1], [7, 8, 9], device=card,
                           grid=(256, 256, 128))
    assert r["lower"] < cell.limits["rel_err"] < r["upper"]
