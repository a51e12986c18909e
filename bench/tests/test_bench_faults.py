"""A run on the CPU with the chip's look skipped and the timed path broken
underneath: ``correct`` has to come out false for each fault a stencil
cell can have. A one-chip cell has no exchange between chips to leave
out; the mesh cell runs here over four CPU devices, and has."""

import time

import pytest
import torch

from bench import harness

SMALL = (16, 12, 8)
CELLS = ["pw134m.fused10.block", "tracer134m.fused4.block",
         "pw2g.mesh2x2.fused10.block"]


def _wrapped(fault):
    def wrap(ex):
        calls = {"n": 0}

        def run(fields, scalars, coeffs):
            calls["n"] += 1
            out = ex(fields, scalars, coeffs)
            return fault(out, fields, calls["n"])
        return run
    return wrap


def unchanged(out, fields, n):
    """Every step returns its state unchanged."""
    return {k: fields[k].clone() for k in out}


def half_left_out(out, fields, n):
    """The upper half of the grid along the sweep axis is never updated."""
    res = {k: v.clone() for k, v in out.items()}
    h = SMALL[0] // 2
    for k in res:
        res[k][h:] = fields[k][h:]
    return res


def one_point_altered(out, fields, n):
    """One answer altered where it is produced: a point of each field off
    by a hundredth of the field's scale."""
    res = {k: v.clone() for k, v in out.items()}
    for v in res.values():
        v[3, 4, 5] += 0.01 * float(v.abs().max())
    return res


def every_other_call_altered(out, fields, n):
    """Only some calls of the window are wrong."""
    return one_point_altered(out, fields, n) if n % 2 == 0 else out


def _run(root, name, wrap=None):
    cell = harness.load_cell(root, name)
    res, rows = harness.run_cell(cell, 2**31 + 5, 0.3, False,
                                 t0=time.perf_counter(), device="cpu",
                                 grid=SMALL, wrap=wrap)
    return res, dict((n, v) for n, v, _ in rows)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(root, name):
    res, _ = _run(root, name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   one_point_altered,
                                   every_other_call_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(root, name, fault):
    res, rows = _run(root, name, _wrapped(fault))
    assert res["correct"] is False, rows
    assert list(res)[-1] == "checks"


def test_nan_is_not_correct(root):
    def nan(out, fields, n):
        res = {k: v.clone() for k, v in out.items()}
        for v in res.values():
            v[0, 0, 0] = torch.nan
        return res
    res, _ = _run(root, CELLS[0], _wrapped(nan))
    assert res["correct"] is False


def test_exchange_left_out_is_not_correct(root, monkeypatch):
    """The mesh cell with every halo slab between shards left zero, as if
    no shard heard from its neighbours."""
    from repro_torch.core import boundary

    def wrap(ex):
        monkeypatch.setattr(boundary, "ring_perms", lambda *a, **k: [])
        return ex
    res, rows = _run(root, CELLS[2], wrap)
    assert res["correct"] is False, rows
    assert res["failed"] == 0 and rows["rel_err.u"] > 1e-2
