"""The stream schedule of the PyTorch port against the JAX reference, on the
CPU.

The port's dataflow layer and planner must legalise exactly as the
reference's (regions, window depths, rings, leads, effective
``time_tile``/``plane_tile``, demotion reasons), at the reference's own
test grids and at the grids of ``chip_smoke.py``.  Its executables
(``backend="cuda", schedule="stream", device="cpu"``: the sweep kernels'
plain PyTorch versions through the port's orchestrators) must match the
reference's ``schedule="stream"`` Pallas kernels in interpret mode on the
same seeded numpy inputs, to the reference's tolerance of 1e-5
(``tests/test_stream.py``, ``test_time_tile.py``, ``test_plane_tile.py``).
"""

import functools
import warnings

import numpy as np
import pytest

from repro.apps import pw_advection as ref_pw
from repro.apps import pw_advection_update as ref_pw_update
from repro.apps import tracer_advection as ref_tracer
from repro.apps import tracer_advection_update as ref_tracer_update
from repro.core import compile_program as ref_compile
from repro.core.dataflow import chain_split_reason as ref_chain_reason
from repro.core.dataflow import lower_to_dataflow as ref_lower
from repro.core.dataflow import plane_split_reason as ref_plane_reason
from repro.core.frontend import ProgramBuilder as RefBuilder
from repro.core.schedule import auto_plan as ref_auto_plan
from repro.core.schedule import plan_to_dict as ref_plan_to_dict
from repro.core.schedule import stream_spec_to_dict as ref_spec_dict
from repro_torch import compile_program, hw
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import TileDemotionWarning
from repro_torch.core.dataflow import (chain_split_reason,
                                       lower_to_dataflow,
                                       plane_split_reason)
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.schedule import (auto_plan, plan_stream_cta,
                                       smem_cost, stream_spec_to_dict)
from repro_torch.interop import plan_from_reference
from repro_torch.obs.trace import Tracer

APPS = {
    "pw_advection": (ref_pw, pw_advection, lambda: ref_pw_update(0.1),
                     lambda: pw_advection_update(0.1), (8, 8, 32)),
    "tracer_advection": (ref_tracer, tracer_advection, ref_tracer_update,
                         tracer_advection_update, (6, 8, 32)),
}
BOUNDARIES = ("zero", "periodic")
TILES = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)]
#: chip_smoke.py's grids: pw at 32M, tracer (and pw bfloat16) at 8M
SMOKE_GRID = {"pw_advection": (512, 256, 256),
              "tracer_advection": (256, 256, 128)}
TOL = 1e-5


def app_data(name, grid, seed=0):
    """Seeded numpy inputs in the apps' physical ranges (the reference's
    ``tests/test_stream.py`` ``pw_data``/``tracer_data``)."""
    rng = np.random.default_rng(seed)
    if name == "pw_advection":
        fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
                  for f in ("u", "v", "w")}
        scalars = {"tcx": np.float32(0.05), "tcy": np.float32(0.05)}
        coeffs = {c: np.linspace(0.9, 1.1, grid[2]).astype(np.float32)
                  for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
        return fields, scalars, coeffs
    fields = {
        "t": rng.normal(size=grid).astype(np.float32) + 15.0,
        "un": rng.normal(size=grid).astype(np.float32) * 0.2,
        "vn": rng.normal(size=grid).astype(np.float32) * 0.2,
        "wn": rng.normal(size=grid).astype(np.float32) * 0.05,
        "e3t": np.abs(rng.normal(size=grid)).astype(np.float32) + 1.0,
        "msk": (rng.uniform(size=grid) > 0.05).astype(np.float32),
    }
    scalars = {"rdt": np.float32(0.05), "zeps": np.float32(1e-6)}
    coeffs = {"ztfreez": rng.normal(size=(grid[2],)).astype(np.float32)}
    return fields, scalars, coeffs


def _kw(steps, time_tile, plane_tile):
    kw = {}
    if steps is not None:
        kw["steps"] = steps
    if time_tile is not None:
        kw["time_tile"] = time_tile
    if plane_tile is not None:
        kw["plane_tile"] = plane_tile
    return kw


@functools.lru_cache(maxsize=None)
def reference_stream(name, boundary, steps=None, time_tile=None,
                     plane_tile=None):
    """The reference's ``schedule="stream"`` result (Pallas, interpret
    mode) and effective tiles, cached per case."""
    ref_app, _, ref_upd, _, grid = APPS[name]
    kw = _kw(steps, time_tile, plane_tile)
    if steps is not None:
        kw["update"] = ref_upd()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ex = ref_compile(ref_app(boundary), grid, schedule="stream", **kw)
    out = ex(*app_data(name, grid))
    return ({k: np.asarray(v) for k, v in out.items()},
            (ex.plan.stream.time_tile, ex.plan.stream.plane_tile))


def port_stream(name, boundary, steps=None, time_tile=None, plane_tile=None,
                update=None):
    _, app, _, upd, grid = APPS[name]
    kw = _kw(steps, time_tile, plane_tile)
    if steps is not None:
        kw["update"] = update or upd()
    ex = compile_program(app(boundary), grid, schedule="stream",
                         device="cpu", **kw)
    out = ex(*app_data(name, grid))
    return ({k: v.numpy() for k, v in out.items()},
            (ex.plan.stream.time_tile, ex.plan.stream.plane_tile))


def assert_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=f"{what} field {k}")


# ------------------------------------------------ (a) legalisation parity

@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"T{t[0]}P{t[1]}")
@pytest.mark.parametrize("where", ["test", "smoke"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_dataflow_spec_and_split_reasons_equal_reference(name, boundary,
                                                         where, tiles):
    """(a) Regions, depths, rings, leads and effective T/P of the port's
    ``lower_to_dataflow`` equal the reference's, and so do the reasons
    ``chain_split_reason`` and ``plane_split_reason`` give."""
    ref_app, app, _, _, test_grid = APPS[name]
    grid = test_grid if where == "test" else SMOKE_GRID[name]
    T, P = tiles
    rp, pp = ref_app(boundary), app(boundary)
    rplan = ref_auto_plan(rp, grid, schedule="stream", time_tile=T,
                          plane_tile=P)
    plan = auto_plan(pp, grid, schedule="stream", time_tile=T, plane_tile=P)
    rg, g = ref_lower(rp, rplan, grid), lower_to_dataflow(pp, plan, grid)
    assert stream_spec_to_dict(g.spec()) == ref_spec_dict(rg.spec())
    assert stream_spec_to_dict(plan.stream) == ref_spec_dict(rplan.stream)
    regions = [list(r.ops) for r in g.regions]
    assert chain_split_reason(pp, regions) == ref_chain_reason(rp, regions)
    for width in (P, grid[0] + 1):
        assert plane_split_reason(pp, width, grid) == \
            ref_plane_reason(rp, width, grid)
    assert [gh.input_halo.tolist() for gh in g.group_halos()] == \
        [gh.input_halo.tolist() for gh in rg.group_halos()]


# ------------------------------------------- (b) the planner at full size

SMOKE_PLANS = [
    ("pw_advection", "zero", (512, 256, 256), "float32"),
    ("pw_advection", "periodic", (512, 256, 256), "float32"),
    ("pw_advection", "zero", (256, 256, 128), "bfloat16"),
    ("tracer_advection", "zero", (256, 256, 128), "float32"),
    ("tracer_advection", "periodic", (256, 256, 128), "float32"),
]


@pytest.mark.parametrize("name,boundary,grid,dtype", SMOKE_PLANS)
def test_stream_auto_plan_matches_reference_and_fits_a_cta(name, boundary,
                                                           grid, dtype):
    """(b) ``auto_plan(schedule="stream")`` keeps the reference's regions
    and effective tiles at chip_smoke.py's grids, the plan dict round-trips
    the reference's one-plane ``block``, and every region's CTA fits the
    232,448 B of shared memory one CTA may use."""
    ref_app, app = APPS[name][:2]
    for T, P in TILES:
        rplan = ref_auto_plan(ref_app(boundary), grid, schedule="stream",
                              time_tile=T, plane_tile=P, dtype=dtype)
        plan = auto_plan(app(boundary), grid, schedule="stream",
                         time_tile=T, plane_tile=P, dtype=dtype)
        assert plan.groups == [list(x) for x in rplan.groups]
        assert plan.block == tuple(rplan.block)
        assert (plan.time_tile, plan.plane_tile) == \
            (rplan.time_tile, rplan.plane_tile)
        assert stream_spec_to_dict(plan.stream) == \
            ref_spec_dict(rplan.stream)
        cost = smem_cost(app(boundary), plan, grid)
        assert 0 < cost <= hw.H100.smem_per_block == 232_448
        graph = lower_to_dataflow(app(boundary), plan, grid)
        for r in graph.regions:
            cta = plan_stream_cta(app(boundary), r, grid, graph.time_tile,
                                  graph.plane_tile, dtype)
            assert cta.smem_bytes <= cost
            # the card is filled: a CTA for every SM, or one for every tile
            assert cta.ctas >= min(hw.H100.sms, int(np.prod(cta.tiles)))
            assert cta.chunk * cta.n_chunks >= grid[0]


@pytest.mark.parametrize("budget,want", [
    (232_448, (4, 2, 1)),       # everything fits
    (42_000, (4, 1, 1)),        # the plane unroll narrows first
    (20_000, (2, 1, 1)),        # then the chain gets shallower
    (3_000, (1, 1, 3)),         # then the region splits per field
])
def test_stream_auto_plan_levers_in_the_reference_order(budget, want):
    """When no sweep tile fits the shared-memory budget, ``auto_plan``
    pulls the reference's levers in its order (``_auto_plan_stream``)."""
    plan = auto_plan(pw_advection(), (8, 8, 32), schedule="stream",
                     time_tile=4, plane_tile=2, smem_budget=budget)
    assert (plan.time_tile, plan.plane_tile, len(plan.groups)) == want


def test_stream_auto_plan_rejects_torch_backends():
    with pytest.raises(ValueError, match="no streaming lowering"):
        auto_plan(pw_advection(), (8, 8, 32), backend="torch_fused",
                  schedule="stream")
    with pytest.raises(ValueError, match="no streaming lowering"):
        compile_program(pw_advection(), (8, 8, 32), backend="torch_fused",
                        schedule="stream", device="cpu")


# ------------------------------------ (c) results against the reference

@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_stream_single_step_matches_reference(name, boundary):
    """(c) One sweep per region against the reference's stream kernels."""
    want, _ = reference_stream(name, boundary)
    got, _ = port_stream(name, boundary)
    assert_close(got, want, f"{name}/{boundary} single step")


@pytest.mark.parametrize("steps,time_tile", [(4, 1), (4, 2), (4, 4),
                                             (5, 2)])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_stream_fused_loop_matches_reference(name, boundary, steps,
                                             time_tile):
    """(c) The fused loop, chained where legal (pw zero), with the
    ``steps % T`` remainder epilogue at steps=5, T=2; the effective tile
    is the reference's."""
    want, want_tiles = reference_stream(name, boundary, steps, time_tile)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TileDemotionWarning)
        got, tiles = port_stream(name, boundary, steps, time_tile)
    assert tiles == want_tiles
    assert_close(got, want, f"{name}/{boundary} steps={steps} T={time_tile}")


@pytest.mark.parametrize("plane_tile", [2, 4])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_stream_plane_tile_matches_reference(name, boundary, plane_tile):
    """(c) The plane unroll: tracer's 6-plane sweep at P=4 takes the
    staging-ring path (its warm-up span is not a multiple of P)."""
    want, want_tiles = reference_stream(name, boundary,
                                        plane_tile=plane_tile)
    got, tiles = port_stream(name, boundary, plane_tile=plane_tile)
    assert tiles == want_tiles == (1, plane_tile)
    assert_close(got, want, f"{name}/{boundary} P={plane_tile}")


@pytest.mark.parametrize("name", sorted(APPS))
def test_stream_plane_tile_composes_with_the_chain(name):
    """(c) P=2 through a T=4 fused loop of 8 steps (chained for pw; the
    tracer chain demotes, the unroll stays)."""
    want, want_tiles = reference_stream(name, "zero", 8, 4, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TileDemotionWarning)
        got, tiles = port_stream(name, "zero", 8, 4, 2)
    assert tiles == want_tiles
    assert_close(got, want, f"{name} steps=8 T=4 P=2")


def test_stream_matches_the_block_schedule():
    """The port's two schedules agree (pw, fused loop, chained)."""
    _, app, _, upd, grid = APPS["pw_advection"]
    data = app_data("pw_advection", grid)
    blk = compile_program(app(), grid, steps=5, update=upd(),
                          device="cpu")(*data)
    stm = compile_program(app(), grid, steps=5, update=upd(), device="cpu",
                          schedule="stream", time_tile=2)(*data)
    for k in blk:
        np.testing.assert_allclose(stm[k].numpy(), blk[k].numpy(),
                                   atol=TOL, rtol=TOL)


# ------------------------------------------------------- (d) demotions

@pytest.mark.parametrize("name,boundary", [("pw_advection", "periodic"),
                                           ("tracer_advection", "zero")])
def test_illegal_chains_demote_with_a_warning(name, boundary):
    """(d) pw periodic (periodic persistent fields) and tracer (four
    regions) demote T=4 to the reference's effective 1, warn, and emit
    ``ChainDemoted``."""
    _, want_tiles = reference_stream(name, boundary, 4, 4)
    _, app, _, upd, grid = APPS[name]
    tr = Tracer()
    with pytest.warns(TileDemotionWarning, match="demoted to effective 1"):
        ex = compile_program(app(boundary), grid, schedule="stream",
                             steps=4, update=upd(), time_tile=4,
                             device="cpu", trace=tr)
    assert (ex.plan.stream.time_tile, ex.plan.stream.plane_tile) == \
        want_tiles == (1, 1)
    assert ex.plan.time_tile == 4          # the request is recorded
    ev = tr.events("ChainDemoted")
    assert ev and ev[-1]["args"]["effective"] == 1


def test_an_update_rule_that_does_not_trace_demotes_the_chain():
    """(d) A rule calling a tensor-only function cannot run in-kernel:
    T=4 demotes to 1 with the warning and the event, the rule runs on the
    host per step, and the result still matches the reference's chain."""
    import torch

    def host_only(fields, out):
        return {k: torch.add(fields[k], out["s" + k], alpha=0.1)
                for k in ("u", "v", "w")}

    want, want_tiles = reference_stream("pw_advection", "zero", 4, 4)
    assert want_tiles == (4, 1)
    _, app, _, _, grid = APPS["pw_advection"]
    tr = Tracer()
    with pytest.warns(TileDemotionWarning, match="does not trace"):
        ex = compile_program(app(), grid, schedule="stream", steps=4,
                             update=host_only, time_tile=4, device="cpu",
                             trace=tr)
    assert ex.plan.stream.time_tile == 1
    assert [e["args"]["reason"] for e in tr.events("ChainDemoted")][-1] \
        .startswith("update rule does not trace")
    got = {k: v.numpy() for k, v in ex(*app_data("pw_advection",
                                                 grid)).items()}
    assert_close(got, want, "untraceable rule")


def test_a_rule_branching_on_a_value_does_not_trace():
    from repro_torch.core.lower_stream import trace_update

    def branchy(fields, out):
        return {"u": fields["u"] if out["su"] > 0 else out["su"]}

    exprs, why = trace_update(pw_advection(), branchy, ["u", "v", "w"],
                              ["su", "sv", "sw"])
    assert exprs is None and "truth value" in why


# -------------------------------------------- (e) reference plan dicts

def test_reference_stream_plan_dict_compiles_in_the_port():
    """(e) A reference stream plan (T=2, P=2) written with ``plan_to_dict``
    compiles in the port and gives the reference's fields."""
    ref_app, app, ref_upd, upd, grid = APPS["pw_advection"]
    rplan = ref_auto_plan(ref_app(), grid, schedule="stream", time_tile=2,
                          plane_tile=2)
    data = app_data("pw_advection", grid)
    want = ref_compile(ref_app(), grid, plan=rplan, steps=5,
                       update=ref_upd())(*data)
    plan = plan_from_reference(ref_plan_to_dict(rplan), app(), grid)
    assert plan.schedule == "stream" and plan.backend == "cuda"
    ex = compile_program(app(), grid, plan=plan, steps=5, update=upd(),
                         device="cpu")
    assert (ex.plan.stream.time_tile, ex.plan.stream.plane_tile) == (2, 2)
    got = {k: v.numpy() for k, v in ex(*data).items()}
    assert_close(got, {k: np.asarray(v) for k, v in want.items()},
                 "reference plan dict")


# ---------------------------- (f) a coefficient along the stream axis

def axis0_coeff_program(builder, boundary="zero"):
    """x -> t (a ring temp read one plane back) -> o, with a coefficient
    along axis 0 read at offsets -1, 0 and +1."""
    b = builder("zcoef", ndim=3, boundary=boundary)
    x = b.input("x")
    cz = b.coeff("cz", axis=0)
    cy = b.coeff("cy", axis=1)
    t = b.temp("t")
    o = b.output("o")
    b.define(t, x[0, 0, 0] * cz[0] + x[-1, 0, 0] - x[0, 1, -1] * cy[0])
    b.define(o, t[-1, 0, 0] * cz[1] + t[0, 1, 0] - x[1, 0, 0] * cz[-1])
    return b.build()


@pytest.mark.parametrize("boundary,steps,time_tile", [
    ("zero", None, None), ("periodic", None, None), ("zero", 3, 2)])
def test_axis0_coefficient_path_matches_reference(boundary, steps,
                                                  time_tile):
    """(f) Per-plane coefficients at the clamped stream index, through a
    single sweep (zero and periodic: the periodic ring temp splits the
    region) and through a chain with its remainder."""
    grid = (7, 6, 32)
    rng = np.random.default_rng(5)
    fields = {"x": rng.normal(size=grid).astype(np.float32) * 0.3}
    coeffs = {"cz": rng.normal(size=grid[0]).astype(np.float32),
              "cy": rng.normal(size=grid[1]).astype(np.float32)}
    kw = {} if steps is None else dict(steps=steps, time_tile=time_tile)

    def upd(f, out):
        return {"x": f["x"] + 0.1 * out["o"]}

    if steps is not None:
        kw["update"] = upd
    want = ref_compile(axis0_coeff_program(RefBuilder, boundary), grid,
                       schedule="stream", **kw)(fields, {}, coeffs)
    ex = compile_program(axis0_coeff_program(ProgramBuilder, boundary),
                         grid, schedule="stream", device="cpu", **kw)
    if steps is not None:
        assert ex.plan.stream.time_tile == time_tile
    got = {k: v.numpy() for k, v in ex(fields, {}, coeffs).items()}
    assert_close(got, {k: np.asarray(v) for k, v in want.items()},
                 f"axis-0 coefficient {boundary}")
