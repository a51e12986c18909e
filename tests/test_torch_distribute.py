"""The port's distributed executor against the reference's sharded
executables (``compile_program(..., mesh=, mesh_axes=)``), on the CPU.

The reference runs once per module in a subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as its own tests
run it, so the override never reaches the other tests): ``shard_map`` over
a ``jax.sharding.Mesh``, halos by ``ppermute``, its ``pallas`` backend in
interpret mode for a handful of cases and ``jnp_fused`` for the rest.  Its
inputs are made here with numpy from a seed and exchanged through ``.npz``
files.  The port runs in-process over a mesh of ``cpu`` devices
(``make_auto_mesh(..., devices=["cpu"] * n)``): its ``cuda`` backend runs
each kernel's plain version per shard at the shard's origin, its torch
backends shift across shards through the lowering's hooks.

Cases are the reference tests' own: ``tests/test_distribute.py`` (both
apps on (2,2,2), (8,), (2,4) and (2,2) meshes, both boundaries, a 2-D
diagonal stencil and a 1-D dependency chain),
``tests/test_distributed_loop.py`` (``steps=4`` fused loops) and
``tests/test_stream_mesh.py`` (a (2,2) mesh that cuts the stream axis,
``time_tile=2`` with a remainder).  Tolerances are theirs: 1e-4 for a
single step, 1e-5 for a fused loop.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import boundary as bc
from repro_torch.core import distribute
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.schedule import (auto_plan, make_shard_spec,
                                       mesh_fingerprint)
from repro_torch.dist import make_auto_mesh
from repro_torch.kernels import stencil3d, stream3d
from test_torch_parity import app_data

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

XYZ = (("X", "Y", "Z"), ("X", "Y", "Z"))


def _case(prog, boundary, grid, mesh, axes, ref, port, steps=None,
          schedule=None, time_tile=None):
    return dict(prog=prog, boundary=boundary, grid=list(grid),
                mesh=list(mesh[0]), names=list(mesh[1]), axes=list(axes),
                ref=ref, port=list(port), steps=steps, schedule=schedule,
                time_tile=time_tile)


# name -> case: the program, boundary and grid, the mesh (shape, axis
# names) and mesh_axes, the reference backend and the port's backends
CASES = {
    # tests/test_distribute.py: single steps
    "pw_zero_222": _case("pw", "zero", (16, 12, 256), ((2, 2, 2), XYZ[0]),
                         XYZ[1], "pallas", ("cuda", "torch_fused")),
    "tracer_zero_222": _case("tracer", "zero", (16, 16, 128),
                             ((2, 2, 2), XYZ[0]), XYZ[1], "pallas",
                             ("cuda",)),
    "pw_zero_8": _case("pw", "zero", (32, 8, 128), ((8,), ("X",)),
                       ("X", None, None), "jnp_fused",
                       ("cuda", "torch_naive")),
    "tracer_zero_24": _case("tracer", "zero", (8, 32, 128),
                            ((2, 4), ("X", "Y")), ("X", "Y", None),
                            "jnp_fused", ("cuda", "torch_fused")),
    "pw_zero_22": _case("pw", "zero", (16, 12, 128), ((2, 2), ("X", "Y")),
                        ("X", "Y", None), "jnp_fused",
                        ("cuda", "torch_fused")),
    "tracer_zero_22": _case("tracer", "zero", (8, 16, 64),
                            ((2, 2), ("X", "Y")), ("X", "Y", None),
                            "jnp_naive", ("cuda", "torch_naive")),
    "pw_periodic_222": _case("pw", "periodic", (16, 12, 128),
                             ((2, 2, 2), XYZ[0]), XYZ[1], "pallas",
                             ("cuda", "torch_fused")),
    "tracer_periodic_24": _case("tracer", "periodic", (8, 16, 64),
                                ((2, 4), ("X", "Y")), ("X", "Y", None),
                                "jnp_fused", ("cuda", "torch_naive")),
    "diag_zero_24": _case("diag", "zero", (16, 32), ((2, 4), ("X", "Y")),
                          ("X", "Y"), "jnp_fused", ("cuda", "torch_fused")),
    "diag_periodic_24": _case("diag", "periodic", (16, 32),
                              ((2, 4), ("X", "Y")), ("X", "Y"), "jnp_fused",
                              ("cuda", "torch_naive")),
    "chain_zero_8": _case("chain", "zero", (64,), ((8,), ("X",)), ("X",),
                          "jnp_fused", ("cuda", "torch_naive")),
    # tests/test_distributed_loop.py: steps=4 fused loops on (2,2,2)
    "pw_zero_loop4": _case("pw", "zero", (8, 8, 128), ((2, 2, 2), XYZ[0]),
                           XYZ[1], "pallas", ("cuda", "torch_fused"),
                           steps=4),
    "pw_periodic_loop4": _case("pw", "periodic", (8, 8, 128),
                               ((2, 2, 2), XYZ[0]), XYZ[1], "jnp_fused",
                               ("cuda", "torch_fused"), steps=4),
    "tracer_zero_loop4": _case("tracer", "zero", (8, 8, 64),
                               ((2, 2, 2), XYZ[0]), XYZ[1], "jnp_fused",
                               ("cuda", "torch_fused"), steps=4),
    "tracer_periodic_loop4": _case("tracer", "periodic", (8, 8, 64),
                                   ((2, 2, 2), XYZ[0]), XYZ[1], "jnp_fused",
                                   ("cuda", "torch_naive"), steps=4),
    # tests/test_stream_mesh.py: a (2,2) mesh that cuts the stream axis;
    # the reference's stream schedule is its pallas backend's, so the
    # jnp_fused cases hold the port's sweeps against its sharded block
    # executable (the reference's own test holds the two together at 1e-5)
    "pw_zero_stream_T2_steps5": _case(
        "pw", "zero", (16, 16, 32), ((2, 2), ("X", "Y")), ("X", "Y", None),
        "pallas", ("cuda",), steps=5, schedule="stream", time_tile=2),
    "pw_periodic_stream_T2_steps4": _case(
        "pw", "periodic", (16, 16, 32), ((2, 2), ("X", "Y")),
        ("X", "Y", None), "jnp_fused", ("cuda",), steps=4, schedule="stream",
        time_tile=2),
    "tracer_zero_stream_steps4": _case(
        "tracer", "zero", (16, 16, 32), ((2, 2), ("X", "Y")),
        ("X", "Y", None), "jnp_fused", ("cuda",), steps=4, schedule="stream",
        time_tile=1),
    "tracer_periodic_stream_step": _case(
        "tracer", "periodic", (16, 16, 32), ((2, 2), ("X", "Y")),
        ("X", "Y", None), "jnp_fused", ("cuda",), schedule="stream"),
}

# halo_exchange_pad on random (8, 16) blocks of a (2, 4) mesh: (lo, hi,
# align_hi, periodic)
EXCHANGES = {
    "zero": ((1, 2), (2, 1), (0, 3), False),
    "periodic": ((2, 1), (1, 3), (1, 0), True),
}

REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro.apps import (pw_advection, pw_advection_update, tracer_advection,
                        tracer_advection_update)
from repro.core import compile_program
from repro.core.distribute import _smap, halo_exchange_pad
from repro.core.frontend import ProgramBuilder
from repro.dist.sharding import make_auto_mesh

assert jax.device_count() == 8
cases, exchanges = json.load(open(sys.argv[1]))
data = np.load(sys.argv[2])

def program(name, boundary):
    if name == "pw":
        return pw_advection(boundary)
    if name == "tracer":
        return tracer_advection(boundary)
    if name == "diag":
        b = ProgramBuilder("diag", ndim=2, boundary=boundary)
        x = b.input("x"); o = b.output("o")
        b.define(o, x[-1, -1] + x[1, 1] + x[-2, 2])
        return b.build()
    b = ProgramBuilder("chain", ndim=1, boundary=boundary)
    x = b.input("x"); t = b.temp("t"); o = b.output("o")
    b.define(t, x[-1] + x[1])
    b.define(o, t[-1] * t[1])
    return b.build()

UPDATES = {"pw": lambda: pw_advection_update(0.1),
           "tracer": tracer_advection_update}
out = {}
for name, c in cases.items():
    p = program(c["prog"], c["boundary"])
    part = lambda kind: {k.split("/")[2]: data[k] for k in data.files
                         if k.startswith(f"{name}/{kind}/")}
    mesh = make_auto_mesh(tuple(c["mesh"]), tuple(c["names"]))
    kw = dict(backend=c["ref"], mesh=mesh, mesh_axes=tuple(c["axes"]))
    if c["steps"]:
        kw.update(steps=c["steps"], update=UPDATES[c["prog"]]())
    if c["schedule"] and c["ref"] == "pallas":
        kw.update(schedule=c["schedule"], time_tile=c["time_tile"])
    ex = compile_program(p, tuple(c["grid"]), **kw)
    res = ex(part("f"), {k: np.float32(v) for k, v in part("s").items()},
             part("c"))
    for k, v in res.items():
        out[f"{name}/{k}"] = np.asarray(v)
mesh = make_auto_mesh((2, 4), ("X", "Y"))
for name, (lo, hi, al, per) in exchanges.items():
    fn = lambda b: halo_exchange_pad(b, lo, hi, al, ("X", "Y"),
                                     {"X": 2, "Y": 4}, periodic=per)
    out[f"exchange/{name}"] = np.asarray(
        _smap(fn, mesh, P("X", "Y"), P("X", "Y"))(data[f"exchange/{name}"]))
np.savez(sys.argv[3], **out)
print("REF_OK")
"""


def program(name, boundary):
    """The case's program in the port (the same builder as the reference
    script's)."""
    if name == "pw":
        return pw_advection(boundary)
    if name == "tracer":
        return tracer_advection(boundary)
    if name == "diag":
        b = ProgramBuilder("diag", ndim=2, boundary=boundary)
        x = b.input("x")
        o = b.output("o")
        b.define(o, x[-1, -1] + x[1, 1] + x[-2, 2])
        return b.build()
    b = ProgramBuilder("chain", ndim=1, boundary=boundary)
    x = b.input("x")
    t = b.temp("t")
    o = b.output("o")
    b.define(t, x[-1] + x[1])
    b.define(o, t[-1] * t[1])
    return b.build()


UPDATES = {"pw": lambda: pw_advection_update(0.1),
           "tracer": tracer_advection_update}


def case_data(name):
    """Seeded numpy inputs of a case: the parity tests' app inputs, or
    normal fields for the small programs."""
    c = CASES[name]
    grid = tuple(c["grid"])
    if c["prog"] in ("pw", "tracer"):
        return app_data(f"{c['prog']}_advection", grid,
                        seed=sorted(CASES).index(name))
    rng = np.random.default_rng(sorted(CASES).index(name))
    return {"x": rng.normal(size=grid).astype(np.float32)}, {}, {}


def exchange_input(name):
    rng = np.random.default_rng(100 + sorted(EXCHANGES).index(name))
    return rng.normal(size=(8, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's result from the reference's sharded executable (one
    subprocess, eight host devices)."""
    d = tmp_path_factory.mktemp("ref")
    arrays = {}
    for name in CASES:
        f, s, c = case_data(name)
        for kind, part in (("f", f), ("s", s), ("c", c)):
            for k, v in part.items():
                arrays[f"{name}/{kind}/{k}"] = np.asarray(v, np.float32)
    for name in EXCHANGES:
        arrays[f"exchange/{name}"] = exchange_input(name)
    np.savez(d / "inputs.npz", **arrays)
    (d / "cases.json").write_text(json.dumps([CASES, EXCHANGES]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE,
                        str(d / "cases.json"), str(d / "inputs.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def cpu_mesh(shape, names):
    return make_auto_mesh(shape, names,
                          devices=["cpu"] * int(np.prod(shape)))


def compile_case(name, backend, **extra):
    c = CASES[name]
    kw = dict(backend=backend,
              mesh=cpu_mesh(tuple(c["mesh"]), tuple(c["names"])),
              mesh_axes=tuple(c["axes"]))
    if c["steps"]:
        kw.update(steps=c["steps"], update=UPDATES[c["prog"]]())
    if c["schedule"]:
        kw.update(schedule=c["schedule"], time_tile=c["time_tile"])
    kw.update(extra)
    with warnings.catch_warnings():
        # a periodic chain demotes to time_tile=1, as in the reference
        warnings.simplefilter("ignore")
        return compile_program(program(c["prog"], c["boundary"]),
                               tuple(c["grid"]), **kw)


@pytest.mark.parametrize("name,backend", [(n, b) for n, c in CASES.items()
                                          for b in c["port"]])
def test_sharded_executable_matches_the_reference(reference, name, backend):
    """Port over a mesh of CPU devices vs the reference's sharded
    executable on eight host devices: 1e-4 for a single step, 1e-5 for a
    fused loop (atol and rtol, as the reference's tests)."""
    c = CASES[name]
    ex = compile_case(name, backend)
    sizes = dict(zip(c["names"], c["mesh"]))
    assert ex.shard.local_grid == tuple(
        g // (1 if a is None else sizes[a])
        for g, a in zip(c["grid"], c["axes"]))
    f, s, co = case_data(name)
    got = ex(f, s, co)
    tol = 1e-5 if c["steps"] else 1e-4
    keys = [k[len(name) + 1:] for k in reference
            if k.startswith(name + "/")]
    assert sorted(got) == sorted(keys)
    for k in keys:
        g = got[k]
        assert tuple(g.shape) == tuple(c["grid"]) and g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), reference[f"{name}/{k}"],
                                   atol=tol, rtol=tol,
                                   err_msg=f"{name}/{k} {backend}")


@pytest.mark.parametrize("name", sorted(EXCHANGES))
def test_halo_exchange_pad_matches_the_reference(reference, name):
    """Every shard's padded block equals the reference's ``shard_map`` of
    its ``halo_exchange_pad`` (neighbour slabs, corners, wrap, zero edge
    halos and the alignment slab)."""
    lo, hi, al, per = EXCHANGES[name]
    x = torch.as_tensor(exchange_input(name))
    blocks = {(i, j): x[4 * i:4 * i + 4, 4 * j:4 * j + 4]
              for i in range(2) for j in range(4)}
    out = distribute.halo_exchange_pad(blocks, lo, hi, al, ("X", "Y"),
                                       {"X": 2, "Y": 4}, periodic=per)
    got = torch.cat([torch.cat([out[(i, j)] for j in range(4)], dim=1)
                     for i in range(2)], dim=0)
    np.testing.assert_array_equal(got.numpy(), reference[f"exchange/{name}"])


def test_ring_perms_equal_the_reference():
    from repro.core.boundary import ring_perms as ref_ring_perms
    for n in range(1, 6):
        for d in (1, -1):
            for per in (False, True):
                assert bc.ring_perms(n, d, per) == ref_ring_perms(n, d, per)
    with pytest.raises(ValueError):
        bc.ring_perms(4, 2, False)


DEGENERATE = [("cuda", None, None), ("torch_fused", None, None),
              ("torch_naive", None, None), ("cuda", "stream", 2)]


@pytest.mark.parametrize("steps", [None, 4])
@pytest.mark.parametrize("backend,schedule,time_tile", DEGENERATE)
def test_degenerate_mesh_is_bit_equal_to_the_local_compile(
        backend, schedule, time_tile, steps):
    """A 1x1x1 mesh takes the local pad path: its results equal the local
    compile's bit for bit."""
    if schedule == "stream" and steps is None:
        time_tile = None
    p = pw_advection()
    grid = (8, 8, 64)
    f, s, c = app_data("pw_advection", grid)
    kw = dict(backend=backend, schedule=schedule, time_tile=time_tile)
    if steps:
        kw.update(steps=steps, update=pw_advection_update(0.1))
    want = compile_program(p, grid, device="cpu", **kw)(f, s, c)
    ex = compile_program(p, grid, mesh=cpu_mesh((1, 1, 1), ("X", "Y", "Z")),
                         **kw)
    assert ex.shard.local_grid == grid
    got = ex(f, s, c)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sharded_kernels_run_at_every_shard_origin():
    """The ``cuda`` backend builds each kernel once on the shard-local
    grid with the global extent, and calls it on every shard at its
    origin, group by group."""
    c = CASES["tracer_zero_24"]
    ex = compile_case("tracer_zero_24", "cuda")
    local = ex.shard.local_grid
    assert local == (4, 8, 128)
    for call in ex.kernels:
        assert call.grid_shape == local
        assert call.global_extent == tuple(c["grid"])
    seen = []
    real = stencil3d.GroupCall.__call__

    def spy(self, padded, svec=None, pc=None, origin=None, input_pad=None,
            device=None):
        seen.append((self.group, tuple(origin)))
        return real(self, padded, svec, pc, origin, input_pad, device)

    stencil3d.GroupCall.__call__ = spy
    try:
        ex(*case_data("tracer_zero_24"))
    finally:
        stencil3d.GroupCall.__call__ = real
    origins = [(4 * i, 8 * j, 0) for i in range(2) for j in range(4)]
    want = [(call.group, o) for call in ex.kernels for o in origins]
    assert seen == want


def test_sharded_stream_axis_deepens_the_ghost_planes():
    """A mesh that cuts the stream axis lowers its sweeps with the
    reference's ``stream_sharded`` halos (the chain's lo ghost planes
    T-fold); one that does not keeps the local geometry."""
    cut = compile_case("pw_zero_stream_T2_steps5", "cuda")
    assert cut.shard.stream_sharded
    chain, rem = cut.kernels
    assert chain.stream_sharded and rem.stream_sharded
    assert (chain.T, rem.T) == (2, 1)
    assert chain.halo_lo[0] == 2 * rem.halo_lo[0]
    kept = compile_case("pw_zero_stream_T2_steps5", "cuda",
                        mesh=cpu_mesh((2, 2), ("Y", "Z")),
                        mesh_axes=(None, "Y", "Z"))
    assert not kept.shard.stream_sharded
    assert not any(k.stream_sharded for k in kept.kernels)


def test_sharded_executable_takes_a_batch():
    """``batched=True`` (the serving engine's form) runs a batch of three
    through the shards: each element equals its own sharded run."""
    ex = compile_case("pw_zero_loop4", "cuda")
    f, s, c = case_data("pw_zero_loop4")
    rng = np.random.default_rng(5)
    fb = {k: torch.as_tensor(np.stack([v, v * 0.5, rng.normal(
        size=v.shape).astype(np.float32) * 0.1])) for k, v in f.items()}
    sb = {k: torch.tensor([float(v)] * 3) for k, v in s.items()}
    cb = {k: torch.as_tensor(np.stack([v] * 3)) for k, v in c.items()}
    got = ex._fn(fb, sb, cb, batched=True)
    for i in range(3):
        want = ex({k: v[i] for k, v in fb.items()}, s, c)
        for k in want:
            torch.testing.assert_close(got[k][i], want[k], rtol=0, atol=0)


def test_single_hop_violation_raises_at_plan_time():
    """A halo deeper than a shard's extent raises when the shard spec is
    made, naming the levers (the stream axis's own)."""
    p = tracer_advection()
    grid = (8, 16, 64)
    mesh = cpu_mesh((8,), ("X",))
    with pytest.raises(ValueError, match="exceeds the local extent 1; "
                                         "coarsen the mesh axis 'X'"):
        compile_program(p, grid, mesh=mesh, mesh_axes=("X", None, None))
    plan = auto_plan(p, (1, 16, 64), schedule="stream")
    from repro_torch.core.dataflow import lower_to_dataflow
    halos = lower_to_dataflow(p, plan, stream_sharded=True).group_halos()
    with pytest.raises(ValueError, match="leave the stream axis unsharded"):
        make_shard_spec(p, plan, grid, mesh, ("X", None, None),
                        group_halos=halos, stream_axis=0)


def test_mesh_options_are_checked():
    p = pw_advection()
    grid = (8, 8, 32)
    with pytest.raises(ValueError, match="mesh_axes requires mesh="):
        compile_program(p, grid, device="cpu", mesh_axes=("X", None, None))
    mesh = cpu_mesh((2, 2), ("X", "Y"))
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        compile_program(p, grid, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="not divisible"):
        compile_program(p, (9, 8, 32), mesh=mesh)
    # mesh_axes default to the mesh's axis names, one a grid axis
    ex = compile_program(p, grid, mesh=mesh)
    assert ex.shard.mesh_axes == ("X", "Y", None)
    assert ex.plan.mesh_axes == ("X", "Y", None)
    assert ex.device == torch.device("cpu")


def test_make_auto_mesh_places_shards_only_where_asked():
    """Without ``devices=`` the mesh takes one card a shard and raises when
    there are too few (never the CPU, never stacking); explicit devices
    fill the mesh in C order."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 4:
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            make_auto_mesh((2, 2), ("X", "Y"))
    mesh = make_auto_mesh((2, 3), ("X", "Y"),
                          devices=["cpu"] * 5 + ["meta"])
    assert mesh.shape == {"X": 2, "Y": 3} and mesh.axis_names == ("X", "Y")
    assert mesh.devices[1, 2] == torch.device("meta")
    with pytest.raises(ValueError, match="takes 4 devices"):
        make_auto_mesh((2, 2), ("X", "Y"), devices=["cpu"] * 3)


def test_mesh_fingerprint_keys_topology_and_devices():
    a = cpu_mesh((2, 2), ("X", "Y"))
    b = cpu_mesh((4, 1), ("X", "Y"))
    two = make_auto_mesh((2, 2), ("X", "Y"), devices=["cpu", "cpu", "meta",
                                                      "meta"])
    axes = ("X", "Y", None)
    assert mesh_fingerprint(None, None) == "none"
    assert mesh_fingerprint(a, axes) == "X:2,Y:2,-:1/devices=1"
    assert mesh_fingerprint(b, axes) != mesh_fingerprint(a, axes)
    assert mesh_fingerprint(a, ("Y", "X", None)) != mesh_fingerprint(a, axes)
    assert mesh_fingerprint(two, axes) == "X:2,Y:2,-:1/devices=2"


def test_shard_lowered_event_and_exchange_spans():
    """The sharded lowering announces itself (``ShardLowered``, as the
    reference does) and every exchange shows as a ``distribute.exchange``
    span beside the kernels."""
    from repro_torch.obs import Tracer
    tr = Tracer()
    c = CASES["pw_zero_loop4"]
    ex = compile_case("pw_zero_loop4", "cuda", trace=tr)
    with tr.active():
        ex(*case_data("pw_zero_loop4"))
    ev = tr.events("ShardLowered")
    assert len(ev) == 1 and ev[0]["args"]["mode"] == "loop"
    assert ev[0]["args"]["local_grid"] == "4x4x64"
    spans = tr.spans("distribute.exchange")
    # one exchange a persistent field a step
    assert len(spans) == c["steps"] * 3


def test_exchange_moves_only_neighbour_slabs():
    """The bytes counted as exchanged are the neighbour slabs of the
    sharded axes: a (2,1) mesh over axis 0 of a periodic pw step moves
    each field's lo and hi planes of both shards."""
    p = pw_advection("periodic")
    grid = (8, 8, 32)
    f, s, c = app_data("pw_advection", grid)
    ex = compile_program(p, grid, mesh=cpu_mesh((2,), ("X",)),
                         mesh_axes=("X", None, None))
    distribute.exchanged_bytes = 0
    ex(f, s, c)
    call = ex.kernels[0]
    lo, hi = call.halo_lo[0], call.halo_hi[0]
    plane = 8 * 32 * 4                  # a (y, x) plane of float32
    assert distribute.exchanged_bytes == 3 * 2 * (lo + hi) * plane


def test_sharded_sweep_launch_counts_stay_zero_on_the_cpu():
    """On the CPU every shard runs the kernels' plain versions: no
    launch is counted."""
    before = (stencil3d.launches, stream3d.launches)
    compile_case("pw_zero_stream_T2_steps5", "cuda")(
        *case_data("pw_zero_stream_T2_steps5"))
    assert (stencil3d.launches, stream3d.launches) == before


def test_deprecated_make_sharded_executor_forwards():
    """The reference's deprecated entry point: it warns, forwards its
    backend to the plan and attaches the legacy attributes."""
    c = CASES["pw_zero_22"]
    mesh = cpu_mesh((2, 2), ("X", "Y"))
    p = program("pw", "zero")
    with pytest.warns(DeprecationWarning, match="make_sharded_executor"):
        ex = distribute.make_sharded_executor(p, tuple(c["grid"]), mesh,
                                              ("X", "Y", None),
                                              backend="torch_fused")
    assert ex.plan.backend == "torch_fused"
    assert ex.local_grid == (8, 6, 128)
    assert ex.mesh_axes == ex.field_spec == ("X", "Y", None)
    f, s, co = case_data("pw_zero_22")
    want = compile_program(p, tuple(c["grid"]), device="cpu",
                           backend="torch_fused")(f, s, co)
    got = ex(f, s, co)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
