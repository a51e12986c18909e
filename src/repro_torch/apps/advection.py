"""The paper's two evaluation kernels as stencil IR programs (§4).

* :func:`pw_advection` — the Piacsek–Williams advection scheme from the Met
  Office MONC atmospheric model: 3 stencil computations across 3 wind fields
  (u, v, w) producing 3 source terms (su, sv, sw), with per-level
  coefficients tzc1/tzc2/tzd1/tzd2 ("small data") and scalar tcx/tcy.
  Structure follows Brown 2021 [4] / the MONC kernel the paper benchmarks.

* :func:`tracer_advection` — the NEMO ocean-model tracer-advection benchmark
  from PSycloneBench: 24 stencil computations across 6 fields with deep
  producer->consumer chains (a MUSCL-style upwind scheme: slopes, limited
  slopes, directional fluxes, divergence updates).  The exact NEMO geometry
  factors are replaced by representative coefficients; the *structure* —
  op count, field count, dependency depth, subselection-style Select ops
  (which StencilFlow could not express, §4) — matches the benchmark's role
  in the paper.

Axis convention: (i, j, k) = (x, y, z) with k the contiguous lane axis.
"""

from __future__ import annotations

from ..core.frontend import ProgramBuilder, absolute, maximum, minimum, sign, where
from ..core.ir import Program


def pw_advection(boundary: str = "zero") -> Program:
    """``boundary="periodic"`` builds the torus-domain variant (every field
    wraps; same IR, same plans, different halo fill on every backend)."""
    b = ProgramBuilder("pw_advection", ndim=3, boundary=boundary)
    u, v, w = b.inputs("u", "v", "w")
    tcx, tcy = b.scalars("tcx", "tcy")
    tzc1, tzc2 = b.coeff("tzc1", axis=2), b.coeff("tzc2", axis=2)
    tzd1, tzd2 = b.coeff("tzd1", axis=2), b.coeff("tzd2", axis=2)
    su, sv, sw = b.outputs("su", "sv", "sw")

    # --- su: u-momentum source ------------------------------------------
    b.define(su,
        tcx * (u[-1, 0, 0] * (u[0, 0, 0] + u[-1, 0, 0])
               - u[0, 0, 0] * (u[1, 0, 0] + u[0, 0, 0]))
        + tcy * (u[0, -1, 0] * (v[0, -1, 0] + v[1, -1, 0])
                 - u[0, 0, 0] * (v[0, 0, 0] + v[1, 0, 0]))
        + tzc1[0] * u[0, 0, -1] * (w[0, 0, -1] + w[1, 0, -1])
        - tzc2[0] * u[0, 0, 0] * (w[0, 0, 0] + w[1, 0, 0]))

    # --- sv: v-momentum source ------------------------------------------
    b.define(sv,
        tcx * (v[-1, 0, 0] * (u[-1, 0, 0] + u[-1, 1, 0])
               - v[0, 0, 0] * (u[0, 0, 0] + u[0, 1, 0]))
        + tcy * (v[0, -1, 0] * (v[0, 0, 0] + v[0, -1, 0])
                 - v[0, 0, 0] * (v[0, 1, 0] + v[0, 0, 0]))
        + tzc1[0] * v[0, 0, -1] * (w[0, 0, -1] + w[0, 1, -1])
        - tzc2[0] * v[0, 0, 0] * (w[0, 0, 0] + w[0, 1, 0]))

    # --- sw: w-momentum source ------------------------------------------
    b.define(sw,
        tcx * (w[-1, 0, 0] * (u[-1, 0, 0] + u[-1, 0, 1])
               - w[0, 0, 0] * (u[0, 0, 0] + u[0, 0, 1]))
        + tcy * (w[0, -1, 0] * (v[0, -1, 0] + v[0, -1, 1])
                 - w[0, 0, 0] * (v[0, 0, 0] + v[0, 0, 1]))
        + tzd1[0] * w[0, 0, -1] * (w[0, 0, 0] + w[0, 0, -1])
        - tzd2[0] * w[0, 0, 0] * (w[0, 0, 1] + w[0, 0, 0]))
    return b.build()


def pw_advection_update(dt: float = 0.1):
    """Forward-Euler wind update for :func:`pw_advection` — the canonical
    time-stepping rule shared by the examples, benchmarks and the fused
    ``compile_program(..., steps=N, update=...)`` path."""
    def update(fields, out):
        return {"u": fields["u"] + dt * out["su"],
                "v": fields["v"] + dt * out["sv"],
                "w": fields["w"] + dt * out["sw"]}
    return update


def tracer_advection_update():
    """Tracer carry rule for :func:`tracer_advection`: the corrected tracer
    becomes next step's ``t``; velocities and metrics are steady."""
    def update(fields, out):
        return dict(fields, t=out["ta"])
    return update


def tracer_advection(boundary: str = "zero") -> Program:
    """24 stencil ops / 6 input fields, MUSCL-style, with dependency chains.

    ``boundary="periodic"`` builds the torus-domain variant."""
    b = ProgramBuilder("tracer_advection", ndim=3, boundary=boundary)
    # 6 fields: tracer, 3 velocity components, 2 metric/mask fields
    t, un, vn, wn, e3t, msk = b.inputs("t", "un", "vn", "wn", "e3t", "msk")
    rdt, zeps = b.scalars("rdt", "zeps")
    ztfreez = b.coeff("ztfreez", axis=2)   # per-level reference
    # intermediates (temps) and the stored result
    names = ["zdx", "zdy", "zdz",              # raw slopes          (3)
             "zsx", "zsy", "zsz",              # limited slopes      (3)
             "zfx", "zfy", "zfz",              # upwind fluxes       (3)
             "zdivx", "zdivy", "zdivz",        # flux divergences    (3)
             "zta1",                           # first update        (1)
             "zdx2", "zdy2", "zdz2",           # second-pass slopes  (3)
             "zsx2", "zsy2", "zsz2",           # limited again       (3)
             "zfx2", "zfy2", "zfz2",           # corrected fluxes    (3)
             "zdiv2"]                          # corrector divergence(1)
    tmp = {n: b.temp(n) for n in names}
    ta = b.output("ta")                        # final op -> 24 total

    T = lambda n: tmp[n]

    # -- first pass: slopes ------------------------------------------------
    b.define(T("zdx"), (t[1, 0, 0] - t[0, 0, 0]) * msk[0, 0, 0])
    b.define(T("zdy"), (t[0, 1, 0] - t[0, 0, 0]) * msk[0, 0, 0])
    b.define(T("zdz"), (t[0, 0, 1] - t[0, 0, 0]) * msk[0, 0, 0])

    # -- slope limiting (minmod-like, uses Select/abs/sign) ----------------
    def limit(s, name):
        d0 = s[0, 0, 0]
        dm = {"zsx": s[-1, 0, 0], "zsy": s[0, -1, 0], "zsz": s[0, 0, -1]}[name]
        return where(d0 * dm > 0.0,
                     sign(d0) * minimum(absolute(d0), absolute(dm)),
                     0.0)

    b.define(T("zsx"), limit(T("zdx"), "zsx"))
    b.define(T("zsy"), limit(T("zdy"), "zsy"))
    b.define(T("zsz"), limit(T("zdz"), "zsz"))

    # -- upwind fluxes ------------------------------------------------------
    def flux(vel, s, t_up_off, ax):
        up = t[tuple(-1 if a == ax else 0 for a in range(3))]
        ce = t[0, 0, 0]
        sm = s[tuple(-1 if a == ax else 0 for a in range(3))]
        sc = s[0, 0, 0]
        v0 = vel[0, 0, 0]
        pos = v0 * (up + 0.5 * sm)      # upstream reconstruction
        neg = v0 * (ce - 0.5 * sc)
        return where(v0 > 0.0, pos, neg)

    b.define(T("zfx"), flux(un, T("zsx"), -1, 0))
    b.define(T("zfy"), flux(vn, T("zsy"), -1, 1))
    b.define(T("zfz"), flux(wn, T("zsz"), -1, 2))

    # -- divergences --------------------------------------------------------
    b.define(T("zdivx"), (T("zfx")[1, 0, 0] - T("zfx")[0, 0, 0]) / (e3t[0, 0, 0] + zeps))
    b.define(T("zdivy"), (T("zfy")[0, 1, 0] - T("zfy")[0, 0, 0]) / (e3t[0, 0, 0] + zeps))
    b.define(T("zdivz"), (T("zfz")[0, 0, 1] - T("zfz")[0, 0, 0]) / (e3t[0, 0, 0] + zeps))

    # -- first (predictor) update, with per-level freezing floor -----------
    b.define(T("zta1"),
             maximum(t[0, 0, 0] - rdt * (T("zdivx")[0, 0, 0]
                                         + T("zdivy")[0, 0, 0]
                                         + T("zdivz")[0, 0, 0]),
                     ztfreez[0]))

    # -- second (corrector) pass on the predicted tracer -------------------
    b.define(T("zdx2"), (T("zta1")[1, 0, 0] - T("zta1")[0, 0, 0]) * msk[0, 0, 0])
    b.define(T("zdy2"), (T("zta1")[0, 1, 0] - T("zta1")[0, 0, 0]) * msk[0, 0, 0])
    b.define(T("zdz2"), (T("zta1")[0, 0, 1] - T("zta1")[0, 0, 0]) * msk[0, 0, 0])

    def limit2(s, name):
        d0 = s[0, 0, 0]
        dm = {"zsx2": s[-1, 0, 0], "zsy2": s[0, -1, 0], "zsz2": s[0, 0, -1]}[name]
        return where(d0 * dm > 0.0,
                     sign(d0) * minimum(absolute(d0), absolute(dm)),
                     0.0)

    b.define(T("zsx2"), limit2(T("zdx2"), "zsx2"))
    b.define(T("zsy2"), limit2(T("zdy2"), "zsy2"))
    b.define(T("zsz2"), limit2(T("zdz2"), "zsz2"))

    def flux2(vel, s, ax):
        up = T("zta1")[tuple(-1 if a == ax else 0 for a in range(3))]
        ce = T("zta1")[0, 0, 0]
        sm = s[tuple(-1 if a == ax else 0 for a in range(3))]
        sc = s[0, 0, 0]
        v0 = vel[0, 0, 0]
        return where(v0 > 0.0, v0 * (up + 0.5 * sm), v0 * (ce - 0.5 * sc))

    b.define(T("zfx2"), flux2(un, T("zsx2"), 0))
    b.define(T("zfy2"), flux2(vn, T("zsy2"), 1))
    b.define(T("zfz2"), flux2(wn, T("zsz2"), 2))

    b.define(T("zdiv2"),
             (T("zfx2")[1, 0, 0] - T("zfx2")[0, 0, 0]
              + T("zfy2")[0, 1, 0] - T("zfy2")[0, 0, 0]
              + T("zfz2")[0, 0, 1] - T("zfz2")[0, 0, 0]) / (e3t[0, 0, 0] + zeps))

    b.define(ta,
             (0.5 * (t[0, 0, 0] + T("zta1")[0, 0, 0])
              - 0.5 * rdt * T("zdiv2")[0, 0, 0]) * msk[0, 0, 0])
    return b.build()
