"""Shift-register sweep kernel for Hopper, generated from the IR as CUDA C++.

Replaces the TPU kernel ``repro.core.lower_stream.build_stream_call`` (the
Pallas call at ``src/repro/core/lower_stream.py:472``): one legalised
stream region (``dataflow.StreamRegion``) swept along axis 0.  Every input
plane enters a rolling window of ``depths[f]`` planes once; temps read at
past planes keep rings of their recent planes (zeros for planes outside the
domain); zero-boundary results are masked on the non-stream margins against
the *global* domain through the runtime origin; axis-0 coefficients are
read per plane at a clamped index, the others along their axis.  With
``time_tile=T`` the kernel chains T time steps, each stage trailing the
last by the region's lead, applies the fused loop's update rule between
stages (traced into IR expressions by ``core.lower_stream``) and returns
the updated fields; with ``plane_tile=P`` it advances P planes per step of
its loop.

Bound on the H100: bytes.  A sweep reads each region input's grid points
once and writes each stored field once (per T steps for a chain):
pw_advection at 512x256x256 moves 3 + 3 float32 fields, 0.2404 ms at
3.35 TB/s.  Its arithmetic is far below the card's float32 rate.  The
TPU kernel keeps whole planes in VMEM and relies on its grid running in
order; CUDA CTAs run in no set order, and one CTA has 227 KB of shared
memory.  So each CTA owns a tile of the non-stream axes
(``schedule.plan_stream_cta``), widened by the region's non-stream halo
(T-fold for a chain), and sweeps a chunk of axis 0 itself; its windows,
per-op result planes, temp rings and per-stage field rings live in shared
memory and rotate by plane index, so each input plane comes from device
memory once per CTA (the halo columns of neighbouring tiles come again,
mostly from L2).  What keeps such a sweep from the byte bound is latency:
a plane that is loaded and only then computed leaves nothing in flight
while it computes.  The design:

* every input's window is a ring fed by ``cp.async`` (16 bytes a copy
  where the window's base, strides and rows allow, else 4 bytes, or
  element by element for unaligned bfloat16; rows padded to 16 bytes in
  shared memory): it holds the ``depth + P - 1`` planes a loop step reads
  and the P planes of the next step in flight; warm-up planes and the
  chunk's prologue come through the same ring;
* a loop step waits for its own planes (``cp.async.wait_all``), passes
  one barrier, starts the fetch of the next step's planes into the slots
  the previous step read, then computes; that top barrier also closes the
  previous step's last level, so a stage ends with a barrier only where
  the next chain stage, or the next plane of the same step, reads or
  overwrites what it wrote;
* ops are evaluated level by level, one barrier between levels, the
  CTA's threads spread evenly over each loop's margin-extended plane by
  one flat index; a temp is evaluated once per plane into shared memory
  and read by its consumers there; a chain stage applies the update rule
  in the loop that computes the region's outputs, at each thread's own
  point, where their margins allow (else in a loop of its own, after a
  barrier);
* the generated code is mostly index work, so it is kept small: loops are
  rolled, the thread and plane indices are opaque to the compiler once a
  step (nothing plane-invariant is held in registers across the sweep),
  and the launch bounds hold ptxas to the registers the planner counted
  (``schedule.STREAM_REGS``) at the CTAs an SM it planned;
* to fill the card the stream axis is cut into chunks, one per CTA
  (``schedule.sweep_chunk``); each chunk first recomputes ``warmup`` planes
  below its first output plane (the reference's sharded-sweep ghost
  planes, T-fold for a chain), so the results do not depend on the
  chunking.  A sweep over a sharded stream axis (``stream_sharded``: a
  mesh cuts axis 0, so the planes below a shard's first plane lie in the
  global domain) takes the reference's deeper lo-side input halo, and its
  first chunk warms up below the shard's first plane like any other
  chunk, reading planes before the padded input as zeros (they lie
  outside what the shard's planes depend on).

The plane unroll is a compile-time unroll of the plane loop by P.  A batch
of requests is one launch, as in the block kernel
(``stencil3d.batch_prologue``): the batch index is ``blockIdx.y``, every
pointer advances by its batch stride, and each element's scalars come from
a ``(batch, n_scalars)`` array on the card; the batch size is a runtime
argument of the one build.  float32 and bfloat16 are compiled (bfloat16
rounds each op's result and each updated field); float64 raises
``NotImplementedError`` on the card.
The C entry returns ``cudaGetLastError()`` and the wrapper raises if it is
not 0.  All inline PTX sits in ``stencil3d.BLOCK_HELPERS``' helper block,
which the host emulation swaps for plain copies.

:func:`stream_call_reference` is the plain PyTorch version with the same
signature and geometry, a plane-by-plane sweep with the TPU kernel's window
buffers, rings, chain stages and P-plane steps.  :class:`StreamCall` runs
it for CPU tensors and launches the kernel for CUDA tensors; ``launches``
counts the launches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import boundary as bc
from ..core.expr_eval import evaluate
from ..core.ir import Access, CoeffRef, Program
from ..core.schedule import (COPY_BYTES, StreamCTA, plan_stream_cta,
                             serving_domain, stream_levels,
                             stream_plane_ops, stream_stage_add,
                             stream_update_fuses)
from .stencil3d import (_CTYPE, _DTYPE_NAMES, _Emitter, _check_batch,
                        _coeff_args, _window_origin, batch_prologue,
                        c_argtypes, call_device, kernel_head, kernel_params,
                        launch, launch_entry, per_element)

#: kernel launches made by :class:`StreamCall` (plain-version runs excluded)
launches = 0

#: the TPU kernel this module replaces
REPLACES = "src/repro/core/lower_stream.py:472"


class StreamCall:
    """One region's sweep kernel: callable(padded_inputs, scalars_vec,
    padded_coeffs, origin, input_pad) -> {stored field: tensor}.

    ``padded_inputs`` must be padded by ``pad_lo``/``pad_hi``; with
    ``input_pad[f]`` an input may be an oversized buffer carrying that
    (ndim, 2) padding, from which the sweep reads its window in place.  A
    leading batch axis runs a batch in one launch, as
    :class:`~repro_torch.kernels.stencil3d.GroupCall` does.
    With ``update`` (the normalised fused-loop rule) and ``update_exprs``
    (the same rule traced to one IR expression per field) the call chains
    ``time_tile`` steps and returns the updated fields
    (``returns_fields``).  ``stream_sharded`` marks a sweep over a stream
    axis a mesh decomposes (the reference's flag of the same name).  The geometry attributes are the TPU kernel's, so
    the orchestrators in ``core.lower_kernel`` drive both kernels alike.
    ``tile``/``chunk`` override the planner's CTA (tests).
    """

    #: the schedule whose kernels this class generates
    schedule = "stream"

    def __init__(self, p: Program, region, grid_shape: Sequence[int],
                 dtype=torch.float32,
                 global_extent: Sequence[int] | None = None,
                 time_tile: int = 1, update=None, update_exprs=None,
                 plane_tile: int = 1, tile=None, chunk=None,
                 stream_sharded: bool = False):
        ndim = p.ndim
        gh = region.halo
        T = max(1, int(time_tile))
        if T > 1 and (update is None or update_exprs is None):
            raise ValueError("time_tile > 1 chains timestep stages in-kernel "
                             "and needs the traced fused-loop update rule")
        self.program = p
        self.region = region
        self.ndim = ndim
        self.dtype = dtype
        self.dtype_name = _DTYPE_NAMES[dtype]
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.global_extent = tuple(int(g) for g in (
            self.grid_shape if global_extent is None else global_extent))
        n0 = self.grid_shape[0]
        hl = tuple(int(gh.input_halo[a, 0]) for a in range(ndim))
        hh = tuple(int(gh.input_halo[a, 1]) for a in range(ndim))
        self.hl, self.hh = hl, hh
        self.lead = lead = hh[0]
        # lo-side stream pad: shallow locally (warm-up planes below the
        # domain are masked), chain-deepened exact ghost planes when the
        # stream axis is sharded (``region.halo`` then comes from a graph
        # lowered with the same flag)
        self.stream_sharded = bool(stream_sharded)
        self.halo_lo = ((T * hl[0] if self.stream_sharded else hl[0]),) \
            + tuple(T * hl[a] for a in range(1, ndim))
        self.halo_hi = (T * lead,) + tuple(T * hh[a] for a in range(1, ndim))
        span = self.halo_lo[0] + self.halo_hi[0]
        self.n_steps = n0 + span
        P = max(1, int(plane_tile))
        if P > n0:
            raise ValueError(
                f"plane_tile {P} exceeds the stream extent {n0}; "
                "dataflow.plane_split_reason should have demoted it")
        self.T, self.P = T, P
        # a serving program's real domain inside its bucket: zero-boundary
        # ops read as 0 outside it, on every axis (``serving_domain``)
        self.domain = serving_domain(p)
        if self.domain is not None and T > 1:
            raise NotImplementedError(
                "a chained sweep of a serving program: the serving update "
                "rule refreshes whole bucket axes, so the compile demotes "
                "the chain to time_tile=1")
        # the TPU kernel's P-plane grid (the plain version replays it)
        self.n_out = -(-n0 // P)
        self.K = -(-span // P)
        self.stage_r = self.K * P - span
        self.n_tiles = self.n_out + self.K
        self.pad_round = self.n_tiles * P - self.n_steps
        self.plane_ext = tuple(self.grid_shape[a] + self.halo_lo[a]
                               + self.halo_hi[a] for a in range(1, ndim))
        self.stage_add = stream_stage_add(region)

        self.ops = [p.ops[i] for i in region.ops]
        self.margins = {p.ops[i].out: gh.margins[i] for i in region.ops}
        # the axes along which each op's value and each input are zero
        # outside the domain (masked), the others wrap
        self.zero_axes = {
            f: tuple(ax for ax in range(ndim)
                     if not bc.is_periodic(p.fields[f].boundary, ax))
            for f in [op.out for op in self.ops] + list(gh.group_inputs)}
        self.produced = {op.out for op in self.ops}
        self.out_names = [op.out for op in self.ops
                          if op.out in set(gh.group_outputs)]
        self.update = update
        self.update_exprs = update_exprs
        self.group_inputs = list(gh.group_inputs)
        self.group_outputs = (list(self.group_inputs) if update is not None
                              else list(self.out_names))
        self.returns_fields = update is not None
        self.group_coeffs = list(gh.group_coeffs)
        self.coeff_axis = {c: p.coeffs[c] for c in gh.group_coeffs}
        self.depths = {f: int(region.depths[f]) for f in self.group_inputs}
        self.rings = {t: int(r) for t, r in region.rings.items()}
        self.n_scalars = len(p.scalars)
        self.stage_margins = [{out: m + (T - 1 - s) * self.stage_add
                               for out, m in self.margins.items()}
                              for s in range(T)]
        self.ring_plane_ext = [tuple(self.grid_shape[a] + (T - s)
                                     * (hl[a] + hh[a])
                                     for a in range(1, ndim))
                               for s in range(T)]
        # geometry for the shared orchestrators (the TPU kernel's)
        self.block = (1,) + self.grid_shape[1:]
        self.align_hi = (0,) * ndim
        self.pad_lo = self.halo_lo
        self.pad_hi = self.halo_hi
        self.window = (span + 1,) + self.plane_ext
        self.tiles = (self.n_tiles,)
        self.stream_axis = 0
        self.chain = T
        self.plane_tile = P
        self.expect = tuple(self.halo_lo[a] + self.grid_shape[a]
                            + self.halo_hi[a] for a in range(ndim))
        # the CTA of the CUDA kernel (2.5-D blocking)
        self.cta: StreamCTA = plan_stream_cta(
            p, region, self.grid_shape, T, P, self.dtype_name, tile=tile,
            chunk=chunk, updates=update is not None)
        self.smem_bytes = self.cta.smem_bytes
        self.threads = self.cta.threads
        self.module = None
        self.entry = "g0"

    # ------------------------------------------------------------ running
    def __call__(self, padded_inputs: dict, scalars_vec=None,
                 padded_coeffs: dict | None = None, origin=None,
                 input_pad: dict | None = None, device=None) -> dict:
        """Run the region on its inputs' device; ``device`` (the
        orchestrator's) decides for a region that reads no field or
        coefficient."""
        dev = call_device(self, padded_inputs, padded_coeffs, device,
                          "stream region")
        if dev.type == "cpu":
            return stream_call_reference(self, padded_inputs, scalars_vec,
                                         padded_coeffs, origin, input_pad,
                                         device=dev)
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        return launch(self, padded_inputs, scalars_vec, padded_coeffs or {},
                      origin, input_pad or {}, device=dev)

    def count_launch(self) -> None:
        global launches
        launches += 1

    def kernel_args(self, padded_inputs, sv, padded_coeffs, origin,
                    input_pad, outs) -> list:
        """The kernel's arguments in :meth:`c_argtypes` order (without the
        stream), after checking every tensor: a pointer to the window's
        origin inside each input's first element with the input's two outer
        strides (a 2-D program's unit axis gets stride 0) and its batch
        stride; coefficient pointers with their batch strides; output
        pointers; the ``(B, n_scalars)`` scalar rows ``sv``; the origin,
        lifted to three axes; the batch size B (as
        ``stencil3d.GroupCall.kernel_args``)."""
        ndim = self.ndim
        lift = 3 - ndim
        device, nb = _check_batch(self, sv, outs)
        args = []
        for f in self.group_inputs:
            x = padded_inputs[f]
            self._check(x, f, device)
            x, lo = _window_origin(self, f, x, input_pad, nb)
            base = sum(lo[a] * x.stride(1 + a) for a in range(ndim))
            s0, s1 = x.stride(1), (x.stride(2) if ndim == 3 else 0)
            ptr = x.data_ptr() + base * self.itemsize
            sb = x.stride(0)
            args += [ptr, s0, s1,
                     self._copy_bytes(x, ptr, [s0, s1] + [sb] * (nb > 1),
                                      lo[-1]), sb]
        args += _coeff_args(self, padded_coeffs, device, nb)
        for f in self.group_outputs:
            self._check(outs[f], f, device)
            args.append(outs[f].data_ptr())
        args.append(sv.data_ptr())
        org = [0] * ndim if origin is None else [int(o) for o in origin]
        return args + org[:1] + [0] * lift + org[1:] + [nb]

    def _copy_bytes(self, x, ptr, strides, col) -> int:
        """Bytes one copy of an input's planes moves: 16, else 4, where the
        window's base, ``strides`` (the outer ones, and the batch stride
        of a batch of several) and the tile's first column are multiples
        of it and the copies that round a row up to it stay inside the row
        (``col``: the window's first column in ``x``); else one
        element."""
        for q in (COPY_BYTES, 4):
            e = q // self.itemsize
            if e and ptr % q == 0 \
                    and all(s * self.itemsize % q == 0 for s in strides) \
                    and self.cta.tile[-1] % e == 0 \
                    and col + -(-self.expect[-1] // e) * e <= x.shape[-1]:
                return q
        return self.itemsize

    def _check(self, t, name, device):
        if t.device != device:
            raise ValueError(f"{name!r} is on {t.device}, expected {device}")
        if t.dtype != self.dtype:
            raise ValueError(f"{name!r} has dtype {t.dtype}, expected "
                             f"{self.dtype}")

    # ----------------------------------------------------------- emitting
    def kernel_params(self) -> list:
        """Parameter declarations (``stencil3d.kernel_params``)."""
        return kernel_params(self)

    def c_argtypes(self) -> list:
        return c_argtypes(self)

    def source(self, name: str | None = None) -> str:
        """CUDA C++ of this region's sweep kernel and its C launch entry."""
        return _SweepEmitter(self, name or self.entry).emit()

    def barriers_per_plane(self) -> float:
        """``__syncthreads`` the kernel passes per plane it sweeps."""
        return _SweepEmitter(self, self.entry).barriers_per_plane()

    def staged_bytes_per_point(self) -> float:
        """Bytes the CTAs stage into shared memory per grid point (halo
        rows, padded columns, warm-up planes and each chunk's planes
        below and ahead of the ones it sweeps included)."""
        extra = (self.T - 1) * self.lead
        return self.cta.staged_bytes_per_point(
            self.grid_shape, {f: d - 1 + extra
                              for f, d in self.depths.items()})


# --------------------------------------------------------------------------
# The plain PyTorch version
# --------------------------------------------------------------------------

def stream_call_reference(call: StreamCall, padded_inputs: dict,
                          scalars_vec=None, padded_coeffs: dict | None = None,
                          origin=None, input_pad: dict | None = None,
                          device=None) -> dict:
    """The region's sweep in plain PyTorch, on any device, grid step by
    grid step as the TPU kernel runs it: window buffers shifted by P planes
    per step, temp rings that store zeros outside the domain, T chained
    stages with the update rule applied plane-wise between them, and the
    staging ring that realigns completed planes to P-plane output blocks.
    Same arguments and geometry as the kernel, the batch axis included
    (``stencil3d.per_element``), and the same rounding: a bfloat16 call
    computes each op (and each update) in float32 and rounds its
    result."""
    return per_element(_stream_reference, call, padded_inputs, scalars_vec,
                       padded_coeffs, origin, input_pad, device)


def _stream_reference(call: StreamCall, padded_inputs: dict, scalars_vec,
                      padded_coeffs: dict, origin, input_pad,
                      device=None) -> dict:
    """:func:`stream_call_reference` for one request."""
    p, ndim, dtype = call.program, call.ndim, call.dtype
    cdt = torch.float32 if dtype == torch.bfloat16 else dtype
    padded_coeffs = padded_coeffs or {}
    grid, ge = call.grid_shape, call.global_extent
    T, P, lead = call.T, call.P, call.lead
    hl, hh, halo_lo = call.hl, call.hh, call.halo_lo
    device = call_device(call, padded_inputs, padded_coeffs, device,
                         "stream region")
    xs = {}
    for f in call.group_inputs:
        x = padded_inputs[f]
        ip = (input_pad or {}).get(f)
        if ip is not None:
            x = x[tuple(slice(int(ip[a][0]) - halo_lo[a],
                              int(ip[a][0]) - halo_lo[a] + call.expect[a])
                        for a in range(ndim))]
        x = x.to(cdt)
        if call.pad_round:
            x = torch.cat([x, x.new_zeros((call.pad_round,) + x.shape[1:])])
        xs[f] = x
    cvecs = {c: padded_coeffs[c].to(cdt) for c in call.group_coeffs}
    svec = [] if scalars_vec is None else list(scalars_vec)
    sdict = {s: torch.tensor(float(svec[i]), dtype=torch.float32,
                             device=device)
             for i, s in enumerate(p.scalars[:len(svec)])}
    org = [0] * ndim if origin is None else [int(o) for o in origin]
    # the domain of the masks: the global one, or a serving program's
    dom = call.domain
    dom_lo = dom[0] if dom is not None else (0,) * ndim
    dom_n = ([int(float(svec[k])) for k in dom[1]] if dom is not None
             else list(ge))
    ops, produced, margins = call.ops, call.produced, call.margins
    stage_margins = call.stage_margins
    depths, ring_depth = call.depths, call.rings
    ring_names = [op.out for op in ops if op.out in ring_depth]
    store_names = call.group_outputs

    def zeros(shape):
        return torch.zeros(shape, dtype=cdt, device=device)

    def ext_of(m):
        return tuple(grid[a] + int(m[a, 0]) + int(m[a, 1])
                     for a in range(1, ndim))

    def plane_slices(src_lo, m, offset):
        return tuple(slice(int(src_lo[a] - m[a, 0] + offset[a]),
                           int(src_lo[a] - m[a, 0] + offset[a])
                           + grid[a] + int(m[a, 0]) + int(m[a, 1]))
                     for a in range(1, ndim))

    def in_domain(ext, lo_off):
        """Mask of the non-stream positions (offset by ``lo_off`` below
        the shard's origin) inside the global domain, or None."""
        mask = None
        for a in range(1, ndim):
            if lo_off[a] is None:
                continue
            coord = org[a] - lo_off[a] + torch.arange(ext[a - 1],
                                                      device=device)
            ok = (coord >= dom_lo[a]) & (coord < dom_lo[a] + dom_n[a])
            shape = [1] * (ndim - 1)
            shape[a - 1] = ext[a - 1]
            ok = ok.reshape(shape)
            mask = ok if mask is None else (mask & ok)
        return mask

    bufs = {f: zeros((depths[f],) + call.plane_ext) for f in call.group_inputs}
    field_vals = [None] + [{f: zeros((depths[f],) + call.ring_plane_ext[s])
                            for f in call.group_inputs} for s in range(1, T)]
    rings = [{t: zeros((ring_depth[t],) + ext_of(stage_margins[s][t]))
              for t in ring_names} for s in range(T)]
    staged = {f: zeros((call.stage_r,) + grid[1:]) for f in store_names}
    outs = {f: torch.empty((call.n_out * P,) + grid[1:], dtype=dtype,
                           device=device) for f in store_names}

    for j in range(call.n_tiles):
        cats = {f: torch.cat([bufs[f], xs[f][j * P:(j + 1) * P]])
                for f in call.group_inputs}
        completed = {f: [] for f in store_names}
        for k_plane in range(P):
            t_step = j * P + k_plane
            for s in range(T):
                acc = T - 1 - s
                margins_s = stage_margins[s]
                c_plane = t_step - halo_lo[0] - (s + 1) * lead
                results: dict = {}
                memo: dict = {}
                for op in ops:
                    m = margins_s[op.out]
                    ext = ext_of(m)

                    def coeff(cr: CoeffRef, m=m, s=s, t_step=t_step):
                        ax = call.coeff_axis[cr.coeff]
                        cvec = cvecs[cr.coeff]
                        if ax == 0:
                            idx = min(max(t_step - (s + 1) * lead
                                          + cr.offset, 0), cvec.shape[0] - 1)
                            return cvec[idx].reshape((1,) * (ndim - 1))
                        start = int(halo_lo[ax] - m[ax, 0] + cr.offset)
                        size = grid[ax] + int(m[ax, 0]) + int(m[ax, 1])
                        shape = [1] * (ndim - 1)
                        shape[ax - 1] = size
                        return cvec[start:start + size].reshape(shape)

                    def access(a: Access, m=m, s=s, k_plane=k_plane,
                               margins_s=margins_s, results=results):
                        o0 = int(a.offset[0])
                        if a.field in produced:
                            pm = margins_s[a.field]
                            if a.field in ring_depth:
                                plane = rings[s][a.field][
                                    ring_depth[a.field] - 1 + o0]
                            else:
                                plane = results[a.field]
                            return plane[plane_slices(pm[:, 0], m, a.offset)]
                        idx = depths[a.field] - 1 - lead + o0
                        if s == 0:
                            plane = cats[a.field][k_plane + 1 + idx]
                            src_lo = halo_lo
                        else:
                            plane = field_vals[s][a.field][idx]
                            src_lo = tuple((T - s) * hl[ax]
                                           for ax in range(ndim))
                        return plane[plane_slices(src_lo, m, a.offset)]

                    mkey = tuple(int(v) for v in m.flatten())
                    res = evaluate(op.expr, access, sdict.__getitem__,
                                   memo.setdefault(mkey, {}), coeff=coeff)
                    if not isinstance(res, torch.Tensor):
                        res = torch.tensor(res, device=device)
                    res = res.to(dtype).to(cdt).expand(ext)
                    zero = call.zero_axes[op.out]
                    if zero and dom is not None:
                        cg = org[0] + c_plane
                        mask = in_domain(ext, [None] + [
                            int(m[a, 0]) for a in range(1, ndim)])
                        if mask is None:
                            mask = torch.ones((), dtype=torch.bool,
                                              device=device)
                        if not dom_lo[0] <= cg < dom_lo[0] + dom_n[0]:
                            mask = torch.zeros((), dtype=torch.bool,
                                               device=device)
                        res = torch.where(mask, res, zeros(()))
                    elif any(m[a].any() for a in zero if a > 0):
                        mask = in_domain(ext, [None] + [
                            int(m[a, 0]) if m[a].any() and a in zero
                            else None for a in range(1, ndim)])
                        res = torch.where(mask, res, zeros(()))
                    results[op.out] = res
                    if op.out in ring_depth:
                        cg = org[0] + c_plane
                        ok = 0 <= cg < ge[0]
                        stored = res if ok else torch.zeros_like(res)
                        rings[s][op.out] = torch.cat(
                            [rings[s][op.out][1:], stored[None]])
                    if call.update is None and op.out in outs:
                        completed[op.out].append(res[tuple(
                            slice(int(m[a, 0]), int(m[a, 0]) + grid[a])
                            for a in range(1, ndim))])
                if call.update is None:
                    break
                ext_s = tuple(grid[a] + acc * (hl[a] + hh[a])
                              for a in range(1, ndim))
                cur = {}
                for f in call.group_inputs:
                    idx = depths[f] - 1 - lead
                    plane = (cats[f][k_plane + 1 + idx] if s == 0
                             else field_vals[s][f][idx])
                    cur[f] = plane[tuple(slice(hl[a], hl[a] + ext_s[a - 1])
                                         for a in range(1, ndim))]
                upd_outs = {}
                for f in call.out_names:
                    m = margins[f]
                    upd_outs[f] = results[f][tuple(
                        slice(int(m[a, 0]), int(m[a, 0]) + ext_s[a - 1])
                        for a in range(1, ndim))]
                merged = dict(cur)
                merged.update(call.update(cur, upd_outs, sdict))
                new = {f: torch.as_tensor(merged[f], device=device)
                       .to(dtype).to(cdt).expand(ext_s)
                       for f in call.group_inputs}
                if s == T - 1:
                    for f in call.group_inputs:
                        completed[f].append(new[f])
                    break
                cg = org[0] + c_plane
                masks = {}          # by the axes a field is zero along
                for f in call.group_inputs:
                    zero = call.zero_axes[f]
                    if zero not in masks:
                        masks[zero] = in_domain(ext_s, [None] + [
                            acc * hl[a] if a in zero and (
                                acc * (hl[a] + hh[a]) or grid[a] != ge[a])
                            else None for a in range(1, ndim)]) \
                            if 0 <= cg < ge[0] else torch.zeros(
                                (), dtype=torch.bool, device=device)
                    mask = masks[zero]
                    v = new[f] if mask is None else torch.where(
                        mask, new[f], zeros(()))
                    field_vals[s + 1][f] = torch.cat(
                        [field_vals[s + 1][f][1:], v.expand(ext_s)[None]])
        for f in call.group_inputs:
            bufs[f] = cats[f][P:]
        # the P-plane output block, realigned through the staging ring
        # (block b is final at grid step b + K; warm-up writes of block 0
        # are overwritten, as the TPU kernel's clamped index map does)
        b = min(max(j - call.K, 0), call.n_out - 1)
        for f in store_names:
            planes = [q[None] for q in completed[f]]
            if call.stage_r > 0:
                keep = P - call.stage_r
                block = torch.cat([staged[f]] + planes[:keep])
                staged[f] = torch.cat(planes[keep:])
            else:
                block = torch.cat(planes)
            outs[f][b * P:(b + 1) * P] = block.to(dtype)
    return {f: outs[f][:grid[0]] for f in store_names}


# --------------------------------------------------------------------------
# The emitter: region -> CUDA C++
# --------------------------------------------------------------------------

class _ExprEmitter(_Emitter):
    """Value-numbered SSA for one loop body of the sweep kernel: the block
    emitter's operators, with accesses and coefficients resolved by the
    sweep (``resolve``), not by the block kernel's window."""

    def __init__(self, scalars: dict, bf16: bool, resolve):
        self.scalars = scalars
        self.lines: list = []
        self.vn: dict = {}
        self.flops = 0
        self.bf16 = bf16
        self._resolve = resolve

    def access(self, e: Access, off: tuple):
        code = self._resolve(e)
        return self._var(("acc", e.field, tuple(e.offset)), code, "f")

    def coeff(self, e: CoeffRef, off: tuple):
        code = self._resolve(e)
        return self._var(("coeff", e.coeff, int(e.offset)), code, "f")


class _SweepEmitter:
    """CUDA C++ of one :class:`StreamCall` (see the module docstring).

    Non-stream axes are lifted to two, ``A`` (axis 1) and ``B`` (axis 2,
    contiguous); a 2-D program gets a unit ``A`` axis."""

    def __init__(self, call: StreamCall, name: str):
        if call.dtype_name not in _CTYPE:
            raise NotImplementedError(
                f"the CUDA sweep kernel takes float32 or bfloat16, not "
                f"{call.dtype_name}")
        self.call = call
        self.name = name
        self.p = call.program
        self.ct = _CTYPE[call.dtype_name]
        self.bf16 = call.dtype_name == "bfloat16"
        cta = call.cta
        lift = 3 - call.ndim

        def two(v, fill):
            return (fill,) * lift + tuple(v)

        self.two = two
        self.tile = two(cta.tile, 1)
        self.N = two(call.grid_shape[1:], 1)
        self.NG = two(call.global_extent[1:], 1)
        self.hl2 = two(call.hl[1:], 0)
        self.hh2 = two(call.hh[1:], 0)
        self.span2 = tuple(a + b for a, b in zip(self.hl2, self.hh2))
        self.scalars = {s: k for k, s in enumerate(self.p.scalars)}
        self.inputs = {f: k for k, f in enumerate(call.group_inputs)}
        self.coeffs = {c: k for k, c in enumerate(call.group_coeffs)}
        self.outputs = {f: k for k, f in enumerate(call.group_outputs)}
        self.keep = set(stream_plane_ops(self.p, call.region,
                                         call.update is not None))
        # the update rule runs in the outputs' loop, or in one of its own
        self.fused = (call.update is not None
                      and stream_update_fuses(self.p, call.region))
        # shared-memory layout, the planner's buffer order
        self.op_index = {op.out: j for j, op in enumerate(call.ops)}
        self.buf = {}
        off = 0
        self.ring_off = None
        for b in cta.buffers:
            if b.key[0] != "win" and self.ring_off is None:
                self.ring_off = off
            self.buf[b.key] = (off, b)
            off += b.nbytes
        self.smem = off
        if self.ring_off is None:
            self.ring_off = off
        self.levels = self._levels()

    # -------------------------------------------------------- structure
    def _levels(self) -> list:
        """Ops by level (``schedule.stream_levels``).  Within a level, ops
        with equal margins share a loop."""
        lvl = stream_levels(self.p, self.call.region)
        out = []
        for lv in range(max(lvl.values()) + 1 if lvl else 0):
            out.append([op for op in self.call.ops if lvl[op.out] == lv])
        return out

    def margin2(self, s: int, out: str):
        """Stage-``s`` margin of op ``out`` on the lifted axes: ((loA,
        hiA), (loB, hiB))."""
        m = self.call.stage_margins[s][out]
        return self.two([tuple(int(x) for x in m[a])
                         for a in range(1, self.call.ndim)], (0, 0))

    def buffer(self, key):
        off, b = self.buf[key]
        ext = self.two(b.extent, 1)
        return off, b.slots, ext

    # ------------------------------------------------------------- code
    def stage_barrier(self, s: int, kp: int) -> bool:
        """Whether stage ``s`` of the ``kp``-th plane of a loop step ends
        with a barrier: before the next chain stage, which reads the field
        ring this stage's update wrote, and before the next plane of the
        step where the stages write shared memory; never at the step's
        end, where the next step's top barrier closes it."""
        c = self.call
        if s < c.T - 1:
            return True
        return kp < c.P - 1 and bool(self.keep or c.T > 1)

    def barriers_per_plane(self) -> float:
        """``__syncthreads`` the kernel passes per plane of its sweep: the
        one at the top of each loop step, one per op level after the first
        and one before the update of every stage, and the stage ends of
        :meth:`stage_barrier`."""
        c = self.call
        n = 1
        for kp in range(c.P):
            for s in range(c.T):
                n += (len(self.levels) - 1
                      + (c.update is not None and not self.fused)
                      + self.stage_barrier(s, kp))
        return n / c.P

    def emit(self) -> str:
        c, ct, name = self.call, self.ct, self.name
        tx, ty = c.threads
        nt = tx * ty
        cta = c.cta
        TA, TB = self.tile
        NA, NB = self.N
        tiles = self.two(cta.tiles, 1)
        front = c.halo_lo[0] + c.lead
        P = c.P
        params = c.kernel_params()
        L = [f"// sweep kernel of region {c.region.ops} of "
             f"{self.p.name}: inputs [{', '.join(c.group_inputs)}], "
             f"stores [{', '.join(c.group_outputs)}]",
             f"// time_tile {c.T}, plane_tile {P}, CTA tile ({TA},{TB}), "
             f"chunk {cta.chunk} planes (+{cta.warmup} warm-up), "
             f"{cta.ctas} CTAs ({cta.ctas_per_sm} an SM), "
             f"{self.smem} B shared memory"]
        L += kernel_head(name, params, nt, cta.ctas_per_sm)
        L += ["  extern __shared__ __align__(16) unsigned char smem_raw[];"]
        for key, (off, b) in self.buf.items():
            ty_ = ct if key[0] == "win" else "float"
            L.append(f"  {ty_}* {self.bname(key)} = reinterpret_cast<{ty_}*>"
                     f"(smem_raw + {off});")
        L += batch_prologue(c)
        L += [
            "  const int bid = blockIdx.x;",
            f"  const int bB = (bid % {tiles[1]}) * {TB};",
            f"  const int bA = ((bid / {tiles[1]}) % {tiles[0]}) * {TA};",
            f"  const int c0 = (bid / {tiles[0] * tiles[1]}) * {cta.chunk};",
            f"  const int c1 = min({c.grid_shape[0]}, c0 + {cta.chunk});",
            f"  const int vA = min({TA}, {NA} - bA), "
            f"vB = min({TB}, {NB} - bB);",
            (f"  const int cs = c0 - {cta.warmup};" if c.stream_sharded
             else f"  const int cs = max(0, c0 - {cta.warmup});"),
            f"  const int ce = c1 - 1 + {(c.T - 1) * c.lead};",
            "  const int tid = threadIdx.y * blockDim.x + threadIdx.x;",
            "  (void)vA; (void)vB;",
        ]
        nring = (self.smem - self.ring_off) // 4
        if c.stream_sharded:
            # windows too: planes before the padded input read as zeros
            L += ["  // shared memory starts as zeros: planes before the "
                  "padded input are not fetched",
                  "  { float* z = reinterpret_cast<float*>(smem_raw);",
                  "#pragma unroll 1",
                  f"    for (int i = tid; i < {self.smem // 4}; i += {nt}) "
                  "z[i] = 0.0f; }",
                  "  __syncthreads();"]
        elif nring:
            L += ["  // rings start as zeros: planes before the sweep are "
                  "outside the domain",
                  f"  {{ float* z = reinterpret_cast<float*>(smem_raw + "
                  f"{self.ring_off});",
                  "#pragma unroll 1",
                  f"    for (int i = tid; i < {nring}; i += {nt}) "
                  "z[i] = 0.0f; }"]
        # each input's plane fetch into its window ring: planes past the
        # last one the chunk reads are not fetched
        modes = [(COPY_BYTES, COPY_BYTES // c.itemsize), (4, 4 // c.itemsize)]
        if c.itemsize < 4:
            modes.append((c.itemsize, 1))
        for f, k in self.inputs.items():
            off, S, (WA, WB) = self.buffer(("win", f))
            stage = (f"(dst, src, in{k}_s1, vA + {c.T * self.span2[0]}, "
                     f"{WB}, 0, vB + {c.T * self.span2[1]}, t, {nt})")
            guard = (f"q < 0 || q > ce + {front}" if c.stream_sharded
                     else f"q > ce + {front}")
            L += [f"  auto fetch{k} = [&](int q, int t) {{  // {f}",
                  f"    if ({guard}) return;",
                  f"    {ct}* dst = win{k} + pmod(q, {S}) * {WA * WB};",
                  f"    const {ct}* src = in{k} + (long long)q * in{k}_s0"
                  f" + (long long)bA * in{k}_s1 + bB;"]
            for i, (q, e) in enumerate(modes):
                if i == len(modes) - 1:
                    L.append(f"    else stage_rows<{e}>{stage};")
                else:
                    L.append(f"    {'else ' if i else ''}if (in{k}_q == {q})"
                             f" stage_rows<{e}>{stage};")
            L.append("  };")
        # the prologue: the planes the first step reads
        for f, k in self.inputs.items():
            d = c.depths[f]
            L.append(f"  for (int q = cs + {front - d + 1}; q < cs + "
                     f"{front + P}; ++q) fetch{k}(q, tid);")
        L.append("  cp_async_commit();")
        L += ["#pragma unroll 1",
              f"  for (int c = cs; c <= ce; c += {P}) {{",
              "    cp_async_wait_all();",
              "    __syncthreads();",
              "    const int tz = opaque(tid);"]
        for k in self.inputs.values():
            if P == 1:
                L.append(f"    fetch{k}(c + {front + 1}, tz);")
            else:
                L.append(f"    for (int q = c + {front + P}; q < c + "
                         f"{front + 2 * P}; ++q) fetch{k}(q, tz);")
        L.append("    cp_async_commit();")
        for kp in range(P):
            L.append(f"    if (c + {kp} <= ce) {{")
            L.append(f"      const int cc = c + {kp};")
            for s in range(c.T):
                L += ["      " + x for x in self._stage(s, kp)]
            L.append("    }")
        L += ["  }", "}", ""]
        L += launch_entry(name, params, cta.ctas, (tx, ty), self.smem)
        return "\n".join(L)

    def bname(self, key) -> str:
        """C name of a shared-memory buffer (by input or op index)."""
        if key[0] == "win":
            return f"win{self.inputs[key[1]]}"
        if key[0] == "field":
            return f"fr{key[1]}_{self.inputs[key[2]]}"
        return f"op{key[1]}_{self.op_index[key[2]]}"

    def _loop(self, ext_lo_hi, body: list) -> list:
        """The CTA's threads over the valid part of a plane extended by
        ``((loA, hiA), (loB, hiB))`` around the tile, one flat index over
        the full tile's extended plane (so every thread gets its share of
        the margins; the points a ragged tile lacks are skipped):
        ``lA``/``lB`` local, ``GA``/``GB`` global coordinates."""
        (la, ha), (lb, hb) = ext_lo_hi
        TA, TB = self.tile
        ea, eb = TA + la + ha, TB + lb + hb
        nt = self.call.threads[0] * self.call.threads[1]
        return (["#pragma unroll 1",
                 f"for (int i = tz; i < {ea * eb}; i += {nt}) {{",
                 f"  const int lA = i / {eb}, lB = i % {eb};",
                 f"  if (lA >= vA + {la + ha} || lB >= vB + {lb + hb}) "
                 "continue;",
                 f"  const int GA = org1 + bA - {la} + lA, "
                 f"GB = org2 + bB - {lb} + lB;",
                 "  (void)GA; (void)GB;"]
                + ["  " + x for x in body] + ["}"])

    def _mask(self, axes_lo: dict) -> str:
        """Condition that the position lies in the global domain on the
        lifted axes in ``axes_lo`` (``{"A"|"B": ...}``)."""
        ng = dict(zip("AB", self.NG))
        return " && ".join(f"G{a} >= 0 && G{a} < {ng[a]}" for a in axes_lo)

    def _domain_mask(self) -> str:
        """Condition that the point (plane ``qs``, position ``GA``/``GB``)
        lies in a serving program's real domain, the element's extents
        ``dn0``, ``dn1``, ... (``stencil3d.batch_prologue``)."""
        c = self.call
        lo = c.domain[0]
        cond = [f"(unsigned)(org0 + qs - {lo[0]}) < (unsigned)dn0"]
        cond += [f"(unsigned)(G{ax} - {lo[a]}) < (unsigned)dn{a}"
                 for a, ax in zip(range(1, c.ndim), "AB"[3 - c.ndim:])]
        return " && ".join(cond)

    def _stage(self, s: int, kp: int) -> list:
        """One chain stage at stage-0 plane ``cc`` (the ``kp``-th plane of
        the loop step): the op levels, then (in a chain) the update; stores
        zeros into the stage's rings when its plane lies outside the
        domain; ends with a barrier where :meth:`stage_barrier` asks."""
        c = self.call
        T = c.T
        body = [f"{{ // stage {s}",
                f"  const int qs = opaque(cc - {s * c.lead});",
                f"  if (org0 + qs >= 0 && org0 + qs < "
                f"{c.global_extent[0]}) {{"]
        for lv, ops in enumerate(self.levels):
            if lv:
                body.append("    __syncthreads();")
            groups: dict = {}
            for op in ops:
                groups.setdefault(self.margin2(s, op.out), []).append(op)
            for m2, gops in groups.items():
                body += ["    " + x for x in self._op_group(s, m2, gops)]
        if c.update is not None and not self.fused:
            body.append("    __syncthreads();")
            body += ["    " + x for x in self._update(s)]
        body.append("  } else {")
        zero = []
        for out in c.rings:
            if out not in self.keep:
                continue
            off, R, (PA, PB) = self.buffer(("op", s, out))
            zero += ["#pragma unroll 1",
                     f"for (int i = tz; i < {PA * PB}; i += "
                     f"{c.threads[0] * c.threads[1]})",
                     f"  {self.bname(('op', s, out))}[pmod(qs, {R}) * "
                     f"{PA * PB} + i] = 0.0f;"]
        if c.update is not None and s < T - 1:
            for f in c.group_inputs:
                off, D, (FA, FB) = self.buffer(("field", s + 1, f))
                zero += ["#pragma unroll 1",
                         f"for (int i = tz; i < {FA * FB}; i += "
                         f"{c.threads[0] * c.threads[1]})",
                         f"  {self.bname(('field', s + 1, f))}[pmod(qs, "
                         f"{D}) * {FA * FB} + i] = 0.0f;"]
        body += ["    " + x for x in zero]
        body.append("  }")
        if self.stage_barrier(s, kp):
            body.append("  __syncthreads();")
        return body + ["}"]

    def _resolver(self, s: int, m2):
        """Access/coefficient resolution for stage ``s`` code evaluated on
        a plane of margin ``m2`` (position ``lA``/``lB``)."""
        c = self.call
        T = c.T
        (ma, _), (mb, _) = m2
        lift = 3 - c.ndim

        def off2(e):
            o = tuple(int(x) for x in e.offset)
            return (o[0],) + (0,) * lift + o[1:]

        def resolve(e):
            if isinstance(e, CoeffRef):
                k = self.coeffs[e.coeff]
                ax = c.coeff_axis[e.coeff]
                if ax == 0:
                    return (f"ld(&cf{k}[min(max(qs + "
                            f"{c.halo_lo[0] + int(e.offset)}, 0), "
                            f"{c.n_steps - 1})])")
                la = ax - 1 + lift
                base, lo, pos = (("bA", ma, "lA") if la == 0
                                 else ("bB", mb, "lB"))
                return (f"ld(&cf{k}[{base} + {pos} + "
                        f"{c.halo_lo[ax] - lo + int(e.offset)}])")
            o0, oa, ob = off2(e)
            if e.field in c.produced:
                key = ("op", s, e.field)
                off, R, (PA, PB) = self.buffer(key)
                (ta, _), (tb, _) = self.margin2(s, e.field)
                slot = (f"pmod(qs + ({o0}), {R}) * {PA * PB}" if R > 1
                        else "0")
                return (f"{self.bname(key)}[{slot} + (lA + "
                        f"({ta - ma + oa})) * {PB} + lB + ({tb - mb + ob})]")
            k = self.inputs[e.field]
            if s == 0:
                off, S, (WA, WB) = self.buffer(("win", e.field))
                ha, hb = T * self.hl2[0], T * self.hl2[1]
                return (f"ld(&win{k}[pmod(qs + {c.halo_lo[0] + o0}, {S}) * "
                        f"{WA * WB} + (lA + ({ha - ma + oa})) * {WB} + lB + "
                        f"({hb - mb + ob})])")
            key = ("field", s, e.field)
            off, D, (FA, FB) = self.buffer(key)
            ha, hb = (T - s) * self.hl2[0], (T - s) * self.hl2[1]
            return (f"{self.bname(key)}[pmod(qs + ({o0}), {D}) * {FA * FB}"
                    f" + (lA + ({ha - ma + oa})) * {FB} + lB + "
                    f"({hb - mb + ob})]")

        return resolve

    def _op_group(self, s: int, m2, ops) -> list:
        """One loop evaluating ``ops`` (one level, margin ``m2``) at stage
        ``s``: masks, bfloat16 rounding, shared-memory planes, rings, and
        (outside a chain) the stored output planes of the chunk; the loop
        of the region's outputs also applies a fused update rule."""
        c = self.call
        em = _ExprEmitter(self.scalars, self.bf16,
                          self._resolver(s, m2))
        (ma, _), (mb, _) = m2
        stores = []
        for op in ops:
            code = em._f(em.ev(op.expr, (0, 0, 0)))
            if self.bf16:
                code = f"rnd_bf16({code})"
            m = c.stage_margins[s][op.out]
            zero = c.zero_axes[op.out]
            if zero and c.domain is not None:
                code = f"(({self._domain_mask()}) ? {code} : 0.0f)"
            elif any(m[a].any() for a in zero if a > 0):
                axes = [ax for a, ax in zip(range(1, c.ndim),
                                            "AB"[3 - c.ndim:])
                        if m[a].any() and a in zero]
                code = f"(({self._mask(axes)}) ? {code} : 0.0f)"
            r = f"r{self.op_index[op.out]}"
            stores.append(f"const float {r} = {code};")
            if op.out in self.keep:
                key = ("op", s, op.out)
                off, R, (PA, PB) = self.buffer(key)
                slot = f"pmod(qs, {R}) * {PA * PB}" if R > 1 else "0"
                stores.append(f"{self.bname(key)}[{slot} + lA * {PB} + lB]"
                              f" = {r};")
            if c.update is None and op.out in self.outputs:
                k = self.outputs[op.out]
                NA, NB = self.N
                stores += [
                    f"if (qs >= c0 && lA >= {ma} && lA < {ma} + vA && "
                    f"lB >= {mb} && lB < {mb} + vB)",
                    f"  st(&out{k}[(long long)qs * {NA * NB} + (long long)"
                    f"(bA + lA - {ma}) * {NB} + (bB + lB - {mb})], {r});"]
        if self.fused and set(c.out_names) <= {op.out for op in ops}:
            regs = {op.out: f"r{self.op_index[op.out]}" for op in ops}
            stores += (["{  // the update rule at this point"]
                       + ["  " + x for x in self._update_body(s, regs)]
                       + ["}"])
        return self._loop(m2, em.lines + stores)

    def _update(self, s: int) -> list:
        """The fused loop's update at stage ``s`` in a loop of its own over
        the stage's extent."""
        acc = self.call.T - 1 - s
        m2 = tuple((acc * self.hl2[i], acc * self.hh2[i]) for i in range(2))
        return self._loop(m2, self._update_body(s))

    def _update_body(self, s: int, regs: dict | None = None) -> list:
        """The update at one point of stage ``s``'s extent: into the next
        stage's field rings (zero outside the global domain) or, at the
        last stage, into the stored fields of the chunk.  The region's
        outputs are read from their planes, or from ``regs`` (their values
        at this point, in the loop that computed them)."""
        c = self.call
        T = c.T
        acc = T - 1 - s
        hl2 = self.hl2

        def resolve(e):
            if isinstance(e, Access) and e.field in self.inputs:
                k = self.inputs[e.field]
                if s == 0:
                    off, S, (WA, WB) = self.buffer(("win", e.field))
                    return (f"ld(&win{k}[pmod(qs + {c.halo_lo[0]}, {S}) * "
                            f"{WA * WB} + (lA + {hl2[0]}) * {WB} + lB + "
                            f"{hl2[1]}])")
                key = ("field", s, e.field)
                off, D, (FA, FB) = self.buffer(key)
                return (f"{self.bname(key)}[pmod(qs, {D}) * {FA * FB} + "
                        f"(lA + {hl2[0]}) * {FB} + lB + {hl2[1]}]")
            if isinstance(e, Access) and regs and e.field in c.out_names:
                return regs[e.field]
            if isinstance(e, Access) and e.field in c.out_names:
                key = ("op", s, e.field)
                off, R, (PA, PB) = self.buffer(key)
                base = self.two([int(c.margins[e.field][a, 0])
                                 for a in range(1, c.ndim)], 0)
                slot = f"pmod(qs, {R}) * {PA * PB}" if R > 1 else "0"
                return (f"{self.bname(key)}[{slot} + (lA + {base[0]}) * "
                        f"{PB} + lB + {base[1]}]")
            raise ValueError(f"update rule reads {e!r}, which is neither a "
                             "persistent field nor a region output")

        em = _ExprEmitter(self.scalars, self.bf16, resolve)
        lines = []
        for f in c.group_inputs:
            code = em._f(em.ev(c.update_exprs[f], (0, 0, 0)))
            if self.bf16:
                code = f"rnd_bf16({code})"
            lines.append(f"const float n{self.inputs[f]} = {code};")
        if s == T - 1:
            NA, NB = self.N
            lines.append("if (qs >= c0) {")
            for f in c.group_inputs:
                k = self.outputs[f]
                lines.append(f"  st(&out{k}[(long long)qs * {NA * NB} + "
                             f"(long long)(bA + lA) * {NB} + (bB + lB)], "
                             f"n{self.inputs[f]});")
            lines.append("}")
        else:
            for f in c.group_inputs:
                zero2 = self.two([a in c.zero_axes[f]
                                  for a in range(1, c.ndim)], True)
                axes = [ax for i, ax in enumerate("AB") if zero2[i] and (
                    acc * self.span2[i] or self.N[i] != self.NG[i])]
                ok = self._mask(axes) if axes else "true"
                key = ("field", s + 1, f)
                off, D, (FA, FB) = self.buffer(key)
                lines.append(f"{self.bname(key)}[pmod(qs, {D}) * {FA * FB}"
                             f" + lA * {FB} + lB] = ({ok}) ? "
                             f"n{self.inputs[f]} : 0.0f;")
        return em.lines + lines
