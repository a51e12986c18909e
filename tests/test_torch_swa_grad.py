"""The sliding-window attention backward, on the CPU.

* the plain version ``swa_plain_backward`` (autograd through ``swa_plain``)
  against ``jax.grad`` of the reference's dense oracle
  ``repro.kernels.ref.swa_reference`` (KV heads repeated, so their
  gradients sum over each group) and of the reference model's
  ``swa_attention``, with GQA and windows below, at and above S: float32,
  1e-5 of each gradient's max abs (the same sums in another order);
* both backward sources run on host threads through the CUDA shim of
  ``tests/test_torch_kernel_emulated.py`` (every CTA's threads as host
  threads, ``__syncthreads`` a barrier, shared memory starting as NaN
  bytes), launched with ``swa_cuda_backward``'s argument marshalling,
  against ``swa_plain_backward``: ``swa_bwd.cu`` in float32 at 1e-4 of
  each gradient's max abs and in bfloat16 at 2e-2, and ``swa_bwd_mma.cu``
  (bfloat16, tensor cores) with its six PTX helpers swapped for
  ``test_torch_swa.MMA_SHIM``'s lane-exchange versions, fed the
  log-sum-exp that ``swa_mma.cu`` stores on host threads, at 2e-2 (the
  kernels' D comes from the forward's output rounded to bfloat16, P and dS
  are rounded to bfloat16 for their products, and the gradients are
  rounded from float32 sums);
* the ``torch.autograd.Function`` wiring, with fake launchers on the CPU:
  forward and backward go through the launchers once each (bfloat16 saving
  the forward's lse and handing it to the backward, float32 saving none),
  and twice forward under ``torch.utils.checkpoint``.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels.ref import swa_reference as ref_swa_reference
from repro.models.layers import AttnSpec as RefAttnSpec
from repro.models.layers import swa_attention as ref_swa_attention
from repro_torch.kernels import ops, swa
from repro_torch.models import layers

from test_torch_kernel_emulated import SHIM
from test_torch_swa import (HELPERS, MMA_SHIM, _host_library, _split_helpers,
                            run_emulated)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _inputs(B, S, H, KV, D, seed, dtype="float32"):
    """q, do (B,S,H,D) and k, v (B,S,KV,D) from a numpy seed, rounded to
    ``dtype``."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)]
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                            ).to(getattr(torch, dtype)) for s in shapes]


# (B, S, H, KV, D, window): GQA 2:1 with w below S, MQA with w = S, no
# GQA with w above S, Danube's head dim with GQA 4:1
PLAIN_CASES = [(2, 256, 4, 2, 32, 64), (1, 256, 4, 1, 16, 256),
               (1, 128, 2, 2, 16, 300), (1, 256, 4, 1, 80, 96)]


@pytest.mark.parametrize("B,S,H,KV,D,w", PLAIN_CASES)
def test_plain_backward_matches_jax_grad_of_the_oracle(B, S, H, KV, D, w):
    q, k, v, do = _inputs(B, S, H, KV, D, seed=S + w)
    got = swa.swa_plain_backward(q, k, v, do, window=w)
    G = H // KV

    def f(q_, k_, v_):
        return ref_swa_reference(q_, jnp.repeat(k_, G, 2),
                                 jnp.repeat(v_, G, 2), window=w)
    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    for name, g, wg, t in zip("qkv", got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        assert _rel(g, wg) <= 1e-5, name


@pytest.mark.parametrize("B,S,H,KV,D,w", PLAIN_CASES)
def test_plain_backward_matches_jax_grad_of_the_model_path(B, S, H, KV, D,
                                                           w):
    """The reference model's ``swa_attention`` (what its training
    differentiates) and the port's, under autograd, against the plain
    backward."""
    q, k, v, do = _inputs(B, S, H, KV, D, seed=S + w + 1)
    spec = dict(n_heads=H, n_kv_heads=KV, d_head=D, window=w, chunk=256)
    _, vjp = jax.vjp(
        lambda *a: ref_swa_attention(*a, RefAttnSpec(**spec)),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    got = swa.swa_plain_backward(q, k, v, do, window=w)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    model = torch.autograd.grad(
        layers.swa_attention(*leaves, layers.AttnSpec(**spec)), leaves, do)
    for name, g, m, wg in zip("qkv", got, model, want):
        assert _rel(g, wg) <= 1e-5, name
        assert _rel(m, wg) <= 1e-5, name


# --------------------------------------------------------------------------
# swa_bwd.cu on the host
# --------------------------------------------------------------------------

_EMU_ARGS = """const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* m, void* l,
    void* d, int B, int S, int H, int KV, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss,
    long long gsh, int window, float scale"""
BWD_LAUNCH = r"""
template <class F> void emu_grid(int gx, int gy, int gz, int smem, F body) {
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::vector<unsigned char> sm(smem, 0xff);
        std::barrier<> bar(NT);
        std::vector<std::thread> ts;
        for (int t = 0; t < NT; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t); blockIdx = dim3(x, y, z);
            blockDim = dim3(NT); emu_bar = &bar; emu_smem = sm.data();
            body();
          });
        for (auto& th : ts) th.join();
      }
}
extern "C" int emu_launch(ARGS) {
  const int G = H / KV;
  emu_grid((S + BQ - 1) / BQ, H, B, DQ_SMEM_FLOATS * sizeof(float), [&] {
    swa_bwd_dq((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
               (const SWA_T*)o, (const SWA_T*)dout, (SWA_T*)dq, (float*)m,
               (float*)l, (float*)d, S, H, G, qsb, qss, qsh, ksb, kss, ksh,
               vsb, vss, vsh, osb, oss, osh, gsb, gss, gsh, window, scale);
  });
  emu_grid((S + BK - 1) / BK, KV, B, DKDV_SMEM_FLOATS * sizeof(float), [&] {
    swa_bwd_dkdv((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
                 (const SWA_T*)dout, (const float*)m, (const float*)l,
                 (const float*)d, (SWA_T*)dk, (SWA_T*)dv, S, H, G, qsb, qss,
                 qsh, ksb, kss, ksh, vsb, vss, vsh, gsb, gss, gsh, window,
                 scale);
  });
  return 0;
}
extern "C" int emu_smem_bytes() { return DQ_SMEM_FLOATS * sizeof(float); }
""".replace("ARGS", _EMU_ARGS)


_MMA_EMU_ARGS = """const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* dq, void* dk,
    void* dv, void* d, int B, int S, int H, int KV, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long gsb,
    long long gss, long long gsh, int window, float scale"""
# swa_bwd_mma.cu's two kernels, each CTA's warps with their exchange
# buffers (test_torch_swa.MMA_SHIM), one CTA at a time
MMA_BWD_LAUNCH = r"""
template <class F> void emu_grid(int gx, int gy, int gz, F body) {
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::vector<unsigned char> sm(SMEM_BYTES, 0xff);
        std::barrier<> bar(NT);
        std::unique_ptr<emu_warp_t[]> warps(new emu_warp_t[NW]);
        std::vector<std::thread> ts;
        for (int t = 0; t < NT; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t); blockIdx = dim3(x, y, z);
            blockDim = dim3(NT); gridDim = dim3(gx, gy, gz);
            emu_bar = &bar; emu_smem = sm.data(); emu_warp = &warps[t / 32];
            body();
          });
        for (auto& th : ts) th.join();
      }
}
extern "C" int emu_launch(ARGS) {
  const int G = H / KV;
  const int vec = swa_bwd_vec(q, k, v, dout, qsb, qss, qsh, ksb, kss, ksh,
                              vsb, vss, vsh, gsb, gss, gsh);
  emu_grid((S + BQ - 1) / BQ, H, B, [&] {
    swa_bwd_mma_dq((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
                   (const SWA_T*)o, (const SWA_T*)dout, (const float*)lse,
                   (SWA_T*)dq, (float*)d, S, H, G, qsb, qss, qsh, ksb, kss,
                   ksh, vsb, vss, vsh, osb, oss, osh, gsb, gss, gsh, window,
                   scale, vec);
  });
  emu_grid((S + BK - 1) / BK, KV, B, [&] {
    swa_bwd_mma_dkdv((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
                     (const SWA_T*)dout, (const float*)lse, (const float*)d,
                     (SWA_T*)dk, (SWA_T*)dv, S, H, G, qsb, qss, qsh, ksb,
                     kss, ksh, vsb, vss, vsh, gsb, gss, gsh, window, scale,
                     vec);
  });
  return 0;
}
extern "C" int emu_smem_bytes() { return SMEM_BYTES; }
""".replace("ARGS", _MMA_EMU_ARGS)


def _emulated_backward(dtype: torch.dtype, d: int):
    """ctypes entry running the dtype's backward source on host threads,
    its two kernels one after the other as ``swa_bwd_launch`` launches
    them: ``swa_bwd.cu`` for float32; ``swa_bwd_mma.cu`` for bfloat16, its
    PTX helpers block taken out and ``MMA_SHIM``'s host versions in its
    place."""
    src = swa.backward_source(dtype, d)
    mma = dtype == torch.bfloat16
    if mma:
        head, _, tail = _split_helpers(src)
        src = head + tail
    src = src.split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    lib = _host_library(src + (MMA_BWD_LAUNCH if mma else BWD_LAUNCH),
                        SHIM + (MMA_SHIM if mma else ""), "swa_bwd")
    assert lib.emu_smem_bytes() == swa.backward_smem_bytes(dtype, d)
    fn = lib.emu_launch
    fn.argtypes = swa._BWD_ARGTYPES[dtype][:-1]
    fn.restype = ctypes.c_int
    return fn


def run_emulated_backward(q, k, v, o, do, window, lse=None):
    """The backward launched as ``swa.swa_cuda_backward`` launches it (the
    same argument marshalling and output layout), on CPU tensors; bfloat16
    takes the forward's ``lse``."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    dq = torch.full((B, S, H, D), float("nan"), dtype=q.dtype)
    dk = torch.full((B, S, KV, D), float("nan"), dtype=q.dtype)
    dv = torch.full_like(dk, float("nan"))
    if q.dtype == torch.bfloat16:
        rows = [torch.full((B, H, S), float("nan"))]
        ptrs = [lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    else:
        rows = [torch.full((B, H, S), float("nan")) for _ in range(3)]
        ptrs = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    _emulated_backward(q.dtype, D)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), *ptrs, *(t.data_ptr() for t in rows), B, S, H, KV,
        *(st for t in (q, k, v, o, do) for st in swa._strides(t)),
        int(window), 1.0 / np.sqrt(D))
    return dq, dk, dv


# (B, S, H, KV, D, window, dtype): float32 runs ``swa_bwd.cu``: Danube's
# head dim with GQA 4:1 and interior chunks; a head dim that is not a
# multiple of 16 and a ragged last tile; a window >= S over two batch rows;
# window 2.  bfloat16 runs ``swa_bwd_mma.cu``: Danube's shape; a window
# that does not divide S; MQA with a ragged tile at D 40 (not a multiple
# of 16); window 1; a window >= S over two batch rows; D 20 (staged element
# by element); D 128 (q's and dout's fragments re-read from shared memory);
# a window of 200 with lower-edge and interior chunks in both kernels; the
# trained families' groups with ragged last tiles: hymba's 5 query heads a
# KV head at D 64, mixtral's 4 at D 128 (the dk/dv kernel at the register
# cap)
EMU_CASES = [
    (1, 192, 4, 1, 80, 96, "float32"),
    (1, 160, 2, 2, 24, 40, "float32"),
    (2, 100, 2, 1, 32, 500, "float32"),
    (1, 128, 2, 2, 16, 2, "float32"),
    (1, 192, 4, 1, 80, 96, "bfloat16"),
    (1, 256, 2, 1, 64, 70, "bfloat16"),
    (1, 130, 4, 1, 40, 50, "bfloat16"),
    (1, 128, 2, 2, 16, 1, "bfloat16"),
    (2, 100, 2, 1, 32, 500, "bfloat16"),
    (1, 96, 2, 1, 20, 50, "bfloat16"),
    (1, 128, 2, 1, 128, 80, "bfloat16"),
    (1, 384, 2, 1, 64, 200, "bfloat16"),
    (1, 136, 5, 1, 64, 60, "bfloat16"),
    (1, 136, 4, 1, 128, 60, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,KV,D,w,dtype", EMU_CASES)
def test_backward_kernel_matches_plain_version_on_the_host(B, S, H, KV, D,
                                                           w, dtype):
    """q and do are read through strides that are not contiguous (a
    (B,H,S,D) buffer seen as (B,S,H,D)); o is the forward's output."""
    q, k, v, do = _inputs(B, S, H, KV, D, seed=D + w, dtype=dtype)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    do = do.transpose(1, 2).contiguous().transpose(1, 2)
    bq = 64 if S % 64 == 0 else S
    if dtype == "bfloat16":
        # the forward's output and lse as swa_mma.cu stores them
        o, lse = run_emulated(q, k, v, w, with_lse=True)
        got = run_emulated_backward(q, k, v, o, do, w, lse)
    else:
        o = swa.swa_plain(q, k, v, window=w, q_block=bq)
        got = run_emulated_backward(q, k, v, o, do, w)
    want = swa.swa_plain_backward(q, k, v, do, window=w, q_block=bq)
    for name, g, wg in zip("qkv", got, want):
        assert g.dtype == wg.dtype and g.shape == wg.shape, name
        assert torch.isfinite(g.float()).all(), name
        # at window 1, dq and dk are 0: held against dv's scale
        ref = wg if w > 1 else want[2]
        err = float((g.float() - wg.float()).abs().max()
                    / ref.float().abs().max())
        assert err <= TOL[dtype], (name, err)


def test_backward_kernel_at_window_one():
    """Each row sees only itself: P = 1, so dv = do (summed over the
    group) and dq = dk = 0 up to the rounding of dout.v - D, against the
    gradients' own scale, max |dv|."""
    q, k, v, do = _inputs(1, 128, 4, 2, 16, seed=9)
    o = swa.swa_plain(q, k, v, window=1, q_block=64)
    dq, dk, dv = run_emulated_backward(q, k, v, o, do, 1)
    want = do.reshape(1, 128, 2, 2, 16).sum(3)
    assert _rel(dv, want) <= 1e-6
    scale = float(want.abs().max())
    assert float(dq.abs().max()) <= 1e-5 * scale
    assert float(dk.abs().max()) <= 1e-5 * scale


def test_backward_source_is_specialised_and_fits_a_cta():
    """Each dtype has its backward source (bfloat16 ``swa_bwd_mma.cu``,
    float32 ``swa_bwd.cu``) with the storage type and head dim defined
    ahead, two kernels and no atomics, and its own shared memory against
    the 232,448 B a CTA can use."""
    for dt, name, kernels in (
            (torch.bfloat16, "__nv_bfloat16", ("swa_bwd_mma_dq",
                                               "swa_bwd_mma_dkdv")),
            (torch.float32, "float", ("swa_bwd_dq", "swa_bwd_dkdv"))):
        src = swa.backward_source(dt, 80)
        assert src.startswith(f"#define SWA_T {name}\n#define SWA_D 80\n")
        assert src.endswith(swa.BACKWARD_SOURCES[dt].read_text())
        assert all(f"void __launch_bounds__(NT) {k}(" in src
                   for k in kernels)
        assert "atomic" not in src.split("#include")[-1]
    assert "mma.sync" in swa.backward_source(torch.bfloat16, 80)
    assert "mma.sync" not in swa.backward_source(torch.float32, 80)
    # bf16: six 64-row tiles of D rounded up to 16, plus 8, and 256 floats;
    # Danube's head dim leaves room for three CTAs an SM
    assert swa.backward_smem_bytes(torch.bfloat16, 80) == 384 * 88 * 2 + 1024
    assert 3 * (swa.backward_smem_bytes(torch.bfloat16, 80) + 1024) \
        <= 233_472
    assert swa.backward_smem_bytes(torch.bfloat16, 288) <= 232_448 \
        < swa.backward_smem_bytes(torch.bfloat16, 289)
    # float32: two CTAs an SM at Danube's head dim
    assert 2 * (swa.backward_smem_bytes(torch.float32, 80) + 1024) \
        <= 233_472
    assert swa.backward_smem_bytes(torch.float32, 207) <= 232_448 \
        < swa.backward_smem_bytes(torch.float32, 208)
    with pytest.raises(ValueError, match="shared memory"):
        swa.backward_source(torch.float32, 256)
    with pytest.raises(ValueError, match="shared memory"):
        swa.backward_source(torch.bfloat16, 304)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        swa.backward_source(torch.float16, 64)


def test_mma_backward_source_keeps_its_assembly_in_six_helpers():
    """All inline PTX of ``swa_bwd_mma.cu`` sits in the same six helpers as
    ``swa_mma.cu``'s, between the same markers, so the host emulation
    swaps them for ``MMA_SHIM``'s and runs the rest unchanged."""
    head, helpers, tail = _split_helpers(swa.backward_source(torch.bfloat16,
                                                             80))
    assert sorted(re.findall(r"void (\w+)\(", helpers)) == sorted(HELPERS)
    assert "asm" in helpers and "asm" not in head + tail
    _, fwd_helpers, _ = _split_helpers(swa.kernel_source(torch.bfloat16, 80))
    assert helpers == fwd_helpers


def test_backward_launcher_takes_only_cuda_tensors():
    """No fallback: the launcher raises on CPU tensors."""
    q, k, v, do = _inputs(1, 64, 2, 1, 16, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa.swa_cuda_backward(q, k, v, q, do, window=8)
    with pytest.raises(ValueError, match="shape"):
        swa.swa_cuda_backward(q, k, v, q[:, :32], do, window=8)


# --------------------------------------------------------------------------
# the autograd.Function
# --------------------------------------------------------------------------

@pytest.fixture
def fake_launchers(monkeypatch):
    """``swa_cuda`` and ``swa_cuda_backward`` replaced by their plain
    versions on CPU tensors, counting calls and what they were given."""
    calls = {"forward": 0, "forward_lse": 0, "backward": []}

    def forward(q, k, v, *, window):
        calls["forward"] += 1
        return swa.swa_plain(q, k, v, window=window, q_block=64)

    def forward_lse(q, k, v, *, window):
        calls["forward_lse"] += 1
        return (swa.swa_plain(q, k, v, window=window, q_block=64),
                swa.swa_plain_lse(q, k, window=window))

    def backward(q, k, v, o, do, *, window, lse=None):
        calls["backward"].append((o, window, lse))
        return swa.swa_plain_backward(q, k, v, do, window=window,
                                      q_block=64)

    monkeypatch.setattr(swa, "swa_cuda", forward)
    monkeypatch.setattr(swa, "swa_cuda_lse", forward_lse)
    monkeypatch.setattr(swa, "swa_cuda_backward", backward)
    return calls


def test_function_runs_the_forward_and_backward_launchers(fake_launchers):
    q, k, v, do = _inputs(1, 128, 4, 2, 16, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = swa.SlidingWindowAttention.apply(*leaves, 32)
    assert o.grad_fn is not None and fake_launchers["forward"] == 1
    got = torch.autograd.grad(o, leaves, do)
    (saved_o, window, lse), = fake_launchers["backward"]
    assert window == 32 and torch.equal(saved_o, o.detach())
    # float32 saves no log-sum-exp: swa_bwd.cu recomputes the statistics
    assert lse is None and fake_launchers["forward_lse"] == 0
    want = swa.swa_plain_backward(q, k, v, do, window=32, q_block=64)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    # a cotangent whose head dim is not contiguous reaches the launcher
    # contiguous in it
    o = swa.SlidingWindowAttention.apply(*leaves, 32)
    odd = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    torch.autograd.grad(o, leaves, odd)
    assert fake_launchers["forward"] == 2


def test_function_in_bf16_saves_lse_for_the_mma_backward(fake_launchers):
    """bfloat16: the forward launches the kernel that stores the lse
    (``swa_cuda_lse``), saves it, and hands it to the backward launcher,
    which runs ``swa_bwd_mma.cu``."""
    q, k, v, do = _inputs(1, 128, 4, 2, 16, seed=7, dtype="bfloat16")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = swa.SlidingWindowAttention.apply(*leaves, 32)
    assert fake_launchers["forward_lse"] == 1
    assert fake_launchers["forward"] == 0
    got = torch.autograd.grad(o, leaves, do)
    (saved_o, window, lse), = fake_launchers["backward"]
    assert window == 32 and torch.equal(saved_o, o.detach())
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 128)
    torch.testing.assert_close(lse, swa.swa_plain_lse(q, k, window=32))
    want = swa.swa_plain_backward(q, k, v, do, window=32, q_block=64)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)

    # the kernels' entry: under autograd only where a gradient will follow;
    # else (the serving path) the forward alone, storing no lse
    o = swa.attention(*leaves, window=32)
    assert o.grad_fn is not None and fake_launchers["forward_lse"] == 2
    with torch.no_grad():
        assert swa.attention(*leaves, window=32).grad_fn is None
    assert swa.attention(q, k, v, window=32).grad_fn is None
    assert fake_launchers["forward"] == 2
    assert fake_launchers["forward_lse"] == 2


class _FakeLib:
    """A built library whose C entries record their arguments."""

    def __init__(self, source):
        self.source, self.calls = source, []
        lib = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append(args)
                return 0

        self.swa_launch = self.swa_bwd_launch = Entry()


@pytest.fixture
def fake_builds(monkeypatch):
    """``build.load`` returning :class:`_FakeLib`s, CPU tensors let through
    as if on the card, and a fake current stream."""
    libs = []

    def load(source, tag="stencil"):
        libs.append((tag, _FakeLib(source)))
        return libs[-1][1]

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(swa, "_FNS", {})
    monkeypatch.setattr(swa.build, "load", load)
    monkeypatch.setattr(swa, "_check_cuda", lambda first, **named: None)
    monkeypatch.setattr(swa.torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return libs


def test_launchers_run_each_dtypes_source(fake_builds):
    """The launchers' dispatch, on fake libraries: ``swa_cuda_lse`` hands
    the forward an lse pointer and ``swa_cuda`` a null one; the bf16
    backward loads ``swa_bwd_mma.cu`` and passes the lse, the float32 one
    loads ``swa_bwd.cu`` with its three row-statistics buffers; bf16
    without the lse, or float32 with one, raises."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = _inputs(1, 64, 4, 2, 16, seed=1, dtype=str(dt)[6:])
        # a batch of one with the batch stride autograd hands over (1)
        do = torch.empty_strided(do.shape, (1,) + do.stride()[1:],
                                 dtype=do.dtype).copy_(do)
        before = (swa.launches, swa.backward_launches)
        o, lse = swa.swa_cuda_lse(q, k, v, window=8)
        swa.swa_cuda(q, k, v, window=8)
        (tag, fwd), = fake_builds
        assert tag == "swa" and fwd.source == swa.kernel_source(dt, 16)
        assert lse.shape == (1, 4, 64) and lse.dtype == torch.float32
        assert fwd.calls[0][4] == lse.data_ptr() and fwd.calls[1][4] is None
        if dt == torch.bfloat16:
            with pytest.raises(ValueError, match="lse"):
                swa.swa_cuda_backward(q, k, v, o, do, window=8)
            dq, dk, dv = swa.swa_cuda_backward(q, k, v, o, do, window=8,
                                               lse=lse)
        else:
            with pytest.raises(ValueError, match="no lse"):
                swa.swa_cuda_backward(q, k, v, o, do, window=8, lse=lse)
            dq, dk, dv = swa.swa_cuda_backward(q, k, v, o, do, window=8)
        (tag, bwd) = fake_builds[1]
        assert tag == "swa_bwd" and bwd.source == swa.backward_source(dt, 16)
        assert bwd.source.endswith(swa.BACKWARD_SOURCES[dt].read_text())
        (args,) = bwd.calls
        n_ptrs = 10 if dt == torch.bfloat16 else 11
        assert len(args) == len(swa._BWD_ARGTYPES[dt]) and \
            args[n_ptrs:n_ptrs + 4] == (1, 64, 4, 2)
        # each tensor's (batch, sequence, head) strides, the batch's 0: a
        # stride along an axis of one is never stepped, and 1 would fail
        # the 16-byte copy test
        assert args[n_ptrs + 4:n_ptrs + 19] == (0, 64, 16, 0, 32, 16,
                                                0, 32, 16, 0, 64, 16,
                                                0, 64, 16)
        assert fwd.calls[0][9:18] == (0, 64, 16, 0, 32, 16, 0, 32, 16)
        assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(),
                            lse.data_ptr() if dt == torch.bfloat16
                            else dq.data_ptr())
        assert (swa.launches, swa.backward_launches) == (before[0] + 2,
                                                         before[1] + 1)
        fake_builds.clear()


def test_function_under_remat_runs_the_forward_twice(fake_launchers):
    """As ``lm_forward(remat=True)`` runs a block: the forward kernel again
    inside the backward, then the backward kernel once."""
    q, k, v, do = _inputs(1, 128, 4, 2, 16, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = checkpoint(lambda a, b, c: swa.SlidingWindowAttention.apply(
        a * 1.0, b, c, 16), *leaves, use_reentrant=False)
    torch.autograd.grad(o, leaves, do)
    assert fake_launchers["forward"] == 2
    assert len(fake_launchers["backward"]) == 1
    # in bfloat16 both forward runs store the lse, and the backward gets
    # the recomputed one
    leaves = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    o = checkpoint(lambda a, b, c: swa.SlidingWindowAttention.apply(
        a * 1.0, b, c, 16), *leaves, use_reentrant=False)
    torch.autograd.grad(o, leaves, do.to(torch.bfloat16))
    assert fake_launchers["forward_lse"] == 2
    assert fake_launchers["forward"] == 2
    assert len(fake_launchers["backward"]) == 2
    _, _, lse = fake_launchers["backward"][1]
    torch.testing.assert_close(lse, swa.swa_plain_lse(leaves[0], leaves[1],
                                                      window=16))


def test_model_routes_cpu_tensors_to_the_torch_path(fake_launchers):
    """On the CPU, ``attend`` takes the torch ``swa_attention`` (autograd
    differentiates it, as XLA does the reference's); the launchers stay
    untouched."""
    q, k, v, _ = _inputs(1, 128, 4, 2, 16, seed=6)
    spec = layers.AttnSpec(n_heads=4, n_kv_heads=2, d_head=16, window=32,
                           chunk=256)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = layers.attend(*leaves, spec)
    out.sum().backward()
    assert fake_launchers["forward"] == 0 and not fake_launchers["backward"]
    assert all(t.grad is not None and t.grad.abs().max() > 0
               for t in leaves)
    torch.testing.assert_close(ops.sliding_window_attention(q, k, v,
                                                            window=32),
                               layers.swa_attention(q, k, v, spec))
