"""The sliding-window attention backward, on the CPU.

* the plain version ``swa_plain_backward`` (autograd through ``swa_plain``)
  against ``jax.grad`` of the reference's dense oracle
  ``repro.kernels.ref.swa_reference`` (KV heads repeated, so their
  gradients sum over each group) and of the reference model's
  ``swa_attention``, with GQA and windows below, at and above S: float32,
  1e-5 of each gradient's max abs (the same sums in another order);
* ``swa_bwd.cu`` run on host threads through the CUDA shim of
  ``tests/test_torch_kernel_emulated.py`` (every CTA's threads as host
  threads, ``__syncthreads`` a barrier, shared memory starting as NaN
  bytes), launched with ``swa_cuda_backward``'s argument marshalling,
  against ``swa_plain_backward``: float32 at 1e-4 of each gradient's max
  abs, bfloat16 at 2e-2 (the kernel's D comes from the forward's output
  rounded to bfloat16, and the gradients are rounded from float32 sums);
* the ``torch.autograd.Function`` wiring, with fake launchers on the CPU:
  forward and backward go through ``swa_cuda`` and ``swa_cuda_backward``,
  once each, and twice forward under ``torch.utils.checkpoint``.
"""

import ctypes

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
from test_torch_swa import _host_library

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


def _emulated_backward(dtype: torch.dtype, d: int):
    """ctypes entry running ``swa_bwd.cu``'s two kernels on host threads,
    one after the other, as ``swa_bwd_launch`` launches them."""
    src = swa.backward_source(dtype, d).split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    lib = _host_library(src + BWD_LAUNCH, SHIM, "swa_bwd")
    assert lib.emu_smem_bytes() == swa.backward_smem_bytes(d)
    fn = lib.emu_launch
    fn.argtypes = swa._BWD_ARGTYPES[:-1]
    fn.restype = ctypes.c_int
    return fn


def run_emulated_backward(q, k, v, o, do, window):
    """The backward launched as ``swa.swa_cuda_backward`` launches it (the
    same argument marshalling and output layout), on CPU tensors."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    dq = torch.full((B, S, H, D), float("nan"), dtype=q.dtype)
    dk = torch.full((B, S, KV, D), float("nan"), dtype=q.dtype)
    dv = torch.full_like(dk, float("nan"))
    m, l, drow = (torch.full((B, H, S), float("nan")) for _ in range(3))
    _emulated_backward(q.dtype, D)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        m.data_ptr(), l.data_ptr(), drow.data_ptr(), B, S, H, KV,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], int(window), 1.0 / np.sqrt(D))
    return dq, dk, dv


# (B, S, H, KV, D, window, dtype): Danube's head dim with GQA 4:1 and
# interior chunks; a head dim that is not a multiple of 16 and a ragged
# last tile; a window >= S over two batch rows; window 2; in bfloat16,
# Danube's shape, a window that does not divide S, and MQA with a ragged
# tile
EMU_CASES = [
    (1, 192, 4, 1, 80, 96, "float32"),
    (1, 160, 2, 2, 24, 40, "float32"),
    (2, 100, 2, 1, 32, 500, "float32"),
    (1, 128, 2, 2, 16, 2, "float32"),
    (1, 192, 4, 1, 80, 96, "bfloat16"),
    (1, 256, 2, 1, 64, 70, "bfloat16"),
    (1, 130, 4, 1, 40, 50, "bfloat16"),
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
    o = swa.swa_plain(q, k, v, window=w, q_block=bq)
    got = run_emulated_backward(q, k, v, o, do, w)
    want = swa.swa_plain_backward(q, k, v, do, window=w, q_block=bq)
    for name, g, wg in zip("qkv", got, want):
        assert g.dtype == wg.dtype and g.shape == wg.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, wg) <= TOL[dtype], (name, _rel(g, wg))


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
    src = swa.backward_source(torch.bfloat16, 80)
    assert src.startswith("#define SWA_T __nv_bfloat16\n#define SWA_D 80\n")
    assert src.endswith(swa.BACKWARD_SOURCE.read_text())
    assert "swa_bwd_dq" in src and "swa_bwd_dkdv" in src
    assert "atomic" not in src.split("#include")[-1]
    # Danube's head dim leaves room for two CTAs an SM
    assert 2 * (swa.backward_smem_bytes(80) + 1024) <= 233_472
    assert swa.backward_smem_bytes(207) <= 232_448 \
        < swa.backward_smem_bytes(208)
    with pytest.raises(ValueError, match="shared memory"):
        swa.backward_source(torch.float32, 256)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        swa.backward_source(torch.float16, 64)


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
    calls = {"forward": 0, "backward": []}

    def forward(q, k, v, *, window):
        calls["forward"] += 1
        return swa.swa_plain(q, k, v, window=window, q_block=64)

    def backward(q, k, v, o, do, *, window):
        calls["backward"].append((o, window))
        return swa.swa_plain_backward(q, k, v, do, window=window,
                                      q_block=64)

    monkeypatch.setattr(swa, "swa_cuda", forward)
    monkeypatch.setattr(swa, "swa_cuda_backward", backward)
    return calls


def test_function_runs_the_forward_and_backward_launchers(fake_launchers):
    q, k, v, do = _inputs(1, 128, 4, 2, 16, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = swa.SlidingWindowAttention.apply(*leaves, 32)
    assert o.grad_fn is not None and fake_launchers["forward"] == 1
    got = torch.autograd.grad(o, leaves, do)
    (saved_o, window), = fake_launchers["backward"]
    assert window == 32 and torch.equal(saved_o, o.detach())
    want = swa.swa_plain_backward(q, k, v, do, window=32, q_block=64)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    # a cotangent whose head dim is not contiguous reaches the launcher
    # contiguous in it
    o = swa.SlidingWindowAttention.apply(*leaves, 32)
    odd = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    torch.autograd.grad(o, leaves, odd)
    assert fake_launchers["forward"] == 2


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
