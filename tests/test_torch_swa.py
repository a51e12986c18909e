"""The port's sliding-window attention against the JAX package, on the CPU.

* the plain version ``swa_plain`` against the reference's Pallas kernel
  (``repro.kernels.ops.sliding_window_attention``, interpret mode) and its
  dense oracle ``swa_reference``, at ``tests/test_kernels.py``'s shapes plus
  D = 80 and a window >= S;
* the port's ``layers.swa_attention`` and ``ops.sliding_window_attention``
  against the reference's ``layers.swa_attention``;
* the CUDA source ``kernels/swa.cu`` run through the host C++ compiler with
  the CUDA shim of ``test_torch_kernel_emulated.py``, against ``swa_plain``.

Inputs are made from a numpy seed and handed to both packages.  Every
tolerance is relative to the compared tensor's own max abs: 2e-5 in
float32 (sums in another order), 2e-2 in bfloat16 (a few ulps of the
rounded output).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import sliding_window_attention as ref_swa_op
from repro.kernels.ref import swa_reference as ref_swa_reference
from repro.models.layers import AttnSpec as RefAttnSpec
from repro.models.layers import swa_attention as ref_swa_attention
from repro_torch.kernels import ops, swa
from repro_torch.kernels.ref import swa_reference
from repro_torch.models.layers import AttnSpec, swa_attention

from test_torch_kernel_emulated import SHIM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _qkv(B, S, H, KV, D, seed, dtype="float32"):
    """numpy float32 q (B,S,H,D), k and v (B,S,KV,D), rounded to ``dtype``
    (so both packages start from the same values), and torch twins."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, KV, KV)]
    tdt = getattr(torch, dtype)
    ts = [torch.as_tensor(a).to(tdt) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


# (B, S, H, KV, D, window, q_block): test_kernels.py's grid and GQA case,
# Danube's head dim, and a window that covers the whole sequence
CASES = [
    (2, 256, 4, 4, 64, 64, 128),
    (2, 256, 4, 4, 64, 128, 64),
    (2, 512, 4, 4, 64, 256, 128),
    (2, 128, 4, 4, 64, 32, 128),
    (2, 256, 8, 2, 64, 64, 128),
    (1, 256, 4, 2, 80, 96, 128),
    (1, 128, 4, 4, 64, 512, 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,w,bq", CASES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, KV, D, w, bq, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=S + w + D, dtype=dtype)
    got = swa.swa_plain(tq, tk, tv, window=w, q_block=bq)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    pallas = ref_swa_op(jq, jk, jv, window=w, q_block=bq)
    assert _rel(got.float(), pallas.astype(jnp.float32)) <= TOL[dtype]
    G = H // KV
    oracle = ref_swa_reference(jq, jnp.repeat(jk, G, 2), jnp.repeat(jv, G, 2),
                               window=w)
    assert _rel(got.float(), oracle.astype(jnp.float32)) <= TOL[dtype]
    # the port's oracle is the reference's
    mine = swa_reference(tq, tk.repeat_interleave(G, 2),
                         tv.repeat_interleave(G, 2), window=w)
    assert _rel(mine.float(), oracle.astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("H,KV,D,w", [(4, 4, 64, 64), (8, 2, 80, 100)])
def test_model_swa_path_matches_reference(H, KV, D, w):
    """The port's ``swa_attention`` against the reference's, and the
    kernel's wrapper (its plain version on the CPU) against it, as
    ``test_kernels.py::test_swa_matches_model_layer_path`` holds the
    Pallas kernel (float32)."""
    B, S = 2, 256
    (q, k, v), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=3)
    want = ref_swa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        RefAttnSpec(n_heads=H, n_kv_heads=KV, d_head=D, window=w, chunk=256))
    spec = AttnSpec(n_heads=H, n_kv_heads=KV, d_head=D, window=w, chunk=256)
    assert _rel(swa_attention(tq, tk, tv, spec), want) <= 2e-5
    assert _rel(ops.sliding_window_attention(tq, tk, tv, window=w),
                want) <= 2e-5


def test_plain_version_rejects_what_swa_pallas_rejects():
    _, (tq, tk, tv) = _qkv(1, 96, 2, 2, 16, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        swa.swa_plain(tq, tk, tv, window=8, q_block=64)
    with pytest.raises(ValueError, match="KV heads must divide"):
        swa.swa_plain(tq, tk[:, :, :1].repeat(1, 1, 3, 1),
                      tv[:, :, :1].repeat(1, 1, 3, 1), window=8)
    with pytest.raises(ValueError, match="window"):
        swa.swa_plain(tq, tk, tv, window=0)


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The launcher raises on CPU tensors (no fallback); its dispatcher
    sends them to the plain version."""
    _, (tq, tk, tv) = _qkv(1, 64, 2, 2, 16, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa.swa_cuda(tq, tk, tv, window=8)
    torch.testing.assert_close(ops.sliding_window_attention(tq, tk, tv,
                                                            window=8),
                               swa.swa_plain(tq, tk, tv, window=8))


def test_kernel_source_is_specialised_per_dtype_and_head_dim():
    src = swa.kernel_source(torch.bfloat16, 80)
    assert src.startswith("#define SWA_T __nv_bfloat16\n#define SWA_D 80\n")
    assert swa.smem_bytes(256) <= 232_448 < swa.smem_bytes(288)
    with pytest.raises(ValueError, match="shared memory"):
        swa.kernel_source(torch.float32, 288)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        swa.kernel_source(torch.float64, 64)


# --------------------------------------------------------------------------
# the CUDA source on the host
# --------------------------------------------------------------------------

def _emulated(dtype: torch.dtype, d: int):
    """ctypes entry running ``swa.cu``'s kernel on host threads: every CTA's
    256 threads as host threads, ``__syncthreads`` a barrier."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel source")
    src = swa.kernel_source(dtype, d).split('extern "C"')[0]
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    src += r"""
extern "C" int emu_launch(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int KV,
                          long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          int window, float scale) {
  const int smem = SMEM_FLOATS * sizeof(float);
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int t = 0; t < (S + BQ - 1) / BQ; ++t) {
        std::vector<unsigned char> sm(smem);
        std::barrier<> bar(NT);
        std::vector<std::thread> ts;
        for (int x = 0; x < NT; ++x)
          ts.emplace_back([&, x] {
            threadIdx = dim3(x); blockIdx = dim3(t, h, b);
            blockDim = dim3(NT); emu_bar = &bar; emu_smem = sm.data();
            swa_kernel((const SWA_T*)q, (const SWA_T*)k, (const SWA_T*)v,
                       (SWA_T*)o, S, H, H / KV, qsb, qss, qsh, ksb, kss, ksh,
                       vsb, vss, vsh, window, scale);
          });
        for (auto& th : ts) th.join();
      }
  return 0;
}
extern "C" int emu_smem_bytes() { return SMEM_FLOATS * sizeof(float); }
"""
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    d_ = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "repro_torch_emu")
    os.makedirs(os.path.join(d_, "inc"), exist_ok=True)
    for h in ("cuda_runtime.h", "cuda_bf16.h"):
        open(os.path.join(d_, "inc", h), "w").close()
    shim = os.path.join(d_, f"shim_{os.getpid()}.h")
    with open(shim, "w") as fh:
        fh.write(SHIM)
    so = os.path.join(d_, f"swa_{tag}.so")
    if not os.path.exists(so):
        cc = os.path.join(d_, f"swa_{tag}.{os.getpid()}.cc")
        with open(cc, "w") as fh:
            fh.write(src)
        tmp = so + f".{os.getpid()}"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-include", shim, "-I",
                        os.path.join(d_, "inc"), "-o", tmp, cc], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    # the launcher's shared-memory check and the kernel agree on the size
    assert lib.emu_smem_bytes() == swa.smem_bytes(d)
    fn = lib.emu_launch
    fn.argtypes = swa._ARGTYPES[:-1]
    fn.restype = ctypes.c_int
    return fn


def run_emulated(q, k, v, window):
    """The kernel launched as ``swa.swa_cuda`` launches it (same argument
    marshalling), on CPU tensors, through the emulated entry."""
    B, S, H, D = q.shape
    o = torch.full((B, S, H, D), float("nan"), dtype=q.dtype)
    _emulated(q.dtype, D)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, S, H, k.shape[2], *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], int(window),
                          1.0 / np.sqrt(D))
    return o


# (B, S, H, KV, D, window): Danube's GQA and head dim, a head dim that is
# not a multiple of 16, a ragged last tile, a window >= S, window 1, and a
# window that is not a multiple of the 64-key chunk
EMU_CASES = [
    (1, 192, 4, 1, 80, 96, "float32"),
    (1, 160, 2, 2, 24, 40, "float32"),
    (2, 100, 2, 1, 32, 500, "float32"),
    (1, 128, 2, 2, 16, 1, "float32"),
    (1, 192, 2, 1, 64, 70, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,KV,D,w,dtype", EMU_CASES)
def test_kernel_source_matches_plain_version_on_the_host(B, S, H, KV, D, w,
                                                         dtype):
    """``swa.cu`` against ``swa_plain`` (f32: 2e-5 relative; bf16: 2e-2,
    both outputs rounded from float32 sums in different orders).  q is read
    through strides that are not contiguous: a (B,H,S,D) buffer seen as
    (B,S,H,D), as a transpose would give it."""
    (_, _, _), (tq, tk, tv) = _qkv(B, S, H, KV, D, seed=D + w, dtype=dtype)
    tq = tq.transpose(1, 2).contiguous().transpose(1, 2)
    got = run_emulated(tq, tk, tv, w)
    bq = 64 if S % 64 == 0 else S
    want = swa.swa_plain(tq, tk, tv, window=w, q_block=bq)
    assert torch.isfinite(got.float()).all()
    assert _rel(got.float(), want.float()) <= TOL[dtype]
