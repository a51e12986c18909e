"""Sliding-window attention kernel for Hopper, written as CUDA C++
(``swa.cu`` beside this module).

Replaces the TPU kernel ``repro.kernels.swa.swa_pallas`` (the Pallas call
at ``src/repro/kernels/swa.py:92``): causal sliding-window attention over
``(B, S, H, D)``, query ``i`` attending to keys ``(i - window, i]``, f32
accumulation, the output in ``q``'s dtype.

Bound on the H100: operations.  The band holds ``sum_i min(i+1, w)`` keys a
query row, and each costs ``4 D`` operations (``q.k`` and ``p.v``): for
H2O-Danube's prefill (B 2, S 8192, H 32, D 80, w 4096) 5.2e11, 0.52 ms at
the tensor cores' 989 TFLOP/s against 0.06 ms for the bytes.  The TPU
kernel holds a query tile's whole ``window + Bq`` KV slab in VMEM and takes
a tile-local softmax; Danube's slab (4,224 rows x 80 x 2 tensors) does not
fit the 227 KB of shared memory a CTA can use.  The design:

* one CTA per (64-row query tile, head, batch row), 256 threads; the q tile
  is staged in shared memory once, and the tile's key range is walked in
  64-row chunks, K and V staged in shared memory as float32;
* an online softmax (running max and denominator per row) in place of the
  tile-local one; keys outside the band contribute ``exp(-inf) = 0``, as
  the TPU kernel's ``-1e30`` does, since every row sees its own position;
* ``(B, S, H, D)`` is read through its strides (no transpose is copied) and
  query head ``h`` reads KV head ``h // (H / KV)`` (the GQA repeat is not
  materialised);
* FMA on the CUDA cores, a 4 x 4 register tile of scores and a 4 x D/16
  tile of the output per thread.  ``wgmma`` and TMA are later work.

Compiled per (dtype, head dim): float32 or bfloat16 storage, any D whose
shared memory fits a CTA (D <= 256).  The C entry returns
``cudaGetLastError()`` and :func:`swa_cuda` raises if it is not 0.

:func:`swa_plain` is the plain PyTorch version: ``swa_pallas``'s
arithmetic tile by tile, float32 throughout.  ``launches`` counts the
kernel's launches (plain-version runs excluded).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import hw
from . import build

#: kernel launches made by :func:`swa_cuda` (plain-version runs excluded)
launches = 0

#: the TPU kernel this module replaces
REPLACES = "src/repro/kernels/swa.py:92"

SOURCE = Path(__file__).with_name("swa.cu")

#: query rows of a CTA's tile and key rows of a chunk (``BQ``, ``BK``)
Q_TILE = KV_CHUNK = 64

_CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p])
_FNS: dict = {}


def smem_bytes(d: int) -> int:
    """Shared memory of one CTA at head dim ``d`` (``SMEM_FLOATS``)."""
    bq, bk = Q_TILE, KV_CHUNK
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1)
                + 11 * bq)


def kernel_source(dtype: torch.dtype, d: int) -> str:
    """``swa.cu`` specialised to a storage type and head dim."""
    if dtype not in _CTYPE:
        raise NotImplementedError(f"the CUDA SWA kernel takes float32 or "
                                  f"bfloat16, not {dtype}")
    if smem_bytes(d) > hw.H100.smem_per_block:
        raise ValueError(f"head dim {d} needs {smem_bytes(d)} B of shared "
                         f"memory a CTA; the H100 gives "
                         f"{hw.H100.smem_per_block}")
    return (f"#define SWA_T {_CTYPE[dtype]}\n#define SWA_D {d}\n"
            + SOURCE.read_text())


def _function(dtype: torch.dtype, d: int):
    fn = _FNS.get((dtype, d))
    if fn is None:
        lib = build.load(kernel_source(dtype, d), tag="swa")
        fn = lib.swa_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[(dtype, d)] = fn
    return fn


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (KV heads must divide H)")
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             window: int) -> torch.Tensor:
    """The kernel on CUDA tensors: q (B,S,H,D), k and v (B,S,KV,D), the
    head dim contiguous.  Returns a contiguous (B,S,H,D) in q's dtype."""
    global launches
    _check(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    B, S, H, D = q.shape
    KV = k.shape[2]
    fn = _function(q.dtype, D)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            KV, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(window), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA SWA kernel (D={D}, {q.dtype}) failed to "
                           f"launch: cudaError {rc}")
    launches += 1
    return o


def swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int, q_block: int = 128) -> torch.Tensor:
    """``swa_pallas``'s arithmetic in PyTorch, float32 throughout: per query
    tile of ``q_block`` rows, the left-zero-padded KV slab of
    ``window + q_block`` rows, masked to ``(i - w, i] ∩ [0, S)`` with
    ``-1e30``, a tile-local softmax, and the weighted sum divided by the
    denominator.  k and v may hold fewer (KV) heads; they are repeated."""
    _check(q, k, v, window)
    B, S, H, D = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    w = int(window)
    bq = min(q_block, S)
    if S % bq:
        raise ValueError(f"S={S} not divisible by q_block={bq}")
    slab = w + bq
    scale = 1.0 / math.sqrt(D)
    qt = q.float().transpose(1, 2)                       # (B,H,S,D)
    kp = F.pad(k.float().transpose(1, 2), (0, 0, w, 0))  # (B,H,w+S,D)
    vp = F.pad(v.float().transpose(1, 2), (0, 0, w, 0))
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(slab, device=q.device)[None, :]
    for i in range(S // bq):
        q0 = i * bq
        logits = (qt[:, :, q0:q0 + bq]
                  @ kp[:, :, q0:q0 + slab].transpose(-1, -2)) * scale
        qpos, kpos = q0 + rows, q0 - w + cols
        ok = (kpos <= qpos) & (kpos > qpos - w) & (kpos >= 0)
        logits = torch.where(ok, logits, -1e30)
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        out[:, :, q0:q0 + bq] = (p @ vp[:, :, q0:q0 + slab]
                                 ) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).to(q.dtype)
