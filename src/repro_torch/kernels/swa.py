"""Sliding-window attention kernels for Hopper, written as CUDA C++: one
fixed source per storage type beside this module.

* bfloat16: ``swa_mma.cu``, on the tensor cores (``mma.sync`` m16n8k16,
  ``ldmatrix``, K and V chunks double-buffered by ``cp.async``);
* float32: ``swa.cu``, FMA on the CUDA cores (TF32 or bf16 products would
  not meet the float32 check, and nothing serves float32).

Both replace the TPU kernel ``repro.kernels.swa.swa_pallas`` (the Pallas
call at ``src/repro/kernels/swa.py:92``): causal sliding-window attention
over ``(B, S, H, D)``, query ``i`` attending to keys ``(i - window, i]``,
float32 softmax statistics and sums, the output in ``q``'s dtype.

Bound on the H100: operations.  The band holds ``sum_i min(i+1, w)`` keys a
query row, and each costs ``4 D`` operations (``q.k`` and ``p.v``): for
H2O-Danube's prefill (B 2, S 8192, H 32, D 80, w 4096) 5.2e11, 0.52 ms at
the tensor cores' 989 TFLOP/s, plus about 0.4 ms of ``exp2`` on the SFUs
(1.6e9 band pairs at 16 a clock an SM), against 0.06 ms for the bytes.
The TPU kernel holds a query tile's whole ``window + Bq`` KV slab in VMEM
and takes a tile-local softmax; Danube's slab (4,224 rows x 80 x 2
tensors) does not fit the 227 KB of shared memory a CTA can use.  What the
two sources share:

* one CTA per (64-row query tile, head, batch row); the tile's key range
  is walked in 64-key chunks staged in shared memory, with an online
  softmax (running max and denominator per row) in place of the tile-local
  one; keys outside the band contribute ``exp(-inf) = 0``, as the TPU
  kernel's ``-1e30`` does, since every row sees its own position;
* ``(B, S, H, D)`` is read through its strides (no transpose is copied) and
  query head ``h`` reads KV head ``h // (H / KV)`` (the GQA repeat is not
  materialised).

``swa_mma.cu`` (bf16) answers the operations bound with the tensor cores:
4 warps of 16 query rows, both products by ``mma.sync`` with f32 sums,
the q fragments held in registers (D <= 128), P packed to bf16 in
registers as the second product's A operand, the softmax in registers
(quad shuffles, ``exp2`` with the scale folded into one FFMA), a 2-stage
``cp.async`` ring so that the next chunk loads while this one computes,
and chunks aligned to 64 keys so that only the band's edge chunks test a
mask.  ``swa.cu`` (float32) keeps K and V as float32 in shared memory,
FMA from a 4 x 4 register tile of scores.  ``wgmma`` and TMA are later
work.

Compiled per (dtype, head dim): any D whose shared memory fits a CTA
(:func:`smem_bytes`).  The C entry returns ``cudaGetLastError()`` and
:func:`swa_cuda` raises if it is not 0; there is no fallback from one
source to the other.

:func:`swa_plain` is the plain PyTorch version: ``swa_pallas``'s
arithmetic tile by tile, float32 throughout.  ``launches`` counts the
kernels' launches (plain-version runs excluded).

The backward, for training, gives q's, k's and v's gradients from the
forward's output and its cotangent, through :func:`swa_cuda_backward`
(``backward_launches`` counts its calls), one fixed source per storage
type (their headers say how):

* bfloat16: ``swa_bwd_mma.cu``, on the tensor cores (``mma.sync``), fed by
  the forward's saved log-sum-exp (:func:`swa_cuda_lse`);
* float32: ``swa_bwd.cu``, on the CUDA cores, which recomputes the row
  statistics.

:func:`swa_plain_backward` is the plain version of both, autograd through
:func:`swa_plain`, and :func:`swa_plain_lse` the plain version of the
saved log-sum-exp.  :class:`SlidingWindowAttention` puts the kernels under
autograd.  The TPU kernel has no backward: the JAX model trains through
its jnp ``swa_attention``.
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
#: calls of :func:`swa_cuda_backward` (each launches its source's two
#: kernels)
backward_launches = 0

#: the TPU kernel this module replaces
REPLACES = "src/repro/kernels/swa.py:92"

#: the fixed source of each storage type
SOURCES = {torch.float32: Path(__file__).with_name("swa.cu"),
           torch.bfloat16: Path(__file__).with_name("swa_mma.cu")}

#: the backward's fixed source of each storage type
BACKWARD_SOURCES = {torch.float32: Path(__file__).with_name("swa_bwd.cu"),
                    torch.bfloat16: Path(__file__).with_name(
                        "swa_bwd_mma.cu")}

#: query rows of a CTA's tile and key rows of a chunk (``BQ``, ``BK``)
Q_TILE = KV_CHUNK = 64

_CTYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p])
# swa_bwd.cu: q, k, v, o, dout, dq, dk, dv, m, l, D; swa_bwd_mma.cu: q, k,
# v, o, dout, lse, dq, dk, dv, D
_BWD_ARGTYPES = {
    dt: ([ctypes.c_void_p] * n + [ctypes.c_int] * 4
         + [ctypes.c_longlong] * 15 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p])
    for dt, n in ((torch.float32, 11), (torch.bfloat16, 10))}
_FNS: dict = {}


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in SOURCES:
        raise NotImplementedError(f"the CUDA SWA kernel takes float32 or "
                                  f"bfloat16, not {dtype}")


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Shared memory of one CTA at head dim ``d``: ``swa.cu``'s
    ``SMEM_FLOATS`` (float32 q, K, V and score tiles) or ``swa_mma.cu``'s
    ``SMEM_BYTES`` (bf16 q tile and two K and V stages, rows of D rounded
    up to 16, plus 8)."""
    _check_dtype(dtype)
    bq, bk = Q_TILE, KV_CHUNK
    if dtype == torch.bfloat16:
        return 2 * (bq + 4 * bk) * (-(-d // 16) * 16 + 8)
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1)
                + 11 * bq)


def kernel_source(dtype: torch.dtype, d: int) -> str:
    """The dtype's source specialised to its storage type and head dim."""
    _check_dtype(dtype)
    if smem_bytes(dtype, d) > hw.H100.smem_per_block:
        raise ValueError(f"head dim {d} needs {smem_bytes(dtype, d)} B of "
                         f"shared memory a CTA in {dtype}; the H100 gives "
                         f"{hw.H100.smem_per_block}")
    return (f"#define SWA_T {_CTYPE[dtype]}\n#define SWA_D {d}\n"
            + SOURCES[dtype].read_text())


def _function(dtype: torch.dtype, d: int):
    fn = _FNS.get((dtype, d))
    if fn is None:
        lib = build.load(kernel_source(dtype, d), tag="swa")
        fn = lib.swa_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[(dtype, d)] = fn
    return fn


def backward_smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Shared memory of the backward's larger CTA at head dim ``d``:
    ``swa_bwd_mma.cu``'s ``SMEM_BYTES`` (bf16: six 64-row tiles of rows of
    D rounded up to 16, plus 8, and 256 floats of row statistics) or
    ``swa_bwd.cu``'s ``DQ_SMEM_FLOATS`` (float32 q, dout, K and V tiles of
    rows of D + 1, a 64 x 65 tile, 11 floats a row)."""
    _check_dtype(dtype)
    bq = Q_TILE
    if dtype == torch.bfloat16:
        return 2 * 6 * bq * (-(-d // 16) * 16 + 8) + 4 * 4 * bq
    return 4 * (4 * bq * (d + 1) + bq * (KV_CHUNK + 1) + 11 * bq)


def backward_source(dtype: torch.dtype, d: int) -> str:
    """The dtype's backward source specialised to its storage type and head
    dim."""
    _check_dtype(dtype)
    if backward_smem_bytes(dtype, d) > hw.H100.smem_per_block:
        raise ValueError(f"head dim {d} needs {backward_smem_bytes(dtype, d)}"
                         f" B of shared memory a CTA in the SWA backward in "
                         f"{dtype}; the H100 gives {hw.H100.smem_per_block}")
    return (f"#define SWA_T {_CTYPE[dtype]}\n#define SWA_D {d}\n"
            + BACKWARD_SOURCES[dtype].read_text())


def _backward_function(dtype: torch.dtype, d: int):
    fn = _FNS.get(("backward", dtype, d))
    if fn is None:
        lib = build.load(backward_source(dtype, d), tag="swa_bwd")
        fn = lib.swa_bwd_launch
        fn.argtypes = _BWD_ARGTYPES[dtype]
        fn.restype = ctypes.c_int
        _FNS[("backward", dtype, d)] = fn
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


def _check_cuda(first: torch.Tensor, **named) -> None:
    """Every tensor a CUDA tensor on ``first``'s device, in its dtype, with
    its head dim contiguous."""
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device")
        if t.dtype != first.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q {first.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def _strides(t: torch.Tensor) -> list:
    """The batch, sequence and head strides a kernel reads ``t`` through,
    0 along an axis of extent 1: such a stride is never stepped, and an
    arbitrary one (autograd hands over (1, ...) for a batch of one) would
    fail the sources' 16-byte copy test and stage element by element."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride())]


def _forward(q, k, v, window, with_lse: bool):
    global launches
    _check(q, k, v, window)
    _check_cuda(q, q=q, k=k, v=v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    fn = _function(q.dtype, D)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, B, S, H, KV,
            *_strides(q), *_strides(k), *_strides(v), int(window),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA SWA kernel (D={D}, {q.dtype}) failed to "
                           f"launch: cudaError {rc}")
    launches += 1
    return o, lse


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             window: int) -> torch.Tensor:
    """The kernel on CUDA tensors: q (B,S,H,D), k and v (B,S,KV,D), the
    head dim contiguous.  bfloat16 runs ``swa_mma.cu``, float32
    ``swa.cu``.  Returns a contiguous (B,S,H,D) in q's dtype; stores no
    log-sum-exp (the serving path)."""
    return _forward(q, k, v, window, with_lse=False)[0]


def swa_cuda_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int):
    """:func:`swa_cuda` that also returns each row's log-sum-exp of its
    scaled scores, a contiguous float32 (B,H,S) from the same launch: what
    the bf16 backward reads in place of the row statistics."""
    return _forward(q, k, v, window, with_lse=True)


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


def swa_plain_lse(q: torch.Tensor, k: torch.Tensor, *, window: int,
                  q_block: int = 128) -> torch.Tensor:
    """The plain version of the forward's saved log-sum-exp: float32
    (B,H,S), ``log sum_j exp(scale q_i.k_j)`` over each row's band
    ``(i - w, i]``, a query tile of ``q_block`` rows at a time."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kt = k.float().repeat_interleave(G, dim=2).transpose(1, 2)  # (B,H,S,D)
    qt = q.float().transpose(1, 2)
    w = int(window)
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, q_block):
        q1 = min(q0 + q_block, S)
        k0 = max(0, q0 - w + 1)
        logits = (qt[:, :, q0:q1] @ kt[:, :, k0:q1].transpose(-1, -2)) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        ok = (kpos <= qpos) & (kpos > qpos - w)
        out[:, :, q0:q1] = torch.where(ok, logits, -math.inf).logsumexp(-1)
    return out


def swa_cuda_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, window: int,
                      lse: torch.Tensor | None = None):
    """The gradients (dq, dk, dv) of ``o = swa_cuda(q, k, v)`` for the
    cotangent ``do`` on CUDA tensors, contiguous, in q's dtype; dk and dv
    summed over each KV head's query heads.  o and do are (B,S,H,D); every
    head dim contiguous.  bfloat16 runs ``swa_bwd_mma.cu`` and needs the
    forward's ``lse`` (:func:`swa_cuda_lse`); float32 runs ``swa_bwd.cu``,
    which takes none."""
    global backward_launches
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    _check_cuda(q, q=q, k=k, v=v, o=o, do=do)
    B, S, H, D = q.shape
    KV = k.shape[2]
    mma = q.dtype == torch.bfloat16
    if mma:
        if lse is None or lse.shape != (B, H, S) \
                or lse.dtype != torch.float32 or lse.device != q.device \
                or not lse.is_contiguous():
            raise ValueError("the bf16 backward takes the forward's lse: a "
                             f"contiguous float32 {(B, H, S)} on {q.device}")
    elif lse is not None:
        raise ValueError(f"the {q.dtype} backward recomputes the row "
                         "statistics and takes no lse")
    fn = _backward_function(q.dtype, D)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if q.numel() == 0:
        return dq, dk, dv
    rows = [torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            for _ in range(1 if mma else 3)]
    ptrs = ([lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
            if mma else [dq.data_ptr(), dk.data_ptr(), dv.data_ptr()])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), *ptrs, *(t.data_ptr() for t in rows), B, S, H, KV,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            *_strides(do), int(window),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA SWA backward kernel (D={D}, {q.dtype}) "
                           f"failed to launch: cudaError {rc}")
    backward_launches += 1
    return dq, dk, dv


def swa_plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, *, window: int,
                       q_block: int = 128):
    """The backward's plain version: (dq, dk, dv) by autograd through
    :func:`swa_plain` (float32 throughout, the gradients in q's dtype).
    The kernel also takes the forward's output; this recomputes it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = swa_plain(*leaves, window=window, q_block=q_block)
        return torch.autograd.grad(o, leaves, do)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int) -> torch.Tensor:
    """The kernels on CUDA tensors: :class:`SlidingWindowAttention` where a
    gradient will follow (grad mode on and an input that requires one),
    else :func:`swa_cuda` alone, which stores no log-sum-exp (prefill and
    decode)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return SlidingWindowAttention.apply(q, k, v, window)
    return swa_cuda(q, k, v, window=window)


class SlidingWindowAttention(torch.autograd.Function):
    """The forward kernel under autograd, and ``swa_cuda_backward`` for the
    gradients of q, k and v.  In bfloat16 the forward also stores each
    row's log-sum-exp (:func:`swa_cuda_lse`) and saves it for the
    backward; float32 saves none."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        if q.dtype == torch.bfloat16:
            o, lse = swa_cuda_lse(q, k, v, window=window)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = swa_cuda(q, k, v, window=window)
            ctx.save_for_backward(q, k, v, o)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = swa_cuda_backward(q, k, v, o, do, window=ctx.window,
                                       lse=lse[0] if lse else None)
        return dq, dk, dv, None
