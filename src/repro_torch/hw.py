"""Target-hardware constants (NVIDIA H100 SXM) used by the planner and by
bound calculations.

Sources: NVIDIA's H100 data sheet, the Hopper architecture white paper and
the CUDA C++ programming guide's compute-capability 9.0 table (132 SMs,
228 KB of shared memory an SM holds, 227 KB of it a CTA can opt into, 1 KB
of it reserved per resident CTA, 2048 threads and 32 CTAs resident per SM,
50 MB L2, 80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the
tensor cores).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bandwidth: float        # bytes/s
    hbm_bytes: int              # device memory capacity
    smem_per_block: int         # shared memory one CTA may opt into (bytes)
    smem_per_sm: int            # shared memory of one SM (bytes)
    smem_reserved_per_cta: int  # shared memory the runtime keeps per CTA
    threads_per_sm: int         # resident threads per SM
    ctas_per_sm: int            # resident CTAs per SM
    sms: int                    # streaming multiprocessors
    l2_bytes: int
    peak_f32_flops: float       # FLOP/s, CUDA cores


H100 = ChipSpec(
    name="NVIDIA H100 80GB HBM3",
    hbm_bandwidth=3.35e12,
    hbm_bytes=80 * 1000**3,
    smem_per_block=232_448,
    smem_per_sm=233_472,
    smem_reserved_per_cta=1024,
    threads_per_sm=2048,
    ctas_per_sm=32,
    sms=132,
    l2_bytes=50 * 1024**2,
    peak_f32_flops=67e12,
)

# field storage dtypes the planner and cost models understand
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}
