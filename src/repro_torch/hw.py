"""Target-hardware constants (NVIDIA H100 SXM) used by the planner and by
bound calculations.

Sources: NVIDIA's H100 data sheet, the Hopper architecture white paper and
the CUDA C++ programming guide's compute-capability 9.0 table (132 SMs,
228 KB of shared memory an SM holds, 227 KB of it a CTA can opt into, 1 KB
of it reserved per resident CTA, 2048 threads, 32 CTAs and 65,536 32-bit
registers per SM, 50 MB L2, 80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s float32
outside the tensor cores, 989 TFLOP/s dense bfloat16 on the tensor cores,
at 700 W).

Links between cards, per GPU and per direction: NVLink 4 at 450 GB/s (the
H100 SXM data sheet's 900 GB/s counts both directions), the fabric inside
one DGX H100 node's eight cards; InfiniBand NDR at 50 GB/s (one 400 Gb/s
ConnectX-7 adapter per GPU in a DGX H100), between nodes.
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
    registers_per_sm: int       # 32-bit registers of one SM
    sms: int                    # streaming multiprocessors
    l2_bytes: int
    peak_f32_flops: float       # FLOP/s, CUDA cores
    peak_bf16_flops: float      # FLOP/s, dense bf16 on the tensor cores
    power_watts: float          # board power limit the peaks assume (W)
    nvlink_bandwidth: float     # bytes/s per GPU, one direction, in a node
    network_bandwidth: float    # bytes/s per GPU, one direction, between nodes


H100 = ChipSpec(
    name="NVIDIA H100 80GB HBM3",
    hbm_bandwidth=3.35e12,
    hbm_bytes=80 * 1000**3,
    smem_per_block=232_448,
    smem_per_sm=233_472,
    smem_reserved_per_cta=1024,
    threads_per_sm=2048,
    ctas_per_sm=32,
    registers_per_sm=65_536,
    sms=132,
    l2_bytes=50 * 1024**2,
    peak_f32_flops=67e12,
    peak_bf16_flops=989e12,
    power_watts=700.0,
    nvlink_bandwidth=450e9,
    network_bandwidth=50e9,
)

# field storage dtypes the planner and cost models understand
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}

#: the serving layer's bucket quantum on the contiguous (innermost) axis,
#: in elements: 32 float32 values are one 128-byte line, the unit the card
#: moves between L2 and device memory, and the smallest lane tile the block
#: planner ranks (``schedule.LANE_TILES``), so a bucket's rows hold whole
#: lines and whole warps
BUCKET_LANE = 32


def align_up(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m
