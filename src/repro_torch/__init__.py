"""repro_torch — the Stencil-HMLS stencil compiler on PyTorch and CUDA.

A port of ``repro`` (JAX / Pallas) to an NVIDIA H100.  The stencil IR,
frontend and halo passes are the same pure-Python modules; the plans are
priced against Hopper's per-CTA shared memory; every fuse group runs as a
CUDA C++ kernel generated from the IR (:mod:`repro_torch.kernels.stencil3d`)
and built with ``nvcc`` for ``sm_90a`` on first use.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU the kernel wrapper runs its plain PyTorch
version.  Nothing here imports JAX or the ``repro`` package.
"""

from .core import (CompiledStencil, CompileOptions, DataflowPlan,
                   TileDemotionWarning, auto_plan, compile_program,
                   run_time_loop)

__all__ = ["CompiledStencil", "CompileOptions", "DataflowPlan",
           "TileDemotionWarning", "auto_plan", "compile_program",
           "run_time_loop"]
