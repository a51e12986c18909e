"""repro_torch.analysis — the H100-priced stencil roofline (the port of
``repro.analysis.stencil_roofline``)."""

from .stencil_roofline import (StencilModel, kernel_traffic, model_plan,
                               model_program, modeled_energy_j,
                               plan_bytes_per_point, roofline_seconds)

__all__ = ["StencilModel", "kernel_traffic", "model_plan", "model_program",
           "modeled_energy_j", "plan_bytes_per_point", "roofline_seconds"]
