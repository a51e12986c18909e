# Stencil-HMLS core on PyTorch: stencil IR, halo passes, the block-schedule
# dataflow plan, the pure-torch lowerings and the CUDA kernel orchestrator.
from .frontend import (CoeffHandle, ExprHandle, FieldHandle, ProgramBuilder,
                       absolute, exp, log, maximum, minimum, sign, sqrt,
                       tanh, where)
from .boundary import BOUNDARIES
from .ir import Program
from .pipeline import (CompiledStencil, CompileOptions, TileDemotionWarning,
                       compile_program, run_time_loop)
from .schedule import (DataflowPlan, StreamSpec, TimeLoopSpec, adapt_update,
                       auto_plan, plan_from_dict, plan_time_loop,
                       plan_to_dict, program_fingerprint, smem_cost)
