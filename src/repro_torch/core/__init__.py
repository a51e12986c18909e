# Stencil-HMLS core on PyTorch: stencil IR, halo passes, the dataflow plan,
# the pure-torch lowerings, the CUDA kernel orchestrator, the distributed
# executor and the measured plan search.
from .frontend import (CoeffHandle, ExprHandle, FieldHandle, ProgramBuilder,
                       absolute, exp, log, maximum, minimum, sign, sqrt,
                       tanh, where)
from .boundary import BOUNDARIES
from .dataflow import (StreamGraph, StreamRegion, chain_split_reason,
                       effective_plane_tile, effective_time_tile,
                       lower_to_dataflow, plane_split_reason)
from .ir import Program
from .pipeline import (CompiledStencil, CompileOptions, TileDemotionWarning,
                       batched_executable, compile_program, run_time_loop)
from .schedule import (DataflowPlan, ShardSpec, StreamSpec, TimeLoopSpec,
                       adapt_update, auto_plan, make_shard_spec,
                       plan_from_dict, plan_time_loop, plan_to_dict,
                       program_fingerprint, shard_local_grid, smem_cost)
from .tune import (PlanCache, TuneConfig, TuneResult, get_tuned_plan,
                   tune_plan)
