"""repro_torch.serve — the stencil serving subsystem on the card (the port
of ``repro.serve``).

(The LM serving engine lives in ``repro_torch.models.lm_serve``.)
"""

from ..core.schedule import BucketSpec, bucket_fingerprint, bucket_for
from .bucket import (crop, embed_coeff, embed_field, embed_request,
                     make_refresh, serving_program, size_scalar_names,
                     wrap_update)
from .engine import ServeResult, StencilEngine, StencilRequest
from .stats import ServeStats

__all__ = [
    "BucketSpec", "bucket_fingerprint", "bucket_for",
    "crop", "embed_coeff", "embed_field", "embed_request",
    "make_refresh", "serving_program", "size_scalar_names", "wrap_update",
    "ServeResult", "StencilEngine", "StencilRequest", "ServeStats",
]
