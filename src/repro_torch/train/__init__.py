"""Training (``repro.train`` in PyTorch): AdamW and its schedule, int8
error-feedback compression, the train step and the fault-tolerant
``Trainer``."""

from .compress import compress_decompress, ef_compress_grads, ef_init
from .loop import TrainConfig, Trainer, make_train_step
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule)

__all__ = ["OptConfig", "TrainConfig", "Trainer", "adamw_init",
           "adamw_update", "clip_by_global_norm", "compress_decompress",
           "cosine_schedule", "ef_compress_grads", "ef_init",
           "make_train_step"]
