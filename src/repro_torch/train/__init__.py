"""Training: AdamW with clipping and a cosine schedule (``optim``) and the
train step with microbatching, remat and bf16 gradient accumulation
(``step``)."""

from .optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    adamw_state_from_reference, cosine_schedule,
                    global_norm, clip_by_global_norm)
from .step import make_loss, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_state_from_reference", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "make_loss", "make_train_step"]
