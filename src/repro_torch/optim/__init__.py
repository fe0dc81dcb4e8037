"""repro_torch.optim — AdamW (bf16 moments), schedules, clipping."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import constant_schedule, cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "wsd_schedule", "cosine_schedule", "constant_schedule"]
