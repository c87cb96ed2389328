from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule, global_norm)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
