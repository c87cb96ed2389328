from .adamw import (AdamWConfig, OptState, adamw_init, adamw_init_sharded,
                    adamw_update, adamw_update_sharded, cosine_schedule,
                    gather_slices, global_norm)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_init_sharded",
           "adamw_update", "adamw_update_sharded", "cosine_schedule",
           "gather_slices", "global_norm"]
