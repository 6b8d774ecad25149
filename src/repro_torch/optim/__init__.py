from repro_torch.optim.adamw import (OptConfig, OptState,
                                     clip_by_global_norm, global_norm,
                                     leaf_groups, lr_at, make_optimizer)

__all__ = ["OptConfig", "OptState", "make_optimizer", "lr_at",
           "global_norm", "clip_by_global_norm", "leaf_groups"]
