"""Optimizers and schedules on trees of tensors (the port of
``repro.optim``)."""
from repro_torch.optim.adafactor import (AdafactorConfig, AfState,
                                        adafactor_init, adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                    adamw_update, clip_by_global_norm,
                                    global_norm)
from repro_torch.optim.schedule import (Schedule, constant, cosine_decay,
                                       linear_warmup_cosine)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "AdafactorConfig",
           "AfState", "adafactor_init", "adafactor_update", "Schedule",
           "constant", "cosine_decay", "linear_warmup_cosine"]
