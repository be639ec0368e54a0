"""Optimizers and learning-rate schedules of the port (``repro/optim``)."""

from repro_torch.optim.optimizers import (AdamState, SgdState, adamw_init,
                                          adamw_update, clip_by_global_norm,
                                          make_optimizer, sgd_init,
                                          sgd_update)
from repro_torch.optim.schedule import make_schedule

__all__ = ["AdamState", "SgdState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "make_optimizer", "make_schedule",
           "sgd_init", "sgd_update"]
