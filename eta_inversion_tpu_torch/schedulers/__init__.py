from .ddim import ddim_backward_step, ddim_inverse_step, ddim_step, pred_x0
from .tables import DiffusionSchedule, ScheduleConfig

__all__ = ["DiffusionSchedule", "ScheduleConfig", "ddim_step", "ddim_inverse_step",
           "ddim_backward_step", "pred_x0"]
