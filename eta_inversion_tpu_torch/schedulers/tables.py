"""Diffusion noise-schedule tables.

Counterpart of eta_inversion_tpu/schedulers/tables.py (diffusers DDIM config:
beta_start=0.00085, beta_end=0.012, scaled_linear, set_alpha_to_one=False).
The tables are fp32 tensors; lookups take a Python int or an integer tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Static configuration of the diffusion noise schedule."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    steps_offset: int = 0
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"

    def make_betas(self) -> np.ndarray:
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                self.num_train_timesteps, dtype=np.float64) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end,
                                self.num_train_timesteps, dtype=np.float64)
        else:
            raise ValueError(f"unknown beta schedule {self.beta_schedule}")
        return betas.astype(np.float32)


class DiffusionSchedule:
    """Alpha-bar tables + timestep grids for an n-step diffusion."""

    def __init__(self, config: ScheduleConfig = ScheduleConfig(),
                 num_inference_steps: int = 50):
        self.config = config
        self.num_inference_steps = int(num_inference_steps)
        betas = config.make_betas()
        alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64))
        self.alphas_cumprod = torch.from_numpy(alphas_cumprod.astype(np.float32))
        final = 1.0 if config.set_alpha_to_one else float(alphas_cumprod[0])
        self.final_alpha_cumprod = torch.tensor(final, dtype=torch.float32)
        self.step_ratio = config.num_train_timesteps // self.num_inference_steps
        # diffusers DDIMScheduler.set_timesteps semantics
        ts = (np.arange(0, self.num_inference_steps) * self.step_ratio).round()[::-1]
        self._bwd_timesteps = ts.astype(np.int64) + config.steps_offset

    @property
    def timesteps_backward(self) -> np.ndarray:
        """Denoising timesteps, descending."""
        return self._bwd_timesteps.copy()

    def timesteps_forward(self, inv_steps: str = "sameshift") -> np.ndarray:
        """Inversion timesteps, ascending (sameshift / samesame / shiftshift,
        see the JAX module)."""
        steps = self._bwd_timesteps[::-1].copy()
        if inv_steps == "shiftshift":
            steps = steps - self.step_ratio
        return steps

    def alpha_at(self, t: Union[int, torch.Tensor]) -> torch.Tensor:
        """alphas_cumprod[t] (fp32 scalar tensor), t < 0 -> final alpha,
        t above the table clamped."""
        t = int(t)
        if t < 0:
            return self.final_alpha_cumprod
        return self.alphas_cumprod[min(t, self.config.num_train_timesteps - 1)]

    def prev_timestep(self, t):
        return t - self.step_ratio

    def variance(self, t) -> torch.Tensor:
        """DDIM sampling variance at timestep t."""
        alpha_prod_t = self.alpha_at(t)
        alpha_prod_t_prev = self.alpha_at(self.prev_timestep(t))
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev
        return (beta_prod_t_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)
