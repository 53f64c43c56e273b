"""DDIM steps (forward/inverse directions, elementwise eta).

Counterpart of eta_inversion_tpu/schedulers/ddim.py.  `eta` may be a float or
a tensor broadcastable against the latent (per-pixel eta, as eta-inversion
needs); a stochastic step takes its variance noise as an argument, so every
draw is the caller's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .tables import DiffusionSchedule


def _on(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device)


def _f32(*xs):
    """The tables are fp32, so (as under JAX promotion) the step runs in fp32
    whatever the dtype of the UNet's eps."""
    return tuple(x.float() for x in xs)


def pred_x0(schedule: DiffusionSchedule, latent, eps, t):
    """Predicted clean sample x0 from the epsilon prediction at timestep t."""
    latent, eps = _f32(latent, eps)
    alpha_prod_t = _on(schedule.alpha_at(t), latent)
    return (latent - torch.sqrt(1.0 - alpha_prod_t) * eps) / torch.sqrt(alpha_prod_t)


def ddim_step(schedule: DiffusionSchedule, latent, eps, t_from, t_to):
    """Deterministic DDIM update from timestep `t_from` to `t_to` (either
    direction); timesteps < 0 resolve to the final alpha, above the table are
    clamped."""
    t_max = schedule.config.num_train_timesteps - 1
    latent, eps = _f32(latent, eps)
    alpha_prod_t = _on(schedule.alpha_at(min(int(t_from), t_max)), latent)
    alpha_prod_t_to = _on(schedule.alpha_at(min(int(t_to), t_max)), latent)
    x0 = (latent - torch.sqrt(1.0 - alpha_prod_t) * eps) / torch.sqrt(alpha_prod_t)
    return torch.sqrt(alpha_prod_t_to) * x0 + torch.sqrt(1.0 - alpha_prod_t_to) * eps


def ddim_inverse_step(schedule: DiffusionSchedule, latent, eps, t,
                      inv_steps: str = "sameshift"):
    """One inversion (noising) step; `t` is the UNet-evaluation timestep."""
    d = schedule.step_ratio
    if inv_steps == "sameshift":
        return ddim_step(schedule, latent, eps, t - d, t)
    if inv_steps in ("samesame", "shiftshift"):
        return ddim_step(schedule, latent, eps, t, t + d)
    raise ValueError(f"unknown inv_steps mode: {inv_steps}")


def ddim_backward_step(schedule: DiffusionSchedule, latent, eps, t, eta=0.0,
                       noise: Optional[torch.Tensor] = None):
    """Full DDIM denoising step t -> t-Δ with stochasticity eta (float or a
    tensor broadcastable to the latent); `noise` is the variance noise."""
    latent, eps = _f32(latent, eps)
    alpha_prod_t = _on(schedule.alpha_at(t), latent)
    alpha_prod_t_prev = _on(schedule.alpha_at(schedule.prev_timestep(t)), latent)
    x0 = (latent - torch.sqrt(1.0 - alpha_prod_t) * eps) / torch.sqrt(alpha_prod_t)
    variance = _on(schedule.variance(t), latent)
    eta = torch.as_tensor(eta, dtype=latent.dtype, device=latent.device)
    std_dev_t = eta * torch.sqrt(variance)
    direction = torch.sqrt(1.0 - alpha_prod_t_prev - std_dev_t ** 2) * eps
    prev_sample = torch.sqrt(alpha_prod_t_prev) * x0 + direction
    if noise is not None:
        prev_sample = prev_sample + std_dev_t * noise
    return prev_sample
