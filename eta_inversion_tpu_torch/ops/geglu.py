"""GEGLU feed-forward, plain PyTorch path.

Counterpart of `geglu_mlp_xla` in eta_inversion_tpu/ops/geglu.py: x.W1 + b1 ->
split -> h * gelu(gate) -> .W2 + b2.  In fp32 the gelu is the exact erf gelu;
in bf16 it is the JAX package's pure-FMA polynomial erf (abs err <= 2e-4), so
both packages round the same function.  The fused GEGLU kernel (a Pallas
kernel that the JAX package only runs under `force_fused`) is not ported yet
(ROADMAP, Queue 2, K6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# odd minimax polynomial for erf on [-3, 3] (eta_inversion_tpu/ops/geglu.py)
ERF_COEF = (1.1283629719137802, -0.37581876264851877, 0.11186273083615,
            -0.025649756925251198, 0.004437909424632624,
            -0.0005535658971878295, 4.614817819605463e-05,
            -2.2677774146116304e-06, 4.9183736107624126e-08)


def erf_poly(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, -3.0, 3.0)
    z2 = z * z
    p = torch.full_like(z, ERF_COEF[-1])
    for c in ERF_COEF[-2::-1]:
        p = p * z2 + c
    return z * p


def gelu_poly_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu on an fp32 tensor via the polynomial erf."""
    return 0.5 * x * (1.0 + erf_poly(x * (1.0 / math.sqrt(2.0))))


def geglu_mlp_xla(x, w1, b1, w2, b2):
    """w1/b1, w2/b2: nn.Linear weights (out, in) and biases, in the compute
    dtype of x."""
    s = F.linear(x, w1, b1)
    inner = w2.shape[1]
    h, gate = s[..., :inner], s[..., inner:]
    if x.dtype == torch.float32:
        a = h * F.gelu(gate)
    else:
        a = (h.float() * gelu_poly_f32(gate.float())).to(x.dtype)
    return F.linear(a, w2, b2)
