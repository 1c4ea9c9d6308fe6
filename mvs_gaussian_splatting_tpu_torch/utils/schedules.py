"""Learning-rate schedules.

Port of the JAX package's ``utils/schedules.py``: the Plenoxels/JaxNeRF
log-linear decay with an optional sine delay ramp, evaluated in float32 as
the JAX package evaluates it inside its train step.
"""

from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> float:
    """Log-linearly interpolated learning rate at ``step``.

    Returns 0 for step < 0 or when both endpoints are 0 (parameter
    disabled)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = torch.tensor(float(step), dtype=torch.float32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32))
    log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32))
    log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
    return 0.0 if float(step) < 0 else float(delay_rate * log_lerp)
