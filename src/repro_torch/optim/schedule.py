"""Learning-rate schedules as pure scalar functions of the step (the port
of ``repro.optim.schedule``): each takes an integer step (a Python int or
an integer tensor) and returns an f32 scalar tensor on the step's
device."""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float = 1.0) -> Schedule:
    def f(step):
        return torch.tensor(value, dtype=torch.float32,
                            device=torch.as_tensor(step).device)
    return f


def cosine_decay(total_steps: int, final_frac: float = 0.1) -> Schedule:
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_frac + (1.0 - final_frac) * cos
    return f


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    cos = cosine_decay(max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))
    return f
