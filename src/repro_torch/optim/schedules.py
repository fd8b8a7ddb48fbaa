"""Learning-rate schedules (own copy of ``repro.optim.schedules``): pure
functions of the step counter, a 0-d tensor, returning an f32 tensor on
its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def linear_warmup_cosine(lr: float, warmup: int, total: int,
                         final_frac: float = 0.1):
    def f(step):
        s = step.float()
        warm = lr * torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, lr * cos)
    return f


def inverse_sqrt(lr: float, warmup: int):
    def f(step):
        s = torch.clamp(step.float(), min=1.0)
        return lr * torch.minimum(s / warmup, torch.sqrt(warmup / s))
    return f
