"""Learning-rate schedules as step -> lr callables, the counterpart of
``repro.optim.schedules``.  Each returns a 0-d f32 tensor computed in f32
as the reference computes it; a Python step is divided in double
precision first, as the reference's is."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "warmup_cosine"]

F32 = torch.float32


def _f32(x):
    return torch.as_tensor(x, dtype=F32)


def _ratio(step, total):
    """``step / total`` in f32 (a tensor step divides in f32)."""
    if isinstance(step, torch.Tensor):
        return step.to(F32) / total
    return _f32(step / total)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_ratio(step, max(total_steps, 1)), 0.0, 1.0)
        # the f32 argument's cosine correctly rounded to f32 (float32
        # cosines of torch and XLA differ in the last place)
        cos = 0.5 * (1 + torch.cos((math.pi * t).double()).to(F32))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        if step < warmup:
            return lr * torch.clamp(_ratio(step, max(warmup, 1)), max=1.0)
        return cos(step - warmup)

    return fn
