"""Learning-rate schedules: WSD (MiniCPM), cosine, constant.

The JAX package's ``optim/schedule.py``.  A schedule maps a step (an
``int`` or a 0-d int tensor) to the learning rate as a 0-d float32 CPU
tensor, computed with the JAX code's float32 operations one 0-d op at a
time on the host (PyTorch's scalar ``pow`` gives the bits of the JAX
package's, where its vectorised one and numpy's ``powf`` differ at some
steps), so ``float(lr(step))`` of :func:`wsd_schedule` and
:func:`constant_schedule` equals the JAX value at every step; the cosine of
:func:`cosine_schedule` is within one f32 ulp of XLA's.  The trainer keeps its step counter on the host, so a schedule never waits for
the card.

The WSD (warmup-stable-decay) schedule is part of the minicpm-2b
assignment: linear warmup → flat stable phase → exponential decay over the
last ``decay_frac`` of training.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(x) -> torch.Tensor:
    """A step or a Python number as a 0-d float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32)


def wsd_schedule(peak_lr: float, total_steps: int, *,
                 warmup_steps: int = 0, decay_frac: float = 0.1,
                 final_scale: float = 0.1) -> Callable:
    """MiniCPM WSD: warmup → stable at peak → decay to final_scale * peak."""
    warmup = max(1, warmup_steps or total_steps // 100)
    decay_start = int(total_steps * (1.0 - decay_frac))

    def lr(step) -> torch.Tensor:
        s = _f32(step)
        w = torch.clamp(s / warmup, max=1.0)
        frac = torch.clamp((s - decay_start)
                           / max(1, total_steps - decay_start), 0.0, 1.0)
        decay = torch.pow(_f32(final_scale), frac)        # exponential anneal
        return peak_lr * w * decay

    return lr


def cosine_schedule(peak_lr: float, total_steps: int, *,
                    warmup_steps: int = 0, final_scale: float = 0.1
                    ) -> Callable:
    warmup = max(1, warmup_steps or total_steps // 100)

    def lr(step) -> torch.Tensor:
        s = _f32(step)
        w = torch.clamp(s / warmup, max=1.0)
        t = torch.clamp((s - warmup) / max(1, total_steps - warmup), 0.0, 1.0)
        # XLA's f32 cosine is its own approximation: the double cosine
        # rounded to f32 is nearer to it than torch's f32 one (an ulp apart
        # at 1.4 % of angles against 4.9 %)
        c = torch.cos((math.pi * t).double()).float()
        cos = final_scale + (1 - final_scale) * 0.5 * (1 + c)
        return peak_lr * w * cos

    return lr


def constant_schedule(lr_value: float) -> Callable:
    def lr(step) -> torch.Tensor:
        return _f32(lr_value)
    return lr
