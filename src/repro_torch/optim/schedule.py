"""LR schedules (pure functions of the step counter, a 0-d tensor)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32, device=step.device)
