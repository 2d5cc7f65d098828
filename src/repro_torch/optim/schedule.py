"""LR schedules.

Port of ``repro.optim.schedule``, computed in f32 as the reference's.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio * peak: an f32
    scalar tensor on ``step``'s device (CPU for an int).  Step 0 of a
    warmup gives lr = 0, as in the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)
