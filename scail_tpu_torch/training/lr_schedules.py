"""AnnealingLR (counterpart of scail_tpu/training/lr_schedules.py).

Linear warmup over `warmup_iter` steps, then linear / cosine / exponential /
constant decay over `num_iters`, floored at `decay_ratio` of the base lr.
Computed in float32, as the JAX schedule is.
"""

from __future__ import annotations

import math

import numpy as np

DECAY_STYLES = ("linear", "cosine", "exponential", "constant", "None", None)


def annealing_lr(start_lr: float, warmup_iter: int, num_iters: int,
                 decay_style: str = "linear", decay_ratio: float = 0.1):
    """Returns schedule(step) -> lr (a Python float)."""
    if decay_style not in DECAY_STYLES:
        raise ValueError(f"unknown decay_style {decay_style!r}, expected one of {DECAY_STYLES}")

    def schedule(step) -> float:
        step = np.float32(step)
        if warmup_iter > 0 and step < warmup_iter:
            return float(np.float32(start_lr) * step / np.float32(max(warmup_iter, 1)))
        progress = np.clip((step - np.float32(warmup_iter))
                           / np.float32(max(num_iters - warmup_iter, 1)),
                           np.float32(0.0), np.float32(1.0))
        lr = np.float32(start_lr)
        if decay_style == "linear":
            lr = lr * (np.float32(1.0) - progress * np.float32(1.0 - decay_ratio))
        elif decay_style == "cosine":
            lr = lr * (np.float32(decay_ratio) + np.float32(1 - decay_ratio) * np.float32(0.5)
                       * (np.float32(1.0) + np.cos(np.float32(math.pi) * progress)))
        elif decay_style == "exponential":
            lr = lr * np.float32(decay_ratio) ** progress
        return float(lr)

    return schedule
