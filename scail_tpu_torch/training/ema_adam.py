"""Fused EMA-Adam (counterpart of scail_tpu/training/ema_adam.py), chained
after clipping by global norm as the JAX Trainer chains them.

One pass per parameter does the Adam(W) update and the EMA shadow update
shadow = decay * shadow + (1 - decay) * new_param.  The state is f32:
exp_avg, exp_avg_sq and shadow per parameter, plus the step count.  This is
elementwise work that the JAX package leaves to XLA, so plain torch ops do
it, in place on the parameters and the state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaAdamState:
    count: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    shadow: Dict[str, torch.Tensor]

    def state_dict(self) -> dict:
        """The state's tensors by reference (dataclasses.asdict would copy them)."""
        return {"count": self.count, "exp_avg": dict(self.exp_avg),
                "exp_avg_sq": dict(self.exp_avg_sq), "shadow": dict(self.shadow)}


class FusedEmaAdam:
    """Adam with bias correction and the EMA shadow.  adam_w_mode=True (the
    Trainer's) decays the weights apart from the moments (AdamW);
    adam_w_mode=False is the L2 mode, which adds weight_decay * param to the
    gradient before the moments (the reference kernel's ADAM_MODE 1).  The
    state covers the parameters it is given: the Trainer gives it those that
    require grad, so frozen parameters get no moments and no shadow (the
    JAX Trainer's multi_transform with set_to_zero on frozen leaves)."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, ema_decay: float = 0.9999,
                 adam_w_mode: bool = True):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.ema_decay = weight_decay, ema_decay
        self.adam_w_mode = adam_w_mode

    @staticmethod
    def init(params: Dict[str, torch.Tensor]) -> EmaAdamState:
        """Zero moments and a shadow that copies (never aliases) the params."""
        f32 = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return EmaAdamState(count=0, exp_avg=f32,
                            exp_avg_sq={n: torch.zeros_like(t) for n, t in f32.items()},
                            shadow={n: p.detach().float().clone() for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: EmaAdamState, lr: float) -> None:
        """Update params and state in place; `lr` is the schedule at the new
        count (state.count + 1)."""
        state.count += 1
        # bias corrections in f32, as the JAX update computes them
        n = np.float32(state.count)
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** n)
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** n)
        wd = self.weight_decay
        for n, p in params.items():
            g = grads[n].float()
            pf = p.float()
            if wd and not self.adam_w_mode:
                g = g + wd * pf
            m, v, s = state.exp_avg[n], state.exp_avg_sq[n], state.shadow[n]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if wd and self.adam_w_mode:
                upd = upd + wd * pf
            new_p = pf - lr * upd
            s.mul_(self.ema_decay).add_((1 - self.ema_decay) * new_p)
            # params += (new - old), as optax.apply_updates applies the update
            p.add_((new_p - pf).to(p.dtype))


def clip_by_global_norm_(grads: Dict[str, torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale grads in place to global L2 norm <= max_norm (optax's rule:
    t / norm * max_norm unless norm < max_norm, so a non-finite norm makes
    every gradient non-finite).  Returns the norm before."""
    norm = global_norm(grads)
    if not norm < max_norm:
        for g in grads.values():
            g.div_(norm.to(g.dtype)).mul_(max_norm)
    return norm


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


def swap_in_ema(params: Dict[str, torch.Tensor], state: EmaAdamState):
    """(ema_params, params): the shadow in the params' dtypes beside the live
    params, for the EMA double-save.  A parameter the state does not cover
    (frozen under LoRA) keeps its live value, as the JAX swap_in_ema does
    for a MaskedNode shadow."""
    return {n: state.shadow[n].to(p.dtype) if n in state.shadow else p
            for n, p in params.items()}, params
