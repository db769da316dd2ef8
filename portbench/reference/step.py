"""One denoise step of the SCAIL sampler, in plain PyTorch f32.

The rectified-flow Euler step of the YAML's RFSampler: the hunyuan-shifted
sigma schedule, the DiT at the CFG batch [uncond; cond] (only the text
states differ), VanillaCFG's combine, and x + (next_sigma - sigma) * v.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import dit
from portbench.reference.dit import Weights


def flow_sigmas(num_steps: int, shift_scale: float) -> np.ndarray:
    """The hunyuan schedule from sigma 1 to 0: s = linspace(0, 1, n + 1),
    s / (shift + s - shift * s), 1 - that, in f32."""
    s = np.linspace(0.0, 1.0, num_steps + 1, endpoint=True)
    s = s / (shift_scale + s - shift_scale * s)
    return (1.0 - s).astype(np.float32)


def step_sigmas(sampler: dict, step: int):
    """(sigma, next sigma) of step `step` of the sampler's params."""
    if not sampler.get("hunyuan_schedule") or sampler.get("schedule_shift"):
        raise NotImplementedError("the reference follows the hunyuan schedule only")
    sigmas = flow_sigmas(int(sampler["num_steps"]), float(sampler["shift_scale"]))
    return float(sigmas[step]), float(sigmas[step + 1])


def denoise_step(net: dict, sampler: dict, weights: Weights, x, step: int, cond: Dict,
                 uncond: Dict, sta: Optional[dict] = None, matmuls: Optional[dit.Matmuls] = None):
    """x (B, T, C, H, W) f32 after step `step` from x: returns (x_next, v)."""
    sigma, next_sigma = step_sigmas(sampler, step)
    scale = float(sampler["guider_config"]["params"]["scale"])
    B = x.shape[0]

    def both(key):
        return torch.cat([uncond[key], cond[key]]) if key == "crossattn" else torch.cat(
            [cond[key], cond[key]])

    t = torch.full((2 * B,), sigma * 1000.0, dtype=torch.float32, device=x.device)
    out = dit.forward(net, weights, torch.cat([x, x]), t, both("crossattn"),
                      both("ref_concat"), both("concat_smpl_render"),
                      both("image_clip_features") if "image_clip_features" in cond else None,
                      sta=sta, matmuls=matmuls)
    v_u, v_c = out.chunk(2)
    v = v_u + scale * (v_c - v_u)
    dt = float(np.float32(next_sigma) - np.float32(sigma))
    return x + dt * v, v
