"""A test-only architecture: two experts of a per-position MLP denoiser,
chosen by sigma, under an EDM-style Euler sampler.

Its program is the small engine below (no network of the port), so that a
test can add a configuration of another architecture to a copy of the
benchmark by files alone: this module, its reference
(portbench/reference/toy_two_expert.py), a configuration, a traffic mix,
limits and a metric reader.  The sampler's step has the EDM samplers'
signature, step(call, x, state, sigma, next_sigma) -> (x, state), and a
request starts from noise * sqrt(1 + sigma_0^2), as the port's EDM
samplers do.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import flops
from portbench.reference import toy_two_expert as ref
from portbench.weights import derive_seed

GROUPS = (("toy_expert_mlp", ("addmm",)),)
NETWORKS = ("high", "low")


def net(cell) -> dict:
    return dict(cell.config["model"])


class Expert(torch.nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c, h, k, f = m["channels"], m["hidden"], m["cond_dim"], m["freq_dim"]
        self.freq_dim = f
        self.fc_in = torch.nn.Linear(c, h)
        self.time = torch.nn.Linear(2 * f, h, bias=False)
        self.ctx = torch.nn.Linear(k, h, bias=False)
        self.fc_out = torch.nn.Linear(h, c)

    def forward(self, x, sigma: torch.Tensor, context):
        f = torch.arange(self.freq_dim, dtype=torch.float32, device=x.device)
        ang = (sigma.log() / 4)[:, None] * torch.exp(-f)
        t = self.time(torch.cat([ang.sin(), ang.cos()], -1)) + self.ctx(context.mean(1))
        h = self.fc_in(x.movedim(2, -1)) + t[:, None, None, None]
        return self.fc_out(torch.nn.functional.silu(h)).movedim(-1, 2)


class EulerSampler:
    def step(self, call, x, state, sigma, next_sigma):
        d = (x - call(x, sigma)) / float(sigma)
        dt = float(np.float32(next_sigma) - np.float32(sigma))
        return x + dt * d, state


class Engine:
    def __init__(self, m: dict, device):
        self.m = m
        self.device = torch.device(device)
        self.sampler = EulerSampler()
        self.experts: Dict[str, Expert] = {}

    def denoise(self, x, sigma: float, cond, uncond):
        expert = self.experts["high" if sigma >= self.m["boundary_sigma"] else "low"]
        s = torch.full((2 * x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        xx = torch.cat([x, x])
        c_in, c_skip, c_out = ((s ** 2 + 1).rsqrt(), 1 / (s ** 2 + 1), s * (s ** 2 + 1).rsqrt())
        view = (-1, 1, 1, 1, 1)
        out = c_skip.view(view) * xx + c_out.view(view) * expert(
            c_in.view(view) * xx, s, torch.cat([uncond["context"], cond["context"]]))
        d_u, d_c = out.chunk(2)
        return d_u + self.m["cfg_scale"] * (d_c - d_u)

    def sample(self, cond, uncond, noise):
        sig = ref.sigmas(self.m)
        x = noise.float() * float(np.sqrt(1.0 + sig[0] ** 2))
        state = None
        for i in range(len(sig) - 1):
            x, state = self.sampler.step(lambda y, s: self.denoise(y, s, cond, uncond), x,
                                         state, float(sig[i]), float(sig[i + 1]))
        return x


def build_engine(cell, device):
    return Engine(cell.net, device)


def _param_specs(cell) -> Dict[str, Dict[str, ref.Spec]]:
    return {n: {"expert": ref.expert_spec(cell.net)} for n in NETWORKS}


def load_weights(engine, cell, seed: int) -> List[torch.nn.Module]:
    for name, specs in _param_specs(cell).items():
        expert = Expert(cell.net).to(engine.device)
        with torch.no_grad():
            for pname, t in ref.draw(seed, name, specs["expert"], engine.device).items():
                expert.get_parameter(pname).copy_(t)
        engine.experts[name] = expert.eval().requires_grad_(False)
    return [engine.experts[n] for n in NETWORKS]


def _shape(cell) -> Tuple[int, ...]:
    t, m = cell.traffic, cell.net
    return t["batch"], t["frames"], m["channels"], t["height"], t["width"]


def conditioning(cell, seed: int, device) -> Tuple[Dict, Dict]:
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "conditioning"))
    shape = (cell.traffic["batch"], cell.traffic["cond_tokens"], cell.net["cond_dim"])
    cond = torch.randn(shape, generator=gen, device=device)
    uncond = torch.randn(shape, generator=gen, device=device)
    return {"context": cond}, {"context": uncond}


def noise(cell, seed: int, request: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "noise", str(request)))
    return torch.randn(_shape(cell), generator=gen, device=device)


def sample(engine, cell, cond, uncond, noise) -> None:
    engine.sample(cond, uncond, noise)


def step_view(args, out):
    """(x, sigma, next sigma, x next) of step(call, x, state, sigma, next_sigma)."""
    return args[1], args[3], args[4], out[0]


def start_state(cell, noise):
    return noise.float() * float(np.sqrt(1.0 + ref.sigmas(cell.net)[0] ** 2))


def step_sigmas(cell, step: int) -> Tuple[float, float]:
    sig = ref.sigmas(cell.net)
    return float(sig[step]), float(sig[step + 1])


def reference_velocity(cell, seed, x, step, cond, uncond, device, control=False):
    weights = {n: ref.draw(seed, n, s["expert"], device) for n, s in _param_specs(cell).items()}
    sigma, _ = step_sigmas(cell, step)
    return ref.velocity(cell.net, weights, x.float(), sigma, cond, uncond, control=control)


def step_work(cell) -> flops.StepWork:
    m = cell.net
    b, t, c, h, w = _shape(cell)
    rows = 2 * b * t * h * w
    lins = [flops.Linear("fc_in", rows, c, m["hidden"]),
            flops.Linear("fc_out", rows, m["hidden"], c)]
    return flops.StepWork(linear_flops=sum(x.flops for x in lins),
                          linear_bound_s=sum(flops.bound_s(x.flops, x.bytes) for x in lins),
                          self_attn_flops=0, self_attn_bound_s=0.0, cross_attn_flops=0)


def expected_launches(cell, forwards: int) -> Dict[str, int]:
    return {}  # the toy runs no kernel of the port

