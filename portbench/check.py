"""Whether what the timed path produced is right.

One step of the window, drawn from the seed, is computed again by the plain
reference (portbench.reference, f32, TF32 off) from the state x the program
began it with, and the program's step is judged by the velocity it took,
v = (x_next - x) / (next_sigma - sigma), against the reference's guided
velocity: `rel_l2` over the whole latent and `worst_frame_rel_l2`, the
largest over its latent frames.  The reference follows the program step by
step from the program's own state, so what that skips is checked by itself,
exactly: every request starts from the benchmark's noise
(`start_mismatch`), each step starts from the state the one before returned
(`chain_breaks`), every step takes the schedule's sigmas
(`schedule_mismatch`), and the kernels launched are those of the traffic's
path and no others (`launch_gap`).  Each number has its limit; the limits of
the two gaps are in portbench/limits/<cell>.json, with the readings they
were set from.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference import step as ref_step
from portbench.reference.dit import Matmuls, exact_f32
from portbench.weights import block_tensors, dit_param_specs

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def reference_weights(cell, seed: int, device):
    """block -> {name: f32 tensor}: the served weights drawn again."""
    specs = dit_param_specs(cell.net)
    dtype = DTYPES[cell.config["dtype"]]

    def weights(block):
        return {n: t.float() for n, t in block_tensors(seed, block, specs[block], device=device,
                                                       dtype=dtype).items()}
    return weights


def velocity_gaps(v, v_ref) -> Dict[str, float]:
    d = (v - v_ref).double()
    ref = v_ref.double()
    frames = [(d[:, t].norm() / ref[:, t].norm()).item() for t in range(v.shape[1])]
    return {"rel_l2": (d.norm() / ref.norm()).item(), "worst_frame_rel_l2": max(frames)}


def launch_gap(got: Dict[str, int], want: Dict[str, int]) -> int:
    """Launches off the expected counts, summed over every counter."""
    return sum(abs(got.get(k, 0) - want.get(k, 0)) for k in set(got) | set(want))


def compare(cell, seed: int, window, pick: int, cond, uncond, device,
            control: bool = False) -> Tuple[Dict[str, dict], Optional[Dict[str, float]]]:
    """The compared numbers of a run whose window recorded `window.steps`,
    step `pick` of them computed again; each {'value', 'limit'}.  With
    `control`, also the gaps of the control (the reference with float8
    matrix products, from the same state): what a limit must fail."""
    rec = window.steps[pick]
    records = [window.warm] + window.steps
    sampler = cell.sampler
    weights = reference_weights(cell, seed, device)

    def reference(matmuls=None):
        with exact_f32():
            return ref_step.denoise_step(cell.net, sampler, weights, rec.x, rec.step, cond,
                                         uncond, sta=cell.traffic.get("sta"), matmuls=matmuls)[1]

    v_ref = reference()
    sigma, next_sigma = ref_step.step_sigmas(sampler, rec.step)
    dt = float(np.float32(next_sigma) - np.float32(sigma))
    v = (rec.out.float() - rec.x.float()) / dt
    gaps = velocity_gaps(v, v_ref)
    ctl = velocity_gaps(reference(Matmuls(fp8=True)), v_ref) if control else None
    limits = cell.limits or {}
    out = {k: {"value": val, "limit": limits.get(k)} for k, val in gaps.items()}
    out["start_mismatch"] = {"value": sum(
        not torch.equal(r.x, window.noises[r.request]) for r in records if r.step == 0),
        "limit": 0}
    out["chain_breaks"] = {"value": sum(
        cur.x is not prev.out for prev, cur in zip(records, records[1:])
        if cur.request == prev.request), "limit": 0}
    out["schedule_mismatch"] = {"value": sum(
        (r.sigma, r.next_sigma) != ref_step.step_sigmas(sampler, r.step) for r in records),
        "limit": 0}
    return out, ctl


def passes(compared: Dict[str, dict]) -> bool:
    """Every number within its limit (a missing limit or a NaN fails)."""
    for c in compared.values():
        v, lim = c["value"], c["limit"]
        if lim is None or (isinstance(v, float) and math.isnan(v)) or v > lim:
            return False
    return True
