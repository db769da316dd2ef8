"""Whether what the timed path produced is right.

One step of the window, drawn from the seed, is computed again by the
architecture's plain reference (`cell.arch.reference_velocity`; for SCAIL's
DiT portbench.reference, f32, TF32 off) from the state x the program began
it with, and the program's step is judged by the velocity it took,
v = (x_next - x) / (next_sigma - sigma), against the reference's guided
velocity: `rel_l2` over the whole latent and `worst_frame_rel_l2`, the
largest over its latent frames.  The reference follows the program step by
step from the program's own state, so what that skips is checked by itself,
exactly: every request starts from the state the architecture makes of the
benchmark's noise (`start_mismatch`), each step starts from the state the
one before returned (`chain_breaks`), every step takes the architecture's
schedule (`schedule_mismatch`), and the kernels launched are those of the
traffic's path and no others (`launch_gap`).  Each number has its limit;
the limits of the two gaps are in portbench/limits/<cell>.json, with the
readings they were set from.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


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
    `control`, also the gaps of the control (the architecture's control of
    the reference, from the same state): what a limit must fail."""
    rec = window.steps[pick]
    records = [window.warm] + window.steps
    arch = cell.arch

    def reference(control=False):
        return arch.reference_velocity(cell, seed, rec.x, rec.step, cond, uncond, device,
                                       control=control)

    v_ref = reference()
    sigma, next_sigma = arch.step_sigmas(cell, rec.step)
    dt = float(np.float32(next_sigma) - np.float32(sigma))
    v = (rec.out.float() - rec.x.float()) / dt
    gaps = velocity_gaps(v, v_ref)
    ctl = velocity_gaps(reference(control=True), v_ref) if control else None
    limits = cell.limits or {}
    out = {k: {"value": val, "limit": limits.get(k)} for k, val in gaps.items()}
    out["start_mismatch"] = {"value": sum(
        not torch.equal(r.x, arch.start_state(cell, window.noises[r.request]))
        for r in records if r.step == 0), "limit": 0}
    out["chain_breaks"] = {"value": sum(
        cur.x is not prev.out for prev, cur in zip(records, records[1:])
        if cur.request == prev.request), "limit": 0}
    out["schedule_mismatch"] = {"value": sum(
        (r.sigma, r.next_sigma) != arch.step_sigmas(cell, r.step) for r in records),
        "limit": 0}
    return out, ctl


def passes(compared: Dict[str, dict]) -> bool:
    """Every number within its limit (a missing limit or a NaN fails)."""
    for c in compared.values():
        v, lim = c["value"], c["limit"]
        if lim is None or (isinstance(v, float) and math.isnan(v)) or v > lim:
            return False
    return True
