"""A cell at a width a CPU test can hold, built from a real cell's files."""

import copy
import dataclasses

from portbench import manifest


def tiny_cell(workload="sample-1p3b-dense-81f", *, dtype="float32", layers=2, hidden=64,
              heads=2, height=None, limits=None):
    """The cell `workload` cut to `layers` layers of width `hidden`, 21
    frames at (height x 64); limits of 1e-4 (an f32 program agrees to 1e-5)
    unless given."""
    cell = manifest.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    p = cfg["model"]["network_config"]["params"]
    p.update(hidden_size=hidden, num_layers=layers, num_attention_heads=heads,
             inner_hidden_size=2 * hidden, text_dim=32, time_freq_dim=16,
             time_embed_dim=hidden, clip_dim=32)
    cfg["dtype"] = dtype
    sta = cell.traffic.get("sta") is not None
    traffic = dict(cell.traffic, frames=21, height=height or (512 if sta else 64), width=64,
                   text_tokens=8, clip_tokens=5)
    limits = limits or {"rel_l2": 1e-4, "worst_frame_rel_l2": 1e-4}
    return dataclasses.replace(cell, name=f"tiny-{workload}", config=cfg, traffic=traffic,
                               limits=limits)
