"""The readings a cell's correctness limits are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 ... \\
        [--control-seeds 11 12 13] [--seconds 2] [--out readings.jsonl]

For each seed, one run of the cell as the benchmark makes it (set-up, a
short window at the cell's own load, the check of a step drawn from the
seed): the program's gaps to the reference, the lower readings.  For each
of --control-seeds, on the same step, the gaps of the architecture's
control (for SCAIL's DiT the reference computed with float8 (e4m3) matrix
products): the upper readings.
One JSON line a seed on standard output, and in --out.  Not part of the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0")
    import torch

    from portbench.harness import run_cell
    from portbench.manifest import load_cell

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    for seed in a.seeds:
        r = run_cell(cell, seed, a.seconds, control=seed in a.control_seeds)
        line = {"workload": a.workload, "seed": seed, "steps": r["attempted"],
                "program": {k: v["value"] for k, v in r["compared"].items()},
                "control": r.get("control"),
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
