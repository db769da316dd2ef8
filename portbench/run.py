"""The benchmark of scail_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (denoise steps in the window), `metrics` (the
cell's end-to-end metrics with --trace 0, its per-layer ones with --trace 1),
`device`, with --trace 1 `breakdown`, and last `compared`: each number the
correctness check compared, with its limit (also the last lines of standard
error).  Exits 2 without a result where the cell's CUDA devices are missing,
and 3 where a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_context() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # libraries that would load JAX by themselves are told not to
    os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0")

    from portbench.guard import forbidden_modules
    from portbench.manifest import load_cell

    cell = load_cell(a.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    result = run_cell(cell, a.seed, a.seconds, trace_run=bool(a.trace), t_start=T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: JAX modules loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    print(f"[portbench] card: {card_context()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
