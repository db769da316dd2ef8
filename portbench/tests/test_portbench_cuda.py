"""On the card: one short run of a cell through the command, and the
control at a reduced depth.  Marked `cuda`; each test skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.manifest import ROOT


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_is_correct():
    _card()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sample-1p3b-sta-81f", "--seed", "4294967311", "--seconds", "3"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] >= 1


@pytest.mark.cuda
def test_control_fails_the_committed_limit():
    """The float8 control at the STA cell's own size, on the program's step:
    the program within the committed limit, the control past it."""
    _card()
    from portbench.harness import run_cell
    from portbench.manifest import load_cell

    cell = load_cell("sample-1p3b-sta-81f")
    r = run_cell(cell, 4294967357, 3.0, control=True)
    limit = cell.limits["rel_l2"]
    assert r["compared"]["rel_l2"]["value"] < limit < r["control"]["rel_l2"]
    assert r["correct"] is True
