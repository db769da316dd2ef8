"""The plain reference against the port at a tiny width on the CPU, and the
rest of a run (the window, the check, the result line) with the timed path
sound and broken.  Only these tests import both the port and the reference."""

import json

import pytest
import torch

from portbench import harness
from portbench.reference import dit as ref_dit
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 33 + 7  # past 32 signed bits: seeds of any size are taken
CELLS = ["sample-1p3b-dense-81f", "sample-1p3b-sta-81f"]


@pytest.mark.parametrize("workload", CELLS)
def test_f32_port_agrees_with_the_reference(workload):
    r = harness.run_cell(tiny_cell(workload), SEED, 0.0, device="cpu")
    assert r["compared"]["rel_l2"]["value"] < 2e-5
    assert r["correct"] is True


def test_result_line_shape():
    r = harness.run_cell(tiny_cell(), SEED, 0.0, device="cpu")
    line = json.loads(json.dumps(r))
    assert list(line)[:4] == ["correct", "attempted", "failed", "device"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == {"denoise_step_s": "s",
                                                                  "setup_s": "s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["compared"]) == {"rel_l2", "worst_frame_rel_l2", "start_mismatch",
                                     "chain_breaks", "schedule_mismatch", "launch_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["compared"].values())


def test_window_runs_its_steps_back_to_back():
    """A window of a whole request and a bit: the second request starts from
    its own noise, every step from the one before, on the schedule."""
    cell = tiny_cell(layers=1, hidden=32)
    cell.config["model"]["sampler_config"]["params"]["num_steps"] = 3
    r = harness.run_cell(cell, SEED, 0.3, device="cpu")
    assert r["attempted"] >= 3
    for name in ("start_mismatch", "chain_breaks", "schedule_mismatch"):
        assert r["compared"][name]["value"] == 0
    assert r["correct"] is True


def _hook_dit(monkeypatch, cell, hook):
    real = cell.arch.load_weights

    def load(engine, cell, seed):
        nets = real(engine, cell, seed)
        for net in nets:
            net.register_forward_hook(hook)
        return nets
    monkeypatch.setattr(cell.arch, "load_weights", load)


def _unchanged(monkeypatch, cell):
    from scail_tpu_torch.diffusion.samplers import RFSampler

    monkeypatch.setattr(RFSampler, "step", lambda self, fn, x, *a, **kw: x.clone())


def _half_batch(monkeypatch, cell):
    # the cond half of the CFG batch left out: the mean over the rest (the
    # uncond half) stands in for it
    _hook_dit(monkeypatch, cell, lambda m, a, out: out[:1].mean(0, keepdim=True).expand_as(out))


def _answer_altered(monkeypatch, cell):
    def hook(m, a, out):
        out = out.clone()
        out[1, 2] = -out[1, 2]  # one latent frame of the cond half
        return out
    _hook_dit(monkeypatch, cell, hook)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, workload, monkeypatch):
    """Each fault a one-card cell can have (no exchange between chips exists
    here) makes `correct` false."""
    cell = tiny_cell(workload)
    fault(monkeypatch, cell)
    r = harness.run_cell(cell, SEED, 0.0, device="cpu")
    assert r["correct"] is False


def test_fp8_matmuls_round_each_operand():
    mm = ref_dit.Matmuls(fp8=True)
    x = torch.randn(4, 64, dtype=torch.float64).float()
    q = mm.rows(x)
    assert not torch.equal(q, x)
    assert ((q - x).abs() <= x.abs().amax(-1, keepdim=True) / 448 * 32).all()
    assert torch.equal(ref_dit.Matmuls().rows(x), x)


def test_control_reads_far_above_the_program():
    """The control (the reference with float8 matrix products, on the
    program's own step) at a width the CPU holds: on each of 3 seeds it
    reads at least three times the bf16 program's largest gap, so a limit
    between them exists; on the card the cells' limits were set the same
    way (portbench/limits)."""
    cell = tiny_cell(dtype="bfloat16", layers=4, hidden=128, height=128)
    program, control = [], []
    for seed in (11, 12, 13):
        r = harness.run_cell(cell, seed, 0.0, device="cpu", control=True)
        program.append(r["compared"]["rel_l2"]["value"])
        control.append(r["control"]["rel_l2"])
    assert min(control) >= 3 * max(program), (program, control)
