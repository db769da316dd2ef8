"""The architecture modules (portbench/arch): SCAIL's pieces pinned to the
values they had before they moved behind `arch/scail_dit.py`, and a toy
architecture added to a copy of the benchmark by files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import manifest

SEED = 2 ** 40 + 123
TOY = manifest.PACKAGE / "tests" / "toy_arch"

# Recorded from the benchmark before its SCAIL pieces moved into arch/scail_dit.py:
# the step's work, (parameter count, sha256[:16] of the [block, name, shape] list),
# the launches of 3 forwards, and sha256[:16] of the inputs drawn on the CPU for SEED
# (cond crossattn, uncond crossattn, ref_concat, concat_smpl_render,
# image_clip_features, the noise of request 1).
WORK_1P3B = dict(linear_flops=244739102474240, linear_bound_s=0.24759838318099742,
                 cross_attn_flops=13843098501120)
INPUTS = ("b11b8344f43a649a", "bed6c433f17f1585", "5bf8d02ad0c51edd", "c759eb1ef9eaf055",
          "1f92ef2b396083d3", "2788c5ce61a75c4a")
PINNED = {
    "sample-1p3b-dense-81f": (
        dict(WORK_1P3B, self_attn_flops=879045755535360, self_attn_bound_s=0.8888228064058241),
        (685, "36a2949d4eee2c64"),
        {"flash_attention_rope": 90, "dual_cross_attention": 90, "adaln_layer_norm": 183,
         "rotary": 90}),
    "sample-14b-dense-81f": (
        dict(linear_flops=2341591251681280, linear_bound_s=2.3681510276452173,
             self_attn_flops=3906870024601600, self_attn_bound_s=3.9503235840258846,
             cross_attn_flops=61524882227200),
        (905, "d862476cb815a269"),
        {"flash_attention_rope": 120, "dual_cross_attention": 120, "adaln_layer_norm": 243,
         "rotary": 120}),
    "sample-1p3b-sta-81f": (
        dict(WORK_1P3B, self_attn_flops=273087945768960, self_attn_bound_s=0.2761253243366633),
        (685, "36a2949d4eee2c64"),
        {"sta_attention_fwd": 180, "flash_attention": 90, "dual_cross_attention": 90,
         "adaln_layer_norm": 183, "rotary": 180}),
}


def _digest(t: torch.Tensor) -> str:
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_scail_pieces_are_the_parents(workload):
    work, specs, launches = PINNED[workload]
    cell = manifest.load_cell(workload)
    assert cell.arch.__file__ == str(manifest.PACKAGE / "arch" / "scail_dit.py")
    got = cell.arch.step_work(cell)
    assert {k: getattr(got, k) for k in work} == work
    (nets,) = cell.arch._param_specs(cell).values()
    flat = [[block, name, list(shape)] for block, spec in nets.items() for name, shape in spec]
    assert (len(flat), hashlib.sha256(json.dumps(flat).encode()).hexdigest()[:16]) == specs
    assert cell.arch.expected_launches(cell, 3) == launches
    cond, uncond = cell.arch.conditioning(cell, SEED, "cpu")
    assert uncond["ref_concat"] is cond["ref_concat"]
    drawn = (cond["crossattn"], uncond["crossattn"], cond["ref_concat"],
             cond["concat_smpl_render"], cond["image_clip_features"],
             cell.arch.noise(cell, SEED, 1, "cpu"))
    assert tuple(_digest(t) for t in drawn) == INPUTS
    assert cell.arch.step_sigmas(cell, 0)[0] == 1.0


# Runs in a copy of the checkout, from its root, as the benchmark's command does.
TOY_RUN = r"""
import json, sys
from pathlib import Path
import torch
from portbench import harness, manifest

root = Path.cwd()
assert manifest.ROOT == root, (manifest.ROOT, root)
cell = manifest.load_cell("sample-toy-grid", root)
out = {"arch": cell.arch.__file__, "per_layer": [m["name"] for m in cell.per_layer],
       "end_to_end": [m["name"] for m in cell.end_to_end]}
for name, seconds in (("sound", 0.0), ("sound_long", 0.2)):
    r = harness.run_cell(cell, 2 ** 35 + 11, seconds, device="cpu")
    out[name] = {"correct": r["correct"], "attempted": r["attempted"],
                 "compared": {k: v["value"] for k, v in r["compared"].items()}}
readers = manifest.metric_readers(cell)
out["readers"] = {n: m.read(harness.Readings(steps=1, step_s=0.25, work=cell.arch.step_work(cell),
                                             trace=None, forward_gaps_ms=[]))
                  for n, m in readers.items()}
real = cell.arch.EulerSampler.step
cell.arch.EulerSampler.step = lambda self, call, x, state, s, ns: (
    (lambda y: (y[0] * (1 + 1e-3), y[1]))(real(self, call, x, state, s, ns)))
out["perturbed"] = harness.run_cell(cell, 2 ** 35 + 11, 0.0, device="cpu")["correct"]
cell.arch.EulerSampler.step = real
load = cell.arch.load_weights


def swapped(engine, cell, seed):  # the program runs each expert where the other belongs
    nets = load(engine, cell, seed)
    engine.experts = {"high": engine.experts["low"], "low": engine.experts["high"]}
    return nets


cell.arch.load_weights = swapped
out["swapped"] = harness.run_cell(cell, 2 ** 35 + 11, 0.0, device="cpu")["correct"]
print(json.dumps(out))
"""


def _files(top):
    return {p.relative_to(top): p for p in top.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_an_architecture_added_by_files_alone(tmp_path):
    """A copy of BENCHMARK.json and portbench/ takes a configuration of
    another architecture (two networks chosen by sigma, an EDM-style step)
    through new files and entries only, and runs it through load_cell and
    run_cell: correct, within 1e-5 of its reference, and not correct where
    the program's step is perturbed or its experts swapped."""
    src = manifest.ROOT
    shutil.copy(src / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(src / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copied = _files(tmp_path / "portbench")
    for rel, path in _files(TOY).items():
        if rel.name == "benchmark_entries.json":
            continue
        dest = tmp_path / "portbench" / rel
        assert not dest.exists(), f"{rel} would edit a file of the benchmark"
        shutil.copy(path, dest)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entries in json.loads((TOY / "benchmark_entries.json").read_text()).items():
        bench[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))

    env = dict(os.environ, PYTHONPATH=str(src))  # the port; portbench from the copy
    run = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])

    assert out["arch"] == str(tmp_path / "portbench" / "arch" / "toy_two_expert.py")
    assert out["end_to_end"] == ["denoise_step_s", "setup_s"]
    assert out["per_layer"] == ["toy_step_ms.sample"]
    assert out["readers"] == {"toy_step_ms.sample": 250.0}
    for name in ("sound", "sound_long"):
        got = out[name]
        assert got["correct"] is True, got
        assert got["compared"]["rel_l2"] < 1e-5 and got["compared"]["worst_frame_rel_l2"] < 1e-5
        assert {k: v for k, v in got["compared"].items() if "rel_l2" not in k} == {
            "start_mismatch": 0, "chain_breaks": 0, "schedule_mismatch": 0, "launch_gap": 0}
    assert out["sound"]["attempted"] == 1 and out["sound_long"]["attempted"] > 2
    assert out["perturbed"] is False and out["swapped"] is False
    for rel, path in copied.items():
        assert path.read_bytes() == (src / "portbench" / rel).read_bytes(), rel


def test_forward_marks_refuse_nested_networks(monkeypatch):
    """A hooked network that runs inside another would put the forwards'
    start and end events out of step: it raises rather than read wrong."""
    from portbench import harness

    monkeypatch.setattr(harness.ForwardMarks, "_event", lambda self, into: into.append(None))
    window = harness.Window(1.0, lambda: None, lambda: None)
    monkeypatch.setattr(harness.Window, "open", property(lambda self: True))
    inner = torch.nn.Linear(2, 2)
    outer = torch.nn.Sequential(inner)
    side = torch.nn.Linear(2, 2)
    marks = harness.ForwardMarks([outer, side], window)
    x = torch.zeros(1, 2)
    side(outer(x))
    assert (len(marks.starts), len(marks.ends)) == (2, 2)
    marks.stop()
    marks = harness.ForwardMarks([outer, inner], window)
    with pytest.raises(RuntimeError, match="started inside"):
        outer(x)
    marks.stop()
