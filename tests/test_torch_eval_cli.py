"""The port's eval CLIs, the sharded FVD sweep and the STA quality gate
(scail_tpu_torch/cli/{calculate_fvd, calculate_fvd_sweep, eval_fid,
eval_clip_score, eval_aes, eval_hps, validate_weights}.py, evals/sweep.py)
against the JAX package's eval/*.py and scripts/validate_weights.py, on the
CPU with --device cpu.

Both sides read the same weights: a file written from a random port module
(the JAX CLIs' --i3d / --detector), or the port's random CLIP towers handed
to the JAX scorer through its converter.  The sweep runs in a gloo world of
2 processes, which import this module: it therefore imports no jax at its
top.  Tolerance: 2e-4 relative (features, scores).  eval_fid and
validate_weights are held in tests/test_torch_eval_cli_gate.py.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
TOL = 2e-4
CLIS = ("calculate_fvd", "calculate_fvd_sweep", "eval_fid", "eval_clip_score", "eval_aes",
        "eval_hps", "validate_weights")


def _jax_script(path):
    """A JAX CLI script (eval/*.py, scripts/*.py) as a module."""
    name = "jax_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_cli(path, argv, monkeypatch, capsys):
    """main() of a JAX CLI on the CPU; returns its printed lines."""
    mod = _jax_script(path)
    monkeypatch.setattr(sys, "argv", [path] + argv + ["--platform", "cpu"])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _tail(text, prefix):
    return float([ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
                 [len(prefix):].split()[0])


def _write_clips(d, rng, n, shape=(4, 32, 32, 3)):
    os.makedirs(d, exist_ok=True)
    clips = []
    for i in range(n):
        frames = rng.integers(0, 255, shape, dtype=np.uint8)
        np.savez(os.path.join(d, f"{i}.npz"), frames=frames)
        clips.append(frames)
    return clips


def _i3d_file(path, seed=0):
    from scail_tpu_torch.evals.i3d import InceptionI3d

    torch.save(InceptionI3d().init_random_(torch.Generator().manual_seed(seed)).state_dict(),
               path)
    return path


def _rel(got, want):
    return abs(got - want) / abs(want)


# ---------------------------------------------------------------------------
# every CLI: --device cuda without CUDA raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cli", CLIS)
def test_cli_device_cuda_without_cuda_raises(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    import importlib

    main = importlib.import_module(f"scail_tpu_torch.cli.{cli}").main
    d = str(tmp_path)
    argv = {"calculate_fvd": ["--real", d, "--fake", d],
            "calculate_fvd_sweep": ["--real_video_dir", d, "--generated_video_dir", d],
            "eval_fid": ["ref", "--images", d, "--stats", d + "/s.npz"],
            "eval_clip_score": ["--images", d, "--prompts", d + "/p.txt"],
            "eval_aes": ["--images", d],
            "eval_hps": ["--images", d, "--prompts", d + "/p.txt"],
            "validate_weights": ["--smoke", "--out", d]}[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv + ["--device", "cuda"])
    assert main.__module__ == f"scail_tpu_torch.cli.{cli}"


# ---------------------------------------------------------------------------
# FVD: the same weights file on both sides (FID and the STA gate are in
# tests/test_torch_eval_cli_gate.py, so that two workers share the CLIs)
# ---------------------------------------------------------------------------
def test_calculate_fvd_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    from scail_tpu_torch.cli import calculate_fvd

    rng = np.random.default_rng(0)
    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    _write_clips(real, rng, 2, (4, 24, 24, 3))
    _write_clips(fake, rng, 2, (4, 24, 24, 3))
    i3d = _i3d_file(str(tmp_path / "i3d.pt"))
    argv = ["--real", real, "--fake", fake, "--i3d", i3d]
    got = calculate_fvd.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == f"FVD: {got:.3f}"
    want = _tail(_run_jax_cli("eval/calculate_fvd.py", argv, monkeypatch, capsys), "FVD:")
    assert np.isfinite(got) and _rel(round(got, 3), want) < TOL
    # a directory against itself: equal features, a distance of 0 up to sqrtm's error
    assert abs(calculate_fvd.main(["--real", real, "--fake", real, "--i3d", i3d,
                                   "--device", "cpu"])) < 1e-6


# ---------------------------------------------------------------------------
# CLIP score, aesthetic, HPS in smoke mode: the port's random towers in both
# ---------------------------------------------------------------------------
@pytest.fixture
def shared_clip(monkeypatch):
    """The JAX smoke scorer takes the port's random towers (through its HF
    converter) and the port's crc32 ids, so both CLIs score one model."""
    import scail_tpu.models.clip_score as jcs
    from scail_tpu.evals.clip_score import JaxClipScorer

    from scail_tpu_torch.evals.clip_score import hash_token_ids
    from scail_tpu_torch.models.clip_score import ClipScoreConfig, ClipScoreModel

    def init_clip_params(key, cfg):
        port_cfg = ClipScoreConfig(**{f: getattr(cfg, f) for f in
                                      ClipScoreConfig.__dataclass_fields__})
        model = ClipScoreModel(port_cfg).init_random_(torch.Generator().manual_seed(0))
        return jcs.clip_params_from_hf_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, cfg)

    monkeypatch.setattr(jcs, "init_clip_params", init_clip_params)
    monkeypatch.setattr(JaxClipScorer, "tokenize",
                        lambda self, texts: hash_token_ids(texts, self.cfg).astype(np.int32))


def _images_and_prompts(tmp_path, n=3):
    from PIL import Image

    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "images")
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (48 + 8 * i, 64, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"{i:02d}.png")
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(["a dancer", "a red car on a road", "two cats"][:n]) + "\n")
    return str(tmp_path / "images"), str(prompts)


@pytest.mark.parametrize("cli, prefix", [("eval_clip_score", "CLIP score:"),
                                         ("eval_hps", "Average HPS:"),
                                         ("eval_aes", "Average aesthetic score:")])
def test_clip_clis_match_the_jax_clis(cli, prefix, tmp_path, monkeypatch, capsys, shared_clip):
    import importlib

    images, prompts = _images_and_prompts(tmp_path)
    argv = ["--images", images] + ([] if cli == "eval_aes" else ["--prompts", prompts])
    got = importlib.import_module(f"scail_tpu_torch.cli.{cli}").main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()[-1]
    assert out.startswith(prefix) and np.isfinite(got)
    assert _tail(out, prefix) == float(f"{got:.6f}" if cli == "eval_hps" else f"{got:.4f}")
    want = _tail(_run_jax_cli(f"eval/{cli}.py", argv, monkeypatch, capsys), prefix)
    assert abs(_tail(out, prefix) - want) <= TOL * abs(want) + (1e-6 if cli == "eval_hps"
                                                                 else 1e-4)


# ---------------------------------------------------------------------------
# the sharded sweep: a gloo world of 2 against JAX's fvd_sweep
# ---------------------------------------------------------------------------
SWEEP = dict(num_frames=4, resolution=32, crop_size=32, batch=4, i3d_size=64)


def _sweep_worker(inputs):
    """A rank of the world: the gathered features and the FVD with all 4
    pairs (2 a rank), 3 (2 and 1) and 1 (rank 1 holds none)."""
    from scail_tpu_torch.evals.sweep import fvd_sweep, sweep_features

    out = {}
    for n in (None, 3, 1):
        kw = dict(SWEEP, i3d_path=inputs["i3d"], max_videos=n, device="cpu")
        out[n] = {"features": sweep_features(inputs["real"], inputs["fake"], **kw),
                  "fvd": fvd_sweep(inputs["real"], inputs["fake"], **kw)}
    return out


def test_fvd_sweep_on_two_ranks_matches_jax(tmp_path):
    sys.path.insert(0, TESTS)
    from test_torch_parallel import collect_world, spawn_world

    from scail_tpu.evals.fvd import I3DFeatureExtractor as JaxI3D
    from scail_tpu.evals.sweep import _load_clip as jax_load_clip
    from scail_tpu.evals.sweep import fvd_sweep as jax_sweep

    rng = np.random.default_rng(4)
    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    _write_clips(real, rng, 4)
    _write_clips(fake, rng, 3)
    _write_clips(fake + "_short", rng, 1, (2, 32, 32, 3))  # a 2-frame clip: padded to 4
    shutil.move(os.path.join(fake + "_short", "0.npz"), os.path.join(fake, "3.npz"))
    i3d = _i3d_file(str(tmp_path / "i3d.pt"), seed=5)
    inputs = {"real": real, "fake": fake, "i3d": i3d}
    workdir = str(tmp_path / "world")
    os.makedirs(workdir)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    procs = spawn_world("test_torch_eval_cli", "_sweep_worker", 2, workdir)

    jext = JaxI3D(i3d, batch=4, size=64)
    want = {}
    for n, order in ((None, [0, 2, 1, 3]), (3, [0, 2, 1]), (1, [0])):
        fr, ff = ([jax_load_clip(os.path.join(d, f"{i}.npz"), 4, 1, 32, 32) for i in order]
                  for d in (real, fake))
        want[n] = {"features": (jext(np.stack(fr)), jext(np.stack(ff))),
                   "fvd": jax_sweep(real, fake, i3d_path=i3d, max_videos=n, **SWEEP)}
    ranks = collect_world(procs, workdir)
    for n in (None, 3, 1):
        assert ranks[0][n]["fvd"] == ranks[1][n]["fvd"]
        for r in ranks:
            for got, ref in zip(r[n]["features"], want[n]["features"]):
                assert got.shape == ref.shape
                assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < TOL
        assert np.isfinite(ranks[0][n]["fvd"])
        assert _rel(ranks[0][n]["fvd"], want[n]["fvd"]) < TOL


def test_calculate_fvd_sweep_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """One process (no WORLD_SIZE): the whole list on this rank."""
    from scail_tpu_torch.cli import calculate_fvd_sweep

    rng = np.random.default_rng(7)
    real, fake = str(tmp_path / "real"), str(tmp_path / "fake")
    _write_clips(real, rng, 3)
    _write_clips(fake, rng, 3)
    argv = ["--real_video_dir", real, "--generated_video_dir", fake, "--num_frames", "4",
            "--resolution", "32", "--crop_size", "32", "--batch", "2",
            "--i3d", _i3d_file(str(tmp_path / "i3d.pt"), seed=8)]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    got = calculate_fvd_sweep.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == f"FVD: {got:.3f}"
    want = _tail(_run_jax_cli("eval/calculate_fvd_sweep.py", argv, monkeypatch, capsys), "FVD:")
    assert np.isfinite(got) and _rel(round(got, 3), want) < TOL


def test_sweep_host_helpers_match_jax(tmp_path):
    from scail_tpu.evals import sweep as js

    from scail_tpu_torch.evals import sweep as ts

    frames = np.arange(20 * 8 * 12 * 3, dtype=np.float32).reshape(20, 8, 12, 3)
    for num, rate, n in ((5, 2, 20), (5, 2, 6), (16, 1, 3)):
        np.testing.assert_array_equal(ts.sample_frames(frames[:n], num, rate),
                                      js.sample_frames(frames[:n], num, rate))
    np.testing.assert_array_equal(ts.center_crop(frames, 6), js.center_crop(frames, 6))
    for size, src in ((4, frames), (5, frames.transpose(0, 2, 1, 3))):
        np.testing.assert_allclose(ts.short_side_scale(src / 255.0, size),
                                   js.short_side_scale(src / 255.0, size), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(6)
    _write_clips(str(tmp_path / "a"), rng, 3)
    _write_clips(str(tmp_path / "b"), rng, 3)
    (tmp_path / "a" / ".hidden.npz").write_bytes(b"")
    (tmp_path / "a" / "notes.txt").write_text("x")
    assert ts.paired_video_files(str(tmp_path / "a"), str(tmp_path / "b")) == \
        js.paired_video_files(str(tmp_path / "a"), str(tmp_path / "b"))
    _write_clips(str(tmp_path / "c"), rng, 2)
    with pytest.raises(ValueError, match="2 generated"):
        ts.paired_video_files(str(tmp_path / "a"), str(tmp_path / "c"))


def test_chip_smoke_defines_each_name_once():
    """chip_smoke.py holds every phase's helpers in one module, where a
    helper that reuses an earlier phase's name silently replaces it (a
    second `_held` would replace phase 9's and fail that phase on the card),
    so every top-level function and constant has one definition."""
    import ast
    from collections import Counter

    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name)]
    assert "phase_evals" in names and "phase_load" in names
    assert [n for n, c in Counter(names).items() if c > 1] == []

