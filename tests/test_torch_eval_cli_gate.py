"""The port's eval_fid and validate_weights CLIs (scail_tpu_torch/cli/
{eval_fid, validate_weights}.py) against the JAX package's eval/eval_fid.py
and scripts/validate_weights.py, on the CPU with --device cpu: the share of
tests/test_torch_eval_cli.py's CLI runs that a second worker takes.

Both sides of eval_fid read one InceptionV3 file written from the port's
random module.  Tolerance: 2e-4 relative (features, scores), bit-equal for
the gate's host helpers.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

from test_torch_eval_cli import ROOT, TESTS, TOL, _jax_script, _rel, _run_jax_cli, _tail


# ---------------------------------------------------------------------------
# FID: the same weights file on both sides
# ---------------------------------------------------------------------------
def test_eval_fid_ref_and_calc_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    from PIL import Image

    from scail_tpu_torch.cli import eval_fid
    from scail_tpu_torch.evals.inception import FIDInceptionV3

    rng = np.random.default_rng(1)
    for name in ("ref", "gen"):
        os.makedirs(tmp_path / name)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(
                tmp_path / name / f"{i}.png")
    det = str(tmp_path / "pt_inception-2015-12-05.pth")
    torch.save(FIDInceptionV3().init_random_(torch.Generator().manual_seed(2)).state_dict(), det)
    stats = str(tmp_path / "ref.npz")
    feats = eval_fid.main(["ref", "--images", str(tmp_path / "ref"), "--stats", stats,
                           "--detector", det, "--device", "cpu"])
    assert feats.shape == (3, 2048)
    assert capsys.readouterr().out.splitlines()[-1] == f"saved stats -> {stats}"
    got = eval_fid.main(["calc", "--images", str(tmp_path / "gen"), "--stats", stats,
                         "--detector", det, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == f"FID: {got:.4f}"
    jstats = str(tmp_path / "jax_ref.npz")
    _run_jax_cli("eval/eval_fid.py", ["ref", "--images", str(tmp_path / "ref"), "--stats",
                                      jstats, "--detector", det], monkeypatch, capsys)
    for key in ("mu", "sigma"):
        a, b = np.load(stats)[key], np.load(jstats)[key]
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < TOL
    want = _tail(_run_jax_cli("eval/eval_fid.py", ["calc", "--images", str(tmp_path / "gen"),
                                                   "--stats", jstats, "--detector", det],
                              monkeypatch, capsys), "FID:")
    assert np.isfinite(got) and _rel(round(got, 4), want) < TOL


# ---------------------------------------------------------------------------
# validate_weights
# ---------------------------------------------------------------------------
def _make_case(d, prompt=None, gt="GT.gif"):
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "ref.png"), "wb").write(b"x")
    open(os.path.join(d, "rendered.gif"), "wb").write(b"x")
    open(os.path.join(d, gt), "wb").write(b"x")
    if prompt:
        open(os.path.join(d, "prompt.txt"), "w").write(prompt)


def test_validate_weights_host_helpers_match_the_jax_script(tmp_path):
    from scail_tpu_torch.cli import validate_weights as tv

    jv = _jax_script("scripts/validate_weights.py")
    ex = tmp_path / "ex"
    _make_case(str(ex / "001"), "a dancer")
    _make_case(str(ex / "002"), gt="GT.mp4")
    _make_case(str(ex / "003"), gt="GT.npz")
    os.makedirs(ex / "incomplete")
    (ex / "file.txt").write_text("x")
    cases = tv.find_cases(str(ex))
    assert cases == jv.find_cases(str(ex)) and len(cases) == 3
    tv.write_prompt_file(cases, str(tmp_path / "p1.txt"))
    jv.write_prompt_file(cases, str(tmp_path / "p2.txt"))
    assert (tmp_path / "p1.txt").read_text() == (tmp_path / "p2.txt").read_text()
    for case in ("001", "002"):
        os.makedirs(tmp_path / "samples" / case)
        for f in (f"{case}_output_000000.mp4", f"{case}_inputs.png", f"{case}_output.gif"):
            (tmp_path / "samples" / case / f).write_bytes(b"v")
    for fn, arg in (("collect_outputs", str(tmp_path / "samples")), ("collect_gt", cases)):
        n1 = getattr(tv, fn)(arg, str(tmp_path / f"{fn}_port"))
        n2 = getattr(jv, fn)(arg, str(tmp_path / f"{fn}_jax"))
        assert n1 == n2 and sorted(os.listdir(tmp_path / f"{fn}_port")) == \
            sorted(os.listdir(tmp_path / f"{fn}_jax"))
    text = "noise\nFVD: 123.456\nmore\nFVD: 99.5 (final)\nFVD: nope\n"
    for prefix in ("FVD:", "CLIP score:"):
        assert tv.parse_tail_float(text, prefix) == jv.parse_tail_float(text, prefix)
    for dense, sta in ((100.0, 105.0), (100.0, 125.0), (1.0, 5.9), (1.0, 6.1), (None, 50.0),
                       (50.0, None), (0.0, 0.0)):
        assert tv.sta_gate(dense, sta, 1.10) == jv.sta_gate(dense, sta, 1.10)


def test_validate_weights_smoke_writes_the_marker_the_cli_reads(tmp_path, monkeypatch):
    """--smoke --device cpu on the toy geometry with --weights: both sampling
    passes, FVD of each against GT, the CLIP score, the gate; the marker
    lands in the --weights directory and makes the sampling CLI default to
    attn_impl 'sta' there.  A second run names --attn-impl auto for its
    dense pass, so the marker does not turn it into STA."""
    import functools

    import yaml

    import scail_tpu_torch.models.clip_vit as tclip
    import scail_tpu_torch.models.umt5 as tt5
    import scail_tpu_torch.models.wan_vae as tvae
    from scail_tpu_torch.cli import sample_video, validate_weights
    from scail_tpu_torch.cli.arguments import get_args

    sys.path.insert(0, TESTS)
    from test_torch_checkpoint_load import TOY_CLIP, TOY_T5, TOY_VAE, _toy_files, _toy_yaml

    monkeypatch.setattr(tt5, "UMT5Config", functools.partial(tt5.UMT5Config, **TOY_T5))
    monkeypatch.setattr(tclip, "ClipVisionConfig",
                        functools.partial(tclip.ClipVisionConfig, **TOY_CLIP))
    monkeypatch.setattr(tvae, "WanVAEConfig", functools.partial(tvae.WanVAEConfig, **TOY_VAE))
    files, _ = _toy_files(str(tmp_path / "files"))
    model_yaml = _toy_yaml(tmp_path, files, {"bf16": False})
    sampling_yaml = tmp_path / "sampling.yaml"
    sampling_yaml.write_text(yaml.safe_dump({"args": {"sampling_fps": 16}}))
    ex = tmp_path / "examples"
    shutil.copytree(os.path.join(ROOT, "examples_synth", "001"), str(ex / "001"))
    impls = []
    real_main = sample_video.main

    def main(argv):
        impls.append(get_args(argv)[1]["network_config"]["params"]["attn_impl"])
        return real_main(argv)

    monkeypatch.setattr(sample_video, "main", main)
    argv = ["--smoke", "--device", "cpu", "--weights", files["ckpt"], "--model-yaml",
            model_yaml, "--sampling-yaml", str(sampling_yaml), "--examples", str(ex),
            # the gate passes whatever FVDs the random weights give: this test
            # holds the marker's path, not the gate's rule (sta_gate above)
            "--sta-tol", "1e6"]
    # sliding tiles (3, 8) divide 3 latent frames x 8 patch rows, so the STA
    # pass runs STA (at the smoke geometry, 64 x 64 and 5 frames, it is dense)
    extra = ["--sample-extra", "--image-size", "128", "128", "--sampling-num-frames", "9"]
    rc, text, value = validate_weights.run_stage(
        "validate_weights", validate_weights.main, argv + ["--out", str(tmp_path / "v1")] + extra)
    assert rc == 0 and value == 0, text[-3000:]
    report = json.loads(text.strip().splitlines()[-1])
    assert report["stages"]["sample_dense"] == {"rc": 0, "videos": 1}
    assert report["stages"]["sample_sta"] == {"rc": 0, "videos": 1}
    assert report["stages"]["gt_videos"] == 1
    for key in ("fvd_dense", "fvd_sta", "clip_score"):
        assert np.isfinite(report[key]), key
    assert report["stages"]["fvd_dense"]["rc"] == 0 and report["stages"]["clip_score"]["rc"] == 0
    assert report["fvd_dense"] != report["fvd_sta"]
    assert report["sta_validated"] is True and report["smoke"] is True
    marker = os.path.join(files["ckpt"], "sta_validated.json")
    assert report["marker"] == marker
    assert json.load(open(marker))["fvd_sta"] == report["fvd_sta"]
    _, mc = get_args(["--base", model_yaml, "--load", files["ckpt"]])
    assert mc["network_config"]["params"]["attn_impl"] == "sta"
    assert impls == ["auto", "sta"]
    # the dense pass stays dense once the marker exists
    rc, text, _ = validate_weights.run_stage(
        "validate_weights", validate_weights.main, argv + ["--out", str(tmp_path / "v2")] + extra)
    assert rc == 0 and impls == ["auto", "sta", "auto", "sta"]
    again = json.loads(text.strip().splitlines()[-1])
    assert again["fvd_dense"] == report["fvd_dense"] and again["fvd_sta"] == report["fvd_sta"]
