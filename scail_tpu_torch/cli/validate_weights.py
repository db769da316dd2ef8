"""The STA quality gate on PyTorch (counterpart of scripts/validate_weights.py).

One command runs the acceptance chain of a set of weights:
  1. sample   every example case with dense attention (cli/sample_video)
  2. sample   the same cases with --attn-impl sta (sliding-tile attention)
  3. eval     FVD(GT, dense), FVD(GT, sta) (cli/calculate_fvd) and the CLIP
              score of the dense clips' middle frames against the prompts
              (cli/eval_clip_score)
  4. gate     if FVD_sta <= max(FVD_dense * --sta-tol, FVD_dense + 5) STA is
              validated: <weights>/sta_validated.json is written, which makes
              'sta' the sampling CLI's default attn_impl for that --load
              directory (cli/arguments.py).
and prints a JSON report as its last line.

Differences from the JAX script, each deliberate:
- No convert stage.  The port reads the released files itself, so --weights
  goes to the sampling CLI as --load, and the marker is written into that
  directory, where the CLI looks for it.  The dense pass names
  --attn-impl auto, so that a marker from an earlier validation does not
  turn it into a second STA pass.
- The stages run in this process, through each CLI's main(argv); their
  printed tail lines are read as the JAX script reads its subprocesses'.
  (The JAX reason for subprocesses, one process at a time on the TPU, does
  not hold here.)  Each stage's engine or extractor is freed before the
  next.  A stage that raises prints its traceback and counts as rc 1, as a
  failed subprocess does in the JAX script: a failed sampling pass ends the
  run with exit code 1, a failed eval leaves its value None and the gate
  closed.
- --device (default cuda) goes to every stage; nothing defaults to the CPU.
- Middle frames are read with the port's load_video_frames (OpenCV /
  Pillow, no imageio).
- --sample-extra takes the rest of the command line, flags included, so it
  comes last.  The JAX script's nargs='*' list ends at the first token that
  starts with '--', so it cannot forward a flag such as --image-size.

--smoke keeps the JAX meaning: the 1.3B YAML in place of the default 14B
one, 2 sampling steps, --image-size 64 64 --sampling-num-frames 5; without
--weights every model is random.

Usage:
  python -m scail_tpu_torch.cli.validate_weights --weights SCAIL-Preview/model \\
      --examples examples/ --out runs/validate --i3d i3d_pretrained_400.pt \\
      --clip-weights CLIP-ViT-g-14.bin
  python -m scail_tpu_torch.cli.validate_weights --smoke --out /tmp/validate \\
      [--sample-extra --image-size 128 128 --sampling-num-frames 9]

(At the smoke geometry, 64 x 64 and 5 frames, the sliding tiles (3, 8) do not
divide the latent (2 frames, 4 rows of patches) and the STA pass runs dense
attention, as the JAX DiT does; 128 x 128 and 9 frames give 3 frames and 8
rows.)
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import io
import json
import os
import shutil
import sys
import traceback

import numpy as np


def find_cases(examples_dir):
    """Example dirs with a ref image + rendered pose video (the CLI's
    input contract); prompt from <case>/prompt.txt else a default."""
    cases = []
    for d in sorted(glob.glob(os.path.join(examples_dir, "*"))):
        if not os.path.isdir(d):
            continue
        has_ref = any(glob.glob(os.path.join(d, p)) for p in ("ref.*", "ref_image.*"))
        has_pose = any(glob.glob(os.path.join(d, p))
                       for p in ("rendered*.mp4", "rendered*.gif", "rendered*.npz",
                                 "rendered*.npy"))
        if has_ref and has_pose:
            pf = os.path.join(d, "prompt.txt")
            if os.path.isfile(pf):
                with open(pf) as f:
                    prompt = f.read().strip()
            else:
                prompt = "a person dancing, high quality video"
            cases.append((d, prompt))
    return cases


def write_prompt_file(cases, path):
    with open(path, "w") as f:
        for d, prompt in cases:
            f.write(f"{prompt}@@{d}\n")


def collect_outputs(sample_out_dir, dst):
    """Flatten <out>/<case>/<case>_output_*.mp4 into one dir for FVD."""
    os.makedirs(dst, exist_ok=True)
    n = 0
    for f in sorted(glob.glob(os.path.join(sample_out_dir, "*", "*output*"))):
        if f.endswith((".mp4", ".gif")):
            shutil.copy(f, os.path.join(dst, f"{n:04d}_" + os.path.basename(f)))
            n += 1
    return n


def collect_gt(cases, dst):
    os.makedirs(dst, exist_ok=True)
    n = 0
    for d, _ in cases:
        for f in sorted(glob.glob(os.path.join(d, "GT.*"))):
            if f.endswith((".mp4", ".gif")):
                shutil.copy(f, os.path.join(dst, f"{n:04d}_" + os.path.basename(f)))
                n += 1
    return n


def extract_middle_frames(video_dir, dst):
    """The middle frame of each video as a PNG (the CLIP-score stage scores
    image directories, as the reference's frame-dump workflow does)."""
    from PIL import Image

    from scail_tpu_torch.data.video import load_video_frames

    os.makedirs(dst, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(video_dir)):
        if not f.endswith((".mp4", ".gif")):
            continue
        frames, _ = load_video_frames(os.path.join(video_dir, f))
        Image.fromarray(np.asarray(frames[len(frames) // 2])[..., :3]).save(
            os.path.join(dst, f + ".png"))
        n += 1
    return n


def parse_tail_float(text, prefix):
    """Last 'prefix: <float>' line in text."""
    val = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(prefix):
            try:
                val = float(line[len(prefix):].split()[0])
            except ValueError:
                pass
    return val


def sta_gate(fvd_dense, fvd_sta, tol):
    """STA is validated when its FVD is within tol of dense (both vs GT).
    tol is multiplicative on the dense score with an absolute floor of
    +5.0 FVD for near-zero dense scores."""
    if fvd_dense is None or fvd_sta is None:
        return False
    return fvd_sta <= max(fvd_dense * tol, fvd_dense + 5.0)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_stage(name, main, argv):
    """main(argv) in this process -> (rc, printed text, return value).  A
    stage that raises gets rc 1 and its traceback on stderr; its memory is
    released before the next stage."""
    print(f"+ {name} " + " ".join(argv), flush=True)
    tee = _Tee(sys.stdout)
    rc, value = 0, None
    try:
        with contextlib.redirect_stdout(tee):
            value = main(argv)
    except Exception:  # the report names the failed stage; the run fails
        traceback.print_exc()
        rc = 1
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rc, tee.buf.getvalue(), value


def main(argv=None):
    from scail_tpu_torch.cli import calculate_fvd, eval_clip_score, sample_video

    ap = argparse.ArgumentParser("validate_weights")
    ap.add_argument("--weights", default=None,
                    help="the released checkpoint dir (SAT layout, as sample_video --load "
                         "reads it); the marker is written here; omit for random weights")
    ap.add_argument("--model-yaml", default="configs/video_model/scail_14b.yaml")
    ap.add_argument("--sampling-yaml", default="configs/sampling/pose_cli.yaml")
    ap.add_argument("--examples", default="examples_synth")
    ap.add_argument("--out", default="runs/validate")
    ap.add_argument("--i3d", default=None, help="i3d_pretrained_400.pt")
    ap.add_argument("--clip-weights", default=None,
                    help="CLIP weights for the CLIP score (HF or open_clip layout)")
    ap.add_argument("--sta-tol", type=float, default=1.10,
                    help="STA passes if FVD_sta <= FVD_dense * tol")
    ap.add_argument("--smoke", action="store_true",
                    help="the 1.3B YAML, tiny geometry, 2 steps")
    ap.add_argument("--sample-extra", nargs=argparse.REMAINDER, default=[],
                    help="the rest of the command line goes to the sampling CLI (give it "
                         "last), e.g. --sample-extra --image-size 128 128")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage; 'cuda' raises when CUDA is not "
                         "available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.engine import resolve_device

    resolve_device(args.device)
    if args.smoke and args.model_yaml == "configs/video_model/scail_14b.yaml":
        # a smoke run at 14B takes long; the 1.3B config runs the same path
        args.model_yaml = "configs/video_model/scail_1p3b.yaml"
    os.makedirs(args.out, exist_ok=True)
    report = {"stages": {}}
    if not args.weights:
        print("[validate] no --weights: random-init smoke mode", flush=True)

    # ---- sample dense, then sta -------------------------------------------
    cases = find_cases(args.examples)
    if not cases:
        print(f"[validate] no example cases under {args.examples}", file=sys.stderr)
        print(json.dumps(report))
        return 1
    prompts_path = os.path.join(args.out, "prompts.txt")
    write_prompt_file(cases, prompts_path)
    base = ["--base", args.model_yaml, args.sampling_yaml, "--input-type", "txt",
            "--input-file", prompts_path, "--device", args.device]
    if args.weights:
        base += ["--load", args.weights]
    if args.smoke:
        base += ["--sampling-steps", "2", "--image-size", "64", "64",
                 "--sampling-num-frames", "5"]
    base += list(args.sample_extra)

    results = {}
    for mode, impl in (("dense", "auto"), ("sta", "sta")):
        out_dir = os.path.join(args.out, f"samples_{mode}")
        rc, _, _ = run_stage("sample_video", sample_video.main,
                             base + ["--output-dir", out_dir, "--attn-impl", impl])
        n = collect_outputs(out_dir, os.path.join(args.out, f"flat_{mode}"))
        report["stages"][f"sample_{mode}"] = {"rc": rc, "videos": n}
        if rc != 0 or n == 0:
            print(json.dumps(report))
            return 1
        results[mode] = os.path.join(args.out, f"flat_{mode}")

    # ---- eval ---------------------------------------------------------------
    gt_dir = os.path.join(args.out, "flat_gt")
    report["stages"]["gt_videos"] = collect_gt(cases, gt_dir)
    fvd = {}
    for mode in ("dense", "sta"):
        cmd = ["--real", gt_dir, "--fake", results[mode], "--device", args.device]
        if args.i3d:
            cmd += ["--i3d", args.i3d]
        rc, text, _ = run_stage("calculate_fvd", calculate_fvd.main, cmd)
        fvd[mode] = parse_tail_float(text, "FVD:")
        report["stages"][f"fvd_{mode}"] = {"rc": rc, "value": fvd[mode]}

    img_dir = os.path.join(args.out, "frames_dense")
    clip_score = None
    if extract_middle_frames(results["dense"], img_dir):
        pf = os.path.join(args.out, "clip_prompts.txt")
        with open(pf, "w") as f:
            for _, prompt in cases:
                f.write(prompt + "\n")
        cmd = ["--images", img_dir, "--prompts", pf, "--device", args.device]
        if args.clip_weights:
            cmd += ["--clip-weights", args.clip_weights]
        rc, text, _ = run_stage("eval_clip_score", eval_clip_score.main, cmd)
        clip_score = parse_tail_float(text, "CLIP score:")
        report["stages"]["clip_score"] = {"rc": rc, "value": clip_score}

    # ---- the STA gate ---------------------------------------------------------
    validated = sta_gate(fvd["dense"], fvd["sta"], args.sta_tol)
    report.update(fvd_dense=fvd["dense"], fvd_sta=fvd["sta"], clip_score=clip_score,
                  sta_validated=bool(validated), smoke=bool(args.smoke or not args.weights))
    if validated and args.weights:
        marker = os.path.join(args.weights, "sta_validated.json")
        with open(marker, "w") as f:
            json.dump({"validated": True, "fvd_dense": fvd["dense"], "fvd_sta": fvd["sta"],
                       "sta_tol": args.sta_tol}, f)
        report["marker"] = marker
        print(f"[validate] STA quality gate PASSED -> {marker} (the sampling CLI now "
              "defaults to attn_impl='sta' for this checkpoint)")
    elif validated:
        print("[validate] STA gate passed (no --weights: no marker written)")
    else:
        print(f"[validate] STA gate NOT passed (dense={fvd['dense']}, sta={fvd['sta']}); "
              "dense stays the default")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
