#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scail_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is swallowed):
  1. device   -- CUDA required; card name and power limit from nvidia-smi;
                 TF32 off for matmuls and cuDNN convolutions.
  2. build    -- compile the hand-written CUDA kernels from csrc/ (nvcc, sm_90a).
  3. kernels  -- each kernel against its plain PyTorch version on the card, at a
                 ragged small shape and at the DiT's main-path shapes (48,832
                 tokens, 2 x 12 heads), within limits scaled to the plain
                 output (ops/attention.py, error_vs_plain); times of kernel
                 and plain version.
  4. DiT      -- the 1.3B DiT, all 30 layers, random bf16 weights, CFG batch 2 at
                 512x896/81 frames (48,832 tokens): 30 + 30 kernel launches, a
                 finite output, its time; kernel path vs plain path on a small input.
  5. CLI      -- `scail_tpu_torch.cli.sample_video` with the 1.3B YAMLs, 2 steps,
                 two requests (examples_synth/001, and an 81-frame 512x896
                 synthetic example); both .mp4 clips decode to the right frames.

The line before the last is {"kernels": [...]}: per kernel its launches in the
CLI run (phase 5), its largest error against the plain version, and the
kernel's and the plain version's milliseconds at the main-path shape.  The last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# kernels vs plain: the limits of scail_tpu_torch.ops.attention.error_vs_plain
# relative L2 distance of the DiT's kernel path from its plain path (bf16, 30 layers)
DIT_REL_TOL = 3e-2


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def timed_ms(fn, iters=3):
    """Mean milliseconds of fn() on the card, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, lse=False):
    """Error of a kernel result against its plain version (f32); fails past
    the limits of error_vs_plain.  Returns the max-abs error."""
    from scail_tpu_torch.ops import attention as A

    e = A.error_vs_plain(got, want, lse=lse)
    if lse:
        limits = f"limit {A.LSE_ATOL}"
    else:
        limits = (f"= {e['err_per_std']:.4f} std (limit {A.OUT_MAX_PER_STD}), "
                  f"rel L2 per head {e['rel_l2']:.3e} (limit {A.OUT_REL_L2})")
    log(f"{name}: max_abs_err {e['max_abs_err']:.3e} {limits}; mean_abs_err "
        f"{e['mean_abs_err']:.3e} {'ok' if e['ok'] else 'OUT OF TOLERANCE'}")
    if not e["ok"]:
        fail(f"{name} disagrees with its plain version")
    return e["max_abs_err"]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
        "allow_tf32 = False for matmul and cuDNN")
    return card


def phase_build():
    from scail_tpu_torch.ops import cuda_build

    info = cuda_build.build()
    cuda_build.lib()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log(f"built {os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s "
        f"(cached={info['cached']}); ptxas: {regs}")
    return info["seconds"]


def phase_kernels():
    import torch

    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.ops.rotary import apply_rotary, build_scail_rope

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def f32(*ts):
        return [t.float() for t in ts]

    results = {}
    # ragged small case: B = 2 x 2 heads, S = 150, Skv = 176
    for mode, interleaved in (("interleaved", True), ("halves", False), ("none", None)):
        q, k, v = rnd(2, 150, 2, 128), rnd(2, 176, 2, 128), rnd(2, 176, 2, 128)
        rope = None
        if interleaved is not None:
            ang = torch.randn(150, 64, generator=gen, device=dev)
            ang = ang.repeat_interleave(2, -1) if interleaved else torch.cat([ang, ang], -1)
            rope = (ang.cos(), ang.sin())
        o, lse = A.flash_attention(q, k, v, rope=rope, rope_interleaved=bool(interleaved))
        torch.cuda.synchronize()
        po, plse = A.flash_attention_plain(*f32(q, k, v), rope=rope,
                                           rope_interleaved=bool(interleaved))
        compare(f"flash rope={mode} small out", o, po)
        compare(f"flash rope={mode} small lse", lse, plse, lse=True)

    # main-path shape: 2 (CFG) x 12 heads, 48,832 tokens, real SCAIL tables
    S = 48832
    q, k, v = rnd(2, S, 12, 128), rnd(2, S, 12, 128), rnd(2, S, 12, 128)
    rows = (slice(0, 1024), slice(S - 1024, S))
    for mode, interleaved in (("interleaved", True), ("halves", False), ("none", None)):
        rope = None
        kk = k
        if interleaved is not None:
            tabs = build_scail_rope(128, 21, 32, 56, interleaved=interleaved, device=dev)
            assert tabs.cos.shape[0] == S
            rope = (tabs.cos, tabs.sin)
            kk = apply_rotary(k, tabs.cos[:, None], tabs.sin[:, None], interleaved)
        o, lse = A.flash_attention(q, kk, v, rope=rope, rope_interleaved=bool(interleaved))
        torch.cuda.synchronize()
        err = 0.0
        for sl in rows:
            r = None if rope is None else (rope[0][sl], rope[1][sl])
            po, plse = A.flash_attention_plain(q[:, sl].float(), kk.float(), v.float(),
                                               rope=r, rope_interleaved=bool(interleaved))
            tag = f"flash rope={mode} (2,{S},12,128) rows [{sl.start},{sl.stop})"
            err = max(err, compare(f"{tag} out", o[:, sl], po))
            compare(f"{tag} lse", lse[:, :, sl], plse, lse=True)
        if mode in ("interleaved", "none"):
            ms = timed_ms(lambda: A.flash_attention(q, kk, v, rope=rope,
                                                    rope_interleaved=bool(interleaved)))
            plain_ms = timed_ms(lambda: A.flash_attention_plain(
                q, kk, v, rope=rope, rope_interleaved=bool(interleaved)), iters=1)
            tflops = 4 * 24 * S * S * 128 / ms / 1e9
            log(f"flash rope={mode} main shape: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
                f"plain {plain_ms:.3f} ms")
            results["flash_attention_rope" if interleaved else "flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del kk

    # dual cross-attention: 48,832 q rows x (512 text, 257 CLIP) keys
    k1, v1, k2, v2 = rnd(2, 512, 12, 128), rnd(2, 512, 12, 128), rnd(2, 257, 12, 128), \
        rnd(2, 257, 12, 128)
    o = A.dual_cross_attention_fused(q, k1, v1, k2, v2)
    torch.cuda.synchronize()
    err = 0.0
    for sl in rows:
        po = A.dual_cross_attention_plain(q[:, sl].float(), *f32(k1, v1, k2, v2))
        err = max(err, compare(f"dual_cross (2,{S},12,128)x(512,257) rows "
                               f"[{sl.start},{sl.stop}) out", o[:, sl], po))
    qs, k1s, v1s, k2s, v2s = rnd(2, 200, 2, 128), rnd(2, 37, 2, 128), rnd(2, 37, 2, 128), \
        rnd(2, 21, 2, 128), rnd(2, 21, 2, 128)
    compare("dual_cross small (2,200,2,128)x(37,21) out",
            A.dual_cross_attention_fused(qs, k1s, v1s, k2s, v2s),
            A.dual_cross_attention_plain(*f32(qs, k1s, v1s, k2s, v2s)))
    ms = timed_ms(lambda: A.dual_cross_attention_fused(q, k1, v1, k2, v2))
    plain_ms = timed_ms(lambda: A.dual_cross_attention_plain(q, k1, v1, k2, v2), iters=1)
    log(f"dual_cross main shape: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["dual_cross_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del q, k, v, o, k1, v1, k2, v2
    torch.cuda.empty_cache()
    return results


def _build_dit():
    import torch
    import yaml

    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        nc = yaml.safe_load(f)["model"]["network_config"]
    nc["params"].update(dtype="bf16", use_i2v_clip=True)
    net = instantiate_from_config(nc)
    dit = net.build(torch.device("cuda"))
    dit.init_weights_(torch.Generator(device="cuda").manual_seed(1))
    return dit.to(torch.bfloat16).eval()


def _dit_inputs(gen, T, H, W):
    import torch

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)

    return dict(x=rnd(2, T, 16, H, W), timesteps=torch.full((2,), 900.0, device="cuda"),
                context=rnd(2, 512, 4096), ref_concat=rnd(2, 1, 16, H, W),
                concat_smpl_render=rnd(2, T, 16, H // 2, W // 2),
                image_clip_features=rnd(2, 257, 1280))


def phase_dit():
    import dataclasses

    import torch

    from scail_tpu_torch.ops import attention as A

    dit = _build_dit()
    cfg = dit.config
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.inner_hidden_size) == \
        (1536, 30, 12, 8960), cfg
    gen = torch.Generator(device="cuda").manual_seed(2)
    inp = _dit_inputs(gen, 21, 64, 112)
    x, t, ctx = inp.pop("x"), inp.pop("timesteps"), inp.pop("context")
    with torch.inference_mode():
        dit(x, t, ctx, **inp)  # warm-up
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        out = dit(x, t, ctx, **inp)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(A.LAUNCHES)
    log(f"DiT 1.3B forward, CFG batch 2, 48,832 tokens: {fwd_ms:.1f} ms; launches {counts}")
    if counts["flash_attention_rope"] != 30 or counts["dual_cross_attention"] != 30:
        fail(f"expected 30 + 30 kernel launches per forward, got {counts}")
    if tuple(out.shape) != (2, 21, 16, 64, 112) or not torch.isfinite(out).all():
        fail(f"DiT output bad: shape {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    del out, x, ctx, inp

    # the kernel path against the plain path, same weights, small input
    small = _dit_inputs(torch.Generator(device="cuda").manual_seed(3), 3, 16, 16)
    xs, ts = small.pop("x"), small.pop("timesteps")
    ctx = small.pop("context")
    with torch.inference_mode():
        got = dit(xs, ts, ctx, **small).float()
        dit.config = dataclasses.replace(cfg, attn_impl="xla")
        want = dit(xs, ts, ctx, **small).float()
        dit.config = cfg
    rel = ((got - want).norm() / want.norm()).item()
    log(f"DiT kernel path vs plain path (2, 3, 16, 16, 16): relative L2 {rel:.3e} "
        f"(tol {DIT_REL_TOL})")
    if not rel < DIT_REL_TOL:
        fail("DiT kernel path disagrees with the plain path")
    del dit
    torch.cuda.empty_cache()
    return fwd_ms


def phase_cli():
    import numpy as np

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.ops import attention as A

    os.makedirs(WORK, exist_ok=True)
    ex81 = os.path.join(WORK, "synthetic_081")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_synthetic_example.py"),
                    ex81, "--frames", "81", "--size", "512", "896"], check=True, timeout=300)
    prompts = os.path.join(WORK, "prompts.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{os.path.join(ROOT, 'examples_synth', '001')}\n")
        f.write(f"a character dancing@@{ex81}\n")
    argv = ["--base", os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml"),
            os.path.join(ROOT, "configs", "sampling", "pose_cli.yaml"),
            "--input-type", "txt", "--input-file", prompts, "--sampling-steps", "2",
            "--device", "cuda", "--output-dir", os.path.join(WORK, "samples")]
    log("CLI: python -m scail_tpu_torch.cli.sample_video " + " ".join(argv))
    A.reset_launch_counts()
    t0 = time.perf_counter()
    records = sample_video.main(argv)
    total = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    log(f"CLI answered {len(records)} requests in {total:.1f} s; kernel launches {counts}")
    if len(records) != 2:
        fail(f"expected 2 answered requests, got {len(records)}")
    for rec, frames in zip(records, (9, 81)):
        out = rec["outputs"][0]
        decoded = load_video_frames(out)[0]
        log(f"request {rec['case']}: {rec['seconds']:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in rec["phases"].items())
            + f"), {os.path.relpath(out, ROOT)} "
            f"decodes to {decoded.shape} (mean {decoded.mean():.1f}), "
            f"samples finite {rec['finite']}")
        if not (rec["finite"] and out.endswith(".mp4")
                and decoded.shape == (frames, 512, 896, 3) and np.ptp(decoded) > 0):
            fail(f"request {rec['case']}: expected an .mp4 of {frames} finite, "
                 "non-constant 512x896 frames")
    if counts["flash_attention_rope"] == 0 or counts["dual_cross_attention"] == 0:
        fail(f"the CLI run did not go through the kernels: {counts}")
    return counts, records


def main():
    if not os.path.isdir(os.path.join(ROOT, "scail_tpu_torch")):
        fail("scail_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    card = phase_device()
    build_s = phase_build()
    kernels = phase_kernels()
    dit_ms = phase_dit()
    counts, records = phase_cli()

    import torch

    log(f"summary: build {build_s:.2f} s; DiT forward {dit_ms:.1f} ms; requests "
        + ", ".join(f"{r['case']} {r['seconds']:.2f} s ({r['frames']} frames)" for r in records)
        + f"; card {card}")

    def entry(name, source, replaces):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], **kernels[name]}

    flash_src = "scail_tpu_torch/csrc/flash_attention.cu"
    report = {
        "kernels": [
            entry("flash_attention_rope", flash_src, "scail_tpu/ops/attention.py:403"),
            entry("dual_cross_attention", "scail_tpu_torch/csrc/dual_cross_attention.cu",
                  "scail_tpu/ops/attention.py:875"),
        ],
        # the no-rope instantiation of the flash kernel is off the sampling path
        "off_path": [entry("flash_attention", flash_src, "scail_tpu/ops/attention.py:68")],
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
