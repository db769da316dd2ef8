#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scail_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is swallowed):
  1. device   -- CUDA required; card name and power limit from nvidia-smi;
                 TF32 off for matmuls and cuDNN convolutions.
  2. build    -- compile the hand-written CUDA kernels from csrc/ (nvcc, sm_90a).
  3. kernels  -- each kernel against its plain PyTorch version on the card, at a
                 ragged small shape and at the DiT's main-path shapes (48,832
                 tokens; 2 x 12 heads for sampling, 1 x 12 for the backward
                 kernels of training), within limits scaled to the plain
                 output (ops/attention.py, error_vs_plain); times of kernel,
                 plain version and the PyTorch library call that computes the
                 same function, beside the card's bound for that work.
  4. DiT      -- the 1.3B DiT, all 30 layers, random bf16 weights, CFG batch 2 at
                 512x896/81 frames (48,832 tokens): 30 + 30 kernel launches, a
                 finite output, its time; kernel path vs plain path on a small input.
  5. CLI      -- `scail_tpu_torch.cli.sample_video` with the 1.3B YAMLs, 2 steps,
                 two requests (examples_synth/001, and an 81-frame 512x896
                 synthetic example); both .mp4 clips decode to the right frames.
  6. train    -- `scail_tpu_torch.cli.train` with the 1.3B YAML at 512x896, 81
                 frames, batch 1: 2 steps (finite losses, the DiT's parameters
                 move, 60 + 60 forward and 30 + 30 backward kernel launches
                 per step); the DiT's parameter gradients on the kernel path
                 against the plain path on a small input; then, at 4 layers
                 (two full-depth checkpoints would pass the machine's disk-write
                 limit), 2 steps saved and 1 step resumed from the checkpoint.

The line before the last is {"kernels": [...]}: per kernel its launches on the
main paths (the sampling CLI of phase 5 and the train CLI of phase 6, each
counted from 0), its largest error against the plain version, the kernel's,
the plain version's and the library call's milliseconds at the main-path shape,
and the bound: the larger of bytes moved over 3.35 TB/s and FLOPs over
989 TFLOP/s (H100 SXM bf16 dense).  The last line is {"ok": true, "device": ...}.
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
# the same for the DiT's parameter gradients through the training loss
GRAD_REL_TOL = 5e-2
# H100 SXM: HBM bytes/s and bf16 dense tensor-core FLOP/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


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


def bound(flops, moved):
    """(ms, 'operations' | 'bytes'): the least time the card needs to do
    `flops` bf16 operations and move `moved` bytes."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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
    import torch.nn.functional as F

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
            # the library call: SDPA on q and k with their rotary already applied
            qr = q if rope is None else apply_rotary(q, rope[0][:, None], rope[1][:, None],
                                                     interleaved)
            library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
                qr.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2)))
            del qr
            flops = 4 * 24 * S * S * 128
            b_ms, b_by = bound(flops, nbytes(q, kk, v, o, lse, *(rope or ())))
            log(f"flash rope={mode} main shape: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s), plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by})")
            results["flash_attention_rope" if interleaved else "flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)
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
    b_ms, b_by = bound(4 * 24 * S * (512 + 257) * 128, nbytes(q, o, k1, v1, k2, v2))
    log(f"dual_cross main shape: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}); no single library call sums two softmaxes")
    # library_ms None: no one PyTorch call computes the sum of two attentions
    results["dual_cross_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del q, k, v, o, k1, v1, k2, v2
    torch.cuda.empty_cache()
    results.update(_backward_kernels(gen, rnd, f32))
    return results


def _backward_kernels(gen, rnd, f32):
    """K5, the dq and dk/dv kernels, against their plain versions: a ragged
    small case, then the training shape (1, 48,832, 12, 128) with SCAIL's rope
    tables (dq on q rows [0, 1024) and the last 1024, dk/dv on those kv rows)."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.ops.rotary import apply_rotary, build_scail_rope

    q, k, v, do = rnd(1, 150, 2, 128), rnd(1, 176, 2, 128), rnd(1, 176, 2, 128), \
        rnd(1, 150, 2, 128)
    o, lse = A.flash_attention(q, k, v)
    got = A.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = A.flash_attention_bwd_plain(*f32(q, k, v, o), lse, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        compare(f"flash bwd small (1,150,2,128)x176 {name}", g, w)

    S = 48832
    tabs = build_scail_rope(128, 21, 32, 56, interleaved=True, device="cuda")
    cos, sin = tabs.cos[:, None], tabs.sin[:, None]
    q, k, v, do = (rnd(1, S, 12, 128) for _ in range(4))
    kr = apply_rotary(k, cos, sin, True)
    o, lse = A.flash_attention(q, kr, v, rope=(tabs.cos, tabs.sin))
    qr = apply_rotary(q, cos, sin, True)  # what the autograd Function's backward passes
    dq, dk, dv = A.flash_attention_bwd(qr, kr, v, o, lse, do)
    torch.cuda.synchronize()
    err = {"dq": 0.0, "dkv": 0.0}
    for sl in (slice(0, 1024), slice(S - 1024, S)):
        tag = f"(1,{S},12,128) rows [{sl.start},{sl.stop})"
        pdq = A.flash_attention_bwd_plain(qr[:, sl].float(), kr.float(), v.float(),
                                          o[:, sl].float(), lse[:, :, sl], do[:, sl].float(),
                                          grads="dq")[0]
        err["dq"] = max(err["dq"], compare(f"flash bwd dq {tag}", dq[:, sl], pdq))
        _, pdk, pdv = A.flash_attention_bwd_plain(qr.float(), kr[:, sl].float(),
                                                  v[:, sl].float(), o.float(), lse, do.float(),
                                                  grads="dkv")
        err["dkv"] = max(err["dkv"], compare(f"flash bwd dk {tag}", dk[:, sl], pdk),
                         compare(f"flash bwd dv {tag}", dv[:, sl], pdv))
        del pdq, pdk, pdv
    scale = 128 ** -0.5
    q2, lse2, delta = A._bwd_operands(qr, o, lse, do, scale)
    ops = (q2, kr, v, do, lse2.contiguous(), delta.contiguous())
    ms = {"dq": timed_ms(lambda: A.flash_attention_bwd_dq(*ops, scale=scale)),
          "dkv": timed_ms(lambda: A.flash_attention_bwd_dkv(*ops))}
    plain_ms = {g: timed_ms(lambda: A.flash_attention_bwd_plain(qr, kr, v, o, lse, do,
                                                                grads=g), iters=1)
                for g in ("dq", "dkv")}
    # the library call: SDPA's backward (flash), dq, dk and dv in one call
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (qr, kr, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    library_ms = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True))
    del out, qt, kt, vt
    work = {"dq": (6 * 12 * S * S * 128, nbytes(q2, kr, v, do, lse2, delta, dq)),
            "dkv": (8 * 12 * S * S * 128, nbytes(q2, kr, v, do, lse2, delta, dk, dv))}
    results = {}
    for g in ("dq", "dkv"):
        b_ms, b_by = bound(*work[g])
        log(f"flash bwd {g} (1,{S},12,128): kernel {ms[g]:.3f} ms "
            f"({work[g][0] / ms[g] / 1e9:.1f} TFLOP/s), plain {plain_ms[g]:.3f} ms, "
            f"SDPA backward (dq+dk+dv) {library_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        results[f"flash_attention_bwd_{g}"] = dict(
            max_abs_err=err[g], ms=ms[g], plain_ms=plain_ms[g], bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
    del q, k, v, do, kr, qr, o, lse, dq, dk, dv, q2, ops
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


# the DiT's launches per training step with remat: forward + recompute for the
# forward kernels, one each for the two backward kernels, in each of 30 layers
TRAIN_LAUNCHES_PER_STEP = {"flash_attention_rope": 60, "dual_cross_attention": 60,
                           "flash_attention_bwd_dq": 30, "flash_attention_bwd_dkv": 30}
# One checkpoint of the 30-layer trainer state (f32 params, two Adam moments,
# EMA shadow) is ~23.4 GiB, and the chip machine allows ~45 GiB of disk writes
# per run: save and resume are checked on the same YAML cut to this depth.
RESUME_LAYERS = 4


def phase_train(ex81):
    """The train CLI at full width and depth: 2 steps (the main path), then
    the DiT's gradients, kernel path against plain path; then save and
    resume at RESUME_LAYERS layers: 2 steps saved, 1 step resumed."""
    import dataclasses
    import gc
    import math
    import shutil

    import torch
    import yaml

    from scail_tpu_torch.cli import train
    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.training.engine import Trainer

    data_root = os.path.join(WORK, "train_data")
    os.makedirs(data_root, exist_ok=True)
    if not os.path.exists(os.path.join(data_root, "000")):
        os.symlink(ex81, os.path.join(data_root, "000"))
    base = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")
    argv = ["--data-root", data_root, "--image-size", "512", "896", "--num-frames", "81",
            "--batch-size", "1", "--warmup-iters", "1", "--seed", "0", "--device", "cuda"]
    watched = ("layers.0.qkv.weight", "layers.29.mlp_out.weight", "final_layer.linear.weight",
               "patch_embed.proj.weight")
    seen = {"before": {}, "step_s": []}
    real_fit, real_step = Trainer.fit, Trainer.train_step

    def fit(self, *a, **kw):  # snapshot a few parameters before training
        if not seen["before"]:
            seen["before"] = {n: self.params[n].detach().clone() for n in watched}
        return real_fit(self, *a, **kw)

    def train_step(self, batch):  # wall time of each step, device synchronised
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        seen["step_s"].append(time.perf_counter() - t0)
        return out

    Trainer.fit, Trainer.train_step = fit, train_step
    try:
        full = ["--base", base] + argv + ["--train-iters", "2"]
        log("train: python -m scail_tpu_torch.cli.train " + " ".join(full))
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train.main(full)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(A.LAUNCHES)
    finally:
        Trainer.fit, Trainer.train_step = real_fit, real_step
    step_s = seen["step_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in trainer.history]
    moved = {n: (trainer.params[n].detach() - seen["before"][n]).abs().max().item()
             for n in watched}
    log(f"train: 2 steps in {total:.1f} s (with engine build and data); step seconds "
        f"{[round(x, 2) for x in step_s]}; losses {losses}; grad norms "
        f"{[m['grad_norm'] for m in trainer.history]}; peak allocated {peak_gb:.2f} GB; "
        f"launches {counts}; largest parameter change {moved}")
    want = {k: 2 * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    if {k: counts[k] for k in want} != want:
        fail(f"expected {want} launches in 2 training steps, got {counts}")
    if trainer.step != 2 or not all(math.isfinite(x) for x in losses) or \
            not all(m["ok"] for m in trainer.history):
        fail(f"training did not take 2 finite steps: {trainer.history}")
    if not all(v > 0 for v in moved.values()):
        fail(f"the DiT's parameters did not change: {moved}")

    # gradients of the trained DiT, kernel path against plain path, small input
    dit = trainer.model
    cfg = dit.config
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(4), 3, 16, 16)
    x, t, ctx = (inp.pop(k)[:1] for k in ("x", "timesteps", "context"))
    inp = {k: v[:1] for k, v in inp.items()}
    w = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    grads = []
    for impl in ("auto", "xla"):
        dit.config = dataclasses.replace(cfg, attn_impl=impl)
        dit.zero_grad(set_to_none=True)
        (dit(x, t, ctx, **inp).float() * w).sum().backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in dit.parameters()]))
    dit.config = cfg
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    log(f"DiT parameter gradients, kernel path vs plain path (1, 3, 16, 16, 16): relative "
        f"L2 {rel:.3e} (tol {GRAD_REL_TOL})")
    if not rel < GRAD_REL_TOL:
        fail("the DiT's gradients on the kernel path disagree with the plain path")
    del trainer, dit, grads
    gc.collect()
    torch.cuda.empty_cache()

    # save, then resume, on the same YAML at RESUME_LAYERS layers
    with open(base) as f:
        cut = yaml.safe_load(f)
    cut["model"]["network_config"]["params"]["num_layers"] = RESUME_LAYERS
    cut_yaml = os.path.join(WORK, f"scail_1p3b_{RESUME_LAYERS}layers.yaml")
    with open(cut_yaml, "w") as f:
        yaml.safe_dump(cut, f)
    save = os.path.join(WORK, "train_run")
    shutil.rmtree(save, ignore_errors=True)
    short = ["--base", cut_yaml, "--save", save] + argv
    t0 = time.perf_counter()
    first = train.main(short + ["--train-iters", "2"])
    saved = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(save) for n in ns)
    del first
    gc.collect()
    resumed = train.main(short + ["--train-iters", "3", "--resume"])
    torch.cuda.synchronize()
    log(f"train at {RESUME_LAYERS} layers: 2 steps saved ({saved / 2**30:.2f} GiB "
        f"checkpoint), then resumed at step 2, now at step {resumed.step}, loss "
        f"{resumed.history[0]['loss'] if resumed.history else None}; both runs "
        f"{time.perf_counter() - t0:.1f} s")
    if resumed.step != 3 or len(resumed.history) != 1 or \
            not math.isfinite(resumed.history[0]["loss"]):
        fail(f"the resumed run did not go on from step 2: step {resumed.step}, "
             f"{resumed.history}")
    del resumed
    shutil.rmtree(save, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"step_s": step_s, "losses": losses, "peak_gb": peak_gb, "grad_rel": rel}


def main():
    if not os.path.isdir(os.path.join(ROOT, "scail_tpu_torch")):
        fail("scail_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    card = phase_device()
    build_s = phase_build()
    kernels = phase_kernels()
    dit_ms = phase_dit()
    sample_counts, records = phase_cli()
    train_counts, train = phase_train(os.path.join(WORK, "synthetic_081"))

    import torch

    log(f"summary: build {build_s:.2f} s; DiT forward {dit_ms:.1f} ms; requests "
        + ", ".join(f"{r['case']} {r['seconds']:.2f} s ({r['frames']} frames)" for r in records)
        + f"; training steps {[round(x, 2) for x in train['step_s']]} s, peak "
        f"{train['peak_gb']:.2f} GB; card {card}")

    def entry(name, source, replaces):
        by_path = {"sample_cli": sample_counts[name], "train_cli": train_counts[name]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **kernels[name]}

    flash_src = "scail_tpu_torch/csrc/flash_attention.cu"
    bwd_src = "scail_tpu_torch/csrc/flash_attention_bwd.cu"
    report = {
        "kernels": [
            entry("flash_attention_rope", flash_src, "scail_tpu/ops/attention.py:403"),
            entry("dual_cross_attention", "scail_tpu_torch/csrc/dual_cross_attention.cu",
                  "scail_tpu/ops/attention.py:875"),
            entry("flash_attention_bwd_dq", bwd_src, "scail_tpu/ops/attention.py:251"),
            entry("flash_attention_bwd_dkv", bwd_src, "scail_tpu/ops/attention.py:286"),
        ],
        # the no-rope instantiation of the flash kernel is off both main paths
        "off_path": [entry("flash_attention", flash_src, "scail_tpu/ops/attention.py:68")],
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
