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
                 same function, beside the card's bound for that work.  The
                 sliding-tile kernels (K7, K8) run with the main path's tables
                 for the video and the pose call of a layer; K2 and K5 also at
                 the STA path's own shape, the 1,792 dense ref rows against
                 48,832 kv rows (K2 runs nowhere else).  K3 also at the text
                 lengths of umt5's varlen_text, 1 and 37 keys.
  4. DiT      -- the 1.3B DiT, all 30 layers, random bf16 weights, CFG batch 2 at
                 512x896/81 frames (48,832 tokens): 30 + 30 kernel launches, a
                 finite output, its time; kernel path vs plain path on a small input.
  4b. DiT STA -- the same with attn_impl='sta' (tile (3, 8), window (3, 2)):
                 exactly 60 K7 + 30 K2 + 30 K3 launches; kernel vs plain path.
  5. CLI      -- `scail_tpu_torch.cli.sample_video` with the 1.3B YAMLs, 2 steps,
                 two requests (examples_synth/001, and an 81-frame 512x896
                 synthetic example); both .mp4 clips decode to the right frames.
  5b. CLI STA -- the 81-frame request again with --attn-impl sta.
  6. train    -- `scail_tpu_torch.cli.train` with the 1.3B YAML at 512x896, 81
                 frames, batch 1: 2 steps (finite losses, the DiT's parameters
                 move, 60 + 60 forward and 30 + 30 backward kernel launches
                 per step); the DiT's parameter gradients on the kernel path
                 against the plain path on a small input; then, at 4 layers
                 (two full-depth checkpoints would pass the machine's disk-write
                 limit), 2 steps saved and 1 step resumed from the checkpoint.
  6b. train STA -- 2 steps at full width and depth from a YAML with
                 `attn_impl: sta` (exact K7/K8/K2/K3/K5 launches), gradients
                 kernel vs plain path.
  6c. remat policies -- the train CLI at full width and depth, 2 steps each,
                 from YAML copies that set `remat_policy`: dense save_attn,
                 save_attn_frac 0.7 and offload_attn (K1 30 / 39 / 30 a step
                 instead of 60), STA save_attn (K7 with the LSE 60 instead of
                 120, K2 30 instead of 60); each one's step-1 loss bit-equal to
                 `default`'s of phase 6 / 6b from the same seed, its step-1
                 gradients within 1e-3 relative L2 of them, peak and step
                 seconds, offload_attn's peak within 0.5 GB of `default`'s.
                 Before each, on a 2-layer DiT at full width and 48,832 tokens,
                 every kept flash output against a fresh launch on the q, k
                 and v the recompute gives: bit-equal.
  6d. LoRA    -- the train CLI with --lora-rank 16 at full width and depth, 2
                 steps: the launches of phase 6, every base tensor bit-equal
                 afterwards, every lora_b non-zero, the peak; merge_lora's
                 forward against the factored one (relative L2 <= 3e-2); then
                 save and resume under --lora-rank at 4 layers (<iter>/ema
                 written, `latest` names the finished iteration).
  7. DiT 14B W8A16 -- the 14B DiT from configs/video_model/scail_14b.yaml
                 (hidden 5120, 40 layers, 40 heads, MLP 13,824) with random
                 int8 layer linears (cli/bench_14b_quant.py), one forward at
                 CFG batch 2, 48,832 tokens: exactly 320 K4 (w8) + 40 K1 + 40
                 K3, a finite output, parameter and peak GB; kernel path vs
                 plain path (plain attention and plain W8A16) on a small input.
  7b. 14B W4A16 clip -- `python -m scail_tpu_torch.cli.bench_14b_e2e --bits 4
                 --steps 2` through main(argv): 2 steps x 2 CFG halves at batch
                 1 (exactly 1,280 K4 (w4) + 160 K1 + 160 K3), then the streamed
                 decode of 81 finite frames.
  8. CLI 14B int8 -- the sampling CLI with the 14B YAML, bf16 weights and
                 --attn-impl pallas_int8 on the 81-frame request, 2 steps:
                 exactly 80 K6 + 80 K3 and no K1, an .mp4 of 81 x 512 x 896
                 frames, per-phase seconds and peak GB; then a bf16 14B DiT
                 built one parameter at a time (its build peak is checked to
                 hold no f32 copy) and its int8 kernel path vs its plain path on
                 a small input.
  5c. CLI long clip -- the sampling CLI with the 1.3B YAML and
                 configs/sampling/pose_cli_long.yaml (RFSamplerLong) on a
                 161-frame 512x896 synthetic example, 2 steps: 41 latent frames
                 in 3 tiles of 21, 8 DiT forwards at CFG batch 2 and 48,832
                 tokens, exactly 240 K1 + 240 K3 + 488 K9 + 240 K10; an .mp4 of
                 161 x 512 x 896 frames, per-phase seconds and peak GB.  Runs
                 after phase 5b.
  9. load     -- the released files' layouts at full width, written from an
                 engine made from seeds on the card: the 1.3B DiT in bf16
                 under SAT names with `latest`, the Wan VAE in f32, CLIP
                 ViT-H under visual.*, umt5-xxl with all 24 layers in bf16
                 (16.3 GB, each file fsynced and dropped from the page
                 cache), and a copy of the 1.3B YAML pointing at them.  The
                 sampling CLI with --load answers the 81-frame request in 2
                 steps: exactly 60 K1 + 60 K3 + 122 K9 + 60 K10, a finite,
                 non-constant clip; every loaded tensor is on the card and
                 bit-equal to its source; load_checkpoint's device peak stays
                 within 1 GB of the DiT's parameters; each file's seconds and
                 GB/s.  Then the train CLI with --load takes one full-depth
                 step from the file's weights in f32 (exact launches, a
                 finite loss).  The files are deleted at the end.
  10. parallel -- scail_tpu_torch/parallel/ on the card, after nvidia-smi's
                 compute mode is read (an exclusive mode raises).  (a) One
                 rank under NCCL at world 1: the mesh's groups are NCCL's, a
                 Ulysses and a ring DiT forward at 2 layers and full width
                 (a trivial mesh: the DiT issues no collective), and each
                 collective kind through NCCL, value-checked.  (b) Two ranks
                 sharing the one card over gloo (NCCL puts no two ranks on
                 one device; this harness stages gloo's point-to-point
                 transfers through host memory, `_stage_p2p_through_host`),
                 1.3B weights from a seed on both: the Ulysses forward at
                 seq 2, 30 layers, CFG batch 2, 48,832 tokens (per rank
                 exactly K2 30, K3 30, K10 60, K9 61, all-to-all 120); at 4
                 layers the ring at seq 2 (K2 8, p2p 4), TP at model 2
                 (all-reduce 32), STA under Ulysses and under TP; each
                 against the one-process kernel path on rank 0, relative L2
                 <= 3e-2.  The ring and Ulysses attention alone at (1,
                 48,832, 12, 128), forward and backward (ring: K2 2, K5 2 + 2,
                 p2p 3), against one-process K2 + K5.  Then `train
                 --distributed --mesh-model 2`, 2
                 steps at full width and PARALLEL_TRAIN_LAYERS layers (exact
                 launches; step 1's loss within 3e-2 of the one-process step
                 at the same depth and seed), and vae_decode_cp of 21
                 latent frames at 512x896 against the streamed decode.
                 Seconds, bytes sent and peak GB of each run per rank; each
                 rank under PARALLEL_RANK_PEAK_GB.
  11. evals   -- the quality evals on random weights from seeds, each network at
                 its published width, with TF32 switched on for the caller
                 (each extractor must compute in f32 and hand the setting
                 back): (a) I3D at 224 px on the 81-frame 512x896 clips of
                 phases 5 and 5b, FVD(dense, STA) through cli/calculate_fvd
                 (finite) and FVD(dense, dense) (|.| < 1e-3), the features of
                 16 frames against the CPU's; (b) InceptionV3 on every 4th
                 frame, `eval_fid ref` on the dense clip's, `calc` on the STA
                 clip's, features against the CPU's; (c) ViT-g-14 (CLIP score),
                 ViT-L/14 with the aesthetic MLP head and ViT-H-14 (HPS) at
                 full depth, each also at 2 layers against the CPU, and LPIPS
                 (VGG16) on 512x896 frame pairs against the CPU; every card
                 result within 1e-4 relative L2 of the CPU's; ms per clip,
                 image, prompt or pair and peak GB of each; (d) the STA gate,
                 cli/validate_weights --smoke on examples_synth/001 at 512x128
                 and 9 frames (where the sliding tiles divide the latent):
                 both sampling passes, FVD of each against GT, the CLIP score,
                 the report; exactly 2 forwards' launches in each pass.

Every DiT forward also runs the fused AdaLN LayerNorm (K9) 2L+1 times (before
each layer's attention and MLP, and in the final layer) and the rotary
kernel (K10) on k in every dense layer, on q and k under STA and int8-QK, and
on q in the dense backward; the exact counts above include them (phase 3
holds both against their plain versions at the main-path shapes).

The line before the last is {"kernels": [...]}: per kernel its launches on the
main paths (`launches_by_path`: the sampling CLI of phases 5, 5b and 5c, the
train CLI of phases 6, 6b, 6c (one path per policy) and 6d, the 14B paths of
phases 7, 7b and 8, the --load request of phase 9, the two ranks of phase
10 (their runs summed) and the two sampling passes of validate_weights in
phase 11, each counted from 0, and their sum), its largest
error against the plain version, the kernel's, the plain version's and the
library call's milliseconds at the main-path shape, and the bound: the
larger of bytes moved over 3.35 TB/s and
the operations over the card's dense rates (989 TFLOP/s bf16 and 1,979 TOP/s
int8 on the tensor cores, 67 TFLOP/s f32 outside them; H100 SXM).  K1's,
K2's and K3's entries add their rate (`tflops`) and `share_of_bound` (the
bound over the kernel's time), K3's also its numbers at the 14B's 40 heads
(`at_14b`, k and v as chunk views of one projection, as the DiT passes
them), the time of two SDPA calls and an add (information only) and its
registers and spill bytes; the four sliding-tile entries (K7, K8) add the
same and the registers and spill bytes of their kernels from the build log
(the log gives the time of their first, mma.sync design beside the new one,
and K8 dk/dv's time with its CTAs launched in block order beside the
heaviest-first order it runs).  The build fails the run on a spill in a
kernel built from csrc/flash_bodies.cuh (K1, K2, K3, K5, K7, K8) or on any
ptxas C7515 / C7512 note (serialised wgmmas).  The last line is
{"ok": true, "device": ...}.
"""

import json
import os
import re
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
# H100 SXM: HBM bytes/s, bf16 / int8 dense tensor-core rates and the f32 rate
# outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12


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


def bound(flops, moved, int8_ops=0, f32_ops=0):
    """(ms, 'operations' | 'bytes'): the least time the card needs to do
    `flops` bf16 and `int8_ops` int8 tensor-core operations and `f32_ops`
    f32 operations outside the tensor cores, and move `moved` bytes."""
    t_ops = (flops / BF16_FLOPS + int8_ops / INT8_OPS + f32_ops / F32_FLOPS) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# the largest max-abs error over std(plain output) of each kernel's checks,
# by the `key` given to compare (reported in the kernels line)
PER_STD = {}


def compare(name, got, want, lse=False, key=None):
    """Error of a kernel result against its plain version (f32); fails past
    the limits of error_vs_plain.  Returns the max-abs error; an output's
    error over std goes into PER_STD[key]."""
    from scail_tpu_torch.ops import attention as A

    e = A.error_vs_plain(got, want, lse=lse)
    if key and not lse:
        PER_STD[key] = max(PER_STD.get(key, 0.0), e["err_per_std"])
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


def reset_counts():
    """Every kernel's launch count to 0 (attention and quantized matmul)."""
    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.ops import quant as Q

    A.reset_launch_counts()
    Q.reset_launch_counts()


def launch_counts():
    """Every kernel's launch count since reset_counts()."""
    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.ops import quant as Q

    return {**A.LAUNCHES, **Q.LAUNCHES}


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


# ptxas's report of each kernel in the build log: mangled name ->
# {"registers": n, "spill_bytes": stores + loads}
PTXAS = {}


def ptxas_usage(log_text):
    """Registers and spill bytes of every entry function in an `nvcc -Xptxas
    -v` log, and the lines that carry a C7515 / C7512 note (wgmmas
    serialised, or serialised for spills)."""
    usage, notes, fn = {}, [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            usage[fn] = {"registers": None, "spill_bytes": 0}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            usage[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            usage[fn]["registers"] = int(m.group(1))
        if "C7515" in ln or "C7512" in ln:
            notes.append(ln.strip())
    return usage, notes


def kernel_usage(*names):
    """{registers, spill_bytes} of the kernels whose mangled names hold any of
    `names` (one entry per instantiation)."""
    return {fn: u for fn, u in PTXAS.items() if any(n in fn for n in names)}


def phase_build():
    from scail_tpu_torch.ops import cuda_build

    info = cuda_build.build()
    cuda_build.lib()
    usage, notes = ptxas_usage(info["log"])
    PTXAS.update(usage)
    spills = {fn: u for fn, u in usage.items() if u["spill_bytes"]}
    log(f"built {os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s "
        f"(cached={info['cached']}); ptxas registers: "
        + ", ".join(f"{fn[:60]} {u['registers']}" for fn, u in usage.items())
        + f"; spills: {spills or 'none'}; C7515/C7512 notes: {notes or 'none'}")
    body_spills = kernel_usage(*FLASH_BODY_KERNELS)
    body_spills = {fn: u for fn, u in body_spills.items() if u["spill_bytes"]}
    if body_spills or notes:
        fail(f"ptxas spilled or serialised wgmmas: {body_spills} {notes}")
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
            err = max(err, compare(f"{tag} out", o[:, sl], po,
                                   key="flash_attention_rope" if interleaved else None))
            compare(f"{tag} lse", lse[:, :, sl], plse, lse=True)
        if mode == "interleaved":
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
                f"TFLOP/s, {b_ms / ms:.1%} of bound; mma.sync design "
                f"{PARENT_MS['flash_attention_rope']} ms), plain {plain_ms:.3f} ms, SDPA "
                f"{library_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            results["flash_attention_rope"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, tflops=flops / ms / 1e9, share_of_bound=b_ms / ms)
    del kk

    # dual cross-attention: 48,832 q rows x (512 text, 257 CLIP) keys
    k1, v1, k2, v2 = rnd(2, 512, 12, 128), rnd(2, 512, 12, 128), rnd(2, 257, 12, 128), \
        rnd(2, 257, 12, 128)
    results["dual_cross_attention"] = _dual_cross_main(q, k1, v1, k2, v2, rows, "1.3B")
    # the text lengths of varlen_text (umt5): one token (uncond_text_length)
    # and a prompt's 37 valid tokens, against the 257 CLIP keys
    for text_len in (1, 37):
        k1t, v1t = rnd(2, text_len, 12, 128), rnd(2, text_len, 12, 128)
        ot = A.dual_cross_attention_fused(q, k1t, v1t, k2, v2)
        torch.cuda.synchronize()
        for sl in rows:
            compare(f"dual_cross (2,{S},12,128)x({text_len},257) rows [{sl.start},{sl.stop}) out",
                    ot[:, sl], A.dual_cross_attention_plain(
                        q[:, sl].float(), *(t.float() for t in (k1t, v1t, k2, v2))),
                    key="dual_cross_attention")
        del k1t, v1t, ot
    qs, k1s, v1s, k2s, v2s = rnd(2, 200, 2, 128), rnd(2, 37, 2, 128), rnd(2, 37, 2, 128), \
        rnd(2, 21, 2, 128), rnd(2, 21, 2, 128)
    compare("dual_cross small (2,200,2,128)x(37,21) out",
            A.dual_cross_attention_fused(qs, k1s, v1s, k2s, v2s),
            A.dual_cross_attention_plain(*f32(qs, k1s, v1s, k2s, v2s)))
    del q, k, v, o, lse, k1, v1, k2, v2
    torch.cuda.empty_cache()
    # the 14B's 40 heads, k and v as the DiT hands them over: chunk views of
    # one (b, s, 2 x hidden) projection per stream
    q = rnd(2, S, 40, 128)
    k1, v1 = rnd(2, 512, 2 * 40 * 128).unflatten(-1, (80, 128)).chunk(2, dim=2)
    k2, v2 = rnd(2, 257, 2 * 40 * 128).unflatten(-1, (80, 128)).chunk(2, dim=2)
    results["dual_cross_attention"]["at_14b"] = _dual_cross_main(q, k1, v1, k2, v2, rows, "14B")
    del q, k1, v1, k2, v2
    torch.cuda.empty_cache()
    results.update(_backward_kernels(gen, rnd, f32))
    sta = _sta_kernels(gen, rnd, f32)
    # K5 at the STA training path's shape, beside its dense-path numbers
    for g in ("dq", "dkv"):
        results[f"flash_attention_bwd_{g}"]["sta_ref_rows"] = sta.pop(f"flash_attention_bwd_{g}")
    results.update(sta)
    results.update(_quant_kernels(gen))
    results["flash_attention_int8"] = _int8_kernel(gen, rnd)
    results.update(_norm_kernels(gen, rnd))
    return results


def _dual_cross_main(q, k1, v1, k2, v2, rows, label):
    """K3 at a main-path shape: the sampled q rows against the plain version,
    then times of kernel and plain version beside the bound; two SDPA calls
    and an add on the same inputs are logged for information only (no single
    library call sums two softmaxes)."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import attention as A

    b, S, n, _ = q.shape
    o = A.dual_cross_attention_fused(q, k1, v1, k2, v2)
    torch.cuda.synchronize()
    err = 0.0
    for sl in rows:
        po = A.dual_cross_attention_plain(q[:, sl].float(), *(t.float() for t in (k1, v1, k2, v2)))
        err = max(err, compare(f"dual_cross ({b},{S},{n},128)x({k1.shape[1]},{k2.shape[1]}) rows "
                               f"[{sl.start},{sl.stop}) out", o[:, sl], po,
                               key="dual_cross_attention"))
    again = A.dual_cross_attention_fused(q, k1, v1, k2, v2)
    if not torch.equal(o, again):
        fail(f"dual_cross {label}: two calls on the same inputs differ")
    del again
    ms = timed_ms(lambda: A.dual_cross_attention_fused(q, k1, v1, k2, v2), iters=20)
    plain_ms = timed_ms(lambda: A.dual_cross_attention_plain(q, k1, v1, k2, v2), iters=1)
    qt = q.transpose(1, 2)
    sdpa2_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, k1.transpose(1, 2), v1.transpose(1, 2)) + F.scaled_dot_product_attention(
        qt, k2.transpose(1, 2), v2.transpose(1, 2)), iters=20)
    flops = 4 * b * n * S * (k1.shape[1] + k2.shape[1]) * 128
    b_ms, b_by = bound(flops, nbytes(q, o, k1, v1, k2, v2))
    usage = kernel_usage("dual_cross_kernel")
    log(f"dual_cross {label} main shape ({b},{S},{n},128)x({k1.shape[1]},{k2.shape[1]}): kernel "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of bound; mma.sync "
        f"design {PARENT_MS['dual_cross_attention'][label]} ms), plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}); two SDPA calls and an add {sdpa2_ms:.3f} ms (information "
        f"only: no single library call sums two softmaxes); ptxas {usage}")
    # library_ms None: no one PyTorch call computes the sum of two attentions
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, tflops=flops / ms / 1e9, share_of_bound=b_ms / ms,
                two_sdpa_and_add_ms=sdpa2_ms, ptxas=usage)


# K9 at the main-path shapes, CFG batch 2: (name, rows per batch element, d):
# a layer's 48,832 tokens at the 1.3B and 14B widths, and the final layer's
# 37,632 video rows; the first is the headline entry
NORM_SHAPES = (("1.3B layer", 48832, 1536), ("14B layer", 48832, 5120),
               ("1.3B final layer", 37632, 1536))
# K10 on the q and k column slices of the qkv projection at CFG batch 2,
# 48,832 tokens: (name, hidden, heads)
ROTARY_SHAPES = (("1.3B", 1536, 12), ("14B", 5120, 40))
# f32 operations per element: K9 the sum, the centred square and its sum, the
# centring, scaling and modulation (8); K10 two products and a sum (3)
NORM_OPS, ROTARY_OPS = 8, 3


def _norm_compare(name, got, want):
    """K9 against its plain version within fused_norms' limits; returns the
    max-abs error."""
    from scail_tpu_torch.ops import fused_norms as FN

    e = FN.adaln_error_vs_plain(got, want)
    PER_STD["adaln_layer_norm"] = max(PER_STD.get("adaln_layer_norm", 0.0), e["err_per_std"])
    log(f"{name}: max_abs_err {e['max_abs_err']:.3e} (limit {e['max_abs_limit']:.3e}, one bf16 "
        f"ulp of the largest output), rel L2 {e['rel_l2']:.3e} (limit {FN.ADALN_REL_L2}) "
        f"{'ok' if e['ok'] else 'OUT OF TOLERANCE'}")
    if not e["ok"]:
        fail(f"{name} disagrees with its plain version")
    return e["max_abs_err"]


def _rotary_compare(name, got, want):
    """K10 against its plain version: bit-exact."""
    import torch

    exact = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
    err = (got.float() - want.float()).abs().max().item()
    log(f"{name}: max_abs_err {err:.3e} (limit 0, bit-exact) "
        f"{'ok' if exact else 'OUT OF TOLERANCE'}")
    if not exact:
        fail(f"{name} is not bit-exact against its plain version")
    PER_STD["rotary"] = 0.0
    return err


def _norm_kernels(gen, rnd):
    """K9 and K10 against their plain versions: a ragged small case (s 150,
    d 64, x rows on a wider stride; K10 with 3 heads), then K9 at each of
    NORM_SHAPES with bf16 and f32 shift/scale (strided rows of a (2, 6, d)
    table, as the DiT passes them) in its one-rounding mode (the Pallas
    kernel's) and, bf16 only, at dit_forward's roundings (round_ln, the mode
    the DiT runs and the one timed; the other's time is logged beside it),
    and K10 on the q and k views of each of
    ROTARY_SHAPES' qkv tensors with SCAIL's tables; times of kernel, plain
    version and the library yardstick (K9: F.layer_norm with weight 1 + scale
    and bias shift, one call per batch row, the same function in b calls; K10:
    none), beside the bound: bytes over 3.35 TB/s (x and the output, shift,
    scale, the f32 tables) against the f32 operations over 67 TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import fused_norms as FN
    from scail_tpu_torch.ops.rotary import build_scail_rope

    eps = 1e-6
    x = rnd(2, 150, 2 * 64)[..., 64:]
    for mdt, round_ln in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
        shift, scale = rnd(2, 6, 64).to(mdt).unsqueeze(2).unbind(1)[:2]
        _norm_compare(f"adaln small (2,150,64) strided, {str(mdt)[6:]} shift/scale"
                      f"{', round_ln' if round_ln else ''}",
                      FN.adaln_layer_norm_kernel(x, shift, scale, eps=eps, round_ln=round_ln),
                      FN.adaln_layer_norm_plain(x, shift, scale, eps=eps, round_ln=round_ln))
    ang = torch.randn(150, 32, generator=gen, device="cuda").repeat_interleave(2, -1)
    xr = rnd(2, 150, 3 * 3 * 64)[..., 64:4 * 64].unflatten(-1, (3, 64))
    _rotary_compare("rotary small (2,150,3,64) strided",
                    FN.rotary_kernel(xr, ang.cos(), ang.sin()),
                    FN.apply_rotary_fused_plain(xr, ang.cos(), ang.sin()))

    by_shape = {}
    for name, s, d in NORM_SHAPES:
        x = rnd(2, s, d)
        mod = rnd(2, 6, d)
        err = 0.0
        for mdt, round_ln in ((torch.bfloat16, False), (torch.float32, False),
                              (torch.bfloat16, True)):
            shift, scale = mod.to(mdt).unsqueeze(2).unbind(1)[:2]
            out = FN.adaln_layer_norm_kernel(x, shift, scale, eps=eps, round_ln=round_ln)
            torch.cuda.synchronize()
            err = max(err, _norm_compare(
                f"adaln {name} (2,{s},{d}), {str(mdt)[6:]} shift/scale"
                f"{', round_ln' if round_ln else ''}", out,
                FN.adaln_layer_norm_plain(x, shift, scale, eps=eps, round_ln=round_ln)))
        shift, scale = mod.unsqueeze(2).unbind(1)[:2]
        ms = timed_ms(lambda: FN.adaln_layer_norm_kernel(x, shift, scale, eps=eps, round_ln=True),
                      iters=20)
        ms_once = timed_ms(lambda: FN.adaln_layer_norm_kernel(x, shift, scale, eps=eps), iters=20)
        plain_ms = timed_ms(lambda: FN.adaln_layer_norm_plain(x, shift, scale, eps=eps,
                                                              round_ln=True), iters=2)
        weight, bias = 1 + scale[:, 0], shift[:, 0]
        library_ms = timed_ms(lambda: [F.layer_norm(x[i], (d,), weight[i], bias[i], eps)
                                       for i in range(2)], iters=20)
        b_ms, b_by = bound(0, nbytes(x, shift, scale, out), f32_ops=NORM_OPS * x.numel())
        log(f"adaln {name} (2,{s},{d}): kernel {ms:.4f} ms round_ln "
            f"({nbytes(x, out) / ms / 1e6:.1f} GB/s), {ms_once:.4f} ms one rounding, "
            f"plain {plain_ms:.3f} ms, F.layer_norm per batch row (2 calls) {library_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        by_shape[name] = dict(shape=[2, s, d], max_abs_err=err, ms=ms, ms_one_rounding=ms_once,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=library_ms)
        del x, mod, out
        torch.cuda.empty_cache()
    results = {"adaln_layer_norm": dict(by_shape[NORM_SHAPES[0][0]], by_shape=by_shape,
                                        max_abs_err=max(e["max_abs_err"]
                                                        for e in by_shape.values()))}

    tabs = build_scail_rope(128, 21, 32, 56, interleaved=True, device="cuda")
    by_shape = {}
    for name, hidden, heads in ROTARY_SHAPES:
        qkv = rnd(2, 48832, 3 * hidden)
        q, k = (t.unflatten(-1, (heads, 128)) for t in qkv.chunk(3, dim=-1)[:2])
        err = 0.0
        for which, t in (("q", q), ("k", k)):
            out = FN.rotary_kernel(t, tabs.cos, tabs.sin)
            torch.cuda.synchronize()
            err = max(err, _rotary_compare(f"rotary {name} {which} of {tuple(qkv.shape)}",
                                           out, FN.apply_rotary_fused_plain(t, tabs.cos, tabs.sin)))
        ms = timed_ms(lambda: FN.rotary_kernel(q, tabs.cos, tabs.sin), iters=20)
        plain_ms = timed_ms(lambda: FN.apply_rotary_fused_plain(q, tabs.cos, tabs.sin), iters=2)
        # the q view read and the output written (the same number of bf16
        # values), and the f32 tables
        b_ms, b_by = bound(0, 2 * nbytes(out) + nbytes(tabs.cos, tabs.sin),
                           f32_ops=ROTARY_OPS * q.numel())
        log(f"rotary {name} {tuple(q.shape)} q view: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); no single PyTorch call applies "
            "an interleaved rotary")
        # library_ms None: no one PyTorch call applies an interleaved rotary
        by_shape[name] = dict(shape=list(q.shape), max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del qkv, q, k, out
        torch.cuda.empty_cache()
    results["rotary"] = dict(by_shape[ROTARY_SHAPES[0][0]], by_shape=by_shape,
                             max_abs_err=max(e["max_abs_err"] for e in by_shape.values()))
    return results


# K4 at the 14B's main-path shapes, CFG batch 2 (M = 2 x 48,832 video-stream
# rows, 2 x 512 text rows): (name, M, K, N); the first is the headline entry
QUANT_SHAPES = (("qkv", 97664, 5120, 15360), ("mlp_in", 97664, 5120, 13824),
                ("mlp_out", 97664, 13824, 5120), ("attn_out", 97664, 5120, 5120),
                ("cross_kv", 1024, 5120, 10240))


# the earlier designs' times (mma.sync, synchronous loads) on NVIDIA H100 80GB
# HBM3 at 700 W, from this script's phase 3 (PERF.md), logged beside each new time
PARENT_MS = {"w8a16_matmul": {"qkv": 74.48, "mlp_in": 67.35, "mlp_out": 65.88,
                              "attn_out": 24.83, "cross_kv": 0.758},
             "w4a16_matmul": {"qkv": 67.61, "mlp_in": 60.70, "mlp_out": 60.98,
                              "attn_out": 22.74, "cross_kv": 0.554},
             "flash_attention_int8": 656.48,
             "flash_attention_rope": 175.73, "flash_attention": 7.522,
             # K3's mma.sync design at the 1.3B and the 14B main-path shapes
             "dual_cross_attention": {"1.3B": 3.505, "14B": 11.551},
             # the first, mma.sync design of K7 / K8, one layer's two calls
             "sta_attention_fwd": 47.92, "sta_attention_fwd_lse": 24.79,
             "sta_attention_bwd_dq": 33.79, "sta_attention_bwd_dkv": 44.34}
# the kernels built from csrc/flash_bodies.cuh (K1, K2, K3, K5, K7, K8): no spills
FLASH_BODY_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                      "sta_fwd_kernel", "sta_bwd_dq_kernel", "sta_bwd_dkv_kernel",
                      "dual_cross_kernel")
# the kernels of each sliding-tile entry in the build log
STA_KERNELS = {"sta_attention_fwd": "sta_fwd_kernel", "sta_attention_fwd_lse": "sta_fwd_kernel",
               "sta_attention_bwd_dq": "sta_bwd_dq_kernel",
               "sta_attention_bwd_dkv": "sta_bwd_dkv_kernel"}


def _rows_view(t):
    """A (M, N) matmul output as error_vs_plain's (1, M, 1, N)."""
    return t.reshape(1, -1, 1, t.shape[-1])


def _random_codes(gen, n, k, bits):
    import torch

    if bits == 8:
        return torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    return torch.randint(0, 256, (n, k // 2), generator=gen, device="cuda", dtype=torch.uint8)


def _dequantize(codes, scale, bits):
    """The bf16 weight the codes stand for (the library yardstick's operand)."""
    import torch

    from scail_tpu_torch.ops import quant as Q

    c = codes if bits == 8 else Q.unpack_int4(codes)
    return c.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]


def _quant_kernels(gen):
    """K4, W8A16 and W4A16, against the plain version: a ragged small case
    (M 300, N 201, K 160, with a bias; every int4 byte, so -8 nibbles), then
    each 14B main-path shape of QUANT_SHAPES with a bias, rows [0, 1024) and
    the last 1024 compared; times of kernel, plain version and torch.matmul
    on the dequantized bf16 weight (cuBLAS), beside the bound: 2MNK FLOPs
    over 989 TFLOP/s against x, codes, scale, bias and output bytes."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import quant as Q

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    results = {}
    for bits in (8, 4):
        key = f"w{bits}a16_matmul"
        mm = Q.matmul_w8a16 if bits == 8 else Q.matmul_w4a16
        x, codes = rnd(300, 160), _random_codes(gen, 201, 160, bits)
        scale, bias = torch.full((201,), 0.02 / 127, device="cuda"), rnd(201)
        compare(f"{key} small (300,160)x(160,201)", _rows_view(mm(x, codes, scale, bias)),
                _rows_view(mm(x, codes, scale, bias, impl="xla")), key=key)
        by_shape = {}
        for name, m, k, n in QUANT_SHAPES:
            x = rnd(m, k)
            codes = _random_codes(gen, n, k, bits)
            scale = torch.full((n,), 0.02 / (127 if bits == 8 else 7), device="cuda")
            bias = rnd(n)
            out = mm(x, codes, scale, bias)
            torch.cuda.synchronize()
            err = 0.0
            for sl in (slice(0, 1024), slice(m - 1024, m)):
                err = max(err, compare(
                    f"{key} {name} ({m},{k})x({k},{n}) rows [{sl.start},{sl.stop})",
                    _rows_view(out[sl]), _rows_view(mm(x[sl], codes, scale, bias, impl="xla")),
                    key=key))
            ms = timed_ms(lambda: mm(x, codes, scale, bias))
            plain_ms = timed_ms(lambda: mm(x, codes, scale, bias, impl="xla"), iters=1)
            w = _dequantize(codes, scale, bits)
            library_ms = timed_ms(lambda: F.linear(x, w, bias))
            flops = 2 * m * n * k
            b_ms, b_by = bound(flops, nbytes(x, codes, scale, bias, out))
            log(f"{key} {name} ({m},{k})x({k},{n}): kernel {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s; mma.sync design {PARENT_MS[key][name]} ms), "
                f"plain {plain_ms:.3f} ms, torch.matmul on "
                f"the dequantized bf16 weight {library_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            by_shape[name] = dict(shape=[m, k, n], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
            del x, codes, out, w
            torch.cuda.empty_cache()
        results[key] = dict(by_shape["qkv"], by_shape=by_shape,
                            max_abs_err=max(e["max_abs_err"] for e in by_shape.values()))
    return results


def _int8_kernel(gen, rnd):
    """K6 against its plain version on the same bf16 inputs: a ragged small
    case (q 150, kv 176 rows, v head-strided), then the 14B's self-attention
    shape (2, 48,832, 40, 128), q rows [0, 1024) and the last 1024 against
    every kv row; times of kernel, plain version and SDPA on the bf16 q, k,
    v (exact attention, the library yardstick).  Bound: QK^T's 2 S^2 d ops per
    head at the int8 rate plus P V's at the bf16 rate, against q, k, v, O,
    LSE bytes."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import attention as A

    q, k = rnd(2, 150, 2, 128), rnd(2, 176, 2, 128)
    v = rnd(2, 176, 2, 3 * 128)[..., 128:256]
    o, lse = A.flash_attention_int8(q, k, v)
    po, plse = A.flash_attention_int8_plain(q, k, v)
    compare("flash int8 small (2,150,2,128)x176 out", o, po, key="flash_attention_int8")
    compare("flash int8 small lse", lse, plse, lse=True)

    S, H = 48832, 40
    q, k, v = (rnd(2, S, H, 128) for _ in range(3))
    o, lse = A.flash_attention_int8(q, k, v)
    torch.cuda.synchronize()
    err = 0.0
    for sl in (slice(0, 1024), slice(S - 1024, S)):
        po, plse = A.flash_attention_int8_plain(q[:, sl], k, v, block_q=128)
        tag = f"flash int8 (2,{S},{H},128) rows [{sl.start},{sl.stop})"
        err = max(err, compare(f"{tag} out", o[:, sl], po, key="flash_attention_int8"))
        compare(f"{tag} lse", lse[:, :, sl], plse, lse=True)
        del po, plse
    ms = timed_ms(lambda: A.flash_attention_int8(q, k, v), iters=2)
    plain_ms = timed_ms(lambda: A.flash_attention_int8_plain(q, k, v, block_q=128), iters=1)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), iters=2)
    ops = 2 * 2 * H * S * S * 128  # each of QK^T (int8) and P V (bf16)
    b_ms, b_by = bound(ops, nbytes(q, k, v, o, lse), int8_ops=ops)
    log(f"flash int8 (2,{S},{H},128): kernel {ms:.3f} ms ({2 * ops / ms / 1e9:.1f} TOP/s; "
        f"mma.sync design {PARENT_MS['flash_attention_int8']} ms), "
        f"plain {plain_ms:.3f} ms, SDPA (bf16, exact) {library_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def _backward_kernels(gen, rnd, f32):
    """K5, the dq and dk/dv kernels, against their plain versions: a ragged
    small case, then the training shape (1, 48,832, 12, 128) with SCAIL's rope
    tables (dq on q rows [0, 1024) and the last 1024, dk/dv on those kv rows),
    where a second call must give the same bits."""
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
    again = A.flash_attention_bwd(qr, kr, v, o, lse, do)  # two passes, no atomics
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    log(f"flash bwd (1,{S},12,128): a second call gives the same bits: {same}")
    if not same:
        fail("K5 is not deterministic: two calls at (1, 48,832, 12, 128) differ")
    del again
    err = {"dq": 0.0, "dkv": 0.0}
    for sl in (slice(0, 1024), slice(S - 1024, S)):
        tag = f"(1,{S},12,128) rows [{sl.start},{sl.stop})"
        pdq = A.flash_attention_bwd_plain(qr[:, sl].float(), kr.float(), v.float(),
                                          o[:, sl].float(), lse[:, :, sl], do[:, sl].float(),
                                          grads="dq")[0]
        err["dq"] = max(err["dq"], compare(f"flash bwd dq {tag}", dq[:, sl], pdq,
                                           key="flash_attention_bwd_dq"))
        _, pdk, pdv = A.flash_attention_bwd_plain(qr.float(), kr[:, sl].float(),
                                                  v[:, sl].float(), o.float(), lse, do.float(),
                                                  grads="dkv")
        err["dkv"] = max(err["dkv"], *(compare(f"flash bwd {n} {tag}", g, w,
                                               key="flash_attention_bwd_dkv")
                                       for n, g, w in (("dk", dk[:, sl], pdk),
                                                       ("dv", dv[:, sl], pdv))))
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


# the sliding-tile geometry of the main path: 512x896, 81 frames (latent 21 x
# 32 x 56 after the patch), ref 1,792 + video 37,632 + pose 9,408 tokens, the
# JAX package's defaults: tile (3, 8), window (3, 2), windowed pose, pose-kv
# window 3
STA_GEOM = ((21, 32, 56), 1792, 9408, (3, 8), (3, 2), True, 3)


def _sta_calls(plan):
    """The two windowed calls of one layer: (name, q rows, q tile rows)."""
    sv = plan.video_len
    return (("video", slice(0, sv), plan.ts), ("pose", slice(sv, sv + plan.pose_len), plan.ts // 4))


def _sta_pairs(plan, skv, ts_q):
    """(q, kv) pairs one windowed call computes: every q row of a tile with
    every real kv row of its table row's blocks (the short ref tail is not
    padded, so its missing rows cost nothing)."""
    real = [sum(min(plan.ts, skv - j * plan.ts) for j in row) for row in plan.table.tolist()]
    return ts_q * sum(real)


def _sdpa_masked_ms(q, k, v, mask, backward=None, err=None):
    """The library call for a windowed call: SDPA on the memory-efficient
    backend with the boolean block mask, forward, or forward + backward when
    `backward` is dO.  Timed only; returns (ms, None), or (None, the error,
    or `err` from an earlier call of the same kernel that failed)."""
    if err:
        return None, err
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            if backward is None:
                return timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)), None
            qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            return timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), backward,
                                                        retain_graph=True)), None
    except Exception as e:  # noqa: BLE001  (a yardstick that cannot run is recorded, not fatal)
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _sta_small(rnd, f32):
    """K7 and K8 against their plain versions at a ragged geometry: kv blocks
    of 32 rows and pose q tiles of 8, so 64-row chunks straddle tiles and
    blocks, and a ref tail block of 4 rows."""
    import torch

    from scail_tpu_torch.ops import sta as S

    plan = S.sta_plan((2, 8, 16), 100, 64, (1, 2), (1, 2), True, 3)
    tables = plan.tables("cuda")
    s = 100 + plan.video_len + 64
    q, k, v, do = (rnd(2, s, 2, 128) for _ in range(4))
    for name, rows, ts_q in _sta_calls(plan):
        qc, dc = q[:, rows], do[:, rows]
        out, lse = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q,
                                      with_lse=True)
        got = S.sta_windowed_bwd(qc, k, v, out, lse, dc, tables, ts=plan.ts, ts_q=ts_q)
        torch.cuda.synchronize()
        po, plse = S.sta_windowed_plain(*f32(qc, k, v), tables.table, ts=plan.ts, ts_q=ts_q)
        tag = f"sta {name} small (2,{rows.stop - rows.start},2,128)x{s} ts {plan.ts} ts_q {ts_q}"
        compare(f"{tag} out", out, po)
        compare(f"{tag} lse", lse, plse, lse=True)
        # the backward's plain version on the kernels' own bf16 inputs (its
        # rounding points), as at 48,832 tokens below
        want = S.sta_windowed_bwd_plain(qc, k, v, out, lse, dc, tables, ts=plan.ts, ts_q=ts_q)
        for g, w, n in zip(got, want, ("dq", "dk", "dv")):
            compare(f"{tag} {n}", g, w)


def _sta_kernels(gen, rnd, f32):
    """K7 (with and without the LSE) and K8 (dq, dk/dv) against their plain
    versions at 48,832 tokens with the main path's tables: K7 with and
    without the LSE at the sampling shape (2, 48,832, 12, 128), K7 with the
    LSE and K8 at the training shape (1, 48,832, 12, 128), each for the video
    call and the pose call, every output row compared.  Times are of one
    layer (video + pose call); the bound counts the pairs the tables visit,
    FLOPs over 989 TFLOP/s.  Then the dense ref rows of the same layer, as the
    STA path gives them to K2 (sampling) and K5 (training): the last 1,792 q
    rows against all 48,832 kv rows.  Returns the entries of K7, K8 and K2,
    and K5's at this shape under its own keys."""
    import numpy as np
    import torch

    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.ops import sta as S

    _sta_small(rnd, f32)
    grid, ref, pose, tile, window, wp, pkw = STA_GEOM
    plan = S.sta_plan(grid, ref, pose, tile, window, wp, pkw)
    tables = plan.tables("cuda")
    s = ref + plan.video_len + pose
    assert s == 48832 and plan.ts == 1344 and plan.table.shape == (28, 11)
    calls = _sta_calls(plan)
    # the block mask in the tile-major order the calls see, for SDPA
    t0 = time.perf_counter()
    order = plan.order
    full = S.sta_block_mask(s, grid, ref, pose, tile, window, wp, pkw)
    masks = {name: torch.from_numpy(full[np.ix_(order[rows], order)]) for name, rows, _ in calls}
    del full
    log(f"sta block mask {s}x{s} built in {time.perf_counter() - t0:.1f} s")
    results, lib_err = {}, {}

    def record(key, err, ms, plain_ms, flops, moved, lib_ms):
        b_ms, b_by = bound(flops, moved)
        usage = kernel_usage(STA_KERNELS[key])
        log(f"{key} (video + pose call): kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{b_ms / ms:.1%} of bound; mma.sync design {PARENT_MS[key]} ms), "
            f"plain {plain_ms:.3f} ms, SDPA with the block mask "
            f"{'none: ' + lib_err[key] if lib_ms is None else f'{lib_ms:.3f} ms'}, "
            f"bound {b_ms:.3f} ms ({b_by}); ptxas {usage}")
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms, tflops=flops / ms / 1e9,
                            share_of_bound=b_ms / ms,
                            registers=sorted({u["registers"] for u in usage.values()}),
                            spill_bytes=sum(u["spill_bytes"] for u in usage.values()))

    # sampling: K7 without the LSE (timed), and with it, batch 2
    q, k, v = rnd(2, s, 12, 128), rnd(2, s, 12, 128), rnd(2, s, 12, 128)
    acc = dict(err=0.0, ms=0.0, plain_ms=0.0, flops=0, moved=0, lib=0.0)
    lse_err = 0.0
    for name, rows, ts_q in calls:
        qc = q[:, rows]
        o, _ = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q)
        ol, lse = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q,
                                     with_lse=True)
        torch.cuda.synchronize()
        po, plse = S.sta_windowed_plain(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q)
        tag = f"(2,{qc.shape[1]},12,128)x{s}"
        acc["err"] = max(acc["err"], compare(f"sta fwd {name} {tag} out", o, po,
                                             key="sta_attention_fwd"))
        lse_err = max(lse_err, compare(f"sta fwd+lse {name} {tag} out", ol, po,
                                       key="sta_attention_fwd_lse"))
        compare(f"sta fwd+lse {name} {tag} lse", lse, plse, lse=True)
        if not torch.equal(o, ol):
            fail(f"sta fwd {name}: the outputs with and without the LSE differ")
        if not torch.equal(o, S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts,
                                                 ts_q=ts_q)[0]):
            fail(f"sta fwd {name}: two calls give different bits")
        del po, plse, ol, lse
        acc["ms"] += timed_ms(lambda: S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts,
                                                         ts_q=ts_q))
        acc["plain_ms"] += timed_ms(lambda: S.sta_windowed_plain(
            qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q), iters=1)
        acc["flops"] += 4 * 24 * _sta_pairs(plan, s, ts_q) * 128
        acc["moved"] += nbytes(qc, k, v, o)
        lib_ms, lib_err["sta_attention_fwd"] = _sdpa_masked_ms(
            qc.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), masks[name].cuda(),
            err=lib_err.get("sta_attention_fwd"))
        acc["lib"] = None if lib_ms is None or acc["lib"] is None else acc["lib"] + lib_ms
        del o
    record("sta_attention_fwd", acc["err"], acc["ms"], acc["plain_ms"], acc["flops"],
           acc["moved"], acc["lib"])
    results["flash_attention"] = _ref_rows_fwd(q, k, v, ref)
    del q, k, v
    torch.cuda.empty_cache()

    # training: K7 with the LSE, then K8, batch 1
    q, k, v, do = (rnd(1, s, 12, 128) for _ in range(4))
    scale = 128 ** -0.5
    fwd = dict(err=lse_err, ms=0.0, plain_ms=0.0, flops=0, moved=0, lib=0.0)
    bwd = {g: dict(err=0.0, ms=0.0, plain_ms=0.0, flops=0, moved=0) for g in ("dq", "dkv")}
    bwd_lib, dkv_block_ms = 0.0, 0.0
    for name, rows, ts_q in calls:
        qc, dc = q[:, rows], do[:, rows]
        o, lse = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q,
                                    with_lse=True)
        torch.cuda.synchronize()
        po, plse = S.sta_windowed_plain(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q)
        tag = f"(1,{qc.shape[1]},12,128)x{s}"
        fwd["err"] = max(fwd["err"], compare(f"sta fwd+lse {name} {tag} out", o, po,
                                             key="sta_attention_fwd_lse"))
        compare(f"sta fwd+lse {name} {tag} lse", lse, plse, lse=True)
        del po, plse
        fwd["ms"] += timed_ms(lambda: S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts,
                                                         ts_q=ts_q, with_lse=True))
        fwd["plain_ms"] += timed_ms(lambda: S.sta_windowed_plain(
            qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q), iters=1)
        pairs = _sta_pairs(plan, s, ts_q)
        fwd["flops"] += 4 * 12 * pairs * 128
        fwd["moved"] += nbytes(qc, k, v, o, lse)
        lib_ms, lib_err["sta_attention_fwd_lse"] = _sdpa_masked_ms(
            qc.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), masks[name].cuda(),
            err=lib_err.get("sta_attention_fwd_lse"))
        fwd["lib"] = None if lib_ms is None or fwd["lib"] is None else fwd["lib"] + lib_ms

        q2, lse2, delta = A._bwd_operands(qc, o, lse, dc, scale)
        ops = (q2, k, v, dc, lse2.contiguous(), delta.contiguous())
        dq = S.sta_windowed_bwd_dq(*ops, tables.table, ts=plan.ts, ts_q=ts_q, scale=scale)
        dk, dv = S.sta_windowed_bwd_dkv(*ops, tables.inv, tables.lens, ts=plan.ts, ts_q=ts_q,
                                        dkv_order=tables.dkv_order)
        again = (S.sta_windowed_bwd_dq(*ops, tables.table, ts=plan.ts, ts_q=ts_q, scale=scale),
                 *S.sta_windowed_bwd_dkv(*ops, tables.inv, tables.lens, ts=plan.ts, ts_q=ts_q,
                                         dkv_order=tables.dkv_order))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
            fail(f"sta bwd {name}: two calls give different bits")
        del again
        pdq = S.sta_windowed_bwd_plain(qc, k, v, o, lse, dc, tables, ts=plan.ts, ts_q=ts_q,
                                       grads="dq")[0]
        bwd["dq"]["err"] = max(bwd["dq"]["err"], compare(f"sta bwd dq {name} {tag}", dq, pdq,
                                                         key="sta_attention_bwd_dq"))
        del pdq
        _, pdk, pdv = S.sta_windowed_bwd_plain(qc, k, v, o, lse, dc, tables, ts=plan.ts,
                                               ts_q=ts_q, grads="dkv")
        bwd["dkv"]["err"] = max(bwd["dkv"]["err"], *(
            compare(f"sta bwd {n} {name} {tag}", g, w, key="sta_attention_bwd_dkv")
            for n, g, w in (("dk", dk, pdk), ("dv", dv, pdv))))
        del pdk, pdv
        bwd["dq"]["ms"] += timed_ms(lambda: S.sta_windowed_bwd_dq(
            *ops, tables.table, ts=plan.ts, ts_q=ts_q, scale=scale))
        bwd["dkv"]["ms"] += timed_ms(lambda: S.sta_windowed_bwd_dkv(
            *ops, tables.inv, tables.lens, ts=plan.ts, ts_q=ts_q, dkv_order=tables.dkv_order))
        dkv_block_ms += timed_ms(lambda: S.sta_windowed_bwd_dkv(
            *ops, tables.inv, tables.lens, ts=plan.ts, ts_q=ts_q))
        for g in ("dq", "dkv"):
            bwd[g]["plain_ms"] += timed_ms(lambda: S.sta_windowed_bwd_plain(
                qc, k, v, o, lse, dc, tables, ts=plan.ts, ts_q=ts_q, grads=g), iters=1)
        bwd["dq"]["flops"] += 6 * 12 * pairs * 128
        bwd["dkv"]["flops"] += 8 * 12 * pairs * 128
        bwd["dq"]["moved"] += nbytes(*ops, dq)
        bwd["dkv"]["moved"] += nbytes(*ops, dk, dv)
        lib_ms, lib_err["sta_attention_bwd"] = _sdpa_masked_ms(
            qc.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), masks[name].cuda(),
            backward=dc.transpose(1, 2), err=lib_err.get("sta_attention_bwd"))
        bwd_lib = None if lib_ms is None or bwd_lib is None else bwd_lib + lib_ms
        del o, lse, q2, ops, dq, dk, dv
    record("sta_attention_fwd_lse", fwd["err"], fwd["ms"], fwd["plain_ms"], fwd["flops"],
           fwd["moved"], fwd["lib"])
    for g in ("dq", "dkv"):
        lib_err[f"sta_attention_bwd_{g}"] = lib_err["sta_attention_bwd"]
        record(f"sta_attention_bwd_{g}", bwd[g]["err"], bwd[g]["ms"], bwd[g]["plain_ms"],
               bwd[g]["flops"], bwd[g]["moved"], bwd_lib)
    log(f"sta_attention_bwd_dkv launch order (video + pose call): heaviest first "
        f"{bwd['dkv']['ms']:.3f} ms, block order {dkv_block_ms:.3f} ms")
    for key, err in lib_err.items():
        if err and key in results:
            results[key]["library_error"] = err
    results.update(_ref_rows_bwd(q, k, v, do, ref))
    del q, k, v, do, masks
    torch.cuda.empty_cache()
    return results


def _ref_rows_fwd(q, k, v, ref):
    """K2 as the STA path runs it at sampling: the last `ref` rows of the
    tile-major q (a strided view) against every kv row, each output row and
    LSE against the plain version; times of kernel, plain and SDPA."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import attention as A

    qr = q[:, -ref:]
    o, lse = A.flash_attention(qr, k, v)
    torch.cuda.synchronize()
    po, plse = A.flash_attention_plain(qr, k, v)
    tag = f"flash (STA ref rows) {tuple(qr.shape)}x{k.shape[1]}"
    err = compare(f"{tag} out", o, po, key="flash_attention")
    compare(f"{tag} lse", lse, plse, lse=True)
    del po, plse
    ms = timed_ms(lambda: A.flash_attention(qr, k, v))
    plain_ms = timed_ms(lambda: A.flash_attention_plain(qr, k, v), iters=1)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qr.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
    flops = 4 * q.shape[0] * q.shape[2] * ref * k.shape[1] * 128
    b_ms, b_by = bound(flops, nbytes(qr, k, v, o, lse))
    log(f"{tag}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of bound; "
        f"mma.sync design {PARENT_MS['flash_attention']} ms), plain {plain_ms:.3f} ms, "
        f"SDPA {library_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, tflops=flops / ms / 1e9, share_of_bound=b_ms / ms)


def _ref_rows_bwd(q, k, v, do, ref):
    """K5 as the STA path runs it in training: dq of the last `ref` q rows
    and dk/dv of every kv row, against the plain versions (every row), with
    times of kernel, plain and SDPA's backward.  Returns K5's two entries."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.ops import attention as A

    qr, dr = q[:, -ref:], do[:, -ref:]
    o, lse = A.flash_attention(qr, k, v)
    scale = 128 ** -0.5
    q2, lse2, delta = A._bwd_operands(qr, o, lse, dr, scale)
    ops = (q2, k, v, dr, lse2.contiguous(), delta.contiguous())
    dq = A.flash_attention_bwd_dq(*ops, scale=scale)
    dk, dv = A.flash_attention_bwd_dkv(*ops)
    torch.cuda.synchronize()
    tag = f"flash bwd (STA ref rows) {tuple(qr.shape)}x{k.shape[1]}"
    pdq = A.flash_attention_bwd_plain(qr, k, v, o, lse, dr, grads="dq")[0]
    err = {"dq": compare(f"{tag} dq", dq, pdq, key="flash_attention_bwd_dq@sta")}
    del pdq
    _, pdk, pdv = A.flash_attention_bwd_plain(qr, k, v, o, lse, dr, grads="dkv")
    err["dkv"] = max(compare(f"{tag} {n}", g, w, key="flash_attention_bwd_dkv@sta")
                     for n, g, w in (("dk", dk, pdk), ("dv", dv, pdv)))
    del pdk, pdv
    ms = {"dq": timed_ms(lambda: A.flash_attention_bwd_dq(*ops, scale=scale)),
          "dkv": timed_ms(lambda: A.flash_attention_bwd_dkv(*ops))}
    plain_ms = {g: timed_ms(lambda: A.flash_attention_bwd_plain(qr, k, v, o, lse, dr, grads=g),
                            iters=1) for g in ("dq", "dkv")}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (qr, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    library_ms = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dr.transpose(1, 2),
                                                      retain_graph=True))
    del out, qt, kt, vt
    pairs = q.shape[0] * q.shape[2] * ref * k.shape[1]
    work = {"dq": (6 * pairs * 128, nbytes(*ops, dq)), "dkv": (8 * pairs * 128, nbytes(*ops, dk, dv))}
    results = {}
    for g in ("dq", "dkv"):
        b_ms, b_by = bound(*work[g])
        log(f"{tag} {g}: kernel {ms[g]:.3f} ms ({work[g][0] / ms[g] / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms[g]:.3f} ms, SDPA backward (dq+dk+dv) {library_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by})")
        results[f"flash_attention_bwd_{g}"] = dict(
            max_abs_err=err[g], ms=ms[g], plain_ms=plain_ms[g], bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, max_err_per_std=PER_STD[f"flash_attention_bwd_{g}@sta"])
    return results


def _build_dit(**params):
    import torch
    import yaml

    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        nc = yaml.safe_load(f)["model"]["network_config"]
    nc["params"].update(dtype="bf16", use_i2v_clip=True, **params)
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


# the dense DiT's launches per forward: in each of 30 layers K1, K3, the k
# rotary (K10) and the AdaLN LayerNorm before attention and before the MLP
# (K9), and K9 once more in the final layer
DIT_LAUNCHES = {"flash_attention_rope": 30, "dual_cross_attention": 30,
                "adaln_layer_norm": 61, "rotary": 30}


def phase_dit():
    import dataclasses

    import torch


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
        reset_counts()
        t0 = time.perf_counter()
        out = dit(x, t, ctx, **inp)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"DiT 1.3B forward, CFG batch 2, 48,832 tokens: {fwd_ms:.1f} ms; launches {counts}")
    _exact(counts, DIT_LAUNCHES, "one DiT forward")
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
    reset_counts()
    t0 = time.perf_counter()
    records = sample_video.main(argv)
    total = time.perf_counter() - t0
    counts = launch_counts()
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
    # 2 requests x 2 steps, one DiT forward at CFG batch 2 each
    _exact(counts, {k: 4 * v for k, v in DIT_LAUNCHES.items()}, "the CLI, 2 requests x 2 steps")
    return counts, records


# the DiT's launches per training step with remat: forward + recompute for the
# forward kernels, one each for the two backward kernels, in each of 30 layers;
# K9 twice per layer site and once in the final layer (not recomputed), K10
# on k in the forward and the recompute and on q in the backward (the K9 and
# K10 backwards are plain torch)
TRAIN_LAUNCHES_PER_STEP = {"flash_attention_rope": 60, "dual_cross_attention": 60,
                           "flash_attention_bwd_dq": 30, "flash_attention_bwd_dkv": 30,
                           "adaln_layer_norm": 121, "rotary": 90}
# One checkpoint of the 30-layer trainer state (f32 params, two Adam moments,
# EMA shadow) is ~23.4 GiB, and the chip machine allows ~45 GiB of disk writes
# per run: save and resume are checked on the same YAML cut to this depth.
RESUME_LAYERS = 4


TRAIN_WATCHED = ("layers.0.qkv.weight", "layers.29.mlp_out.weight", "final_layer.linear.weight",
                 "patch_embed.proj.weight")


def _train(argv, want_per_step, label, watched=TRAIN_WATCHED, on_start=None,
           on_first_grads=None):
    """The train CLI for 2 steps at full width and depth (`argv`): finite
    losses, the `watched` parameters move, exactly `want_per_step` kernel
    launches per step.  on_start(trainer) runs before the first step,
    on_first_grads(grads) on the first step's parameter gradients before
    clipping.  Returns (trainer, launch counts, stats)."""
    import math

    import torch

    import scail_tpu_torch.training.engine as engine_mod
    from scail_tpu_torch.cli import train
    from scail_tpu_torch.training.engine import Trainer

    seen = {"before": {}, "step_s": [], "clips": 0}
    real_fit, real_step = Trainer.fit, Trainer.train_step
    real_clip = engine_mod.clip_by_global_norm_

    def fit(self, *a, **kw):  # snapshot a few parameters before training
        if not seen["before"]:
            seen["before"] = {n: self.params[n].detach().clone() for n in watched}
            if on_start is not None:
                on_start(self)
        return real_fit(self, *a, **kw)

    def clip(grads, max_norm):  # the first step's gradients, before clipping
        seen["clips"] += 1
        if seen["clips"] == 1 and on_first_grads is not None:
            on_first_grads(grads)
        return real_clip(grads, max_norm)

    def train_step(self, batch):  # wall time of each step, device synchronised
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        seen["step_s"].append(time.perf_counter() - t0)
        return out

    Trainer.fit, Trainer.train_step, engine_mod.clip_by_global_norm_ = fit, train_step, clip
    try:
        full = argv + ["--train-iters", "2"]
        log(f"{label}: python -m scail_tpu_torch.cli.train " + " ".join(full))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(full)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.fit, Trainer.train_step, engine_mod.clip_by_global_norm_ = \
            real_fit, real_step, real_clip
    step_s = seen["step_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in trainer.history]
    moved = {n: (trainer.params[n].detach() - seen["before"][n]).abs().max().item()
             for n in watched}
    log(f"{label}: 2 steps in {total:.1f} s (with engine build and data); step seconds "
        f"{[round(x, 2) for x in step_s]}; losses {losses}; grad norms "
        f"{[m['grad_norm'] for m in trainer.history]}; peak allocated {peak_gb:.2f} GB; "
        f"launches {counts}; largest parameter change {moved}")
    _exact(counts, {k: 2 * v for k, v in want_per_step.items()}, f"{label}, 2 training steps")
    if trainer.step != 2 or not all(math.isfinite(x) for x in losses) or \
            not all(m["ok"] for m in trainer.history):
        fail(f"{label}: training did not take 2 finite steps: {trainer.history}")
    if not all(v > 0 for v in moved.values()):
        fail(f"{label}: the DiT's parameters did not change: {moved}")
    return trainer, counts, {"step_s": step_s, "losses": losses, "peak_gb": peak_gb}


def _grad_parity(dit, kernel, plain, small, label):
    """Relative L2 distance of the DiT's parameter gradients on the kernel
    path (config fields `kernel`) from the plain path (`plain`), batch 1 of a
    small latent `small` = (T, H, W); fails past GRAD_REL_TOL."""
    import dataclasses

    import torch

    cfg = dit.config
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(4), *small)
    x, t, ctx = (inp.pop(k)[:1] for k in ("x", "timesteps", "context"))
    inp = {k: v[:1] for k, v in inp.items()}
    w = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    grads = []
    for fields in (kernel, plain):
        dit.config = dataclasses.replace(cfg, **fields)
        dit.zero_grad(set_to_none=True)
        (dit(x, t, ctx, **inp).float() * w).sum().backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in dit.parameters()]))
    dit.config = cfg
    dit.zero_grad(set_to_none=True)
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    log(f"{label}: DiT parameter gradients, kernel path vs plain path (1, {small[0]}, 16, "
        f"{small[1]}, {small[2]}): relative L2 {rel:.3e} (tol {GRAD_REL_TOL})")
    if not rel < GRAD_REL_TOL:
        fail(f"{label}: the DiT's gradients on the kernel path disagree with the plain path")
    return rel


def _train_argv(base, data_root):
    return ["--base", base, "--data-root", data_root, "--image-size", "512", "896",
            "--num-frames", "81", "--batch-size", "1", "--warmup-iters", "1", "--seed", "0",
            "--device", "cuda"]


def _data_root(ex81):
    data_root = os.path.join(WORK, "train_data")
    os.makedirs(data_root, exist_ok=True)
    if not os.path.exists(os.path.join(data_root, "000")):
        os.symlink(ex81, os.path.join(data_root, "000"))
    return data_root


def phase_train(ex81):
    """The train CLI at full width and depth: 2 steps (the main path), then
    the DiT's gradients, kernel path against plain path; then save and
    resume at RESUME_LAYERS layers: 2 steps saved, 1 step resumed."""
    import gc
    import math
    import shutil

    import torch
    import yaml

    from scail_tpu_torch.cli import train

    base = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")
    argv = _train_argv(base, _data_root(ex81))
    trainer, counts, stats = _train(argv, TRAIN_LAUNCHES_PER_STEP, "train",
                                    on_first_grads=_keep_grads("dense"))
    BASELINE["dense"].update(loss=stats["losses"][0], peak_gb=stats["peak_gb"],
                             step_s=stats["step_s"])
    stats["grad_rel"] = _grad_parity(trainer.model, {"attn_impl": "auto"}, {"attn_impl": "xla"},
                                     (3, 16, 16), "train")
    del trainer
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
    short = _train_argv(cut_yaml, _data_root(ex81)) + ["--save", save]
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
    return counts, stats


# the STA DiT's launches: per forward, the video and the pose windowed calls
# (K7) and the dense ref rows (K2) in each of 30 layers, the dual cross-
# attention (K3), K9 as in the dense DiT and K10 on q and k; per training step
# with remat, forward and recompute of those, K7 with the LSE, and one
# backward of each windowed call (K8) and of the ref rows (K5)
STA_DIT_LAUNCHES = {"sta_attention_fwd": 60, "flash_attention": 30, "dual_cross_attention": 30,
                    "adaln_layer_norm": 61, "rotary": 60}
STA_TRAIN_LAUNCHES_PER_STEP = {"sta_attention_fwd_lse": 120, "flash_attention": 60,
                               "dual_cross_attention": 60, "sta_attention_bwd_dq": 60,
                               "sta_attention_bwd_dkv": 60, "flash_attention_bwd_dq": 30,
                               "flash_attention_bwd_dkv": 30, "adaln_layer_norm": 121,
                               "rotary": 120}
# a small latent (T, H, W) at which the DiT's default STA runs with the
# windowed pose and the pose-kv window: Hp 32, Wp 8, ts 192, pose tiles of 48
STA_SMALL = (3, 64, 16)


def _exact(counts, want, what):
    """Fail unless each kernel launched exactly as `want` says (0 where unnamed)."""
    got = {k: v for k, v in counts.items() if v}
    want = {k: v for k, v in want.items() if v}
    if got != want:
        fail(f"{what}: expected launches {want}, got {got}")


def phase_dit_sta():
    """The 1.3B DiT with attn_impl='sta' (the JAX defaults), all 30 layers, CFG
    batch 2 at 48,832 tokens: exact launches, a finite output, its time; its
    kernel path against its plain path (sta_impl='xla') on a small input."""
    import dataclasses

    import torch


    dit = _build_dit(attn_impl="sta")
    cfg = dit.config
    assert (cfg.sta_tile, cfg.sta_window, cfg.sta_windowed_pose, cfg.sta_pose_kv_window) == \
        ((3, 8), (3, 2), True, 3), cfg
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(2), 21, 64, 112)
    x, t, ctx = inp.pop("x"), inp.pop("timesteps"), inp.pop("context")
    with torch.inference_mode():
        dit(x, t, ctx, **inp)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = dit(x, t, ctx, **inp)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"STA DiT 1.3B forward, CFG batch 2, 48,832 tokens: {fwd_ms:.1f} ms; launches {counts}")
    _exact(counts, STA_DIT_LAUNCHES, "one STA DiT forward")
    if tuple(out.shape) != (2, 21, 16, 64, 112) or not torch.isfinite(out).all():
        fail(f"STA DiT output bad: shape {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    del out, x, ctx, inp

    small = _dit_inputs(torch.Generator(device="cuda").manual_seed(3), *STA_SMALL)
    xs, ts = small.pop("x"), small.pop("timesteps")
    ctx = small.pop("context")
    with torch.inference_mode():
        reset_counts()
        got = dit(xs, ts, ctx, **small).float()
        _exact(launch_counts(), STA_DIT_LAUNCHES, "STA DiT forward on the small input")
        dit.config = dataclasses.replace(cfg, sta_impl="xla")
        want = dit(xs, ts, ctx, **small).float()
        dit.config = cfg
    rel = ((got - want).norm() / want.norm()).item()
    log(f"STA DiT kernel path vs plain path (2, {STA_SMALL[0]}, 16, {STA_SMALL[1]}, "
        f"{STA_SMALL[2]}): relative L2 {rel:.3e} (tol {DIT_REL_TOL})")
    if not rel < DIT_REL_TOL:
        fail("STA DiT kernel path disagrees with the plain path")
    del dit
    torch.cuda.empty_cache()
    return fwd_ms


def phase_cli_sta(ex81):
    """The sampling CLI with --attn-impl sta: one 81-frame 512x896 request,
    2 steps, exactly 2 forwards' launches; the .mp4 decodes to 81 frames."""
    import numpy as np

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames

    prompts = os.path.join(WORK, "prompts_sta.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{ex81}\n")
    argv = ["--base", os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml"),
            os.path.join(ROOT, "configs", "sampling", "pose_cli.yaml"),
            "--input-type", "txt", "--input-file", prompts, "--sampling-steps", "2",
            "--attn-impl", "sta", "--device", "cuda",
            "--output-dir", os.path.join(WORK, "samples_sta")]
    log("CLI STA: python -m scail_tpu_torch.cli.sample_video " + " ".join(argv))
    reset_counts()
    records = sample_video.main(argv)
    counts = launch_counts()
    rec = records[0]
    out = rec["outputs"][0]
    decoded = load_video_frames(out)[0]
    log(f"CLI STA answered {len(records)} request in {rec['seconds']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in rec["phases"].items())
        + f"); {os.path.relpath(out, ROOT)} decodes to {decoded.shape} (mean "
        f"{decoded.mean():.1f}), samples finite {rec['finite']}; kernel launches {counts}")
    _exact(counts, {k: 2 * v for k, v in STA_DIT_LAUNCHES.items()}, "STA CLI, 2 steps")
    if len(records) != 1 or not (rec["finite"] and out.endswith(".mp4")
                                 and decoded.shape == (81, 512, 896, 3) and np.ptp(decoded) > 0):
        fail("STA request: expected one .mp4 of 81 finite, non-constant 512x896 frames")
    return counts, rec


def phase_train_sta(ex81):
    """The train CLI with an `attn_impl: sta` YAML (written under
    build/chip_smoke/) at full width and depth: 2 steps with exact launches,
    then the DiT's gradients, kernel path against plain path."""
    import gc

    import torch
    import yaml

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["network_config"]["params"]["attn_impl"] = "sta"
    sta_yaml = os.path.join(WORK, "scail_1p3b_sta.yaml")
    with open(sta_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    trainer, counts, stats = _train(_train_argv(sta_yaml, _data_root(ex81)),
                                    STA_TRAIN_LAUNCHES_PER_STEP, "train STA",
                                    on_first_grads=_keep_grads("sta"))
    BASELINE["sta"].update(loss=stats["losses"][0], peak_gb=stats["peak_gb"],
                           step_s=stats["step_s"])
    stats["grad_rel"] = _grad_parity(trainer.model, {"sta_impl": "auto"}, {"sta_impl": "xla"},
                                     STA_SMALL, "train STA")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return counts, stats


# phase 6c: the remat policies that keep the flash outputs.  Per training
# step, K1 (dense) launches once per layer in the forward and again in the
# recompute of the layers that do not keep their outputs: 30 under save_attn
# and offload_attn, 30 + 9 under save_attn_frac 0.7 (21 head layers); under
# STA save_attn, K7 with the LSE (video and pose calls) and K2 (ref rows)
# launch in the forward only.  Everything else is as under `default`.
REMAT_POLICY_LAUNCHES = {
    "save_attn": {**TRAIN_LAUNCHES_PER_STEP, "flash_attention_rope": 30},
    "save_attn_frac": {**TRAIN_LAUNCHES_PER_STEP, "flash_attention_rope": 39},
    "offload_attn": {**TRAIN_LAUNCHES_PER_STEP, "flash_attention_rope": 30},
}
STA_SAVE_ATTN_LAUNCHES_PER_STEP = {**STA_TRAIN_LAUNCHES_PER_STEP, "sta_attention_fwd_lse": 60,
                                   "flash_attention": 30}
# each policy's step-1 parameter gradients against `default`'s from the same
# seed: relative L2 (the same kernels; only the recompute differs)
POLICY_GRAD_REL_TOL = 1e-3
# offload_attn keeps the flash outputs in pinned host memory: its device peak
# may pass `default`'s by no more than this (GB)
OFFLOAD_PEAK_SLACK_GB = 0.5
LORA_RANK = 16
# merge_lora's forward against the factored one (bf16 compute, 30 layers)
LORA_MERGE_REL_TOL = DIT_REL_TOL

# `default`'s step-1 loss and gradients (on the host), dense and STA, from
# phases 6 and 6b
BASELINE = {"dense": {}, "sta": {}}


def _keep_grads(path):
    def keep(grads):
        BASELINE[path]["grads"] = {n: g.detach().to("cpu", copy=True) for n, g in grads.items()}
    return keep


def _grads_vs_baseline(path, out):
    """on_first_grads hook: the relative L2 distance of the step-1 gradients
    from `default`'s, one tensor on the card at a time, into out["rel"]."""
    import torch

    def compare(grads):
        base = BASELINE[path]["grads"]
        if set(grads) != set(base):
            fail(f"{path}: the gradients' names differ from `default`'s")
        diff = ref = torch.zeros((), dtype=torch.float64, device="cuda")
        for n, g in grads.items():
            b = base[n].to("cuda", non_blocking=True)
            diff = diff + (g.double() - b.double()).square().sum()
            ref = ref + b.double().square().sum()
        out["rel"] = (diff.sqrt() / ref.sqrt()).item()
    return compare


def _policy_yaml(label, **params):
    """A copy of the 1.3B YAML under build/chip_smoke/ with network params
    set (checkpoint_activations is on there, so the DiT remats)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        cfg = yaml.safe_load(f)
    nc = cfg["model"]["network_config"]["params"]
    if not nc.get("transformer_args", {}).get("checkpoint_activations"):
        fail("the 1.3B YAML does not turn remat on (checkpoint_activations)")
    nc.update(params)
    path = os.path.join(WORK, f"scail_1p3b_{label}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _stash_check(policy, **params):
    """The flash outputs a policy keeps against a fresh launch on the q, k
    and v that the recompute gives (they must be bit-equal, or the recompute
    would pair the kept outputs with other inputs): a 2-layer DiT at full
    width, batch 1, 48,832 tokens, one forward and backward.  Not counted."""
    import torch

    from scail_tpu_torch.models import dit as dit_mod
    from scail_tpu_torch.ops.attention import FlashStash

    diffs = []

    class CheckedStash(FlashStash):
        def replay(self, launch):
            kept = super().replay(launch)
            fresh = launch()
            diffs.append(max((a.float() - b.float()).abs().max().item()
                             for a, b in zip(kept, fresh)))
            return kept

    dit = _build_dit(num_layers=2, remat_policy=policy, **params)
    dit.requires_grad_(True).train()
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(6), 21, 64, 112)
    inp = {k: v[:1] for k, v in inp.items()}
    x, t, ctx = inp.pop("x"), inp.pop("timesteps"), inp.pop("context")
    dit_mod.FlashStash = CheckedStash
    try:
        out = dit(x, t, ctx, **inp)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
    finally:
        dit_mod.FlashStash = FlashStash
    kept_layers = dit_mod.kept_flash_layers(dit.config)
    per_layer = 3 if dit.config.attn_impl == "sta" else 1
    log(f"stash check {policy} {params or ''}: {len(diffs)} kept flash outputs in {kept_layers} "
        f"of 2 layers against a fresh launch on the recomputed inputs: max abs diff "
        f"{max(diffs) if diffs else None}")
    if len(diffs) != kept_layers * per_layer or any(d != 0 for d in diffs):
        fail(f"{policy}: the kept flash outputs are not those of the recomputed q, k and v")
    del dit, out
    torch.cuda.empty_cache()
    return max(diffs)


def phase_train_remat(ex81):
    """Phase 6c: the train CLI at full width and depth under each remat
    policy that keeps the flash outputs (dense save_attn, save_attn_frac 0.7,
    offload_attn; STA save_attn): exact launches, step 1's loss bit-equal to
    `default`'s (phases 6, 6b) from the same seed, the step-1 gradients within
    POLICY_GRAD_REL_TOL, peaks and step seconds; before each, the kept outputs
    against a fresh launch (_stash_check).  Returns ({path: launch counts},
    {policy: stats})."""
    import gc

    import torch

    t_phase = time.perf_counter()
    counts, stats = {}, {}
    runs = [("save_attn", "dense", dict(remat_policy="save_attn")),
            ("save_attn_frac", "dense", dict(remat_policy="save_attn_frac", remat_save_frac=0.7)),
            ("offload_attn", "dense", dict(remat_policy="offload_attn")),
            ("sta_save_attn", "sta", dict(remat_policy="save_attn", attn_impl="sta"))]
    for label, path, params in runs:
        stash_diff = _stash_check(params["remat_policy"],
                                  **{k: v for k, v in params.items() if k != "remat_policy"})
        want = (STA_SAVE_ATTN_LAUNCHES_PER_STEP if path == "sta"
                else REMAT_POLICY_LAUNCHES[params["remat_policy"]])
        grads = {}
        trainer, c, st = _train(_train_argv(_policy_yaml(label, **params), _data_root(ex81)),
                                want, f"train {label}",
                                on_first_grads=_grads_vs_baseline(path, grads))
        st.update(grad_rel=grads["rel"], stash_max_diff=stash_diff,
                  loss_equal=st["losses"][0] == BASELINE[path]["loss"])
        log(f"train {label}: step-1 loss {st['losses'][0]!r} against default's "
            f"{BASELINE[path]['loss']!r} (bit-equal {st['loss_equal']}); step-1 gradients "
            f"relative L2 {grads['rel']:.3e} from default's (tol {POLICY_GRAD_REL_TOL}); peak "
            f"{st['peak_gb']:.2f} GB against default's {BASELINE[path]['peak_gb']:.2f} GB; steps "
            f"{[round(x, 2) for x in st['step_s']]} s against default's "
            f"{[round(x, 2) for x in BASELINE[path]['step_s']]} s")
        if not st["loss_equal"]:
            fail(f"{label}: step 1's loss differs from default's")
        if not grads["rel"] <= POLICY_GRAD_REL_TOL:
            fail(f"{label}: step 1's gradients differ from default's")
        if label == "offload_attn" and \
                st["peak_gb"] > BASELINE[path]["peak_gb"] + OFFLOAD_PEAK_SLACK_GB:
            fail(f"offload_attn: device peak {st['peak_gb']:.2f} GB passes default's + "
                 f"{OFFLOAD_PEAK_SLACK_GB} GB")
        counts[f"train_cli_{label}"], stats[label] = c, st
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    for path in BASELINE.values():
        path.pop("grads", None)
    log(f"phase 6c (remat policies): {time.perf_counter() - t_phase:.1f} s")
    return counts, stats


def phase_train_lora(ex81):
    """Phase 6d: the train CLI with --lora-rank 16 at full width and depth,
    `default` remat: exact launches (those of the full fine-tune), every base
    parameter bit-equal after 2 steps, every lora_b non-zero, the peak; then
    merge_lora's forward against the factored forward on a small input; then
    save and resume at RESUME_LAYERS layers under --lora-rank (<iter>/ema
    written, `latest` names the finished iteration)."""
    import gc
    import math
    import shutil

    import torch

    from scail_tpu_torch.cli import train
    from scail_tpu_torch.training.checkpoint import read_latest
    from scail_tpu_torch.training.lora import merge_lora

    t_phase = time.perf_counter()
    base_yaml = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")
    lora = ["--lora-rank", str(LORA_RANK)]
    before = {}

    def snapshot(trainer):  # the frozen base, on the host
        before.update({n: t.detach().to("cpu", copy=True)
                       for n, t in trainer.model.state_dict().items() if "lora_" not in n})

    trainer, counts, st = _train(_train_argv(base_yaml, _data_root(ex81)) + lora,
                                 TRAIN_LAUNCHES_PER_STEP, "train LoRA",
                                 watched=("layers.0.qkv.lora_b", "layers.29.mlp_out.lora_b"),
                                 on_start=snapshot)
    model = trainer.model
    state = model.state_dict()
    changed = [n for n, t in before.items() if not torch.equal(state[n].cpu(), t)]
    lora_b = [n for n in state if n.endswith("lora_b")]
    zero_b = [n for n in lora_b if not bool(state[n].any())]
    trained = sum(p.numel() for p in trainer.params.values())
    log(f"train LoRA: {len(before)} base tensors bit-equal after 2 steps: {not changed}; "
        f"{len(lora_b)} lora_b, all non-zero: {not zero_b}; {trained / 1e6:.2f} M trained "
        f"parameters; peak {st['peak_gb']:.2f} GB (full fine-tune "
        f"{BASELINE['dense']['peak_gb']:.2f} GB); steps {[round(x, 2) for x in st['step_s']]} s")
    if changed or zero_b or len(lora_b) != 7 * model.config.num_layers:
        fail(f"LoRA training: base tensors changed {changed[:4]}, zero lora_b {zero_b[:4]}, "
             f"{len(lora_b)} lora_b")
    st.update(base_bit_equal=not changed, trained_params=trained)
    del before, state

    # merge_lora: the merged DiT against the factored one, with B drawn so
    # that the delta is ~10% of each output
    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(9), 3, 16, 16)
    x, t, ctx = inp.pop("x"), inp.pop("timesteps"), inp.pop("context")
    with torch.inference_mode():
        factored = model(x, t, ctx, **inp).float()
        merge_lora(model)
        merged = model(x, t, ctx, **inp).float()
    rel = ((merged - factored).norm() / factored.norm()).item()
    log(f"merge_lora: merged vs factored forward (2, 3, 16, 16, 16), 30 layers: relative L2 "
        f"{rel:.3e} (tol {LORA_MERGE_REL_TOL})")
    if not rel <= LORA_MERGE_REL_TOL or any("lora_" in n for n in model.state_dict()):
        fail("merge_lora: the merged DiT disagrees with the factored one")
    st["merge_rel"] = rel
    del trainer, model, factored, merged
    gc.collect()
    torch.cuda.empty_cache()

    # save and resume under --lora-rank at RESUME_LAYERS layers
    cut_yaml = os.path.join(WORK, f"scail_1p3b_{RESUME_LAYERS}layers.yaml")
    save = os.path.join(WORK, "train_run_lora")
    shutil.rmtree(save, ignore_errors=True)
    short = _train_argv(cut_yaml, _data_root(ex81)) + lora + ["--save", save]
    first = train.main(short + ["--train-iters", "2"])
    latest = read_latest(save)
    has_ema = os.path.isfile(os.path.join(save, "2", "ema", "state.pt"))
    del first
    gc.collect()
    resumed = train.main(short + ["--train-iters", "3", "--resume"])
    log(f"train LoRA at {RESUME_LAYERS} layers: saved at step 2 (latest {latest!r}, "
        f"<iter>/ema written: {has_ema}), resumed to step {resumed.step} (latest "
        f"{read_latest(save)!r}), loss {resumed.history[0]['loss'] if resumed.history else None}")
    if latest != "2" or not has_ema or resumed.step != 3 or read_latest(save) != "3" or \
            not math.isfinite(resumed.history[0]["loss"]):
        fail("LoRA save and resume did not go on from step 2 with its EMA double-save")
    del resumed
    shutil.rmtree(save, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    st["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 6d (LoRA): {st['phase_s']:.1f} s")
    return counts, st


# the 14B paths' launches: one forward runs 8 quantized linears (qkv,
# attn_out, cross_q, cross_kv, clip_kv, cross_out, mlp_in, mlp_out), one
# self-attention, one dual cross-attention, two K9 and the rotary of k (of q
# and k under int8-QK) in each of 40 layers, and K9 in the final layer
DIT14B_W8_LAUNCHES = {"w8a16_matmul": 320, "flash_attention_rope": 40, "dual_cross_attention": 40,
                      "adaln_layer_norm": 81, "rotary": 40}
E2E14B_W4_LAUNCHES = {"w4a16_matmul": 1280, "flash_attention_rope": 160,
                      "dual_cross_attention": 160, "adaln_layer_norm": 324,
                      "rotary": 160}  # 2 steps x 2 CFG halves
CLI14B_INT8_LAUNCHES = {"flash_attention_int8": 80, "dual_cross_attention": 80,
                        "adaln_layer_norm": 162, "rotary": 160}  # 2 steps
DIT14B_WIDTHS = (5120, 40, 40, 13824)
# a small latent (T, H, W) for the 14B kernel-vs-plain checks: 304 tokens
SMALL_14B = (3, 16, 16)


def _config_14b(**params):
    """The DiTConfig of configs/video_model/scail_14b.yaml, bf16, with CLIP."""
    import yaml

    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "video_model", "scail_14b.yaml")) as f:
        nc = yaml.safe_load(f)["model"]["network_config"]
    nc["params"].update(dtype="bf16", use_i2v_clip=True, **params)
    cfg = instantiate_from_config(nc).config
    got = (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.inner_hidden_size)
    if got != DIT14B_WIDTHS:
        fail(f"the 14B YAML gives widths {got}, expected {DIT14B_WIDTHS}")
    return cfg


def _plain_path_check(dit, plain_fields, label):
    """Relative L2 distance of the DiT's kernel path from its plain path
    (config fields `plain_fields`) with the same weights, CFG batch 2 at
    SMALL_14B; fails past DIT_REL_TOL."""
    import dataclasses

    import torch

    from scail_tpu_torch.cli.bench_14b_quant import dit_inputs, run_dit

    cfg = dit.config
    small = dit_inputs(cfg, 2, torch.device("cuda"), torch.Generator(device="cuda").manual_seed(3),
                       latent=SMALL_14B)
    with torch.inference_mode():
        got = run_dit(dit, small).float()
        dit.config = dataclasses.replace(cfg, **plain_fields)
        want = run_dit(dit, small).float()
        dit.config = cfg
    rel = ((got - want).norm() / want.norm()).item()
    log(f"{label}: kernel path vs plain path {plain_fields} (2, {SMALL_14B[0]}, 16, "
        f"{SMALL_14B[1]}, {SMALL_14B[2]}): relative L2 {rel:.3e} (tol {DIT_REL_TOL})")
    if not rel < DIT_REL_TOL:
        fail(f"{label}: the kernel path disagrees with the plain path")
    return rel


def phase_dit14b_w8():
    """The 14B DiT with random W8A16 layer linears (bench_14b_quant's
    build_random_quant_params), all 40 layers: one forward at CFG batch 2,
    48,832 tokens, exact launches, finite output, parameter and peak GB; then
    the kernel path against the plain path (plain attention, plain W8A16)."""
    import gc

    import torch

    from scail_tpu_torch.cli.bench_14b_quant import (build_random_quant_params, dit_inputs,
                                                     model_bytes, run_dit)

    cfg = _config_14b()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(6)
    dit = build_random_quant_params(cfg, 8, torch.device("cuda"), gen)
    param_gb = model_bytes(dit) / 1e9
    inp = dit_inputs(cfg, 2, torch.device("cuda"), gen)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = run_dit(dit, inp)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"DiT 14B W8A16 forward, CFG batch 2, 48,832 tokens: {fwd_ms:.1f} ms; parameters "
        f"{param_gb:.2f} GB, peak allocated {peak_gb:.2f} GB; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    _exact(counts, DIT14B_W8_LAUNCHES, "one 14B W8A16 forward")
    if tuple(out.shape) != (2, 21, 16, 64, 112) or not torch.isfinite(out).all():
        fail(f"14B W8A16 output bad: shape {tuple(out.shape)}, finite "
             f"{bool(torch.isfinite(out).all())}")
    del out, inp
    rel = _plain_path_check(dit, {"attn_impl": "xla", "quant_impl": "xla"}, "DiT 14B W8A16")
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(fwd_ms=fwd_ms, param_gb=param_gb, peak_gb=peak_gb, rel=rel)


def phase_e2e_14b_w4():
    """`python -m scail_tpu_torch.cli.bench_14b_e2e --bits 4 --steps 2` through
    main(argv): exact launches, 81 finite decoded frames."""
    import gc

    import torch

    from scail_tpu_torch.cli import bench_14b_e2e

    argv = ["--bits", "4", "--steps", "2"]
    log("14B W4A16 clip: python -m scail_tpu_torch.cli.bench_14b_e2e " + " ".join(argv))
    reset_counts()
    t0 = time.perf_counter()
    rec = bench_14b_e2e.main(argv)
    total = time.perf_counter() - t0
    counts = launch_counts()
    log(f"14B W4A16 clip: {total:.1f} s in all; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    _exact(counts, E2E14B_W4_LAUNCHES, "the 14B W4A16 clip, 2 steps")
    if rec.get("decoded_shape") != [1, 81, 3, 512, 896] or not rec.get("decoded_finite") \
            or not rec["latent_finite"]:
        fail(f"14B W4A16 clip: expected 81 finite 512x896 frames, got {rec}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(rec, total_s=total)


def phase_cli_14b_int8(ex81):
    """The sampling CLI with the 14B YAML, bf16 weights and --attn-impl
    pallas_int8: the 81-frame request, 2 steps, exact launches, the .mp4's
    frames, per-phase seconds and peak GB.  Then a bf16 14B DiT built on the
    meta device one parameter at a time (as the engine builds it): its build
    peak must stay within 1 GB of its bf16 parameters (no whole f32 copy),
    and its int8 kernel path is held against its plain path."""
    import gc

    import numpy as np
    import torch

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.models.dit import DiT

    prompts = os.path.join(WORK, "prompts_14b.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{ex81}\n")
    argv = ["--base", os.path.join(ROOT, "configs", "video_model", "scail_14b.yaml"),
            os.path.join(ROOT, "configs", "sampling", "pose_cli.yaml"),
            "--input-type", "txt", "--input-file", prompts, "--sampling-steps", "2",
            "--attn-impl", "pallas_int8", "--device", "cuda",
            "--output-dir", os.path.join(WORK, "samples_14b_int8")]
    log("CLI 14B int8: python -m scail_tpu_torch.cli.sample_video " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    records = sample_video.main(argv)
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = records[0]
    out = rec["outputs"][0]
    decoded = load_video_frames(out)[0]
    log(f"CLI 14B int8 answered {len(records)} request in {rec['seconds']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in rec["phases"].items())
        + f"; {total:.1f} s with the engine build); {os.path.relpath(out, ROOT)} decodes to "
        f"{decoded.shape} (mean {decoded.mean():.1f}), samples finite {rec['finite']}; peak "
        f"allocated {peak_gb:.2f} GB; launches {  {k: v for k, v in counts.items() if v} }")
    _exact(counts, CLI14B_INT8_LAUNCHES, "the 14B int8 CLI, 2 steps")
    if len(records) != 1 or not (rec["finite"] and out.endswith(".mp4")
                                 and decoded.shape == (81, 512, 896, 3) and np.ptp(decoded) > 0):
        fail("14B int8 request: expected one .mp4 of 81 finite, non-constant 512x896 frames")
    del records
    gc.collect()
    torch.cuda.empty_cache()

    cfg = _config_14b(attn_impl="pallas_int8")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dit = DiT(cfg, device="meta")
    dit.init_weights_(torch.Generator(device="cuda").manual_seed(7), device=torch.device("cuda"),
                      dtype=cfg.compute_dtype)
    dit.eval()
    param_gb = sum(p.numel() * p.element_size() for p in dit.parameters()) / 1e9
    build_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"bf16 14B DiT built one parameter at a time: parameters {param_gb:.2f} GB, build "
        f"peak {build_gb:.2f} GB above what was allocated before (an f32 copy would add "
        f"{2 * param_gb:.1f} GB)")
    if not build_gb < param_gb + 1.0:
        fail("building the bf16 14B DiT held more than its parameters and one f32 parameter")
    rel = _plain_path_check(dit, {"quant_impl": "xla"}, "DiT 14B int8 attention")
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(rec, total_s=total, peak_gb=peak_gb, param_gb=param_gb,
                        build_gb=build_gb, rel=rel)


# the long clip: 161 frames -> 41 latent frames in tiles of 21 overlapping by
# 8 ([0, 20], [13, 33], [20, 40]); each of the 2 steps denoises the tile pairs
# (0, 1) and (1, 2), 4 DiT forwards at CFG batch 2 and 48,832 tokens
LONG_TILES = [(0, 20), (13, 33), (20, 40)]
LONG_FORWARDS = 8
LONG_LAUNCHES = {k: LONG_FORWARDS * v for k, v in DIT_LAUNCHES.items()}


def _tokens(x_shape, patch=(2, 2)):
    """The DiT's fused sequence for a latent (b, T, C, H, W): ref + video +
    half-resolution pose tokens."""
    T, H, W = x_shape[1], x_shape[3] // patch[0], x_shape[4] // patch[1]
    return H * W + T * H * W + T * (H // 2) * (W // 2)


def phase_cli_long():
    """The sampling CLI with the long-clip YAML (RFSamplerLong) on a 161-frame
    512x896 synthetic example, 2 steps: 3 tiles, 8 DiT forwards at CFG batch 2
    and 48,832 tokens, exact launches, the .mp4's 161 frames, per-phase
    seconds and peak GB."""
    import gc

    import numpy as np
    import torch

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.models.dit import DiT

    ex161 = os.path.join(WORK, "synthetic_161")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_synthetic_example.py"),
                    ex161, "--frames", "161", "--size", "512", "896"], check=True, timeout=600)
    prompts = os.path.join(WORK, "prompts_long.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{ex161}\n")
    argv = ["--base", os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml"),
            os.path.join(ROOT, "configs", "sampling", "pose_cli_long.yaml"),
            "--input-type", "txt", "--input-file", prompts, "--sampling-steps", "2",
            "--device", "cuda", "--output-dir", os.path.join(WORK, "samples_long")]
    log("CLI long clip: python -m scail_tpu_torch.cli.sample_video " + " ".join(argv))
    seen = {"tiles": [], "forwards": []}
    real_tiles, real_forward = sample_video.make_tile_indices, DiT.forward

    def make_tile_indices(*a):
        seen["tiles"].append(real_tiles(*a))
        return seen["tiles"][-1]

    def forward(self, x, *a, **kw):
        seen["forwards"].append((x.shape[0], _tokens(x.shape)))
        return real_forward(self, x, *a, **kw)

    sample_video.make_tile_indices, DiT.forward = make_tile_indices, forward
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        records = sample_video.main(argv)
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        sample_video.make_tile_indices, DiT.forward = real_tiles, real_forward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = records[0]
    out = rec["outputs"][0]
    decoded = load_video_frames(out)[0]
    tiles = [(t[0], t[-1]) for t in seen["tiles"][0]] if seen["tiles"] else None
    log(f"CLI long clip answered {len(records)} request in {rec['seconds']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in rec["phases"].items())
        + f"; {total:.1f} s with the engine build); tiles {tiles}; DiT forwards (batch, tokens) "
        f"{seen['forwards']}; {os.path.relpath(out, ROOT)} decodes to {decoded.shape} (mean "
        f"{decoded.mean():.1f}), samples finite {rec['finite']}; peak allocated {peak_gb:.2f} GB; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    if tiles != LONG_TILES or seen["forwards"] != [(2, 48832)] * LONG_FORWARDS:
        fail(f"long clip: expected tiles {LONG_TILES} and {LONG_FORWARDS} forwards at CFG batch "
             f"2 and 48,832 tokens, got {tiles} and {seen['forwards']}")
    _exact(counts, LONG_LAUNCHES, "the long-clip CLI, 2 steps")
    if len(records) != 1 or not (rec["finite"] and out.endswith(".mp4")
                                 and decoded.shape == (161, 512, 896, 3) and np.ptp(decoded) > 0):
        fail("long-clip request: expected one .mp4 of 161 finite, non-constant 512x896 frames")
    del records
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(rec, total_s=total, peak_gb=peak_gb)


# the released files' names, written from the port's modules: the reverse of
# scail_tpu_torch/convert/torch_ckpt.py, wan_vae_ckpt.py and the umt5 / CLIP
# loaders, kept here so the files do not come from the code that reads them
SAT = "model.diffusion_model."
SAT_GLOBAL = {"patch_embed.proj": "mixins.patch_embed.proj",
              "patch_embed.proj_pose": "mixins.patch_embed.proj_pose",
              "time_embed.fc1": "time_embed.0", "time_embed.fc2": "time_embed.2",
              "text_embedding.fc1": "text_embedding.0", "text_embedding.fc2": "text_embedding.2",
              "final_layer.linear": "mixins.final_layer.linear",
              "adaln_projection.fc": "adaln_projection.1",
              "clip_proj.ln_in": "clip_proj.proj.0", "clip_proj.fc1": "clip_proj.proj.1",
              "clip_proj.fc2": "clip_proj.proj.3", "clip_proj.ln_out": "clip_proj.proj.4"}
SAT_LAYER = {"qkv": "transformer.layers.{}.attention.query_key_value",
             "attn_out": "transformer.layers.{}.attention.dense",
             "cross_q": "transformer.layers.{}.cross_attention.query",
             "cross_kv": "transformer.layers.{}.cross_attention.key_value",
             "cross_out": "transformer.layers.{}.cross_attention.dense",
             "mlp_in": "transformer.layers.{}.mlp.dense_h_to_4h",
             "mlp_out": "transformer.layers.{}.mlp.dense_4h_to_h",
             "adaln": "mixins.adaln_layer.adaLN_modulations.{}",
             "q_norm": "mixins.adaln_layer.query_layernorm_list.{}",
             "k_norm": "mixins.adaln_layer.key_layernorm_list.{}",
             "cross_q_norm": "mixins.adaln_layer.cross_query_layernorm_list.{}",
             "cross_k_norm": "mixins.adaln_layer.cross_key_layernorm_list.{}",
             "clip_k_norm": "mixins.adaln_layer.clip_feature_key_layernorm_list.{}",
             "clip_kv": "mixins.adaln_layer.clip_feature_key_value_list.{}"}
T5_BLOCK = {"norm1.scale": "norm1.weight", "q.weight": "attn.q.weight",
            "k.weight": "attn.k.weight", "v.weight": "attn.v.weight", "o.weight": "attn.o.weight",
            "pos_emb": "pos_embedding.embedding.weight", "norm2.scale": "norm2.weight",
            "gate.weight": "ffn.gate.0.weight", "fc1.weight": "ffn.fc1.weight",
            "fc2.weight": "ffn.fc2.weight"}
CLIP_BLOCK = {"norm1": "norm1", "to_qkv": "attn.to_qkv", "proj": "attn.proj", "norm2": "norm2",
              "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}


def _leaf(leaf):
    return "weight" if leaf == "scale" else leaf


def sat_dit_file(sd):
    """A DiT state dict -> the SAT checkpoint's 'module': SAT names, the patch
    convs (h, in, 1, 2, 2), the AdaLN tables with their leading 1."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if k == "final_layer.adaln":
            out[SAT + "mixins.final_layer.adaLN_modulation"] = v[None]
        elif parts[0] == "layers":
            name = SAT_LAYER[parts[2]].format(parts[1])
            out[SAT + name + ("." + _leaf(parts[3]) if len(parts) > 3 else "")] = \
                v[None] if parts[2] == "adaln" else v
        else:
            if parts[0] == "patch_embed" and parts[2] == "weight":
                v = v.reshape(v.shape[0], -1, 1, 2, 2)
            out[SAT + SAT_GLOBAL[".".join(parts[:2])] + "." + _leaf(parts[2])] = v
    return out


def wan_vae_file(sd):
    """A WanVAEModel state dict -> Wan2.1_VAE.pth's tensors, in f32 as the
    released file: RMS gammas (c, 1, 1) in the attention blocks, (c, 1, 1, 1)
    elsewhere."""
    def gamma(k, v):
        return v.reshape(-1, 1, 1) if k.endswith(".norm.gamma") else v.reshape(-1, 1, 1, 1)

    return {k: (gamma(k, v) if k.endswith(".gamma") else v).float() for k, v in sd.items()}


def clip_file(sd):
    """A ClipVisionTower state dict -> the reference's visual.* names."""
    out = {}
    for k, v in sd.items():
        k = k.replace(".scale", ".weight")
        if k.startswith("layers."):
            _, i, mod, leaf = k.split(".")
            k = f"transformer.{i}.{CLIP_BLOCK[mod]}.{leaf}"
        out["visual." + k] = v
    return out


def umt5_file(sd):
    """A UMT5Encoder state dict -> models_t5_umt5-xxl-enc-bf16.pth's names."""
    out = {}
    for k, v in sd.items():
        if k in ("token_embedding", "norm.scale"):
            out[{"token_embedding": "token_embedding.weight", "norm.scale": "norm.weight"}[k]] = v
        else:
            _, i, rest = k.split(".", 2)
            out[f"blocks.{i}.{T5_BLOCK[rest]}"] = v
    return out


def _save_cold(obj, path):
    """torch.save, then flush the file and drop it from the page cache, so a
    load reads the disk as a fresh machine's would.  Returns the file's bytes."""
    import torch

    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return os.path.getsize(path)


def _cpu_state(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _held(name, module, source, dtype):
    """Fail unless every tensor of `module` is on the card and bit-equal to
    `source` (the state it was written from) cast to `dtype`."""
    import torch

    got = module.state_dict()
    if set(got) != set(source):
        fail(f"load: {name} has parameters {sorted(set(got) ^ set(source))[:4]} that its "
             "source has not, or the other way")
    off = [k for k, v in got.items() if v.device.type != "cuda"]
    bad = [k for k, v in got.items()
           if v.dtype != dtype or not torch.equal(v, source[k].to("cuda", dtype))]
    if off or bad:
        fail(f"load: {name} is not its source on the card: off the card {off[:4]}, "
             f"not bit-equal {bad[:4]}")
    return len(got)


# the --load request: 2 steps, one DiT forward at CFG batch 2 each
LOAD_LAUNCHES = {k: 2 * v for k, v in DIT_LAUNCHES.items()}


def phase_load(ex81):
    """Load the released files' layouts: an engine made from seeds on the card
    is written in the reference's layouts at full width (the 1.3B DiT in bf16
    under SAT names with `latest`, the Wan VAE in f32, CLIP ViT-H under
    visual.*, umt5-xxl with all 24 layers in bf16), each file flushed and
    dropped from the page cache; a copy of the 1.3B YAML points at them.
    The sampling CLI with --load answers the 81-frame request in 2 steps
    (exact launches, a finite, non-constant clip); every loaded module is
    bit-equal on the card to its source; the device peak of load_checkpoint
    stays within 1 GB of the DiT's parameters.  Then the train CLI with
    --load takes one full-depth step from the file's weights in f32."""
    import gc
    import math
    import shutil

    import numpy as np
    import torch
    import yaml

    from scail_tpu_torch.cli import sample_video, train
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.engine import VideoDiffusionEngine
    from scail_tpu_torch.models.umt5 import UMT5Config
    from scail_tpu_torch.training.engine import Trainer
    from scail_tpu_torch.utils.config import load_configs, split_reference_config

    t_phase = time.perf_counter()
    work = os.path.join(WORK, "load")
    shutil.rmtree(work, ignore_errors=True)
    base = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")

    # the source engine, from seeds on the card; umt5 at full depth
    src = VideoDiffusionEngine(dict(split_reference_config(load_configs([base]))[1]),
                               device="cuda")
    src.conditioner.embedders[0].init(torch.Generator(device="cuda").manual_seed(12),
                                      UMT5Config(), device=torch.device("cuda"))
    src.init_params(torch.Generator(device="cuda").manual_seed(11))
    sources = {"dit": _cpu_state(src.dit), "vae": _cpu_state(src.first_stage_model.model),
               "clip": _cpu_state(src.i2v_clip.model),
               "umt5": _cpu_state(src.conditioner.embedders[0].model)}
    del src
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(work, "ckpt")
    paths = {"dit": os.path.join(ckpt, "1", "mp_rank_00_model_states.pt"),
             "vae": os.path.join(work, "Wan2.1_VAE.pth"),
             "clip": os.path.join(work, "models_clip_open-clip-xlm-roberta-large-vit-huge-14-"
                                        "onlyvisual.pth"),
             "umt5": os.path.join(work, "umt5-xxl", "models_t5_umt5-xxl-enc-bf16.pth")}
    t0 = time.perf_counter()
    written = {"dit": _save_cold({"module": sat_dit_file(sources["dit"]), "iteration": 1},
                                 paths["dit"]),
               "vae": _save_cold(wan_vae_file(sources["vae"]), paths["vae"]),
               "clip": _save_cold(clip_file(sources["clip"]), paths["clip"]),
               "umt5": _save_cold(umt5_file(sources["umt5"]), paths["umt5"])}
    with open(os.path.join(ckpt, "latest"), "w") as f:
        f.write("1")
    write_s = time.perf_counter() - t0
    with open(base) as f:
        cfg = yaml.safe_load(f)
    m = cfg["model"]
    m["first_stage_config"]["params"]["vae_pth"] = paths["vae"]
    m["i2v_clip_config"]["params"]["checkpoint_path"] = paths["clip"]
    m["conditioner_config"]["params"]["emb_models"][0]["params"]["checkpoint_path"] = paths["umt5"]
    load_yaml = os.path.join(work, "scail_1p3b_load.yaml")
    with open(load_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    log("load: wrote " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in written.items())
        + f" ({sum(written.values()) / 1e9:.2f} GB, flushed and dropped from the page cache) in "
        f"{write_s:.1f} s; the YAML's vae_pth and checkpoint_paths point at them ({load_yaml})")

    # the request through the CLI with --load
    prompts = os.path.join(work, "prompts.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{ex81}\n")
    argv = ["--base", load_yaml, os.path.join(ROOT, "configs", "sampling", "pose_cli.yaml"),
            "--input-type", "txt", "--input-file", prompts, "--sampling-steps", "2",
            "--device", "cuda", "--output-dir", os.path.join(work, "samples"), "--load", ckpt]
    log("load: python -m scail_tpu_torch.cli.sample_video " + " ".join(argv))
    seen = {}
    real_load = VideoDiffusionEngine.load_checkpoint

    def load_checkpoint(self, load_dir, **kw):  # the engine and its load's device peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = real_load(self, load_dir, **kw)
        torch.cuda.synchronize()
        seen.update(engine=self, peak=torch.cuda.max_memory_allocated() - before)
        return out

    VideoDiffusionEngine.load_checkpoint = load_checkpoint
    try:
        reset_counts()
        t0 = time.perf_counter()
        records = sample_video.main(argv)
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        VideoDiffusionEngine.load_checkpoint = real_load
    eng = seen["engine"]
    for r in eng.weight_loads:
        log(f"load: {r['what']} from {os.path.relpath(r['path'], ROOT)}: {r['bytes'] / 1e9:.3f} GB "
            f"onto the card in {r['seconds']:.2f} s ({r['bytes'] / 1e9 / r['seconds']:.2f} GB/s)")
    dit_gb = sum(p.numel() * p.element_size() for p in eng.dit.parameters()) / 1e9
    peak_gb = seen["peak"] / 1e9
    log(f"load: load_checkpoint's device peak {peak_gb:.3f} GB above what was allocated before, "
        f"for {dit_gb:.3f} GB of DiT parameters (limit: parameters + 1 GB)")
    if not peak_gb <= dit_gb + 1.0:
        fail("load: load_checkpoint held more than the DiT's parameters and 1 GB on the card")
    dtype = torch.bfloat16
    held = {"DiT": _held("DiT", eng.dit, sources["dit"], dtype),
            "Wan VAE": _held("Wan VAE", eng.first_stage_model.model, sources["vae"], dtype),
            "CLIP": _held("CLIP", eng.i2v_clip.model, sources["clip"], dtype),
            "umt5": _held("umt5", eng.conditioner.embedders[0].model, sources["umt5"], dtype)}
    log(f"load: every loaded tensor is on the card and bit-equal to its source in bf16: {held}")
    rec = records[0]
    out = rec["outputs"][0]
    decoded = load_video_frames(out)[0]
    log(f"load: the --load request answered in {rec['seconds']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in rec["phases"].items())
        + f"; {total:.1f} s with the engine build and the loads); {os.path.relpath(out, ROOT)} "
        f"decodes to {decoded.shape} (mean {decoded.mean():.1f}), samples finite "
        f"{rec['finite']}; launches { {k: v for k, v in counts.items() if v} }")
    _exact(counts, LOAD_LAUNCHES, "the --load request, 2 steps")
    if len(records) != 1 or not (rec["finite"] and out.endswith(".mp4")
                                 and decoded.shape == (81, 512, 896, 3) and np.ptp(decoded) > 0):
        fail("load: expected one .mp4 of 81 finite, non-constant 512x896 frames")
    loads = list(eng.weight_loads)
    del eng, seen, records
    gc.collect()
    torch.cuda.empty_cache()

    # one training step at full depth from the same DiT file
    check = {}
    real_fit = Trainer.fit

    def fit(self, *a, **kw):  # the parameters the step starts from, against the file's
        check["bad"] = [n for n, p in self.params.items()
                        if p.dtype != torch.float32
                        or not torch.equal(p, sources["dit"][n].to("cuda", torch.float32))]
        check["n"] = len(self.params)
        return real_fit(self, *a, **kw)

    Trainer.fit = fit
    try:
        argv = _train_argv(load_yaml, _data_root(ex81)) + ["--load", ckpt, "--train-iters", "1"]
        log("load: python -m scail_tpu_torch.cli.train " + " ".join(argv))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = launch_counts()
    finally:
        Trainer.fit = real_fit
    loss = trainer.history[0]["loss"] if trainer.history else None
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"load: train --load: {check.get('n')} parameters equal the file's in f32 before the "
        f"step (mismatches {check.get('bad', ['not checked'])[:4]}); one step, loss {loss}, "
        f"{train_s:.1f} s with the engine build and the loads, peak allocated {train_peak:.2f} "
        f"GB; launches { {k: v for k, v in train_counts.items() if v} }")
    if check.get("bad") != [] or trainer.step != 1 or loss is None or not math.isfinite(loss):
        fail("load: train --load did not take one finite step from the file's weights")
    _exact(train_counts, TRAIN_LAUNCHES_PER_STEP, "train --load, 1 step")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"load: phase {phase_s:.1f} s; {sum(written.values()) / 1e9:.2f} GB written")
    return counts, dict(rec, total_s=total, loads=loads, peak_gb=peak_gb, dit_gb=dit_gb,
                        write_gb=sum(written.values()) / 1e9, write_s=write_s, loss=loss,
                        train_s=train_s, phase_s=phase_s)


# --------------------------------------------------------------------------
# Phase 10: parallelism over torch.distributed (scail_tpu_torch/parallel/)
# --------------------------------------------------------------------------
# launches per DiT forward under a mesh, per rank, by depth L: q and k roped by
# K10 before the exchange, no K1 (off on a non-trivial mesh, as in JAX)
def _mesh_dit_launches(L, attn):
    base = {"dual_cross_attention": L, "adaln_layer_norm": 2 * L + 1, "rotary": 2 * L}
    if attn == "sta":  # the video and pose windowed calls (K7), the ref rows (K2)
        return dict(base, sta_attention_fwd=2 * L, flash_attention=L)
    return dict(base, flash_attention=2 * L if attn == "ring" else L)


# depth of the two-rank train CLI step (full width): both ranks' state and
# activations share the one card
PARALLEL_TRAIN_LAYERS = 8
# a rank of the two that share the card must stay under this (GB)
PARALLEL_RANK_PEAK_GB = 38.0
PARALLEL_TIMEOUT_S = 600


def _check_compute_mode():
    """Two processes on one card need its compute mode to allow them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    mode = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    if smi.returncode != 0 or "exclusive" in mode.lower():
        raise RuntimeError(f"compute mode {mode!r}: two ranks cannot share the card "
                           f"(nvidia-smi: {smi.stderr.strip()})")
    return mode


def _stage_p2p_through_host():
    """Two ranks on one card run over gloo, whose point-to-point send and
    recv take host memory only: a CUDA tensor crashes the process (gloo
    tcp/pair.cc writev, 'Bad address'; the all-to-all, all-reduce,
    all-gather and reduce-scatter carry CUDA tensors, bf16 too).  This
    harness wraps torch.distributed.batch_isend_irecv in its rank processes
    so CUDA tensors travel through host copies; the library's calls stay
    as they are."""
    import torch
    import torch.distributed as dist

    real = dist.batch_isend_irecv

    class Staged:
        def __init__(self, works, copies):
            self.works, self.copies, self.done = works, copies, False

        def wait(self):
            if not self.done:
                for w in self.works:
                    w.wait()
                for dst, src in self.copies:
                    dst.copy_(src)
                self.done = True
            return True

    def staged(ops):
        new_ops, copies = [], []
        for op in ops:
            t = op.tensor
            if t.is_cuda:
                if op.op is dist.isend:
                    host = t.detach().cpu()
                else:
                    host = torch.empty(t.shape, dtype=t.dtype)
                    copies.append((t, host))
                op = dist.P2POp(op.op, host, op.peer, op.group, op.tag)
            new_ops.append(op)
        shared = Staged(real(new_ops), copies)
        return [shared] * len(ops)

    dist.batch_isend_irecv = staged


def _rank_dit(dit, inp, mesh, label, want):
    """One forward under `mesh` on this rank: exact launches and collectives
    counted from 0, seconds, bytes sent, peak GB."""
    import torch

    from scail_tpu_torch import parallel

    x, t, ctx = inp["x"], inp["timesteps"], inp["context"]
    kw = {k: v for k, v in inp.items() if k not in ("x", "timesteps", "context")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    parallel.reset_collective_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = dit(x, t, ctx, mesh=mesh, **kw)
    torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
           "collectives": dict(parallel.COLLECTIVES),
           "bytes_sent": sum(parallel.COLLECTIVE_BYTES.values()),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    kernels, colls = want
    _exact(rec["launches"], kernels, label)
    for kind, n in colls.items():
        if rec["collectives"][kind] != n:
            fail(f"{label}: expected {n} {kind} calls, got {rec['collectives']}")
    if not torch.isfinite(out).all():
        fail(f"{label}: output not finite")
    return out, rec


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _rank_attention(name, fn, mesh, full, want):
    """fn(q, k, v, mesh) on this rank's seq rows of the main path's (1, 48,832,
    12, 128) q, k, v, its backward from dO: exact launches and collectives,
    then (out, dq, dk, dv) gathered over the rows for the comparison."""
    import torch

    from scail_tpu_torch import parallel
    from scail_tpu_torch.parallel import comm

    q, k, v, do = (comm.local_slice(t, mesh, "seq", 1).clone() for t in full)
    for t in (q, k, v):
        t.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    parallel.reset_collective_counts()
    t0 = time.perf_counter()
    out = fn(q, k, v, mesh)
    out.backward(do)
    torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
           "collectives": dict(parallel.COLLECTIVES),
           "bytes_sent": sum(parallel.COLLECTIVE_BYTES.values()),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    kernels, colls = want
    _exact(rec["launches"], kernels, name)
    for kind, n in colls.items():
        if rec["collectives"][kind] != n:
            fail(f"{name}: expected {n} {kind} calls, got {rec['collectives']}")
    got = [comm.all_gather(t.detach(), mesh, "seq", 1) for t in (out, q.grad, k.grad, v.grad)]
    return got, rec


def _parallel_rank_main():
    """A rank of the two-rank run (phase 10b): gloo on the one card."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from scail_tpu_torch.models import wan_vae
    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.distributed import initialize_distributed
    from scail_tpu_torch.parallel.sharding import dit_param_rules, shard_module_

    initialize_distributed(backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
    rank = dist.get_rank()
    _stage_p2p_through_host()
    global log

    def log(msg, _log=log):  # noqa: F811 -- prefix this rank's lines
        _log(f"rank {rank}: {msg}")

    seq = make_mesh(MeshSpec(1, 2, 1))
    model = make_mesh(MeshSpec(1, 1, 2))
    rec = {"runs": {}}
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(2), 21, 64, 112)

    def record(name, out, r, ref):
        r["rel_l2"] = None if ref is None else _rel_l2(out, ref)
        rec["runs"][name] = r
        log(f"{name}: {r['seconds']:.2f} s, {r['bytes_sent'] / 1e9:.3f} GB sent, peak "
            f"{r['peak_gb']:.2f} GB, launches {r['launches']}, collectives {r['collectives']}, "
            f"relative L2 to the one-process kernel path {r['rel_l2']}")
        if ref is not None and not r["rel_l2"] <= DIT_REL_TOL:
            fail(f"{name}: relative L2 {r['rel_l2']:.3e} from the one-process path "
                 f"(tol {DIT_REL_TOL})")

    def reference(dit, cfg):
        """The one-process kernel path on rank 0 (rank 1 waits)."""
        out = None
        if rank == 0:
            kept = dit.config
            dit.config = cfg
            x, t, ctx = inp["x"], inp["timesteps"], inp["context"]
            kw = {k: v for k, v in inp.items() if k not in ("x", "timesteps", "context")}
            with torch.inference_mode():
                out = dit(x, t, ctx, **kw)
            dit.config = kept
        dist.barrier()
        return out

    # Ulysses at full depth
    dit = _build_dit(attn_impl="ulysses")
    out, r = _rank_dit(dit, inp, seq, "Ulysses seq 2, 30 layers",
                       (_mesh_dit_launches(30, "ulysses"), {"all_to_all": 120}))
    record("ulysses_30", out, r, reference(dit, dit.config))
    del dit, out
    gc.collect()
    torch.cuda.empty_cache()

    # the ring and Ulysses attention forward and backward at the main path's
    # shape (batch 1, as in training): K2 per ring step, K5 per chunk
    from scail_tpu_torch.ops import attention as A
    from scail_tpu_torch.parallel.ring import ring_attention
    from scail_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device="cuda").manual_seed(8)
    full = [torch.randn((1, 48832, 12, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(4)]
    want_ref = None
    if rank == 0:
        q, k, v = (t.clone().requires_grad_(True) for t in full[:3])
        o = A.attention(q, k, v)
        o.backward(full[3])
        want_ref = [o.detach(), q.grad, k.grad, v.grad]
        del q, k, v, o
    dist.barrier()
    bwd = {"flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}
    for name, fn, want in (
            ("ring_attention_bwd", ring_attention,
             (dict(bwd, flash_attention=2), {"p2p": 3})),
            ("ulysses_attention_bwd", ulysses_attention,
             ({"flash_attention": 1, "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1},
              {"all_to_all": 8}))):
        got, r = _rank_attention(name, fn, seq, full, want)
        r["rel_l2"] = None if want_ref is None else max(
            _rel_l2(g, w) for g, w in zip(got, want_ref))
        rec["runs"][name] = r
        log(f"{name}: {r['seconds']:.2f} s, {r['bytes_sent'] / 1e9:.3f} GB sent, peak "
            f"{r['peak_gb']:.2f} GB, launches {r['launches']}, collectives {r['collectives']}, "
            f"largest relative L2 of out, dq, dk, dv to the one-process K2 + K5 {r['rel_l2']}")
        if want_ref is not None and not r["rel_l2"] <= DIT_REL_TOL:
            fail(f"{name}: relative L2 {r['rel_l2']:.3e} (tol {DIT_REL_TOL})")
        del got
    del full, want_ref
    gc.collect()
    torch.cuda.empty_cache()

    # 4 layers: ring, TP, STA under Ulysses, STA under TP
    dit = _build_dit(num_layers=4)
    cfg = dit.config
    tp = _build_dit(num_layers=4)
    shard_module_(tp, dit_param_rules(), model)
    sta = dataclasses.replace(cfg, attn_impl="sta")
    runs = (("ring_4", dit, dataclasses.replace(cfg, attn_impl="ring"), seq,
             (_mesh_dit_launches(4, "ring"), {"p2p": 4})),
            ("tp_4", tp, cfg, model, (_mesh_dit_launches(4, "auto"), {"all_reduce": 32})),
            ("sta_ulysses_4", dit, sta, seq, (_mesh_dit_launches(4, "sta"), {"all_to_all": 16})),
            ("sta_tp_4", tp, sta, model, (_mesh_dit_launches(4, "sta"), {"all_reduce": 32})))
    for name, net, run_cfg, mesh, want in runs:
        net.config = run_cfg
        out, r = _rank_dit(net, inp, mesh, name, want)
        record(name, out, r, reference(dit, run_cfg))
        del out
    del dit, tp, inp
    gc.collect()
    torch.cuda.empty_cache()

    # the train CLI, tensor parallel over the two ranks
    rec["train"] = _parallel_train_rank()
    gc.collect()
    torch.cuda.empty_cache()

    # the context-parallel VAE decode of 21 latent frames at 512x896
    vae = wan_vae.WanVAE()
    vae.init(torch.Generator(device="cuda").manual_seed(6), device="cuda")
    z = torch.randn((1, 21, 16, 64, 112), generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    from scail_tpu_torch import parallel

    parallel.reset_collective_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        frames = wan_vae.vae_decode_cp(vae.model, vae.config, z, seq)
    torch.cuda.synchronize()
    r = {"seconds": time.perf_counter() - t0, "collectives": dict(parallel.COLLECTIVES),
         "bytes_sent": sum(parallel.COLLECTIVE_BYTES.values()),
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": {}}
    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = wan_vae.vae_decode(vae.model, vae.config, z, streamed=True)
        torch.cuda.synchronize()
        r["streamed_seconds"] = time.perf_counter() - t0
    dist.barrier()
    if tuple(frames.shape) != (1, 81, 3, 512, 896) or not torch.isfinite(frames).all():
        fail(f"vae_decode_cp: bad frames {tuple(frames.shape)}")
    record("vae_decode_cp", frames, r, ref)
    del vae, z, frames, ref

    with open(os.path.join(WORK, f"parallel_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _parallel_train_yaml():
    import yaml

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        cut = yaml.safe_load(f)
    cut["model"]["network_config"]["params"]["num_layers"] = PARALLEL_TRAIN_LAYERS
    path = os.path.join(WORK, f"scail_1p3b_{PARALLEL_TRAIN_LAYERS}layers.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cut, f)
    return path


def _parallel_train_argv():
    return _train_argv(_parallel_train_yaml(), os.path.join(WORK, "train_data"))


def _parallel_train_rank():
    """2 steps of `train --distributed --mesh-model 2` on this rank: exact
    launches, the step seconds, the peak."""
    import torch

    from scail_tpu_torch import parallel
    from scail_tpu_torch.cli import train

    L = PARALLEL_TRAIN_LAYERS
    argv = _parallel_train_argv() + ["--distributed", "--mesh-model", "2", "--train-iters", "2"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    parallel.reset_collective_counts()
    t0 = time.perf_counter()
    trainer = train.main(argv)
    torch.cuda.synchronize()
    r = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
         "collectives": dict(parallel.COLLECTIVES),
         "bytes_sent": sum(parallel.COLLECTIVE_BYTES.values()),
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": [m["loss"] for m in trainer.history],
         "grad_norms": [m["grad_norm"] for m in trainer.history],
         "ok": [m["ok"] for m in trainer.history]}
    # per step, with remat: the forward kernels twice (forward and recompute),
    # the backward ones once; K10 on q and k in both forwards
    per_step = {"flash_attention": 2 * L, "dual_cross_attention": 2 * L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "adaln_layer_norm": 4 * L + 1, "rotary": 4 * L}
    _exact(r["launches"], {k: 2 * v for k, v in per_step.items()},
           f"train --distributed --mesh-model 2, {L} layers, 2 steps")
    if trainer.step != 2 or not all(r["ok"]):
        fail(f"the two-rank train CLI did not take 2 steps: {trainer.history}")
    log(f"train --mesh-model 2 at {L} layers: {r['seconds']:.1f} s for 2 steps (with engine "
        f"build), losses {r['losses']}, gradient norms {r['grad_norms']}, peak "
        f"{r['peak_gb']:.2f} GB, {r['bytes_sent'] / 1e9:.3f} GB sent, collectives {r['collectives']}")
    del trainer
    return r


def _nccl_world1_main():
    """Phase 10a: NCCL at world size 1 -- the production backend initialises,
    the mesh's groups are NCCL's, a Ulysses and a ring DiT forward at 2 layers
    and full width run under that mesh (a trivial one: the DiT issues no
    collective), and each collective kind goes through NCCL."""
    import torch
    import torch.distributed as dist

    from scail_tpu_torch.parallel import MeshSpec, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=0, world_size=1)
    mesh = make_mesh(MeshSpec(1, 1, 1))
    backends = {a: dist.get_backend(mesh.group(a)) for a in ("data", "seq", "model")}
    if dist.get_backend() != "nccl" or set(backends.values()) != {"nccl"}:
        fail(f"NCCL world 1: backends {dist.get_backend()} {backends}")
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(2), 21, 64, 112)
    outs = {}
    for attn in ("ulysses", "ring"):
        dit = _build_dit(num_layers=2, attn_impl=attn)
        out, r = _rank_dit(dit, inp, mesh, f"NCCL world 1, {attn}, 2 layers",
                           (_mesh_dit_launches(2, "ulysses"), {}))
        outs[attn] = out
        log(f"NCCL world 1: {attn} DiT forward, 2 layers: {r['seconds']:.2f} s, launches "
            f"{r['launches']}")
        del dit
    if not torch.equal(outs["ulysses"], outs["ring"]):
        fail("NCCL world 1: the Ulysses and ring forwards differ on a trivial mesh")
    # each kind of collective the library issues, through NCCL
    x = torch.arange(8.0, device="cuda", dtype=torch.bfloat16).reshape(2, 4)
    ops = {}
    y = x.clone()
    dist.all_reduce(y)
    ops["all_reduce"] = torch.equal(y, x)
    g = torch.empty_like(x)
    dist.all_gather_into_tensor(g, x)
    ops["all_gather"] = torch.equal(g, x)
    a = torch.empty_like(x)
    dist.all_to_all_single(a, x)
    ops["all_to_all"] = torch.equal(a, x)
    s = torch.empty_like(x)
    dist.reduce_scatter_tensor(s, x)
    ops["reduce_scatter"] = torch.equal(s, x)
    p = torch.empty_like(x)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0), dist.P2POp(dist.irecv, p, 0)]):
        w.wait()
    ops["p2p"] = torch.equal(p, x)
    torch.cuda.synchronize()
    log(f"NCCL world 1: backend {dist.get_backend()}, mesh groups {backends}, collectives "
        f"{ops}")
    if not all(ops.values()):
        fail(f"NCCL world 1: a collective returned a wrong value: {ops}")
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(entry, world, extra_env=None):
    """Run chip_smoke.`entry`() in `world` processes on the card; the first
    failure (or the time limit) stops them all."""
    port = _free_port()
    code = f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as c; c.{entry}()"
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > PARALLEL_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        fail(f"{entry}: ranks exited with {codes} after {time.perf_counter() - t0:.0f} s")


def phase_parallel(ex81):
    """Phase 10: (a) NCCL at world size 1; (b) two ranks over gloo on the one
    card -- Ulysses at full depth, ring, TP, STA under Ulysses and under TP at
    4 layers, each held against the one-process kernel path; the train CLI
    with --distributed --mesh-model 2 for 2 steps at PARALLEL_TRAIN_LAYERS
    layers against the one-process run of 2 steps (each step's loss and
    gradient norm: the second step's loss reads the first update, made
    through the tensor-parallel backward, the gradient reduce and the
    sharded clip norm and moments); vae_decode_cp of 21
    latent frames against the streamed decode.  Returns the ranks' launches
    (summed) and the phase's record."""
    import gc

    import torch

    from scail_tpu_torch.cli import train

    t_phase = time.perf_counter()
    mode = _check_compute_mode()
    log(f"parallel: compute mode {mode}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _run_ranks("_nccl_world1_main", 1)
    nccl_s = time.perf_counter() - t0

    # the one-process train steps at the same depth and seed
    _data_root(ex81)
    t0 = time.perf_counter()
    one = train.main(_parallel_train_argv() + ["--train-iters", "2"])
    one_losses = [m["loss"] for m in one.history]
    one_norms = [m["grad_norm"] for m in one.history]
    log(f"parallel: one-process train at {PARALLEL_TRAIN_LAYERS} layers, 2 steps: losses "
        f"{one_losses}, gradient norms {one_norms} ({time.perf_counter() - t0:.1f} s with "
        "engine build)")
    del one
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _run_ranks("_parallel_rank_main", 2)
    ranks_s = time.perf_counter() - t0
    recs = []
    for rank in range(2):
        with open(os.path.join(WORK, f"parallel_rank{rank}.json")) as f:
            recs.append(json.load(f))
    for rank, rec in enumerate(recs):
        for name, r in list(rec["runs"].items()) + [("train", rec["train"])]:
            if r["peak_gb"] > PARALLEL_RANK_PEAK_GB:
                fail(f"parallel: rank {rank} {name} peaked at {r['peak_gb']:.2f} GB "
                     f"(> {PARALLEL_RANK_PEAK_GB})")
        for what, got, want in (("loss", rec["train"]["losses"], one_losses),
                                ("gradient norm", rec["train"]["grad_norms"], one_norms)):
            for step, (g, w) in enumerate(zip(got, want), 1):
                if not abs(g - w) <= DIT_REL_TOL * abs(w):
                    fail(f"parallel: rank {rank}'s step-{step} {what} {g} vs the one-process "
                         f"{w} (relative tol {DIT_REL_TOL})")
    counts = {}
    for rec in recs:
        for r in list(rec["runs"].values()) + [rec["train"]]:
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v
    phase_s = time.perf_counter() - t_phase
    runs = recs[0]["runs"]
    log("parallel: " + "; ".join(
        f"{name} {r['seconds']:.2f} s / {recs[1]['runs'][name]['seconds']:.2f} s, sent "
        f"{r['bytes_sent'] / 1e9:.3f} / {recs[1]['runs'][name]['bytes_sent'] / 1e9:.3f} GB, "
        f"peak {r['peak_gb']:.2f} / {recs[1]['runs'][name]['peak_gb']:.2f} GB, rel L2 "
        f"{r['rel_l2']}" for name, r in runs.items())
        + f"; train losses {recs[0]['train']['losses']} vs one process {one_losses}, "
        f"gradient norms {recs[0]['train']['grad_norms']} vs {one_norms}, "
        f"peak {recs[0]['train']['peak_gb']:.2f} / {recs[1]['train']['peak_gb']:.2f} GB; "
        f"NCCL world 1 {nccl_s:.1f} s; two ranks {ranks_s:.1f} s; phase {phase_s:.1f} s")
    print(json.dumps({"parallel": {"ranks": recs, "one_process_losses": one_losses,
                                   "one_process_grad_norms": one_norms,
                                   "nccl_world1_s": nccl_s, "two_ranks_s": ranks_s,
                                   "phase_s": phase_s}}), flush=True)
    return counts, {"phase_s": phase_s, "runs": runs, "one_losses": one_losses}



# phase 11: the quality evals on random weights from seeds, every network at
# its published width; the card's results against the port's CPU run of the
# same function within EVAL_REL_TOL (f32 both sides; a TF32 convolution reads
# ~1e-3, so the check also holds the extractors' full_f32)
EVAL_REL_TOL = 1e-4
# the STA gate's sampling geometry: 9 frames at 512 x 128 are 3 latent frames
# of 32 x 8 patches, which the sliding tiles (3, 8) divide (the --smoke
# geometry, 64 x 64 and 5 frames, runs dense attention in its STA pass)
GATE_EXTRA = ["--image-size", "512", "128", "--sampling-num-frames", "9"]


def _card_vs_cpu(label, got, want, tol=EVAL_REL_TOL):
    """Fail unless `got` (card) is within `tol` relative L2 of `want` (CPU);
    both numpy."""
    import numpy as np
    import torch

    rel = _rel_l2(torch.from_numpy(got), torch.from_numpy(want))
    log(f"evals: {label}: card vs CPU relative L2 {rel:.3e} (tol {tol:.0e})")
    if not (np.isfinite(got).all() and rel <= tol):
        fail(f"evals: {label} on the card disagrees with the CPU ({rel:.3e} > {tol:.0e})")
    return rel


def _tf32_still_on(label):
    import torch

    if not (torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32):
        fail(f"evals: {label} did not restore the caller's TF32 settings")


def _timed_on_card(fn):
    """(fn()'s result, seconds, peak GB): one warm-up call, then one timed call
    between device synchronisations, the peak over both."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _evals_fvd(dense_clip, sta_clip, work, stats):
    """(a) I3D at Kinetics-400 geometry on the two 81-frame clips: FVD through
    the CLI, its self-distance, the card's features against the CPU's."""
    import numpy as np
    import torch

    from scail_tpu_torch.cli import calculate_fvd
    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor, load_video_dir

    dirs = {}
    for name, clip in (("dense", dense_clip), ("sta", sta_clip)):
        dirs[name] = os.path.join(work, f"fvd_{name}")
        os.makedirs(dirs[name], exist_ok=True)
        dst = os.path.join(dirs[name], os.path.basename(clip))
        if not os.path.exists(dst):
            os.symlink(clip, dst)
    fvd = calculate_fvd.main(["--real", dirs["dense"], "--fake", dirs["sta"], "--device", "cuda"])
    self_fvd = calculate_fvd.main(["--real", dirs["dense"], "--fake", dirs["dense"],
                                   "--device", "cuda"])
    _tf32_still_on("calculate_fvd")
    log(f"evals: FVD(dense, STA) {fvd:.6f}, FVD(dense, dense) {self_fvd:.3e} (I3D, 81 frames, "
        "random weights)")
    if not (np.isfinite(fvd) and abs(self_fvd) < 1e-3):
        fail(f"evals: FVD {fvd} not finite or self-distance {self_fvd} >= 1e-3")

    clip = np.stack(load_video_dir(dirs["dense"]))  # (1, 81, 512, 896, 3)
    if clip.shape != (1, 81, 512, 896, 3):
        fail(f"evals: the dense clip reads {clip.shape}")
    ext = I3DFeatureExtractor(device="cuda", seed=0)
    feats, secs, peak = _timed_on_card(lambda: ext(clip))
    stats["i3d"] = {"ms_per_clip": secs * 1e3, "frames": 81, "peak_gb": peak}
    cpu = I3DFeatureExtractor(device="cpu")
    cpu.model.load_state_dict(ext.model.state_dict())
    short = clip[:, :16]
    t0 = time.perf_counter()
    want = cpu(short)
    stats["i3d"]["cpu_s_16_frames"] = time.perf_counter() - t0
    stats["i3d"]["rel_l2"] = _card_vs_cpu("I3D, 16 frames at 224", ext(short), want)
    # the same clip with TF32 convolutions (the extractor's network called
    # outside full_f32), for the record
    from scail_tpu_torch.evals.fvd import preprocess_for_i3d

    with torch.no_grad():
        tf32 = ext.model(preprocess_for_i3d(short, 224, ext.device)).cpu().numpy()
    stats["i3d"]["tf32_rel_l2"] = _rel_l2(torch.from_numpy(tf32), torch.from_numpy(want))
    log(f"evals: I3D {secs * 1e3:.1f} ms per 81-frame clip, peak {peak:.2f} GB; features "
        f"{feats.shape}; under TF32 the same features read {stats['i3d']['tf32_rel_l2']:.3e}")
    stats["fvd"] = {"dense_vs_sta": fvd, "self": self_fvd}
    del ext, cpu
    _free_card()


def _evals_fid(dense_clip, sta_clip, work, stats):
    """(b) InceptionV3 on every 4th frame of each clip: `eval_fid ref` on the
    dense clip's, `calc` on the STA clip's; the card's features against the
    CPU's on two frames."""
    import numpy as np
    from PIL import Image

    from scail_tpu_torch.cli import eval_fid
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.evals.fid import InceptionFeatureExtractor

    frames = {}
    for name, clip in (("dense", dense_clip), ("sta", sta_clip)):
        frames[name] = load_video_frames(clip)[0][::4]
        d = os.path.join(work, f"frames_{name}")
        os.makedirs(d, exist_ok=True)
        for i, f in enumerate(frames[name]):
            Image.fromarray(f).save(os.path.join(d, f"{i:03d}.png"))
    ref = os.path.join(work, "fid_ref.npz")
    eval_fid.main(["ref", "--images", os.path.join(work, "frames_dense"), "--stats", ref,
                   "--device", "cuda"])
    t0 = time.perf_counter()
    fid = eval_fid.main(["calc", "--images", os.path.join(work, "frames_sta"), "--stats", ref,
                         "--device", "cuda"])
    stats["seconds"]["fid_calc"] = time.perf_counter() - t0
    _tf32_still_on("eval_fid")
    if not np.isfinite(fid):
        fail(f"evals: FID {fid} not finite")
    imgs = frames["dense"]
    ext = InceptionFeatureExtractor(device="cuda", seed=0)
    _, secs, peak = _timed_on_card(lambda: ext(imgs))
    cpu = InceptionFeatureExtractor(device="cpu")
    cpu.model.load_state_dict(ext.model.state_dict())
    stats["inception"] = {"ms_per_image": secs * 1e3 / len(imgs), "images": len(imgs),
                          "peak_gb": peak,
                          "rel_l2": _card_vs_cpu("InceptionV3, 2 frames", ext(imgs[:2]),
                                                 cpu(imgs[:2]))}
    stats["fid"] = fid
    log(f"evals: FID(dense frames, STA frames) {fid:.6f} over {len(imgs)} frames each; "
        f"InceptionV3 {secs * 1e3 / len(imgs):.2f} ms per 512x896 frame, peak {peak:.2f} GB")
    del ext, cpu
    _free_card()
    return frames


def _clip_tower(label, cfg, images, prompts, stats):
    """One CLIP model at full width and depth on the card (ms per image and
    per prompt, peak), then both towers at 2 layers, card against CPU."""
    import dataclasses

    from scail_tpu_torch.evals.clip_score import ClipScorer, compute_clip_score

    scorer = ClipScorer(cfg=cfg, device="cuda", seed=0)
    emb, secs, peak = _timed_on_card(lambda: scorer.image_embed(images))
    _, tsecs, tpeak = _timed_on_card(lambda: scorer.text_embed(prompts))
    score = compute_clip_score(images, prompts, scorer.image_embed, scorer.text_embed)
    _tf32_still_on(label)
    del scorer
    _free_card()
    cut = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    card = ClipScorer(cfg=cut, device="cuda", seed=1)
    cpu = ClipScorer(cfg=cut, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    rel_i = _card_vs_cpu(f"{label} vision tower, 2 layers", card.image_embed(images[:2]),
                  cpu.image_embed(images[:2]))
    rel_t = _card_vs_cpu(f"{label} text tower, 2 layers", card.text_embed(prompts[:2]),
                  cpu.text_embed(prompts[:2]))
    del card, cpu
    _free_card()
    stats[label] = {"ms_per_image": secs * 1e3 / len(images),
                    "ms_per_prompt": tsecs * 1e3 / len(prompts), "peak_gb": max(peak, tpeak),
                    "score": score, "rel_l2_vision": rel_i, "rel_l2_text": rel_t,
                    "vision": f"{cfg.vision_width} x {cfg.vision_layers}",
                    "text": f"{cfg.text_width} x {cfg.text_layers}"}
    log(f"evals: {label} ({stats[label]['vision']} vision, {stats[label]['text']} text): "
        f"{secs * 1e3 / len(images):.2f} ms per image, {tsecs * 1e3 / len(prompts):.2f} ms "
        f"per prompt, peak {max(peak, tpeak):.2f} GB, score {score:.4f}")
    return emb, score


def _evals_towers(frames, stats):
    """(c) CLIP score on ViT-g-14, the aesthetic head on ViT-L/14, HPS on
    ViT-H-14, LPIPS on VGG16, on the clips' frames."""
    import numpy as np
    import torch
    from PIL import Image

    from scail_tpu_torch.evals.aesthetic import (aesthetic_score_from_clip_embeddings,
                                                 random_aesthetic_head)
    from scail_tpu_torch.evals.lpips import LPIPS
    from scail_tpu_torch.models.clip_score import ClipScoreConfig

    images = [Image.fromarray(f) for f in frames["dense"][:8]]
    prompts = ["a character dancing", "a person turns around on a stage",
               "a figure raises both arms", "a dancer in a red dress", "a man walking",
               "a woman jumping in a studio", "two feet tapping", "a slow spin"]
    _clip_tower("clip_score_vit_g14", ClipScoreConfig.vit_g14(), images, prompts, stats)
    emb, _ = _clip_tower("aesthetic_vit_l14", ClipScoreConfig.vit_l14(), images, prompts, stats)
    aes = aesthetic_score_from_clip_embeddings(emb, random_aesthetic_head(0))
    if not np.isfinite(aes).all():
        fail("evals: aesthetic scores not finite")
    stats["aesthetic_vit_l14"]["mean_rating"] = float(aes.mean())
    _, hps = _clip_tower("hps_vit_h14", ClipScoreConfig.vit_h14(), images, prompts, stats)
    stats["hps_vit_h14"]["hps"] = hps / 100.0

    def pairs(n):
        x = np.stack(frames["dense"][:n]).astype(np.float32) / 127.5 - 1.0
        y = np.stack(frames["sta"][:n]).astype(np.float32) / 127.5 - 1.0
        return (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y).permute(0, 3, 1, 2))

    model = LPIPS(device="cuda").init_random_(torch.Generator(device="cuda").manual_seed(0))
    x, y = pairs(4)
    xc, yc = x.cuda(), y.cuda()
    d, secs, peak = _timed_on_card(lambda: model(xc, yc))
    _tf32_still_on("LPIPS")
    cpu = LPIPS()
    cpu.load_state_dict(model.state_dict())
    # two frames 4 apart of the dense clip: a pair that differs whatever the
    # two clips hold
    stats["lpips_vgg16"] = {"ms_per_pair": secs * 1e3 / 4, "pairs": 4, "peak_gb": peak,
                            "mean": float(d.mean()),
                            "rel_l2": _card_vs_cpu("LPIPS, 1 pair at 512x896",
                                            model(xc[:1], xc[1:2]).cpu().numpy(),
                                            cpu(x[:1], x[1:2]).numpy())}
    if not torch.isfinite(d).all():
        fail("evals: LPIPS not finite")
    log(f"evals: LPIPS {secs * 1e3 / 4:.2f} ms per 512x896 pair, peak {peak:.2f} GB, mean "
        f"{float(d.mean()):.6f}")
    del model, cpu, xc, yc
    _free_card()


def _evals_gate(work):
    """(d) the STA gate: validate_weights --smoke on examples_synth/001 on the
    card; exact launches of each sampling pass."""
    import shutil

    import numpy as np

    from scail_tpu_torch.cli import sample_video, validate_weights

    ex = os.path.join(work, "examples")
    if not os.path.isdir(os.path.join(ex, "001")):
        shutil.copytree(os.path.join(ROOT, "examples_synth", "001"), os.path.join(ex, "001"))
    passes = []
    real_main = sample_video.main

    def counted(argv):
        reset_counts()
        out = real_main(argv)
        passes.append(launch_counts())
        return out

    argv = ["--smoke", "--device", "cuda", "--examples", ex, "--out",
            os.path.join(work, "validate"), "--sample-extra"] + GATE_EXTRA
    sample_video.main = counted
    t0 = time.perf_counter()
    try:
        rc, text, value = validate_weights.run_stage("validate_weights", validate_weights.main,
                                                     argv)
    finally:
        sample_video.main = real_main
    secs = time.perf_counter() - t0
    if rc or value != 0:
        fail(f"evals: validate_weights exited with {value} (rc {rc})")
    report = json.loads(text.strip().splitlines()[-1])
    st = report["stages"]
    for mode in ("dense", "sta"):
        if st[f"sample_{mode}"]["rc"] or st[f"sample_{mode}"]["videos"] < 1:
            fail(f"evals: validate_weights sample_{mode} {st[f'sample_{mode}']}")
    for key in ("fvd_dense", "fvd_sta", "clip_score"):
        if report[key] is None or not np.isfinite(report[key]):
            fail(f"evals: validate_weights {key} = {report[key]}")
    if "sta_validated" not in report or len(passes) != 2:
        fail(f"evals: validate_weights report {report}, {len(passes)} sampling passes")
    # 2 steps, one DiT forward at CFG batch 2 each
    _exact(passes[0], {k: 2 * v for k, v in DIT_LAUNCHES.items()}, "validate_weights dense pass")
    _exact(passes[1], {k: 2 * v for k, v in STA_DIT_LAUNCHES.items()},
           "validate_weights STA pass")
    log(f"evals: validate_weights --smoke in {secs:.1f} s: FVD dense {report['fvd_dense']}, "
        f"STA {report['fvd_sta']}, CLIP score {report['clip_score']}, sta_validated "
        f"{report['sta_validated']}; launches dense {passes[0]}, STA {passes[1]}")
    return {k: passes[0][k] + passes[1][k] for k in passes[0]}, report, secs


def phase_evals(dense_clip, sta_clip):
    """Phase 11: FVD (I3D), FID (InceptionV3), the CLIP towers (ViT-g-14 CLIP
    score, ViT-L/14 aesthetic, ViT-H-14 HPS) and LPIPS on random weights from
    seeds at their published widths, each against its CPU run, with TF32 on
    for the caller (the extractors must compute in f32 regardless and hand the
    setting back); then the STA gate through validate_weights.  Returns the
    gate's launches and the phase's record."""
    import torch

    t_phase = time.perf_counter()
    work = os.path.join(WORK, "evals")
    os.makedirs(work, exist_ok=True)
    stats = {"seconds": {}}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        _evals_fvd(dense_clip, sta_clip, work, stats)
        t1 = time.perf_counter()
        frames = _evals_fid(dense_clip, sta_clip, work, stats)
        t2 = time.perf_counter()
        _evals_towers(frames, stats)
        stats["seconds"].update(fvd=t1 - t0, fid=t2 - t1, towers=time.perf_counter() - t2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    counts, report, gate_s = _evals_gate(work)
    stats["validate_weights"] = {"seconds": gate_s, "fvd_dense": report["fvd_dense"],
                                 "fvd_sta": report["fvd_sta"],
                                 "clip_score": report["clip_score"],
                                 "sta_validated": report["sta_validated"]}
    phase_s = time.perf_counter() - t_phase
    stats["phase_s"] = phase_s
    stats["seconds"]["gate"] = gate_s
    log(f"phase 11 (evals): {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stats["seconds"].items()) + ")")
    print(json.dumps({"evals": stats}), flush=True)
    return counts, stats


def main():
    if not os.path.isdir(os.path.join(ROOT, "scail_tpu_torch")):
        fail("scail_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()
    kernels = phase_kernels()
    dit_ms = phase_dit()
    sta_dit_ms = phase_dit_sta()
    sample_counts, records = phase_cli()
    ex81 = os.path.join(WORK, "synthetic_081")
    sta_sample_counts, sta_record = phase_cli_sta(ex81)
    long_counts, long_rec = phase_cli_long()
    train_counts, train = phase_train(ex81)
    sta_train_counts, sta_train = phase_train_sta(ex81)
    remat_counts, remat = phase_train_remat(ex81)
    lora_counts, lora = phase_train_lora(ex81)
    w8_counts, w8 = phase_dit14b_w8()
    w4_counts, w4 = phase_e2e_14b_w4()
    int8_counts, int8 = phase_cli_14b_int8(ex81)
    load_counts, load = phase_load(ex81)
    parallel_counts, par = phase_parallel(ex81)
    eval_counts, ev = phase_evals(records[1]["outputs"][0], sta_record["outputs"][0])

    import torch

    log(f"summary: build {build_s:.2f} s; DiT forward {dit_ms:.1f} ms, with STA "
        f"{sta_dit_ms:.1f} ms; requests "
        + ", ".join(f"{r['case']} {r['seconds']:.2f} s ({r['frames']} frames)" for r in records)
        + f", with STA {sta_record['case']} {sta_record['seconds']:.2f} s; training steps "
        f"{[round(x, 2) for x in train['step_s']]} s, peak {train['peak_gb']:.2f} GB, with STA "
        f"{[round(x, 2) for x in sta_train['step_s']]} s, peak {sta_train['peak_gb']:.2f} GB; "
        + "".join(f"under {k} {[round(x, 2) for x in v['step_s']]} s, peak {v['peak_gb']:.2f} "
                  f"GB, gradients {v['grad_rel']:.2e} from default's; " for k, v in remat.items())
        + f"LoRA rank {LORA_RANK} {[round(x, 2) for x in lora['step_s']]} s, peak "
        f"{lora['peak_gb']:.2f} GB, merge {lora['merge_rel']:.2e}; "
        f"14B W8A16 forward {w8['fwd_ms']:.1f} ms ({w8['param_gb']:.2f} GB of parameters, "
        f"peak {w8['peak_gb']:.2f} GB); 14B W4A16 clip step {w4['step_s']} s, decode "
        f"{w4.get('vae_decode_s')} s ({w4['param_gb']} GB of parameters, peak {w4['peak_gb']} "
        f"GB); 14B int8 request {int8['seconds']:.2f} s, peak {int8['peak_gb']:.2f} GB; "
        f"161-frame long-clip request {long_rec['seconds']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in long_rec["phases"].items())
        + f"), peak {long_rec['peak_gb']:.2f} GB; --load request {load['seconds']:.2f} s, "
        "loads " + ", ".join(f"{r['what']} {r['bytes'] / 1e9 / r['seconds']:.2f} GB/s"
                             for r in load["loads"])
        + f", load peak {load['peak_gb']:.3f} GB for {load['dit_gb']:.3f} GB of DiT, phase "
        f"{load['phase_s']:.1f} s; parallel phase {par['phase_s']:.1f} s; evals phase "
        f"{ev['phase_s']:.1f} s (the STA gate {ev['validate_weights']['seconds']:.1f} s); "
        f"whole run "
        f"{time.perf_counter() - t_start:.0f} s; card {card}")

    paths = {"sample_cli": sample_counts, "train_cli": train_counts,
             "sample_cli_sta": sta_sample_counts, "train_cli_sta": sta_train_counts,
             "dit14b_w8": w8_counts, "e2e_14b_w4": w4_counts, "sample_cli_14b_int8": int8_counts,
             "sample_cli_long": long_counts, "sample_cli_load": load_counts,
             **remat_counts, "train_cli_lora": lora_counts, "parallel_2ranks": parallel_counts,
             "validate_weights": eval_counts}

    def entry(name, source, replaces):
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_err_per_std": PER_STD[name], **kernels[name]}

    csrc = "scail_tpu_torch/csrc/"
    report = {"kernels": [
        entry("flash_attention_rope", csrc + "flash_attention.cu", "scail_tpu/ops/attention.py:403"),
        entry("flash_attention", csrc + "flash_attention.cu", "scail_tpu/ops/attention.py:68"),
        entry("dual_cross_attention", csrc + "dual_cross_attention.cu",
              "scail_tpu/ops/attention.py:875"),
        entry("flash_attention_bwd_dq", csrc + "flash_attention_bwd.cu",
              "scail_tpu/ops/attention.py:251"),
        entry("flash_attention_bwd_dkv", csrc + "flash_attention_bwd.cu",
              "scail_tpu/ops/attention.py:286"),
        entry("sta_attention_fwd", csrc + "sta_attention.cu", "scail_tpu/ops/sta.py:159"),
        entry("sta_attention_fwd_lse", csrc + "sta_attention.cu", "scail_tpu/ops/sta.py:159"),
        entry("sta_attention_bwd_dq", csrc + "sta_attention.cu", "scail_tpu/ops/sta.py:246"),
        entry("sta_attention_bwd_dkv", csrc + "sta_attention.cu", "scail_tpu/ops/sta.py:279"),
        entry("w8a16_matmul", csrc + "w8a16_matmul.cu", "scail_tpu/ops/quant.py:65"),
        entry("w4a16_matmul", csrc + "w8a16_matmul.cu", "scail_tpu/ops/quant.py:65"),
        entry("flash_attention_int8", csrc + "flash_attention_int8.cu",
              "scail_tpu/ops/attention.py:708"),
        entry("adaln_layer_norm", csrc + "fused_norms.cu", "scail_tpu/ops/fused_norms.py:28"),
        entry("rotary", csrc + "fused_norms.cu", "scail_tpu/ops/fused_norms.py:79"),
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
