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
                 synthetic example, its pose and GT clips in MPEG-4); both
                 .mp4 clips decode to the right frames.
  5b. CLI STA -- the 81-frame request again with --attn-impl sta.
  6. train    -- `scail_tpu_torch.cli.train` with the 1.3B YAML at 512x896, 81
                 frames, batch 1: 2 steps (finite losses, the DiT's parameters
                 move, 60 + 60 forward and 30 + 30 backward kernel launches
                 per step); the DiT's parameter gradients on the kernel path
                 against the plain path on a small input; then, at 4 layers
                 (two full-depth checkpoints would pass the machine's disk-write
                 limit), 2 steps saved and 1 step resumed from the checkpoint,
                 each step logged (log_interval 1): metrics.jsonl read back,
                 and the TensorBoard scalars under <save>/runs/train where
                 torch.utils.tensorboard imports (the line says which
                 backends were live).
  6b. train STA -- 2 steps at full width and depth from a YAML with
                 `attn_impl: sta` (exact K7/K8/K2/K3/K5 launches), gradients
                 kernel vs plain path.
  6c. remat policies -- the train CLI, 2 steps each, from YAML copies that
                 set `remat_policy`: dense save_attn, save_attn_frac 0.7 and
                 offload_attn at full width and CUT_LAYERS (4) layers (K1 4 / 6
                 / 4 a step instead of 8), STA save_attn at full width and
                 depth (K7 with the LSE 60 instead of 120, K2 30 instead of
                 60); each one's step-1 loss bit-equal to `default`'s at the
                 same depth and seed (phase 6's 4-layer save run, phase 6b), its step-1
                 gradients within 1e-3 relative L2 of them, peak and step
                 seconds, offload_attn's peak within 0.5 GB of `default`'s.
                 Before each, on a 2-layer DiT at full width and 48,832 tokens,
                 every kept flash output against a fresh launch on the q, k
                 and v the recompute gives: bit-equal.
  6d. LoRA    -- the train CLI with --lora-rank 16 at full width and
                 CUT_LAYERS layers, 2 steps: the launches of a full fine-tune
                 at that depth, every base tensor bit-equal
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
  5c. CLI long clip -- the sampling CLI with the 1.3B YAML cut to CUT_LAYERS
                 layers and configs/sampling/pose_cli_long.yaml (RFSamplerLong)
                 on a 161-frame 512x896 synthetic example, 2 steps: 41 latent
                 frames in 3 tiles of 21, 8 DiT forwards at CFG batch 2 and
                 48,832 tokens, exactly 32 K1 + 32 K3 + 72 K9 + 32 K10; an .mp4 of
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
                 seq 2, CUT_LAYERS layers, CFG batch 2, 48,832 tokens (per
                 rank exactly K2 4, K3 4, K10 8, K9 9, all-to-all 16); at 4
                 layers the ring at seq 2 (K2 8, p2p 4), TP at model 2
                 (all-reduce 32), STA under Ulysses and under TP; the MoE
                 DiT (8 experts, top 2) at 2 layers under expert parallelism
                 at model 2, 4 experts a rank (all-reduce 16); each
                 against the one-process kernel path on rank 0, relative L2
                 <= 3e-2.  The ring and Ulysses attention alone at (1,
                 48,832, 12, 128), forward and backward (ring: K2 2, K5 2 + 2,
                 p2p 3), against one-process K2 + K5.  Then `train
                 --distributed --mesh-model 2`, 2
                 steps at full width and PARALLEL_TRAIN_LAYERS layers (exact
                 launches; step 1's loss within 3e-2 of the one-process step
                 at the same depth and seed), and vae_decode_cp of 21
                 latent frames at 512x896 against the streamed decode.  After
                 the train run's counts, training/sync.py on the trained,
                 sharded model: drift 0.0, a replicated parameter moved by 0.5
                 on rank 1 found on both ranks, sync_params_across_ranks back
                 to 0.0.
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
  12. image   -- the SD-family image path (inference/, models/unet.py,
                 autoencoding/, diffusion/embedders.py) in f32 with TF32 off,
                 random weights from seeds: (a) SamplingPipeline(SDXL_V1_BASE)
                 builds the 2.57 B UNet, both text towers at full depth and
                 the KL VAE on the card; text_to_image at 1024 x 1024, CFG 5, 2
                 steps under each of the six Sampler values on the LegacyDDPM
                 ladder and DPMPP2M on the EDM ladder: a finite (1, 1024,
                 1024, 3) image in [0, 1] and exactly the UNet forwards of
                 UNET_FORWARDS; seconds and peak GB of each; the UNet forward
                 at CFG batch 2, the VAE decode and each text tower timed.
                 (b) image_to_image at strength 0.5 on (a)'s image; the base
                 freed, SamplingPipeline(SDXL_V1_REFINER) and `refiner` on
                 (a)'s latent.  (c) card against CPU from one state dict:
                 the SDXL UNet with every transformer depth 1 on a 32 x 32
                 latent, the VAE on a 256 x 256 image, both towers at 2
                 layers, relative L2 <= 1e-4.  (d) the 1.3B DiT at full width
                 and depth through VideoDiffusionEngine.sample with the zoo's
                 DPMPP2MSampler over EDMDiscretization and VanillaCFG, 2 steps:
                 exactly 60 K1 + 60 K3 + 122 K9 + 60 K10, a finite latent.
                 (e) one PD distillation step (PDDiffusionLoss, VideoScaling)
                 with a 2-layer 1.3B-width student carrying cfg_embed and a
                 teacher alike at 48,832 tokens, its backward and exact
                 launches; TASDLoss and TASDLossRF on a plain torch network,
                 card against CPU within 1e-5.
  13. trainers -- (a) Trainer.fit through the train CLI on the 1.3B at full
                 width and CUT_LAYERS layers: train_iters 4, exit_interval 2,
                 eval_interval 1, eval_iters 1 on the step's example: 2 steps
                 and 2 evaluations, each evaluation exactly _eval_launches
                 (one forward without remat), the timers' ms per step and
                 report_memory (no save: the hooks' run below saves);
                 then at 4 layers with --save: step 1's loss made NaN under
                 skip_nan (skipped), step 2 inside profile_trace with an
                 annotate range (the trace file holds it), step 3's loss NaN
                 with skip_nan off (applied), the exit at 3 of 4 and its final
                 save, metrics read back.  (b) AutoencoderTrainer with
                 LPIPSWithDiscriminator (hinge, the adaptive weight, LPIPS at
                 random weights) and NLayerDiscriminator (ndf 64, 3 layers),
                 f32 with TF32 off, 2 generator and 2 discriminator steps at
                 256 x 256, batch 2, on the VQGAN of vqgan_imagenet_f16_1024
                 and Kandinsky 2.x's MOVQ, and the MOVQ with the EMA quantiser:
                 ms a step, peak GB, finite losses, the codebook moved.  (c) the
                 video tokenizer at the JAX package's defaults (init_dim 64, LFQ
                 2^18 codes) on a 17-frame 128 x 128 clip under
                 VideoAutoencoderLoss and the 3D discriminator (image_size 128,
                 frame_num 16) on the 16 frames after the first (its 3D blocks
                 halve the frames, as the JAX function's reshape needs), the
                 LFQ's entropy terms in chunks of tokens; those terms chunked
                 against unchunked on 2,048 tokens, the chunked pass timed on
                 all 36,864.  (d) card against CPU, relative L2 <= 1e-4:
                 VQModel and MOVQ at depth 1, both discriminators, the
                 tokenizer at init_dim 8, LFQ at 2^8 codes, both losses with
                 their gradients.

  14. zoo     -- one model at a time, each freed before the next: (a) the SVD
                 VideoUNet at Stability's svd.yaml widths (1.5 B, f32, TF32
                 off), one forward of 14 frames at 576x1024 at CFG batch 2
                 (28 frames), ms and peak GB; card against CPU on 4 frames of
                 a 16x16 latent, relative L2 <= 1e-4.  (b) The MoE DiT at
                 scail_1p3b.yaml's widths with 8 experts, top 2 (6.6 B expert
                 parameters, bf16): one forward at CFG batch 2 and 48,832
                 tokens with exactly K1 30, K3 30, K9 61, K10 30; its kernel
                 path against its plain path at 4 layers, relative L2 <=
                 3e-2.  (d) Llama-2-7B's widths: filling_sequence fills 32
                 tokens after a 2 x 128 prompt, greedy through the KV cache,
                 greedy by full recompute and top-k 40 / top-p 0.9, ms a token
                 and peak GB in bf16; the cached greedy tokens equal full
                 recompute's in f32.  (e) One 128-token prompt forward of
                 Mixtral-8x7B (2 of 32 layers), GLM-4-9B, ChatGLM-6B,
                 ChatGLM2-6B, GLM-130B (2 of 70 layers), GPT-2, GPT-Neo-1.3B,
                 GLM-large and cuda2d (2 layers at CogView's width, layout
                 (64, 1088, 5184), kernels 9 / 7) in bf16, ms and peak GB; each
                 at 2 layers in f32 against the CPU (GLM-130B at width 4,096),
                 relative L2 <= 1e-4.  Each step's seconds.  (c), the MoE DiT
                 under expert parallelism, runs in phase 10.
  15. encoders -- the encoder zoo at published widths, random bf16 weights
                 from seeds, one model at a time: T5 v1.1 XL (encode 2 x
                 512 tokens; 32 greedy tokens through the KV cache; in f32 at
                 24 + 24 layers the cached greedy tokens equal full
                 recompute's), BERT-large and RoBERTa-large (8 x 512 with
                 padding), the three DPR towers (the question through
                 BertWordPieceTokenizer on a 30,522-entry vocab this script
                 writes; 16 x 256 passages; a reader pass over 4 x 256),
                 ViT-L/16 (batch 32 at 224), CaiT-M48 (batch 4 at 448),
                 EVA-02-L/14 (batch 16 at 224, half the patches masked),
                 YOLOS-B (2 x 800 x 1,344: its position tables resized from
                 the 512 x 864 grid), GLM-4V-9B (13.9 B: one 1,120² image, 1,602
                 image rows spliced into 128 text tokens) and MAE ViT-H/14
                 (forward, norm_pix loss and backward at batch 16): ms or ms a
                 token, peak GB, finite outputs of the right shapes; each at
                 2 layers in f32 against the CPU on one state dict (GLM-4V at
                 a 224² image; MAE's loss and every gradient), relative L2
                 <= 1e-4.  The image tokenizer over the VQGAN f16-1024 (codes
                 card vs CPU at >= 99.9% of positions, the decode <= 1e-4);
                 GPT-2 with adapters: one adapters-only AdamW step leaves every
                 base tensor bit-equal and moves every adapter tensor.  No TPU
                 kernel lies on this phase; its line is {"encoders": ...}.

Every DiT forward also runs the fused AdaLN LayerNorm (K9) 2L+1 times (before
each layer's attention and MLP, and in the final layer) and the rotary
kernel (K10) on k in every dense layer, on q and k under STA and int8-QK, and
on q in the dense backward; the exact counts above include them (phase 3
holds both against their plain versions at the main-path shapes).

The line before the last is {"kernels": [...]}: per kernel its launches on the
main paths (`launches_by_path`: the sampling CLI of phases 5, 5b and 5c, the
train CLI of phases 6, 6b, 6c (one path per policy) and 6d, the 14B paths of
phases 7, 7b and 8, the --load request of phase 9, the two ranks of phase
10 (their runs summed), the two sampling passes of validate_weights in
phase 11, phase 12's DiT under DPMPP2MSampler and its PD step, phase
13's Trainer.fit with its evaluations and its 4-layer hook run, and phase
14's MoE DiT forward (`dit_moe`), each counted from 0, and their sum), its largest
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

import contextlib
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


def timed_ms(fn, iters=3, warmup=True):
    """Mean milliseconds of fn() on the card, after one warm-up call (none
    with warmup False: for the plain versions, whose one call takes 0.05 to
    13 s on shapes the comparison before it has already run)."""
    import torch

    if warmup:
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
                q, kk, v, rope=rope, rope_interleaved=bool(interleaved)), iters=1,
                warmup=False)
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
    plain_ms = timed_ms(lambda: A.dual_cross_attention_plain(q, k1, v1, k2, v2), iters=1,
                        warmup=False)
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
            plain_ms = timed_ms(lambda: mm(x, codes, scale, bias, impl="xla"), iters=1,
                                warmup=False)
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
    plain_ms = timed_ms(lambda: A.flash_attention_int8_plain(q, k, v, block_q=128), iters=1,
                        warmup=False)
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
                                                                grads=g),
                                 iters=1, warmup=False)
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
            qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q), iters=1, warmup=False)
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
            qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q), iters=1, warmup=False)
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
                qc, k, v, o, lse, dc, tables, ts=plan.ts, ts_q=ts_q, grads=g), iters=1,
                warmup=False)
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
    plain_ms = timed_ms(lambda: A.flash_attention_plain(qr, k, v), iters=1, warmup=False)
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
                            iters=1, warmup=False) for g in ("dq", "dkv")}
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


def synthetic_example(out_dir, frames, size=(512, 896)):
    """The fixture of scripts/make_synthetic_example.py (its reference image
    and moving stick figure, seed 0) with the pose and GT clips written as
    MPEG-4 through OpenCV (rendered.mp4, GT.mp4, 16 fps), as a pose render
    usually comes: the script's GIFs take ≈ 30 s to encode at 161 frames,
    and every request decodes them again."""
    import importlib.util

    import cv2
    import numpy as np
    from PIL import Image

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_example", os.path.join(ROOT, "scripts", "make_synthetic_example.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    h, w = size
    os.makedirs(out_dir, exist_ok=True)
    ref = np.random.default_rng(0).integers(40, 216, (h, w, 3), np.uint8)
    Image.fromarray(ref).save(os.path.join(out_dir, "ref.png"))
    clip = script._stick_figure_frames(frames, h, w, 0)
    for name in ("rendered.mp4", "GT.mp4"):
        path = os.path.join(out_dir, name)
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 16.0, (w, h))
        if not writer.isOpened():
            fail(f"OpenCV cannot encode MPEG-4 to {path}")
        for frame in clip:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
    log(f"wrote the synthetic fixture ({frames} frames at {h}x{w}, MPEG-4) -> {out_dir}")


def phase_cli():
    import numpy as np

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames

    os.makedirs(WORK, exist_ok=True)
    ex81 = os.path.join(WORK, "synthetic_081")
    synthetic_example(ex81, 81)
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
# forward kernels, one each for the two backward kernels, in each of L layers;
# K9 twice per layer site and once in the final layer (not recomputed), K10
# on k in the forward and the recompute and on q in the backward (the K9 and
# K10 backwards are plain torch)
def _train_launches(L):
    return {"flash_attention_rope": 2 * L, "dual_cross_attention": 2 * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "adaln_layer_norm": 4 * L + 1, "rotary": 3 * L}


# one evaluation forward (no remat: evaluate is under no_grad): K1 and K3 a
# layer, K9 2L + 1, K10 on k
def _eval_launches(L):
    return {"flash_attention_rope": L, "dual_cross_attention": L,
            "adaln_layer_norm": 2 * L + 1, "rotary": L}


TRAIN_LAUNCHES_PER_STEP = _train_launches(30)
# One checkpoint of the 30-layer trainer state (f32 params, two Adam moments,
# EMA shadow) is ~23.4 GiB, and the chip machine allows ~45 GiB of disk writes
# per run: save and resume are checked on the same YAML cut to this depth.
RESUME_LAYERS = 4
# the depth at which the earlier paths that only repeat the main path's
# layers run (6c's dense remat policies, 6d's LoRA steps, 5c's long clip,
# 10's Ulysses forward and 13 (a)'s Trainer.fit): the whole run must stay
# inside its time limit as phases are added.  6c's dense baseline is phase
# 6's save run, at the same depth
CUT_LAYERS = RESUME_LAYERS


def _watched(L):
    return ("layers.0.qkv.weight", f"layers.{L - 1}.mlp_out.weight", "final_layer.linear.weight",
            "patch_embed.proj.weight")


TRAIN_WATCHED = _watched(30)


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


def _cut_yaml(layers):
    """A copy of the 1.3B YAML at `layers` layers (full width), in WORK."""
    import yaml

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        cut = yaml.safe_load(f)
    cut["model"]["network_config"]["params"]["num_layers"] = layers
    path = os.path.join(WORK, f"scail_1p3b_{layers}layers.yaml")
    os.makedirs(WORK, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cut, f)
    return path


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


def _log_every_step():
    """The Trainer logs every step inside the block (the train CLI keeps
    TrainConfig's log_interval of 10, more than the smoke runs' steps)."""
    import contextlib
    import functools

    import scail_tpu_torch.training.engine as engine_mod

    @contextlib.contextmanager
    def ctx():
        real = engine_mod.TrainConfig
        engine_mod.TrainConfig = functools.partial(real, log_interval=1)
        try:
            yield
        finally:
            engine_mod.TrainConfig = real

    return ctx()


def _metrics_read_back(save, backends, iters, label):
    """The Trainer's metric outputs under `save`: metrics.jsonl's records of
    `iters`, and, where TensorBoard was live, the `loss` scalars read back
    from <save>/runs/train equal to the JSONL's.  Returns a record."""
    recs = [json.loads(x) for x in open(os.path.join(save, "metrics.jsonl"))]
    if [r["iter"] for r in recs] != iters or not all(
            isinstance(r["loss"], float) for r in recs):
        fail(f"{label}: metrics.jsonl holds {recs}, expected iterations {iters}")
    out = {"backends": backends, "jsonl_records": len(recs)}
    if backends["tensorboard"]:
        from tensorboard.backend.event_processing import event_accumulator

        acc = event_accumulator.EventAccumulator(os.path.join(save, "runs", "train"))
        acc.Reload()
        got = sorted((e.step, e.value) for e in acc.Scalars("loss"))
        want = [(r["iter"], r["loss"]) for r in recs]
        if [s for s, _ in got] != iters or not all(
                (g != g and w != w) or abs(g - w) <= 1e-6 * max(1.0, abs(w))
                for (_, g), (_, w) in zip(got, want)):
            fail(f"{label}: TensorBoard's loss scalars {got} differ from metrics.jsonl's {want}")
        out["tensorboard_scalars"] = len(acc.Tags()["scalars"])
    log(f"{label}: metric writers live on this machine: {backends} (tensorboard: "
        f"{'live' if backends['tensorboard'] else 'absent'}); metrics.jsonl {len(recs)} "
        f"records" + (f", TensorBoard {out['tensorboard_scalars']} scalar tags read back "
                      "equal" if backends["tensorboard"] else ""))
    return out


def phase_train(ex81):
    """The train CLI at full width and depth: 2 steps (the main path), then
    the DiT's gradients, kernel path against plain path; then save and
    resume at RESUME_LAYERS layers: 2 steps saved, 1 step resumed, every
    step logged through the metric writers (metrics.jsonl, and TensorBoard
    where it imports), read back."""
    import gc
    import math
    import shutil

    import torch

    from scail_tpu_torch.cli import train

    base = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")
    argv = _train_argv(base, _data_root(ex81))
    trainer, counts, stats = _train(argv, TRAIN_LAUNCHES_PER_STEP, "train")
    BASELINE["dense"].update(loss=stats["losses"][0], peak_gb=stats["peak_gb"],
                             step_s=stats["step_s"])
    stats["grad_rel"] = _grad_parity(trainer.model, {"attn_impl": "auto"}, {"attn_impl": "xla"},
                                     (3, 16, 16), "train")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # save, then resume, on the same YAML at RESUME_LAYERS layers
    cut_yaml = _cut_yaml(RESUME_LAYERS)
    save = os.path.join(WORK, "train_run")
    shutil.rmtree(save, ignore_errors=True)
    short = _train_argv(cut_yaml, _data_root(ex81)) + ["--save", save]
    t0 = time.perf_counter()
    with _log_every_step():
        # this run's step 1 is the `default` baseline of phase 6c's dense
        # policies (the same YAML at RESUME_LAYERS layers, the same seed)
        torch.cuda.reset_peak_memory_stats()
        with _first_grads(BASELINE["dense_cut"]):
            first = train.main(short + ["--train-iters", "2"])
        BASELINE["dense_cut"].update(loss=first.history[0]["loss"],
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        backends = first.metrics_writer.backends
        saved = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(save)
                    for n in ns if not d.startswith(os.path.join(save, "runs")))
        del first
        gc.collect()
        resumed = train.main(short + ["--train-iters", "3", "--resume"])
    torch.cuda.synchronize()
    stats["metrics"] = _metrics_read_back(save, backends, [1, 2, 3], "train --save")
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
def _sta_train_launches(L):
    return {"sta_attention_fwd_lse": 4 * L, "flash_attention": 2 * L,
            "dual_cross_attention": 2 * L, "sta_attention_bwd_dq": 2 * L,
            "sta_attention_bwd_dkv": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "adaln_layer_norm": 4 * L + 1, "rotary": 4 * L}


STA_TRAIN_LAUNCHES_PER_STEP = _sta_train_launches(30)
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
                                    on_first_grads=_keep_grads(BASELINE["sta"]))
    BASELINE["sta"].update(loss=stats["losses"][0], peak_gb=stats["peak_gb"],
                           step_s=stats["step_s"])
    stats["grad_rel"] = _grad_parity(trainer.model, {"sta_impl": "auto"}, {"sta_impl": "xla"},
                                     STA_SMALL, "train STA")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return counts, stats


# phase 6c: the remat policies that keep the flash outputs, at L layers.  Per
# training step, K1 (dense) launches once per layer in the forward and again
# in the recompute of the layers that do not keep their outputs: L under
# save_attn and offload_attn, 2L - int(0.7 L) under save_attn_frac 0.7; under
# STA save_attn, K7 with the LSE (video and pose calls) and K2 (ref rows)
# launch in the forward only.  Everything else is as under `default`.
def _policy_launches(label, L):
    if label == "sta_save_attn":
        return dict(_sta_train_launches(L), sta_attention_fwd_lse=2 * L, flash_attention=L)
    k1 = {"save_attn": L, "offload_attn": L, "save_attn_frac": 2 * L - int(0.7 * L)}[label]
    return dict(_train_launches(L), flash_attention_rope=k1)


# each policy's step-1 parameter gradients against `default`'s from the same
# seed: relative L2 (the same kernels; only the recompute differs)
POLICY_GRAD_REL_TOL = 1e-3
# offload_attn keeps the flash outputs in pinned host memory: its device peak
# may pass `default`'s by no more than this (GB)
OFFLOAD_PEAK_SLACK_GB = 0.5
LORA_RANK = 16
# merge_lora's forward against the factored one (bf16 compute)
LORA_MERGE_REL_TOL = DIT_REL_TOL

# `default`'s step-1 loss, peak and step seconds: dense and STA at full depth
# (phases 6 and 6b, with STA's step-1 gradients on the host), dense at
# CUT_LAYERS layers (phase 6's save run, with its gradients)
BASELINE = {"dense": {}, "sta": {}, "dense_cut": {}}


def _keep_grads(into):
    def keep(grads):
        into["grads"] = {n: g.detach().to("cpu", copy=True) for n, g in grads.items()}
    return keep


@contextlib.contextmanager
def _first_grads(into):
    """Keep the first step's parameter gradients (before clipping) of the
    train CLI run inside, on the host, in into["grads"]."""
    import scail_tpu_torch.training.engine as engine_mod

    real = engine_mod.clip_by_global_norm_
    keep = _keep_grads(into)

    def clip(grads, max_norm):
        if "grads" not in into:
            keep(grads)
        return real(grads, max_norm)

    engine_mod.clip_by_global_norm_ = clip
    try:
        yield
    finally:
        engine_mod.clip_by_global_norm_ = real


def _grads_vs_baseline(baseline, path, out):
    """on_first_grads hook: the relative L2 distance of the step-1 gradients
    from `default`'s (baseline["grads"]), one tensor on the card at a time,
    into out["rel"]."""
    import torch

    def compare(grads):
        base = baseline["grads"]
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
    """Phase 6c: the train CLI under each remat policy that keeps the flash
    outputs: dense save_attn, save_attn_frac 0.7 and offload_attn at full
    width and CUT_LAYERS layers, STA save_attn at full width and depth: exact
    launches, step 1's loss bit-equal to `default`'s at the same depth from
    the same seed (phase 6's save run, phase 6b), the step-1 gradients within
    POLICY_GRAD_REL_TOL, peaks and step seconds; before each, the kept
    outputs against a fresh launch (_stash_check).  Returns ({path: launch
    counts}, {policy: stats})."""
    import gc

    import torch

    t_phase = time.perf_counter()
    counts, stats = {}, {}
    L = CUT_LAYERS
    runs = [("save_attn", "dense_cut", L, dict(remat_policy="save_attn")),
            ("save_attn_frac", "dense_cut", L,
             dict(remat_policy="save_attn_frac", remat_save_frac=0.7)),
            ("offload_attn", "dense_cut", L, dict(remat_policy="offload_attn")),
            ("sta_save_attn", "sta", 30, dict(remat_policy="save_attn", attn_impl="sta"))]
    for label, path, layers, params in runs:
        stash_diff = _stash_check(params["remat_policy"],
                                  **{k: v for k, v in params.items() if k != "remat_policy"})
        grads, base = {}, BASELINE[path]
        trainer, c, st = _train(
            _train_argv(_policy_yaml(label, num_layers=layers, **params), _data_root(ex81)),
            _policy_launches(label, layers), f"train {label} at {layers} layers",
            watched=_watched(layers), on_first_grads=_grads_vs_baseline(base, path, grads))
        st.update(grad_rel=grads["rel"], stash_max_diff=stash_diff,
                  loss_equal=st["losses"][0] == base["loss"])
        log(f"train {label}: step-1 loss {st['losses'][0]!r} against default's "
            f"{base['loss']!r} (bit-equal {st['loss_equal']}); step-1 gradients "
            f"relative L2 {grads['rel']:.3e} from default's (tol {POLICY_GRAD_REL_TOL}); peak "
            f"{st['peak_gb']:.2f} GB against default's {base['peak_gb']:.2f} GB; steps "
            f"{[round(x, 2) for x in st['step_s']]} s ({layers} layers)")
        if not st["loss_equal"]:
            fail(f"{label}: step 1's loss differs from default's")
        if not grads["rel"] <= POLICY_GRAD_REL_TOL:
            fail(f"{label}: step 1's gradients differ from default's")
        if label == "offload_attn" and \
                st["peak_gb"] > base["peak_gb"] + OFFLOAD_PEAK_SLACK_GB:
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
    """Phase 6d: the train CLI with --lora-rank 16 at full width and
    CUT_LAYERS layers, `default` remat: exact launches (those of the full fine-tune), every base
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
    L = CUT_LAYERS
    base_yaml = _cut_yaml(L)
    lora = ["--lora-rank", str(LORA_RANK)]
    before = {}

    def snapshot(trainer):  # the frozen base, on the host
        before.update({n: t.detach().to("cpu", copy=True)
                       for n, t in trainer.model.state_dict().items() if "lora_" not in n})

    trainer, counts, st = _train(_train_argv(base_yaml, _data_root(ex81)) + lora,
                                 _train_launches(L), f"train LoRA at {L} layers",
                                 watched=("layers.0.qkv.lora_b", f"layers.{L - 1}.mlp_out.lora_b"),
                                 on_start=snapshot)
    model = trainer.model
    state = model.state_dict()
    changed = [n for n, t in before.items() if not torch.equal(state[n].cpu(), t)]
    lora_b = [n for n in state if n.endswith("lora_b")]
    zero_b = [n for n in lora_b if not bool(state[n].any())]
    trained = sum(p.numel() for p in trainer.params.values())
    log(f"train LoRA: {len(before)} base tensors bit-equal after 2 steps: {not changed}; "
        f"{len(lora_b)} lora_b, all non-zero: {not zero_b}; {trained / 1e6:.2f} M trained "
        f"parameters; peak {st['peak_gb']:.2f} GB; steps {[round(x, 2) for x in st['step_s']]} s "
        f"({L} layers)")
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
    log(f"merge_lora: merged vs factored forward (2, 3, 16, 16, 16), {L} layers: relative L2 "
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
# (0, 1) and (1, 2), 4 DiT forwards at CFG batch 2 and 48,832 tokens, of the
# DiT at CUT_LAYERS layers
LONG_TILES = [(0, 20), (13, 33), (20, 40)]
LONG_FORWARDS = 8


def _tokens(x_shape, patch=(2, 2)):
    """The DiT's fused sequence for a latent (b, T, C, H, W): ref + video +
    half-resolution pose tokens."""
    T, H, W = x_shape[1], x_shape[3] // patch[0], x_shape[4] // patch[1]
    return H * W + T * H * W + T * (H // 2) * (W // 2)


def phase_cli_long():
    """The sampling CLI with the long-clip YAML (RFSamplerLong) on a 161-frame
    512x896 synthetic example, the DiT at CUT_LAYERS layers, 2 steps: 3 tiles,
    8 DiT forwards at CFG batch 2 and 48,832 tokens, exact launches, the
    .mp4's 161 frames, per-phase seconds and peak GB."""
    import gc

    import numpy as np
    import torch

    from scail_tpu_torch.cli import sample_video
    from scail_tpu_torch.data.video import load_video_frames
    from scail_tpu_torch.models.dit import DiT

    ex161 = os.path.join(WORK, "synthetic_161")
    synthetic_example(ex161, 161)
    prompts = os.path.join(WORK, "prompts_long.txt")
    with open(prompts, "w") as f:
        f.write(f"a character dancing@@{ex161}\n")
    argv = ["--base", _cut_yaml(CUT_LAYERS),
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
    _exact(counts, {k: LONG_FORWARDS * v for k, v in _eval_launches(CUT_LAYERS).items()},
           "the long-clip CLI, 2 steps")
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
PARALLEL_TRAIN_LAYERS = 4
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

    # Ulysses at CUT_LAYERS layers (its all-to-alls are staged through the
    # host at ~0.6 GB/s a rank, so its seconds grow with the depth)
    L = CUT_LAYERS
    dit = _build_dit(attn_impl="ulysses", num_layers=L)
    out, r = _rank_dit(dit, inp, seq, f"Ulysses seq 2, {L} layers",
                       (_mesh_dit_launches(L, "ulysses"), {"all_to_all": 4 * L}))
    record(f"ulysses_{L}", out, r, reference(dit, dit.config))
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
    del dit, tp
    gc.collect()
    torch.cuda.empty_cache()

    # expert parallelism: the MoE DiT at 2 layers, 8 experts, 4 a rank (its
    # linears tensor parallel as above, the MoE output all-reduced once)
    full_moe = _moe_dit(2) if rank == 0 else None
    ep = _moe_dit(2)
    shard_module_(ep, dit_param_rules(), model)
    if ep.layers[0].moe_in.weight.shape[0] != MOE["num_experts"] // 2:
        fail(f"moe_ep_2: rank {rank} holds {ep.layers[0].moe_in.weight.shape[0]} experts")
    out, r = _rank_dit(ep, inp, model, "moe_ep_2",
                       (_mesh_dit_launches(2, "auto"), {"all_reduce": 16}))
    record("moe_ep_2", out, r, reference(full_moe, full_moe.config if rank == 0 else None))
    del full_moe, ep, out, inp
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


def _parallel_train_argv():
    return _train_argv(_cut_yaml(PARALLEL_TRAIN_LAYERS), os.path.join(WORK, "train_data"))


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
    r["param_sync"] = _param_sync_check(trainer)
    _no_jax_loaded(f"rank {torch.distributed.get_rank()} after the train CLI")
    del trainer
    return r


def _param_sync_check(trainer):
    """training/sync.py on the trained, sharded model, after the run's
    launches and collectives were counted: drift 0.0; one replicated
    parameter moved by 0.5 on rank 1 and the drift found on both ranks;
    sync_params_across_ranks brings it back to 0.0."""
    import torch
    import torch.distributed as dist

    from scail_tpu_torch.training.sync import check_param_sync, sync_params_across_ranks

    t0 = time.perf_counter()
    params = dict(trainer.model.named_parameters())
    agree = trainer.check_param_sync()
    name = next(n for n, p in params.items() if not trainer._sharded(n, p))
    if dist.get_rank() == 1:
        with torch.no_grad():
            params[name].view(-1)[0] += 0.5
    drift = check_param_sync(params, atol=float("inf"), mesh=trainer.mesh, rules=trainer.rules)
    sync_params_across_ranks(params, mesh=trainer.mesh, rules=trainer.rules)
    after = trainer.check_param_sync()
    res = {"agree": agree, "perturbed": name, "drift": drift, "after": after,
           "seconds": time.perf_counter() - t0}
    log(f"param sync (rank {dist.get_rank()}): {res}")
    if agree != 0.0 or abs(drift - 0.5) > 1e-3 or after != 0.0:
        fail(f"param sync on rank {dist.get_rank()}: {res}")
    return res


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


NO_JAX_MODULES = ("jax", "jaxlib", "flax", "ml_dtypes", "scail_tpu")


def _no_jax_loaded(where):
    """Fail if this process holds jax, flax, ml_dtypes (which TensorFlow
    imports, and TensorBoard imports TensorFlow where one is installed) or
    the JAX package."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in NO_JAX_MODULES)
    if bad:
        fail(f"{where}: the port's run imported {bad[:8]}")
    log(f"{where}: none of {', '.join(NO_JAX_MODULES)} is imported")


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
    log("parallel: replica sync after the two-rank train run: " + "; ".join(
        f"rank {rank} {rec['train']['param_sync']}" for rank, rec in enumerate(recs)))
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


# phase 12: the SD-family image path (inference/, models/unet.py,
# autoencoding/, diffusion/embedders.py and the EDM-era sampler zoo) at SDXL
# base's full width on random weights from seeds, f32 with TF32 off; then the
# zoo over the DiT and one PD distillation step on the kernels
IMAGE_STEPS = 2
IMAGE_SIZE = 1024
IMAGE_SCALE = 5.0
# UNet forwards (each at CFG batch 2) of a sampler at n steps into sigma 0:
# Heun and DPM++ 2S make a second call a step, but not into sigma 0
UNET_FORWARDS = {"EulerEDMSampler": lambda n: n, "HeunEDMSampler": lambda n: 2 * n - 1,
                 "EulerAncestralSampler": lambda n: n,
                 "DPMPP2SAncestralSampler": lambda n: 2 * n - 1,
                 "DPMPP2MSampler": lambda n: n, "LinearMultistepSampler": lambda n: n}
# card against CPU, per module, relative L2 (f32 both sides)
IMAGE_REL_TOL = 1e-4
# the TASD losses on the card against the CPU
TASD_REL_TOL = 1e-5
PD_LAYERS = 2


def _counted_unet(net):
    """A list that gets the batch of every UNet forward."""
    calls = []
    net.register_forward_pre_hook(lambda m, args: calls.append(args[0].shape[0]))
    return calls


def _image_checks(label, out, shape):
    import torch

    if tuple(out.shape) != shape or not torch.isfinite(out).all() or \
            not (0.0 <= float(out.min()) and float(out.max()) <= 1.0):
        fail(f"image: {label} gave {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}, "
             f"range [{float(out.min())}, {float(out.max())}]; expected {shape} in [0, 1]")


def _image_sampling(stats):
    """(a) SDXL base at 1024 x 1024 under all six samplers; the UNet, decode
    and text-tower times.  Returns the pipeline, the first image and latent."""
    import torch

    from scail_tpu_torch.inference.api import (Discretization, ModelArchitecture, Sampler,
                                               SamplingParams, SamplingPipeline)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = SamplingPipeline(ModelArchitecture.SDXL_V1_BASE,
                            model_path=os.path.join(WORK, "no_checkpoints"), device="cuda", seed=0)
    torch.cuda.synchronize()
    model = pipe.model
    n_unet = sum(p.numel() for p in model.network.parameters())
    towers = model.text_embedders()
    stats["base"] = {"build_s": time.perf_counter() - t0, "unet_params": n_unet,
                     "tower_params": [sum(p.numel() for p in e.model.parameters()) for e in towers],
                     "vae_params": sum(p.numel() for p in model.first_stage_model.parameters()),
                     "build_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    calls = _counted_unet(model.network)
    runs = [(s, Discretization.LEGACY_DDPM) for s in Sampler] + [
        (Sampler.DPMPP2M, Discretization.EDM)]
    first = None
    stats["samplers"] = {}
    for sampler, disc in runs:
        params = SamplingParams(width=IMAGE_SIZE, height=IMAGE_SIZE, steps=IMAGE_STEPS,
                                sampler=sampler, discretization=disc, scale=IMAGE_SCALE)
        label = f"{sampler.value} ({disc.value})"
        calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, lat = pipe.text_to_image(params, "a lighthouse on a cliff at dawn, oil painting",
                                      negative_prompt="blurry", samples=1, return_latents=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        _image_checks(label, out, (1, IMAGE_SIZE, IMAGE_SIZE, 3))
        want = [2] * UNET_FORWARDS[sampler.value](IMAGE_STEPS)
        if calls != want:
            fail(f"image: {label}: UNet forwards {calls}, expected {want}")
        stats["samplers"][label] = {"s": secs, "peak_gb": peak, "unet_forwards": len(calls)}
        log(f"image: SDXL base {label}, {IMAGE_STEPS} steps at {IMAGE_SIZE}^2, CFG {IMAGE_SCALE}: "
            f"{secs:.2f} s, peak {peak:.2f} GB, {len(calls)} UNet forwards at CFG batch 2")
        if first is None:
            first = (out, lat)

    with torch.no_grad():
        g = torch.Generator(device="cuda").manual_seed(5)
        side = IMAGE_SIZE // 8
        x = torch.randn((2, 4, side, side), generator=g, device="cuda")
        t = torch.full((2,), 500, device="cuda")
        ctx = torch.randn((2, 77, 2048), generator=g, device="cuda")
        y = torch.randn((2, 2816), generator=g, device="cuda")
        stats["unet_ms_cfg2"] = timed_ms(lambda: model.network(x, t, ctx, y), iters=3)
        z = torch.randn((1, 4, side, side), generator=g, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        stats["vae_decode_ms"] = timed_ms(lambda: model.decode_first_stage(z), iters=2)
        stats["vae_decode_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats["tower_ms"] = [timed_ms(lambda e=e: e(["a lighthouse on a cliff at dawn"]), iters=3)
                             for e in towers]
    calls.clear()
    log(f"image: SDXL base UNet {n_unet / 1e9:.3f} B parameters, towers "
        f"{[round(n / 1e9, 3) for n in stats['base']['tower_params']]} B, VAE "
        f"{stats['base']['vae_params'] / 1e6:.1f} M, built in {stats['base']['build_s']:.1f} s; "
        f"UNet forward at CFG batch 2 ({side}x{side} latent) {stats['unet_ms_cfg2']:.1f} ms, VAE "
        f"decode {stats['vae_decode_ms']:.1f} ms (peak {stats['vae_decode_peak_gb']:.2f} GB), "
        f"text towers {[round(m, 2) for m in stats['tower_ms']]} ms a prompt")
    return pipe, first


def _image_img2img_and_refiner(held, stats):
    """(b) image_to_image at strength 0.5 on (a)'s first image; then, the base
    freed (`held` gives up the last reference), the refiner on (a)'s latent."""
    import torch

    from scail_tpu_torch.inference.api import ModelArchitecture, SamplingParams, SamplingPipeline

    pipe = held.pop("pipe")
    image, latent = held.pop("first")
    params = SamplingParams(width=IMAGE_SIZE, height=IMAGE_SIZE, steps=IMAGE_STEPS,
                            scale=IMAGE_SCALE, img2img_strength=0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.image_to_image(params, image * 2.0 - 1.0, "a lighthouse on a cliff, watercolour")
    torch.cuda.synchronize()
    stats["img2img_s"] = time.perf_counter() - t0
    _image_checks("image_to_image", out, (1, IMAGE_SIZE, IMAGE_SIZE, 3))
    del pipe, out
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = SamplingPipeline(ModelArchitecture.SDXL_V1_REFINER,
                           model_path=os.path.join(WORK, "no_checkpoints"), device="cuda", seed=1)
    torch.cuda.synchronize()
    stats["refiner_build_s"] = time.perf_counter() - t0
    stats["refiner_unet_params"] = sum(p.numel() for p in ref.model.network.parameters())
    calls = _counted_unet(ref.model.network)
    t0 = time.perf_counter()
    out = ref.refiner(SamplingParams(width=IMAGE_SIZE, height=IMAGE_SIZE, steps=IMAGE_STEPS,
                                     scale=IMAGE_SCALE), latent, "a lighthouse on a cliff")
    torch.cuda.synchronize()
    stats["refiner_s"] = time.perf_counter() - t0
    stats["refiner_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _image_checks("refiner", out, (1, IMAGE_SIZE, IMAGE_SIZE, 3))
    if calls != [2] * IMAGE_STEPS:
        fail(f"image: refiner UNet forwards {calls}, expected {[2] * IMAGE_STEPS}")
    log(f"image: image_to_image (strength 0.5) {stats['img2img_s']:.2f} s; refiner (UNet "
        f"{stats['refiner_unet_params'] / 1e9:.3f} B parameters, built in "
        f"{stats['refiner_build_s']:.1f} s) {stats['refiner_s']:.2f} s, peak "
        f"{stats['refiner_peak_gb']:.2f} GB")
    del ref, out
    _free_card()


def _image_card_vs_cpu(stats):
    """(c) each module on the card and on the CPU from one state dict: the
    SDXL UNet at its widths with every transformer depth 1 on a 32 x 32
    latent, the VAE at its widths on a 256 x 256 image, both text towers at 2
    layers."""
    import copy
    import dataclasses

    import torch
    import yaml

    from scail_tpu_torch.autoencoding.autoencoder_kl import AutoencoderKLModeOnly
    from scail_tpu_torch.diffusion.embedders import ClipTextTower
    from scail_tpu_torch.models.unet import UNetModel
    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "inference", "sd_xl_base.yaml")) as f:
        model = yaml.safe_load(f)["model"]["params"]
    rel = {}
    g = torch.Generator(device="cuda").manual_seed(7)

    def both(label, card, cpu, *inputs):
        with torch.no_grad():
            got = card(*(t.cuda() for t in inputs)).cpu()
            want = cpu(*inputs)
        rel[label] = _card_vs_cpu_rel(label, got, want)

    unet_p = dict(model["network_config"]["params"], transformer_depth=1)
    card = UNetModel(**unet_p, device="cuda").init_random_(g, zero_modules=False)
    cpu = UNetModel(**unet_p)
    cpu.load_state_dict(card.state_dict())
    gc = torch.Generator().manual_seed(8)
    both("UNet (SDXL widths, depth 1, 32x32 latent)", card, cpu,
         torch.randn((1, 4, 32, 32), generator=gc), torch.tensor([421.0]),
         torch.randn((1, 77, 2048), generator=gc), torch.randn((1, 2816), generator=gc))
    del card, cpu
    _free_card()

    vae_cfg = model["first_stage_config"]["params"]
    card = AutoencoderKLModeOnly(**vae_cfg, device="cuda").init_random_(g)
    cpu = AutoencoderKLModeOnly(**vae_cfg)
    cpu.load_state_dict(card.state_dict())
    img = torch.rand((1, 3, 256, 256), generator=gc) * 2 - 1
    both("VAE encode (256x256)", card.encode, cpu.encode, img)
    both("VAE decode (32x32 latent)", card.decode, cpu.decode,
         torch.randn((1, 4, 32, 32), generator=gc))
    del card, cpu
    _free_card()

    cond = instantiate_from_config(model["conditioner_config"])
    for emb in cond.embedders[:2]:  # CLIP-L (hidden) and OpenCLIP bigG (penultimate, pooled)
        emb.cfg = dataclasses.replace(emb.cfg, text_layers=2)
        if emb.layer == "hidden":
            emb.layer_idx = 1
        emb.model = ClipTextTower(emb.cfg, emb.with_projection, device="meta")
        emb.init(g, device="cuda")
        cpu = copy.copy(emb)
        cpu.model = ClipTextTower(emb.cfg, emb.with_projection)
        cpu.model.load_state_dict(emb.model.state_dict())
        prompts = ["a lighthouse on a cliff at dawn", ""]
        got, want = emb(prompts), cpu(prompts)
        got, want = (got if isinstance(got, tuple) else (got,)), \
            (want if isinstance(want, tuple) else (want,))
        for i, (a, b) in enumerate(zip(got, want)):
            label = f"{type(emb).__name__} output {i} (2 layers)"
            rel[label] = _card_vs_cpu_rel(label, a.cpu(), b)
    stats["card_vs_cpu_rel_l2"] = rel
    _free_card()


def _card_vs_cpu_rel(label, got, want):
    import torch

    r = _rel_l2(got.float(), want.float())
    log(f"image: {label}: card vs CPU relative L2 {r:.3e} (tol {IMAGE_REL_TOL:.0e})")
    if not (torch.isfinite(got).all() and r <= IMAGE_REL_TOL):
        fail(f"image: {label} on the card disagrees with the CPU ({r:.3e})")
    return r


def _image_dit_zoo(stats):
    """(d) the 1.3B DiT at full width and depth under the zoo's DPMPP2MSampler
    over EDMDiscretization with VanillaCFG, in-process through
    VideoDiffusionEngine.sample, 2 steps at 48,832 tokens."""
    import torch

    from scail_tpu_torch.engine import VideoDiffusionEngine
    from scail_tpu_torch.utils.config import load_configs, split_reference_config

    base = os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")
    mc = dict(split_reference_config(load_configs([base]))[1])
    for key in ("first_stage_config", "i2v_clip_config", "conditioner_config", "loss_fn_config"):
        mc.pop(key, None)  # sampling from given conditioning needs the DiT only
    d = "sgm.modules.diffusionmodules."
    mc["sampler_config"] = {"target": d + "sampling.DPMPP2MSampler", "params": {
        "num_steps": IMAGE_STEPS,
        "guider_config": {"target": d + "guiders.VanillaCFG", "params": {"scale": 5.0}},
        # sigma_max 1: the RF DiT's c_noise (sigma * 1000) stays in its range
        "discretization_config": {"target": d + "discretizer.EDMDiscretization",
                                  "params": {"sigma_min": 0.002, "sigma_max": 1.0}}}}
    eng = VideoDiffusionEngine(mc, {"bf16": True}, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    eng.init_params(g)
    cfg = eng.network.config
    assert (cfg.hidden_size, cfg.num_layers) == (1536, 30), cfg
    inp = _dit_inputs(g, 21, 64, 112)
    cond = {k: inp[k][:1] for k in ("ref_concat", "concat_smpl_render", "image_clip_features")}
    cond["crossattn"] = inp["context"][:1]
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lat = eng.sample(g, cond, uc, batch_size=1, shape=(21, 16, 64, 112))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    _exact(counts, {k: 2 * v for k, v in DIT_LAUNCHES.items()},
           "the DiT under DPMPP2MSampler, 2 steps")
    if tuple(lat.shape) != (1, 21, 16, 64, 112) or not torch.isfinite(lat.float()).all():
        fail(f"image: the DiT zoo latent {tuple(lat.shape)} not finite")
    stats["dit_zoo"] = {"s": secs, "launches": {k: v for k, v in counts.items() if v}}
    log(f"image: 1.3B DiT under DPMPP2MSampler (EDM ladder, VanillaCFG), 2 steps at CFG batch "
        f"2, 48,832 tokens: {secs:.2f} s; launches {stats['dit_zoo']['launches']}")
    del eng, lat, inp
    _free_card()
    return counts


def _pd_dit(g, trainable):
    import torch
    import yaml

    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        nc = yaml.safe_load(f)["model"]["network_config"]
    nc["params"].update(dtype="bf16", use_i2v_clip=True, num_layers=PD_LAYERS,
                        cfg_embed_dim=nc["params"]["time_embed_dim"])
    dit = instantiate_from_config(nc).build("meta")
    if trainable:  # f32 parameters, bf16 compute, as the trainer holds them
        dit.init_weights_(g, device=torch.device("cuda"))
        return dit.requires_grad_(True).train()
    dit.init_weights_(g, device=torch.device("cuda"), dtype=torch.bfloat16)
    return dit.eval()


def _image_pd_and_tasd(stats):
    """(e) one PD distillation step (PDDiffusionLoss over the zero-SNR ladder,
    a Denoiser of VideoScaling and UnitWeighting) with a 2-layer 1.3B-width
    student carrying cfg_embed and a second such DiT as the teacher, at
    48,832 tokens; its loss, backward and exact launches.  Then TASDLoss and
    TASDLossRF on a plain torch network, card against CPU."""
    import torch

    from scail_tpu_torch.utils.registry import instantiate_from_config

    d = "sgm.modules.diffusionmodules."
    zero_snr = {"target": d + "discretizer.ZeroSNRDDPMDiscretization"}
    loss = instantiate_from_config({"target": d + "loss.PDDiffusionLoss",
                                    "params": {"discretization_config": zero_snr}})
    den = instantiate_from_config({"target": d + "denoiser.Denoiser", "params": {
        "weighting_config": {"target": d + "denoiser_weighting.UnitWeighting"},
        "scaling_config": {"target": d + "denoiser_scaling.VideoScaling"}}})
    g = torch.Generator(device="cuda").manual_seed(10)
    student, teacher = _pd_dit(g, True), _pd_dit(g, False)
    inp = _dit_inputs(g, 21, 64, 112)
    cond = {k: inp[k][:1] for k in ("ref_concat", "concat_smpl_render", "image_clip_features")}
    cond["crossattn"] = inp["context"][:1]
    latent = inp["x"][:1].float()

    def net(dit):
        def fn(x, c_noise, c, **kw):
            return dit(x, c_noise, c["crossattn"], ref_concat=c["ref_concat"],
                       concat_smpl_render=c["concat_smpl_render"],
                       image_clip_features=c["image_clip_features"], cfg_scale=kw.get("cfg_scale"))
        return fn

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    value = loss(g, net(student), den, cond, latent, teacher_fn=net(teacher)).mean()
    value.backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    L = PD_LAYERS
    # the student's step with remat (the YAML's checkpoint_activations), as a
    # training step of L layers; the teacher's two forwards under no_grad
    want = {"flash_attention_rope": 2 * L + 2 * L, "dual_cross_attention": 2 * L + 2 * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "adaln_layer_norm": (4 * L + 1) + 2 * (2 * L + 1), "rotary": 3 * L + 2 * L}
    _exact(counts, want, "the PD step")
    grads = [p.grad for p in student.parameters() if p.grad is not None]
    if not (torch.isfinite(value) and grads and all(torch.isfinite(gr).all() for gr in grads)):
        fail(f"image: PD step loss {value.item()} or its gradients not finite")
    stats["pd_step"] = {"s": secs, "loss": value.item(), "peak_gb":
                        torch.cuda.max_memory_allocated() / 1e9,
                        "launches": {k: v for k, v in counts.items() if v}}
    log(f"image: PD step ({L}-layer 1.3B-width student with cfg_embed, teacher alike, 48,832 "
        f"tokens): loss {value.item():.6f}, {secs:.2f} s, peak {stats['pd_step']['peak_gb']:.2f} "
        f"GB; launches {stats['pd_step']['launches']}")
    del student, teacher, inp, latent, value, grads
    _free_card()

    # the TASD losses on a plain torch network, the same draws on both devices
    tasd = instantiate_from_config({"target": d + "loss.TASDLoss", "params": {
        "sigma_sampler_config": {"target": d + "sigma_sampling.DiscreteSampling",
                                 "params": {"discretization_config": zero_snr}}}})
    tasd_den = instantiate_from_config({"target": d + "denoiser.DiscreteDenoiser_TASD", "params": {
        "num_idx": 1000, "quantize_c_noise": False, "discretization_config": zero_snr,
        "weighting_config": {"target": d + "denoiser_weighting.UnitWeighting"},
        "scaling_config": {"target": d + "denoiser_scaling.VideoScaling"}}})
    rf = instantiate_from_config({"target": d + "loss.TASDLoss_RF", "params": {
        "schedule_shift": True,
        "sigma_sampler_config": {"target": d + "sigma_sampling.RFSampling"}}})
    rf_den = instantiate_from_config({"target": d + "denoiser.Denoiser", "params": {
        "weighting_config": {"target": d + "denoiser_weighting.EpsWeighting"},
        "scaling_config": {"target": d + "denoiser_scaling.RFScaling"}}})
    gc = torch.Generator().manual_seed(11)
    x = torch.randn((2, 3, 16, 64, 64), generator=gc)
    noise = torch.randn(x.shape, generator=gc)
    idx = torch.randint(1, 999, (2, 3), generator=gc)
    t_idx = torch.rand((2, 3), generator=gc) * 0.9 + 0.05
    w = torch.randn((16, 16), generator=gc) / 4

    def plain_net(xin, c_noise, c, rope_position_ids=None, **kw):
        h = torch.einsum("btchw,dc->btdhw", xin, w.to(xin.device))
        shape = c_noise.shape + (1,) * (xin.dim() - c_noise.dim())
        return torch.tanh(h) + 1e-3 * c_noise.reshape(shape).float() + 1e-4 * \
            rope_position_ids.float().mean()

    vals = {}
    for dev in ("cuda", "cpu"):
        def on(t):
            return t.to(dev)
        vals[dev] = (
            tasd(None, plain_net, tasd_den, {}, on(x), noise=on(noise), alphas_idx=on(idx)),
            rf(None, plain_net, rf_den, {}, on(x), noise=on(noise), t_indices=on(t_idx)))
    for name, a, b in zip(("TASDLoss", "TASDLossRF"), vals["cuda"], vals["cpu"]):
        r = _rel_l2(a.cpu().float(), b.float())
        log(f"image: {name} card {a.cpu().tolist()} vs CPU {b.tolist()}: relative {r:.3e} "
            f"(tol {TASD_REL_TOL:.0e})")
        if not r <= TASD_REL_TOL:
            fail(f"image: {name} on the card disagrees with the CPU ({r:.3e})")
        stats[f"{name}_rel"] = r
    return counts


def phase_image():
    """Phase 12: the image path at SDXL base's full width, then the zoo over
    the DiT and the PD / TASD losses.  Returns the DiT zoo's and the PD
    step's launches and the phase's record."""
    t_phase = time.perf_counter()
    stats = {"seconds": {}}
    t0 = time.perf_counter()
    pipe, first = _image_sampling(stats)
    held = {"pipe": pipe, "first": first}
    del pipe, first
    t1 = time.perf_counter()
    _image_img2img_and_refiner(held, stats)
    t2 = time.perf_counter()
    _image_card_vs_cpu(stats)
    t3 = time.perf_counter()
    zoo_counts = _image_dit_zoo(stats)
    t4 = time.perf_counter()
    pd_counts = _image_pd_and_tasd(stats)
    stats["seconds"].update(sampling=t1 - t0, img2img_refiner=t2 - t1, card_vs_cpu=t3 - t2,
                            dit_zoo=t4 - t3, pd_tasd=time.perf_counter() - t4)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 (image): {stats['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stats["seconds"].items()) + ")")
    print(json.dumps({"image": stats}), flush=True)
    return zoo_counts, pd_counts, stats


TRAINER_HOOK_LAYERS = 4
# card against CPU for the autoencoder modules (f32 both sides, TF32 off)
TRAINERS_REL_TOL = 1e-4
# the published first stages: taming-transformers' vqgan_imagenet_f16_1024.yaml
# and Kandinsky 2.x's movq
VQGAN_F16_1024 = dict(ddconfig=dict(double_z=False, z_channels=256, resolution=256,
                                    in_channels=3, out_ch=3, ch=128, ch_mult=(1, 1, 2, 2, 4),
                                    num_res_blocks=2, attn_resolutions=(16,), dropout=0.0),
                      n_embed=1024, embed_dim=256)
KANDINSKY_MOVQ = dict(ddconfig=dict(double_z=False, z_channels=4, resolution=256, in_channels=3,
                                    out_ch=3, ch=128, ch_mult=(1, 2, 2, 4), num_res_blocks=2,
                                    attn_resolutions=(32,), dropout=0.0),
                      n_embed=16384, embed_dim=4)
# the losses' gradients on cuDNN against the CPU where a LeakyReLU input of
# the 3D discriminator lies within rounding of 0 (|x| <= KINK_NEAR of that
# activation's largest) and lands on the other side on the card: its slope
# there is 1 on one device and 0.1 on the other, which moves the gradient of
# every weight below it by ~2e-3 (on an H100 with cuDNN 9.22, one input at
# 5.2e-9, 1.3e-7 of its activation's largest, flips under cuDNN's rounding;
# none with cuDNN off).  Without such a flip the cuDNN run is held at
# TRAINERS_REL_TOL like the rest
KINK_NEAR = 1e-5
KINK_GRAD_TOL = 5e-3
# LFQ's entropy terms, chunked against unchunked on the card, on this many tokens
LFQ_CHECK_TOKENS = 2048


def _diff_counts(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _trainers_dit_fit(ex81, stats):
    """(a) Trainer.fit on the 1.3B DiT at full width and depth through the
    train CLI: train_iters 4, exit_interval 2, eval_interval 1, eval_iters 1
    on the step's example; 2 steps and 2 evaluations, the launches each
    evaluation adds, the timers and report_memory."""
    import dataclasses
    import itertools
    import math

    import torch

    from scail_tpu_torch.cli import train
    from scail_tpu_torch.training.engine import Trainer
    from scail_tpu_torch.utils.profiling import report_memory

    seen = {"evals": [], "eval_launches": [], "eval_s": []}
    real_fit, real_eval = Trainer.fit, Trainer.evaluate

    def fit(self, data_iter, *a, **kw):
        self.config = dataclasses.replace(self.config, exit_interval=2, eval_interval=1,
                                          eval_iters=1)
        first = next(data_iter)
        return real_fit(self, itertools.chain([first], data_iter), itertools.repeat(first),
                        self.loss_fn)

    def evaluate(self, data_iter, loss_fn):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        v = real_eval(self, data_iter, loss_fn)
        torch.cuda.synchronize()
        seen["eval_s"].append(time.perf_counter() - t0)
        seen["eval_launches"].append(_diff_counts(launch_counts(), before))
        seen["evals"].append(v)
        return v

    Trainer.fit, Trainer.evaluate = fit, evaluate
    try:
        argv = _train_argv(_cut_yaml(CUT_LAYERS), _data_root(ex81)) + ["--train-iters", "4"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.fit, Trainer.evaluate = real_fit, real_eval
    steps = len(trainer.history)
    timer_ms = {n: trainer.timers(n).elapsed(reset=False) * 1e3 / steps
                for n in ("data loader", "train_step")}
    timers_line = trainer.timers.log(["data loader", "train_step"], normalizer=steps)
    mem = report_memory("phase 13 (a), after Trainer.fit")
    losses = [m["loss"] for m in trainer.history]
    want = {k: 2 * v + 2 * _eval_launches(CUT_LAYERS).get(k, 0)
            for k, v in _train_launches(CUT_LAYERS).items()}
    log(f"trainers (a): Trainer.fit at {CUT_LAYERS} layers: stopped at step {trainer.step} of 4 "
        f"(exit_interval 2), losses {losses}, evaluation losses {seen['evals']} "
        f"({[round(x, 2) for x in seen['eval_s']]} s each); timers per step: {timers_line} "
        f"(phase 6's steps {BASELINE['dense'].get('step_s')} s); report_memory {mem}; each "
        f"evaluation launched {seen['eval_launches']}; all launches {counts}; {total:.1f} s "
        "with the engine build")
    if trainer.step != 2 or steps != 2 or not all(m["ok"] for m in trainer.history) or \
            not all(math.isfinite(x) for x in losses):
        fail(f"trainers (a): fit did not take 2 finite steps and exit: {trainer.history}")
    if len(seen["evals"]) != 2 or not all(math.isfinite(x) for x in seen["evals"]):
        fail(f"trainers (a): expected 2 finite evaluations, got {seen['evals']}")
    for i, got in enumerate(seen["eval_launches"]):
        _exact(got, _eval_launches(CUT_LAYERS), f"trainers (a), evaluation {i + 1}")
    _exact(counts, want, "trainers (a), 2 steps and 2 evaluations")
    stats["dit_fit"] = {"losses": losses, "eval_losses": seen["evals"], "eval_s": seen["eval_s"],
                        "timer_ms_per_step": timer_ms, "report_memory": mem,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "seconds": total}
    del trainer
    _free_card()
    return counts


def _trainers_dit_hooks(ex81, stats):
    """(a) at TRAINER_HOOK_LAYERS layers, full width, with --save: step 1's
    loss made NaN under skip_nan (skipped: no update, the optimizer count
    stays), step 2 inside profile_trace with an annotate range, step 3's
    loss NaN with skip_nan off (applied: the parameters turn NaN); the exit
    at 3 of 4, its final save, the metric writers read back."""
    import dataclasses
    import shutil

    import torch

    from scail_tpu_torch.cli import train
    from scail_tpu_torch.training.checkpoint import read_latest
    from scail_tpu_torch.training.engine import Trainer
    from scail_tpu_torch.utils.profiling import annotate, profile_trace, trace_path

    L = TRAINER_HOOK_LAYERS
    save, trace_dir = os.path.join(WORK, "trainers_run"), os.path.join(WORK, "trainers_trace")
    for d in (save, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    rec = {"ok": [], "count": [], "moved": [], "nan": []}
    real_fit, real_step = Trainer.fit, Trainer.train_step

    def fit(self, *a, **kw):
        self.config = dataclasses.replace(self.config, exit_interval=3, log_interval=1)
        return real_fit(self, *a, **kw)

    def train_step(self, batch):
        i = self.step
        name = next(iter(self.params))
        before = self.params[name].detach().clone()
        if i in (0, 2):
            self.config = dataclasses.replace(self.config, skip_nan=(i == 0))
            real_loss = self.loss_fn
            self.loss_fn = lambda g, b: real_loss(g, b) * float("nan")
            try:
                m = real_step(self, batch)
            finally:
                self.loss_fn = real_loss
        else:
            with profile_trace(trace_dir), annotate("phase13_train_step"):
                m = real_step(self, batch)
            torch.cuda.synchronize()
        after = self.params[name].detach()
        rec["ok"].append(m["ok"])
        rec["count"].append(self.opt_state.count)
        rec["moved"].append(not torch.equal(before, after))
        rec["nan"].append(bool(torch.isnan(after).any()))
        return m

    Trainer.fit, Trainer.train_step = fit, train_step
    try:
        argv = _train_argv(_cut_yaml(L), _data_root(ex81)) + ["--save", save,
                                                              "--train-iters", "4"]
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Trainer.fit, Trainer.train_step = real_fit, real_step
    per_step = {"flash_attention_rope": 2 * L, "dual_cross_attention": 2 * L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "adaln_layer_norm": 4 * L + 1, "rotary": 3 * L}
    _exact(counts, {k: 3 * v for k, v in per_step.items()}, f"trainers (a), {L} layers, 3 steps")
    with open(trace_path(trace_dir)) as f:
        events = json.load(f)["traceEvents"]
    annotated = sum(e.get("name") == "phase13_train_step" for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    metrics = _metrics_read_back(save, trainer.metrics_writer.backends, [1, 2, 3],
                                 "trainers (a) hooks")
    out = dict(rec, skipped=trainer.skipped, step=trainer.step, latest=read_latest(save),
               trace_events=len(events), trace_annotated=annotated, trace_kernels=kernels,
               metrics=metrics, seconds=total)
    log(f"trainers (a) hooks at {L} layers: {out}")
    if rec != {"ok": [False, True, True], "count": [0, 1, 2], "moved": [False, True, True],
               "nan": [False, False, True]} or trainer.skipped != 1 or trainer.step != 3 or \
            out["latest"] != "3" or not annotated:
        fail(f"trainers (a): skip_nan / exit / final save / trace checks failed: {out}")
    stats["dit_hooks"] = out
    del trainer
    shutil.rmtree(save, ignore_errors=True)
    _free_card()
    return counts


def _top_kernels(fn, n=6):
    """The n kernels that take the most device time in fn() (torch.profiler
    over CUPTI): {name: ms}."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:n]
    return {e.key[:80]: round(e.device_time_total / 1e3, 3) for e in rows}


def _timed_steps(trainer, batch, generator, n=4):
    """n alternating train steps, each between device synchronisations:
    (losses, ms of each step)."""
    import torch

    losses, ms = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch, generator, i, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def _trainers_vq(stats, lpips):
    """(b) AutoencoderTrainer with LPIPSWithDiscriminator (hinge, disc_start
    0, the adaptive weight, LPIPS at random weights) and NLayerDiscriminator
    (ndf 64, 3 layers): the VQGAN f16-1024 and the MOVQ at their published
    widths, then the MOVQ with the EMA quantiser, 2 generator and 2
    discriminator steps each at 256 x 256, batch 2, f32."""
    import math

    import torch

    from scail_tpu_torch.autoencoding import (AutoencoderTrainer, EMAVectorQuantizer,
                                              LPIPSWithDiscriminator, NLayerDiscriminator)
    from scail_tpu_torch.autoencoding.vqgan import MOVQ, VQModel

    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand((2, 3, 256, 256), generator=g, device="cuda") * 2 - 1
    out = {}
    for label, cls, cfg, ema in (("vqgan_f16_1024", VQModel, VQGAN_F16_1024, False),
                                 ("movq", MOVQ, KANDINSKY_MOVQ, False),
                                 ("movq_ema", MOVQ, KANDINSKY_MOVQ, True)):
        model = cls(**cfg, device="cuda").init_random_(g)
        parts = model.trainer_parts()
        if ema:
            parts["regularizer"] = EMAVectorQuantizer(cfg["n_embed"], cfg["embed_dim"], beta=0.25,
                                                      device="cuda").init_random_(g)
        codebook = parts["regularizer"].embedding.weight
        before = codebook.detach().clone()
        disc = NLayerDiscriminator(3, 64, 3, device="cuda").init_random_(g)
        loss = LPIPSWithDiscriminator(disc_start=0, disc_loss="hinge", lpips=lpips,
                                      regularization_weights={"loss/vq": 1.0})
        trainer = AutoencoderTrainer(**parts, loss=loss, discriminator=disc)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = _timed_steps(trainer, x, g)
        moved = (codebook.detach() - before).abs().max().item()
        r = {"params_m": sum(p.numel() for p in model.parameters()) / 1e6, "losses": losses,
             "step_ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "codebook_moved": moved}

        def step_pair():
            trainer.train_step(x, g, 0, 4)
            trainer.train_step(x, g, 1, 4)

        r["top_kernels_ms"] = _top_kernels(step_pair)  # one more pair, profiled
        log(f"trainers (b) {label}: {r}")
        if not all(math.isfinite(v) for v in losses) or not moved > 0:
            fail(f"trainers (b) {label}: non-finite loss or a codebook that did not move: {r}")
        out[label] = r
        del model, parts, disc, trainer, codebook, before
        _free_card()
    stats["vq"] = out


class _AfterFirstFrame:
    """The video discriminator on the frames after the first: a 17-frame clip
    (a first frame, then 16) gives it 16, which its 3D blocks halve."""

    def __init__(self, disc):
        self.disc = disc

    def __call__(self, x):
        return self.disc(x[:, :, 1:])

    def parameters(self):
        return self.disc.parameters()


def _trainers_tokenizer(stats, lpips):
    """(c) the video tokenizer at the JAX package's default config (init_dim
    64, LFQ 2^18 codes) on 17 frames at 128 x 128, batch 1, under
    VideoAutoencoderLoss with the 3D discriminator (image_size 128,
    frame_num 16): 2 generator and 2 discriminator steps, the LFQ chunked;
    then its entropy terms chunked against unchunked on LFQ_CHECK_TOKENS
    tokens, and the chunked pass timed on all of them."""
    import math

    import torch

    from scail_tpu_torch.autoencoding import (AutoencoderTrainer, VideoAutoencoderLoss,
                                              VideoDiscriminator, lfq_entropy_terms)
    from scail_tpu_torch.autoencoding.regularizers import lfq_auto_chunk, lfq_codebook
    from scail_tpu_torch.autoencoding.video_tokenizer import VideoTokenizer, VideoTokenizerConfig

    g = torch.Generator(device="cuda").manual_seed(14)
    tok = VideoTokenizer(VideoTokenizerConfig(), device="cuda").init_random_(g)
    disc = VideoDiscriminator(image_size=128, frame_num=16, device="cuda").init_random_(g)
    loss = VideoAutoencoderLoss(disc_start=0, perceptual_weight=1.0, adversarial_loss_weight=0.1,
                                grad_penalty_loss_weight=10.0, quantizer_aux_loss_weight=1.0,
                                lpips=lpips)
    trainer = AutoencoderTrainer(**tok.trainer_parts(), loss=loss,
                                 discriminator=_AfterFirstFrame(disc))
    v = torch.rand((1, 3, 17, 128, 128), generator=g, device="cuda") * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _timed_steps(trainer, v, g)
    peak = torch.cuda.max_memory_allocated() / 1e9
    lfq = tok.quantizers
    with torch.no_grad():
        feats = tok.encode(v).movedim(1, -1)
        _, idx, _, br = tok.quantize(tok.encode(v))
        x = torch.nn.functional.linear(feats, lfq.project_in.weight, lfq.project_in.bias)
    x = x.reshape(-1, 1, lfq.codebook_dim).float()
    n = x.shape[0]
    cb = lfq_codebook(lfq.codebook_size, device="cuda")
    chunk = lfq_auto_chunk(n, 1, lfq.codebook_size)

    def entropy_pass(xx, ch):
        xx = xx.detach().requires_grad_(True)
        ps, be = lfq_entropy_terms(xx, cb, lfq.inv_temperature, ch)
        (ps - lfq.diversity_gamma * be).backward()
        return ps.item(), be.item(), xx.grad

    lfq_ms = _timed_on_card(lambda: entropy_pass(x, chunk))[1] * 1e3
    sub = x[:LFQ_CHECK_TOKENS]
    a, b = entropy_pass(sub, None), entropy_pass(sub, 512)
    rel = {"per_sample_entropy": abs(a[0] - b[0]) / abs(a[0]),
           "batch_entropy": abs(a[1] - b[1]) / abs(a[1]),
           "grad_rel_l2": _rel_l2(b[2], a[2])}
    r = {"params_m": sum(p.numel() for p in tok.parameters()) / 1e6, "losses": losses,
         "step_ms": ms, "peak_gb": peak, "tokens": n, "chunk_tokens": chunk,
         "per_sample_entropy": br["per_sample_entropy"].item(),
         "batch_entropy": br["batch_entropy"].item(), "codes_used": int(idx.unique().numel()),
         "lfq_entropy_fwd_bwd_ms": lfq_ms, "chunked_vs_unchunked": rel}
    log(f"trainers (c) video tokenizer: {r}")
    if not all(math.isfinite(v) for v in losses) or not all(x <= TRAINERS_REL_TOL
                                                            for x in rel.values()):
        fail(f"trainers (c): non-finite loss, or the chunked LFQ entropy disagrees: {r}")
    stats["tokenizer"] = r
    del tok, disc, trainer, x, sub, a, b
    _free_card()


def _with_lrelu_inputs(fn, dev):
    """fn(dev), and the input of every LeakyReLU of the 3D discriminator that
    it ran, on the host, in call order."""
    import scail_tpu_torch.autoencoding.discriminator as disc_mod

    seen, real = [], disc_mod._lrelu

    def lrelu(x, slope):
        seen.append(x.detach().float().cpu())
        return real(x, slope)

    disc_mod._lrelu = lrelu
    try:
        return fn(dev), seen
    finally:
        disc_mod._lrelu = real


def _trainers_card_vs_cpu(stats, lpips_cpu):
    """(d) each new module on the card and on the CPU from one state dict,
    f32: VQModel and MOVQ at their widths with 1 resnet block a level (64 x
    64), both discriminators, the tokenizer at init_dim 8, LFQ at 2^8 codes,
    and both losses with their gradients; relative L2 <= TRAINERS_REL_TOL."""
    import copy

    import torch

    from scail_tpu_torch.autoencoding import (LFQ, LPIPSWithDiscriminator, NLayerDiscriminator,
                                              VideoAutoencoderLoss, VideoDiscriminator)
    from scail_tpu_torch.autoencoding.video_tokenizer import VideoTokenizer, VideoTokenizerConfig
    from scail_tpu_torch.autoencoding.vqgan import MOVQ, VQModel

    g = torch.Generator().manual_seed(15)
    rel = {}

    def check(label, got, want, tol=TRAINERS_REL_TOL):
        for i, (a, b) in enumerate(zip(got, want)):
            r = _rel_l2(a.detach().cpu().float(), b.detach().float())
            rel[f"{label}[{i}]"] = r
            if not (torch.isfinite(a).all() and r <= tol):
                fail(f"trainers (d): {label} output {i} on the card disagrees with the CPU "
                     f"({r:.3e} > {tol:.0e})")

    def both(label, module, fn, *inputs):
        card = copy.deepcopy(module).cuda()
        with torch.no_grad():
            check(label, fn(card, *(t.cuda() for t in inputs)), fn(module, *inputs))

    img = torch.rand((1, 3, 64, 64), generator=g) * 2 - 1
    for name, cls, cfg in (("VQModel", VQModel, VQGAN_F16_1024), ("MOVQ", MOVQ, KANDINSKY_MOVQ)):
        m = cls(**dict(cfg, ddconfig=dict(cfg["ddconfig"], num_res_blocks=1))).init_random_(g)
        both(name, m, lambda mm, x: (mm(x)[0], mm.encode(x)[0]), img)
    both("NLayerDiscriminator", NLayerDiscriminator(3, 64, 3).init_random_(g),
         lambda mm, x: (mm(x),), torch.rand((2, 3, 64, 64), generator=g) * 2 - 1)
    vdisc = VideoDiscriminator(image_size=32, frame_num=4).init_random_(g)
    clip = torch.rand((2, 3, 4, 32, 32), generator=g) * 2 - 1
    both("VideoDiscriminator", vdisc, lambda mm, x: (mm(x),), clip)
    tok = VideoTokenizer(VideoTokenizerConfig(init_dim=8, codebook_size=2 ** 8)).init_random_(g)
    both("VideoTokenizer", tok, lambda mm, x: mm(x)[:2],
         torch.rand((1, 3, 5, 32, 32), generator=g) * 2 - 1)
    lfq = LFQ(dim=16, codebook_size=2 ** 8, diversity_gamma=2.5).init_random_(g)

    def lfq_fn(mm, x):
        x = x.clone().requires_grad_(True)
        q, _, aux, _ = mm.quantize(x)
        (aux + q.square().sum()).backward()
        return q, aux, x.grad

    xl = torch.randn((2, 100, 16), generator=g) * 0.1
    check("LFQ (2^8 codes) and its gradient", lfq_fn(copy.deepcopy(lfq).cuda(), xl.cuda()),
          lfq_fn(lfq, xl))

    # the losses and their gradients: the reconstruction through a 1x1 head
    nl = NLayerDiscriminator(3, 64, 3).init_random_(g)
    head = torch.nn.Conv2d(8, 3, 1)
    feats = torch.randn((2, 8, 64, 64), generator=g)
    target = torch.rand((2, 3, 64, 64), generator=g) * 2 - 1
    lp_card = copy.deepcopy(lpips_cpu).cuda()

    def image_loss(dev):
        # no LPIPS here: the adaptive weight scales the GAN term's gradient at
        # the head to the nll's, where the two partly cancel, which amplifies
        # the rounding of 13 random VGG layers (LPIPS alone: phase 11)
        d, h = copy.deepcopy(nl).to(dev), copy.deepcopy(head).to(dev)
        f = feats.to(dev).detach().requires_grad_(True)  # a leaf on either device
        loss_obj = LPIPSWithDiscriminator(disc_start=0, disc_weight=0.5, lpips=None)
        total, log_ = loss_obj.generator_loss(d, torch.zeros((), device=dev), target.to(dev),
                                              h(f), {}, 1, adaptive_ctx=(h, f))
        total.backward()
        dl, _ = loss_obj.discriminator_loss(d, target.to(dev), h(f).detach(), 1)
        return total, log_["scalars/d_weight"], f.grad, h.weight.grad, dl

    losses = {"LPIPSWithDiscriminator and gradients": lambda dev: image_loss(dev)}
    recon = torch.rand((2, 3, 4, 32, 32), generator=g) * 2 - 1

    def video_loss(dev, lp):
        d = copy.deepcopy(vdisc).to(dev)
        r = recon.to(dev).detach().requires_grad_(True)
        loss_obj = VideoAutoencoderLoss(disc_start=0, adversarial_loss_weight=0.1,
                                        grad_penalty_loss_weight=10.0, lpips=lp)
        total, _ = loss_obj.generator_loss(d, clip.to(dev), r, 1,
                                           frame_indices=torch.tensor([0, 3], device=dev))
        total.backward()
        dl, _ = loss_obj.discriminator_loss(d, clip.to(dev), recon.to(dev), 1)
        dl.backward()
        return total, r.grad, dl, d.blocks[0].conv1.weight.grad

    losses["VideoAutoencoderLoss and gradients"] = lambda dev: video_loss(
        dev, lp_card if dev == "cuda" else lpips_cpu)
    kinks = {}
    for label, fn in losses.items():
        want, want_x = _with_lrelu_inputs(fn, "cpu")
        # the losses' math on the card with cuDNN off (PyTorch's own CUDA
        # convolutions), then as the trainers run them, on cuDNN
        torch.backends.cudnn.enabled = False
        try:
            check(label + ", cuDNN off", fn("cuda"), want)
        finally:
            torch.backends.cudnn.enabled = True
        got, got_x = _with_lrelu_inputs(fn, "cuda")
        flips = []
        for i, (a, b) in enumerate(zip(got_x, want_x)):
            flip = (a > 0) != (b > 0)
            if flip.any():
                flips.append({"call": i, "elements": int(flip.sum()),
                              "cpu_abs_max": float(b[flip].abs().max()),
                              "near": float(b[flip].abs().max() / b.abs().max())})
        kinks[label] = flips
        if any(f["near"] > KINK_NEAR for f in flips):
            fail(f"trainers (d): {label}: a LeakyReLU input away from 0 changed sign on the "
                 f"card: {flips}")
        check(label, got, want, KINK_GRAD_TOL if flips else TRAINERS_REL_TOL)
    log(f"trainers (d): card vs CPU relative L2 {rel} (tol {TRAINERS_REL_TOL:.0e}); LeakyReLU "
        f"inputs on the other side of 0 on the card (cuDNN on): {kinks}")
    stats["card_vs_cpu_rel_l2"] = rel
    stats["lrelu_sign_flips"] = kinks
    _free_card()


def phase_trainers(ex81):
    """Phase 13: the DiT Trainer's hooks at the 1.3B's full width, and the
    adversarial autoencoder path at its published widths (f32, TF32 off).
    Returns the launches of (a)'s two runs and the phase's record."""
    import torch

    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.evals.lpips import LPIPS

    t_phase = time.perf_counter()
    stats = {"seconds": {}}
    t0 = time.perf_counter()
    fit_counts = _trainers_dit_fit(ex81, stats)
    t1 = time.perf_counter()
    hook_counts = _trainers_dit_hooks(ex81, stats)
    t2 = time.perf_counter()
    with full_f32():
        lpips = LPIPS(device="cuda").init_random_(torch.Generator(device="cuda").manual_seed(12))
        _trainers_vq(stats, lpips)
        t3 = time.perf_counter()
        _trainers_tokenizer(stats, lpips)
        t4 = time.perf_counter()
        lpips_cpu = LPIPS().init_random_(torch.Generator().manual_seed(12))
        _trainers_card_vs_cpu(stats, lpips_cpu)
    stats["seconds"].update(dit_fit=t1 - t0, dit_hooks=t2 - t1, vq=t3 - t2, tokenizer=t4 - t3,
                            card_vs_cpu=time.perf_counter() - t4)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 (trainers): {stats['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stats["seconds"].items()) + ")")
    print(json.dumps({"trainers": stats}), flush=True)
    return fit_counts, hook_counts, stats


# --------------------------------------------------------------------------
# Phase 14: the SVD VideoUNet, the MoE DiT, generation and the decoder zoo
# --------------------------------------------------------------------------
# Stability's generative-models configs/inference/svd.yaml, network_config
SVD_UNET = dict(in_channels=8, out_channels=4, model_channels=320, channel_mult=(1, 2, 4, 4),
                num_res_blocks=2, attention_resolutions=(4, 2, 1), num_head_channels=64,
                transformer_depth=1, context_dim=1024, adm_in_channels=768,
                num_classes="sequential", use_linear_in_transformer=True,
                use_spatial_context=True, extra_ff_mix_layer=True,
                merge_strategy="learned_with_images", video_kernel_size=(3, 1, 1),
                use_checkpoint=False, spatial_transformer_attn_type="softmax-xformers")
SVD_FRAMES = 14
SVD_LATENT = (72, 128)  # 576 x 1024
ZOO_REL_TOL = 1e-4
# the MoE DiT at scail_1p3b.yaml's widths: launches per forward (its MLPs run
# cuBLAS, the attention and norms the same kernels as the dense DiT)
MOE = dict(num_experts=8, moe_top_k=2)
MOE_PLAIN_LAYERS = 4
LLAMA_PROMPT = (2, 128)
LLAMA_NEW = 32
GLM130B_CPU_WIDTH = dict(dim=4096, num_heads=32, inner_hidden_size=10944)
# CogView (Ding et al. 2021, arXiv:2105.13290, sec. 3: 48 layers, hidden
# 2560, 40 heads): the width the cuda2d super-resolution model finetunes
COGVIEW = dict(dim=2560, num_heads=40)


def _param_gb(module):
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 1e9


def _zoo_svd(stats):
    """(a) the SVD VideoUNet at svd.yaml's widths, f32 (TF32 off): one
    forward of 14 frames at 576 x 1024 at CFG batch 2 (28 frames); card
    against CPU on a 16 x 16 latent with 4 frames."""
    import torch

    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.models.video_unet import VideoUNet

    gen = torch.Generator(device="cuda").manual_seed(21)
    t0 = time.perf_counter()
    net = VideoUNet(**SVD_UNET, device="meta").init_random_(gen, zero_modules=False,
                                                            device="cuda")
    build_s = time.perf_counter() - t0
    n = 2 * SVD_FRAMES

    def inputs(frames, hw, dev, g):
        b = frames // (SVD_FRAMES if frames == n else 4)
        r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
        return dict(x=r(frames, 8, *hw), timesteps=torch.rand(frames, generator=g, device=dev),
                    context=r(frames, 1, 1024), y=r(frames, 768),
                    image_only_indicator=torch.zeros(b, frames // b, device=dev),
                    num_video_frames=frames // b)

    inp = inputs(n, SVD_LATENT, "cuda", gen)
    x = inp.pop("x")
    with full_f32(), torch.inference_mode():
        out, s, peak = _timed_on_card(lambda: net(x, **inp))
    if tuple(out.shape) != (n, 4, *SVD_LATENT) or not torch.isfinite(out).all():
        fail(f"zoo (a): VideoUNet output bad {tuple(out.shape)}")
    del out, x, inp
    cpu_gen = torch.Generator().manual_seed(22)
    small = inputs(4, (16, 16), "cpu", cpu_gen)
    cpu = VideoUNet(**SVD_UNET, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()}, assign=True)
    on_card = {k: v.cuda() if torch.is_tensor(v) else v for k, v in small.items()}
    with full_f32(), torch.inference_mode():
        got = net(on_card.pop("x"), **on_card).cpu()
        want = cpu(small.pop("x"), **small)
    rel = _rel_l2(got, want)
    stats["svd"] = {"params_b": sum(p.numel() for p in net.parameters()) / 1e9,
                    "param_gb": _param_gb(net), "build_s": build_s, "forward_ms": s * 1e3,
                    "peak_gb": peak, "card_vs_cpu": rel}
    log(f"zoo (a): SVD VideoUNet ({stats['svd']['params_b']:.3f} B parameters, "
        f"{stats['svd']['param_gb']:.2f} GB f32): forward of {n} frames at "
        f"{SVD_LATENT[0] * 8}x{SVD_LATENT[1] * 8} {s * 1e3:.1f} ms, peak {peak:.2f} GB; card vs "
        f"CPU (4 frames, 16x16 latent) relative L2 {rel:.3e} (tol {ZOO_REL_TOL:.0e})")
    if not rel <= ZOO_REL_TOL:
        fail("zoo (a): the VideoUNet on the card disagrees with the CPU")
    del net, cpu
    _free_card()


def _moe_dit(num_layers=30):
    """The 1.3B DiT with 8 experts, top 2, bf16, drawn one parameter at a
    time on the card."""
    import torch
    import yaml

    from scail_tpu_torch.utils.registry import instantiate_from_config

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        nc = yaml.safe_load(f)["model"]["network_config"]
    nc["params"].update(dtype="bf16", use_i2v_clip=True, num_layers=num_layers, **MOE)
    dit = instantiate_from_config(nc).build("meta")
    dit.init_weights_(torch.Generator(device="cuda").manual_seed(1), device="cuda",
                      dtype=torch.bfloat16)
    return dit.eval()


def _zoo_moe_dit(stats):
    """(b) the MoE DiT: one forward at CFG batch 2, 48,832 tokens, exact
    launches; the kernel path against the plain path at MOE_PLAIN_LAYERS on
    phase 4's small input."""
    import dataclasses

    import torch

    t0 = time.perf_counter()
    dit = _moe_dit()
    build_s = time.perf_counter() - t0
    experts = sum(p.numel() for n, p in dit.named_parameters() if ".moe_" in n)
    param_gb = _param_gb(dit)
    inp = _dit_inputs(torch.Generator(device="cuda").manual_seed(2), 21, 64, 112)
    x, t, ctx = inp.pop("x"), inp.pop("timesteps"), inp.pop("context")
    counts = {}

    def fwd():
        reset_counts()
        out = dit(x, t, ctx, **inp)
        counts.update(launch_counts())
        return out

    with torch.inference_mode():
        out, s, peak = _timed_on_card(fwd)
    _exact(counts, DIT_LAUNCHES, "zoo (b): one MoE DiT forward")
    if tuple(out.shape) != (2, 21, 16, 64, 112) or not torch.isfinite(out).all():
        fail(f"zoo (b): MoE DiT output bad {tuple(out.shape)}")
    del dit, out, x, ctx, inp
    _free_card()
    small = _moe_dit(MOE_PLAIN_LAYERS)
    cfg = small.config
    sinp = _dit_inputs(torch.Generator(device="cuda").manual_seed(3), 3, 16, 16)
    xs, ts, cs = sinp.pop("x"), sinp.pop("timesteps"), sinp.pop("context")
    with torch.inference_mode():
        got = small(xs, ts, cs, **sinp).float()
        small.config = dataclasses.replace(cfg, attn_impl="xla")
        want = small(xs, ts, cs, **sinp).float()
        small.config = cfg
    rel = _rel_l2(got, want)
    stats["moe_dit"] = {"expert_params_b": experts / 1e9, "param_gb": param_gb, "build_s": build_s,
                        "forward_ms": s * 1e3, "peak_gb": peak, "launches": counts,
                        "kernel_vs_plain": rel}
    log(f"zoo (b): MoE DiT (1.3B widths, {MOE['num_experts']} experts top "
        f"{MOE['moe_top_k']}, {experts / 1e9:.3f} B expert parameters): forward at CFG batch 2, "
        f"48,832 tokens {s * 1e3:.1f} ms, peak {peak:.2f} GB, launches "
        f"{ {k: v for k, v in counts.items() if v} }; kernel path vs plain path at "
        f"{MOE_PLAIN_LAYERS} layers, (2, 3, 16, 16, 16): relative L2 {rel:.3e} (tol "
        f"{DIT_REL_TOL})")
    if not rel < DIT_REL_TOL:
        fail("zoo (b): the MoE DiT's kernel path disagrees with its plain path")
    del small, got, want
    _free_card()
    return counts


def _build_lm(cls, cfg, dtype, seed=31):
    import torch

    return cls(cfg, device="meta").init_weights_(torch.Generator(device="cuda").manual_seed(seed),
                                                 device="cuda", dtype=dtype).eval()


def _generate(model, seq, cached, strategy, seed=33):
    """filling_sequence over `model`: through its KV cache (the prompt
    prefilled at the first call, then one token a call) or by full
    recompute; (tokens, ms a new token, peak GB)."""
    import torch

    from scail_tpu_torch.generation import filling_sequence

    state = {"cache": None, "fed": 0}

    def cached_fn(tokens, pos):
        if state["cache"] is None:
            state["cache"] = model.new_cache(tokens.shape[0])
        logits, _ = model(tokens[:, state["fed"]:pos + 1], state["cache"])
        state["fed"] = pos + 1
        return logits[:, -1]

    def full_fn(tokens, pos):
        return model(tokens[:, :pos + 1])[0][:, -1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = filling_sequence(cached_fn if cached else full_fn, seq, strategy,
                               torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_new = int((seq < 0).sum(1).max())
    return out, (time.perf_counter() - t0) * 1e3 / n_new, torch.cuda.max_memory_allocated() / 1e9


def _zoo_llama(stats):
    """(d) generation at Llama-2-7B's widths (LlamaConfig defaults):
    filling_sequence fills LLAMA_NEW tokens after a 2 x 128 prompt.  bf16:
    greedy through the KV cache, greedy by full recompute, top-k 40 / top-p
    0.9 through the cache, timed.  The check that the cached greedy tokens
    equal full recompute's runs at the same widths and depth in f32 (TF32
    off): in bf16 the two paths round differently (other GEMM shapes), and a
    near-tie between the top two logits of a random-weight model then picks
    another token, so the bf16 run only reports where they part."""
    import torch

    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.generation import BaseStrategy
    from scail_tpu_torch.models.zoo.llama import Llama, LlamaConfig

    cfg = LlamaConfig()
    b, s0 = LLAMA_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(32)
    seq = torch.full((b, s0 + LLAMA_NEW), -1, dtype=torch.long, device="cuda")
    seq[:, :s0] = torch.randint(0, cfg.vocab_size, (b, s0), generator=gen, device="cuda")
    greedy, sampled = BaseStrategy(top_k=1), BaseStrategy(top_k=40, top_p=0.9)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        model = _build_lm(Llama, cfg, dtype)
        build_s = time.perf_counter() - t0
        runs = {"greedy_cached": (True, greedy), "greedy_full": (False, greedy)}
        if dtype == torch.bfloat16:
            runs["top_k40_top_p0.9_cached"] = (True, sampled)
        r, toks = {"param_gb": _param_gb(model), "build_s": build_s}, {}
        with full_f32():
            for run, (cached, strategy) in runs.items():
                toks[run], ms, peak = _generate(model, seq, cached, strategy)
                r[run] = {"ms_per_token": ms, "peak_gb": peak}
                t = toks[run]
                if not ((t >= 0) & (t < cfg.vocab_size)).all() or \
                        not torch.equal(t[:, :s0], seq[:, :s0]):
                    fail(f"zoo (d): {run}: a token left unfilled or the prompt changed")
            a, f = toks["greedy_cached"], toks["greedy_full"]
            r["greedy_cached_equals_full"] = bool(torch.equal(a, f))
            diff = (a != f).any(0).nonzero()
            r["first_difference"] = int(diff[0]) if len(diff) else None
            if len(diff):  # the full path's top-2 logit gap where the two part
                pos = r["first_difference"]
                row = int((a[:, pos] != f[:, pos]).nonzero()[0])
                with torch.inference_mode():
                    top2 = model(a[row:row + 1, :pos])[0][0, -1].float().topk(2).values
                r["top2_gap_there"] = float(top2[0] - top2[1])
        rec[name] = r
        log(f"zoo (d): Llama-2-7B widths, {name} ({r['param_gb']:.2f} GB, built in "
            f"{build_s:.1f} s): " + "; ".join(
                f"{k} {v['ms_per_token']:.1f} ms a token, peak {v['peak_gb']:.2f} GB"
                for k, v in r.items() if isinstance(v, dict))
            + f"; greedy cached == full recompute: {r['greedy_cached_equals_full']}"
            + ("" if r["first_difference"] is None else
               f" (first parts at position {r['first_difference']}, where full recompute's "
               f"top two logits are {r['top2_gap_there']:.4f} apart)"))
        del model
        _free_card()
    stats["llama"] = rec
    if not rec["float32"]["greedy_cached_equals_full"]:
        fail("zoo (d): in f32 the cached greedy tokens differ from full recompute's")


def _zoo_cases():
    """(label, module, config class, full-depth kwargs, 2-layer kwargs for
    the card-vs-CPU check, the forward's inputs(b, s, device, gen) -> args)."""
    import torch

    def ids(vocab):
        def make(b, s, dev, g):
            return (torch.randint(0, vocab, (b, s), generator=g, device=dev),)
        return make

    def glm2d(vocab):
        def make(b, s, dev, g):
            pos = torch.arange(s, device=dev).expand(b, s)
            block = torch.zeros_like(pos)
            return (torch.randint(0, vocab, (b, s), generator=g, device=dev),
                    torch.stack([pos, block], 1), torch.tril(torch.ones(b, s, s, device=dev)))
        return make

    def cuda2d(vocab, layout):
        def make(b, s, dev, g):
            s0 = layout[1]
            pos = torch.cat([torch.arange(s0), torch.arange(layout[2] - s0)]).to(dev)
            return (torch.randint(0, vocab, (b, layout[2]), generator=g, device=dev),
                    pos.expand(b, -1), torch.tril(torch.ones(b, s0, s0, device=dev)))
        return make

    return [
        ("Mixtral-8x7B", "mixtral", "MixtralConfig", dict(num_layers=2), dict(num_layers=2),
         ids(32000)),
        ("GLM-4-9B", "glm", "GlmConfig", {}, dict(num_layers=2), ids(151552)),
        ("ChatGLM-6B", "chatglm", "ChatGLMConfig", {}, dict(num_layers=2), glm2d(130528)),
        ("ChatGLM2-6B", "chatglm23", "ChatGLM2Config", {}, dict(num_layers=2), ids(65024)),
        ("GLM-130B", "glm130b", "GLM130BConfig", dict(num_layers=2),
         dict(num_layers=2, **GLM130B_CPU_WIDTH), glm2d(150528)),
        ("GPT-2", "gpt", "GPTConfig", {}, dict(num_layers=2), ids(50257)),
        ("GPT-Neo-1.3B", "gptneo", "GPTNeoConfig", {}, dict(num_layers=2), ids(50257)),
        ("GLM-large", "glmblock", "GLMBlockConfig", {}, dict(num_layers=2), glm2d(30592)),
        ("cuda2d", "cuda2d", "Cuda2dConfig", dict(num_layers=2, **COGVIEW),
         dict(num_layers=2, **COGVIEW), cuda2d(50048, (64, 1088, 5184))),
    ]


ZOO_MODELS = {"mixtral": "Mixtral", "glm": "Glm", "chatglm": "ChatGLM", "chatglm23": "ChatGLM2",
              "glm130b": "GLM130B", "gpt": "GPT", "gptneo": "GPTNeo", "glmblock": "GLMBlock",
              "cuda2d": "Cuda2d"}
ZOO_PROMPT = (1, 128)
ZOO_CPU_PROMPT = (1, 32)


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


def _zoo_lms(stats):
    """(e) one prompt forward of each model in bf16 at its published width
    and the listed depth; then, f32, at 2 layers (GLM-130B at width 4,096),
    the card against the CPU from one state dict."""
    import importlib

    import torch

    from scail_tpu_torch.evals import full_f32

    stats["lms"] = {}
    for label, mod, cfg_name, full_kw, cpu_kw, make in _zoo_cases():
        m = importlib.import_module(f"scail_tpu_torch.models.zoo.{mod}")
        cls, cfg_cls = getattr(m, ZOO_MODELS[mod]), getattr(m, cfg_name)
        cfg = cfg_cls(**full_kw)
        t0 = time.perf_counter()
        model = _build_lm(cls, cfg, torch.bfloat16)
        build_s = time.perf_counter() - t0
        args = make(*ZOO_PROMPT, "cuda", torch.Generator(device="cuda").manual_seed(41))
        with torch.inference_mode():
            out, s, peak = _timed_on_card(lambda: _logits(model(*args)))
        if not torch.isfinite(out).all() or out.shape[-1] != cfg.vocab_size:
            fail(f"zoo (e): {label}: logits not finite or not {cfg.vocab_size} wide")
        rec = {"layers": cfg.num_layers, "params_b": sum(p.numel() for p in model.parameters())
               / 1e9, "param_gb": _param_gb(model), "build_s": build_s, "tokens": out.shape[1],
               "forward_ms": s * 1e3, "peak_gb": peak}
        del model, out, args
        _free_card()
        # card against CPU, f32, 2 layers
        small_cfg = cfg_cls(**cpu_kw)
        card = _build_lm(cls, small_cfg, torch.float32, seed=42)
        cpu = cls(small_cfg, device="meta")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, assign=True)
        cpu_args = make(*ZOO_CPU_PROMPT, "cpu", torch.Generator().manual_seed(43))
        with full_f32(), torch.inference_mode():
            got = _logits(card(*(a.cuda() for a in cpu_args))).cpu()
            want = _logits(cpu(*cpu_args))
        rec["card_vs_cpu"] = _rel_l2(got, want)
        rec["card_vs_cpu_width"] = small_cfg.dim
        stats["lms"][label] = rec
        log(f"zoo (e): {label}: {rec['params_b']:.3f} B parameters at {rec['layers']} layers "
            f"({rec['param_gb']:.2f} GB bf16): forward of {rec['tokens']} tokens "
            f"{rec['forward_ms']:.1f} ms, peak {peak:.2f} GB; card vs CPU (f32, 2 layers, width "
            f"{small_cfg.dim}) relative L2 {rec['card_vs_cpu']:.3e} (tol {ZOO_REL_TOL:.0e})")
        if not rec["card_vs_cpu"] <= ZOO_REL_TOL:
            fail(f"zoo (e): {label} on the card disagrees with the CPU")
        del card, cpu, got, want
        _free_card()


def phase_zoo():
    """Phase 14: (a) the SVD VideoUNet, (b) the MoE DiT, (d) Llama-2-7B
    generation, (e) the decoder zoo; (c), the MoE DiT under expert
    parallelism, runs in phase 10.  Returns the MoE DiT's launches and the
    phase's record."""
    t_phase = time.perf_counter()
    stats = {"seconds": {}}
    steps = (("svd", _zoo_svd), ("moe_dit", _zoo_moe_dit), ("llama", _zoo_llama),
             ("lms", _zoo_lms))
    moe_counts = None
    for name, fn in steps:
        t0 = time.perf_counter()
        r = fn(stats)
        if name == "moe_dit":
            moe_counts = r
        stats["seconds"][name] = time.perf_counter() - t0
        log(f"phase 14 ({name}): {stats['seconds'][name]:.1f} s")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 (zoo): {stats['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stats["seconds"].items()) + ")")
    print(json.dumps({"zoo": stats}, default=str), flush=True)
    return moe_counts, stats


# ---------------------------------------------------------------------------
# phase 15: the encoder zoo, the adapters, the tokenizers
# ---------------------------------------------------------------------------
# published configurations, written out (the card's machine has no
# transformers to read them from): google/t5-v1_1-xl, bert-large-uncased,
# roberta-large, facebook/dpr-*-single-nq-base, google/vit-large-patch16-224,
# CaiT-M48 at 448 (Touvron et al. 2021, arXiv:2103.17239, table 1), EVA-02-L/14
# (Fang et al. 2023, arXiv:2303.11331), THUDM/glm-4v-9b (GLM-4-9B with the
# EVA2-CLIP-E tower), facebook/vit-mae-huge, hustvl/yolos-base
T5_XL = dict(vocab_size=32128, dim=2048, dim_kv=64, num_heads=32, inner_hidden_size=5120,
             num_layers=24, num_decoder_layers=24, num_buckets=32, max_distance=128,
             gated_mlp=True, tie_word_embeddings=False)
BERT_LARGE = dict(vocab_size=30522, dim=1024, num_heads=16, num_layers=24,
                  inner_hidden_size=4096, max_len=512, type_vocab_size=2, eps=1e-12)
ROBERTA_LARGE = dict(BERT_LARGE, vocab_size=50265, max_len=514, type_vocab_size=1, eps=1e-5,
                     position_style="roberta", pad_token_id=1)
BERT_BASE = dict(vocab_size=30522, dim=768, num_heads=12, num_layers=12, inner_hidden_size=3072,
                 max_len=512, type_vocab_size=2, eps=1e-12)
VIT_L16 = dict(image_size=224, patch_size=16, dim=1024, num_heads=16, num_layers=24,
               inner_hidden_size=4096, num_classes=1000, eps=1e-12)
CAIT_M48 = dict(image_size=448, patch_size=16, dim=768, num_heads=16, num_layers=48,
                dec_num_layers=2, inner_hidden_size=3072, num_classes=1000, eps=1e-6)
EVA02_L = dict(image_size=224, patch_size=14, dim=1024, num_heads=16, num_layers=24,
               inner_hidden_size=2730, predict_feature_dim=1024, eps=1e-6)
EVA2_CLIP_E = dict(image_size=1120, patch_size=14, dim=1792, num_heads=16, num_layers=63,
                   inner_hidden_size=15360, eps=1e-6)
GLM4V_ADAPTER = dict(proj_hidden_size=4096, adapter_inner=13696)
MAE_H14 = dict(image_size=224, patch_size=14, dim=1280, num_heads=16, num_layers=32,
               inner_hidden_size=5120, decoder_dim=512, decoder_num_heads=16,
               decoder_num_layers=8, decoder_inner_hidden_size=2048, mask_ratio=0.75, eps=1e-12)
YOLOS_B = dict(image_size=(512, 864), patch_size=16, dim=768, num_heads=12, num_layers=12,
               inner_hidden_size=3072, num_detection_tokens=100, num_labels=91,
               use_mid_position_embeddings=True, eps=1e-12)
T5_ENC = (2, 512)
T5_NEW = 32
BERT_INPUT = (8, 512)
GLM4V_TEXT = 128
# the image tokenizer's codes, card against CPU: near-ties between two codes
# may resolve either way under the devices' rounding
CODE_AGREEMENT = 0.999


def _cpu_twin(card_model, cls, cfg):
    """cls(cfg) on the CPU holding the card model's state dict."""
    import torch

    cpu = cls(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()}, assign=True)
    return cpu.to(torch.float32)


def _against_cpu(label, cls, cfg, run, make_inputs, stats, seed):
    """`cls(cfg)` from a seed on the card in f32 (TF32 off) and its CPU twin
    from one state dict, each through run(model, *inputs) on
    make_inputs(device, generator); the relative L2 of every output against
    the CPU's must stay <= ZOO_REL_TOL.  Returns the largest."""
    import torch

    from scail_tpu_torch.evals import full_f32

    card = _build_lm(cls, cfg, torch.float32, seed=seed)
    cpu = _cpu_twin(card, cls, cfg)
    inputs = make_inputs("cpu", torch.Generator().manual_seed(seed + 1))
    with full_f32(), torch.inference_mode():
        got = run(card, *(a.cuda() if torch.is_tensor(a) else a for a in inputs))
        want = run(cpu, *inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = max(_rel_l2(g.cpu(), w) for g, w in zip(got, want))
    stats["card_vs_cpu"] = rel
    log(f"encoders: {label}: card vs CPU (f32, 2 layers) relative L2 {rel:.3e} (tol "
        f"{ZOO_REL_TOL:.0e})")
    if not rel <= ZOO_REL_TOL:
        fail(f"encoders: {label} on the card disagrees with the CPU ({rel:.3e})")
    del card, cpu
    _free_card()
    return rel


def _on_card(label, cls, cfg, run, args, check, stats, seed=51):
    """`cls(cfg)` in bf16 from a seed, one parameter at a time on the card;
    run(model, *args) timed (a warm-up, then one call); check(out) -> None
    or what is wrong.  Fills stats and returns the output."""
    import torch

    t0 = time.perf_counter()
    model = _build_lm(cls, cfg, torch.bfloat16, seed=seed)
    build_s = time.perf_counter() - t0
    with torch.inference_mode():
        out, s, peak = _timed_on_card(lambda: run(model, *args))
    outs = out if isinstance(out, tuple) else (out,)
    bad = check(out) or next((f"output {i} not finite" for i, o in enumerate(outs)
                              if torch.is_tensor(o) and o.is_floating_point()
                              and not torch.isfinite(o).all()), None)
    stats.update(params_b=sum(p.numel() for p in model.parameters()) / 1e9,
                 param_gb=_param_gb(model), build_s=build_s, forward_ms=s * 1e3, peak_gb=peak,
                 shapes=[tuple(o.shape) for o in outs if torch.is_tensor(o)])
    log(f"encoders: {label}: {stats['params_b']:.3f} B parameters ({stats['param_gb']:.2f} GB "
        f"bf16, built in {build_s:.1f} s): {s * 1e3:.1f} ms, peak {peak:.2f} GB, outputs "
        f"{stats['shapes']}")
    if bad:
        fail(f"encoders: {label}: {bad}")
    return model, out


def _shape_check(*want):
    def check(out):
        outs = out if isinstance(out, tuple) else (out,)
        got = [tuple(o.shape) for o in outs[:len(want)]]
        return None if got == list(want) else f"output shapes {got}, not {list(want)}"
    return check


def _images(b, h, w, dev, g):
    import torch

    return torch.randn(b, 3, h, w, generator=g, device=dev)


def _enc_t5(stats):
    """T5 v1.1 XL: encode 2 x 512 tokens (bf16, timed), 32 greedy tokens
    through the cache (timed); in f32 at full depth the cached greedy tokens
    equal full recompute's; at 2 + 2 layers card against CPU."""
    import dataclasses

    import torch

    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.models.zoo.t5 import T5, T5Config, t5_greedy_decode

    cfg = T5Config(**T5_XL)
    g = torch.Generator(device="cuda").manual_seed(52)
    ids = torch.randint(0, cfg.vocab_size, T5_ENC, generator=g, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, T5_ENC[1] // 2:] = 0
    rec = stats.setdefault("t5_xl", {})
    model, _ = _on_card("T5 v1.1 XL encode", T5, cfg, lambda m, i, k: m.encode(i, k), (ids, mask),
                        _shape_check((*T5_ENC, cfg.dim)), rec)
    with torch.inference_mode():
        toks, s, peak = _timed_on_card(lambda: t5_greedy_decode(model, ids, mask, T5_NEW))
    rec.update(greedy_ms_per_token=s * 1e3 / T5_NEW, greedy_peak_gb=peak)
    if tuple(toks.shape) != (T5_ENC[0], T5_NEW):
        fail(f"encoders: T5 greedy decode gave {tuple(toks.shape)}")
    del model
    _free_card()
    model = _build_lm(T5, cfg, torch.float32, seed=53)

    def full_recompute():
        enc = model.encode(ids, mask)
        dec = torch.zeros(T5_ENC[0], 1, dtype=torch.long, device="cuda")
        for _ in range(T5_NEW):
            nxt = model.decode(dec, enc, mask)[:, -1].argmax(-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
        return dec[:, 1:]

    with full_f32(), torch.inference_mode():
        cached = t5_greedy_decode(model, ids, mask, T5_NEW)
        full = full_recompute()
    rec["greedy_cached_equals_full_f32"] = bool(torch.equal(cached, full))
    log(f"encoders: T5 v1.1 XL greedy {rec['greedy_ms_per_token']:.1f} ms a token (bf16, peak "
        f"{peak:.2f} GB); in f32 at {cfg.num_layers} + {cfg.num_decoder_layers} layers cached == "
        f"full recompute: "
        f"{rec['greedy_cached_equals_full_f32']}")
    if not rec["greedy_cached_equals_full_f32"]:
        fail("encoders: T5's cached greedy tokens differ from full recompute's in f32")
    del model
    _free_card()
    small = dataclasses.replace(cfg, num_layers=2, num_decoder_layers=2)

    def inputs(dev, gen):
        i = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen).to(dev)
        m = torch.ones_like(i)
        m[1, 11:] = 0
        return i, m, torch.randint(0, cfg.vocab_size, (2, 8), generator=gen).to(dev)

    _against_cpu("T5 v1.1 XL", T5, small, lambda m, i, k, d: m(i, k, d), inputs, rec, 54)


def _padded(vocab, pad_id, b, s, dev, g):
    import torch

    ids = torch.randint(2, vocab, (b, s), generator=g, device=dev)
    mask = torch.ones_like(ids)
    lengths = torch.linspace(s // 4, s, b, device=dev).long()
    mask[torch.arange(s, device=dev)[None] >= lengths[:, None]] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def _enc_bert(stats):
    """BERT-large and RoBERTa-large: 8 x 512 tokens with padding in the mask."""
    import dataclasses

    import torch

    from scail_tpu_torch.models.zoo.bert import Bert, BertConfig

    for label, kw in (("bert_large", BERT_LARGE), ("roberta_large", ROBERTA_LARGE)):
        cfg = BertConfig(**kw)
        g = torch.Generator(device="cuda").manual_seed(55)
        args = _padded(cfg.vocab_size, cfg.pad_token_id, *BERT_INPUT, "cuda", g)
        rec = stats.setdefault(label, {})
        model, _ = _on_card(label, Bert, cfg, lambda m, i, k: m(i, k), args,
                            _shape_check((*BERT_INPUT, cfg.dim), (BERT_INPUT[0], cfg.dim)), rec)
        del model
        _free_card()
        _against_cpu(label, Bert, dataclasses.replace(cfg, num_layers=2),
                     lambda m, i, k: m(i, k),
                     lambda dev, gen: _padded(cfg.vocab_size, cfg.pad_token_id, 2, 32, dev, gen),
                     rec, 56)


DPR_QUESTION = "[CLS] who wrote on the origin of species by means of natural selection ? [SEP]"
DPR_WORDS = ("who wrote on the origin of species by means natural selection darwin charles "
             "book published in 1859 evolution ?").split()


def _dpr_vocab():
    """A vocab.txt of bert-base-uncased's size: the special tokens, the
    question's words, [unused] fillers."""
    path = os.path.join(WORK, "dpr_vocab.txt")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + DPR_WORDS
    words += [f"[unused{i}]" for i in range(BERT_BASE["vocab_size"] - len(words))]
    os.makedirs(WORK, exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return path


def _enc_dpr(stats):
    """The three DPR towers (BERT-base, projection 0): the question through
    BertWordPieceTokenizer to ids and the question encoder, 16 x 256
    passages through the context encoder, one reader pass over 4 x 256."""
    import dataclasses

    import torch

    from scail_tpu_torch.models.zoo.bert import BertConfig
    from scail_tpu_torch.models.zoo.dpr import DPRConfig, DPREncoder, DPRReader
    from scail_tpu_torch.tokenization import BertWordPieceTokenizer

    tok = BertWordPieceTokenizer(_dpr_vocab(), tokenizer_model_type="bert-base-uncased")
    q = tok.EncodeAsIds(DPR_QUESTION).tokenization
    unk = tok.get_command("unk").Id
    if unk in q or q[0] != tok.get_command("ENC").Id or q[-1] != tok.get_command("sep").Id:
        fail(f"encoders: DPR question tokenized to {q}")
    cfg = DPRConfig(BertConfig(**BERT_BASE), 0)
    g = torch.Generator(device="cuda").manual_seed(57)
    qids = torch.tensor([q], device="cuda")
    d = cfg.bert.dim
    runs = (("dpr_question", DPREncoder, (qids, torch.ones_like(qids)), ((1, d),)),
            ("dpr_context", DPREncoder, _padded(cfg.bert.vocab_size, 0, 16, 256, "cuda", g),
             ((16, d),)),
            ("dpr_reader", DPRReader, _padded(cfg.bert.vocab_size, 0, 4, 256, "cuda", g),
             ((4, 256), (4, 256), (4,))))
    for label, cls, args, shapes in runs:
        rec = stats.setdefault(label, {})
        model, _ = _on_card(label, cls, cfg, lambda m, i, k: m(i, k), args,
                            _shape_check(*shapes), rec)
        del model
        _free_card()
        small = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert, num_layers=2))
        _against_cpu(label, cls, small, lambda m, i, k: m(i, k),
                     lambda dev, gen: _padded(cfg.bert.vocab_size, 0, 2, 32, dev, gen), rec, 58)
    stats["dpr_question"]["question_tokens"] = len(q)


def _enc_vision(stats):
    """ViT-L/16, CaiT-M48 at 448, EVA-02-L/14 (half the patches masked) and
    YOLOS-B at 800 x 1,344 (its position tables resized from the 512 x 864
    grid); each at 2 layers against the CPU on one image."""
    import dataclasses

    import torch

    from scail_tpu_torch.models.zoo.cait import CaiT, CaiTConfig
    from scail_tpu_torch.models.zoo.eva2 import EVA2, EVA2Config
    from scail_tpu_torch.models.zoo.vit import ViT, ViTConfig
    from scail_tpu_torch.models.zoo.yolos import Yolos, YolosConfig

    def eva_inputs(b, dev, g):
        n = (224 // 14) ** 2
        masked = torch.rand(b, n, generator=g, device=dev).argsort(1) < n // 2
        return _images(b, 224, 224, dev, g), masked

    cases = (
        ("vit_l16", ViT, ViTConfig(**VIT_L16), lambda m, x: m(x),
         lambda dev, g: (_images(32, 224, 224, dev, g),), ((32, 1000),),
         lambda dev, g: (_images(1, 224, 224, dev, g),)),
        ("cait_m48", CaiT, CaiTConfig(**CAIT_M48), lambda m, x: m(x),
         lambda dev, g: (_images(4, 448, 448, dev, g),), ((4, 1000),),
         lambda dev, g: (_images(1, 448, 448, dev, g),)),
        ("eva02_l", EVA2, EVA2Config(**EVA02_L), lambda m, x, k: m(x, k),
         lambda dev, g: eva_inputs(16, dev, g), ((16, 256, 1024),),
         lambda dev, g: eva_inputs(1, dev, g)),
        ("yolos_b", Yolos, YolosConfig(**YOLOS_B), lambda m, x: m(x),
         lambda dev, g: (_images(2, 800, 1344, dev, g),), ((2, 100, 92), (2, 100, 4)),
         lambda dev, g: (_images(1, 256, 432, dev, g),)),
    )
    for label, cls, cfg, run, make, shapes, small_make in cases:
        rec = stats.setdefault(label, {})
        args = make("cuda", torch.Generator(device="cuda").manual_seed(59))
        model, _ = _on_card(label, cls, cfg, run, args, _shape_check(*shapes), rec)
        del model, args
        _free_card()
        _against_cpu(label, cls, dataclasses.replace(cfg, num_layers=2), run,
                     small_make, rec, 60)
    stats["yolos_b"]["patch_tokens"] = (800 // 16) * (1344 // 16)


def _enc_glm4v(stats):
    """GLM-4V-9B: GLM-4-9B with the EVA2-CLIP-E tower at 1,120²: one image
    (1,602 image rows) spliced into 128 text tokens; at 2 + 2 layers and a
    224² image card against CPU."""
    import dataclasses

    import torch

    from scail_tpu_torch.models.zoo.evaclip import EVACLIPConfig
    from scail_tpu_torch.models.zoo.glm import GlmConfig
    from scail_tpu_torch.models.zoo.glm4v import GLM4V, GLM4VConfig

    cfg = GLM4VConfig(glm=GlmConfig(), vit=EVACLIPConfig(**EVA2_CLIP_E), **GLM4V_ADAPTER)

    def inputs(c, text, dev, g):
        n = c.image_length
        s = text + n
        toks = torch.randint(0, c.glm.vocab_size, (1, s), generator=g, device=dev)
        mask = torch.zeros(1, s, dtype=torch.bool, device=dev)
        mask[0, text // 2:text // 2 + n] = True
        return toks, _images(1, c.vit.image_size, c.vit.image_size, dev, g), mask

    rec = stats.setdefault("glm4v_9b", {})
    args = inputs(cfg, GLM4V_TEXT, "cuda", torch.Generator(device="cuda").manual_seed(61))
    run = lambda m, t, x, k: m(t, x, k)[0]  # noqa: E731
    model, _ = _on_card("GLM-4V-9B", GLM4V, cfg, run, args,
                        _shape_check((1, GLM4V_TEXT + cfg.image_length, cfg.glm.vocab_size)), rec)
    rec["image_rows"] = cfg.image_length
    del model, args
    _free_card()
    small = dataclasses.replace(cfg, glm=dataclasses.replace(cfg.glm, num_layers=2),
                                vit=dataclasses.replace(cfg.vit, num_layers=2, image_size=224))
    _against_cpu("GLM-4V-9B", GLM4V, small, run, lambda dev, g: inputs(small, 16, dev, g), rec, 62)


def _enc_mae(stats):
    """MAE ViT-H/14: forward, mae_loss(norm_pix=True) and backward at batch
    16, 224² (bf16, timed); at 2 + 2 layers in f32 the loss and every
    parameter gradient card against CPU."""
    import dataclasses

    import torch

    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.models.zoo.mae import MAE, MAEConfig, mae_loss

    cfg = MAEConfig(**MAE_H14)
    g = torch.Generator(device="cuda").manual_seed(63)
    x, noise = _images(16, 224, 224, "cuda", g), torch.rand(16, cfg.num_patches, generator=g,
                                                            device="cuda")
    rec = stats.setdefault("mae_h14", {})

    def step(m, x, noise):
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = mae_loss(m, x, noise, norm_pix=True)
            loss.backward()
        return loss.detach()

    t0 = time.perf_counter()
    model = _build_lm(MAE, cfg, torch.bfloat16, seed=64).requires_grad_(True)
    build_s = time.perf_counter() - t0
    loss, s, peak = _timed_on_card(lambda: step(model, x, noise))
    grads_ok = all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    rec.update(params_b=sum(p.numel() for p in model.parameters()) / 1e9,
               param_gb=_param_gb(model), build_s=build_s, step_ms=s * 1e3, peak_gb=peak,
               loss=float(loss))
    log(f"encoders: MAE ViT-H/14: {rec['params_b']:.3f} B parameters: forward + loss + backward "
        f"at batch 16 {s * 1e3:.1f} ms, peak {peak:.2f} GB, loss {float(loss):.4f}")
    if not (torch.isfinite(loss) and grads_ok):
        fail("encoders: MAE's loss or gradients are not finite")
    del model
    _free_card()
    small = dataclasses.replace(cfg, num_layers=2, decoder_num_layers=2)
    card = _build_lm(MAE, small, torch.float32, seed=65).requires_grad_(True)
    cpu = _cpu_twin(card, MAE, small).requires_grad_(True)
    cg = torch.Generator().manual_seed(66)
    xs, ns = _images(1, 224, 224, "cpu", cg), torch.rand(1, cfg.num_patches, generator=cg)
    with full_f32():
        got = step(card, xs.cuda(), ns.cuda())
    want = step(cpu, xs, ns)
    gc_, gw = (torch.cat([p.grad.flatten().cpu() for p in m.parameters()]) for m in (card, cpu))
    rec["card_vs_cpu"] = max(_rel_l2(got.cpu()[None], want[None]), _rel_l2(gc_, gw))
    log(f"encoders: MAE ViT-H/14: card vs CPU (f32, 2 + 2 layers) loss and gradients "
        f"relative L2 {rec['card_vs_cpu']:.3e} (tol {ZOO_REL_TOL:.0e})")
    if not rec["card_vs_cpu"] <= ZOO_REL_TOL:
        fail("encoders: MAE's loss or gradients on the card disagree with the CPU")
    del card, cpu
    _free_card()


def _enc_image_tokenizer(stats):
    """ImageTokenizer over the VQGAN f16-1024 (phase 13's), f32: 4 images
    at 256² encoded and decoded on the card; one image on the card and the
    CPU from one state dict: the codes agree at >= CODE_AGREEMENT of the
    positions, the decode of the CPU's codes within ZOO_REL_TOL."""
    import torch

    from scail_tpu_torch.autoencoding.vqgan import VQModel
    from scail_tpu_torch.evals import full_f32
    from scail_tpu_torch.tokenization import ImageTokenizer

    g = torch.Generator(device="cuda").manual_seed(67)
    model = VQModel(**VQGAN_F16_1024, device="cuda").init_random_(g).eval()
    tok = ImageTokenizer(model)
    imgs = torch.rand(4, 256, 256, 3, generator=g, device="cuda")
    with full_f32():
        ids, s_enc, peak = _timed_on_card(lambda: tok.EncodeAsIds(imgs, add_normalization=True))
        rec_imgs, s_dec, _ = _timed_on_card(lambda: tok.DecodeIds(ids, (4, 16, 16)))
    if tuple(ids.shape) != (4, 256) or tuple(rec_imgs.shape) != (4, 256, 256, 3) or \
            not torch.isfinite(rec_imgs).all():
        fail(f"encoders: image tokenizer gave {tuple(ids.shape)} / {tuple(rec_imgs.shape)}")
    cpu_model = VQModel(**VQGAN_F16_1024, device="cpu").eval()
    cpu_tok = ImageTokenizer(cpu_model, {k: v.cpu() for k, v in model.state_dict().items()})
    one = imgs[:1].cpu()
    with full_f32():
        card_ids = tok.EncodeAsIds(one, add_normalization=True).cpu()
        cpu_ids = cpu_tok.EncodeAsIds(one, add_normalization=True)
        card_dec = tok.DecodeIds(cpu_ids, (1, 16, 16)).cpu()
    cpu_dec = cpu_tok.DecodeIds(cpu_ids, (1, 16, 16))
    agree = float((card_ids == cpu_ids).float().mean())
    rel = _rel_l2(card_dec, cpu_dec)
    stats["image_tokenizer"] = {"encode_ms": s_enc * 1e3, "decode_ms": s_dec * 1e3,
                                "peak_gb": peak, "code_agreement": agree, "card_vs_cpu": rel}
    log(f"encoders: image tokenizer (VQGAN f16-1024, f32): encode 4 x 256² {s_enc * 1e3:.1f} ms, "
        f"decode {s_dec * 1e3:.1f} ms; card vs CPU: codes agree at {agree:.4f} of positions "
        f"(at least {CODE_AGREEMENT}), decode relative L2 {rel:.3e} (tol {ZOO_REL_TOL:.0e})")
    if agree < CODE_AGREEMENT or not rel <= ZOO_REL_TOL:
        fail("encoders: the image tokenizer on the card disagrees with the CPU")
    del model, tok
    _free_card()


def _enc_adapters(stats):
    """GPT-2 with adapters (hidden 64): one AdamW step of
    adapters_only_optimizer on 4 x 128 tokens; every base tensor bit-equal
    afterwards, every adapter tensor moved."""
    import torch
    import torch.nn.functional as F

    from scail_tpu_torch.models.common import container
    from scail_tpu_torch.models.zoo.gpt import GPT, GPTConfig
    from scail_tpu_torch.training.adapters import adapters_only_optimizer, init_adapter_params

    cfg = GPTConfig()
    g = torch.Generator(device="cuda").manual_seed(68)
    base = _build_lm(GPT, cfg, torch.float32, seed=69)
    holder = container(base=base, adapters=init_adapter_params(g, cfg.num_layers, cfg.dim, 64))
    before = {k: v.detach().clone() for k, v in holder.state_dict().items()}
    opt = adapters_only_optimizer(lambda ps: torch.optim.AdamW(ps, lr=1e-3),
                                  holder.named_parameters())
    toks = torch.randint(0, cfg.vocab_size, (4, 129), generator=g, device="cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        logits = base(toks[:, :-1], adapters=holder.adapters)[0]
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    after = holder.state_dict()
    frozen = [k for k in before if k.startswith("base.")]
    changed = [k for k in frozen if not torch.equal(before[k], after[k])]
    still = [k for k in before if k.startswith("adapters.") and torch.equal(before[k], after[k])]
    stats["adapters"] = {"step_ms": s * 1e3, "loss": float(loss), "base_tensors": len(frozen),
                         "base_bit_equal": not changed, "adapter_tensors_unmoved": len(still)}
    log(f"encoders: GPT-2 + adapters: one adapters-only AdamW step {s * 1e3:.1f} ms, loss "
        f"{float(loss):.4f}; {len(frozen)} base tensors bit-equal afterwards: {not changed}; "
        f"adapter tensors unmoved: {len(still)}")
    if changed or still or not torch.isfinite(loss):
        fail(f"encoders: adapters-only step moved the base ({changed[:3]}) or left adapters "
             f"({still[:3]})")
    del base, holder, opt
    _free_card()


def phase_encoders():
    """Phase 15: the encoder zoo at published widths (bf16, random weights
    from seeds), each also in f32 at 2 layers against the CPU; T5's cached
    greedy decoding; MAE's training step; the image tokenizer; an
    adapters-only step.  Returns the phase's record."""
    t_phase = time.perf_counter()
    stats = {"seconds": {}}
    steps = (("t5", _enc_t5), ("bert", _enc_bert), ("dpr", _enc_dpr), ("vision", _enc_vision),
             ("glm4v", _enc_glm4v), ("mae", _enc_mae), ("image_tokenizer", _enc_image_tokenizer),
             ("adapters", _enc_adapters))
    for name, fn in steps:
        t0 = time.perf_counter()
        fn(stats)
        stats["seconds"][name] = time.perf_counter() - t0
        log(f"phase 15 ({name}): {stats['seconds'][name]:.1f} s")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 (encoders): {stats['phase_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stats["seconds"].items()) + ")")
    print(json.dumps({"encoders": stats}, default=str), flush=True)
    return stats


# seconds of each phase of this run, in order
PHASE_S = {}


def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    return out


def main():
    if not os.path.isdir(os.path.join(ROOT, "scail_tpu_torch")):
        fail("scail_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    t_start = time.perf_counter()
    card = _phase("device", phase_device)
    build_s = _phase("build", phase_build)
    kernels = _phase("kernels", phase_kernels)
    dit_ms = _phase("dit", phase_dit)
    sta_dit_ms = _phase("dit_sta", phase_dit_sta)
    sample_counts, records = _phase("cli", phase_cli)
    ex81 = os.path.join(WORK, "synthetic_081")
    sta_sample_counts, sta_record = _phase("cli_sta", phase_cli_sta, ex81)
    long_counts, long_rec = _phase("cli_long", phase_cli_long)
    train_counts, train = _phase("train", phase_train, ex81)
    sta_train_counts, sta_train = _phase("train_sta", phase_train_sta, ex81)
    remat_counts, remat = _phase("train_remat", phase_train_remat, ex81)
    lora_counts, lora = _phase("train_lora", phase_train_lora, ex81)
    w8_counts, w8 = _phase("dit14b_w8", phase_dit14b_w8)
    w4_counts, w4 = _phase("e2e_14b_w4", phase_e2e_14b_w4)
    int8_counts, int8 = _phase("cli_14b_int8", phase_cli_14b_int8, ex81)
    load_counts, load = _phase("load", phase_load, ex81)
    parallel_counts, par = _phase("parallel", phase_parallel, ex81)
    eval_counts, ev = _phase("evals", phase_evals, records[1]["outputs"][0],
                             sta_record["outputs"][0])
    zoo_counts, pd_counts, image = _phase("image", phase_image)
    fit_counts, hook_counts, trainers = _phase("trainers", phase_trainers, ex81)
    moe_counts, zoo = _phase("zoo", phase_zoo)
    encoders = _phase("encoders", phase_encoders)
    _no_jax_loaded("the whole run")

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
        f"{ev['phase_s']:.1f} s (the STA gate {ev['validate_weights']['seconds']:.1f} s); image "
        f"phase {image['phase_s']:.1f} s (SDXL UNet forward at CFG batch 2 "
        f"{image['unet_ms_cfg2']:.1f} ms, decode {image['vae_decode_ms']:.1f} ms); trainers "
        f"phase {trainers['phase_s']:.1f} s; zoo phase {zoo['phase_s']:.1f} s (SVD UNet forward "
        f"{zoo['svd']['forward_ms']:.1f} ms, MoE DiT forward {zoo['moe_dit']['forward_ms']:.1f} ms, "
        f"Llama-2-7B {zoo['llama']['bfloat16']['greedy_cached']['ms_per_token']:.1f} ms a "
        f"token); encoders phase {encoders['phase_s']:.1f} s (GLM-4V-9B forward "
        f"{encoders['glm4v_9b']['forward_ms']:.1f} ms, T5 XL greedy "
        f"{encoders['t5_xl']['greedy_ms_per_token']:.1f} ms a token); phases (s) "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items())
        + f"; whole run {time.perf_counter() - t_start:.0f} s; card {card}")
    print(json.dumps({"phase_seconds": PHASE_S}), flush=True)

    paths = {"sample_cli": sample_counts, "train_cli": train_counts,
             "sample_cli_sta": sta_sample_counts, "train_cli_sta": sta_train_counts,
             "dit14b_w8": w8_counts, "e2e_14b_w4": w4_counts, "sample_cli_14b_int8": int8_counts,
             "sample_cli_long": long_counts, "sample_cli_load": load_counts,
             **remat_counts, "train_cli_lora": lora_counts, "parallel_2ranks": parallel_counts,
             "validate_weights": eval_counts, "dit_zoo_dpmpp2m": zoo_counts,
             "pd_step": pd_counts, "trainer_fit_evals": fit_counts,
             "trainer_hooks_4layers": hook_counts, "dit_moe": moe_counts}

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
