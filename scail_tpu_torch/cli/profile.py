"""Where the time of one request, and of one training step, goes on one
NVIDIA GPU.

Builds the engine from the 1.3B YAMLs with random weights (as the sampling
CLI does without a checkpoint) and profiles, each after one warm-up call:

  * dit        -- one DiT forward at CFG batch 2, 512x896, 81 frames (48,832
                  tokens): the denoise step of the sampling loop;
  * dit_sta    -- the same with attn_impl='sta' (sliding-tile attention at the
                  JAX package's defaults: tile (3, 8), window (3, 2));
  * vae_encode -- the streamed encode of 81 frames at 512x896;
  * pose_encode -- the streamed encode of the 2x2-downsampled pose video;
  * vae_decode -- the streamed decode of 21 latent frames to 81 frames;
  * train_step -- one Trainer step of the train CLI at batch 1, 512x896, 81
                  frames: the VAE encodes, CLIP, the remat DiT forward and
                  backward (f32 parameters, bf16 compute) and the clipped
                  EMA-Adam update;
  * train_step_sta -- the same step with attn_impl='sta';
  * train_step_save_attn -- the dense step under remat_policy='save_attn'
                  (each layer's flash outputs kept across the recompute);
  * train_step_lora -- the dense step fine-tuning LoRA factors of rank 16
                  on the layer linears, the base frozen (training/lora.py);
  * dit14b_w4  -- one 14B DiT forward (hidden 5120, 40 layers) at CFG batch 2,
                  48,832 tokens, with random W4A16 layer linears
                  (bench_14b_quant.build_random_quant_params);
  * dit14b_int8 -- one bf16 14B DiT forward at CFG batch 2 with
                  attn_impl='pallas_int8' (int8-QK flash attention).
The two 14B phases run first, each with its own model, before the 1.3B
engine is built.

Per phase: wall ms, device ms (the sum of kernel and memcpy/memset times that
torch.profiler reads from CUPTI), device busy share (device ms / wall ms, one
stream), peak allocated memory, the card's SM clock and board power that
nvidia-smi samples every 100 ms during the profiled call, and device ms by
group (each attention kernel: K1 flash_attention, K2 flash_attention_norope,
K5 flash_attention_bwd, K3 dual_cross_attention, K7 sta_attention, K8
sta_attention_bwd, K4 w8a16_matmul (W8A16 and W4A16), K6
flash_attention_int8, K9 adaln_layer_norm, K10 rotary; GEMMs, convolutions,
copies, the rest).
Prints one JSON line per phase and writes each phase's kernel table under
--out.

  python -m scail_tpu_torch.cli.profile [--out build/profile] [--phases dit ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("dit", "dit_sta", "vae_encode", "pose_encode", "vae_decode", "train_step",
          "train_step_sta", "train_step_save_attn", "train_step_lora", "dit14b_w4",
          "dit14b_int8")
TRAIN_CONFIGS = {"train_step": {}, "train_step_sta": {"attn_impl": "sta"},
                 "train_step_save_attn": {"remat_policy": "save_attn"}}
LORA_RANK = 16
# kernel-name substrings by group, first match wins
# (K1 keeps the name `flash_attention` it had before K2 was on a path)
GROUPS = (("w8a16_matmul", ("w8a16_kernel",)),
          ("flash_attention_int8", ("flash_int8_kernel",)),
          ("flash_attention_norope", ("flash_fwd_kernel<0>",)),
          ("flash_attention", ("flash_fwd_kernel",)),
          ("flash_attention_bwd", ("flash_bwd_",)),
          ("sta_attention", ("sta_fwd_kernel",)),
          ("sta_attention_bwd", ("sta_bwd_",)),
          ("dual_cross_attention", ("dual_cross_kernel",)),
          ("adaln_layer_norm", ("adaln_ln_kernel",)),
          ("rotary", ("rotary_kernel",)),
          ("conv", ("fprop", "dgrad", "wgrad", "conv", "winograd")),
          ("gemm", ("gemm", "nvjet", "cutlass")),
          ("copy", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")))


# the card's SM clock (MHz) and board power (W), one line every 100 ms
SMI_SAMPLES = ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
               "--format=csv,noheader,nounits", "-lms", "100"]


def _clock_stats(lines):
    """Mean and least SM clock and mean and largest board power of nvidia-smi's
    `clocks.sm, power.draw` lines (unreadable lines skipped); None if none."""
    samples = []
    for line in lines:
        try:
            clock, power = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((clock, power))
    if not samples:
        return None
    clocks, power = zip(*samples)
    return {"samples": len(samples), "sm_clock_mhz_mean": sum(clocks) / len(clocks),
            "sm_clock_mhz_min": min(clocks), "power_w_mean": sum(power) / len(power),
            "power_w_max": max(power)}


def _device_field(event) -> str:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return name
    raise RuntimeError("this torch.profiler has no device time field")


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_phase(name, fn, out_dir):
    """Warm-up, then one profiled call of fn(); returns the phase's record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smi = subprocess.Popen(SMI_SAMPLES, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        smi.terminate()
    clocks = _clock_stats(smi.communicate(timeout=30)[0].splitlines())
    events = prof.key_averages()
    field = _device_field(events[0])
    groups = {}
    device_ms = 0.0
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(ev, field) / 1e3
        device_ms += ms
        groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + ms
    if device_ms == 0.0:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    with open(os.path.join(out_dir, f"{name}_kernels.txt"), "w") as f:
        f.write(events.table(sort_by=field, row_limit=40))
    return {"phase": name, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "clocks": clocks,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def main(argv=None):
    p = argparse.ArgumentParser("scail_tpu_torch.cli.profile")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "profile"),
                   help="directory for the per-phase kernel tables")
    p.add_argument("--phases", nargs="+", default=list(PHASES), choices=PHASES)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(a.out, exist_ok=True)
    card = torch.cuda.get_device_name(0)
    for name in (n for n in ("dit14b_w4", "dit14b_int8") if n in a.phases):
        with torch.inference_mode():
            rec = profile_phase(name, _dit14b_call(name), a.out)
        print(json.dumps(dict(rec, device=card)), flush=True)
        torch.cuda.empty_cache()
    if not set(a.phases) - {"dit14b_w4", "dit14b_int8"}:
        return

    from scail_tpu_torch.cli.arguments import get_args
    from scail_tpu_torch.engine import VideoDiffusionEngine

    args, model_config = get_args([
        "--base", os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml"),
        os.path.join(ROOT, "configs", "sampling", "pose_cli.yaml"), "--device", "cuda"])
    engine = VideoDiffusionEngine(model_config, args, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    engine.init_params(gen)
    dt = engine.network.config.compute_dtype

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    T, H, W = 21, 64, 112  # latent of 81 frames at 512x896
    x, ctx, ref = rnd(2, T, 16, H, W), rnd(2, 512, 4096), rnd(2, 1, 16, H, W)
    pose, clip = rnd(2, T, 16, H // 2, W // 2), rnd(2, 257, 1280)
    t = torch.full((2,), 900.0, device="cuda")
    video, pose_video, z = rnd(1, 81, 3, 512, 896), rnd(1, 81, 3, 256, 448), rnd(1, T, 16, H, W)
    dense_cfg = engine.network.config
    sta_cfg = dataclasses.replace(dense_cfg, attn_impl="sta")

    def dit():
        return engine.dit(x, t, ctx, ref_concat=ref, concat_smpl_render=pose,
                          image_clip_features=clip)

    calls = {
        "dit": (dense_cfg, dit),
        "dit_sta": (sta_cfg, dit),
        "vae_encode": (dense_cfg, lambda: engine.encode_first_stage(video, force_encode=True)),
        "pose_encode": (dense_cfg, lambda: engine.encode_first_stage(pose_video,
                                                                     force_encode=True)),
        "vae_decode": (dense_cfg, lambda: engine.decode_first_stage(z)),
    }
    for name in (n for n in PHASES if n in calls and n in a.phases):
        engine.dit.config, fn = calls[name]
        with torch.inference_mode():
            rec = profile_phase(name, fn, a.out)
        print(json.dumps(dict(rec, device=card)), flush=True)
    del calls, x, ctx, ref, pose, clip, z
    train = [n for n in TRAIN_CONFIGS if n in a.phases]
    if train:
        step = _train_step_call(engine, gen)
        for name in train:
            engine.dit.config = dataclasses.replace(dense_cfg, **TRAIN_CONFIGS[name])
            rec = profile_phase(name, step, a.out)
            print(json.dumps(dict(rec, device=card)), flush=True)
        del step
    engine.dit.config = dense_cfg
    if "train_step_lora" in a.phases:
        torch.cuda.empty_cache()
        rec = profile_phase("train_step_lora", _train_step_call(engine, gen, LORA_RANK), a.out)
        print(json.dumps(dict(rec, device=card)), flush=True)


def _dit14b_call(name):
    """One 14B DiT forward at CFG batch 2, 48,832 tokens: W4A16 layer
    linears (dit14b_w4) or bf16 weights with int8-QK attention (dit14b_int8),
    random weights from seed 0.  The model lives as long as the call."""
    from scail_tpu_torch.cli.bench_14b_quant import (build_random_quant_params, dit_inputs,
                                                     run_dit)
    from scail_tpu_torch.models.dit import DiT, DiTConfig

    gen = torch.Generator(device="cuda").manual_seed(0)
    if name == "dit14b_w4":
        cfg = DiTConfig(dtype="bfloat16")
        dit = build_random_quant_params(cfg, 4, torch.device("cuda"), gen)
    else:
        cfg = DiTConfig(dtype="bfloat16", attn_impl="pallas_int8")
        dit = DiT(cfg, device="meta")
        dit.init_weights_(gen, device=torch.device("cuda"), dtype=cfg.compute_dtype)
        dit.eval()
    inp = dit_inputs(cfg, 2, torch.device("cuda"), gen)
    return lambda: run_dit(dit, inp)


def _train_step_call(engine, gen, lora_rank=0):
    """One step of the train CLI's Trainer on a random 81-frame 512x896 batch
    (the text states drawn at umt5-xxl width in place of the conditioner);
    with lora_rank, of LoRA factors on a frozen base, as `train --lora-rank`."""
    from scail_tpu_torch.training.engine import TrainConfig, Trainer

    engine.dit = None  # init_params fills only a missing DiT: a fresh f32 one to train
    engine.init_params(gen, trainable=True)
    if lora_rank:
        from scail_tpu_torch.training.lora import add_lora, lora_mask

        add_lora(engine.dit, torch.Generator().manual_seed(1), rank=lora_rank)
        lora_mask(engine.dit)
    trainer = Trainer(engine.dit, lambda g, b: engine.shared_step(g, b)[0],
                      TrainConfig(train_iters=100, warmup_iters=1))
    batch = {"mp4": torch.rand(1, 81, 3, 512, 896, generator=gen, device="cuda") * 2 - 1,
             "pose": torch.rand(1, 81, 3, 512, 896, generator=gen, device="cuda") * 2 - 1,
             "ref_frame": torch.rand(1, 1, 3, 512, 896, generator=gen, device="cuda") * 2 - 1,
             "crossattn": torch.randn(1, 512, 4096, generator=gen, device="cuda").to(
                 engine.network.config.compute_dtype)}
    return lambda: trainer.train_step(batch)


if __name__ == "__main__":
    main()
