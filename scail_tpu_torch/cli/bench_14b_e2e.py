"""A whole 14B clip on one NVIDIA GPU with W4A16 (or W8A16) weights
(counterpart of the JAX repo's scripts/bench_14b_e2e.py).

The RF sampling loop of the port's RFSampler schedule (hunyuan shift 5, CFG
scale 4) over the 14B DiT at 512x896, 81 frames, with random quantized
weights (bench_14b_quant.build_random_quant_params): the two CFG halves of a
step run as two forwards at batch 1, then the Euler update; then the
streamed Wan-VAE decode of the final latent (random VAE weights).  The first
step and the first decode are timed apart from the rest (their first-use
costs); the sampling time of `--steps` steps is projected from the later
steps.

  python -m scail_tpu_torch.cli.bench_14b_e2e [--steps 50] [--bits 4] [--skip-decode]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from scail_tpu_torch.cli.bench_14b_quant import build_random_quant_params, model_bytes
from scail_tpu_torch.diffusion.denoiser import Denoiser
from scail_tpu_torch.diffusion.samplers import RFSampler
from scail_tpu_torch.models.dit import DiTConfig
from scail_tpu_torch.models.wan_vae import WanVAEConfig, WanVAEModel, vae_decode


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("scail_tpu_torch.cli.bench_14b_e2e")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=81)
    ap.add_argument("--bits", type=int, default=4, choices=[4, 8])
    ap.add_argument("--skip-decode", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_14b_e2e measures the card: CUDA is not available")
    dev = torch.device("cuda")
    if args.steps < 2:
        raise ValueError("--steps must be at least 2: the first step is timed apart")

    T = (args.frames - 1) // 4 + 1
    H, W = 512 // 8, 896 // 8
    cfg = DiTConfig(dtype="bfloat16")  # the 14B's widths
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    dit = build_random_quant_params(cfg, args.bits, dev, gen)
    nbytes = model_bytes(dit)
    print(f"param bytes: {nbytes / 1e9:.2f} GB (bits={args.bits})", flush=True)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(cfg.compute_dtype)

    cond = {"crossattn": rnd(1, 512, cfg.text_dim), "ref_concat": rnd(1, 1, 16, H, W),
            "concat_smpl_render": rnd(1, T, 16, H // 2, W // 2),
            "image_clip_features": rnd(1, 257, cfg.clip_dim)}
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]))
    sampler = RFSampler(
        hunyuan_schedule=True, shift_scale=5, num_steps=args.steps, mode="normal",
        discretization_config={
            "target": "sgm.modules.diffusionmodules.discretizer.RFDiscretization"},
        guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                       "params": {"scale": 4}})
    denoiser = Denoiser(
        weighting_config={
            "target": "sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting"},
        scaling_config={
            "target": "sgm.modules.diffusionmodules.denoiser_scaling.RFScaling"})

    def net(x, c_noise, c, **kw):
        return dit(x, c_noise, c["crossattn"], ref_concat=c["ref_concat"],
                   concat_smpl_render=c["concat_smpl_render"],
                   image_clip_features=c["image_clip_features"])

    def denoise_half(c, x, sigma):
        s = torch.full((1,), sigma, dtype=torch.float32, device=dev)
        return denoiser(net, x, s, c).float()

    def euler_update(x, v_c, v_u, pair):
        v = v_u + sampler.guider.scale * (v_c - v_u)
        return x + float(np.float32(pair[1]) - np.float32(pair[0])) * v

    x = torch.randn((1, T, 16, H, W), generator=gen, device=dev)
    sigmas = sampler.sigma_schedule(x.shape)
    pairs = np.stack([sigmas[:-1], sigmas[1:]], axis=1)

    def step(x, pair):
        v_c = denoise_half(cond, x, float(pair[0]))
        v_u = denoise_half(uc, x, float(pair[0]))
        return euler_update(x, v_c, v_u, pair)

    with torch.inference_mode():
        t0 = time.perf_counter()
        x = step(x, pairs[0])
        torch.cuda.synchronize(dev)
        print(f"first step: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        for pair in pairs[1:]:
            x = step(x, pair)
        torch.cuda.synchronize(dev)
        t_rest = time.perf_counter() - t0
    step_s = t_rest / (len(pairs) - 1)
    t_sample = step_s * args.steps
    print(f"steps 2..{len(pairs)} measured: {t_rest:.1f}s ({step_s:.2f} s/step, both CFG "
          "halves)", flush=True)
    out = {
        "metric": f"sec_per_clip_14b_w{args.bits}a16_512p_pallas",
        "sampling_s_measured_after_compile_step": round(t_rest, 1),
        "measured_steps": len(pairs) - 1,
        "step_s": round(step_s, 2),
        f"sampling_s_extrapolated_{args.steps}step": round(t_sample, 1),
        "steps": args.steps,
        "param_gb": round(nbytes / 1e9, 2),
        "latent_finite": bool(torch.isfinite(x).all()),
    }
    del dit
    torch.cuda.empty_cache()

    if not args.skip_decode:
        vcfg = WanVAEConfig(dtype="bfloat16")
        vae = WanVAEModel(vcfg, device=dev)
        vae.init_weights_(torch.Generator(device=dev).manual_seed(1))
        vae.to(vcfg.compute_dtype)
        with torch.inference_mode():
            t0 = time.perf_counter()
            vae_decode(vae, vcfg, x, streamed=True)
            torch.cuda.synchronize(dev)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            vid = vae_decode(vae, vcfg, x, streamed=True)
            torch.cuda.synchronize(dev)
            t_dec = time.perf_counter() - t0
        out.update({
            "vae_decode_s": round(t_dec, 1),
            "vae_decode_fps": round(args.frames / t_dec, 2),
            # the first decode's extra seconds (first-use costs; no compile)
            "decode_compile_s": round(t_first - t_dec, 1),
            "value": round(t_sample + t_dec, 1),
            "unit": (f"s/clip ({args.steps}-step sampling extrapolated from the steps after "
                     "the first + streamed decode measured)"),
            "decoded_shape": list(vid.shape),
            "decoded_finite": bool(torch.isfinite(vid).all()),
        })
    else:
        out.update({"value": round(t_sample, 1),
                    "unit": f"s ({args.steps}-step sampling extrapolated from the steps "
                            "after the first)"})
    out.update(peak_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
               device=torch.cuda.get_device_name(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
