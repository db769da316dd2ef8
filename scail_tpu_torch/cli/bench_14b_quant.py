"""One 14B DiT denoise step on one NVIDIA GPU with W8A16 or W4A16 weights
(counterpart of the JAX repo's scripts/bench_14b_quant.py).

The 14B DiT (hidden 5120, 40 layers, 40 heads of 128, MLP 13,824) at full
width and depth, its eight linears per layer replaced by QuantizedLinear
layers of random codes made directly on the card (no float weight is ever
made for them), everything else small random bf16.  This measures the
memory and the step time of the quantized path, not quality.  One step is
one DiT forward at CFG batch `--cfg-batch` over 512x896, 81 frames (48,832
tokens).

  python -m scail_tpu_torch.cli.bench_14b_quant [--bits 4] [--cfg-batch 2]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch import nn

from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops.quant import random_quantized_linear

ITERS = 3  # timed steps, after one untimed first step
# the latent of 81 frames at 512x896: 21 x 64 x 112 (ref 1,792 + video 37,632
# + pose 9,408 = 48,832 tokens after the 2x2 patch)
LATENT = (21, 64, 112)


def build_random_quant_params(cfg: DiTConfig, bits: int, device, generator) -> DiT:
    """The DiT of `cfg` with random W4A16/W8A16 layer linears (ops/quant.py
    random_quantized_linear: int8 codes uniform in [-127, 127] at scale
    0.02/127, or packed int4 bytes uniform in [0, 255] at scale 0.02/7, zero
    bf16 biases) made on `device`, and every other parameter made there in
    bf16, one at a time: N(0, 0.02^2) for the other dense layers' weights and
    biases and the final AdaLN table, N(0, 1/h) for the layers' AdaLN tables,
    ones for the norm scales, zeros for the CLIP projection's LayerNorm
    biases (the JAX script's recipe; torch's generator gives other numbers)."""
    dit = DiT(cfg, device="meta")
    for blk in dit.layers:
        for name, child in list(blk.named_children()):
            if isinstance(child, nn.Linear):
                setattr(blk, name, random_quantized_linear(
                    child.in_features, child.out_features, bits, device=device,
                    generator=generator, dtype=cfg.compute_dtype))
    h = cfg.hidden_size
    with torch.no_grad():
        for mod_name, mod in dit.named_modules():
            for leaf, p in list(mod._parameters.items()):
                name = f"{mod_name}.{leaf}"
                t = torch.empty(p.shape, dtype=torch.float32, device=device)
                if leaf == "scale":
                    t.fill_(1.0)
                elif name.startswith("clip_proj.ln_") and leaf == "bias":
                    t.zero_()
                else:
                    t.normal_(0.0, h ** -0.5 if name.startswith("layers.") else 0.02,
                              generator=generator)
                mod._parameters[leaf] = nn.Parameter(t.to(cfg.compute_dtype),
                                                     requires_grad=False)
    return dit.eval()


def model_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of a model."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def dit_inputs(cfg: DiTConfig, batch: int, device, generator, latent=LATENT) -> dict:
    """Random bf16 DiT inputs of one denoise step: the noisy latent, 512 text
    tokens, the reference latent, the half-resolution pose latent and 257
    CLIP tokens; c_noise 500."""
    T, H, W = latent

    def rnd(*shape):
        return torch.randn(*shape, generator=generator, device=device).to(cfg.compute_dtype)

    return dict(x=rnd(batch, T, 16, H, W),
                timesteps=torch.full((batch,), 500.0, device=device),
                context=rnd(batch, 512, cfg.text_dim), ref_concat=rnd(batch, 1, 16, H, W),
                concat_smpl_render=rnd(batch, T, 16, H // 2, W // 2),
                image_clip_features=rnd(batch, 257, cfg.clip_dim))


def run_dit(dit: DiT, inp: dict):
    """One DiT forward on dit_inputs()."""
    kw = dict(inp)
    return dit(kw.pop("x"), kw.pop("timesteps"), kw.pop("context"), **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("scail_tpu_torch.cli.bench_14b_quant")
    ap.add_argument("--bits", type=int, default=4, choices=[4, 8])
    ap.add_argument("--cfg-batch", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_14b_quant measures the card: CUDA is not available")
    dev = torch.device("cuda")

    cfg = DiTConfig(dtype="bfloat16")  # the 14B's widths
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    dit = build_random_quant_params(cfg, args.bits, dev, gen)
    nbytes = model_bytes(dit)
    print(f"param bytes: {nbytes / 1e9:.2f} GB (bits={args.bits})", flush=True)
    inp = dit_inputs(cfg, args.cfg_batch, dev, gen)

    with torch.inference_mode():
        t0 = time.perf_counter()
        run_dit(dit, inp)
        torch.cuda.synchronize(dev)
        print(f"first step: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = run_dit(dit, inp)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / ITERS * 1e3
    rec = {
        "metric": f"dit_14b_w{args.bits}a16_step_ms_512p",
        "value": round(ms, 1),
        "param_gb": round(nbytes / 1e9, 2),
        "cfg_batch": args.cfg_batch,
        "derived_sec_per_clip_50step": round(ms * 50 / 1000 * (2 // args.cfg_batch), 1),
        "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
        "finite": bool(torch.isfinite(out).all()),
        "device": torch.cuda.get_device_name(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
