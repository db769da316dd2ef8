"""Training CLI on PyTorch (counterpart of scail_tpu/cli/train.py).

Builds the engine from the same YAML graphs as sampling, a VideoPoseDataset
over a directory of example dirs, and runs the Trainer with the RFLoss
raw-pixel shared_step.  The DiT trains in f32 parameters with bf16 compute;
the VAE, CLIP and text encoders are frozen.  `--load <dir>` starts the DiT
from a SAT checkpoint directory (<dir>/<latest>/mp_rank_00_model_states.pt,
read in f32); the VAE and encoders then come from the YAML's file paths.

Usage:
  python -m scail_tpu_torch.cli.train \\
      --base configs/video_model/scail_1p3b.yaml --data-root /path/to/examples \\
      --save ckpts/run1 [--load DIR] [--image-size 512 896 --num-frames 81] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from scail_tpu_torch.utils.config import load_configs, split_reference_config

# flags of the JAX CLI that the port does not run yet, with the ROADMAP item
UNPORTED_FLAGS = {
    "lora_rank": "ROADMAP Queue 1 item 12 (LoRA finetuning)",
    "mesh_seq": "ROADMAP Queue 1 item 13 (parallelism over torch.distributed)",
    "mesh_model": "ROADMAP Queue 1 item 13 (parallelism over torch.distributed)",
    "distributed": "ROADMAP Queue 1 item 13 (parallelism over torch.distributed)",
    "shard_activations": "ROADMAP Queue 1 item 13 (parallelism over torch.distributed)",
}


def build_argparser():
    p = argparse.ArgumentParser("scail_tpu_torch.train")
    p.add_argument("--base", nargs="*", default=[])
    p.add_argument("--data-root", required=True)
    p.add_argument("--save", default=None)
    p.add_argument("--load", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train-iters", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-iters", type=int, default=100)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--image-size", type=int, nargs=2, default=[256, 448])
    p.add_argument("--num-frames", type=int, default=9)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is not available")
    p.add_argument("--lora-rank", type=int, default=0)
    p.add_argument("--mesh-seq", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--shard-activations", action="store_true")
    p.add_argument("--distributed", action="store_true")
    return p


def _check_ported(args) -> None:
    for flag, item in UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value and not (flag.startswith("mesh_") and value == 1):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported: {item}")


def main(argv=None):
    """Train; returns the Trainer (its step, parameters and per-step metrics
    in `trainer.history`)."""
    from scail_tpu_torch.data.datasets import VideoPoseDataset, make_loaders
    from scail_tpu_torch.engine import VideoDiffusionEngine
    from scail_tpu_torch.training.engine import TrainConfig, Trainer

    args = build_argparser().parse_args(argv)
    _check_ported(args)
    run_cfg, model_cfg = split_reference_config(load_configs(args.base))
    engine = VideoDiffusionEngine(dict(model_cfg), dict(run_cfg), device=args.device)
    dev = engine.device
    if args.load:
        engine.load_checkpoint(args.load, trainable=True)
    else:
        engine.init_params(torch.Generator(device=dev).manual_seed(args.seed), trainable=True)

    def loss_fn(generator, batch):
        return engine.shared_step(generator, batch)[0]

    tconf = TrainConfig(train_iters=args.train_iters, lr=args.lr,
                        warmup_iters=args.warmup_iters, grad_accum=args.grad_accum,
                        save_dir=args.save, seed=args.seed)
    trainer = Trainer(engine.dit, loss_fn, tconf, model_config=dict(model_cfg))
    if args.resume:
        trainer.resume()

    ds = VideoPoseDataset(args.data_root, image_size=tuple(args.image_size),
                          num_frames=args.num_frames)
    print(f"dataset: {len(ds)} examples from {args.data_root}", flush=True)
    # --batch-size is per microbatch: one step takes grad_accum x batch_size
    # examples, reshaped to a leading (grad_accum, ...) axis
    accum = max(1, args.grad_accum)
    if len(ds) < args.batch_size * accum:
        raise SystemExit(f"dataset too small: {len(ds)} examples < batch_size x grad_accum = "
                         f"{args.batch_size}x{accum}; no batch could be drawn")
    train_loader = make_loaders(ds, args.batch_size * accum, seed=args.seed,
                                start_iter=trainer.step)

    def to_device(batch):
        out = {}
        if engine.conditioner is not None and "txt" in batch:
            with torch.no_grad():
                out["crossattn"] = engine.conditioner({"txt": batch["txt"]})["crossattn"]
        for k, v in batch.items():
            if isinstance(v, list):
                continue
            out[k] = torch.from_numpy(v).to(dev, torch.float32)
        if accum > 1:
            out = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                   for k, v in out.items()}
        return out

    trainer.history = trainer.fit(map(to_device, iter(train_loader)))
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
