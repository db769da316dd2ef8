"""Training CLI on PyTorch (counterpart of scail_tpu/cli/train.py).

Builds the engine from the same YAML graphs as sampling, a VideoPoseDataset
over a directory of example dirs, and runs the Trainer with the RFLoss
raw-pixel shared_step; `--valid-data-root` adds a validation set, whose
in-order loader Trainer.fit evaluates with the same loss every
`eval_interval` steps (TrainConfig).  The DiT trains in f32 parameters with
bf16 compute; the VAE, CLIP and text encoders are frozen.  `--load <dir>` starts the DiT
from a SAT checkpoint directory (<dir>/<latest>/mp_rank_00_model_states.pt,
read in f32); the VAE and encoders then come from the YAML's file paths.
`--lora-rank r` fine-tunes LoRA factors of rank r on the DiT's layer linears
(training/lora.py) with the base frozen.  The YAML's network params choose
the remat policy (`remat_policy`: default, save_attn, save_attn_frac with
`remat_save_frac`, offload_attn) when `checkpoint_activations` is on.

Several ranks: one process per rank, launched with RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT (and LOCAL_RANK for the card) and --distributed;
--mesh-seq and --mesh-model lay the world out as data x seq x model
(parallel/mesh.py), --shard-activations shards the DiT's carries over the
model ranks.  Each data rank loads its own slice of the dataset; rank 0
writes the checkpoints (full state dicts).

Usage:
  python -m scail_tpu_torch.cli.train \\
      --base configs/video_model/scail_1p3b.yaml --data-root /path/to/examples \\
      --save ckpts/run1 [--load DIR] [--lora-rank 16] [--image-size 512 896 --num-frames 81] \\
      [--device cuda]
  RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m scail_tpu_torch.cli.train ... --distributed --mesh-model 2
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from scail_tpu_torch.utils.config import load_configs, split_reference_config


def build_argparser():
    p = argparse.ArgumentParser("scail_tpu_torch.train")
    p.add_argument("--base", nargs="*", default=[])
    p.add_argument("--data-root", required=True)
    p.add_argument("--valid-data-root", default=None,
                   help="a directory of validation example dirs, evaluated during training")
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
    p.add_argument("--lora-rank", type=int, default=0,
                   help=">0 fine-tunes LoRA factors of this rank on the DiT")
    p.add_argument("--mesh-seq", type=int, default=1,
                   help="sequence-parallel ranks (the DiT's tokens shard over them)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel ranks (the DiT's heads and MLP shard over them)")
    p.add_argument("--shard-activations", action="store_true",
                   help="shard the DiT's carries between layers over the model ranks")
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank: torch.distributed from RANK / WORLD_SIZE / "
                        "MASTER_ADDR / MASTER_PORT; each data rank loads its own data slice")
    return p


def main(argv=None):
    """Train; returns the Trainer (its step, parameters and per-step metrics
    in `trainer.history`)."""
    from scail_tpu_torch.data.datasets import VideoPoseDataset, make_loaders
    from scail_tpu_torch.engine import VideoDiffusionEngine
    from scail_tpu_torch.training.engine import TrainConfig, Trainer

    from scail_tpu_torch.parallel.distributed import initialize_distributed
    from scail_tpu_torch.parallel.mesh import DATA_AXIS, MeshSpec, make_mesh

    args = build_argparser().parse_args(argv)
    if args.distributed:
        initialize_distributed(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if args.mesh_seq * args.mesh_model > 1 or world > 1:
        mesh = make_mesh(MeshSpec.infer(world, seq=args.mesh_seq, model=args.mesh_model))
        if args.lora_rank > 0 and args.mesh_model > 1:
            raise NotImplementedError("--lora-rank with --mesh-model > 1: tensor parallel "
                                      "shards plain linears only")
    run_cfg, model_cfg = split_reference_config(load_configs(args.base))
    if args.shard_activations:
        model_cfg = dict(model_cfg)
        nc = dict(model_cfg.get("network_config", {}))
        nc["params"] = dict(nc.get("params", {}) or {}, shard_activations=True)
        model_cfg["network_config"] = nc
    engine = VideoDiffusionEngine(dict(model_cfg), dict(run_cfg), device=args.device)
    dev = engine.device
    if args.load:
        engine.load_checkpoint(args.load, trainable=True)
    else:
        engine.init_params(torch.Generator(device=dev).manual_seed(args.seed), trainable=True)
    if mesh is not None:
        engine.shard_params(mesh)
    if args.lora_rank > 0:
        from scail_tpu_torch.training.lora import add_lora, lora_mask

        add_lora(engine.dit, torch.Generator().manual_seed(args.seed + 1), rank=args.lora_rank)
        lora_mask(engine.dit)
        print(f"LoRA finetuning enabled (rank {args.lora_rank})", flush=True)
    dcfg = engine.dit.config
    if dcfg.remat and dcfg.remat_policy == "save_attn_frac":
        from scail_tpu_torch.models.dit import save_attn_head_layers

        print(f"save_attn_frac remat: {save_attn_head_layers(dcfg)} head layers keep their "
              "flash outputs", flush=True)

    def loss_fn(generator, batch):
        return engine.shared_step(generator, batch)[0]

    tconf = TrainConfig(train_iters=args.train_iters, lr=args.lr,
                        warmup_iters=args.warmup_iters, grad_accum=args.grad_accum,
                        save_dir=args.save, seed=args.seed)
    trainer = Trainer(engine.dit, loss_fn, tconf, model_config=dict(model_cfg), mesh=mesh,
                      rules=engine.param_rules)
    if args.resume:
        trainer.resume()

    ds = VideoPoseDataset(args.data_root, image_size=tuple(args.image_size),
                          num_frames=args.num_frames)
    print(f"dataset: {len(ds)} examples from {args.data_root}", flush=True)
    # --batch-size is per microbatch and per data rank: one step takes
    # grad_accum x batch_size examples on each data rank, from its own slice
    # of each epoch, reshaped to a leading (grad_accum, ...) axis
    accum = max(1, args.grad_accum)
    d_rank, d_size = (mesh.rank(DATA_AXIS), mesh.size(DATA_AXIS)) if mesh else (0, 1)
    per_rank = len(ds) // d_size
    if per_rank < args.batch_size * accum:
        raise SystemExit(f"dataset too small: {per_rank} examples per data rank < batch_size x "
                         f"grad_accum = {args.batch_size}x{accum}; no batch could be drawn")
    valid_ds = None
    if args.valid_data_root:
        valid_ds = VideoPoseDataset(args.valid_data_root, image_size=tuple(args.image_size),
                                    num_frames=args.num_frames)
        print(f"validation: {len(valid_ds)} examples from {args.valid_data_root}", flush=True)
        if len(valid_ds) // d_size < args.batch_size * accum:
            raise SystemExit(f"validation set too small: {len(valid_ds)} examples for "
                             f"{d_size} data ranks of batch_size x grad_accum = "
                             f"{args.batch_size}x{accum}")
    train_loader, valid_loader = make_loaders(ds, args.batch_size * accum, valid_ds=valid_ds,
                                              seed=args.seed, start_iter=trainer.step,
                                              rank=d_rank, world_size=d_size)

    def to_device(batch, accum=accum):
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

    # a validation batch holds batch_size x grad_accum examples in one loss
    valid_iter = None if valid_loader is None else (
        to_device(b, accum=1) for b in valid_loader)
    trainer.history = trainer.fit(map(to_device, iter(train_loader)), valid_iter, loss_fn)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
