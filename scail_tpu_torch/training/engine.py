"""Training engine (counterpart of scail_tpu/training/engine.py): the
grad-accumulation-aware train loop with NaN skip, clipping by global norm
chained with fused EMA-Adam under the annealing schedule, JSONL metrics,
periodic and final checkpoints (asynchronous, with the EMA double-save), and
resume from `latest`.

The optimizer covers the parameters that require grad (all of the DiT's in a
full fine-tune, the LoRA factors under training/lora.py); the checkpoint
holds every parameter and buffer of the model, so a LoRA run resumes with
its base.

One process on one device.  The random stream is one torch.Generator on the
model's device, saved with the checkpoint, so a resumed run draws what the
uninterrupted run would have drawn.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from scail_tpu_torch.training.checkpoint import CheckpointManager, load_checkpoint, read_latest
from scail_tpu_torch.training.ema_adam import FusedEmaAdam, clip_by_global_norm_, swap_in_ema
from scail_tpu_torch.training.lr_schedules import annealing_lr


@dataclasses.dataclass
class TrainConfig:
    train_iters: int = 1000
    lr: float = 1e-4
    warmup_iters: int = 100
    lr_decay_style: str = "cosine"
    lr_decay_ratio: float = 0.1
    weight_decay: float = 0.01
    clip_grad: float = 1.0
    grad_accum: int = 1
    ema_decay: float = 0.9999
    log_interval: int = 10
    save_interval: int = 500
    save_dir: Optional[str] = None
    tensorboard: bool = False
    wandb: bool = False
    seed: int = 1234
    async_save: bool = True  # write checkpoints in a background thread
    keep_last_checkpoints: int = 3
    keep_every_checkpoints: int = 0


def _micro_batch(batch: Dict[str, Any], i: int, accum: int) -> Dict[str, Any]:
    """Microbatch i of a batch whose tensors lead with an (accum, ...) axis."""
    if accum == 1:
        return batch
    return {k: v[i] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == accum else v
            for k, v in batch.items()}


class Trainer:
    """Owns the optimizer and step state around
    loss_fn(generator, batch) -> scalar loss (mean over the batch), a
    function of `model`'s parameters that require grad."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, config: TrainConfig,
                 model_config: Optional[Dict] = None):
        if config.tensorboard or config.wandb:
            raise NotImplementedError("TensorBoard and wandb logging are not ported (ROADMAP "
                                      "Queue 1 item 12, the metric writers): metrics go to "
                                      "<save_dir>/metrics.jsonl")
        self.config = config
        self.model = model
        self.model_config = model_config
        self.loss_fn = loss_fn
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("the model has no parameter that requires grad")
        device = next(iter(self.params.values())).device
        self.schedule = annealing_lr(config.lr, config.warmup_iters, config.train_iters,
                                     config.lr_decay_style, config.lr_decay_ratio)
        self.optimizer = FusedEmaAdam(weight_decay=config.weight_decay,
                                      ema_decay=config.ema_decay)
        self.opt_state = self.optimizer.init(self.params)
        self.generator = torch.Generator(device=device).manual_seed(config.seed)
        self.step = 0
        self.skipped = 0
        self._ckpt = None

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step over `grad_accum` microbatches; the whole update
        is skipped when the loss or a gradient is not finite."""
        cfg = self.config
        for p in self.params.values():
            p.grad = None
        loss = 0.0
        for i in range(cfg.grad_accum):
            micro = self.loss_fn(self.generator, _micro_batch(batch, i, cfg.grad_accum))
            micro.backward()
            loss = loss + micro.detach()
        loss = loss / cfg.grad_accum
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.div_(cfg.grad_accum)
                 for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None  # the optimizer reads `grads`; no second copy stays alive
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        ok = finite
        grad_norm = clip_by_global_norm_(grads, cfg.clip_grad)
        if ok:
            self.optimizer.step(self.params, grads, self.opt_state,
                                self.schedule(self.opt_state.count + 1))
        self.step += 1
        self.skipped += 0 if ok else 1
        return {"loss": float(loss), "ok": ok, "grad_norm": float(grad_norm)}

    def fit(self, data_iter: Iterator[Dict[str, Any]]) -> list:
        """Train from the current step to train_iters; returns each step's
        metrics."""
        cfg = self.config
        history, losses = [], []
        t_last = time.perf_counter()
        for it in range(self.step, cfg.train_iters):
            metrics = self.train_step(next(data_iter))
            history.append(metrics)
            losses.append(metrics["loss"])
            step = it + 1
            if step % cfg.log_interval == 0:
                elapsed = time.perf_counter() - t_last
                record = {"iter": step, "loss": sum(losses) / len(losses),
                          "lr": self.schedule(step), "grad_norm": metrics["grad_norm"],
                          "it_per_s": cfg.log_interval / elapsed, "skipped": self.skipped}
                print(f"iter {step}/{cfg.train_iters} | loss {record['loss']:.4f} | "
                      f"lr {record['lr']:.3e} | grad_norm {record['grad_norm']:.3f} | "
                      f"{record['it_per_s']:.2f} it/s | skipped {self.skipped}", flush=True)
                self._log_metrics(record)
                losses, t_last = [], time.perf_counter()
            if cfg.save_dir and step % cfg.save_interval == 0:
                self.save(step)
        if cfg.save_dir:
            self.save(self.step)
        self.wait_for_save()  # the last write has landed, or its failure raises
        return history

    def _log_metrics(self, record: Dict) -> None:
        if self.config.save_dir:
            os.makedirs(self.config.save_dir, exist_ok=True)
            with open(os.path.join(self.config.save_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The model's parameters and buffers (trained and frozen), the
        optimizer state, the step and the random stream, by reference."""
        return {"params": self.model.state_dict(),
                "opt_state": self.opt_state.state_dict(), "step": self.step,
                "skipped": self.skipped, "generator": self.generator.get_state()}

    def ema_params(self) -> Dict[str, torch.Tensor]:
        """The model's state with the EMA shadow in place of each trained
        parameter (the EMA double-save; frozen ones keep their values)."""
        return swap_in_ema(self.model.state_dict(), self.opt_state)[0]

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            self.model.load_state_dict(state["params"])
            opt = state["opt_state"]
            for field in ("exp_avg", "exp_avg_sq", "shadow"):
                for n, t in getattr(self.opt_state, field).items():
                    t.copy_(opt[field][n])
        self.opt_state.count = int(opt["count"])
        self.step, self.skipped = int(state["step"]), int(state["skipped"])
        self.generator.set_state(state["generator"])

    def save(self, iteration: int) -> str:
        cfg = self.config
        if self._ckpt is None:
            self._ckpt = CheckpointManager(cfg.save_dir, keep_last=cfg.keep_last_checkpoints,
                                           keep_every=cfg.keep_every_checkpoints,
                                           async_save=cfg.async_save)
        path = self._ckpt.save(iteration, self.state_dict(), model_config=self.model_config,
                               ema_params=self.ema_params())
        print(f"saved checkpoint iter {iteration} -> {path}"
              + (" (async)" if cfg.async_save else ""), flush=True)
        return path

    def wait_for_save(self) -> None:
        """Block until the checkpoint write in flight (if any) has landed;
        raise if a write failed."""
        if self._ckpt is not None:
            self._ckpt.wait()

    def resume(self, save_dir: Optional[str] = None) -> int:
        """Continue from `latest` in save_dir (default: the config's)."""
        self.wait_for_save()
        d = save_dir or self.config.save_dir
        if d is None or read_latest(d) is None:
            print("no checkpoint to resume from; starting fresh", flush=True)
            return 0
        state, it = load_checkpoint(d)
        self.load_state_dict(state)
        print(f"resumed from iter {it}", flush=True)
        return it
