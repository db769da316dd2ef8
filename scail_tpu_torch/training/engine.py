"""Training engine (counterpart of scail_tpu/training/engine.py:31-56 and
:161-348): the grad-accumulation-aware train loop with NaN skip (switchable,
`skip_nan`), clipping by global norm chained with fused EMA-Adam under the
annealing schedule, metrics through utils/metrics_writers.MetricsWriter
(JSONL, TensorBoard where it imports, wandb when asked and importable),
periodic and final checkpoints (asynchronous, with the EMA double-save),
evaluation every `eval_interval` steps, the replica drift check every
`check_param_sync_interval` steps (training/sync.py), the clean exit at
`exit_interval`, and resume from `latest`.  "data loader" and "train_step"
are timed by utils/timers.Timers, synchronised with the card.

The optimizer covers the parameters that require grad (all of the DiT's in a
full fine-tune, the LoRA factors under training/lora.py); the checkpoint
holds every parameter and buffer of the model, so a LoRA run resumes with
its base.

The random stream is one torch.Generator on the model's device, saved with
the checkpoint, so a resumed run draws what the uninterrupted run would have
drawn.

Under a mesh (parallel/mesh.py) every rank runs this loop on its shard: the
model's tensor-parallel parameters are its slices (engine.shard_params), and
so are their EMA-Adam moments and shadows, made from them; the Trainer takes
the rules they were sharded by (engine.param_rules) to gather and re-shard
them.  The gradients are summed over the ranks that share the rank's model
coordinate (the mesh's 'replica' axis, data x seq: the seq ranks hold
partial sums over their rows), flattened into a few buckets of one
all-reduce each, and divided by the data size, so a step is the one-rank
step on the global batch; the global norm counts each sharded tensor's
slices once; a step is skipped on every rank or on none.  Every rank
draws from the same seed: the loss function draws for the global batch and
keeps its data slice (engine.loss).  `evaluate` draws from a generator of its
own, seeded from the config's seed, the step and 977 + i (JAX folds 977 + i
into the step key), so evaluation never moves the training stream.
Checkpoints hold full state dicts, gathered on every rank and written by
rank 0, so a sharded run's checkpoint loads into a one-card run and the
other way round; resume re-shards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, REPLICA_AXIS
from scail_tpu_torch.parallel.sharding import gather_state_dict, shard_state_dict
from scail_tpu_torch.training.checkpoint import CheckpointManager, load_checkpoint, read_latest
from scail_tpu_torch.training.ema_adam import (EmaAdamState, FusedEmaAdam, clip_by_global_norm_,
                                               swap_in_ema)
from scail_tpu_torch.training.lr_schedules import annealing_lr
from scail_tpu_torch.utils.logging import print_rank0
from scail_tpu_torch.utils.metrics_writers import MetricsWriter
from scail_tpu_torch.utils.timers import Timers


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
    eval_interval: int = 500
    eval_iters: int = 8
    exit_interval: Optional[int] = None  # clean coordinated exit
    save_dir: Optional[str] = None
    tensorboard: bool = True  # <save_dir>/runs/<experiment_name or "train">
    wandb: bool = False
    wandb_project: str = "scail_tpu"
    experiment_name: Optional[str] = None
    seed: int = 1234
    skip_nan: bool = True  # skip the whole update on a non-finite loss or gradient
    check_param_sync_interval: Optional[int] = None
    async_save: bool = True  # write checkpoints in a background thread
    keep_last_checkpoints: int = 3
    keep_every_checkpoints: int = 0


# the most bytes of gradient flattened into one all-reduce under a mesh
GRAD_BUCKET_BYTES = 1 << 28


def _micro_batch(batch: Dict[str, Any], i: int, accum: int) -> Dict[str, Any]:
    """Microbatch i of a batch whose tensors lead with an (accum, ...) axis."""
    if accum == 1:
        return batch
    return {k: v[i] if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == accum else v
            for k, v in batch.items()}


def _grad_buckets(grads, max_bytes: int = GRAD_BUCKET_BYTES):
    """The gradients in order, cut into runs of one dtype and device of at
    most max_bytes each (a larger tensor alone)."""
    buckets, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        last = buckets[-1][-1] if buckets else None
        if last is None or (last.dtype, last.device) != (g.dtype, g.device) \
                or size + nbytes > max_bytes:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    return buckets


class Trainer:
    """Owns the optimizer and step state around
    loss_fn(generator, batch) -> scalar loss (mean over the batch), a
    function of `model`'s parameters that require grad."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, config: TrainConfig,
                 model_config: Optional[Dict] = None, mesh=None, rules=None):
        """mesh: the parallel.mesh.Mesh the model is sharded over (None or a
        trivial mesh: one rank); rules: the parallel.sharding.PathRules it
        was sharded by, needed under a non-trivial mesh."""
        self.config = config
        self.model = model
        self.model_config = model_config
        self.loss_fn = loss_fn
        self.mesh = None if mesh is None or mesh.trivial else mesh
        if self.mesh is not None and rules is None:
            raise ValueError(f"a Trainer over the mesh {self.mesh.spec} needs the rules its "
                             "model was sharded by (engine.param_rules)")
        self.rules = rules
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("the model has no parameter that requires grad")
        device = next(iter(self.params.values())).device
        self.schedule = annealing_lr(config.lr, config.warmup_iters, config.train_iters,
                                     config.lr_decay_style, config.lr_decay_ratio)
        self.optimizer = FusedEmaAdam(weight_decay=config.weight_decay,
                                      ema_decay=config.ema_decay)
        self.opt_state = self.optimizer.init(self.params)
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(config.seed)
        self.step = 0
        self.skipped = 0
        self._ckpt = None
        self.timers = Timers(device)
        self.metrics_writer = MetricsWriter(
            config.save_dir if self._writer_rank else None,
            enable_tensorboard=config.tensorboard, enable_wandb=config.wandb,
            wandb_project=config.wandb_project, run_name=config.experiment_name)

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step over `grad_accum` microbatches; with skip_nan the
        whole update is skipped when the loss or a gradient is not finite."""
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
        if self.mesh is not None:
            loss = self._reduce_grads(loss, grads)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if self.mesh is not None:
            flag = torch.tensor([float(finite)], device=loss.device)
            for axis in (REPLICA_AXIS, MODEL_AXIS):  # the two together: every rank
                comm.all_reduce_(flag, self.mesh, axis, "min")
            finite = bool(flag > 0)
        ok = finite if cfg.skip_nan else True
        if self.mesh is None:
            grad_norm = clip_by_global_norm_(grads, cfg.clip_grad)
        else:
            grad_norm = self._clip_sharded(grads, cfg.clip_grad)
        if ok:
            self.optimizer.step(self.params, grads, self.opt_state,
                                self.schedule(self.opt_state.count + 1))
        self.step += 1
        self.skipped += 0 if ok else 1
        return {"loss": float(loss), "ok": ok, "grad_norm": float(grad_norm)}

    def _reduce_grads(self, loss, grads):
        """Sum the gradients over the ranks that share this rank's model
        coordinate and divide by the data size (the one-rank gradient of the
        global batch's mean loss), one all-reduce a bucket; returns the loss
        averaged over 'data'."""
        mesh = self.mesh
        for bucket in _grad_buckets(list(grads.values())):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            comm.all_reduce_(flat, mesh, REPLICA_AXIS).div_(mesh.size(DATA_AXIS))
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
        loss = comm.all_reduce_(loss.detach().float().reshape(1).clone(), mesh, DATA_AXIS)
        return loss[0] / mesh.size(DATA_AXIS)

    def _sharded(self, name: str, t) -> bool:
        rule = self.rules.rule_for(name, t.dim())
        return rule is not None and MODEL_AXIS in rule.spec

    def _clip_sharded(self, grads, max_norm: float):
        """clip_by_global_norm_ over the whole model: the squares of the
        sharded gradients summed over 'model', each replicated one once."""
        dev = next(iter(grads.values())).device
        sharded = torch.zeros((), dtype=torch.float32, device=dev)
        replicated = torch.zeros((), dtype=torch.float32, device=dev)
        for n, g in grads.items():
            sq = g.float().square().sum()
            if self._sharded(n, g):
                sharded = sharded + sq
            else:
                replicated = replicated + sq
        sharded = comm.all_reduce_(sharded.reshape(1).clone(), self.mesh, MODEL_AXIS)[0]
        norm = torch.sqrt(sharded + replicated)
        if not norm < max_norm:  # optax's rule, as clip_by_global_norm_
            for g in grads.values():
                g.div_(norm.to(g.dtype)).mul_(max_norm)
        return norm

    def fit(self, data_iter: Iterator[Dict[str, Any]],
            eval_data_iter: Optional[Iterator[Dict[str, Any]]] = None,
            eval_loss_fn: Optional[Callable] = None) -> list:
        """Train from the current step to train_iters, or to the first
        multiple of exit_interval; returns each step's metrics.  Within a
        step: log, save, evaluate (eval_loss_fn(generator, batch) on
        eval_data_iter), check the replicas, exit; the final save follows."""
        cfg = self.config
        history, losses = [], []
        t_last = time.perf_counter()
        for it in range(self.step, cfg.train_iters):
            self.timers("data loader").start()
            batch = next(data_iter)
            self.timers("data loader").stop()
            self.timers("train_step").start()
            metrics = self.train_step(batch)
            self.timers("train_step").stop()
            history.append(metrics)
            losses.append(metrics["loss"])
            step = it + 1
            if step % cfg.log_interval == 0 and self._writer_rank:
                elapsed = time.perf_counter() - t_last
                record = {"iter": step, "loss": sum(losses) / len(losses),
                          "lr": self.schedule(step), "grad_norm": metrics["grad_norm"],
                          "it_per_s": cfg.log_interval / elapsed, "skipped": self.skipped}
                print_rank0(f"iter {step}/{cfg.train_iters} | loss {record['loss']:.4f} | "
                            f"lr {record['lr']:.3e} | grad_norm {record['grad_norm']:.3f} | "
                            f"{record['it_per_s']:.2f} it/s | skipped {self.skipped}")
                self._log_metrics(record)
                losses, t_last = [], time.perf_counter()
            if cfg.save_dir and step % cfg.save_interval == 0:
                self.save(step)
            if (eval_data_iter is not None and eval_loss_fn is not None
                    and step % cfg.eval_interval == 0):
                self.evaluate(eval_data_iter, eval_loss_fn)
            if cfg.check_param_sync_interval and step % cfg.check_param_sync_interval == 0:
                drift = self.check_param_sync()
                print_rank0(f"param sync check at iter {step}: max drift {drift}")
            if cfg.exit_interval and step % cfg.exit_interval == 0:
                print_rank0(f"exit-interval hit at iter {step}; clean exit")
                break
        if cfg.save_dir:
            self.save(self.step)
        self.wait_for_save()  # the last write has landed, or its failure raises
        return history

    @property
    def _writer_rank(self) -> bool:
        """Whether this process logs and writes (rank 0 under a mesh)."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _log_metrics(self, record: Dict) -> None:
        """JSONL + TensorBoard + optional wandb (sat/training/utils.py:29-64)."""
        self.metrics_writer.write(record)
        self.metrics_writer.flush()

    def _eval_generator(self, i: int) -> torch.Generator:
        """The random stream of evaluation batch i at the current step: its
        own generator, the training stream untouched."""
        seed = ((self.config.seed * 1_000_003 + self.step) * 1_000_033 + 977 + i) % (1 << 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def evaluate(self, data_iter, eval_loss_fn) -> float:
        """The mean of eval_iters losses eval_loss_fn(generator, batch), without
        gradients; under a mesh, the mean over the data ranks
        (deepspeed_training.py:659-744)."""
        vals = []
        with torch.no_grad():
            for i in range(self.config.eval_iters):
                loss = eval_loss_fn(self._eval_generator(i), next(data_iter)).detach().float()
                if self.mesh is not None:
                    loss = comm.all_reduce_(loss.reshape(1).clone(), self.mesh,
                                            DATA_AXIS)[0] / self.mesh.size(DATA_AXIS)
                vals.append(float(loss))
        loss = sum(vals) / len(vals)
        print_rank0(f"eval loss {loss:.4f}")
        return loss

    def check_param_sync(self, atol: float = 0.0) -> float:
        """The largest drift between the copies of a trained parameter over
        the ranks that hold the same slice (training/sync.py)."""
        from scail_tpu_torch.training.sync import check_param_sync

        return check_param_sync(dict(self.model.named_parameters()), atol, mesh=self.mesh,
                                rules=self.rules)

    # ------------------------------------------------------------------
    def _full(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A state dict of this rank's slices made whole (a collective under a
        mesh; the dict itself without one)."""
        return sd if self.mesh is None else gather_state_dict(sd, self.rules, self.mesh)

    def state_dict(self) -> Dict[str, Any]:
        """The model's parameters and buffers (trained and frozen), the
        optimizer state, the step and the random stream, by reference; under
        a mesh, the full tensors gathered from every rank."""
        opt = self.opt_state.state_dict()
        for field in ("exp_avg", "exp_avg_sq", "shadow"):
            opt[field] = self._full(opt[field])
        return {"params": self._full(self.model.state_dict()),
                "opt_state": opt, "step": self.step,
                "skipped": self.skipped, "generator": self.generator.get_state()}

    def ema_params(self, state: Dict[str, Any] = None) -> Dict[str, torch.Tensor]:
        """The model's state with the EMA shadow in place of each trained
        parameter (the EMA double-save; frozen ones keep their values), from
        `state` (this state_dict(), made when not given)."""
        state = self.state_dict() if state is None else state
        return swap_in_ema(state["params"], EmaAdamState(**state["opt_state"]))[0]

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a full state (re-sharded under a mesh)."""
        if self.mesh is not None:
            state = dict(state, params=shard_state_dict(state["params"], self.rules, self.mesh),
                         opt_state=dict(state["opt_state"], **{
                             f: shard_state_dict(state["opt_state"][f], self.rules, self.mesh)
                             for f in ("exp_avg", "exp_avg_sq", "shadow")}))
        with torch.no_grad():
            self.model.load_state_dict(state["params"])
            opt = state["opt_state"]
            for field in ("exp_avg", "exp_avg_sq", "shadow"):
                for n, t in getattr(self.opt_state, field).items():
                    t.copy_(opt[field][n])
        self.opt_state.count = int(opt["count"])
        self.step, self.skipped = int(state["step"]), int(state["skipped"])
        self.generator.set_state(state["generator"])

    def save(self, iteration: int) -> Optional[str]:
        """Save the full state; under a mesh every rank gathers and rank 0
        writes (the others return None)."""
        cfg = self.config
        state = self.state_dict()
        ema = self.ema_params(state)
        if not self._writer_rank:
            return None
        if self._ckpt is None:
            self._ckpt = CheckpointManager(cfg.save_dir, keep_last=cfg.keep_last_checkpoints,
                                           keep_every=cfg.keep_every_checkpoints,
                                           async_save=cfg.async_save)
        path = self._ckpt.save(iteration, state, model_config=self.model_config,
                               ema_params=ema)
        print_rank0(f"saved checkpoint iter {iteration} -> {path}"
                    + (" (async)" if cfg.async_save else ""))
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
            print_rank0("no checkpoint to resume from; starting fresh")
            return 0
        state, it = load_checkpoint(d)
        self.load_state_dict(state)
        print_rank0(f"resumed from iter {it}")
        return it
