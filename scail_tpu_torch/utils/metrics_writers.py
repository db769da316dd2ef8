"""Metric writer adapters (counterpart of scail_tpu/utils/metrics_writers.py:
1-79; reference: sat/training/utils.py:29-64).

A `MetricsWriter` multiplexes one record stream to:

  - JSONL at <save_dir>/metrics.jsonl (always; the canonical artifact)
  - TensorBoard events at <save_dir>/runs/<run_name or "train"> through
    torch.utils.tensorboard, when it imports
  - wandb when it imports AND enable_wandb=True (reference: --wandb)

A backend that does not import is a no-op, as in the JAX package, so the
Trainer never grows a hard dependency.  TensorBoard writes through its own
TensorFlow stub (`_summary_writer`), so that logging never imports TensorFlow
and what TensorFlow imports in turn (ml_dtypes, and jax where it is installed).
"""

from __future__ import annotations

import json
import os
import sys
import types
from typing import Dict, Optional


def _summary_writer(log_dir: str):
    """torch.utils.tensorboard's SummaryWriter on TensorBoard's TensorFlow
    stub.  TensorBoard loads TensorFlow lazily where one is installed, unless
    `tensorboard.compat.notf` imports (its documented no-TensorFlow switch,
    tensorboard/compat/__init__.py); the stub writes the same event files.
    Where TensorFlow is already loaded the switch changes nothing."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(log_dir=log_dir)


class MetricsWriter:
    def __init__(self, save_dir: Optional[str], *, enable_tensorboard: bool = True,
                 enable_wandb: bool = False, wandb_project: str = "scail_tpu",
                 run_name: Optional[str] = None):
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if save_dir is None:
            return
        os.makedirs(save_dir, exist_ok=True)
        self._jsonl = os.path.join(save_dir, "metrics.jsonl")

        if enable_tensorboard:
            try:
                self._tb = _summary_writer(os.path.join(save_dir, "runs", run_name or "train"))
            except Exception:
                self._tb = None

        if enable_wandb:
            try:
                import wandb

                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=wandb_project, name=run_name, dir=save_dir,
                               mode=os.environ.get("WANDB_MODE", "offline"))
            except Exception:
                self._wandb = None

    @property
    def backends(self) -> Dict[str, bool]:
        """Which outputs are live."""
        return {"jsonl": self._jsonl is not None, "tensorboard": self._tb is not None,
                "wandb": self._wandb is not None}

    def write(self, record: Dict):
        """The record as one JSON line; its int and float values as scalars at
        step record['step'] (else record['iter'])."""
        if self._jsonl:
            with open(self._jsonl, "a") as f:
                f.write(json.dumps(record) + "\n")
        step = int(record.get("step", record.get("iter", 0)))
        scalars = {k: float(v) for k, v in record.items()
                   if k not in ("step", "iter") and isinstance(v, (int, float))}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.finish()
