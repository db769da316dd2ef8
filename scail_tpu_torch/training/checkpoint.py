"""Checkpoint save and restore (counterpart of scail_tpu/training/checkpoint.py)
in a torch-native format in place of Orbax, with the same layout:

  <save>/latest              text file naming the newest committed iteration
  <save>/<iter>/state/       torch.save of the trainer state (state.pt)
  <save>/model_config.json   the model graph, for from_pretrained

A save is written to a temporary directory and renamed into place, and only
then does `latest` move to it, so a crash mid-save never leaves `latest` on
a torn checkpoint.  The manager keeps the newest `keep_last` iterations.
Saves are synchronous: the JAX package's Orbax writes are asynchronous.  The
EMA weights live in the state (the optimizer's shadow;
training.ema_adam.swap_in_ema), not in a second tree.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def _tracker_path(save_dir: str) -> str:
    return os.path.join(save_dir, "latest")


def read_latest(save_dir: str) -> Optional[str]:
    p = _tracker_path(save_dir)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return f.read().strip()


def save_checkpoint(save_dir: str, iteration: int, state: Dict[str, Any],
                    model_config: Optional[Dict] = None) -> str:
    """Write `state` (nested dicts of tensors and Python scalars) as
    <save_dir>/<iteration>/state and point `latest` at it.  Returns the path."""
    save_dir = os.path.abspath(save_dir)
    it_dir = os.path.join(save_dir, str(iteration))
    final = os.path.join(it_dir, "state")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    if model_config is not None:
        with open(os.path.join(save_dir, "model_config.json"), "w") as f:
            json.dump(model_config, f, indent=2, default=str)
    with open(_tracker_path(save_dir) + ".tmp", "w") as f:
        f.write(str(iteration))
    os.replace(_tracker_path(save_dir) + ".tmp", _tracker_path(save_dir))
    return final


def load_checkpoint(save_dir: str):
    """(state on the CPU, iteration) of the checkpoint `latest` names.  The
    file is memory-mapped: tensors are read as they are copied."""
    it = read_latest(save_dir)
    if it is None:
        raise FileNotFoundError(f"no `latest` tracker in {save_dir}")
    path = os.path.join(os.path.abspath(save_dir), it, "state", STATE_FILE)
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True), int(it)


class CheckpointManager:
    """Saves with retention: keep the newest `keep_last` iterations and the
    one `latest` names."""

    def __init__(self, save_dir: str, keep_last: int = 3):
        self.save_dir = os.path.abspath(save_dir)
        self.keep_last = keep_last

    def save(self, iteration: int, state: Dict[str, Any],
             model_config: Optional[Dict] = None) -> str:
        path = save_checkpoint(self.save_dir, iteration, state, model_config)
        self._gc()
        return path

    def _gc(self):
        its = [int(n) for n in os.listdir(self.save_dir)
               if n.isdigit() and os.path.isdir(os.path.join(self.save_dir, n))]
        keep = set(sorted(its)[-self.keep_last:] if self.keep_last else [])
        latest = read_latest(self.save_dir)
        if latest is not None:
            keep.add(int(latest))
        for i in its:
            if i not in keep:
                shutil.rmtree(os.path.join(self.save_dir, str(i)))
