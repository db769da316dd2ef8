"""Checkpoint save and restore (counterpart of scail_tpu/training/checkpoint.py)
in a torch-native format in place of Orbax, with the same layout:

  <save>/latest              text file naming the newest committed iteration
  <save>/<iter>/state/       torch.save of the trainer state (state.pt)
  <save>/<iter>/ema/         the EMA double-save: {"params": the model's
                             parameters with the EMA shadow swapped in}
  <save>/model_config.json   the model graph, for from_pretrained

Each tree is written to a temporary directory and renamed into place, and
only once every tree of an iteration has landed does `latest` move to it, so
a crash mid-save never leaves `latest` on a torn checkpoint.
`CheckpointManager` writes asynchronously by default, as the JAX manager
does: `save` copies the trees to the host, a writer thread writes them and
then advances `latest` and collects old iterations; training goes on
meanwhile.  A write that fails raises at the next `save` or at `wait`.
Retention keeps the newest `keep_last` iterations, every multiple of
`keep_every` (0: none by period) and the one `latest` names.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
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


def _write_tree(path: str, tree: Dict[str, Any]) -> None:
    """torch.save `tree` as <path>/state.pt through <path>.tmp and a rename."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _commit(save_dir: str, iteration: int) -> None:
    with open(_tracker_path(save_dir) + ".tmp", "w") as f:
        f.write(str(iteration))
    os.replace(_tracker_path(save_dir) + ".tmp", _tracker_path(save_dir))


def _write_config(save_dir: str, model_config: Optional[Dict]) -> None:
    if model_config is not None:
        with open(os.path.join(save_dir, "model_config.json"), "w") as f:
            json.dump(model_config, f, indent=2, default=str)


def save_checkpoint(save_dir: str, iteration: int, state: Dict[str, Any],
                    model_config: Optional[Dict] = None, ema_params=None) -> str:
    """Write `state` (nested dicts of tensors and Python scalars) as
    <save_dir>/<iteration>/state, and `ema_params` as <iteration>/ema, then
    point `latest` at the iteration.  Synchronous.  Returns the state path."""
    save_dir = os.path.abspath(save_dir)
    it_dir = os.path.join(save_dir, str(iteration))
    final = os.path.join(it_dir, "state")
    _write_tree(final, state)
    if ema_params is not None:
        _write_tree(os.path.join(it_dir, "ema"), {"params": ema_params})
    _write_config(save_dir, model_config)
    _commit(save_dir, iteration)
    return final


def load_checkpoint(save_dir: str, iteration: Optional[int] = None, ema: bool = False):
    """(tree on the CPU, iteration): the state of the checkpoint `latest`
    names (or of `iteration`), or with `ema` its {"params": EMA weights}.
    The file is memory-mapped: tensors are read as they are copied."""
    it = str(iteration) if iteration is not None else read_latest(save_dir)
    if it is None:
        raise FileNotFoundError(f"no `latest` tracker in {save_dir}")
    path = os.path.join(os.path.abspath(save_dir), it, "ema" if ema else "state", STATE_FILE)
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True), int(it)


def _host_copy(tree):
    """A copy of a nested dict of tensors and scalars whose tensors are on the
    CPU and share no storage with the originals."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    """Saves with retention, asynchronous by default (module docstring)."""

    def __init__(self, save_dir: str, keep_last: int = 3, keep_every: int = 0,
                 async_save: bool = True):
        self.save_dir = os.path.abspath(save_dir)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._failed_iteration: Optional[int] = None

    def save(self, iteration: int, state: Dict[str, Any], model_config: Optional[Dict] = None,
             ema_params=None) -> str:
        """Save one iteration; returns its state path.  The trees are copied
        to the host before this returns, so the caller may go on changing
        them."""
        self.wait()  # one write at a time, in order; raises a failed one
        os.makedirs(self.save_dir, exist_ok=True)
        state, ema_params = _host_copy(state), _host_copy(ema_params)
        args = (iteration, state, model_config, ema_params)
        if self.async_save:
            self._writer = threading.Thread(target=self._write, args=args,
                                            name=f"checkpoint-{iteration}")
            self._writer.start()
        else:
            self._write(*args)
            self._raise_failure()
        return os.path.join(self.save_dir, str(iteration), "state")

    def _write(self, iteration, state, model_config, ema_params) -> None:
        try:
            save_checkpoint(self.save_dir, iteration, state, model_config, ema_params)
            self._gc()
        except Exception as err:  # handed to the caller's thread by wait()
            self._error, self._failed_iteration = err, iteration

    def wait(self) -> None:
        """Block until the write in flight (if any) has committed; raise if a
        write failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_failure()

    close = wait

    def _raise_failure(self) -> None:
        if self._error is not None:
            err, it = self._error, self._failed_iteration
            self._error = self._failed_iteration = None
            raise RuntimeError(f"writing checkpoint iteration {it} to {self.save_dir} failed; "
                               f"`latest` still names {read_latest(self.save_dir)}") from err

    def _retained(self, iterations):
        keep = set(sorted(iterations)[-self.keep_last:] if self.keep_last else [])
        if self.keep_every:
            keep |= {i for i in iterations if i % self.keep_every == 0}
        return keep

    def _gc(self) -> None:
        its = [int(n) for n in os.listdir(self.save_dir)
               if n.isdigit() and os.path.isdir(os.path.join(self.save_dir, n))]
        keep = self._retained(its)
        latest = read_latest(self.save_dir)
        if latest is not None:
            keep.add(int(latest))
        for i in its:
            if i not in keep:
                shutil.rmtree(os.path.join(self.save_dir, str(i)))
