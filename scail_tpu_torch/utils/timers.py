"""Named device-synchronised timers (counterpart of scail_tpu/utils/timers.py:
1-80; reference: sat/training/utils.py:67-133).

As the reference's Timers do, a timer on a CUDA device calls
torch.cuda.synchronize() at start and at stop, so it measures the work the
region queued on the card and not only its launch.  (The JAX timers read the
host clock alone, so under JAX's asynchronous dispatch they time the
dispatch.)  On the CPU they read the host clock.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


def device_sync(device=None):
    """Block until the work queued on `device` (default: the current CUDA
    device, when CUDA is initialised) is done; a no-op on the CPU."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.elapsed_ = 0.0
        self.started = False
        self.start_time = 0.0

    def _sync(self):
        if self.device is not None:
            device_sync(self.device)

    def start(self):
        assert not self.started, f"timer {self.name} already started"
        self._sync()
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self):
        assert self.started, f"timer {self.name} not started"
        self._sync()
        self.elapsed_ += time.perf_counter() - self.start_time
        self.started = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started = False

    def elapsed(self, reset=True):
        was_started = self.started
        if was_started:
            self.stop()
        e = self.elapsed_
        if reset:
            self.reset()
        if was_started:
            self.start()
        return e


class Timers:
    """Group of named timers on one device (None or a CPU device: the host
    clock alone); `log` prints ms per interval like the reference's
    `Timers.log`."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def log(self, names=None, normalizer=1.0, reset=True) -> str:
        names = names or list(self.timers)
        parts = []
        for n in names:
            if n in self.timers:
                ms = self.timers[n].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{n}: {ms:.2f}ms")
        line = " | ".join(parts)
        from scail_tpu_torch.utils.logging import print_rank0

        print_rank0("timers: " + line)
        return line
