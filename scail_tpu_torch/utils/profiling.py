"""Profiling and tracing (counterpart of scail_tpu/utils/profiling.py:1-51;
reference: sat/training/utils.py Timers and the nvtx ranges gated by
--profiling, deepspeed_training.py:458-470).

`profile_trace` runs torch.profiler over the CPU and, when CUDA is
available, the card (CUPTI), and writes a Chrome trace into `logdir`;
`annotate` opens a named range in it; `report_memory` reads the caching
allocator's counters.  cli/profile.py's per-phase measurement is separate.
"""

from __future__ import annotations

import contextlib
import os

import torch

from scail_tpu_torch.utils.logging import print_rank0


def trace_path(logdir: str) -> str:
    """The Chrome trace file profile_trace writes (one per rank)."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return os.path.join(logdir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Capture a trace of the block into trace_path(logdir) (open it in
    chrome://tracing or Perfetto)."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir))
        print_rank0(f"profiler trace written to {logdir}")


def annotate(name: str):
    """A named range inside a trace (the nvtx.range_push equivalent)."""
    return torch.profiler.record_function(name)


def report_memory(name: str = ""):
    """(sat/training/utils.py:135) The card's allocator counters as
    {'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'}, printed on rank 0;
    None without CUDA (as a JAX CPU device reports no memory stats)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    s = torch.cuda.memory_stats()
    stats = {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
             "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
             "bytes_limit": torch.cuda.get_device_properties(
                 torch.cuda.current_device()).total_memory}
    gib = 1024 ** 3
    print_rank0(f"memory ({name}): in_use {stats['bytes_in_use'] / gib:.2f} GiB | "
                f"peak {stats['peak_bytes_in_use'] / gib:.2f} GiB | "
                f"limit {stats['bytes_limit'] / gib:.2f} GiB")
    return stats
