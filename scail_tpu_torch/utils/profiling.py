"""Profiling and tracing (counterpart of scail_tpu/utils/profiling.py:1-51;
reference: sat/training/utils.py Timers and the nvtx ranges gated by
--profiling, deepspeed_training.py:458-470).

Spans.  `annotate(name)` is the program's one span entry point.  It is in
one of three states:

- off, the default: it returns one shared no-op context manager after a
  single check, and allocates, records and times nothing;
- recording, while a torch profiler records in this process or after
  `enable()`: each span appends a `Span` to an in-process list (its name,
  its parent, the sampler's request and step index, host start and end from
  `time.perf_counter_ns`, and on CUDA two timing events, resolved only when
  read).  It opens no `record_function`: torch hands a range's GPU-side
  annotation to a profiler's `events()` as a CUDA event, where a reader
  that counts the device events as kernels would count the span's whole
  length;
- under `profile_trace`: it records, and also opens `record_function(name)`,
  so the Chrome trace shows the span.

A span's events go on the stream that was current when the outermost open
span opened (none where CUDA was not initialized then).  A span opened
with `follows=` the span just closed before it, with nothing run between
the two, starts on that span's end event: one event a boundary.  Each
outermost span, as it opens, resolves the records the card has passed
(without blocking) and returns their events to a pool for later spans, so
events are made only for the first steps and none stays pending long.
Spans opened inside a backward pass (a checkpoint's recompute) are not
recorded, nor any past `MAX_SPANS` records.

`annotate(name, always=True)` records a host-clock span in every state (for
set-up, which ends before a profiler starts).  Spans nest per process, so
open them from one thread.  `spans()` returns the records with their device
milliseconds, `counts()` the number per name (the base of every ratio),
`reset()` clears them (and so does entering `profile_trace`).
`clock_offset` maps the records' host clock onto a profiler trace's clock
from spans both saw start, and `innermost` finds the span the host was in
at an instant.

`profile_trace` runs torch.profiler over the CPU and, when CUDA is
available, the card (CUPTI), and writes a Chrome trace into `logdir`;
`report_memory` reads the caching allocator's counters.  cli/profile.py's
per-phase measurement is separate.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from scail_tpu_torch.utils.logging import print_rank0

# the largest spread, over the anchors, of the host clock's offset from a
# trace's clock that clock_offset accepts
CLOCK_RESIDUAL_S = 100e-6
# the most records kept: past it spans record nothing until reset() (a
# 50-step request of the 14B DiT records 6,100)
MAX_SPANS = 100_000


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span.  `parent` is the index in spans() of the span it
    opened inside; `request` and `step` the sampler's position (mark_step),
    -1 before any."""

    name: str
    parent: Optional[int]
    request: int
    step: int
    start_ns: int
    end_ns: Optional[int] = None         # None while open
    events: Optional[tuple] = None       # (start, end) torch.cuda.Event on CUDA, until resolved
    end_taken: bool = False              # events[1] is the start of the span after it
    device_ms: Optional[float] = None    # resolved by spans()
    self_ms: Optional[float] = None      # device_ms less its children's

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6


class _Recorder:
    """The records of this process and the state that decides whether a
    span records."""

    def __init__(self):
        self.records: List[Span] = []
        self.open: List[Tuple[int, Span]] = []   # (index, span) of the open spans
        self.stream = None                        # of the outermost open span
        self.pool: List[torch.cuda.Event] = []    # events read, for later spans
        self.resolved = 0                         # records before it are resolved
        self.request = -1
        self.step = -1
        self.enabled = False
        self.exporting = 0   # profile_trace blocks entered and not left

    def event(self, stream) -> torch.cuda.Event:
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def collect(self, wait: bool) -> None:
        """Resolve the closed records' device ms in order, from the first
        not yet resolved up to the first span still open, and return their
        events to the pool; without `wait`, only as far as the card has
        passed (`query`), so it never blocks."""
        records = self.records
        while self.resolved < len(records):
            s = records[self.resolved]
            if s.events is not None:
                start, end = s.events
                if s.end_ns is None or not (wait or end.query()):
                    return
                if wait:
                    end.synchronize()
                s.device_ms = start.elapsed_time(end)
                self.release(s)
            self.resolved += 1

    def release(self, s: Span) -> None:
        """Return a closed record's events to the pool: its start, and its
        end unless a later span starts on it (and returns it)."""
        self.pool.append(s.events[0])
        if not s.end_taken:
            self.pool.append(s.events[1])
        s.events = None


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Recording:
    """A span in the recording state (see the module docstring)."""

    __slots__ = ("name", "device", "follows", "span", "range")

    def __init__(self, name: str, device: bool, follows: Optional[Span]):
        self.name = name
        self.device = device
        self.follows = follows

    def __enter__(self) -> Span:
        t = time.perf_counter_ns()
        rec = _REC
        if not rec.open:
            rec.stream = (torch.cuda.current_stream()
                          if self.device and torch.cuda.is_initialized() else None)
            if rec.stream is not None:
                rec.collect(wait=False)
        span = Span(self.name, rec.open[-1][0] if rec.open else None, rec.request, rec.step, t)
        if self.device and rec.stream is not None:
            before = self.follows
            if before is not None and before.events is not None and before.end_ns is not None:
                span.events = (before.events[1], None)
                before.end_taken = True
            else:
                span.events = (rec.event(rec.stream), None)
        self.range = None
        if rec.exporting:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        rec.open.append((len(rec.records), span))
        rec.records.append(span)
        self.span = span
        return span

    def __exit__(self, *exc) -> bool:
        span = self.span
        if self.range is not None:
            self.range.__exit__(*exc)
        if span.events is not None:
            span.events = (span.events[0], _REC.event(_REC.stream))
        span.end_ns = time.perf_counter_ns()
        # innermost last; reset() may have dropped it
        opened = _REC.open
        for k in range(len(opened) - 1, -1, -1):
            if opened[k][1] is span:
                del opened[k]
                break
        return False


def annotate(name: str, *, always: bool = False, follows: Optional[Span] = None):
    """A span named `name` around the block: a no-op unless a profiler
    records, `enable()` was called or `always` (a host-clock span, recorded
    in every state); `follows` is the span closed just before it, where
    nothing runs between the two (see the module docstring)."""
    if not (always or _REC.enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    if len(_REC.records) >= MAX_SPANS or torch._C._current_graph_task_id() != -1:
        return _OFF
    return _Recording(name, not always, follows)


def enable(on: bool = True) -> None:
    """Record spans whether or not a profiler records."""
    _REC.enabled = on


def mark_step(step: int) -> None:
    """The sampler's position, called before each of its steps: spans after
    it carry `step`, and a step 0 starts the next request."""
    if step == 0:
        _REC.request += 1
    _REC.step = step


def self_times(records: Sequence[Span]) -> List[Optional[float]]:
    """Each span's device ms less the device ms of the spans opened directly
    inside it (on one stream they lie inside it and apart); None where it
    has no device time."""
    children = [0.0] * len(records)
    for s in records:
        if s.parent is not None and s.device_ms is not None:
            children[s.parent] += s.device_ms
    return [None if s.device_ms is None else s.device_ms - c for s, c in zip(records, children)]


def spans() -> List[Span]:
    """The records, in the order they opened, their device ms resolved (after
    a synchronize) up to the first span still open."""
    _REC.collect(wait=True)
    records = list(_REC.records)
    for s, own in zip(records, self_times(records)):
        s.self_ms = own
    return records


def counts() -> Dict[str, int]:
    """The number of records per span name."""
    out: Dict[str, int] = {}
    for s in _REC.records:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def reset() -> None:
    """Drop every record (spans open now are not recorded)."""
    for s in _REC.records:
        if s.events is not None and s.end_ns is not None:
            _REC.release(s)
    _REC.records.clear()
    _REC.open.clear()
    _REC.resolved = 0


def clock_offset(trace_starts_s: Sequence[float],
                 program_starts_ns: Sequence[int]) -> Tuple[float, float]:
    """(offset, residual), seconds: a trace time is the host time (ns / 1e9)
    plus the offset, the median over the anchors of (trace start - program
    start); the residual is the anchors' largest deviation from it.  The
    anchors are the starts of spans the trace and the records both hold, one
    pair a span in order.  Raises where they do not pair up or the residual
    exceeds CLOCK_RESIDUAL_S."""
    if len(trace_starts_s) != len(program_starts_ns) or not trace_starts_s:
        raise ValueError(f"{len(trace_starts_s)} trace anchors against "
                         f"{len(program_starts_ns)} program anchors")
    diffs = [t - p / 1e9 for t, p in zip(sorted(trace_starts_s), sorted(program_starts_ns))]
    offset = statistics.median(diffs)
    residual = max(abs(d - offset) for d in diffs)
    if residual > CLOCK_RESIDUAL_S:
        raise ValueError(f"the host clock's offset from the trace's spreads {residual * 1e6:.1f} "
                         f"us over {len(diffs)} anchors (at most {CLOCK_RESIDUAL_S * 1e6:.0f})")
    return offset, residual


def innermost(records: Sequence[Span], times_ns: Sequence[float]) -> List[Optional[Span]]:
    """For each host time, the innermost closed span of `records` (spans()'s
    list, in the order they opened) that holds it; None where none does."""
    starts = [s.start_ns for s in records]
    out: List[Optional[Span]] = []
    for t in times_ns:
        # the span opened last before t, or the first of its ancestors
        # still open at t: spans nest, so no other span can hold t
        i = bisect.bisect_right(starts, t) - 1
        found = None
        while i is not None and i >= 0:
            s = records[i]
            if s.end_ns is not None and t < s.end_ns:
                found = s
                break
            i = s.parent
        out.append(found)
    return out


def trace_path(logdir: str) -> str:
    """The Chrome trace file profile_trace writes (one per rank)."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return os.path.join(logdir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Capture a trace of the block into trace_path(logdir) (open it in
    chrome://tracing or Perfetto); spans inside it show as ranges."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset()
    prof.start()
    _REC.exporting += 1
    try:
        yield prof
    finally:
        _REC.exporting -= 1
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir))
        print_rank0(f"profiler trace written to {logdir}")


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
