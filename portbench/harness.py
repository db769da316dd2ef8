"""One run of a cell: set-up, the measured window, the readings, the check.

Set-up builds the engine from the configuration and puts the benchmark's
weights into its networks, makes the request's conditioning, and starts the
first request: its first step is the warm step.  Each of these is the
architecture's (`cell.arch`, portbench/arch; for SCAIL's DiT the port's
VideoDiffusionEngine with the DiT, its denoiser and the YAML's RFSampler);
the window, the readings, the trace and the check are shared.  The
window opens at the second step, after a synchronize, and closes when the
host, about to start a step, finds `seconds` gone: the steps it has already
queued finish and are counted, and the window ends in a synchronize.  A
request is the sampler's 50 steps; the next one, with its own noise from the
seed, follows it in the same window.

The window is driven through the sampler's own `step` (wrapped to time and
record it) and, in a traced run, through forward hooks on each of the
architecture's networks that record CUDA events and the host spans
`dit_forward` and `sampler`.  After the window the program's state is freed
and one step drawn from the seed is computed again by the plain reference,
from the state the program began it with (see portbench.check).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, flops, trace
from portbench.manifest import Cell, metric_readers


class WindowClosed(Exception):
    """Raised at the first step that would start after the window's time."""


@dataclasses.dataclass
class StepRecord:
    request: int
    step: int            # index of the step in its request
    sigma: float         # the (sigma, next sigma) the program stepped with
    next_sigma: float
    x: torch.Tensor      # the state the step began from (f32)
    out: torch.Tensor    # the state it returned


class Window:
    """Wraps the sampler's step: records every step, opens the window at
    the second step and closes it after `seconds`."""

    def __init__(self, seconds: float, sync: Callable[[], None],
                 on_open: Callable[[], None] = lambda: None):
        self.seconds = seconds
        self.sync = sync
        self.on_open = on_open
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.warm: Optional[StepRecord] = None
        self.steps: List[StepRecord] = []
        self.noises: List[torch.Tensor] = []
        self._in_request = 0

    @property
    def open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    def begin_request(self, noise: torch.Tensor) -> None:
        self.noises.append(noise)
        self._in_request = 0

    def wrap(self, step_fn, view):
        """step_fn wrapped; view(args, out) -> (x, sigma, next sigma, x next)
        of one call (the architecture's step_view)."""
        def step(*args, **kw):
            if self.warm is not None and self.t_open is None:
                self.sync()
                self.on_open()
                self.t_open = time.perf_counter()
            elif self.open and time.perf_counter() - self.t_open >= self.seconds:
                raise WindowClosed
            out = step_fn(*args, **kw)
            x, sigma, next_sigma, x_next = view(args, out)
            rec = StepRecord(len(self.noises) - 1, self._in_request, sigma, next_sigma, x,
                             x_next)
            self._in_request += 1
            if self.warm is None:
                self.warm = rec
            else:
                self.steps.append(rec)
            return out
        return step

    def close(self) -> float:
        """Synchronize, close the window; returns its seconds."""
        self.sync()
        self.t_close = time.perf_counter()
        return self.t_close - self.t_open


class ForwardMarks:
    """Forward hooks on each network, while the window is open: a CUDA event
    at each forward's start and end, and the host spans `dit_forward` (the
    forward) and `sampler` (from one forward's end to the next one's start).
    The networks run one at a time, so the events alternate start, end: a
    forward that starts inside another raises."""

    def __init__(self, nets: List[torch.nn.Module], window: Window):
        from torch.autograd.profiler import record_function

        self.window = window
        self.starts: List[torch.cuda.Event] = []
        self.ends: List[torch.cuda.Event] = []
        self._span = None
        self._record_function = record_function
        self._handles = [h for net in nets for h in (net.register_forward_pre_hook(self._pre),
                                                      net.register_forward_hook(self._post))]

    def _switch(self, name: Optional[str]) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._span = None
        if name is not None:
            self._span = self._record_function(name)
            self._span.__enter__()

    def _event(self, into: list) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        into.append(ev)

    def _pre(self, module, args):
        if self.window.open:
            if len(self.starts) != len(self.ends):
                raise RuntimeError(f"{type(module).__name__} started inside another hooked "
                                   f"network's forward: list only networks that do not nest")
            self._event(self.starts)
            self._switch("dit_forward")

    def _post(self, module, args, output):
        if self.window.open:
            self._event(self.ends)
            self._switch("sampler")

    def stop(self) -> None:
        self._switch(None)
        for h in self._handles:
            h.remove()

    def gaps_ms(self) -> List[float]:
        """Device milliseconds from each forward's end to the next one's start."""
        return [e.elapsed_time(s) for e, s in zip(self.ends, self.starts[1:])]


def launch_counts() -> Dict[str, int]:
    from scail_tpu_torch.ops import attention, quant

    return {**attention.LAUNCHES, **quant.LAUNCHES}


def reset_launch_counts() -> None:
    from scail_tpu_torch.ops import attention, quant

    attention.reset_launch_counts()
    quant.reset_launch_counts()


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads (portbench/metrics)."""

    steps: int                      # denoise steps in the traced window
    step_s: float                   # its seconds over its steps
    work: flops.StepWork            # the work of one step, from shapes
    trace: Optional[trace.Trace]    # the profiler's operations and spans
    forward_gaps_ms: List[float]    # device ms from a network forward's end to the next one's start


def run_cell(cell: Cell, seed: int, seconds: float, *, trace_run: bool = False,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """One run: returns the result line's fields, and 'compared' (the
    numbers the check compared, each with its limit).  With `control`
    (portbench.control; the benchmark's runs never set it) also 'control':
    the control's gaps on the same step."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    arch = cell.arch
    engine = arch.build_engine(cell, device)
    nets = arch.load_weights(engine, cell, seed)
    cond, uncond = arch.conditioning(cell, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    traced = []  # the profiler and the window's span, entered at the window's opening
    marks = None

    def on_open():
        reset_launch_counts()
        if trace_run:
            from torch.autograd.profiler import record_function
            from torch.profiler import ProfilerActivity, profile

            traced.extend([profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                           record_function(trace.WINDOW)])
            for ctx in traced:
                ctx.__enter__()
        sync()

    window = Window(seconds, sync, on_open)
    if trace_run and cuda:
        marks = ForwardMarks(nets, window)
    engine.sampler.step = window.wrap(engine.sampler.step, arch.step_view)
    request = 0
    try:
        while True:
            noise = arch.noise(cell, seed, request, dev)
            window.begin_request(noise)
            arch.sample(engine, cell, cond, uncond, noise)
            request += 1
    except WindowClosed:
        pass
    if marks is not None:
        marks.stop()
    window_s = window.close()
    steps = len(window.steps)
    for ctx in reversed(traced):
        ctx.__exit__(None, None, None)
    setup_s = window.t_open - t_start
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    step_s = window_s / steps
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s, {steps} steps in {window_s:.3f} s "
        f"({step_s:.4f} s a step), peak {peak / 1e9:.2f} GB, launches {launches}")

    result = {"correct": False, "attempted": steps, "failed": 0,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace_run:
        work = arch.step_work(cell)
        tr = trace.read_profile(traced[0].events()) if traced else None
        ctx = Readings(steps=steps, step_s=step_s, work=work, trace=tr,
                       forward_gaps_ms=marks.gaps_ms() if marks is not None else [])
        metrics = {}
        for name, reader in metric_readers(cell).items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        result["metrics"] = metrics
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            # the architecture's kernel groups, if any, before the frozen ones
            result["breakdown"] = tr.breakdown(getattr(arch, "GROUPS", ()) + trace.GROUPS)
        traced.clear()
    else:
        result["metrics"] = {"denoise_step_s": {"value": step_s, "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}

    # the program's state goes before the reference runs
    nets.clear()
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pick = random.Random(seed).randrange(steps)
    t0 = time.perf_counter()
    compared, control_gaps = check.compare(cell, seed, window, pick, cond, uncond, dev, control)
    compared["launch_gap"] = {
        # the kernels run on the card only: a CPU run launches none
        "value": check.launch_gap(launches, arch.expected_launches(cell, steps if cuda else 0)),
        "limit": 0}
    log(f"reference step {window.steps[pick].step} of request {window.steps[pick].request}: "
        f"{time.perf_counter() - t0:.1f} s")
    result["correct"] = check.passes(compared)
    if control:
        result["control"] = control_gaps
    result["compared"] = compared
    return result

