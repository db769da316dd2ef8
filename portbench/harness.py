"""One run of a cell: set-up, the measured window, the readings, the check.

Set-up builds the port's VideoDiffusionEngine from the configuration (the
DiT, its denoiser and the RFSampler of the YAML), puts the benchmark's
weights into its DiT, makes the request's conditioning, and starts
`engine.sample` on the first request: its first step is the warm step.  The
window opens at the second step, after a synchronize, and closes when the
host, about to start a step, finds `seconds` gone: the steps it has already
queued finish and are counted, and the window ends in a synchronize.  A
request is the sampler's 50 steps; the next one, with its own noise from the
seed, follows it in the same window.

The window is driven through the sampler's own `step` (wrapped to time and
record it) and, in a traced run, through forward hooks on the DiT that
record CUDA events and the host spans `dit_forward` and `sampler`.  After
the window the program's state is freed and one step drawn from the seed is
computed again by the plain reference, from the state the program began it
with (see portbench.check).
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, flops, inputs, trace
from portbench.geometry import Geometry
from portbench.manifest import Cell, metric_readers
from portbench.weights import block_tensors, dit_param_specs


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

    def wrap(self, step_fn):
        def step(denoise_fn, x, sigma, next_sigma, *args, **kw):
            if self.warm is not None and self.t_open is None:
                self.sync()
                self.on_open()
                self.t_open = time.perf_counter()
            elif self.open and time.perf_counter() - self.t_open >= self.seconds:
                raise WindowClosed
            out = step_fn(denoise_fn, x, sigma, next_sigma, *args, **kw)
            rec = StepRecord(len(self.noises) - 1, self._in_request, sigma, next_sigma, x, out)
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
    """Forward hooks on the DiT, while the window is open: a CUDA event at
    each forward's start and end, and the host spans `dit_forward` (the
    forward) and `sampler` (from one forward's end to the next one's start)."""

    def __init__(self, dit: torch.nn.Module, window: Window):
        from torch.autograd.profiler import record_function

        self.window = window
        self.starts: List[torch.cuda.Event] = []
        self.ends: List[torch.cuda.Event] = []
        self._span = None
        self._record_function = record_function
        self._handles = [dit.register_forward_pre_hook(self._pre),
                         dit.register_forward_hook(self._post)]

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


def build_engine(cell: Cell, device: str):
    """The port's engine from the cell's configuration: its DiT, denoiser and
    sampler (the encoders are not in these cells)."""
    from scail_tpu_torch.engine import VideoDiffusionEngine

    model = cell.config["model"]
    model_config = {k: model[k] for k in ("use_i2v_clip", "latent_input", "use_pose",
                                            "denoiser_config", "sampler_config") if k in model}
    model_config["network_config"] = dict(model["network_config"], params=cell.net)
    return VideoDiffusionEngine(model_config, {"bf16": cell.config["dtype"] == "bfloat16"},
                                device=device)


def load_weights(engine, cell: Cell, seed: int) -> torch.nn.Module:
    """Build the port's DiT on the meta device and give it the benchmark's
    weights for `seed` as its parameters (no copy)."""
    dit = engine.network.build("meta")
    specs = dit_param_specs(cell.net)
    want = {name: tuple(shape) for spec in specs.values() for name, shape in spec}
    have = {name: tuple(p.shape) for name, p in dit.named_parameters()}
    if want != have:
        raise RuntimeError(f"the DiT's parameters differ from the benchmark's: "
                           f"{sorted(set(want.items()) ^ set(have.items()))[:8]}")
    dtype = engine.network.config.compute_dtype
    for block, spec in specs.items():
        for name, t in block_tensors(seed, block, spec, device=engine.device, dtype=dtype).items():
            parent, _, leaf = name.rpartition(".")
            dit.get_submodule(parent)._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)
    engine.dit = dit.eval()
    return engine.dit


def launch_counts() -> Dict[str, int]:
    from scail_tpu_torch.ops import attention, quant

    return {**attention.LAUNCHES, **quant.LAUNCHES}


def reset_launch_counts() -> None:
    from scail_tpu_torch.ops import attention, quant

    attention.reset_launch_counts()
    quant.reset_launch_counts()


def expected_launches(cell: Cell, forwards: int) -> Dict[str, int]:
    L = cell.net["num_layers"]
    out: Dict[str, int] = {}
    for name, n in cell.traffic["launches_per_layer"].items():
        out[name] = out.get(name, 0) + n * L * forwards
    for name, n in cell.traffic.get("launches_per_forward", {}).items():
        out[name] = out.get(name, 0) + n * forwards
    return out


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads (portbench/metrics)."""

    steps: int                      # denoise steps in the traced window
    step_s: float                   # its seconds over its steps
    work: flops.StepWork            # the work of one step, from shapes
    trace: Optional[trace.Trace]    # the profiler's operations and spans
    forward_gaps_ms: List[float]    # device ms from a DiT forward's end to the next one's start


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
    engine = build_engine(cell, device)
    dit = load_weights(engine, cell, seed)
    net, traffic = cell.net, cell.traffic
    cond, uncond = inputs.conditioning(seed, net, traffic, device=dev)
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
        marks = ForwardMarks(dit, window)
    engine.sampler.step = window.wrap(engine.sampler.step)
    gen = torch.Generator(device=dev).manual_seed(0)  # the engine draws nothing: noise is given
    shape = inputs.latent_shape(Geometry(traffic["frames"], traffic["height"], traffic["width"]),
                                net["out_channels"])
    request = 0
    try:
        while True:
            noise = inputs.noise(seed, request, net, traffic, device=dev)
            window.begin_request(noise)
            engine.sample(gen, cond, uncond, batch_size=traffic["batch"], shape=shape,
                          noise=noise)
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
        work = flops.step_work(net, traffic)
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
            result["breakdown"] = tr.breakdown()
        traced.clear()
    else:
        result["metrics"] = {"denoise_step_s": {"value": step_s, "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}

    # the program's state goes before the reference runs
    del dit
    engine.dit = None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pick = random.Random(seed).randrange(steps)
    t0 = time.perf_counter()
    compared, control_gaps = check.compare(cell, seed, window, pick, cond, uncond, dev, control)
    compared["launch_gap"] = {
        # the kernels run on the card only: a CPU run launches none
        "value": check.launch_gap(launches, expected_launches(cell, steps if cuda else 0)),
        "limit": 0}
    log(f"reference step {window.steps[pick].step} of request {window.steps[pick].request}: "
        f"{time.perf_counter() - t0:.1f} s")
    result["correct"] = check.passes(compared)
    if control:
        result["control"] = control_gaps
    result["compared"] = compared
    return result

