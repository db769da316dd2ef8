"""What the traced run reads: device operations, host spans and the window.

The profiler (torch.profiler over CUPTI) records every kernel, copy and
memset the card runs in the window.  Busy time is the union of their
intervals (not their sum), idle gaps its complement inside the window, each
gap named by the benchmark's host span (`dit_forward`, `sampler`) that was
open when it began.  GROUPS is a frozen copy of the port's kernel-name
groups (its profile CLI), used for the breakdown after an architecture's
own groups (portbench/arch), if it has any.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

# host spans the harness opens around the DiT forward and the rest of a step
SPANS = ("dit_forward", "sampler")
WINDOW = "window"
# kernel-name substrings by group, first match wins
GROUPS = (("w8a16_matmul", ("w8a16_kernel",)),
          ("flash_attention_int8", ("flash_int8_kernel",)),
          ("flash_attention_norope", ("flash_fwd_kernel<0>",)),
          ("flash_attention", ("flash_fwd_kernel",)),
          ("flash_attention_bwd", ("flash_bwd_",)),
          ("sta_attention", ("sta_fwd_kernel",)),
          ("sta_attention_bwd", ("sta_bwd_",)),
          ("dual_cross_attention", ("dual_cross_kernel",)),
          ("adaln_layer_norm", ("adaln_ln_kernel",)),
          ("rotary", ("rotary_kernel",)),
          ("conv", ("fprop", "dgrad", "wgrad", "conv", "winograd")),
          ("gemm", ("gemm", "nvjet", "cutlass")),
          ("copy", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw")))

Interval = Tuple[float, float]


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def matches(name: str, patterns: Sequence[str]) -> bool:
    low = name.lower()
    return any(p in low for p in patterns)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class Trace:
    """Device operations and host spans of one window, times in seconds on
    the profiler's clock."""

    ops: List[Tuple[str, float, float]]     # (kernel or copy name, start, end)
    spans: List[Tuple[str, float, float]]   # (host span name, start, end)
    window: Interval

    def op_seconds(self, patterns: Sequence[str] = None) -> float:
        """Summed duration of the operations whose name holds a pattern (all
        operations without patterns)."""
        return sum(e - s for n, s, e in self.ops if patterns is None or matches(n, patterns))

    def busy_s(self) -> float:
        return sum(b - a for a, b in union((s, e) for _, s, e in self.ops))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> List[Interval]:
        """The idle intervals of the window: covered by no operation."""
        out, t = [], self.window[0]
        for a, b in union((s, e) for _, s, e in self.ops):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def span_at(self, t: float) -> str:
        for name, s, e in self.spans:
            if s <= t < e:
                return name
        return "other"

    def breakdown(self, groups=GROUPS, top: int = 5) -> Dict[str, List[list]]:
        """The device operations that took most time, `top` groups (of
        `groups`, first match wins) then `top` kernels, and the 2 * top
        longest idle gaps by host span."""
        by_group: Dict[str, float] = {}
        kernels: Dict[str, float] = {}
        for n, s, e in self.ops:
            g = group_of(n, groups)
            by_group[g] = by_group.get(g, 0.0) + (e - s)
            kernels[n] = kernels.get(n, 0.0) + (e - s)
        ops = [[f"group:{g}", v]
               for g, v in sorted(by_group.items(), key=lambda kv: -kv[1])[:top]]
        ops += [[n[:160], v] for n, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:2 * top]
        return {"device_ops": ops, "idle_gaps": [[self.span_at(a), b - a] for a, b in gaps]}


def read_profile(events) -> Trace:
    """A Trace from a torch.profiler run's events(): device events are the
    operations (the GPU side of the harness's own annotations excluded), CPU
    events named in SPANS the host spans, and the one named WINDOW the
    window."""
    import torch

    ops, spans, window = [], [], None
    names = set(SPANS) | {WINDOW}
    for ev in events:
        start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name not in names:
                ops.append((ev.name, start, end))
        elif ev.name == WINDOW:
            window = (start, end)
        elif ev.name in SPANS:
            spans.append((ev.name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    if not ops:
        raise RuntimeError("the profiler recorded no device operation in the window")
    return Trace(ops=sorted(ops, key=lambda o: o[1]), spans=spans, window=window)
