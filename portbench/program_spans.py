"""The port's own spans, as the per-layer readers of metrics/ read them.

scail_tpu_torch.utils.profiling records a span at each layer boundary of
the sampling path while a profiler records in the process, as it does in
the traced window: `sampler.step`, `dit.forward` inside it, and in each DiT
layer `dit.self_attn`, `dit.cross_attn` and `dit.mlp`; `setup.imports` on
the host clock in every run.  Every reader of the sampling spans leaves out
the window's first step: it holds the profiler's start-up, where the card
waits on the host.  Where the port records no spans (a checkout from before
them), or the window held one step, every function here returns None, and
raises nothing.
"""

STEP = "sampler.step"


def profiling():
    """The port's profiling module, None where it records no spans."""
    try:
        from scail_tpu_torch.utils import profiling as p
    except ImportError:
        return None
    return p if all(hasattr(p, f) for f in ("spans", "clock_offset", "innermost")) else None


def after_first_step():
    """(records, steps): the records of the sampling spans after the first
    recorded step, and the number of steps they hold; None where the port
    records no spans or recorded fewer than two steps."""
    p = profiling()
    if p is None:
        return None
    records = p.spans()
    steps = [(s.request, s.step) for s in records if s.name == STEP]
    if len(steps) < 2:
        return None
    return [s for s in records if s.request >= 0 and (s.request, s.step) != steps[0]], \
        len(steps) - 1


def per_step_ms(name: str, self_time: bool = False):
    """Device ms a step in the spans named `name` (their self time with
    `self_time`), over the recorded steps but the first; None where they
    have no device time (a CPU run)."""
    got = after_first_step()
    if got is None:
        return None
    records, steps = got
    ms = [s.self_ms if self_time else s.device_ms for s in records if s.name == name]
    ms = [v for v in ms if v is not None]
    return sum(ms) / steps if ms else None
