"""program_idle_ms.sample: device-idle milliseconds a step that began while
the host was inside one of the port's spans.

The trace's idle gaps (portbench.trace), each named by the innermost span
of the port (`sampler.step`, `dit.forward`, `dit.self_attn`,
`dit.cross_attn`, `dit.mlp`) whose host interval holds the gap's start.
The port's host clock is mapped onto the trace's by the median offset
between the starts of the harness's `dit_forward` spans and the port's
`dit.forward` spans (scail_tpu_torch.utils.profiling.clock_offset, which
raises where they spread over 100 us).  Summed over the window's steps but
the first (program_spans.py), over those steps."""

from portbench.program_spans import after_first_step, profiling

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    got = after_first_step()
    if got is None or r.trace is None:
        return None
    p = profiling()
    records = p.spans()
    kept = {id(s) for s in got[0]}
    program = [s.start_ns for s in records if s.name == "dit.forward"]
    anchors = [s for name, s, _ in r.trace.spans if name == "dit_forward"]
    if not program or not anchors:
        return None
    offset, _ = p.clock_offset(anchors, program)
    gaps = r.trace.gaps()
    owners = p.innermost(records, [(a - offset) * 1e9 for a, _ in gaps])
    idle = sum(b - a for (a, b), owner in zip(gaps, owners) if id(owner) in kept)
    return 1e3 * idle / got[1]
