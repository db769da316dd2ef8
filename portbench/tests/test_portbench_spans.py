"""The readers of the port's spans (program_spans.py and the seven metrics
that read them) on synthetic records and a synthetic trace."""

import pytest

from portbench import flops, program_spans, trace
from portbench.harness import Readings
from portbench.manifest import load_cell, metric_reader
from scail_tpu_torch.utils import profiling

SPAN_METRICS = ("self_attn_ms.sample", "cross_attn_ms.sample", "mlp_ms.sample",
                "dit_outer_ms.sample", "sampler_update_ms.sample", "program_idle_ms.sample",
                "imports_s.setup")
H0 = 50_000_000_000          # host ns of the first step's start
OFFSET = -42.0               # trace seconds = host seconds + OFFSET
MS = 1_000_000               # ns


def _records(device=True):
    """Two steps of 1,000 ms, two layers: a forward of 989 ms (the first
    step) and 990 ms holding, a layer, self-attention 300, cross-attention
    50 and MLP 120 ms; the host ahead by nothing, so host and device
    intervals agree.  Set-up imports 1.5 s on the host."""
    out = [profiling.Span("setup.imports", None, -1, -1, 0, 1500 * MS)]

    def add(name, parent, t0, ms, request, step):
        out.append(profiling.Span(name, parent, request, step, t0, t0 + int(ms * MS),
                                  device_ms=ms if device else None))
        return len(out) - 1

    for k in range(2):
        t = H0 + k * 1000 * MS
        step = add("sampler.step", None, t, 1000, 0, k)
        fwd = add("dit.forward", step, t + 5 * MS, 989 if k == 0 else 990, 0, k)
        u = t + 30 * MS
        for _ in range(2):
            for name, ms in (("dit.self_attn", 300), ("dit.cross_attn", 50), ("dit.mlp", 120)):
                add(name, fwd, u, ms, 0, k)
                u += ms * MS
    for s, own in zip(out, profiling.self_times(out)):
        s.self_ms = own
    return out


def _trace(jitter_s=(3e-6, 5e-6)):
    """Device work over both steps but four idle gaps: 2 ms at the window's
    start (before any span), 1 ms in step 0's first self-attention, 0.5 ms
    in step 1's MLP and 0.25 ms in step 1's sampler update."""
    t0 = H0 / 1e9 + OFFSET
    gaps = [(t0 - 0.002, t0), (t0 + 0.040, t0 + 0.041), (t0 + 1.800, t0 + 1.8005),
            (t0 + 1.997, t0 + 1.99725)]
    ops, t = [], t0 - 0.002
    for a, b in gaps[1:]:
        ops.append(("elementwise_kernel", max(t, t0), a))
        t = b
    ops.append(("elementwise_kernel", t, t0 + 2.0))
    spans = [("dit_forward", t0 + k + 0.005 + j, t0 + k + 0.995) for k, j in zip(range(2),
                                                                                jitter_s)]
    return trace.Trace(ops=ops, spans=spans, window=(t0 - 0.002, t0 + 2.0))


def _readings(tr):
    cell = load_cell("sample-1p3b-dense-81f")
    return Readings(steps=2, step_s=1.0, work=flops.step_work(cell.net, cell.traffic),
                    trace=tr, forward_gaps_ms=[0.25])


def _read(r):
    return {name: metric_reader(name).read(r) for name in SPAN_METRICS}


def _recorded(monkeypatch, records):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    counts = {}
    for s in records:
        counts[s.name] = counts.get(s.name, 0) + 1
    monkeypatch.setattr(profiling, "counts", lambda: counts)


def test_the_readers_on_synthetic_spans_and_trace(monkeypatch):
    _recorded(monkeypatch, _records())
    got = _read(_readings(_trace()))
    # every sampling reader leaves the window's first step out
    assert got == {"self_attn_ms.sample": pytest.approx(600.0),
                   "cross_attn_ms.sample": pytest.approx(100.0),
                   "mlp_ms.sample": pytest.approx(240.0),
                   "dit_outer_ms.sample": pytest.approx(50.0),
                   "sampler_update_ms.sample": pytest.approx(10.0),
                   "program_idle_ms.sample": pytest.approx(0.5 + 0.25),
                   "imports_s.setup": pytest.approx(1.5)}
    # the sub-blocks', the forward's and the step's self times close on the step
    parts = ("self_attn_ms.sample", "cross_attn_ms.sample", "mlp_ms.sample",
             "dit_outer_ms.sample", "sampler_update_ms.sample")
    assert sum(got[k] for k in parts) == pytest.approx(1000.0)


def test_a_wide_clock_residual_raises(monkeypatch):
    _recorded(monkeypatch, _records())
    with pytest.raises(ValueError, match="spreads"):
        metric_reader("program_idle_ms.sample").read(_readings(_trace(jitter_s=(0.0, 1e-3))))


def test_one_step_gives_no_sampler_update(monkeypatch):
    # the window's one step is its first, which every sampling reader leaves out
    _recorded(monkeypatch, [s for s in _records() if s.step <= 0])
    got = _read(_readings(_trace()))
    assert got == dict(dict.fromkeys(SPAN_METRICS), **{"imports_s.setup": pytest.approx(1.5)})


def test_nothing_recorded_reads_none():
    got = _read(_readings(_trace()))
    assert got == dict.fromkeys(SPAN_METRICS)


def test_spans_without_device_times_read_only_the_host_clock(monkeypatch):
    # a CPU run: the spans record host times only
    _recorded(monkeypatch, _records(device=False))
    got = _read(_readings(None))
    assert {k for k, v in got.items() if v is not None} == {"imports_s.setup"}


def test_a_port_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.profiling() is None
    assert _read(_readings(_trace())) == dict.fromkeys(SPAN_METRICS)


def test_the_readers_are_entries_of_every_cell():
    for cell in ("sample-1p3b-dense-81f", "sample-14b-dense-81f", "sample-1p3b-sta-81f"):
        names = [m["name"] for m in load_cell(cell).per_layer]
        assert names[-len(SPAN_METRICS):] == list(SPAN_METRICS)
