"""The port's spans (scail_tpu_torch/utils/profiling.py): off by default,
recording under a profiler without opening profiler ranges, ranges under
profile_trace, exception safety, the self-time arithmetic, the mapping of
the host clock onto a trace's, and the spans of a tiny DiT sampled on the
CPU."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scail_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING_SPANS = ("sampler.step", "dit.forward", "dit.self_attn", "dit.cross_attn", "dit.mlp")


@pytest.fixture(autouse=True)
def clean_records():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _span(name, parent, device_ms, start_ns=0, end_ns=1):
    return profiling.Span(name, parent, 0, 0, start_ns, end_ns, device_ms=device_ms)


def test_off_returns_one_no_op_and_records_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("an off span did work")

    # an off span reads no clock, makes no CUDA event and opens no range
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace())
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.annotate("dit.forward")
    assert profiling.annotate("sampler.step") is first
    with profiling.annotate("dit.mlp"):
        with first:
            torch.ones(4).sum()
    assert profiling.spans() == [] and profiling.counts() == {}


def test_a_plain_profiler_records_spans_without_opening_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("sampler.step") as outer:
            with profiling.annotate("dit.forward") as inner:
                torch.ones(64, 64) @ torch.ones(64, 64)
            torch.ones(8).sum()
    assert profiling.counts() == {"sampler.step": 1, "dit.forward": 1}
    got = profiling.spans()
    assert got == [outer, inner]
    assert (outer.parent, inner.parent) == (None, 0)
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert outer.host_ms > 0 and outer.events is None and outer.device_ms is None
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names
    assert not names & {"sampler.step", "dit.forward"}
    # the profiler is off again, so are the spans
    with profiling.annotate("dit.mlp"):
        pass
    assert profiling.counts() == {"sampler.step": 1, "dit.forward": 1}


def test_enable_records_without_a_profiler():
    profiling.enable()
    with profiling.annotate("dit.mlp"):
        pass
    profiling.enable(False)
    with profiling.annotate("dit.mlp"):
        pass
    assert profiling.counts() == {"dit.mlp": 1}


def test_profile_trace_shows_spans_as_ranges_and_records_them(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        with profiling.annotate("dit.self_attn"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(profiling.trace_path(str(tmp_path))))
    assert any(e.get("name") == "dit.self_attn" for e in trace["traceEvents"])
    assert profiling.counts() == {"dit.self_attn": 1}
    # outside profile_trace a profiler's spans open no range again
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("dit.self_attn"):
            torch.ones(4).sum()
    assert "dit.self_attn" not in {e.name for e in prof.events()}


def test_an_exception_through_nested_spans_leaves_them_closed():
    profiling.enable()
    with pytest.raises(RuntimeError, match="window"):
        with profiling.annotate("sampler.step"):
            with profiling.annotate("dit.forward"):
                with profiling.annotate("dit.mlp"):
                    raise RuntimeError("window closed")
    with profiling.annotate("sampler.step"):
        pass
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("sampler.step", None), ("dit.forward", 0),
                                                 ("dit.mlp", 1), ("sampler.step", None)]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in got)
    assert got[0].end_ns >= got[1].end_ns >= got[2].end_ns


class _FakeEvent:
    """A timing event on a fake card whose clock moves 1 ms a record."""

    clock = 0
    made = 0
    passed = True   # whether the card has passed every record

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        assert stream == "stream"
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def synchronize(self):
        pass

    def query(self):
        return _FakeEvent.passed

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.clock = _FakeEvent.made = 0
    _FakeEvent.passed = True
    profiling._REC.pool.clear()
    yield
    profiling.reset()
    profiling._REC.pool.clear()


def _layer_spans():
    with profiling.annotate("dit.forward"):
        with profiling.annotate("dit.self_attn") as a:
            pass
        with profiling.annotate("dit.cross_attn", follows=a) as b:
            pass
        with profiling.annotate("dit.mlp", follows=b):
            pass
    return a, b


def test_spans_that_follow_one_another_share_their_boundary_event(fake_card):
    profiling.enable()
    a, b = _layer_spans()
    # one event a boundary: 6 for 4 spans, the cross-attention's start the
    # self-attention's end
    assert _FakeEvent.made == 6 and b.events[0] is a.events[1] and a.end_taken
    got = profiling.spans()
    assert [(s.name, s.device_ms, s.self_ms) for s in got] == [
        ("dit.forward", 5.0, 2.0), ("dit.self_attn", 1.0, 1.0), ("dit.cross_attn", 1.0, 1.0),
        ("dit.mlp", 1.0, 1.0)]
    # read, the events go back to the pool once each, and the next spans take them
    assert len({id(e) for e in profiling._REC.pool}) == len(profiling._REC.pool) == 6
    _layer_spans()
    assert _FakeEvent.made == 6
    assert [s.device_ms for s in profiling.spans() if s.name == "dit.cross_attn"] == [1.0, 1.0]


def test_a_span_follows_only_a_recorded_closed_span(fake_card):
    _FakeEvent.passed = False   # no event reused
    profiling.enable()
    with profiling.annotate("dit.self_attn") as a:
        with profiling.annotate("dit.cross_attn", follows=a) as b:
            pass
    with profiling.annotate("dit.mlp", follows=None) as c:
        pass
    assert not a.end_taken and not b.end_taken and _FakeEvent.made == 6


def test_each_outermost_span_resolves_what_the_card_has_passed(fake_card):
    profiling.enable()
    _layer_spans()
    # the card has not passed the first forward: nothing resolved, new events
    _FakeEvent.passed = False
    _layer_spans()
    assert _FakeEvent.made == 12 and profiling._REC.resolved == 0
    # it has: the next outermost span resolves both forwards and reuses their events
    _FakeEvent.passed = True
    _layer_spans()
    assert _FakeEvent.made == 12 and profiling._REC.resolved == 8
    got = profiling.spans()
    assert [s.device_ms for s in got if s.name == "dit.forward"] == [5.0, 5.0, 5.0]
    assert [s.device_ms for s in got if s.name == "dit.cross_attn"] == [1.0, 1.0, 1.0]
    assert all(s.events is None for s in got) and len(profiling._REC.pool) == 12


def test_a_checkpoint_recompute_records_no_span():
    from torch.utils.checkpoint import checkpoint

    def block(x):
        with profiling.annotate("dit.mlp"):
            return (x * 2).sin()

    profiling.enable()
    x = torch.ones(3, requires_grad=True)
    checkpoint(block, x, use_reentrant=False).sum().backward()
    assert profiling.counts() == {"dit.mlp": 1}
    assert x.grad is not None


def test_spans_past_the_cap_are_not_recorded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.annotate("dit.mlp"):
            pass
    assert profiling.counts() == {"dit.mlp": 3}
    profiling.reset()
    with profiling.annotate("dit.mlp"):
        pass
    assert profiling.counts() == {"dit.mlp": 1}


def test_profile_trace_starts_from_no_record(tmp_path):
    profiling.enable()
    with profiling.annotate("dit.mlp"):
        pass
    with profiling.profile_trace(str(tmp_path)):
        assert profiling.counts() == {}
        with profiling.annotate("dit.self_attn"):
            pass
    assert profiling.counts() == {"dit.self_attn": 1}


def test_self_time_is_the_span_less_its_children():
    records = [_span("sampler.step", None, 100.0), _span("dit.forward", 0, 90.0),
               _span("dit.self_attn", 1, 50.0), _span("dit.cross_attn", 1, 10.0),
               _span("dit.mlp", 1, 20.0), _span("setup.imports", None, None)]
    assert profiling.self_times(records) == [pytest.approx(10.0), pytest.approx(10.0), 50.0,
                                             10.0, 20.0, None]


def test_the_clock_offset_is_recovered_and_a_wide_residual_raises():
    program = [1_000_000_000 + k * 2_400_000_000 for k in range(6)]
    jitter = [3e-6, 4e-6, 5e-6, 4e-6, 6e-6, 3e-6]
    trace = [p / 1e9 - 7.25 + j for p, j in zip(program, jitter)]
    offset, residual = profiling.clock_offset(trace[::-1], program)
    assert offset == pytest.approx(-7.25 + 4e-6, abs=1e-9)
    assert residual == pytest.approx(2e-6, abs=1e-9)
    trace[3] += 1e-3
    with pytest.raises(ValueError, match="spreads"):
        profiling.clock_offset(trace, program)
    with pytest.raises(ValueError, match="anchors"):
        profiling.clock_offset(trace[:5], program)


def test_innermost_names_the_span_the_host_was_in():
    records = [profiling.Span("sampler.step", None, 0, 0, 0, 100),
               profiling.Span("dit.forward", 0, 0, 0, 10, 90),
               profiling.Span("dit.self_attn", 1, 0, 0, 20, 40),
               profiling.Span("dit.mlp", 1, 0, 0, 50, 60),
               profiling.Span("sampler.step", None, 0, 1, 200, 300)]
    got = profiling.innermost(records, [5, 25, 45, 55, 95, 150, 250, -1])
    assert [s and s.name for s in got] == ["sampler.step", "dit.self_attn", "dit.forward",
                                           "dit.mlp", "sampler.step", None, "sampler.step",
                                           None]


def test_a_tiny_dit_sampled_under_a_profiler_records_each_layer_boundary():
    from scail_tpu_torch.models.dit import DiT, DiTConfig
    from scail_tpu_torch.utils.registry import instantiate_from_config

    layers = 3
    cfg = DiTConfig(hidden_size=64, num_layers=layers, num_heads=2, inner_hidden_size=128,
                    time_embed_dim=64, text_dim=32, clip_dim=16, share_adaln=True,
                    use_i2v_clip=True, dtype="float32")
    model = DiT(cfg)
    model.init_weights_(torch.Generator().manual_seed(0))
    sampler = instantiate_from_config({
        "target": "sgm.modules.diffusionmodules.sampling.RFSampler",
        "params": dict(hunyuan_schedule=True, shift_scale=5, num_steps=2, discretization_config={
            "target": "sgm.modules.diffusionmodules.discretizer.RFDiscretization"},
            guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                           "params": {"scale": 4}})})
    g = torch.Generator().manual_seed(1)
    T, H, W = 3, 8, 8
    cond = {"crossattn": torch.randn(1, 16, 32, generator=g),
            "ref_concat": torch.randn(1, 1, 16, H, W, generator=g),
            "image_clip_features": torch.randn(1, 9, 16, generator=g),
            "concat_smpl_render": torch.randn(1, T, 16, H // 2, W // 2, generator=g)}
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]))

    def denoise_fn(x, sigma, c, cfg_scale=None, **kw):
        return model(x, sigma, c["crossattn"], ref_concat=c["ref_concat"],
                     concat_smpl_render=c["concat_smpl_render"],
                     image_clip_features=c["image_clip_features"])

    profiling.reset()  # building the sampler may have recorded setup.imports
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        sampler(denoise_fn, torch.randn(1, T, 16, H, W, generator=g), cond, uc)
    assert profiling.counts() == {"sampler.step": 2, "dit.forward": 2,
                                  "dit.self_attn": 2 * layers, "dit.cross_attn": 2 * layers,
                                  "dit.mlp": 2 * layers}
    got = profiling.spans()
    assert len({s.request for s in got}) == 1
    assert sorted({s.step for s in got}) == [0, 1]
    for s in got:
        parent = None if s.parent is None else got[s.parent]
        want = {"sampler.step": None, "dit.forward": "sampler.step"}.get(s.name, "dit.forward")
        assert (parent and parent.name) == want, s
        assert parent is None or parent.step == s.step
    # within a forward: each layer's three spans in order, one after another
    first = [s.name for s in got if s.step == 0]
    assert first == ["sampler.step", "dit.forward"] + ["dit.self_attn", "dit.cross_attn",
                                                       "dit.mlp"] * layers
    assert not {e.name for e in prof.events()} & set(SAMPLING_SPANS)


def test_setup_imports_is_recorded_once_a_process_with_no_profiler():
    code = ("from scail_tpu_torch.utils import profiling, registry\n"
            "registry.ensure_imports()\n"
            "registry.ensure_imports()\n"
            "s = profiling.spans()\n"
            "print(profiling.counts(), s[0].host_ms > 0, s[0].events)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "{'setup.imports': 1} True None"
