"""The per-layer metrics' readers and the breakdown on a synthetic trace."""

import pytest

from portbench import flops, trace
from portbench.harness import Readings
from portbench.manifest import load_cell, metric_readers


def _trace():
    # two steps of 1 s: a GEMM, K1, K9 and glue, a 10 ms host gap in each
    ops, spans = [], []
    for k in range(2):
        t = k * 1.0
        ops += [("sm90_xmma_gemm_bf16bf16", t, t + 0.2),
                ("void flash_fwd_kernel<1>(Params)", t + 0.2, t + 0.8),
                ("adaln_ln_kernel<6>", t + 0.8, t + 0.85),
                ("elementwise_kernel", t + 0.85, t + 0.95),
                ("Memcpy DtoD", t + 0.96, t + 0.99)]
        spans += [("dit_forward", t, t + 0.95), ("sampler", t + 0.95, t + 1.0)]
    return trace.Trace(ops=ops, spans=spans, window=(0.0, 2.0))


def test_union_and_gaps():
    assert trace.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    tr = _trace()
    assert tr.busy_s() == pytest.approx(2 * 0.98)
    assert [round(b - a, 6) for a, b in tr.gaps()] == [0.01, 0.01, 0.01, 0.01]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["group:flash_attention", pytest.approx(1.2)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert {name for name, _ in bd["idle_gaps"]} == {"sampler"}
    assert tr.span_at(5.0) == "other"


def test_an_architectures_groups_come_before_the_frozen_ones():
    bd = _trace().breakdown((("self_attention", ("flash_fwd",)),) + trace.GROUPS)
    assert bd["device_ops"][0] == ["group:self_attention", pytest.approx(1.2)]
    assert _trace().breakdown() == _trace().breakdown(trace.GROUPS)


def test_readers_on_a_synthetic_trace():
    cell = load_cell("sample-1p3b-dense-81f")
    work = flops.step_work(cell.net, cell.traffic)
    r = Readings(steps=2, step_s=1.0, work=work, trace=_trace(), forward_gaps_ms=[0.4, 0.2])
    got = {name: reader.read(r) for name, reader in metric_readers(cell).items()}
    assert got["sampler_ms.sample"] == pytest.approx(0.3)
    assert got["elementwise_ms.sample"] == pytest.approx(1e3 * (0.1 + 0.03))
    assert got["idle_pct.sample"] == pytest.approx(2.0)
    assert got["attn_roofline.sample"] == pytest.approx(100 * work.self_attn_bound_s / 0.6)
    assert got["gemm_roofline.sample"] == pytest.approx(100 * work.linear_bound_s / 0.2)
    assert got["mfu.sample"] == pytest.approx(100 * work.model_flops / 989e12)


def test_readers_find_nothing_without_a_trace():
    cell = load_cell("sample-1p3b-sta-81f")
    work = flops.step_work(cell.net, cell.traffic)
    r = Readings(steps=1, step_s=1.0, work=work, trace=None, forward_gaps_ms=[])
    got = {name: reader.read(r) for name, reader in metric_readers(cell).items()}
    assert {k for k, v in got.items() if v is not None} == {"mfu.sample"}
