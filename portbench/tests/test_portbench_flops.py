"""The benchmark's work counts against the bounds of the port's kernel table
(PERF.md §6), and the frozen STA geometry against the port's planner."""

import numpy as np
import pytest

from portbench import flops
from portbench.geometry import Geometry, plan_sta
from portbench.manifest import load_cell

STA = {"tile": [3, 8], "window": [3, 2], "windowed_pose": True, "pose_kv_window": 3}


@pytest.fixture(scope="module")
def dense():
    return load_cell("sample-1p3b-dense-81f")


def test_geometry_of_an_81_frame_request():
    geo = Geometry(81, 512, 896)
    assert geo.latent == (21, 64, 112) and geo.grid == (21, 32, 56)
    assert (geo.video_len, geo.ref_len, geo.pose_len, geo.tokens) == (37632, 1792, 9408, 48832)


def test_kernel_bounds_match_the_kernel_table():
    """One layer's K1 (all pairs), K7 (the windowed calls' pairs) and K3
    (48,832 q rows x 512 text + 257 CLIP keys) at (2, 48,832, 12, 128)."""
    geo = Geometry(81, 512, 896)
    s = geo.tokens

    def ms(pairs, sq, skv):
        return 1e3 * flops.bound_s(flops.attention_flops(2, 12, 128, pairs),
                                   flops.attention_bytes(2, 12, 128, sq, skv))

    assert round(ms(s * s, s, s), 2) == 29.63
    assert round(ms(geo.attention_pairs(STA) - geo.ref_len * s, s, s), 2) == 8.12
    assert round(ms(s * (512 + 257), s, 512 + 257), 3) == 0.467


def test_step_work_of_the_dense_1p3b_step(dense):
    w = flops.step_work(dense.net, dense.traffic)
    assert w.linear_flops == pytest.approx(0.245e15, rel=0.02)
    assert w.self_attn_flops == pytest.approx(30 * 29.63e-3 * flops.BF16_PEAK_FLOPS, rel=1e-3)
    assert w.model_flops == pytest.approx(1.14e15, rel=0.01)
    # the linears' bound is their operations over the peak where they are large
    assert w.linear_bound_s == pytest.approx(w.linear_flops / flops.BF16_PEAK_FLOPS, rel=0.02)


def test_sta_work_counts_the_visited_pairs(dense):
    w = flops.step_work(dense.net, dict(dense.traffic, sta=STA))
    assert w.self_attn_flops == pytest.approx(0.273e15, rel=0.01)
    assert w.model_flops == pytest.approx(0.53e15, rel=0.01)


def test_sta_plan_of_the_cell():
    plan = plan_sta((21, 32, 56), STA)
    assert plan.ts == 1344 and plan.table.shape == (28, 11)
    assert sorted(plan.order.tolist()) == list(range(48832))


@pytest.mark.parametrize("grid,sta", [
    ((6, 32, 4), STA),
    ((6, 16, 8), {"tile": [3, 8], "window": [3, 2], "windowed_pose": True,
                  "pose_kv_window": 3}),
    ((9, 32, 4), {"tile": [3, 8], "window": [1, 2], "windowed_pose": True,
                  "pose_kv_window": 0}),
])
def test_pairs_equal_the_ports_block_mask(grid, sta):
    """The pairs the frozen plan visits, counted in original token order,
    equal the port's own statement of the STA semantics (sta_block_mask)."""
    from scail_tpu_torch.ops.sta import sta_block_mask

    T, Hp, Wp = grid
    geo = Geometry(4 * (T - 1) + 1, 16 * Hp, 16 * Wp)
    assert geo.grid == grid
    s = geo.tokens
    mask = sta_block_mask(s, grid, geo.ref_len, geo.pose_len, tuple(sta["tile"]),
                          tuple(sta["window"]), True, sta["pose_kv_window"])
    assert geo.attention_pairs(sta) == int(mask.sum())
    plan = plan_sta(grid, sta)
    mine = np.zeros((s, s), bool)
    ts, tp, sv = plan.ts, plan.ts // 4, geo.video_len
    for i in range(len(plan.table)):
        q = np.r_[i * ts:(i + 1) * ts, sv + i * tp:sv + (i + 1) * tp]
        kv = np.concatenate([np.arange(b, e) for b, e in plan.kv_rows(i, s)])
        mine[np.ix_(plan.order[q], plan.order[kv])] = True
    mine[plan.order[sv + geo.pose_len:]] = True
    assert np.array_equal(mine, mask)
