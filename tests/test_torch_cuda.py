"""Kernel-vs-plain checks that need an NVIDIA GPU (marker `cuda`).

Run on a machine with the card (tests/conftest.py imports jax, which the port's
machine need not have):  python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
Without a card each test skips (decided inside the fixture, never at import).
Limits: those of scail_tpu_torch.ops.attention.error_vs_plain, scaled to the
plain output (bf16 rounding of q, of P before P V and of the output).
"""

import numpy as np
import pytest
import torch

from scail_tpu_torch.ops import attention as A


def _assert_close(got, want, lse=False):
    err = A.error_vs_plain(got, want, lse=lse)
    assert err["ok"], err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [None, True, False])
def test_flash_attention_kernel_matches_plain(cuda, rope):
    q, k, v = _rnd(cuda, 2, 150, 2, 128), _rnd(cuda, 2, 176, 2, 128), _rnd(cuda, 2, 176, 2, 128)
    tabs = None
    if rope is not None:
        ang = torch.randn(150, 64, generator=cuda, device="cuda")
        ang = ang.repeat_interleave(2, -1) if rope else torch.cat([ang, ang], -1)
        tabs = (ang.cos(), ang.sin())
    before = dict(A.LAUNCHES)
    out, lse = A.flash_attention(q, k, v, rope=tabs, rope_interleaved=bool(rope))
    torch.cuda.synchronize()
    name = "flash_attention" if rope is None else "flash_attention_rope"
    assert A.LAUNCHES[name] == before[name] + 1
    want, want_lse = A.flash_attention_plain(q.float(), k.float(), v.float(), rope=tabs,
                                             rope_interleaved=bool(rope))
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)


def _tables(gen, s, interleaved):
    """Rotary tables (s, 128) f32 whose angles differ in every row."""
    ang = torch.randn(s, 64, generator=gen, device="cuda")
    ang = ang.repeat_interleave(2, -1) if interleaved else torch.cat([ang, ang], -1)
    return ang.cos(), ang.sin()


def _check_flash(q, k, v, rope=None, interleaved=True):
    """K1 (rope tables given) or K2 against its plain version on the same bf16
    inputs, so that both round q and P where the Pallas kernels do, with its
    launch counted once; then a second call for the same bits."""
    name = "flash_attention" if rope is None else "flash_attention_rope"
    before = dict(A.LAUNCHES)
    out, lse = A.flash_attention(q, k, v, rope=rope, rope_interleaved=interleaved)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in A.LAUNCHES.items() if c != before[n]} == {name: 1}
    want, want_lse = A.flash_attention_plain(q, k, v, rope=rope, rope_interleaved=interleaved)
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)
    again, again_lse = A.flash_attention(q, k, v, rope=rope, rope_interleaved=interleaved)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True], ids=["norope", "interleaved"])
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("skv", [1, 63, 64, 65, 127, 128, 129])
def test_flash_attention_ragged_tiles(cuda, sq, skv, rope):
    """Both sides of the 64-row kv stages and of the 128-row q tile (two
    consumer warpgroups of 64): every q and kv tail, Sq != Skv."""
    q = _rnd(cuda, 1, sq, 2, 128)
    k, v = _rnd(cuda, 1, skv, 2, 128), _rnd(cuda, 1, skv, 2, 128)
    _check_flash(q, k, v, _tables(cuda, sq, True) if rope else None)


@pytest.mark.cuda
@pytest.mark.parametrize("interleaved", [True, False])
def test_flash_attention_ropes_every_row_in_both_modes(cuda, interleaved):
    """Tables that differ in every row, both rope modes, 1,100 q rows x 64
    heads: a q tile read by the products before its rotation lands (a
    missing proxy fence or barrier) is off by the whole rotary."""
    q, k, v = (_rnd(cuda, 1, 1100, 64, 128) for _ in range(3))
    _check_flash(q, k, v, _tables(cuda, 1100, interleaved), interleaved)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True], ids=["norope", "interleaved"])
def test_flash_attention_takes_head_strided_views(cuda, rope):
    """q, k and v as the DiT hands them over: (b, s, n, 128) column slices of
    one (b, s, 3 n 128) qkv projection; the same bits as on contiguous copies."""
    b, s, n = 2, 300, 3
    qkv = _rnd(cuda, b, s, 3 * n * 128).unflatten(-1, (3 * n, 128))
    q, k, v = qkv[:, :, :n], qkv[:, :, n:2 * n], qkv[:, :, 2 * n:]
    tabs = _tables(cuda, s, True) if rope else None
    _check_flash(q, k, v, tabs)
    got = A.flash_attention(q, k, v, rope=tabs)
    want = A.flash_attention(*(t.contiguous() for t in (q, k, v)), rope=tabs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("interleaved", [True, False])
def test_flash_attention_at_40_heads(cuda, interleaved):
    """The 14B's 40 heads at CFG batch 2, q and kv tails."""
    q, k, v = _rnd(cuda, 2, 700, 40, 128), _rnd(cuda, 2, 700, 40, 128), \
        _rnd(cuda, 2, 700, 40, 128)
    _check_flash(q, k, v, _tables(cuda, 700, interleaved), interleaved)


@pytest.mark.cuda
def test_flash_attention_on_the_ref_row_grid(cuda):
    """K2 as the STA path calls it: the last 1,792 q rows (a strided view)
    against a longer kv run, 2 x 12 heads: 14 x 24 CTAs, under three waves."""
    k, v = _rnd(cuda, 2, 6000, 12, 128), _rnd(cuda, 2, 6000, 12, 128)
    q = _rnd(cuda, 2, 6000, 12, 128)[:, -1792:]
    _check_flash(q, k, v)


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_rows_off_16_bytes(cuda):
    """TMA reads rows on 16-byte strides: a head or row stride that is no
    multiple of 8 bf16 values raises before any launch."""
    before = dict(A.LAUNCHES)
    wide = _rnd(cuda, 1, 64, 2, 132)[..., :128]  # head stride 132 values = 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention(wide, wide, wide)
    rows = _rnd(cuda, 1, 64, 2 * 128 + 4)[..., :256].unflatten(-1, (2, 128))  # row 520 bytes
    with pytest.raises(ValueError, match="16-byte"):
        A.flash_attention(rows, rows, rows)
    assert A.LAUNCHES == before


@pytest.mark.cuda
def test_dual_cross_attention_kernel_matches_plain(cuda):
    q = _rnd(cuda, 2, 200, 2, 128)
    kv = [_rnd(cuda, 2, s, 2, 128) for s in (37, 37, 21, 21)]
    out = A.dual_cross_attention_fused(q, *kv)
    torch.cuda.synchronize()
    want = A.dual_cross_attention_plain(q.float(), *(t.float() for t in kv))
    _assert_close(out, want)


def _check_dual(q, k1, v1, k2, v2, rows=None):
    """K3 against its plain version on the same bf16 inputs (on the q rows of
    each slice in `rows`, else on all), its launch counted once; then a
    second call for the same bits."""
    before = dict(A.LAUNCHES)
    out = A.dual_cross_attention_fused(q, k1, v1, k2, v2)
    torch.cuda.synchronize()
    assert ({n: c - before[n] for n, c in A.LAUNCHES.items() if c != before[n]}
            == {"dual_cross_attention": 1})
    for sl in rows or (slice(None),):
        _assert_close(out[:, sl], A.dual_cross_attention_plain(q[:, sl], k1, v1, k2, v2))
    assert torch.equal(out, A.dual_cross_attention_fused(q, k1, v1, k2, v2))


def _dual_kv(gen, b, s, n, chunked):
    """k, v of one stream: contiguous, or chunk views of one (b, s, 2 n 128)
    projection (row stride 2 x hidden), as the DiT passes them."""
    if chunked:
        return _rnd(gen, b, s, 2 * n * 128).unflatten(-1, (2 * n, 128)).chunk(2, dim=2)
    return _rnd(gen, b, s, n, 128), _rnd(gen, b, s, n, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s1", [1, 64, 65, 512])
@pytest.mark.parametrize("s2", [1, 257])
def test_dual_cross_attention_ragged_streams(cuda, s1, s2):
    """Every kv tail of either stream (a tile of 1 live row, a whole tile, one
    row past it, the DiT's 512 and 257) at 130 q rows: a q tile whose second
    warpgroup holds 2 live rows."""
    q = _rnd(cuda, 2, 130, 2, 128)
    _check_dual(q, *_dual_kv(cuda, 2, s1, 2, False), *_dual_kv(cuda, 2, s2, 2, False))


@pytest.mark.cuda
def test_dual_cross_attention_loops_items_with_ragged_q_tiles(cuda):
    """More (head, q tile) items than SMs, so each persistent CTA walks
    several, every ninth with 76 live rows (1,100 = 8 x 128 + 76), k/v as
    chunk views."""
    q = _rnd(cuda, 1, 1100, 64, 128)
    _check_dual(q, *_dual_kv(cuda, 1, 512, 64, True), *_dual_kv(cuda, 1, 257, 64, True))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [12, 40])
def test_dual_cross_attention_at_the_main_shapes(cuda, heads):
    """The 1.3B's 12 and the 14B's 40 heads at CFG batch 2 and 48,832 q rows
    against (512, 257) keys given as the DiT's chunk views, checked on the
    first and the last 1,024 rows."""
    s = 48832
    q = _rnd(cuda, 2, s, heads, 128)
    _check_dual(q, *_dual_kv(cuda, 2, 512, heads, True), *_dual_kv(cuda, 2, 257, heads, True),
                rows=(slice(0, 1024), slice(s - 1024, s)))


def _bwd_case(gen, strided_v=False):
    """Ragged K5 inputs: q/dO (1, 150, 2, 128), k/v (1, 176, 2, 128), bf16, with
    the forward's output and LSE from the kernel."""
    q, k, do = _rnd(gen, 1, 150, 2, 128), _rnd(gen, 1, 176, 2, 128), _rnd(gen, 1, 150, 2, 128)
    # v as the DiT passes it: a head-strided slice of a wider projection
    v = _rnd(gen, 1, 176, 2, 3 * 128)[..., 128:256] if strided_v else _rnd(gen, 1, 176, 2, 128)
    out, lse = A.flash_attention(q, k, v)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("strided_v", [False, True])
def test_flash_attention_bwd_kernels_match_plain(cuda, strided_v):
    q, k, v, out, lse, do = _bwd_case(cuda, strided_v)
    before = dict(A.LAUNCHES)
    got = A.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert A.LAUNCHES[name] == before[name] + 1
    want = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                       do.float())
    for g, w in zip(got, want):
        _assert_close(g, w)
    again = A.flash_attention_bwd(q, k, v, out, lse, do)  # two passes, no atomics
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_once(q, k, v, out, lse, do):
    """K5 once, with its exact launch counts checked: (dq, dk, dv)."""
    before = dict(A.LAUNCHES)
    got = A.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name in A.LAUNCHES:
        extra = name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
        assert A.LAUNCHES[name] == before[name] + extra, name
    return got


def _check_bwd(q, k, v, out, lse, do):
    """K5 against its plain version on the same bf16 inputs, so that both round
    q2, P and dS where the Pallas kernels do (on f32 copies one q row leaves
    the bf16 rounding of each product unaveraged), then a second call for the
    same bits."""
    got = _bwd_once(q, k, v, out, lse, do)
    want = A.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        _assert_close(g, w)
    again = _bwd_once(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 63, 65, 129, 150])
@pytest.mark.parametrize("skv", [64, 176, 200])
def test_flash_attention_bwd_ragged_tiles(cuda, sq, skv):
    """Both sides of K5's 64-row tiles and its 128-row K/V block: every q and
    kv tail is masked, nothing past it is written, and a second call gives the
    same bits."""
    q, do = _rnd(cuda, 1, sq, 2, 128), _rnd(cuda, 1, sq, 2, 128)
    k, v = _rnd(cuda, 1, skv, 2, 128), _rnd(cuda, 1, skv, 2, 128)
    out, lse = A.flash_attention(q, k, v)
    _check_bwd(q, k, v, out, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("sq, skv, heads", [(1100, 300, 64), (1792, 6000, 2)])
def test_flash_attention_bwd_wide_and_ref_row_grids(cuda, sq, skv, heads):
    """The dq pass's two CTA shapes: 128 q rows a CTA where the grid fills the
    card four times over (1,100 rows x 64 heads), 64 rows otherwise (the STA
    path's 1,792 ref rows against a longer kv run, at two heads)."""
    k, v = _rnd(cuda, 1, skv, heads, 128), _rnd(cuda, 1, skv, heads, 128)
    q = _rnd(cuda, 1, max(sq, skv), heads, 128)[:, -sq:]  # the last rows, as STA slices them
    do = _rnd(cuda, 1, sq, heads, 128)
    out, lse = A.flash_attention(q, k, v)
    _check_bwd(q, k, v, out, lse, do)


@pytest.mark.cuda
def test_flash_attention_bwd_kernels_take_head_strided_views(cuda):
    """q/k/v/dO as the DiT hands them over: (b, s, n, 128) column slices of a
    (b, s, 3 n 128) projection.  The kernels read them through their strides
    and give the same bits as on contiguous copies."""
    b, sq, skv, n = 2, 150, 200, 3
    scale = 128 ** -0.5
    qkv = _rnd(cuda, b, sq, 3 * n * 128).unflatten(-1, (3 * n, 128))
    kv = _rnd(cuda, b, skv, 3 * n * 128).unflatten(-1, (3 * n, 128))
    q, do, k, v = qkv[:, :, :n], qkv[:, :, n:2 * n], kv[:, :, n:2 * n], kv[:, :, 2 * n:]
    lse2 = torch.randn(b, n, sq, generator=cuda, device="cuda") + 8.0
    delta = torch.randn(b, n, sq, generator=cuda, device="cuda")
    outs = []
    for ops in ((q, k, v, do), tuple(t.contiguous() for t in (q, k, v, do))):
        dq = A.flash_attention_bwd_dq(*ops, lse2, delta, scale=scale)
        outs.append((dq, *A.flash_attention_bwd_dkv(*ops, lse2, delta)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("interleaved", [True, False])
def test_attention_gradients_on_the_card_match_the_plain_path(cuda, interleaved):
    """attention(rope=...) through its autograd Function on the card (K1
    forward, K5 backward) against the same Function on CPU copies of the same
    bf16 inputs, where it runs the plain versions: the same bf16 rounding of
    the roped k and of the rope transposes, so only the kernels differ."""
    q, k, v, w = (_rnd(cuda, 1, 150, 2, 128) for _ in range(4))
    ang = torch.randn(150, 64, generator=cuda, device="cuda")
    ang = ang.repeat_interleave(2, -1) if interleaved else torch.cat([ang, ang], -1)
    grads = []
    for device in ("cuda", "cpu"):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        rope = (ang.cos().to(device), ang.sin().to(device))
        out = A.attention(*ts, rope=rope, rope_interleaved=interleaved)
        (out.float() * w.to(device).float()).sum().backward()
        grads.append([t.grad for t in ts])
    for g, want in zip(*grads):
        _assert_close(g, want.to(g.device))


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _rnd(cuda, 1, 64, 2, 64)  # head dim 64
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        A.flash_attention(q.float(), q.float(), q.float())


# sliding-tile attention (K7, K8): (grid_thw, ref_len, pose_len, tile, window,
# pose_kv_window, batch, heads).  'ragged': kv blocks of 32 rows and pose q
# tiles of 8, so a 64-row stage straddles two blocks, a 128-row CTA holds one
# 8-row tile (its second warpgroup has no live row), and a ref tail of 4 rows;
# 'straddle_ts96': blocks of 96 rows (a stage of 64 live rows, then one of
# 32), pose tiles of 24, a short last block of 50 rows; 'production_rows':
# ts 1344 and pose tiles of 336 rows, as at 48,832 tokens (a video tile ends
# 64 rows into its 11th CTA, a pose tile 80 rows into its 3rd);
# 'production_rows_wide': the same at 2 x 24 heads, where the dq kernel takes
# 128-row CTAs (the dense kernel's wave rule), the 11th with a warpgroup of
# no live rows
STA_CASES = {
    "ragged": ((2, 8, 16), 100, 64, (1, 2), (1, 2), 3, 2, 2),
    "straddle_ts96": ((2, 4, 48), 50, 96, (1, 2), (1, 2), 0, 2, 2),
    "production_rows": ((3, 8, 56), 8, 336, (3, 8), (1, 1), 0, 1, 2),
    "production_rows_wide": ((3, 8, 56), 8, 336, (3, 8), (1, 1), 0, 2, 24),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STA_CASES))
def test_sta_kernels_match_plain(cuda, case):
    from scail_tpu_torch.ops import sta as S

    grid, ref, pose, tile, window, pkw, b, heads = STA_CASES[case]
    plan = S.sta_plan(grid, ref, pose, tile, window, True, pkw)
    tables = plan.tables("cuda")
    s = ref + plan.video_len + pose
    q, k, v, do = (_rnd(cuda, b, s, heads, 128) for _ in range(4))
    sv = plan.video_len
    for qc, ts_q in ((q[:, :sv], plan.ts), (q[:, sv:sv + pose], plan.ts // 4)):
        dc = do[:, :qc.shape[1]]
        before = dict(A.LAUNCHES)
        out, lse = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q,
                                      with_lse=True)
        out2, none = S.sta_windowed_fwd(qc, k, v, tables.table, ts=plan.ts, ts_q=ts_q)
        got = S.sta_windowed_bwd(qc, k, v, out, lse, dc, tables, ts=plan.ts, ts_q=ts_q)
        torch.cuda.synchronize()
        for name in ("sta_attention_fwd", "sta_attention_fwd_lse", "sta_attention_bwd_dq",
                     "sta_attention_bwd_dkv"):
            assert A.LAUNCHES[name] == before[name] + 1, name
        assert none is None and torch.equal(out, out2)
        want, want_lse = S.sta_windowed_plain(qc.float(), k.float(), v.float(), tables.table,
                                              ts=plan.ts, ts_q=ts_q)
        _assert_close(out, want)
        _assert_close(lse, want_lse, lse=True)
        # the backward's plain version on the kernels' bf16 inputs: its
        # rounding points (dS and P in bf16; with f32 inputs they are not
        # rounded, and a pose call's dk/dv, whose ref rows take every q tile,
        # spans too wide a range for error_vs_plain's scale)
        plain = S.sta_windowed_bwd_plain(qc, k, v, out, lse, dc, tables, ts=plan.ts, ts_q=ts_q)
        for g, w in zip(got, plain):
            _assert_close(g, w)
        again = S.sta_windowed_bwd(qc, k, v, out, lse, dc, tables, ts=plan.ts, ts_q=ts_q)
        assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_sta_attention_gradients_on_the_card_match_the_plain_path(cuda):
    """sta_attention through its autograd Functions on the card (K7 + K2
    forward, K8 + K5 backward) against the same calls on CPU copies of the
    same bf16 inputs, where they run the plain versions."""
    from scail_tpu_torch.ops import sta as S

    grid, ref, pose, tile, window, pkw, _, _ = STA_CASES["ragged"]
    kw = dict(grid_thw=grid, ref_len=ref, pose_len=pose, tile=tile, window=window,
              windowed_pose=True, pose_kv_window=pkw)
    s = ref + grid[0] * grid[1] * grid[2] + pose
    q, k, v, w = (_rnd(cuda, 1, s, 2, 128) for _ in range(4))
    grads = []
    for device in ("cuda", "cpu"):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        (S.sta_attention(*ts, **kw).float() * w.to(device).float()).sum().backward()
        grads.append([t.grad for t in ts])
    for g, want in zip(*grads):
        _assert_close(g, want.to(g.device))


def _sta_all(S, q, k, v, do, tables, ts, ts_q):
    """The four STA entry points on one call: (out, lse, out without the
    LSE, dq, dk, dv), synchronised."""
    out, lse = S.sta_windowed_fwd(q, k, v, tables.table, ts=ts, ts_q=ts_q, with_lse=True)
    out2, _ = S.sta_windowed_fwd(q, k, v, tables.table, ts=ts, ts_q=ts_q)
    grads = S.sta_windowed_bwd(q, k, v, out, lse, do, tables, ts=ts, ts_q=ts_q)
    torch.cuda.synchronize()
    return (out, lse, out2, *grads)


@pytest.mark.cuda
def test_sta_kernels_skip_an_unattended_block_and_take_head_strided_slices(cuda):
    """A hand-made table over kv blocks of 32 rows (the last of 4): block 2
    is attended by no q tile (its dk/dv rows are zeros), the short last
    block leads one row's walk, q tiles of 40 rows end inside a 64-row
    chunk.  q/k/v/dO are head-strided slices of packed tensors: the results
    equal those on contiguous copies bit for bit, match the plain versions,
    and a second call gives the same bits."""
    from scail_tpu_torch.ops import sta as S

    ts, ts_q, skv = 32, 40, 420
    table_np = np.asarray([[0, 1, 13], [3, 4, 5], [13, 6, 7], [8, 9, 10], [11, 12, 0]],
                          np.int32)
    inv, lens = S._inverse_table(table_np, -(-skv // ts))
    assert lens[2] == 0 and lens[13] == 2
    tables = S.StaTables(*(torch.from_numpy(a).cuda() for a in (
        table_np, inv, lens, S.dkv_launch_order(lens, ts, skv))))
    qd = _rnd(cuda, 2, 200, 2, 3, 128)   # q and dO packed with a third head group
    kv = _rnd(cuda, 2, skv, 3, 3, 128)   # k and v packed
    q, do, k, v = qd[:, :, 0], qd[:, :, 1], kv[:, :, 0], kv[:, :, 2]
    assert not any(t.is_contiguous() for t in (q, do, k, v))
    got = _sta_all(S, q, k, v, do, tables, ts, ts_q)
    same = _sta_all(S, *(t.contiguous() for t in (q, k, v, do)), tables, ts, ts_q)
    again = _sta_all(S, q, k, v, do, tables, ts, ts_q)
    assert all(torch.equal(x, y) for x, y in zip(got, same))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    out, lse, out2, dq, dk, dv = got
    assert torch.equal(out, out2)
    want, want_lse = S.sta_windowed_plain(q.float(), k.float(), v.float(), tables.table, ts=ts,
                                          ts_q=ts_q)
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)
    plain = S.sta_windowed_bwd_plain(q, k, v, out, lse, do, tables, ts=ts, ts_q=ts_q)
    for g, w in zip((dq, dk, dv), plain):
        _assert_close(g, w)
    assert not dk[:, 64:96].any() and not dv[:, 64:96].any()
    # without an order the CTAs launch in block order: the same bits
    q2, lse2, delta = A._bwd_operands(q, out, lse, do, 128 ** -0.5)
    ops = (q2, k, v, do, lse2.contiguous(), delta.contiguous())
    built = S.sta_windowed_bwd_dkv(*ops, tables.inv, tables.lens, ts=ts, ts_q=ts_q)
    assert all(torch.equal(x, y) for x, y in zip(built, (dk, dv)))


@pytest.mark.cuda
def test_sta_card_path_raises_without_its_kernels(cuda, monkeypatch):
    """No fallback: when the kernels cannot be built, or a launch reports an
    error, every STA entry point on the card raises; none runs the plain
    version or moves to the CPU."""
    from scail_tpu_torch.ops import cuda_build
    from scail_tpu_torch.ops import sta as S

    grid, ref, pose, tile, window, pkw, _, _ = STA_CASES["ragged"]
    plan = S.sta_plan(grid, ref, pose, tile, window, True, pkw)
    tables = plan.tables("cuda")
    s = ref + plan.video_len + pose
    q, k, v, do = (_rnd(cuda, 1, s, 2, 128) for _ in range(4))
    qv, dv = q[:, :plan.video_len], do[:, :plan.video_len]
    q2, lse2, delta = A._bwd_operands(qv, qv, torch.zeros(1, 2, plan.video_len, device="cuda"),
                                      dv, 128 ** -0.5)
    ops = (q2, k, v, dv, lse2.contiguous(), delta.contiguous())
    calls = (
        lambda: S.sta_windowed_fwd(qv, k, v, tables.table, ts=plan.ts, ts_q=plan.ts),
        lambda: S.sta_windowed_fwd(qv, k, v, tables.table, ts=plan.ts, ts_q=plan.ts,
                                   with_lse=True),
        lambda: S.sta_windowed_bwd_dq(*ops, tables.table, ts=plan.ts, ts_q=plan.ts,
                                      scale=128 ** -0.5),
        lambda: S.sta_windowed_bwd_dkv(*ops, tables.inv, tables.lens, ts=plan.ts, ts_q=plan.ts,
                                       dkv_order=tables.dkv_order),
        lambda: S.sta_attention(q, k, v, grid_thw=grid, ref_len=ref, pose_len=pose, tile=tile,
                                window=window, windowed_pose=True, pose_kv_window=pkw,
                                pre_tiled=True),
    )

    def unbuildable():
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")

    class Failing:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue

    for lib in (unbuildable, Failing):
        monkeypatch.setattr(cuda_build, "lib", lib)
        before = dict(A.LAUNCHES)
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
        assert A.LAUNCHES == before


@pytest.mark.cuda
def test_sta_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """Rows off 16 bytes, tables of the wrong type or shape, a dk/dv order
    that is not (n, 2): a ValueError naming the shape, before any launch."""
    from scail_tpu_torch.ops import sta as S

    grid, ref, pose, tile, window, pkw, _, _ = STA_CASES["ragged"]
    plan = S.sta_plan(grid, ref, pose, tile, window, True, pkw)
    tables = plan.tables("cuda")
    s = ref + plan.video_len + pose
    q, k, v = (_rnd(cuda, 1, s, 2, 128) for _ in range(3))
    qv = q[:, :plan.video_len]
    kw = dict(ts=plan.ts, ts_q=plan.ts)
    odd = _rnd(cuda, s * 2 * 128 + 4)[4:].view(1, s, 2, 128)  # 8 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        S.sta_windowed_fwd(qv, odd, v, tables.table, **kw)
    with pytest.raises(ValueError, match="int32"):
        S.sta_windowed_fwd(qv, k, v, tables.table.long(), **kw)
    with pytest.raises(ValueError, match="int32"):
        S.sta_windowed_fwd(qv, k, v, tables.table[:-1], **kw)
    with pytest.raises(ValueError, match="unsupported STA call"):
        S.sta_windowed_fwd(q[:, :plan.video_len - 1], k, v, tables.table, **kw)
    q2 = qv.contiguous()
    lse2 = torch.zeros(1, 2, plan.video_len, device="cuda")
    with pytest.raises(ValueError, match="dkv_order"):
        S.sta_windowed_bwd_dkv(q2, k, v, q2, lse2, lse2, tables.inv, tables.lens, **kw,
                               dkv_order=tables.dkv_order.reshape(-1))


def _matmul_view(t):
    """A (..., N) matmul output as error_vs_plain's (1, rows, 1, N)."""
    return t.reshape(1, -1, 1, t.shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n, bias, strided", [(200, False, False), (201, True, True)])
def test_quantized_matmul_kernels_match_plain(cuda, bits, n, bias, strided):
    """K4 (W8A16 / W4A16) at M = 300 and N = 200 or 201, neither a multiple
    of the 128 x 128 tile, K = 160 (two and a half 64-deep stages); every int4 nibble,
    -8 included; with a bias and x rows on a wider stride."""
    from scail_tpu_torch.ops import quant as Q

    k = 160
    x = _rnd(cuda, 300, 2 * k)[:, :k] if strided else _rnd(cuda, 2, 150, k)
    if bits == 8:
        codes = torch.randint(-127, 128, (n, k), generator=cuda, device="cuda",
                              dtype=torch.int8)
    else:
        codes = torch.randint(0, 256, (n, k // 2), generator=cuda, device="cuda",
                              dtype=torch.uint8)
        codes[0] = torch.arange(k // 2, device="cuda", dtype=torch.uint8) * 3  # many bytes
        assert Q.unpack_int4(codes).min().item() == -8
    scale = (torch.rand(n, generator=cuda, device="cuda") * 0.02 + 1e-3).bfloat16()
    b = _rnd(cuda, n) if bias else None
    mm = Q.matmul_w8a16 if bits == 8 else Q.matmul_w4a16
    name = f"w{bits}a16_matmul"
    before = Q.LAUNCHES[name]
    got = mm(x, codes, scale, b)
    torch.cuda.synchronize()
    assert Q.LAUNCHES[name] == before + 1
    want = mm(x, codes, scale, b, impl="xla")
    assert got.shape == want.shape == (*x.shape[:-1], n) and got.dtype == torch.bfloat16
    _assert_close(_matmul_view(got), _matmul_view(want))
    # the same product from the f32 plain version of the dequantized weight
    w = (codes.float() if bits == 8 else Q.unpack_int4(codes).float()) * scale.float()[:, None]
    ref = (x.float() @ w.T).to(torch.bfloat16)
    if b is not None:
        ref = ref + b
    _assert_close(_matmul_view(got), _matmul_view(ref))


def _check_quant(x, codes, scale, bias, bits):
    """K4 against its plain version, then a second call for the same bits."""
    from scail_tpu_torch.ops import quant as Q

    mm = Q.matmul_w8a16 if bits == 8 else Q.matmul_w4a16
    got = mm(x, codes, scale, bias)
    want = mm(x, codes, scale, bias, impl="xla")
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _assert_close(_matmul_view(got), _matmul_view(want))
    assert torch.equal(got, mm(x, codes, scale, bias))


def _codes(gen, n, k, bits):
    if bits == 8:
        return torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    return torch.randint(0, 256, (n, k // 2), generator=gen, device="cuda", dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m, n, k", [(127, 129, 160), (129, 127, 208), (128, 128, 64),
                                     (1, 8, 16), (257, 255, 48), (300, 201, 96)])
def test_quantized_matmul_ragged_tiles(cuda, bits, m, n, k):
    """M and N one off K4's 128 x 128 output tile, K with a tail in the
    64-deep stages (160, 208), and int4 rows of K/2 bytes that are no 16-byte
    multiple (K = 16, 48, 208: the cp.async path), x on a wider row stride."""
    x = _rnd(cuda, m, k + 32)[:, :k]
    scale = (torch.rand(n, generator=cuda, device="cuda") * 0.02 + 1e-3).bfloat16()
    _check_quant(x, _codes(cuda, n, k, bits), scale, _rnd(cuda, n), bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_at_the_cross_kv_shape(cuda, bits):
    """The 14B's cross_kv linear: M = 1,024 rows (8 row tiles) by N = 10,240,
    K = 5,120."""
    x = _rnd(cuda, 1024, 5120)
    scale = torch.full((10240,), 0.02 / 127, device="cuda")
    _check_quant(x, _codes(cuda, 10240, 5120, bits), scale, _rnd(cuda, 10240), bits)


@pytest.mark.cuda
def test_quantized_matmul_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from scail_tpu_torch.ops import quant as Q

    codes = torch.zeros(32, 40, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):  # K = 40 is not a multiple of 16
        Q.matmul_w8a16(_rnd(cuda, 4, 40), codes, torch.ones(32, device="cuda"))
    with pytest.raises(TypeError):
        Q.matmul_w8a16(_rnd(cuda, 4, 32).float(), codes[:, :32].contiguous(),
                       torch.ones(32, device="cuda"))


@pytest.mark.cuda
def test_flash_attention_int8_kernel_matches_plain(cuda):
    """K6 at q 150 and kv 176 rows (q and KV tails), v a head-strided slice."""
    q, k = _rnd(cuda, 2, 150, 2, 128), _rnd(cuda, 2, 176, 2, 128)
    v = _rnd(cuda, 2, 176, 2, 3 * 128)[..., 128:256]
    before = A.LAUNCHES["flash_attention_int8"]
    out, lse = A.flash_attention_int8(q, k, v)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention_int8"] == before + 1
    want, want_lse = A.flash_attention_int8_plain(q, k, v)
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)


def _check_int8(q, k, v):
    """K6 against its plain version on the same bf16 inputs, then a second
    call for the same bits."""
    out, lse = A.flash_attention_int8(q, k, v)
    want, want_lse = A.flash_attention_int8_plain(q, k, v)
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)
    again, again_lse = A.flash_attention_int8(q, k, v)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("skv", [1, 63, 64, 65, 127, 128, 129])
def test_flash_attention_int8_ragged_tiles(cuda, sq, skv):
    """Both sides of K6's 64-row kv stages and its 128-row q tile (two
    consumer warpgroups): every q and kv tail, Sq != Skv."""
    q = _rnd(cuda, 1, sq, 2, 128)
    k, v = _rnd(cuda, 1, skv, 2, 128), _rnd(cuda, 1, skv, 2, 128)
    _check_int8(q, k, v)


@pytest.mark.cuda
def test_flash_attention_int8_at_40_heads_with_a_head_strided_v(cuda):
    """The 14B's 40 heads at q 150 and kv 176 rows, v a head-strided view of
    a packed qkv-like tensor."""
    q, k = _rnd(cuda, 2, 150, 40, 128), _rnd(cuda, 2, 176, 40, 128)
    v = _rnd(cuda, 2, 176, 40, 3 * 128)[..., 128:256]
    _check_int8(q, k, v)


@pytest.mark.cuda
def test_attention_int8_gradients_on_the_card_match_the_plain_path(cuda):
    """attention_int8 on the card (K6 forward, K5 backward) against the same
    Function on CPU copies of the same bf16 inputs (plain versions)."""
    q, k, v, w = (_rnd(cuda, 1, 150, 2, 128) for _ in range(4))
    grads = []
    for device in ("cuda", "cpu"):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        (A.attention_int8(*ts).float() * w.to(device).float()).sum().backward()
        grads.append([t.grad for t in ts])
    for g, want in zip(*grads):
        _assert_close(g, want.to(g.device))


@pytest.mark.cuda
@pytest.mark.parametrize("mod_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 1536])
def test_adaln_layer_norm_kernel_matches_plain(cuda, mod_dtype, d):
    """K9 at s = 150 (no block multiple), x rows on a wider stride (the final
    layer's row gather is a strided view), shift/scale strided rows of a
    (b, 6, d) table as the DiT passes them, bf16 or f32."""
    from scail_tpu_torch.ops import fused_norms as F

    x = _rnd(cuda, 2, 150, 2 * d)[..., d:]
    shift, scale = _rnd(cuda, 2, 6, d).to(mod_dtype).unsqueeze(2).unbind(1)[:2]
    before = A.LAUNCHES["adaln_layer_norm"]
    got = F.adaln_layer_norm_kernel(x, shift, scale, eps=1e-6)
    torch.cuda.synchronize()
    assert A.LAUNCHES["adaln_layer_norm"] == before + 1
    want = F.adaln_layer_norm_plain(x, shift, scale, eps=1e-6)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = F.adaln_error_vs_plain(got, want)
    assert err["ok"], err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 1536, 5120])
def test_adaln_layer_norm_round_ln_kernel_matches_plain(cuda, d):
    """K9 at dit_forward's roundings (the DiT's sites) on the same strided
    operands, within the same limits; f32 shift/scale, whose modulation JAX
    would return in f32, are refused."""
    from scail_tpu_torch.ops import fused_norms as F

    x = _rnd(cuda, 2, 150, 2 * d)[..., d:]
    shift, scale = _rnd(cuda, 2, 6, d).unsqueeze(2).unbind(1)[:2]
    before = A.LAUNCHES["adaln_layer_norm"]
    got = F.adaln_layer_norm_kernel(x, shift, scale, eps=1e-6, round_ln=True)
    torch.cuda.synchronize()
    assert A.LAUNCHES["adaln_layer_norm"] == before + 1
    want = F.adaln_layer_norm_plain(x, shift, scale, eps=1e-6, round_ln=True)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    err = F.adaln_error_vs_plain(got, want)
    assert err["ok"], err
    with pytest.raises(TypeError):
        F.adaln_layer_norm_kernel(x, shift.float(), scale.float(), round_ln=True)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ragged", "qkv_view"])
def test_rotary_kernel_is_bit_exact_against_plain(cuda, layout):
    """K10 at s = 150, d = 64, 3 heads, and on the q and k column slices of a
    (2, 150, 3 * 3 * 128) qkv projection with SCAIL-like interleaved tables."""
    from scail_tpu_torch.ops import fused_norms as F

    d = 64 if layout == "ragged" else 128
    ang = torch.randn(150, d // 2, generator=cuda, device="cuda").repeat_interleave(2, -1)
    cos, sin = ang.cos(), ang.sin()
    if layout == "ragged":
        views = [_rnd(cuda, 2, 150, 3, d)]
    else:
        qkv = _rnd(cuda, 2, 150, 3 * 3 * d)
        views = [t.unflatten(-1, (3, d)) for t in qkv.chunk(3, dim=-1)[:2]]
    for x in views:
        before = A.LAUNCHES["rotary"]
        got = F.rotary_kernel(x, cos, sin)
        torch.cuda.synchronize()
        assert A.LAUNCHES["rotary"] == before + 1
        assert torch.equal(got, F.apply_rotary_fused_plain(x, cos, sin))


@pytest.mark.cuda
def test_fused_norm_gradients_on_the_card_match_the_cpu(cuda):
    """The K9 and K10 autograd Functions on the card against the same calls on
    CPU copies of the same bf16 inputs (plain versions): the backwards are
    the same torch code, so only the forwards' kernels differ."""
    from scail_tpu_torch.ops import fused_norms as F

    x, w = _rnd(cuda, 1, 150, 2, 128), _rnd(cuda, 1, 150, 2 * 128)
    mod = _rnd(cuda, 1, 6, 2 * 128)
    ang = torch.randn(150, 64, generator=cuda, device="cuda").repeat_interleave(2, -1)
    grads = []
    for device in ("cuda", "cpu"):
        xi, mi = x.detach().to(device).requires_grad_(), mod.detach().to(device).requires_grad_()
        shift, scale = mi.unsqueeze(2).unbind(1)[:2]
        y = F.apply_rotary_fused(xi, ang.cos().to(device), ang.sin().to(device)).flatten(2)
        y = F.adaln_layer_norm(y, shift, scale, eps=1e-6)
        (y.float() * w.to(device).float()).sum().backward()
        grads.append([xi.grad, mi.grad])
    for g, want in zip(*grads):
        assert g.dtype == torch.bfloat16
        err = ((g.float().cpu() - want.float()).norm() / want.float().norm()).item()
        assert err < 1e-2, err


@pytest.mark.cuda
def test_fused_norm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from scail_tpu_torch.ops import fused_norms as F

    x = _rnd(cuda, 1, 4, 36)  # d not a multiple of 8
    with pytest.raises(ValueError):
        F.adaln_layer_norm_kernel(x, x[:, :1], x[:, :1])
    with pytest.raises(TypeError):
        F.rotary_kernel(x.float()[..., None, :], torch.ones(4, 36), torch.ones(4, 36))
