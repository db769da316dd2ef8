"""Sliding-tile attention (STA) on PyTorch (counterpart of scail_tpu/ops/sta.py).

The DiT's self-attention sequence [ref | video | pose] is regrouped so that
the video tokens form strip tiles of (tile_t latent frames, tile_h latent
rows, full width), each one contiguous kv block of ts rows.  Each video q
tile attends a clamped (win_t, win_h) window of video tiles plus the
conditioning blocks; with `windowed_pose` the half-resolution pose queries,
tiled the same way, share that window; with `pose_kv_window` the pose region
itself is windowed in t.  The ref queries stay dense over the whole sequence
(arXiv:2502.04507; the exact semantics are `sta_block_mask`).

The planners (`_strip_layout`, `_pose_perm`, `_window_table`,
`_inverse_table`, `sta_order`, `sta_block_mask`, `sta_executed_pairs`) are
the JAX package's numpy code, copied.  The windowed calls run the
hand-written kernels of csrc/sta_attention.cu: `sta_windowed_fwd` (K7, with
or without the LSE) and `sta_windowed_bwd_dq` / `sta_windowed_bwd_dkv` (K8);
each has a plain PyTorch version, taken for CPU tensors only, and counts its
launches in `ops.attention.LAUNCHES`.  The dense ref rows go through
`ops.attention.attention` (K2 forward, K5 backward).

Unlike the TPU kernels, the port copies no zero pad onto k/v (the kernels
mask the rows past the sequence) and no lane pad onto the pose q tiles (the
kernels mask the rows past each tile).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from scail_tpu_torch.ops import cuda_build
from scail_tpu_torch.ops.attention import (LAUNCHES, _bwd_operands, _check_impl, _check_operand,
                                           _stream, _strides, attention,
                                           flash_attention_bwd_plain, flash_attention_plain,
                                           stashed_flash)

_LOG2E = math.log2(math.e)


# --------------------------------------------------------------------------
# Planners: the JAX package's numpy code, unchanged
# --------------------------------------------------------------------------
def _strip_layout(T, Hp, Wp, ref_len, pose_len, tile_t, tile_h):
    """Static index plan: permutation of video tokens to tile-major
    order and the original positions of the global (ref+pose) tokens."""
    assert T % tile_t == 0 and Hp % tile_h == 0, (
        f"STA strip tiles ({tile_t},{tile_h}) must divide (T={T}, Hp={Hp})")
    sv = T * Hp * Wp
    n_t, n_h = T // tile_t, Hp // tile_h
    t, h, w = np.meshgrid(np.arange(T), np.arange(Hp), np.arange(Wp),
                          indexing="ij")
    orig = ref_len + (t * Hp + h) * Wp + w               # (T, Hp, Wp)
    # tile-major: (it, ih) tiles raster, within-tile (t, h, w) raster
    perm = (orig.reshape(n_t, tile_t, n_h, tile_h, Wp)
            .transpose(0, 2, 1, 3, 4).reshape(-1))
    s_total = ref_len + sv + pose_len
    glob = np.concatenate([np.arange(ref_len),
                           np.arange(ref_len + sv, s_total)])
    return perm.astype(np.int32), glob.astype(np.int32), n_t, n_h


def _pose_perm(T, Hp, Wp, ref_len, pose_len, tile_t, tile_h):
    """Tile-major permutation of the half-res pose tokens, spatially
    aligned with the video strip tiles: pose tile (it, ih) covers the
    same (t, h) region as video tile (it, ih) at half resolution."""
    hp, wp = Hp // 2, Wp // 2
    assert tile_h % 2 == 0, "windowed-pose STA needs an even tile_h"
    assert Wp % 2 == 0 and (tile_t * tile_h * Wp) % 32 == 0, (
        f"windowed-pose STA needs Wp even and ts % 32 == 0 (the pose q "
        f"tile ts//4 must be 8-row aligned for the TPU kernel), got "
        f"Wp={Wp} tile=({tile_t},{tile_h})")
    assert pose_len == T * hp * wp, (
        f"windowed-pose STA expects the SCAIL half-res pose grid "
        f"T*(Hp/2)*(Wp/2)={T * hp * wp}, got pose_len={pose_len}")
    pt_h = tile_h // 2
    n_t, n_h = T // tile_t, Hp // tile_h
    sv = T * Hp * Wp
    t, h, w = np.meshgrid(np.arange(T), np.arange(hp), np.arange(wp),
                          indexing="ij")
    orig = ref_len + sv + (t * hp + h) * wp + w
    perm = (orig.reshape(n_t, tile_t, n_h, pt_h, wp)
            .transpose(0, 2, 1, 3, 4).reshape(-1))
    return perm.astype(np.int32)


def _window_table(n_t, n_h, win_t, win_h, n_pose_blocks, n_ref_blocks,
                  pose_kv_win_t=0):
    """(n_tiles, n_steps) int32 kv-block table shared by the video and
    (windowed-pose mode) pose query tiles: a clamped (win_t, win_h)
    window of video tiles, then the conditioning blocks.  With
    pose_kv_win_t > 0 the pose region (laid out per t-strip) is itself
    temporally windowed: only the pose blocks of the pose_kv_win_t
    t-strips around the query's strip are visited; ref blocks are
    always all visited and always LAST (they carry the zero pad, which
    the kernel's tail-step mask expects at the end of the walk)."""
    wt, wh = min(win_t, n_t), min(win_h, n_h)
    n_v = n_t * n_h
    bps = n_pose_blocks // n_t if pose_kv_win_t else 0   # blocks per strip
    pw = min(pose_kv_win_t, n_t) if pose_kv_win_t else 0
    rows = []
    for it in range(n_t):
        t0 = min(max(it - wt // 2, 0), n_t - wt)
        p0 = min(max(it - pw // 2, 0), n_t - pw) if pw else 0
        for ih in range(n_h):
            h0 = min(max(ih - wh // 2, 0), n_h - wh)
            row = [(t0 + dt) * n_h + (h0 + dh)
                   for dt in range(wt) for dh in range(wh)]
            if pw:
                row += [n_v + (p0 + dt) * bps + g
                        for dt in range(pw) for g in range(bps)]
            else:
                row += [n_v + g for g in range(n_pose_blocks)]
            row += [n_v + n_pose_blocks + g for g in range(n_ref_blocks)]
            rows.append(row)
    return np.asarray(rows, np.int32)


def _inverse_table(table, n_blocks):
    """(nq, n_steps) forward table -> (n_blocks, inv_len) inverse table +
    (n_blocks,) row lengths.  Rows are padded by repeating the last valid
    q-tile index (fetch elided by the pipeline; compute skipped via the
    length guard).  A block attended by nobody gets index 0, length 0."""
    rows = [[] for _ in range(n_blocks)]
    for qi in range(table.shape[0]):
        for j in table[qi]:
            rows[int(j)].append(qi)
    lens = np.asarray([len(r) for r in rows], np.int32)
    inv_len = max(1, int(lens.max()) if len(lens) else 1)
    inv = np.zeros((n_blocks, inv_len), np.int32)
    for j, r in enumerate(rows):
        if r:
            inv[j, : len(r)] = r
            inv[j, len(r):] = r[-1]
    return inv, lens


def sta_order(grid_thw, ref_len, pose_len, tile, windowed_pose=False):
    """Static token order for the tile-major-resident layout and its
    inverse.  windowed_pose=False: [video (tile-major) | ref | pose];
    True: [video (tile-major) | pose (tile-major) | ref].  The DiT
    keeps hidden states in this order for the whole layer stack when
    attn_impl='sta' (one gather per forward instead of several per
    layer); RoPE tables are row-permuted to match."""
    T, Hp, Wp = grid_thw
    perm, glob, _, _ = _strip_layout(T, Hp, Wp, ref_len, pose_len,
                                     tile[0], tile[1])
    if windowed_pose:
        pperm = _pose_perm(T, Hp, Wp, ref_len, pose_len, tile[0], tile[1])
        order = np.concatenate([perm, pperm,
                                np.arange(ref_len, dtype=np.int32)])
    else:
        order = np.concatenate([perm, glob])
    return order, np.argsort(order)


def sta_executed_pairs(grid_thw, ref_len, pose_len, tile, window,
                       windowed_pose=False, pose_kv_window=0):
    """Executed (q, kv) dot pairs of sta_attention at this geometry --
    the honest FLOP count for the sparse step (BENCH executed_tflops).
    Counts every kv block a table row visits, including the zero-padded
    ref tail the kernel actually processes.  Divide by s**2
    (s = ref_len + T*Hp*Wp + pose_len) for the executed-over-dense
    attention fraction."""
    T, Hp, Wp = grid_thw
    sv = T * Hp * Wp
    n_t, n_h = T // tile[0], Hp // tile[1]
    ts = tile[0] * tile[1] * Wp
    if windowed_pose and pose_kv_window and n_h % 4 == 0:
        n_pb = pose_len // ts
        pad = (-ref_len) % ts
        n_rb = (ref_len + pad) // ts
        table = _window_table(n_t, n_h, window[0], window[1], n_pb, n_rb,
                              pose_kv_window)
    else:
        s_glob = ref_len + pose_len
        pad = (-s_glob) % ts
        table = _window_table(n_t, n_h, window[0], window[1], 0,
                              (s_glob + pad) // ts, 0)
    row_kv = table.shape[1] * ts            # kv tokens per table row
    pairs = table.shape[0] * ts * row_kv    # video q tiles
    s_pad_total = ref_len + sv + pose_len + pad
    if windowed_pose:
        pairs += table.shape[0] * (ts // 4) * row_kv  # pose q tiles, same table
        pairs += ref_len * s_pad_total                # dense ref rows
    else:
        pairs += (ref_len + pose_len) * s_pad_total   # dense cond rows
    return int(pairs)


def sta_block_mask(s, grid_thw, ref_len, pose_len, tile, window,
                   windowed_pose=False, pose_kv_window=0):
    """Dense (s, s) boolean mask equivalent to sta_attention's sparsity
    (True = attended) -- the test oracle and the documentation of the
    exact semantics."""
    T, Hp, Wp = grid_thw
    perm, glob, n_t, n_h = _strip_layout(T, Hp, Wp, ref_len, pose_len,
                                         tile[0], tile[1])
    ts = tile[0] * tile[1] * Wp
    sv = T * Hp * Wp
    mask = np.zeros((s, s), bool)
    mask[glob[:, None], np.arange(s)[None]] = True   # cond q: dense
    mask[:, glob] = True                             # everyone sees cond
    wt, wh = min(window[0], n_t), min(window[1], n_h)
    tiles = perm.reshape(n_t * n_h, ts)
    pose_strips = None
    if windowed_pose:
        ptiles = _pose_perm(T, Hp, Wp, ref_len, pose_len,
                            tile[0], tile[1]).reshape(n_t * n_h, ts // 4)
        pose_idx = np.arange(ref_len + sv, s)
        vid_idx = perm.reshape(-1)
        # pose queries lose dense video access; keep only their window
        mask[np.ix_(pose_idx, vid_idx)] = False
        if pose_kv_window and n_h % 4 == 0:
            # video+pose queries lose dense pose access too
            pose_strips = ptiles.reshape(n_t, n_h * ts // 4)
            vp_idx = np.concatenate([vid_idx, pose_idx])
            mask[np.ix_(vp_idx, pose_idx)] = False
    pw = min(pose_kv_window, n_t) if pose_strips is not None else 0
    for it in range(n_t):
        t0 = min(max(it - wt // 2, 0), n_t - wt)
        p0 = min(max(it - pw // 2, 0), n_t - pw) if pw else 0
        for ih in range(n_h):
            h0 = min(max(ih - wh // 2, 0), n_h - wh)
            qsets = [tiles[it * n_h + ih]]
            if windowed_pose:
                qsets.append(ptiles[it * n_h + ih])
            for qs in qsets:
                for dt in range(wt):
                    for dh in range(wh):
                        kj = tiles[(t0 + dt) * n_h + (h0 + dh)]
                        mask[qs[:, None], kj[None, :]] = True
                if pw:
                    for dt in range(pw):
                        kj = pose_strips[p0 + dt]
                        mask[qs[:, None], kj[None, :]] = True
    return mask


# --------------------------------------------------------------------------
# The plan of one geometry: token order, kv-block tables
# --------------------------------------------------------------------------
class StaTables(NamedTuple):
    """The int32 tables of one windowed call, on one device."""

    table: torch.Tensor   # (n_tiles, n_steps) kv blocks of each q tile, visiting order
    inv: torch.Tensor     # (n_blocks, inv_len) q tiles attending each kv block
    lens: torch.Tensor    # (n_blocks,) valid entries of each inv row
    dkv_order: torch.Tensor  # (n_ctas, 2) dk/dv launch order: (kv block, chunk), heaviest first


# kv rows of one dk/dv CTA (csrc/flash_bodies.cuh k5::kDkvRows)
DKV_ROWS = 128


def dkv_launch_order(lens, ts: int, skv: int) -> np.ndarray:
    """(n_ctas, 2) int32: the (kv block, 128-row chunk) of every dk/dv CTA
    that holds rows of the sequence, blocks attended by the most q tiles
    first (ties in block order).  A block's CTAs all walk its lens[blk] q
    tiles, so the longest CTAs start first and the short ones fill the tail."""
    lens = np.asarray(lens)
    pairs = [(j, c) for j in np.argsort(-lens, kind="stable").tolist()
             for c in range(-(-min(ts, skv - j * ts) // DKV_ROWS))]
    return np.asarray(pairs, np.int32).reshape(-1, 2)


@lru_cache(maxsize=None)
def _block_order(ts: int, skv: int, device: str) -> torch.Tensor:
    """The dk/dv CTAs in block order, on `device`: what the kernel runs when
    it is given no order."""
    lens = np.zeros(-(-skv // ts), np.int32)
    return torch.from_numpy(dkv_launch_order(lens, ts, skv)).to(device)


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity: one per geometry
class StaPlan:
    """What sta_attention needs of a geometry, built once (`sta_plan`)."""

    ts: int               # kv block rows = video q tile rows; pose q tiles have ts // 4
    video_len: int
    pose_len: int
    order: np.ndarray     # tile-major position -> original position
    inverse: np.ndarray   # original position -> tile-major position
    table: np.ndarray
    inv: np.ndarray
    lens: np.ndarray
    dkv_order: np.ndarray

    def tables(self, device) -> StaTables:
        return _device_tables(self, str(device))


@lru_cache(maxsize=None)
def _device_tables(plan: StaPlan, device: str) -> StaTables:
    return StaTables(*(torch.from_numpy(a).to(device)
                       for a in (plan.table, plan.inv, plan.lens, plan.dkv_order)))


@lru_cache(maxsize=None)
def sta_plan(grid_thw: Tuple[int, int, int], ref_len: int, pose_len: int,
             tile: Tuple[int, int], window: Tuple[int, int], windowed_pose: bool = False,
             pose_kv_window: int = 0) -> StaPlan:
    """The token order and kv-block tables of sta_attention at one geometry
    (the JAX sta_attention's planning, done once per geometry; its
    pose_kv_window fallback is printed then)."""
    T, Hp, Wp = grid_thw
    sv = T * Hp * Wp
    _, _, n_t, n_h = _strip_layout(T, Hp, Wp, ref_len, pose_len, tile[0], tile[1])
    ts = tile[0] * tile[1] * Wp
    if windowed_pose and pose_kv_window and n_h % 4 != 0:
        print(f"[sta] pose_kv_window={pose_kv_window} ignored: needs "
              f"n_h % 4 == 0 (Hp/tile_h = {n_h}); pose kv stays dense")
    if windowed_pose and pose_kv_window and n_h % 4 == 0:
        # pose region is exactly n_t * (n_h/4) blocks of ts; only the ref
        # tail is short, and every table row visits it last
        n_pb = pose_len // ts
        n_rb = -(-ref_len // ts)
        table = _window_table(n_t, n_h, window[0], window[1], n_pb, n_rb, pose_kv_window)
    else:
        table = _window_table(n_t, n_h, window[0], window[1], 0,
                              -(-(ref_len + pose_len) // ts), 0)
    n_blocks = -(-(ref_len + sv + pose_len) // ts)
    inv, lens = _inverse_table(table, n_blocks)
    order, inverse = sta_order(grid_thw, ref_len, pose_len, tile, windowed_pose=windowed_pose)
    return StaPlan(ts, sv, pose_len, order.astype(np.int64), inverse.astype(np.int64), table,
                   inv, lens, dkv_launch_order(lens, ts, ref_len + sv + pose_len))


def block_rows(blocks, ts: int, skv: int, device) -> torch.Tensor:
    """kv rows of the listed blocks, in order; the last block may be short."""
    return torch.cat([torch.arange(j * ts, min(j * ts + ts, skv), device=device)
                      for j in np.asarray(blocks).tolist()])


def _rows(tables, name):
    t = getattr(tables, name)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# Plain versions: the kernels' functions in PyTorch, tile by tile, at the
# kernels' rounding points (the dense plain versions over each tile's blocks)
# --------------------------------------------------------------------------
def sta_windowed_plain(q, k, v, table, *, ts: int, ts_q: int, scale=None):
    """Plain version of `sta_windowed_fwd`: each q tile of ts_q rows attends
    the kv blocks of its table row.  Returns (out (b, sq, n, d) in q.dtype,
    lse (b, n, sq) f32, natural log)."""
    table = np.asarray(table.cpu() if isinstance(table, torch.Tensor) else table)
    outs, lses = [], []
    for i, row in enumerate(table):
        idx = block_rows(row, ts, k.shape[1], k.device)
        o, lse = flash_attention_plain(q[:, i * ts_q:(i + 1) * ts_q], k[:, idx], v[:, idx],
                                       scale=scale)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def sta_windowed_bwd_plain(q, k, v, out, lse, do, tables, *, ts: int, ts_q: int, scale=None,
                           grads: str = "all"):
    """Plain version of the K8 kernels (q roped, not prescaled; lse natural
    log from the forward): dq over the table, dk/dv over the inverse table,
    in f32 at the kernels' rounding points.  tables: a StaTables (or any
    object with table / inv / lens).  grads 'dq' or 'dkv' computes only that
    kernel's part and returns None for the others."""
    if grads not in ("all", "dq", "dkv"):
        raise ValueError(f"grads must be 'all', 'dq' or 'dkv', got {grads!r}")
    skv = k.shape[1]
    dq = dk = dv = None
    if grads in ("all", "dq"):
        dqs = []
        for i, row in enumerate(_rows(tables, "table")):
            sl = slice(i * ts_q, (i + 1) * ts_q)
            idx = block_rows(row, ts, skv, k.device)
            dqs.append(flash_attention_bwd_plain(q[:, sl], k[:, idx], v[:, idx], out[:, sl],
                                                 lse[:, :, sl], do[:, sl], scale=scale,
                                                 grads="dq")[0])
        dq = torch.cat(dqs, dim=1)
    if grads in ("all", "dkv"):
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        lens = _rows(tables, "lens")
        for j, tiles in enumerate(_rows(tables, "inv")):
            rows = slice(j * ts, min(j * ts + ts, skv))
            if lens[j] == 0:
                continue
            qi = block_rows(tiles[:lens[j]], ts_q, q.shape[1], q.device)
            _, dk[:, rows], dv[:, rows] = flash_attention_bwd_plain(
                q[:, qi], k[:, rows], v[:, rows], out[:, qi], lse[:, :, qi], do[:, qi],
                scale=scale, grads="dkv")
    return dq, dk, dv


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check_call(q, k, v, ts, ts_q):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    b, sq, n, d = q.shape
    if k.shape[0] != b or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if ts <= 0 or ts_q <= 0 or sq % ts_q or b * n > 65535 or k.shape[1] == 0:
        raise ValueError(f"unsupported STA call: q {tuple(q.shape)}, kv length {k.shape[1]}, "
                         f"ts {ts}, ts_q {ts_q}")


def _check_table(name, t, device, shape):
    """shape: the sizes the kernel needs, None where any size goes."""
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous() or \
            t.dim() != len(shape) or t.numel() == 0 or \
            any(want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: the kernels take a non-empty contiguous int32 table of shape "
                         f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def sta_windowed_fwd(q, k, v, table, *, ts: int, ts_q: int, scale=None, with_lse=False):
    """Windowed attention (K7): q (b, n_tiles*ts_q, n, d) in tiles of ts_q rows,
    k/v (b, skv, n, d) in blocks of ts rows; tile i attends the blocks of
    table[i].  Returns (out, lse (b, n, sq) natural log, or None without
    with_lse).  CPU tensors take the plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out, lse = sta_windowed_plain(q, k, v, table, ts=ts, ts_q=ts_q, scale=scale)
        return out, (lse if with_lse else None)
    if q.device.type != "cuda":
        raise NotImplementedError(f"sta_windowed_fwd: no kernel for device {q.device}")
    _check_call(q, k, v, ts, ts_q)
    b, sq, n, d = q.shape
    _check_table("table", table, q.device, (sq // ts_q, None))
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device) if with_lse else None
    rc = cuda_build.lib().scail_sta_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, n, sq, k.shape[1], ts_q, ts, table.shape[1],
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        ctypes.c_float(scale * _LOG2E), _stream(q.device))
    cuda_build.check(rc, "sta_attention_fwd")
    LAUNCHES["sta_attention_fwd_lse" if with_lse else "sta_attention_fwd"] += 1
    return out, lse


def _check_bwd(q2, k, v, do, lse2, delta, ts, ts_q):
    _check_call(q2, k, v, ts, ts_q)
    _check_operand("do", do, q2.device)
    b, sq, n, _ = q2.shape
    if do.shape != q2.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q {tuple(q2.shape)}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != (b, n, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous f32 (b, n, sq)")


def sta_windowed_bwd_dq(q2, k, v, do, lse2, delta, table, *, ts: int, ts_q: int, scale: float):
    """The K8 dq kernel on _bwd_operands' inputs (q prescaled, log2 LSE,
    delta): walks the forward's table."""
    _check_bwd(q2, k, v, do, lse2, delta, ts, ts_q)
    b, sq, n, _ = q2.shape
    _check_table("table", table, q2.device, (sq // ts_q, None))
    dq = torch.empty(q2.shape, dtype=q2.dtype, device=q2.device)
    rc = cuda_build.lib().scail_sta_attention_bwd_dq(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), table.data_ptr(), dq.data_ptr(), b, n, sq, k.shape[1], ts_q, ts,
        table.shape[1], *_strides(q2), *_strides(k), *_strides(v), *_strides(do),
        *_strides(dq), ctypes.c_float(scale), _stream(q2.device))
    cuda_build.check(rc, "sta_attention_bwd_dq")
    LAUNCHES["sta_attention_bwd_dq"] += 1
    return dq


def sta_windowed_bwd_dkv(q2, k, v, do, lse2, delta, inv, lens, *, ts: int, ts_q: int,
                         dkv_order=None):
    """The K8 dk/dv kernel on _bwd_operands' inputs: walks the inverse table,
    its CTAs launched in `dkv_order` (StaTables.dkv_order, heaviest first;
    None launches them in block order).  Returns (dk, dv) over every kv row."""
    _check_bwd(q2, k, v, do, lse2, delta, ts, ts_q)
    b, sq, n, _ = q2.shape
    n_blocks = -(-k.shape[1] // ts)
    _check_table("inv", inv, q2.device, (n_blocks, None))
    _check_table("lens", lens, q2.device, (n_blocks,))
    order = (_block_order(ts, k.shape[1], str(q2.device)) if dkv_order is None
             else dkv_order)
    _check_table("dkv_order", order, q2.device, (None, 2))
    if order.shape[0] > 65535:
        raise ValueError(f"dkv_order: at most 65535 dk/dv CTAs, got {order.shape[0]}")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = cuda_build.lib().scail_sta_attention_bwd_dkv(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), inv.data_ptr(), lens.data_ptr(), order.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, sq, k.shape[1], ts_q, ts, inv.shape[1], order.shape[0],
        *_strides(q2), *_strides(k), *_strides(v),
        *_strides(do), *_strides(dk), *_strides(dv), _stream(q2.device))
    cuda_build.check(rc, "sta_attention_bwd_dkv")
    LAUNCHES["sta_attention_bwd_dkv"] += 1
    return dk, dv


def sta_windowed_bwd(q, k, v, out, lse, do, tables: StaTables, *, ts: int, ts_q: int,
                     scale=None):
    """Gradient of `sta_windowed_fwd` from its output and natural-log LSE:
    (dq, dk, dv), two kernel launches.  CPU tensors take the plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return sta_windowed_bwd_plain(q, k, v, out, lse, do, tables, ts=ts, ts_q=ts_q,
                                      scale=scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"sta_windowed_bwd: no kernel for device {q.device}")
    q2, lse2, delta = _bwd_operands(q, out, lse, do, scale)
    ops = (q2, k, v, do, lse2.contiguous(), delta.contiguous())
    return (sta_windowed_bwd_dq(*ops, tables.table, ts=ts, ts_q=ts_q, scale=scale),
            *sta_windowed_bwd_dkv(*ops, tables.inv, tables.lens, ts=ts, ts_q=ts_q,
                                  dkv_order=tables.dkv_order))


class _StaWindowed(torch.autograd.Function):
    """The windowed call with its gradient (JAX _sta_windowed and its custom
    VJP): K7 with the LSE forward, K8 backward.  Under a remat policy that
    keeps the flash outputs, the recompute takes (out, lse) from the
    FlashStash (ops/attention.py)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, ts, ts_q, scale):
        out, lse = stashed_flash(lambda: sta_windowed_fwd(q, k, v, tables.table, ts=ts,
                                                          ts_q=ts_q, scale=scale, with_lse=True))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tables, ctx.ts, ctx.ts_q, ctx.scale = tables, ts, ts_q, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sta_windowed_bwd(q, k, v, out, lse, do.contiguous(), ctx.tables,
                                      ts=ctx.ts, ts_q=ctx.ts_q, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def sta_windowed(q, k, v, tables: StaTables, *, ts: int, ts_q: int, scale: float,
                 impl: str = "auto"):
    """One windowed call.  impl 'auto': the kernels (plain versions on CPU
    tensors), the LSE variant and the K8 backward when a gradient is needed;
    'xla': the plain forward on any device, differentiated by autograd."""
    if not _check_impl(impl):
        return sta_windowed_plain(q, k, v, tables.table, ts=ts, ts_q=ts_q, scale=scale)[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _StaWindowed.apply(q, k, v, tables, ts, ts_q, scale)
    return sta_windowed_fwd(q, k, v, tables.table, ts=ts, ts_q=ts_q, scale=scale)[0]


# --------------------------------------------------------------------------
# Public op
# --------------------------------------------------------------------------
def sta_attention(q, k, v, *, grid_thw: Tuple[int, int, int], ref_len: int, pose_len: int,
                  tile: Tuple[int, int] = (3, 4), window: Tuple[int, int] = (3, 3),
                  scale: float = None, pre_tiled: bool = False, windowed_pose: bool = False,
                  pose_kv_window: int = 0, impl: str = "auto"):
    """Sliding-tile self attention over the fused [ref | video | pose]
    sequence.  q/k/v: (b, s, n, d); grid_thw = (T, Hp, Wp) of the video
    part.  With pre_tiled=True, q/k/v are already in sta_order's tile-major
    layout and the output stays in it.  windowed_pose=True also restricts
    the half-res pose queries to the (t, h) tile window over video;
    pose_kv_window=w (needs windowed_pose and n_h % 4 == 0) restricts
    attention into the pose region to the w t-strips around the query's
    strip; ref queries stay dense.  impl: 'auto' kernels, 'xla' plain
    (as `ops.attention.attention`)."""
    b, s, n, d = q.shape
    T, Hp, Wp = grid_thw
    sv = T * Hp * Wp
    if s != ref_len + sv + pose_len:
        raise ValueError(f"sequence length {s} != ref {ref_len} + video {sv} + pose {pose_len}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    plan = sta_plan(tuple(grid_thw), ref_len, pose_len, tuple(tile), tuple(window),
                    bool(windowed_pose), int(pose_kv_window))
    if not pre_tiled:
        order = torch.from_numpy(plan.order).to(q.device)
        q, k, v = q[:, order], k[:, order], v[:, order]
    tables = plan.tables(q.device)
    ts = plan.ts

    def windowed(qt, ts_q):
        return sta_windowed(qt, k, v, tables, ts=ts, ts_q=ts_q, scale=scale, impl=impl)

    parts = [windowed(q[:, :sv], ts)]
    cond = sv
    if windowed_pose:
        parts.append(windowed(q[:, sv:sv + pose_len], ts // 4))
        cond = sv + pose_len
    # the conditioning queries stay dense over the whole kv (softmax is
    # order-invariant, so the tile-major kv is fine): K2, with K5 backward
    parts.append(attention(q[:, cond:], k, v, scale=scale, impl=impl))
    out = torch.cat(parts, dim=1)
    if not pre_tiled:
        out = out[:, torch.from_numpy(plan.inverse).to(q.device)]
    return out
