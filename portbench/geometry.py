"""Token geometry of one request, and the sliding-tile (STA) plan, frozen.

`strip_layout`, `pose_perm` and `window_table` are copies of the STA
planner's numpy geometry in the port (its `_strip_layout`, `_pose_perm` and
`_window_table`), frozen here so that the pairs the benchmark counts, and the
windows its reference attends, cannot move with the program.  `Geometry` is
the fused [ref | video | pose] sequence of a (frames, height, width) request:
the latent grid, the row counts of its three parts, and under STA the
tile-major order and the kv blocks each q tile visits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# the Wan VAE: 4x temporal (first frame alone) and 8x spatial compression;
# the DiT's (1, 2, 2) patches
VAE_T, VAE_S = 4, 8
PATCH_H = PATCH_W = 2


def strip_layout(T, Hp, Wp, ref_len, pose_len, tile_t, tile_h):
    """Video tokens permuted to tile-major order, and the positions of the
    ref and pose tokens."""
    assert T % tile_t == 0 and Hp % tile_h == 0, (T, Hp, tile_t, tile_h)
    sv = T * Hp * Wp
    n_t, n_h = T // tile_t, Hp // tile_h
    t, h, w = np.meshgrid(np.arange(T), np.arange(Hp), np.arange(Wp), indexing="ij")
    orig = ref_len + (t * Hp + h) * Wp + w
    perm = (orig.reshape(n_t, tile_t, n_h, tile_h, Wp)
            .transpose(0, 2, 1, 3, 4).reshape(-1))
    s_total = ref_len + sv + pose_len
    glob = np.concatenate([np.arange(ref_len), np.arange(ref_len + sv, s_total)])
    return perm.astype(np.int32), glob.astype(np.int32), n_t, n_h


def pose_perm(T, Hp, Wp, ref_len, pose_len, tile_t, tile_h):
    """Half-resolution pose tokens permuted to tile-major order, pose tile
    (it, ih) covering the (t, h) region of video tile (it, ih)."""
    hp, wp = Hp // 2, Wp // 2
    assert tile_h % 2 == 0 and Wp % 2 == 0 and (tile_t * tile_h * Wp) % 32 == 0
    assert pose_len == T * hp * wp
    pt_h = tile_h // 2
    n_t, n_h = T // tile_t, Hp // tile_h
    sv = T * Hp * Wp
    t, h, w = np.meshgrid(np.arange(T), np.arange(hp), np.arange(wp), indexing="ij")
    orig = ref_len + sv + (t * hp + h) * wp + w
    perm = (orig.reshape(n_t, tile_t, n_h, pt_h, wp)
            .transpose(0, 2, 1, 3, 4).reshape(-1))
    return perm.astype(np.int32)


def window_table(n_t, n_h, win_t, win_h, n_pose_blocks, n_ref_blocks, pose_kv_win_t=0):
    """(n_tiles, n_steps) kv blocks of each q tile: a clamped (win_t, win_h)
    window of video tiles, then the pose blocks (with pose_kv_win_t > 0 only
    those of the pose_kv_win_t t-strips around the tile's strip), then every
    ref block, last."""
    wt, wh = min(win_t, n_t), min(win_h, n_h)
    n_v = n_t * n_h
    bps = n_pose_blocks // n_t if pose_kv_win_t else 0
    pw = min(pose_kv_win_t, n_t) if pose_kv_win_t else 0
    rows = []
    for it in range(n_t):
        t0 = min(max(it - wt // 2, 0), n_t - wt)
        p0 = min(max(it - pw // 2, 0), n_t - pw) if pw else 0
        for ih in range(n_h):
            h0 = min(max(ih - wh // 2, 0), n_h - wh)
            row = [(t0 + dt) * n_h + (h0 + dh) for dt in range(wt) for dh in range(wh)]
            if pw:
                row += [n_v + (p0 + dt) * bps + g for dt in range(pw) for g in range(bps)]
            else:
                row += [n_v + g for g in range(n_pose_blocks)]
            row += [n_v + n_pose_blocks + g for g in range(n_ref_blocks)]
            rows.append(row)
    return np.asarray(rows, np.int32)


@dataclasses.dataclass(frozen=True)
class StaPlan:
    """Sliding-tile attention over the tile-major sequence [video | pose |
    ref] (windowed pose queries): q tile i is video rows [i*ts, (i+1)*ts)
    and pose rows [sv + i*ts/4, sv + (i+1)*ts/4); both attend the kv rows
    of the blocks table[i] (block j = rows [j*ts, (j+1)*ts), the last one
    short); the ref rows attend every row."""

    ts: int
    order: np.ndarray    # tile-major position -> original position
    table: np.ndarray    # (n_tiles, n_steps) kv blocks

    def kv_rows(self, i: int, s_total: int) -> List[Tuple[int, int]]:
        """[start, end) row ranges of the blocks q tile i visits."""
        return [(j * self.ts, min((j + 1) * self.ts, s_total)) for j in self.table[i].tolist()]


def plan_sta(grid: Tuple[int, int, int], sta: dict) -> StaPlan:
    """The plan of the port's default STA (windowed pose queries) on the
    (T, Hp, Wp) grid, sta: {tile, window, pose_kv_window}.  The pose region
    is windowed in t when a strip holds a multiple of 4 tiles (each strip's
    pose tiles then fill whole blocks), else attended whole."""
    if not sta.get("windowed_pose", True):
        raise NotImplementedError("the benchmark's STA is the windowed-pose layout")
    T, Hp, Wp = grid
    tile, window, pose_kv_window = tuple(sta["tile"]), tuple(sta["window"]), int(
        sta["pose_kv_window"])
    ref_len, sv, pose_len = Hp * Wp, T * Hp * Wp, T * (Hp // 2) * (Wp // 2)
    perm, _, n_t, n_h = strip_layout(T, Hp, Wp, ref_len, pose_len, tile[0], tile[1])
    pperm = pose_perm(T, Hp, Wp, ref_len, pose_len, tile[0], tile[1])
    ts = tile[0] * tile[1] * Wp
    if pose_kv_window and n_h % 4 == 0:
        table = window_table(n_t, n_h, window[0], window[1], pose_len // ts,
                             -(-ref_len // ts), pose_kv_window)
    else:
        table = window_table(n_t, n_h, window[0], window[1], 0,
                             -(-(ref_len + pose_len) // ts), 0)
    order = np.concatenate([perm, pperm, np.arange(ref_len, dtype=np.int32)])
    assert len(order) == ref_len + sv + pose_len
    return StaPlan(ts=ts, order=order.astype(np.int64), table=table)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The fused token sequence of one request at (frames, height, width)."""

    frames: int
    height: int
    width: int

    @property
    def latent(self) -> Tuple[int, int, int]:
        """(T, H, W) of the latent: 81 frames at 512x896 -> (21, 64, 112)."""
        return ((self.frames - 1) // VAE_T + 1, self.height // VAE_S, self.width // VAE_S)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(T, Hp, Wp) after the patch embedding."""
        T, H, W = self.latent
        return T, H // PATCH_H, W // PATCH_W

    @property
    def ref_len(self) -> int:
        _, Hp, Wp = self.grid
        return Hp * Wp

    @property
    def video_len(self) -> int:
        T, Hp, Wp = self.grid
        return T * Hp * Wp

    @property
    def pose_len(self) -> int:
        T, Hp, Wp = self.grid
        return T * (Hp // 2) * (Wp // 2)

    @property
    def tokens(self) -> int:
        return self.ref_len + self.video_len + self.pose_len

    def attention_pairs(self, sta: Optional[dict] = None) -> int:
        """(q, kv) pairs self-attention needs for one sequence: every pair
        when dense; under STA the pairs of each q tile with the real rows
        of its blocks, and of every ref row with every row."""
        s = self.tokens
        if sta is None:
            return s * s
        plan = plan_sta(self.grid, sta)
        kv = sum(sum(e - b for b, e in plan.kv_rows(i, s)) for i in range(len(plan.table)))
        # each table row serves a video q tile of ts rows and a pose one of ts/4
        return (plan.ts + plan.ts // 4) * kv + self.ref_len * s
