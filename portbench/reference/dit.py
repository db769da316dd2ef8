"""The SCAIL DiT forward in plain PyTorch, f32, TF32 off.

Written from the model's equations, not from the port: patch embedding of
[ref | video] and of the half-resolution pose latent into one sequence, the
three-regime 3D rotary (ref at t = 0, video at t = 1..T, pose at a +120 W
offset pooled 2x2 after the trig), AdaLN blocks with a shared projection and
per-layer tables, full-width q/k RMS norms, softmax self-attention (dense,
or sliding-tile over the frozen plan of portbench.geometry), the summed text
+ CLIP cross-attention, a GELU(tanh) MLP, and the AdaLN final layer on the
video tokens.  Weights come block by block from portbench.weights, drawn
again from the seed and taken in f32, so the program's copy is never read.
Attention is chunked over query rows so that the scores of a chunk stay
within SCORE_ELEMENTS f32 values.  `Matmuls(fp8=True)` computes the same
forward with every matrix product's operands in float8: the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.geometry import plan_sta

# f32 scores of one attention chunk (4 GiB, plus as much for the softmax)
SCORE_ELEMENTS = 2 ** 30
POSE_W_OFFSET = 120
ROPE_THETA = 10000.0

Weights = Callable[[str], Dict[str, torch.Tensor]]


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls in f32 (no TF32), restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rope_tables(head_dim: int, T: int, Hp: int, Wp: int):
    """(cos, sin) (S, head_dim) f32 numpy for [ref | video | pose], the
    frequencies of each axis repeated over the interleaved pairs; the head
    dim split t = d - 4*(d//6), h = w = 2*(d//6)."""
    dim_t = head_dim - 4 * (head_dim // 6)
    dim_s = (head_dim // 6) * 2

    def freqs(dim):
        return (1.0 / ROPE_THETA ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
                ).astype(np.float32)

    ft, fs = freqs(dim_t), freqs(dim_s)

    def angles(ts, hs, ws):
        def axis(pos, f):
            return np.repeat(np.outer(np.asarray(pos, np.float32), f), 2, axis=-1)

        at, ah, aw = axis(ts, ft), axis(hs, fs), axis(ws, fs)
        n_t, n_h, n_w = len(at), len(ah), len(aw)
        return np.concatenate([
            np.broadcast_to(at[:, None, None], (n_t, n_h, n_w, at.shape[-1])),
            np.broadcast_to(ah[None, :, None], (n_t, n_h, n_w, ah.shape[-1])),
            np.broadcast_to(aw[None, None, :], (n_t, n_h, n_w, aw.shape[-1]))], axis=-1)

    frames = np.arange(1, T + 1, dtype=np.float64)
    hs, ws = np.arange(Hp, dtype=np.float64), np.arange(Wp, dtype=np.float64)
    ref = angles(np.zeros(1), hs, ws).reshape(-1, head_dim)
    vid = angles(frames, hs, ws).reshape(-1, head_dim)
    pose = angles(frames, hs, POSE_W_OFFSET + ws)

    def pool(v):
        return v.reshape(T, Hp // 2, 2, Wp // 2, 2, head_dim).mean(axis=(2, 4), dtype=np.float32)

    cos = np.concatenate([np.cos(ref), np.cos(vid), pool(np.cos(pose)).reshape(-1, head_dim)])
    sin = np.concatenate([np.sin(ref), np.sin(vid), pool(np.sin(pose)).reshape(-1, head_dim)])
    return cos.astype(np.float32), sin.astype(np.float32)


def _rope(x, cos, sin):
    """x (B, S, n, d) rotated by interleaved pairs: (x0, x1) -> (x0 c - x1 s, x1 c + x0 s)."""
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos[:, None] + rot * sin[:, None]




def _layer_norm(x, eps, scale=None, bias=None):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


class Matmuls:
    """The reference's matrix products, accumulated in f32.  With fp8, both
    operands of each are first rounded to float8 e4m3 with a scale per row
    of A and per column of B (absmax to 448), as an fp8 GEMM path would
    take them: the control of the benchmark's check."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def rows(self, t):
        """t rounded to e4m3 with one scale per row (last dim reduced)."""
        if not self.fp8:
            return t
        scale = t.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def cols(self, t):
        return self.rows(t.transpose(-1, -2)).transpose(-1, -2) if self.fp8 else t

    def linear(self, x, w, name):
        return F.linear(self.rows(x), self.rows(w[f"{name}.weight"]), w[f"{name}.bias"])

    def attend(self, q, k, v):
        """softmax(q k^T) v over (G, s, d) f32, q already scaled; chunked
        over q rows."""
        out = torch.empty_like(q)
        rows = max(1, SCORE_ELEMENTS // (q.shape[0] * k.shape[1]))
        kt, v = self.rows(k).transpose(1, 2), self.cols(v)
        for i in range(0, q.shape[1], rows):
            p = torch.softmax(torch.bmm(self.rows(q[:, i:i + rows]), kt), -1)
            out[:, i:i + rows] = torch.bmm(self.rows(p), v)
        return out


def _grouped(t):
    """(B, S, n, d) -> (B*n, S, d)."""
    B, S, n, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * n, S, d)


def _ungrouped(t, B):
    G, S, d = t.shape
    return t.reshape(B, G // B, S, d).permute(0, 2, 1, 3)


def dense_attention(mm: Matmuls, q, k, v):
    """(B, S, n, d) -> (B, S, n, d) over every key."""
    B = q.shape[0]
    scale = q.shape[-1] ** -0.5
    return _ungrouped(mm.attend(_grouped(q) * scale, _grouped(k), _grouped(v)), B)


def sta_attention(mm: Matmuls, q, k, v, plan, video_len: int, pose_len: int):
    """Sliding-tile attention in the tile-major order [video | pose | ref]:
    q tile i (its video rows and its pose rows) attends the rows of the kv
    blocks plan.table[i]; the ref rows attend every row."""
    B, S = q.shape[:2]
    scale = q.shape[-1] ** -0.5
    qg, kg, vg = _grouped(q) * scale, _grouped(k), _grouped(v)
    out = torch.empty_like(qg)
    ts, tp = plan.ts, plan.ts // 4
    dev = q.device
    for i in range(len(plan.table)):
        q_rows = torch.cat([torch.arange(i * ts, (i + 1) * ts, device=dev),
                            torch.arange(video_len + i * tp, video_len + (i + 1) * tp,
                                         device=dev)])
        kv_rows = torch.cat([torch.arange(b, e, device=dev) for b, e in plan.kv_rows(i, S)])
        out[:, q_rows] = mm.attend(qg[:, q_rows], kg[:, kv_rows], vg[:, kv_rows])
    ref0 = video_len + pose_len
    out[:, ref0:] = mm.attend(qg[:, ref0:], kg, vg)
    return _ungrouped(out, B)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64,
                                                           device=t.device) / half).float()
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _patchify(x, ph, pw):
    """(B, T, C, H, W) -> (B, T*(H/ph)*(W/pw), C*ph*pw), (t h w) rows, (c kh kw) features."""
    B, T, C, H, W = x.shape
    x = x.reshape(B, T, C, H // ph, ph, W // pw, pw).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(B, T * (H // ph) * (W // pw), C * ph * pw)


def forward(net: dict, weights: Weights, x, timesteps, context, ref_concat, pose,
            clip_features=None, sta: Optional[dict] = None, matmuls: Optional[Matmuls] = None):
    """The DiT's velocity (B, T, C, H, W) f32 for x (B, T, C, H, W); every
    input is taken in f32.  `sta`: the traffic's sliding-tile parameters, or
    None for dense attention.  `matmuls`: Matmuls() (f32) by default."""
    mm = matmuls or Matmuls()
    _linear = mm.linear
    f32 = torch.float32
    x, context, ref_concat, pose = (t.to(f32) for t in (x, context, ref_concat, pose))
    B, T, C, H, W = x.shape
    dev = x.device
    h, n = net["hidden_size"], net["num_attention_heads"]
    d = h // n
    eps = float(net["layernorm_epsilon"])
    _, ph, pw = net["patch_size"]
    Hp, Wp = H // ph, W // pw
    geo_ref, geo_video, geo_pose = Hp * Wp, T * Hp * Wp, T * (Hp // 2) * (Wp // 2)
    pad = net["in_channels"] - C

    w = weights("text_embedding")
    ctx = _linear(F.gelu(_linear(context, w, "text_embedding.fc1"), approximate="tanh"), w,
                  "text_embedding.fc2")
    clip_tokens = None
    if net.get("use_i2v_clip"):
        w = weights("clip_proj")
        y = _layer_norm(clip_features.to(f32), 1e-5, w["clip_proj.ln_in.scale"],
                        w["clip_proj.ln_in.bias"])
        y = _linear(F.gelu(_linear(y, w, "clip_proj.fc1")), w, "clip_proj.fc2")
        clip_tokens = _layer_norm(y, 1e-5, w["clip_proj.ln_out.scale"], w["clip_proj.ln_out.bias"])
    w = weights("time_embed")
    emb = _linear(F.silu(_linear(timestep_embedding(timesteps, net["time_freq_dim"]), w,
                                 "time_embed.fc1")), w, "time_embed.fc2")
    w = weights("adaln_projection")
    adaln = _linear(F.silu(emb), w, "adaln_projection.fc").reshape(B, 6, h)

    ones = torch.ones((B, 1, pad, H, W), dtype=f32, device=dev)
    video = torch.cat([torch.cat([ref_concat, ones], 2),
                       torch.cat([x, torch.zeros((B, T, pad, H, W), dtype=f32, device=dev)], 2)],
                      dim=1)
    pose_in = torch.cat([pose.to(f32), torch.ones((B, T, pad, H // 2, W // 2), dtype=f32,
                                                  device=dev)], 2)
    w = weights("patch_embed")
    hidden = torch.cat([_linear(_patchify(video, ph, pw), w, "patch_embed.proj"),
                        _linear(_patchify(pose_in, ph, pw), w, "patch_embed.proj_pose")], dim=1)
    del video, pose_in

    cos, sin = (torch.from_numpy(t).to(dev) for t in rope_tables(d, T, Hp, Wp))
    if sta is None:
        def attend(q, k, v):
            return dense_attention(mm, q, k, v)
        video_rows = torch.arange(geo_ref, geo_ref + geo_video, device=dev)
    else:
        plan = plan_sta((T, Hp, Wp), sta)
        order = torch.from_numpy(plan.order).to(dev)
        hidden, cos, sin = hidden[:, order], cos[order], sin[order]

        def attend(q, k, v):
            return sta_attention(mm, q, k, v, plan, geo_video, geo_pose)
        video_rows = torch.argsort(order)[geo_ref:geo_ref + geo_video]

    def heads(t):
        return t.unflatten(-1, (n, d))

    for i in range(net["num_layers"]):
        p = f"layers.{i}"
        w = weights(p)
        mod = adaln + w[f"{p}.adaln"][None]
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mod.unsqueeze(2).unbind(1)
        a = _layer_norm(hidden, eps) * (1 + sc_msa) + s_msa
        q, k, v = _linear(a, w, f"{p}.qkv").chunk(3, dim=-1)
        del a
        q = _rope(heads(_rms_norm(q, w[f"{p}.q_norm.scale"], eps)), cos, sin)
        k = _rope(heads(_rms_norm(k, w[f"{p}.k_norm.scale"], eps)), cos, sin)
        o = attend(q, k, heads(v)).flatten(2)
        del q, k, v
        hidden = hidden + g_msa * _linear(o, w, f"{p}.attn_out")
        del o
        cq = _rms_norm(_linear(_layer_norm(hidden, eps), w, f"{p}.cross_q"),
                       w[f"{p}.cross_q_norm.scale"], eps)
        ck, cv = _linear(ctx, w, f"{p}.cross_kv").chunk(2, dim=-1)
        ck = _rms_norm(ck, w[f"{p}.cross_k_norm.scale"], eps)
        cross = dense_attention(mm, heads(cq), heads(ck), heads(cv))
        if clip_tokens is not None:
            pk, pv = _linear(clip_tokens, w, f"{p}.clip_kv").chunk(2, dim=-1)
            pk = _rms_norm(pk, w[f"{p}.clip_k_norm.scale"], eps)
            cross = cross + dense_attention(mm, heads(cq), heads(pk), heads(pv))
        del cq
        hidden = hidden + _linear(cross.flatten(2), w, f"{p}.cross_out")
        del cross
        m = _layer_norm(hidden, eps) * (1 + sc_mlp) + s_mlp
        m = F.gelu(_linear(m, w, f"{p}.mlp_in"), approximate="tanh")
        hidden = hidden + g_mlp * _linear(m, w, f"{p}.mlp_out")
        del m, w

    w = weights("final_layer")
    fmod = emb[:, None, :] + w["final_layer.adaln"][None]
    out = hidden[:, video_rows]
    out = _layer_norm(out, eps) * (1 + fmod[:, 1:2]) + fmod[:, 0:1]
    out = _linear(out, w, "final_layer.linear")
    c_out = net["out_channels"]
    out = out.reshape(B, T, Hp, Wp, ph, pw, c_out).permute(0, 1, 6, 2, 4, 3, 5)
    return out.reshape(B, T, c_out, H, W)

