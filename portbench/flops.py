"""Work counts of one denoise step, from shapes alone, and the card's peaks.

A step is one DiT forward at the CFG batch (2 x the request batch) over the
fused [ref | video | pose] sequence.  Operations count a multiply-add as 2.
Linears: every projection of the DiT at the rows it runs on.  Attention:
QK^T and PV, 4 * d operations per (q, kv) pair and head; self-attention over
the pairs the request needs (all of them when dense, the visited ones under
STA, from the frozen geometry), the dual cross-attention over the text and
CLIP tokens.  Bytes: each operand read once and each result written once, in
bf16 (2 bytes), the roofline's count of what the inputs need.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from portbench.geometry import Geometry

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core operations/s, HBM bytes/s
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of operations over the bf16
    peak and bytes over the HBM rate."""
    return max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def attention_flops(batch: int, heads: int, head_dim: int, pairs: int) -> int:
    """QK^T and PV over `pairs` (q, kv) pairs of each (batch, head)."""
    return 4 * batch * heads * pairs * head_dim


def attention_bytes(batch: int, heads: int, head_dim: int, sq: int, skv: int) -> int:
    """q and out (sq rows), k and v (skv rows), bf16."""
    return BF16_BYTES * batch * heads * head_dim * 2 * (sq + skv)


@dataclasses.dataclass(frozen=True)
class Linear:
    name: str
    rows: int    # rows of the input, over the whole CFG batch
    d_in: int
    d_out: int

    @property
    def flops(self) -> int:
        return 2 * self.rows * self.d_in * self.d_out

    @property
    def bytes(self) -> int:
        return BF16_BYTES * (self.rows * (self.d_in + self.d_out) + self.d_in * self.d_out
                             + self.d_out)


def dit_linears(net: dict, geo: Geometry, batch: int, text_tokens: int,
                clip_tokens: int) -> List[Linear]:
    """Every linear of one DiT forward at CFG batch `batch` (net: the
    configuration's network params)."""
    h, inner, L = net["hidden_size"], net["inner_hidden_size"], net["num_layers"]
    te, tf = net["time_embed_dim"], net["time_freq_dim"]
    _, ph, pw = net["patch_size"]
    patch_in = net["in_channels"] * ph * pw
    patch_out = net["out_channels"] * ph * pw
    s = geo.tokens
    out = [
        Linear("patch_embed.proj", batch * (geo.ref_len + geo.video_len), patch_in, h),
        Linear("patch_embed.proj_pose", batch * geo.pose_len, patch_in, h),
        Linear("time_embed.fc1", batch, tf, te),
        Linear("time_embed.fc2", batch, te, te),
        Linear("adaln_projection.fc", batch, te, 6 * h),
        Linear("text_embedding.fc1", batch * text_tokens, net["text_dim"], h),
        Linear("text_embedding.fc2", batch * text_tokens, h, h),
        Linear("final_layer.linear", batch * geo.video_len, h, patch_out),
    ]
    if net.get("use_i2v_clip"):
        c = net.get("clip_dim", 1280)
        out += [Linear("clip_proj.fc1", batch * clip_tokens, c, c),
                Linear("clip_proj.fc2", batch * clip_tokens, c, h)]
    per_layer = [Linear("qkv", batch * s, h, 3 * h), Linear("attn_out", batch * s, h, h),
                 Linear("cross_q", batch * s, h, h),
                 Linear("cross_kv", batch * text_tokens, h, 2 * h),
                 Linear("cross_out", batch * s, h, h),
                 Linear("mlp_in", batch * s, h, inner), Linear("mlp_out", batch * s, inner, h)]
    if net.get("use_i2v_clip"):
        per_layer.append(Linear("clip_kv", batch * clip_tokens, h, 2 * h))
    out += [dataclasses.replace(lin, name=f"layers.{i}.{lin.name}")
            for i in range(L) for lin in per_layer]
    return out


@dataclasses.dataclass(frozen=True)
class StepWork:
    """Operations and bound times of one denoise step."""

    linear_flops: int
    linear_bound_s: float
    self_attn_flops: int
    self_attn_bound_s: float
    cross_attn_flops: int

    @property
    def model_flops(self) -> int:
        return self.linear_flops + self.self_attn_flops + self.cross_attn_flops


def step_work(net: dict, traffic: dict) -> StepWork:
    """The work of one denoise step of a configuration (net: its network
    params) under a traffic mix."""
    geo = Geometry(traffic["frames"], traffic["height"], traffic["width"])
    batch = 2 * traffic["batch"]  # CFG: uncond and cond halves
    n = net["num_attention_heads"]
    d = net["hidden_size"] // n
    text, clip = traffic["text_tokens"], traffic["clip_tokens"]
    lins = dit_linears(net, geo, batch, text, clip)
    s = geo.tokens
    sta: Optional[dict] = traffic.get("sta")
    L = net["num_layers"]
    self_flops = L * attention_flops(batch, n, d, geo.attention_pairs(sta))
    self_bytes = L * attention_bytes(batch, n, d, s, s)
    cross_kv = text + (clip if net.get("use_i2v_clip") else 0)
    return StepWork(
        linear_flops=sum(x.flops for x in lins),
        linear_bound_s=sum(bound_s(x.flops, x.bytes) for x in lins),
        self_attn_flops=self_flops,
        self_attn_bound_s=bound_s(self_flops, self_bytes),
        cross_attn_flops=L * attention_flops(batch, n, d, s * cross_kv))

