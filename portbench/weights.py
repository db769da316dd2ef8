"""The DiT's weights, a pure function of (seed, block name).

Every block of the DiT (`layers.<i>`, and each top-level module) is one
normal draw from a generator seeded by (seed, block), on the device, scaled
and shifted per parameter, and rounded once to the type the DiT is served
in.  The harness hands these tensors to the port's DiT as its parameters (no
second copy); the reference draws the same block again, one at a time, and
computes in f32 from the served values.

The scales are the benchmark's own, chosen so that every part of a layer
moves the output: linears N(0, 0.02) with N(0, 0.02) biases, the patch and
final projections xavier-normal, the AdaLN tables N(0, ADALN_STD^2) (gates
of a trained model's size, so that 30 or 40 layers matter next to the patch
embedding), and the q/k RMS-norm scales near QK_NORM_SCALE, which makes the
attention logits' spread about 2 and each query's softmax pick a few hundred
keys of the 48,832 rather than average them all.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

ADALN_STD = 0.4
QK_NORM_SCALE = 1.5
LINEAR_STD = 0.02
# each parameter starts on a 64-element boundary of its block (128 bytes in bf16)
ALIGN = 64

Spec = List[Tuple[str, Tuple[int, ...]]]


def derive_seed(seed: int, *names: str) -> int:
    """A 63-bit generator seed from the run's seed (any size) and names."""
    digest = hashlib.sha256(":".join([str(int(seed)), *names]).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def dit_param_specs(net: dict) -> Dict[str, Spec]:
    """{block: [(parameter name, shape), ...]} of the DiT, in the port's
    state-dict names (net: the configuration's network params; the
    shared-AdaLN DiT of SCAIL)."""
    h, inner, L = net["hidden_size"], net["inner_hidden_size"], net["num_layers"]
    te, tf = net["time_embed_dim"], net["time_freq_dim"]
    _, ph, pw = net["patch_size"]
    patch_in = net["in_channels"] * ph * pw
    patch_out = net["out_channels"] * ph * pw
    if not net.get("share_adaln"):
        raise NotImplementedError("the benchmark's DiTs share one AdaLN projection")

    def lin(name, d_in, d_out):
        return [(f"{name}.weight", (d_out, d_in)), (f"{name}.bias", (d_out,))]

    specs = {
        "patch_embed": lin("patch_embed.proj", patch_in, h) + lin("patch_embed.proj_pose",
                                                                  patch_in, h),
        "time_embed": lin("time_embed.fc1", tf, te) + lin("time_embed.fc2", te, te),
        "text_embedding": lin("text_embedding.fc1", net["text_dim"], h)
        + lin("text_embedding.fc2", h, h),
        "final_layer": [("final_layer.adaln", (2, h))] + lin("final_layer.linear", h, patch_out),
        "adaln_projection": lin("adaln_projection.fc", te, 6 * h),
    }
    clip = net.get("use_i2v_clip")
    if clip:
        c = net.get("clip_dim", 1280)
        specs["clip_proj"] = ([("clip_proj.ln_in.scale", (c,)), ("clip_proj.ln_in.bias", (c,))]
                              + lin("clip_proj.fc1", c, c) + lin("clip_proj.fc2", c, h)
                              + [("clip_proj.ln_out.scale", (h,)),
                                 ("clip_proj.ln_out.bias", (h,))])
    for i in range(L):
        p = f"layers.{i}"
        block = [(f"{p}.adaln", (6, h))]
        for name, d_in, d_out in (("qkv", h, 3 * h), ("attn_out", h, h), ("cross_q", h, h),
                                  ("cross_kv", h, 2 * h), ("cross_out", h, h),
                                  ("mlp_in", h, inner), ("mlp_out", inner, h)):
            block += lin(f"{p}.{name}", d_in, d_out)
        norms = ["q_norm", "k_norm", "cross_q_norm", "cross_k_norm"] + (
            ["clip_k_norm"] if clip else [])
        block += [(f"{p}.{n}.scale", (h,)) for n in norms]
        if clip:
            block += lin(f"{p}.clip_kv", h, 2 * h)
        specs[p] = block
    return specs


def _mean_std(name: str, shape) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "adaln":
        return 0.0, ADALN_STD
    if leaf == "scale":  # RMS-norm scales of q and k; LayerNorm scales of the CLIP projection
        return (1.0, 0.1) if name.startswith("clip_proj.") else (QK_NORM_SCALE, 0.1)
    if leaf == "bias":
        return 0.0, LINEAR_STD
    if name.startswith(("patch_embed.", "final_layer.linear")):
        return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))
    return 0.0, LINEAR_STD


def block_tensors(seed: int, block: str, spec: Spec, *, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one block, views into one buffer of `dtype`."""
    offsets, total = [], 0
    for _, shape in spec:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", block))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    for (name, shape), off in zip(spec, offsets):
        mean, std = _mean_std(name, shape)
        flat[off:off + math.prod(shape)].mul_(std).add_(mean)
    flat = flat.to(dtype)
    return {name: flat[off:off + math.prod(shape)].view(shape)
            for (name, shape), off in zip(spec, offsets)}
