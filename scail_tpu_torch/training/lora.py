"""LoRA fine-tuning (counterpart of scail_tpu/training/lora.py).

`add_lora` gives every dense layer whose JAX-style path matches a target
regex the factors lora_a (in, r) ~ 0.01 N(0, 1), lora_b (r, out) = 0 and
the scale alpha / rank (a buffer); `models/common.dense` adds the delta,
on float and quantized bases alike.  `merge_lora` folds the delta into the
weight and removes the factors.  `lora_mask` leaves `requires_grad` on the
factors only, so the Trainer builds its optimizer over them alone (the JAX
Trainer's train_mask under optax.multi_transform).

The JAX paths are the stacked tree's: the port's `layers.3.qkv` is
`layers/qkv` there, layer 3 of one (L, in, r) draw.  The draw of each path
comes from its own generator, seeded from the caller's generator's seed and
zlib.crc32 of the path, so it is the same in every process (the JAX package
folds Python's per-process `hash()` of the path into its key, which is not).
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from scail_tpu_torch.ops.quant import QuantizedLinear

DEFAULT_TARGETS = (
    r"layers/(qkv|attn_out|cross_q|cross_kv|cross_out|mlp_in|mlp_out)$",
)
FACTORS = ("lora_a", "lora_b")


def jax_path(name: str) -> Tuple[str, int]:
    """A module name -> (its '/'-joined path in the stacked JAX tree, its
    layer index or -1): 'layers.3.qkv' -> ('layers/qkv', 3)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), -1


def path_seed(generator: torch.Generator, path: str) -> int:
    """The seed of a path's draw: the generator's seed and the path's crc32."""
    return ((generator.initial_seed() << 32) ^ zlib.crc32(path.encode("utf-8"))) % 2 ** 63


def _device(module: nn.Module) -> torch.device:
    return next(iter(list(module.parameters()) + list(module.buffers()))).device


def add_lora(model: nn.Module, generator: torch.Generator, rank: int = 16, alpha: float = None,
             targets: Sequence[str] = DEFAULT_TARGETS) -> nn.Module:
    """Give every matching nn.Linear / QuantizedLinear of `model` LoRA
    factors, in f32 on the layer's device, frozen until `lora_mask`.
    Returns the model."""
    if rank <= 0:
        raise ValueError(f"LoRA rank must be positive, got {rank}")
    pats = [re.compile(p) for p in targets]
    alpha = alpha if alpha is not None else rank
    groups: Dict[str, List[Tuple[int, nn.Module]]] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, QuantizedLinear)):
            path, index = jax_path(name)
            if any(p.search(path) for p in pats):
                groups.setdefault(path, []).append((index, mod))
    if not groups:
        raise ValueError(f"no dense layer matches the LoRA targets {tuple(targets)}")
    for path, mods in groups.items():
        mods.sort(key=lambda im: im[0])
        d_in, d_out = mods[0][1].in_features, mods[0][1].out_features
        draw = 0.01 * torch.randn((len(mods), d_in, rank), dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(
                                      path_seed(generator, path)))
        for (_, mod), a in zip(mods, draw):
            dev = _device(mod)
            mod.lora_a = nn.Parameter(a.to(dev, copy=True), requires_grad=False)
            mod.lora_b = nn.Parameter(torch.zeros((rank, d_out), dtype=torch.float32, device=dev),
                                      requires_grad=False)
            mod.register_buffer("lora_scale", torch.tensor(alpha / rank, dtype=torch.float32,
                                                           device=dev))
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold each layer's delta into its weight, W += (scale * A @ B)^T in f32,
    and remove the factors.  Returns the model."""
    for name, mod in model.named_modules():
        if getattr(mod, "lora_a", None) is None:
            continue
        if isinstance(mod, QuantizedLinear):
            raise ValueError(f"merge_lora: {name} is quantized; the delta folds into a float "
                             "weight only")
        delta = mod.lora_scale.float() * (mod.lora_a.float() @ mod.lora_b.float())
        mod.weight.copy_((mod.weight.float() + delta.T).to(mod.weight.dtype))
        for leaf in FACTORS + ("lora_scale",):
            delattr(mod, leaf)
    return model


def lora_mask(model: nn.Module) -> List[str]:
    """Set requires_grad on the LoRA factors and off on every other
    parameter; returns the names of the factors."""
    names = []
    for name, p in model.named_parameters():
        train = name.rsplit(".", 1)[-1] in FACTORS
        p.requires_grad_(train)
        if train:
            names.append(name)
    if not names:
        raise ValueError("the model has no LoRA factors: call add_lora first")
    return names
