"""Prefix tuning (counterpart of scail_tpu/training/prefix_tuning.py): a
learned per-layer KV prefix of `prefix_len` positions, concatenated onto
every attention's keys and values and always visible.  The zoo models
(zoo/gpt.py, zoo/llama.py) take the prefix as a forward argument; training
freezes the base and optimizes the prefix alone.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
from torch import nn


def init_prefix_params(generator: torch.Generator, num_layers: int, num_kv_heads: int,
                       prefix_len: int, head_dim: int, *, device=None) -> nn.Parameter:
    """(L, 2, n_kv, P, hd) · 0.01 standard normal, trainable."""
    t = torch.randn(num_layers, 2, num_kv_heads, prefix_len, head_dim, generator=generator,
                    device=device or generator.device)
    return nn.Parameter(0.01 * t)


def subtree_optimizer(key: str, make: Callable,
                      named_params: Iterable[Tuple[str, torch.Tensor]]):
    """`make(params)` (e.g. `lambda p: torch.optim.SGD(p, lr=0.1)`) over the
    parameters with a `key` name component alone; every other one is frozen
    (requires_grad off), as JAX's multi_transform with set_to_zero freezes
    the rest of the tree."""
    train = []
    for name, p in named_params:
        mine = key in name.split(".")
        p.requires_grad_(mine)
        if mine:
            train.append(p)
    if not train:
        raise ValueError(f"no parameter has a {key!r} name component")
    return make(train)


def prefix_only_optimizer(make: Callable, named_params: Iterable[Tuple[str, torch.Tensor]]):
    """The optimizer over the `prefix` parameters alone."""
    return subtree_optimizer("prefix", make, named_params)
