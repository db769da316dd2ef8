"""Adapter fine-tuning and MLP heads (counterpart of
scail_tpu/training/adapters.py): a bottleneck MLP after the attention
output and after the MLP output of every layer (x + up(gelu(down(x))), the
GELU in its tanh form, as `jax.nn.gelu` defaults), drawn near zero so the
adapted model starts at the base model's function; the zoo's GPT takes them
as a forward argument (models/zoo/gpt.py `adapters=`).  Training passes the
`adapters` parameters alone to the optimizer; the rest stays frozen.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import container, gelu_tanh, linear
from scail_tpu_torch.training.prefix_tuning import subtree_optimizer


def _bottleneck(hidden: int, inner: int, device):
    return container(down=linear(hidden, inner, device=device),
                     up=linear(inner, hidden, device=device))


class Adapters(nn.Module):
    """Per layer: attn and mlp, each {down (inner, hidden), up (hidden, inner)}
    with biases."""

    def __init__(self, num_layers: int, hidden_size: int, adapter_hidden: int,
                 device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            container(attn=_bottleneck(hidden_size, adapter_hidden, device),
                      mlp=_bottleneck(hidden_size, adapter_hidden, device))
            for _ in range(num_layers))


def init_adapter_params(generator: torch.Generator, num_layers: int, hidden_size: int,
                        adapter_hidden: int, std: float = 1e-3, *, device=None) -> Adapters:
    """Weights N(0, std), biases zero, trainable."""
    a = Adapters(num_layers, hidden_size, adapter_hidden,
                 device=device or generator.device)
    with torch.no_grad():
        for name, p in a.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
            p.requires_grad_(True)
    return a


def apply_adapter(p, x):
    """x + up(gelu_tanh(down(x))); p holds one layer's {down, up}."""
    h = gelu_tanh(F.linear(x, p.down.weight, p.down.bias))
    return x + F.linear(h, p.up.weight, p.up.bias)


def adapters_only_optimizer(make: Callable, named_params: Iterable[Tuple[str, torch.Tensor]]):
    """`make(params)` over the parameters with an `adapters` name component
    (e.g. a model holding `base` and `adapters`); every other one frozen."""
    return subtree_optimizer("adapters", make, named_params)


class MLPHead(nn.Module):
    """A linear stack with the activation between its layers."""

    def __init__(self, hidden_size: int, *output_sizes: int, device="cuda"):
        super().__init__()
        sizes = (hidden_size, *output_sizes)
        self.layers = nn.ModuleList(linear(a, b, device=device)
                                    for a, b in zip(sizes[:-1], sizes[1:]))


def init_mlp_head_params(generator: torch.Generator, hidden_size: int, *output_sizes: int,
                         std: float = 0.005, device=None) -> MLPHead:
    """Weights N(0, std), biases zero, trainable."""
    head = MLPHead(hidden_size, *output_sizes, device=device or generator.device)
    with torch.no_grad():
        for layer in head.layers:
            layer.weight.normal_(0.0, std, generator=generator)
            layer.bias.zero_()
    head.requires_grad_(True)
    return head


def mlp_head(head: MLPHead, x, act=F.relu):
    """The head over final hidden states, `act` between its linears."""
    for i, layer in enumerate(head.layers):
        if i > 0:
            x = act(x)
        x = F.linear(x, layer.weight, layer.bias)
    return x
