"""Weight bridge: the JAX package's parameter pytrees (nested dicts of numpy
arrays) -> the port's state_dicts, so both packages compute the same
function in the parity tests.

Rules: a pytree path a/b/kernel becomes a.b.weight with the (in, out)
kernel transposed to nn.Linear's (out, in); the quantized codes qweight
(in, out) int8 and qweight4 (in/2, out) uint8 of ops/quant.py keep their
names and dtypes and are transposed the same way, to the port's (out, in)
and (out, in/2); every other leaf keeps its name and layout, floats in f32
and integers in their own dtype.  Stacked (L, ...) layer leaves are split into per-layer modules;
a DiT tree in the save_attn_frac layout (layers/head_layers + layers/tail_layers, as the JAX
trainer stores it) is first joined along the layer axis, as unsplit_layer_params does.
LoRA factors (lora_a (in, r), lora_b (r, out), lora_scale) keep their names and layouts,
as `layers.3.qkv.lora_a`.  Convolution kernels move from channels-last to PyTorch's (out, in, *k).
This module imports no jax: it takes numpy arrays (np.asarray each leaf).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten(v, path)
        elif isinstance(v, tuple) and not v:
            continue  # optax's MaskedNode: a frozen leaf of a masked optimizer state
        else:
            yield path, np.asarray(v)


def _linear_leaf(path: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[-1] in ("kernel", "qweight", "qweight4"):
        parts[-1] = "weight" if parts[-1] == "kernel" else parts[-1]
        arr = np.swapaxes(arr, -1, -2)
    return ".".join(parts), arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    dtype = arr.dtype if arr.dtype.kind in "iub" else np.float32
    return torch.from_numpy(np.array(arr, dtype=dtype, order="C", copy=True))


def _stacked(params, leaf_fn, stack_key: str = "layers",
             torch_key: str = "layers") -> Dict[str, torch.Tensor]:
    """Apply leaf_fn to every leaf; split the (L, ...) leaves under stack_key."""
    sd = {}
    for path, arr in _flatten(params):
        if path.startswith(stack_key + "/"):
            rest = path[len(stack_key) + 1:]
            for i in range(arr.shape[0]):
                key, val = leaf_fn(rest, arr[i])
                sd[f"{torch_key}.{i}.{key}"] = _tensor(val)
        else:
            key, val = leaf_fn(path, arr)
            sd[key] = _tensor(val)
    return sd


def _join(head, tail):
    if isinstance(head, dict):
        return {k: _join(head[k], tail[k]) for k in head}
    return np.concatenate([np.asarray(head), np.asarray(tail)], axis=0)


def _unsplit_layers(params):
    """The JAX unsplit_layer_params, in numpy: layers/{head,tail}_layers ->
    one (L, ...) stack."""
    layers = params.get("layers")
    if not (isinstance(layers, dict) and "head_layers" in layers):
        return params
    return {**params, "layers": _join(layers["head_layers"], layers["tail_layers"])}


def dit_state_dict_from_jax(params, cfg=None) -> Dict[str, torch.Tensor]:
    """`init_dit_params` / converted-checkpoint pytree, stacked or split for
    save_attn_frac -> `DiT.state_dict()`."""
    return _stacked(_unsplit_layers(params), _linear_leaf)


def _conv_leaf(path: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        # (kt, kh, kw, i, o) / (kh, kw, i, o) -> (o, i, kt, kh, kw) / (o, i, kh, kw)
        nk = arr.ndim - 2
        arr = arr.transpose(nk + 1, nk, *range(nk))
    return ".".join(parts), arr


def wan_vae_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_wan_vae_params` pytree -> `WanVAEModel.state_dict()`."""
    return {k: _tensor(v) for k, v in (_conv_leaf(p, a) for p, a in _flatten(params))}


def umt5_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_umt5_params` pytree -> `UMT5Encoder.state_dict()`."""
    return _stacked(params, _linear_leaf)


def clip_vision_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_clip_vision_params` pytree -> `ClipVisionTower.state_dict()`."""
    return _stacked(params, lambda p, a: _conv_leaf(p, a) if p.startswith("patch_embedding")
                    else _linear_leaf(p, a))


def ema_adam_state_from_jax(state):
    """A JAX `EmaAdamState` (count, exp_avg, exp_avg_sq, shadow: DiT-shaped
    pytrees, stacked or split) -> the port's EmaAdamState keyed like
    `DiT.named_parameters()`.  Under a train mask (LoRA: the state that
    optax.multi_transform leaves) the frozen leaves are MaskedNodes and get
    no entry, as the port keeps no state for frozen parameters."""
    from scail_tpu_torch.training.ema_adam import EmaAdamState

    return EmaAdamState(count=int(np.asarray(state.count)),
                        exp_avg=dit_state_dict_from_jax(state.exp_avg),
                        exp_avg_sq=dit_state_dict_from_jax(state.exp_avg_sq),
                        shadow=dit_state_dict_from_jax(state.shadow))
