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


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def i3d_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_i3d_params` / `i3d_params_from_state_dict` pytree ->
    `InceptionI3d.state_dict()` (pytorch_i3d names): conv3d kernels to
    (out, in, kt, kh, kw), bn/{scale, bias, mean, var} to BatchNorm's names."""
    sd = {}
    for path, arr in _flatten(params):
        parts = path.split("/")
        if parts[-2] == "bn":
            key, val = ".".join(parts[:-1] + [_BN_NAMES[parts[-1]]]), arr
        else:
            key, val = _conv_leaf(path, arr)
        sd[key] = _tensor(val)
    return sd


def inception_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_inception_params` / `inception_params_from_state_dict` pytree ->
    `FIDInceptionV3.state_dict()` (pytorch-fid names): each unit's kernel to
    <unit>.conv.weight (out, in, kh, kw), its scale / bias / mean / var to
    <unit>.bn.*."""
    sd = {}
    for path, arr in _flatten(params):
        parts = path.split("/")
        stem, leaf = ".".join(parts[:-1]), parts[-1]
        if leaf == "kernel":
            sd[f"{stem}.conv.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        else:
            sd[f"{stem}.bn.{_BN_NAMES[leaf]}"] = _tensor(arr)
    return sd


def lpips_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_lpips_params` / `lpips_params_from_torch` pytree ->
    `LPIPS.state_dict()`: convs[i] to torchvision's features.N (the kernel is
    in torch's layout already), lins[k] (C,) to linK.model.1.weight (1, C, 1, 1)."""
    from scail_tpu_torch.evals.lpips import VGG_CONVS

    sd = {}
    for idx, conv in zip(VGG_CONVS, params["convs"]):
        sd[f"features.{idx}.weight"] = _tensor(np.asarray(conv["kernel"]))
        sd[f"features.{idx}.bias"] = _tensor(np.asarray(conv["bias"]))
    for k, lin in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = _tensor(np.asarray(lin).reshape(1, -1, 1, 1))
    return sd


_CLIP_LAYER_NAMES = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
                     "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                     "out": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def clip_score_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_clip_params` / `clip_params_from_*` pytree ->
    `ClipScoreModel.state_dict()` (HF CLIPModel names): stacked (L, ...)
    layers split per layer, (in, out) kernels transposed, LayerNorm scales
    to `weight`, the patch kernel to (width, 3, p, p)."""
    sd = {}
    v, t = params["vision"], params["text"]
    for tree, name in ((v, "vision_model"), (t, "text_model")):
        for part, leaves in tree["layers"].items():
            for leaf, arr in leaves.items():
                arr = np.asarray(arr)
                for i in range(arr.shape[0]):
                    key = f"{name}.encoder.layers.{i}.{_CLIP_LAYER_NAMES[part]}."
                    sd[key + ("bias" if leaf == "bias" else "weight")] = _tensor(
                        arr[i].T if leaf == "kernel" else arr[i])
    for dst, src in (("vision_model.pre_layrnorm", v["pre_ln"]),
                     ("vision_model.post_layernorm", v["post_ln"]),
                     ("text_model.final_layer_norm", t["final_ln"])):
        sd[dst + ".weight"], sd[dst + ".bias"] = _tensor(src["scale"]), _tensor(src["bias"])
    emb = "vision_model.embeddings."
    sd[emb + "class_embedding"] = _tensor(v["class_embedding"])
    sd[emb + "patch_embedding.weight"] = _tensor(
        np.asarray(v["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd[emb + "position_embedding.weight"] = _tensor(v["position_embedding"])
    sd["text_model.embeddings.token_embedding.weight"] = _tensor(t["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _tensor(t["position_embedding"])
    sd["visual_projection.weight"] = _tensor(np.asarray(params["visual_projection"]["kernel"]).T)
    sd["text_projection.weight"] = _tensor(np.asarray(params["text_projection"]["kernel"]).T)
    return sd
