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


def _tree_paths(tree, prefix=""):
    """(path, array) of every leaf of nested dicts and lists (list items by
    index)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            yield from _tree_paths(v, path)
        else:
            yield path, np.asarray(v)


def _torch_layout(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """A kernel to torch's layout: (in, out) -> (out, in); (k, in, out) and
    (kh, kw, in, out) -> (out, in, *k).  scale and embedding become weight."""
    if leaf == "kernel":
        nk = arr.ndim - 2
        arr = arr.T if nk == 0 else arr.transpose(nk + 1, nk, *range(nk))
        return "weight", arr
    return ("weight" if leaf in ("scale", "embedding") else leaf), arr


# JAX UNet tree names -> the reference's module names, per path component
_UNET_PARTS = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "out_norm": "out_layers.0",
               "out_conv": "out_layers.3", "emb": "emb_layers.1", "skip": "skip_connection",
               "blocks": "transformer_blocks", "to_out": "to_out.0"}


def unet_state_dict_from_jax(params, num_classes=None) -> Dict[str, torch.Tensor]:
    """`UNetModel.init` / `unet_params_from_torch` pytree -> the port's
    `UNetModel.state_dict()` (openaimodel names); `num_classes` as the
    model's (its 'timestep' MLP sits at label_emb.1, 'sequential' at
    label_emb.0)."""
    seq = 1 if num_classes == "timestep" else 0
    label = {"0": f"label_emb.{seq}.0", "1": f"label_emb.{seq}.2"}
    sd = {}
    for path, arr in _tree_paths(params):
        parts = path.split("/")
        head, rest = parts[0], parts[1:-1]
        if head == "time_embed":
            stem = f"time_embed.{2 * int(rest[0])}"
        elif head in ("out_norm", "out_conv"):
            stem = "out.0" if head == "out_norm" else "out.2"
        elif head == "label_emb":
            # int classes: label_emb/embedding; continuous: a linear;
            # timestep / sequential: [linear, linear]
            stem = label[rest[0]] if rest else "label_emb"
        else:
            blocks = {"input": "input_blocks", "middle": "middle_block",
                      "output": "output_blocks"}[head]
            names = []
            for i, c in enumerate(rest):
                if c == "proj_in" and i and rest[i - 1] in ("ff", "ff_in"):
                    names[-1:] = [f"{rest[i - 1]}.net.0.proj"]
                elif c == "proj_out" and i and rest[i - 1] in ("ff", "ff_in"):
                    names[-1:] = [f"{rest[i - 1]}.net.2"]
                else:
                    names.append(_UNET_PARTS.get(c, c))
            stem = ".".join([blocks] + names)
        leaf, val = _torch_layout(parts[-1], arr)
        sd[f"{stem}.{leaf}"] = _tensor(val)
    return sd


def _video_unet_layer(lp):
    """A VideoUNet layer's JAX tree in the 2-D UNet's shape: a video res
    block's `spatial` ResBlock at the block's own level (sgm's VideoResBlock
    subclasses ResBlock), `time_pos_embed` [0, 1] at sgm's Sequential indices
    0 and 2."""
    if not isinstance(lp, dict):
        return lp
    if "spatial" in lp:
        lp = {**lp["spatial"], **{k: v for k, v in lp.items() if k != "spatial"}}
    if "time_pos_embed" in lp:
        lp = {**lp, "time_pos_embed": {"0": lp["time_pos_embed"][0],
                                       "2": lp["time_pos_embed"][1]}}
    return lp


def video_unet_state_dict_from_jax(params, num_classes=None) -> Dict[str, torch.Tensor]:
    """`VideoUNet.init` / `video_unet_params_from_torch` pytree -> the port's
    `VideoUNet.state_dict()` (sgm names)."""
    tree = dict(params)
    for part in ("input", "output"):
        tree[part] = [[_video_unet_layer(lp) for lp in blk] for blk in params[part]]
    tree["middle"] = [_video_unet_layer(lp) for lp in params["middle"]]
    return unet_state_dict_from_jax(tree, num_classes)


def autoencoder_kl_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`AutoencoderKL.init_params` / `autoencoder_kl_params_from_torch` pytree
    -> the port's `AutoencoderKL.state_dict()` (encoder.*, decoder.*,
    quant_conv, post_quant_conv): a normalize's {norm: ...} to its own name,
    downsample / upsample kernels to `.conv`."""
    sd = {}
    for path, arr in _tree_paths(params):
        parts = path.split("/")
        names = []
        for i, c in enumerate(parts[:-1]):
            if c == "norm" and i and parts[i - 1] in ("norm1", "norm2", "norm", "norm_out"):
                continue
            names.append(c + ".conv" if c in ("downsample", "upsample") else c)
        leaf, val = _torch_layout(parts[-1], arr)
        sd[".".join(names + [leaf])] = _tensor(val)
    return sd


def clip_text_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX embedders' text tower (`init_text_tower`, `text_params_from_hf`,
    `text_params_from_open_clip`: text/{...} and, for open_clip,
    text_projection) -> the port's `ClipTextTower.state_dict()`."""
    sd = _clip_tower_from_jax(params["text"], "text_model")
    t = params["text"]
    sd["text_model.final_layer_norm.weight"] = _tensor(t["final_ln"]["scale"])
    sd["text_model.final_layer_norm.bias"] = _tensor(t["final_ln"]["bias"])
    sd["text_model.embeddings.token_embedding.weight"] = _tensor(t["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _tensor(t["position_embedding"])
    if "text_projection" in params:
        sd["text_projection.weight"] = _tensor(
            np.asarray(params["text_projection"]["kernel"]).T)
    return sd


_CLIP_LAYER_NAMES = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
                     "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                     "out": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _clip_tower_from_jax(tree, name) -> Dict[str, torch.Tensor]:
    """A CLIP tower's stacked (L, ...) layers -> `{name}.encoder.layers.{i}.*`."""
    sd = {}
    for part, leaves in tree["layers"].items():
        for leaf, arr in leaves.items():
            arr = np.asarray(arr)
            for i in range(arr.shape[0]):
                key = f"{name}.encoder.layers.{i}.{_CLIP_LAYER_NAMES[part]}."
                sd[key + ("bias" if leaf == "bias" else "weight")] = _tensor(
                    arr[i].T if leaf == "kernel" else arr[i])
    return sd


def clip_score_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_clip_params` / `clip_params_from_*` pytree ->
    `ClipScoreModel.state_dict()` (HF CLIPModel names): stacked (L, ...)
    layers split per layer, (in, out) kernels transposed, LayerNorm scales
    to `weight`, the patch kernel to (width, 3, p, p)."""
    v, t = params["vision"], params["text"]
    sd = {**_clip_tower_from_jax(v, "vision_model"), **_clip_tower_from_jax(t, "text_model")}
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


# ---------------------------------------------------------------------------
# the autoencoder training stack (scail_tpu/autoencoding/)
# ---------------------------------------------------------------------------
_NORM_HOLDERS = ("norm1", "norm2", "norm", "norm_out")


def vqmodel_state_dict_from_jax(params, movq: bool = False) -> Dict[str, torch.Tensor]:
    """`VQModel.init_params` / `vqmodel_params_from_torch` pytree -> the port's
    VQModel / MOVQ state dict: a normalize's {norm: ...} to its own name (to
    `norm_layer` beside MOVQ's conv_y / conv_b), resample kernels to `.conv`,
    the codebook to quantize.embedding.weight."""
    sd = {}
    for path, arr in _tree_paths(params):
        parts = path.split("/")
        if parts[:2] == ["quantize", "embedding"]:
            sd["quantize.embedding.weight"] = _tensor(arr)
            continue
        names = []
        for i, c in enumerate(parts[:-1]):
            if c == "norm" and i and parts[i - 1] in _NORM_HOLDERS:
                if movq and parts[0] == "decoder":
                    names.append("norm_layer")
                continue
            names.append(c + ".conv" if c in ("downsample", "upsample") else c)
        leaf, val = _torch_layout(parts[-1], arr)
        sd[".".join(names + [leaf])] = _tensor(val)
    return sd


def ema_quantizer_state_dict_from_jax(state) -> Dict[str, torch.Tensor]:
    """`init_ema_quantizer` / the new_state of `ema_vector_quantize` ->
    EMAVectorQuantizer's buffers."""
    return {f"embedding.{k}": _tensor(np.asarray(state[k]))
            for k in ("weight", "cluster_size", "embed_avg")}


def lfq_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_lfq` -> LFQ's project_in / project_out (empty when dim equals
    the code bits)."""
    return {f"{name}.{leaf}": _tensor(val) for name in ("project_in", "project_out")
            if name in params for leaf, val in (_torch_layout(k, np.asarray(a))
                                                for k, a in params[name].items())}


def nlayer_discriminator_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_nlayer_discriminator` -> NLayerDiscriminator's `main.{i}.*`: the
    first conv at 0, each [conv, bn] after it 3 indices apart, the logit conv
    last; the BatchNorm running buffers at their initial values."""
    sd = {}
    layers = params["layers"]
    idx = 0
    for i, layer in enumerate(layers):
        for k, a in layer["conv"].items():
            leaf, val = _torch_layout(k, np.asarray(a))
            sd[f"main.{idx}.{leaf}"] = _tensor(val)
        if "bn" in layer:
            bn = f"main.{idx + 1}"
            sd[f"{bn}.weight"] = _tensor(np.asarray(layer["bn"]["scale"]))
            sd[f"{bn}.bias"] = _tensor(np.asarray(layer["bn"]["bias"]))
            c = sd[f"{bn}.weight"].shape[0]
            sd[f"{bn}.running_mean"] = torch.zeros(c)
            sd[f"{bn}.running_var"] = torch.ones(c)
            sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        idx += 3 if "bn" in layer else 2
    return sd


_VIDEO_DISC_NAMES = {"in": "proj_in", "out": "proj_out"}


def video_discriminator_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`init_video_discriminator` -> VideoDiscriminator: blocks.{i}.* (the
    feed-forward's in / out to proj_in / proj_out, the RMS norms' `scale`
    kept), head/conv and head/linear to head_conv / head_linear; the
    attention's `heads` count is structure, not a tensor."""
    sd = {}
    for path, arr in _tree_paths(params):
        parts = path.split("/")
        if parts[-1] == "heads":
            continue
        if parts[0] == "head":
            parts = [f"head_{parts[1]}"] + parts[2:]
        if "ff" in parts and parts[-2] in _VIDEO_DISC_NAMES:
            parts[-2] = _VIDEO_DISC_NAMES[parts[-2]]
        leaf, val = (parts[-1], arr) if parts[-1] == "scale" else _torch_layout(parts[-1], arr)
        sd[".".join(parts[:-1] + [leaf])] = _tensor(val)
    return sd


def _conv_pair(prefix, p) -> Dict[str, torch.Tensor]:
    out = {}
    for k, a in p.items():
        leaf, val = _torch_layout(k, np.asarray(a))
        out[f"{prefix}.{leaf}"] = _tensor(val)
    return out


def _res_units(prefix, layer) -> Dict[str, torch.Tensor]:
    units = layer["units"]
    sd = {}
    for j, u in enumerate(units):
        pfx = prefix if len(units) == 1 else f"{prefix}.{j}"
        sd.update(_conv_pair(f"{pfx}.fn.0.conv", u["conv"]))
        sd.update(_conv_pair(f"{pfx}.fn.2", u["proj"]))
        sd.update(_conv_pair(f"{pfx}.fn.4.to_k", u["se"]["to_k"]))
        sd.update(_conv_pair(f"{pfx}.fn.4.net.0", u["se"]["net0"]))
        sd.update(_conv_pair(f"{pfx}.fn.4.net.2", u["se"]["net2"]))
    return sd


def video_tokenizer_state_dict_from_jax(params, plan) -> Dict[str, torch.Tensor]:
    """`VideoTokenizer.init_params` -> the port's VideoTokenizer (the
    reference's names, as video_tokenizer_params_from_torch reads them);
    `plan` is the tokenizer's layer plan (VideoTokenizer.plan)."""
    n = len(plan)
    sd = {**_conv_pair("conv_in.conv", params["conv_in"]),
          **_conv_pair("conv_out.conv", params["conv_out"])}
    for i, ((typ, *_), layer) in enumerate(zip(plan, params["enc_layers"])):
        sd.update(_res_units(f"encoder_layers.{i}", layer) if typ == "residual"
                  else _conv_pair(f"encoder_layers.{i}.conv", layer["conv"]))
    for j, ((typ, *_), layer) in enumerate(zip(reversed(plan), params["dec_layers"])):
        sd.update(_res_units(f"decoder_layers.{j}", layer) if typ == "residual"
                  else _conv_pair(f"decoder_layers.{j}.net.0", layer["conv"]))
    sd[f"encoder_layers.{n}.1.weight"] = _tensor(np.asarray(params["final_norm"]["scale"]))
    sd[f"encoder_layers.{n}.1.bias"] = _tensor(np.asarray(params["final_norm"]["bias"]))
    sd.update({f"quantizers.{k}": v for k, v in lfq_state_dict_from_jax(params["lfq"]).items()})
    return sd


def lm_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A zoo decoder LM's pytree (stacked `layers/...` leaves; `init_*_params`
    or a `*_params_from_hf` / `*_params_from_sat` converter) -> the port
    model's `state_dict()` (models/zoo/): layer i's leaves at `layers.i.*`,
    kernels transposed to (out, in), an expert stack (E, in, out) to (E, out,
    in); tables and norms keep their names."""
    return _stacked(params, _linear_leaf)


# one name per zoo module, as the parity tests call them
llama_state_dict_from_jax = lm_state_dict_from_jax
mixtral_state_dict_from_jax = lm_state_dict_from_jax
gpt_state_dict_from_jax = lm_state_dict_from_jax
gptneo_state_dict_from_jax = lm_state_dict_from_jax
glm_state_dict_from_jax = lm_state_dict_from_jax
chatglm_state_dict_from_jax = lm_state_dict_from_jax
chatglm2_state_dict_from_jax = lm_state_dict_from_jax
glm130b_state_dict_from_jax = lm_state_dict_from_jax
glmblock_state_dict_from_jax = lm_state_dict_from_jax
cuda2d_state_dict_from_jax = lm_state_dict_from_jax


# ---------------------------------------------------------------------------
# the encoder zoo, the adapters and the MLP head (models/zoo/, training/)
# ---------------------------------------------------------------------------
_ENCODER_STACKS = ("layers", "enc_layers", "dec_layers")
# JAX leaf names that nn.Module owns as attributes, and the port's names
_ENCODER_RENAMES = {"type": "token_type"}


def encoder_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A zoo encoder's pytree (`init_*_params` or a `*_params_from_hf` /
    `*_params_from_sat` converter, or a tree that nests them, as GLM-4V's
    {vit, adapter, glm}) -> the port model's `state_dict()`: each stacked
    leaf under a `layers` / `enc_layers` / `dec_layers` key split into
    `<key>.i.*`, 2-D kernels transposed to (out, in), a patch embedding's
    HWIO kernel to (out, in, kh, kw); a 4-D kernel elsewhere (GLM-4V's
    adapter conv) is the SAT layout already and keeps it."""
    sd = {}
    for path, arr in _flatten(params):
        parts = [_ENCODER_RENAMES.get(p, p) for p in path.split("/")]
        stack = next((i for i, p in enumerate(parts) if p in _ENCODER_STACKS), None)
        rows = [(None, arr)] if stack is None else list(enumerate(arr))
        for i, a in rows:
            names = list(parts)
            if i is not None:
                names.insert(stack + 1, str(i))
            if names[-1] == "kernel":
                names[-1] = "weight"
                if a.ndim == 2:
                    a = a.T
                elif a.ndim == 4 and any(p == "patch_embed" for p in names):
                    a = a.transpose(3, 2, 0, 1)
            sd[".".join(names)] = _tensor(a)
    return sd


def adapters_state_dict_from_jax(adapters) -> Dict[str, torch.Tensor]:
    """`init_adapter_params`' {attn, mlp}/{down, up}/{kernel (L, in, out),
    bias (L, out)} -> `training/adapters.py` `Adapters.state_dict()`:
    layer i's at `layers.i.{attn,mlp}.{down,up}`."""
    sd = {}
    for path, arr in _flatten(adapters):
        for i, a in enumerate(arr):
            key, val = _linear_leaf(path, a)
            sd[f"layers.{i}.{key}"] = _tensor(val)
    return sd


def mlp_head_state_dict_from_jax(layers) -> Dict[str, torch.Tensor]:
    """`init_mlp_head_params`' list of {kernel, bias} -> the port's
    `MLPHead.state_dict()` (`layers.i.weight` / `.bias`)."""
    return {f"layers.{i}.{k}": _tensor(v) for i, p in enumerate(layers)
            for k, v in (_linear_leaf(leaf, np.asarray(a)) for leaf, a in p.items())}
