"""The released checkpoints -> the port's modules (counterpart of
scail_tpu/convert/torch_ckpt.py).

The SAT layout is `<dir>/<iteration>/mp_rank_00_model_states.pt` with the
weights under 'module' and a text file `latest` naming the iteration.  The
DiT's parameters live under 'model.diffusion_model.' with SAT's names:

  transformer.layers.{i}.attention.query_key_value.{weight,bias}   (3h, h)
  transformer.layers.{i}.attention.dense.*
  transformer.layers.{i}.cross_attention.{query,key_value,dense}.*
  transformer.layers.{i}.mlp.dense_h_to_4h / dense_4h_to_h
  mixins.patch_embed.{proj,proj_pose}.{weight,bias}   conv3d (h, in, 1, 2, 2)
  mixins.adaln_layer.adaLN_modulations.{i}            (1, 6, h) [share_adaln]
  mixins.adaln_layer.{query,key,cross_query,cross_key,clip_feature_key}_layernorm_list.{i}.weight
  mixins.adaln_layer.clip_feature_key_value_list.{i}.{weight,bias}
  mixins.final_layer.linear.*, mixins.final_layer.adaLN_modulation (1, 2, h)
  time_embed.{0,2}.*, adaln_projection.1.*, text_embedding.{0,2}.*,
  clip_proj.proj.{0,1,3,4}.*

SAT's (out, in) linear weights are nn.Linear's layout already; the patch
conv flattens to (h, in*4) in the (c, kh, kw) order of the DiT's patchify;
the AdaLN tables drop their leading 1.  Each module is filled one parameter
at a time from the memory-mapped file: read, cast, moved to its device, so
a device never holds an f32 copy of a bf16 model.
"""

from __future__ import annotations

import os
import zipfile
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

SAT_PREFIX = "model.diffusion_model."

Fix = Optional[Callable[[torch.Tensor], torch.Tensor]]


def load_torch_state_dict(path: str, mmap: bool = True) -> Dict[str, torch.Tensor]:
    """The tensors of a .pt / .pth file on the CPU, in their stored dtype.

    A zipfile checkpoint (every torch >= 1.6 save) is memory-mapped, so a
    tensor costs no resident memory until it is read; a legacy file takes a
    plain load.  A SAT file's 'module', then a 'state_dict', is unwrapped.
    The released files are pickles that may hold DeepSpeed's bookkeeping
    besides the tensors, so they are unpickled in full: load only files you
    trust."""
    mmap = mmap and zipfile.is_zipfile(path)
    sd = torch.load(path, map_location="cpu", weights_only=False, mmap=mmap)
    if isinstance(sd, dict) and "module" in sd:
        sd = sd["module"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    return {k: v.detach() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def resolve_latest_checkpoint(load_dir: str) -> str:
    """Follow the `latest` tracker file (iteration 1 when there is none)."""
    tracker = os.path.join(load_dir, "latest")
    iteration = "1"
    if os.path.exists(tracker):
        with open(tracker) as f:
            iteration = f.read().strip()
    return os.path.join(load_dir, iteration, "mp_rank_00_model_states.pt")


def mapped_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor],
                      source: Callable[[str], Tuple[str, Fix]],
                      what: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """({parameter name: tensor}, {parameter name: checkpoint key}) for every
    parameter of `module`, read from `sd` at `source(name)` = (key, layout
    fix or None).  Views of `sd` where the fix allows; a missing key raises
    and names both."""
    tensors, keys = {}, {}
    for name, _ in module.named_parameters():
        key, fix = source(name)
        if key not in sd:
            raise KeyError(f"{what}: parameter {name!r} has no tensor {key!r} in the checkpoint")
        tensors[name] = fix(sd[key]) if fix else sd[key]
        keys[name] = key
    return tensors, keys


def load_state_(module: nn.Module, tensors: Mapping[str, torch.Tensor], *, device=None,
                dtype=None, keys: Optional[Mapping[str, str]] = None, what: str = "") -> int:
    """Replace every parameter of `module` (on the meta device or anywhere)
    by its tensor in `tensors`, one at a time: cast to `dtype` (floats only)
    and moved to `device`, casting on the side of the smaller copy.  A
    missing tensor or a shape that differs raises and names the key.  Returns
    the bytes read."""
    keys = keys or {}
    read = 0
    with torch.no_grad():
        for mod_name, mod in module.named_modules():
            for leaf, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                key = keys.get(name, name)
                t = tensors.get(name)
                if t is None:
                    raise KeyError(f"{what}: parameter {name!r} has no tensor {key!r}")
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{what}: tensor {key!r} has shape {tuple(t.shape)}, "
                                     f"parameter {name!r} needs {tuple(p.shape)}")
                read += t.numel() * t.element_size()
                want = dtype if dtype is not None and t.is_floating_point() else t.dtype
                if torch.empty((), dtype=want).element_size() < t.element_size():
                    t = t.to(want).to(device=device)
                else:
                    t = t.to(device=device).to(want)
                mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return read


def to_device_(module: nn.Module, device, dtype=None) -> int:
    """Move `module`'s parameters to `device` (cast to `dtype`), one at a time."""
    return load_state_(module, dict(module.named_parameters()), device=device, dtype=dtype)


# DiT.state_dict() prefix -> SAT name, outside the layers and inside layer {i}
_DIT_GLOBAL = {
    "patch_embed.proj": "mixins.patch_embed.proj",
    "patch_embed.proj_pose": "mixins.patch_embed.proj_pose",
    "time_embed.fc1": "time_embed.0",
    "time_embed.fc2": "time_embed.2",
    "text_embedding.fc1": "text_embedding.0",
    "text_embedding.fc2": "text_embedding.2",
    "final_layer.linear": "mixins.final_layer.linear",
    "final_layer.adaln_mlp": "mixins.final_layer.adaLN_modulation.1",
    "adaln_projection.fc": "adaln_projection.1",
    "clip_proj.ln_in": "clip_proj.proj.0",
    "clip_proj.fc1": "clip_proj.proj.1",
    "clip_proj.fc2": "clip_proj.proj.3",
    "clip_proj.ln_out": "clip_proj.proj.4",
}
_DIT_LAYER = {
    "qkv": "transformer.layers.{}.attention.query_key_value",
    "attn_out": "transformer.layers.{}.attention.dense",
    "cross_q": "transformer.layers.{}.cross_attention.query",
    "cross_kv": "transformer.layers.{}.cross_attention.key_value",
    "cross_out": "transformer.layers.{}.cross_attention.dense",
    "mlp_in": "transformer.layers.{}.mlp.dense_h_to_4h",
    "mlp_out": "transformer.layers.{}.mlp.dense_4h_to_h",
    "adaln_mlp": "mixins.adaln_layer.adaLN_modulations.{}.1",
    "q_norm": "mixins.adaln_layer.query_layernorm_list.{}",
    "k_norm": "mixins.adaln_layer.key_layernorm_list.{}",
    "cross_q_norm": "mixins.adaln_layer.cross_query_layernorm_list.{}",
    "cross_k_norm": "mixins.adaln_layer.cross_key_layernorm_list.{}",
    "clip_k_norm": "mixins.adaln_layer.clip_feature_key_layernorm_list.{}",
    "clip_kv": "mixins.adaln_layer.clip_feature_key_value_list.{}",
}


def _drop_lead(t):
    return t[0] if t.dim() == 3 else t


def _flatten_patch(t):
    return t.reshape(t.shape[0], -1)


def dit_sat_source(name: str, prefix: str = SAT_PREFIX) -> Tuple[str, Fix]:
    """(SAT key, layout fix) of a `DiT.state_dict()` key."""
    parts = name.split(".")
    if name == "final_layer.adaln":
        return prefix + "mixins.final_layer.adaLN_modulation", _drop_lead
    if parts[0] == "layers" and parts[2] == "adaln":
        return prefix + f"mixins.adaln_layer.adaLN_modulations.{parts[1]}", _drop_lead
    if parts[0] == "layers":
        base, leaf = _DIT_LAYER.get(parts[2], "").format(parts[1]), parts[3]
    else:
        base, leaf = _DIT_GLOBAL.get(".".join(parts[:2]), ""), parts[2]
    if not base:
        raise KeyError(f"DiT parameter {name!r} has no SAT name")
    fix = _flatten_patch if parts[0] == "patch_embed" and leaf == "weight" else None
    return prefix + base + "." + ("weight" if leaf == "scale" else leaf), fix


def dit_state_dict_from_sat(sd: Mapping[str, torch.Tensor], cfg,
                            prefix: str = SAT_PREFIX) -> Dict[str, torch.Tensor]:
    """A SAT state dict -> `DiT(cfg).state_dict()`, in the file's dtype."""
    from scail_tpu_torch.models.dit import DiT

    return mapped_state_dict(DiT(cfg, device="meta"), sd, lambda n: dit_sat_source(n, prefix),
                             "DiT checkpoint")[0]


def load_mapped_(module: nn.Module, sd: Mapping[str, torch.Tensor],
                 source: Callable[[str], Tuple[str, Fix]], *, what: str, device=None,
                 dtype=None) -> int:
    """Fill `module` from `sd` at `source(name)` (see mapped_state_dict), one
    parameter at a time, in `dtype` on `device`; logs how many of the file's
    tensors nothing read.  Returns the bytes read."""
    tensors, keys = mapped_state_dict(module, sd, source, what)
    unread = sorted(set(sd) - set(keys.values()))
    print(f"{what}: {len(keys)} parameters from {len(sd) - len(unread)} tensors; "
          f"{len(unread)} tensors unread" + (f" (first: {unread[0]})" if unread else ""),
          flush=True)
    return load_state_(module, tensors, device=device, dtype=dtype, keys=keys, what=what)


def load_dit_(dit: nn.Module, sd: Mapping[str, torch.Tensor], *, device, dtype,
              prefix: str = SAT_PREFIX) -> int:
    """Fill `dit` (built on the meta device) from a SAT state dict, one
    parameter at a time, in `dtype` on `device`.  Returns the bytes read."""
    return load_mapped_(dit, sd, lambda n: dit_sat_source(n, prefix), what="DiT checkpoint",
                        device=device, dtype=dtype)
