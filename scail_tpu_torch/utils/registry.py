"""Target-string object factory for the port (counterpart of
scail_tpu/utils/registry.py).

The reference YAMLs name torch-reference classes (`target: sgm...`); this
registry maps them onto `scail_tpu_torch` classes.  It keeps its own alias
and object tables, apart from the JAX package's, so both packages can build
the same YAML in one process.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

from scail_tpu_torch.utils.profiling import annotate

_ALIASES: Dict[str, str] = {}
_REGISTRY: Dict[str, Any] = {}
_IMPORTED = False


def register(name: str = None, alias=()):
    """Register a class under its scail_tpu_torch path and reference-path aliases."""

    def deco(obj):
        key = name or f"{obj.__module__}.{obj.__qualname__}"
        _REGISTRY[key] = obj
        for a in ((alias,) if isinstance(alias, str) else tuple(alias)):
            _ALIASES[a] = key
        return obj

    return deco


def get_obj_from_str(string: str) -> Any:
    if string not in _ALIASES:
        ensure_imports()
    key = _ALIASES.get(string, string)
    if key in _REGISTRY:
        return _REGISTRY[key]
    module, cls = key.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config, **extra_kwargs):
    """Build ``target(**params, **extra_kwargs)``."""
    config = dict(config)
    if "target" not in config:
        if config.get("__is_first_stage__", False) or config.get("__is_unconditional__", False):
            return None
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params", {}) or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)


def ensure_imports():
    """Import every port module that registers aliases (once a process, in
    the host-clock span `setup.imports`)."""
    global _IMPORTED
    if _IMPORTED:
        return
    with annotate("setup.imports", always=True):
        for m in (
            "scail_tpu_torch.models.dit",
            "scail_tpu_torch.models.wan_vae",
            "scail_tpu_torch.models.umt5",
            "scail_tpu_torch.models.clip_vit",
            "scail_tpu_torch.diffusion.denoiser",
            "scail_tpu_torch.diffusion.scaling",
            "scail_tpu_torch.diffusion.discretization",
            "scail_tpu_torch.diffusion.guiders",
            "scail_tpu_torch.diffusion.samplers",
            "scail_tpu_torch.diffusion.conditioner",
            "scail_tpu_torch.diffusion.loss",
            "scail_tpu_torch.diffusion.sigma_sampling",
            "scail_tpu_torch.diffusion.embedders",
            "scail_tpu_torch.models.unet",
            "scail_tpu_torch.models.video_unet",
            "scail_tpu_torch.autoencoding.autoencoder_kl",
            "scail_tpu_torch.autoencoding.vqgan",
            "scail_tpu_torch.inference.engine",
        ):
            importlib.import_module(m)
    _IMPORTED = True
