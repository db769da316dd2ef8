"""YAML config loading and merging, compatible with the reference's OmegaConf
use (the port's own copy of scail_tpu/utils/config.py).

`--base a.yaml b.yaml` are deep-merged left to right and the result is split
into `args:` (runtime namespace) and `model:` (the model graph).  ConfigDict
gives attribute access (`cfg.a.b`) beside item access (`cfg['a']['b']`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return wrap(v)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key, default=None):
        return wrap(super().get(key, default))


def wrap(v):
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict({k: wrap(x) for k, x in v.items()})
    if isinstance(v, list):
        return [wrap(x) for x in v]
    return v


def deep_merge(base: Dict, override: Dict) -> Dict:
    """OmegaConf.merge semantics: override wins; dicts merge recursively."""
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path: str) -> ConfigDict:
    with open(path) as f:
        return wrap(yaml.safe_load(f) or {})


def load_configs(paths: List[str]) -> ConfigDict:
    """Merge YAML files left to right (later files override)."""
    merged: Dict = {}
    for p in paths:
        merged = deep_merge(merged, load_yaml(p))
    return wrap(merged)


def split_reference_config(cfg: ConfigDict):
    """(runtime_args, model_config): top-level `args:` and `model:`."""
    runtime = wrap(dict(cfg.get("args", {}) or {}))
    model = wrap(dict(cfg.get("model", {}) or {}))
    return runtime, model
