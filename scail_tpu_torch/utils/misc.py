"""Small helpers (the port's own copy of scail_tpu/utils/misc.py's)."""

from __future__ import annotations


def append_dims(x, target_ndim: int):
    """Append singleton dims to `x` until it has `target_ndim` dims."""
    dims_to_append = target_ndim - x.ndim
    if dims_to_append < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * dims_to_append]


def default(val, d):
    if val is not None:
        return val
    return d() if callable(d) else d
