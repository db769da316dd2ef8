"""Process-aware logging (counterpart of scail_tpu/utils/logging.py:1-51;
reference: sat/helpers.py:127-147).

One process per rank: "rank 0" is torch.distributed's rank 0 when a process
group is initialised, else this process.
"""

from __future__ import annotations

import logging
import sys

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("scail_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "[%(asctime)s scail_tpu_torch %(levelname)s] %(message)s"))
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return _rank() == 0


def print_rank0(msg: str, level: str = "info"):
    if is_main_process():
        getattr(get_logger(), level)(msg)


def print_all(msg: str, level: str = "info"):
    import torch.distributed as dist

    prefix = f"[rank {_rank()}] " if dist.is_available() and dist.is_initialized() else ""
    getattr(get_logger(), level)(prefix + msg)
