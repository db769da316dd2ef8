"""Multi-process bring-up (counterpart of scail_tpu/parallel/distributed.py;
the reference's arguments.py:241-339 initialize_distributed).

The environment contract of the JAX package and the reference: explicit
arguments win, then MASTER_ADDR / MASTER_PORT + WORLD_SIZE / RANK, adopting
OpenMPI's OMPI_COMM_WORLD_* (sample_video.py:511-513).  With a world of one
the call does nothing.  Each process drives the card LOCAL_RANK names (0 by
default).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize_distributed(backend: str = None, *, coordinator_address: str = None,
                           num_processes: int = None, process_id: int = None,
                           device: str = "cuda", timeout_s: float = 600.0) -> bool:
    """Initialise torch.distributed if the environment (or the arguments)
    call for more than one process; returns True when it did.

    backend: 'nccl' for CUDA and 'gloo' for the CPU unless named (gloo also
    carries CUDA tensors, staged through host memory, which is how two ranks
    can share one card).  device 'cuda' sets the process's card from
    LOCAL_RANK and raises without CUDA: there is no fallback to the CPU."""
    for src, dst in (("OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"),
                     ("OMPI_COMM_WORLD_RANK", "RANK"),
                     ("OMPI_COMM_WORLD_LOCAL_RANK", "LOCAL_RANK")):
        if src in os.environ and dst not in os.environ:
            os.environ[dst] = os.environ[src]

    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"torch.distributed already initialised with world "
                               f"{dist.get_world_size()}, asked for {world}")
        return True
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        if not os.environ.get("MASTER_ADDR"):
            raise RuntimeError(f"WORLD_SIZE={world} but no MASTER_ADDR: set MASTER_ADDR and "
                               "MASTER_PORT (or pass coordinator_address)")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"torch.distributed initialised: {world} processes, backend {backend}",
              flush=True)
    return True
