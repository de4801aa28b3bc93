"""Multi-process initialization and mesh construction (the port of
``jpeg_tpu.parallel.distributed``).

One process per device: ``torch.distributed`` with NCCL on the card and
gloo on the CPU, a (data, space) mesh whose ``space`` axis stays within a
host and whose ``data`` axis spans hosts, and each process's slice of a
global batch.  Processes are started by the caller (``torchrun
--nproc-per-node N`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``), where ``jpeg_tpu``'s
single controller sees every device of its process.

A single-process run needs no initialization: ``initialize`` is a no-op
when nothing is set, and ``mesh.make_mesh`` brings up a world-size-1
group for a 1x1 mesh.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from .mesh import make_mesh


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               retries: int = 0, backoff_s: float = 2.0,
               device: str | torch.device = "cuda") -> None:
    """Bring up ``torch.distributed`` from the arguments or torchrun's
    environment.

    ``coordinator_address`` ("host:port"; else ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` (else ``WORLD_SIZE``) and
    ``process_id`` (else ``RANK``) give the rendezvous.  ``device``: the
    card (NCCL; this process takes card ``LOCAL_RANK``, else its rank
    modulo the cards it sees) or "cpu" (gloo).

    "Already initialized" is success.  With nothing given or set, this is
    a single-process run and a no-op.  ``retries`` > 0 re-attempts a
    transient bring-up failure (the coordinator not yet listening) with
    exponential backoff from ``backoff_s``; the last error is raised.
    """
    if dist.is_initialized():
        return  # idempotent
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ \
            and "MASTER_PORT" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = num_processes if num_processes is not None else \
        _env_int("WORLD_SIZE")
    if addr is None and world is None:
        return  # no cluster: a single-process run
    rank = process_id if process_id is not None else _env_int("RANK")
    if addr is None or world is None or rank is None:
        raise ValueError("initialize needs a coordinator address, the "
                         "number of processes and this process's id "
                         "(arguments or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE, RANK)")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a "
                               "gloo group")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if local is None else local)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown device {device!r}")
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                    world_size=world, rank=rank)
            return
        except RuntimeError:  # the store's connect and timeout errors
            if attempt == retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))


def _world() -> tuple[int, int]:
    """(rank, world size); a process with no group is rank 0 of 1."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(space_per_host: int | None = None,
                device: str | torch.device | None = None):
    """(data, space) mesh over every rank.

    The ``space`` axis (spatial restart-segment sharding) is kept within a
    host, so its histogram ``all_reduce`` stays on the host's links; the
    ``data`` axis spans hosts, where only independent images travel.  A
    host's ranks are ``LOCAL_WORLD_SIZE`` (torchrun), else the whole
    world; ``space`` is ``space_per_host`` or at most 4, shrunk until it
    divides them.
    """
    _, world = _world()
    local = _env_int("LOCAL_WORLD_SIZE") or world
    space = space_per_host or min(local, 4)
    while local % space:
        space -= 1
    return make_mesh(data=world // space, space=space, device=device)


def process_batch_slice(batch_size: int) -> slice:
    """The slice of a global batch this process should feed (data axis)."""
    rank, n = _world()
    if batch_size % n:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the "
            f"{n} processes (pad the batch or drop the remainder explicitly)")
    per = batch_size // n
    return slice(per * rank, per * (rank + 1))
