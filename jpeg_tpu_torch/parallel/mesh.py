"""Device-mesh construction for the (data, space) parallel layout (the
port of ``jpeg_tpu.parallel.mesh``).

One process drives one device.  The mesh has two axes:

* ``data``  — batch data parallelism: whole images per rank.
* ``space`` — spatial sharding: each image's MCU rows are split into
  restart-delimited slabs, one per rank, so every rank's entropy stream
  is independent (DC prediction resets at RSTn boundaries).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group: its collectives run over NCCL on the card
and gloo on the CPU (``all_reduce`` of the symbol histograms over
``space``, where ``jpeg_tpu`` has XLA's ``psum``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
SPACE_AXIS = "space"

# the device type a process group's backend drives
_DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu"}


def _single_process_group(device: str) -> None:
    """A world-size-1 default group for a process that never called
    ``distributed.initialize``: NCCL on a card, gloo on the CPU, through an
    in-process store (no address, no port)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a mesh on the card needs one; "
                               "pass device='cpu' for a gloo mesh")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown mesh device {device!r}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh_device_type(device: str | torch.device | None = None) -> str:
    """The device type of a mesh over the default group: "cuda" under
    NCCL, "cpu" under gloo.  ``device``, when given, must agree."""
    kind = _DEVICE_OF_BACKEND.get(dist.get_backend())
    if kind is None:
        raise ValueError(f"unsupported process group backend "
                         f"{dist.get_backend()!r}")
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"the process group runs {dist.get_backend()} "
                         f"({kind}), not {torch.device(device).type}")
    return kind


def make_mesh(data: int = 1, space: int = 1,
              device: str | torch.device | None = None) -> DeviceMesh:
    """Build a (data, space) mesh over ranks ``0 .. data*space-1``.

    ``data * space`` ranks must exist; extra ranks are left out of the
    mesh (they would otherwise force awkward image geometries), and every
    rank of the world must call this, since it creates the mesh's process
    groups.  In a process that never called ``distributed.initialize``, a
    1x1 mesh brings up a world-size-1 group itself: NCCL on the card
    (``device`` "cuda", the default) or gloo for ``device="cpu"``, through
    an in-process store, with no port to pick.  Otherwise the device type
    follows the default group's backend, and ``device`` must agree.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = data * space
    if need > world:
        raise ValueError(
            f"mesh {data}x{space} needs {need} devices, have {world}")
    if not dist.is_initialized():
        _single_process_group(torch.device(device or "cuda").type)
    kind = _mesh_device_type(device)
    return DeviceMesh(kind, torch.arange(need).reshape(data, space),
                      mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
    group's rank order (``get_local_rank``'s coordinate).  A failed
    collective raises."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def batch_sharding(mesh: DeviceMesh):
    """[B, H, W, 3] batch: images over ``data``, rows over ``space`` (the
    DTensor placements of ``mesh``'s two axes).  DTensor is imported here:
    it takes a second to import, and nothing else needs it."""
    from torch.distributed.tensor import Shard
    return (Shard(0), Shard(1))


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())
