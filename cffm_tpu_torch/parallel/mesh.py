"""The device group of the row-sharded engine.

The port's counterpart of `cffm_tpu/parallel/mesh.py`. JAX puts all
devices on one flat "data" axis that carries both roles: the batch is
data-parallel over it and the table rows are mod-sharded over it. Here
that axis is a `torch.distributed` process group with one process per
device: NCCL between CUDA cards, gloo between CPU processes (the tests).
A process's rank is its shard index.

Build a `Mesh` with `make_mesh()`:
  - under torchrun (or any launcher that sets RANK, WORLD_SIZE and
    MASTER_ADDR/MASTER_PORT), with no arguments;
  - otherwise with an explicit `init_method` ("tcp://localhost:<port>",
    "file://<path>"), rank and world size;
  - on a default group that is already initialised, which it reuses.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    group: object          # the process group (None: the default group)
    rank: int              # this process's shard index
    world: int             # number of shards
    device: torch.device   # this process's device
    owns_group: bool       # make_mesh initialised the default group

    def shard_index(self) -> int:
        return self.rank


def make_mesh(init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, backend: Optional[str] = None,
              device=None) -> Mesh:
    """This process's place in the flat device group.

    backend: "nccl" (CUDA devices) or "gloo" (CPU); by default NCCL when
    device is a CUDA device or, with no device given, when CUDA is
    available. device: the process's device; by default cuda:LOCAL_RANK
    for NCCL and the CPU for gloo ("cuda" without an index also means
    cuda:LOCAL_RANK). With no init_method the environment
    (torchrun's RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is read."""
    if device is not None:
        device = torch.device(device)
    if backend is None:
        backend = ("nccl" if (device.type == "cuda" if device is not None
                              else torch.cuda.is_available()) else "gloo")
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device is None:
        device = local if backend == "nccl" else torch.device("cpu")
    elif device.type == "cuda" and device.index is None:
        device = local
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    owns = not dist.is_initialized()
    if owns:
        kwargs = {"init_method": init_method or "env://"}
        if rank is not None:
            kwargs["rank"] = rank
        if world_size is not None:
            kwargs["world_size"] = world_size
        dist.init_process_group(backend, **kwargs)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default group runs {dist.get_backend()}, not {backend}")
    return Mesh(None, dist.get_rank(), dist.get_world_size(), device, owns)


def free_port() -> int:
    """A free TCP port on localhost, for init_method="tcp://localhost:<port>"."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def close_mesh(mesh: Mesh) -> None:
    """Destroy the default group if make_mesh created it."""
    if mesh.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def requested_world_size() -> int:
    """The group size this process runs in: the default group's when it
    exists, else torchrun's WORLD_SIZE, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))
