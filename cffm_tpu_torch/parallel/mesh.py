"""The device group of the row-sharded engine.

The port's counterpart of `cffm_tpu/parallel/mesh.py`. JAX puts all
devices on one flat "data" axis that carries both roles: the batch is
data-parallel over it and the table rows are mod-sharded over it. Here
that axis is a `torch.distributed` process group with one process per
device: NCCL between CUDA cards, gloo between CPU processes (the tests).
A process's rank is its shard index.

The hierarchical and intra-host engines see the group as a (host, chip)
grid (`make_mesh_2d`): rank r is host r // C, chip r % C (host-major, as
torchrun numbers ranks), with a sub-`Mesh` over the ranks of this host
("chip") and one over the ranks with this chip index ("host").

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


class Mesh2D(NamedTuple):
    """This process's place in the (host, chip) grid of the flat group:
    rank r = host * C + chip. `chip` is the sub-mesh of this host's ranks
    (its rank is the chip index, its world C), `host` the sub-mesh of the
    ranks with this chip index (its rank is the host index, its world H).
    A sub-mesh that spans the whole group is the flat group itself."""
    flat: Mesh
    chip: Mesh
    host: Mesh

    @property
    def num_hosts(self) -> int:
        return self.host.world

    @property
    def chips_per_host(self) -> int:
        return self.chip.world


def grid_shape(world: int, num_hosts: Optional[int] = None,
               chips_per_host: Optional[int] = None) -> tuple:
    """(H, C) of a group of world ranks: C from chips_per_host, else from
    num_hosts, else torchrun's LOCAL_WORLD_SIZE, else world (one host).
    Raises unless H * C == world."""
    if chips_per_host is None:
        chips_per_host = (world // num_hosts if num_hosts
                          else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    h = num_hosts or (world // chips_per_host if chips_per_host > 0 else 0)
    if chips_per_host < 1 or h * chips_per_host != world:
        raise ValueError(f"a group of {world} ranks is not a whole number of hosts of "
                         f"{chips_per_host} chips (num_hosts={num_hosts})")
    return h, chips_per_host


def make_mesh_2d(num_hosts: Optional[int] = None, chips_per_host: Optional[int] = None,
                 init_method: Optional[str] = None, rank: Optional[int] = None,
                 world_size: Optional[int] = None, backend: Optional[str] = None,
                 device=None) -> Mesh2D:
    """The (host, chip) grid of the flat group (`make_mesh`'s arguments
    build or join it). By default C is torchrun's LOCAL_WORLD_SIZE and H
    the world over C; tests pass both. The grid is checked against the
    world size before the group is joined when the size is known. Every
    rank builds every subgroup in the same order (`new_group` is
    collective)."""
    known = world_size or (dist.get_world_size() if dist.is_initialized()
                           else os.environ.get("WORLD_SIZE"))
    if known:
        grid_shape(int(known), num_hosts, chips_per_host)
    flat = make_mesh(init_method, rank, world_size, backend, device)
    try:
        h, c = grid_shape(flat.world, num_hosts, chips_per_host)
        hi, ci = divmod(flat.rank, c)

        def sub(ranks_of, count, mine):
            group = None
            for i in range(count):
                ranks = ranks_of(i)
                if len(ranks) == flat.world:
                    continue  # the whole group: the flat group itself
                g = dist.new_group(ranks=ranks)
                if i == mine:
                    group = g
            return group

        chip_group = sub(lambda i: [i * c + j for j in range(c)], h, hi)
        host_group = sub(lambda i: [j * c + i for j in range(h)], c, ci)
    except BaseException:
        close_mesh(flat)
        raise
    return Mesh2D(flat, Mesh(chip_group, ci, c, flat.device, False),
                  Mesh(host_group, hi, h, flat.device, False))
