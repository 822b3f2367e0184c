"""Several processes, one mesh: `torch.distributed`.

Port of edgegraph3d_tpu/parallel/distributed.py.  Each process calls
`initialize` with the same coordinator address and world size and its
own rank; `global_mesh` then gives a Mesh whose shards are every
process's local shards, joined by the default process group.  Every
process passes the SAME full host arrays to the sharded entries (the
host state of the pipeline is identical on every process, as in the
JAX package), each computes only its own shards, and every entry
returns the whole result on every process (parallel/sharded.py).

The backend defaults to NCCL, on the card; it never changes to gloo on
its own.  gloo is for meshes on the CPU (the tests) and for processes
that share a card: NCCL refuses two ranks on one card ("Duplicate GPU
detected").
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch.parallel.mesh import Mesh, _device, all_gather

#: what `initialize` recorded for `global_mesh`
_STATE: dict = {}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None,
               backend: str = "nccl"):
    """Join the process group at `coordinator_address` ("host:port").
    `local_device_count` is the number of shards this process drives
    (the counterpart of JAX's virtual-device flag; default 1).  Without
    a GPU, backend="nccl" raises: pass backend="gloo" (and CPU devices
    to `global_mesh`) explicitly.  Idempotent per process."""
    import torch.distributed as dist

    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: backend='nccl' needs a CUDA GPU "
                           "(pass backend='gloo' explicitly for the CPU)")
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    _STATE.update(local_device_count=local_device_count or 1,
                  backend=dist.get_backend())
    return dist


def global_mesh(devices: list | None = None) -> Mesh:
    """The mesh over every process's shards.  `devices` are this
    process's shards (a device may repeat); by default
    `local_device_count` CUDA cards, process r taking cards
    r * local .. r * local + local - 1 modulo the cards it sees."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA GPU is available "
                               "(pass devices=[...] explicitly)")
        local = _STATE.get("local_device_count", 1)
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{(rank * local + i) % n_cards}"
                   for i in range(local)]
    devs = tuple(_device(d) for d in devices)
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(devs[0])
    return Mesh(devices=devs, group=dist.group.WORLD, world=world, rank=rank)


def shard_global(mesh: Mesh, host_array: np.ndarray) -> list:
    """This process's shards of a host array (axis 0), one tensor per
    local shard on its device.  Every process passes the SAME full
    array; each keeps only the blocks it owns."""
    return [torch.as_tensor(np.ascontiguousarray(host_array[lo:hi]),
                            device=d)
            for _, d, lo, hi in mesh.local_bounds(len(host_array))]


def replicate_global(mesh: Mesh, host_array: np.ndarray) -> list:
    """A replica of a host array on each local shard's device (one
    tensor per distinct device, shared where a device repeats)."""
    copies = {}
    return [copies.setdefault(d, torch.as_tensor(np.asarray(host_array),
                                                 device=d))
            for d in mesh.devices]


def gather_to_host(mesh: Mesh, blocks: list) -> np.ndarray:
    """The full array, in global shard order, on every process, from
    this process's shard blocks (the role of JAX's fetch_global)."""
    return all_gather(mesh, blocks).cpu().numpy()
