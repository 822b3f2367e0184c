"""The work-item mesh and its collectives.

Port of edgegraph3d_tpu/parallel/mesh.py.  The JAX package shards the
work-item axis (refpoints, seeds, chains, 3D points) of every sweep over
a 1-D `jax.sharding.Mesh` and replicates the per-view tensors; its
reductions are `psum` / `pmin` over the mesh axis.  Here a `Mesh` is the
list of shards this process drives (one `torch.device` each, a device
may repeat: `["cuda:0"] * 4` or `["cpu"] * 8` are meshes) and,
across processes, a `torch.distributed` process group
(parallel/distributed.py).  The global shard count is the local count
times the group's world size; process r drives the shards
r * local .. r * local + local - 1, so the global shard order is the
rank-major order of the processes' local shards.

Shard g of an axis of n rows takes the contiguous block
`shard_bounds(n, size)[g]`: blocks of ceil(n / size) rows, the last
ones shorter or empty (equal when n is padded to a multiple of the
shard count with `pad_to_multiple`).

The collectives take one tensor per local shard:
  psum / pmin / pmax  reduce the local shards on the first local device
                      in shard order, then all_reduce(SUM / MIN / MAX)
                      over the group;
  all_gather          concatenates the blocks in global shard order on
                      the first local device; across processes, blocks
                      of unequal length are padded to the longest,
                      gathered and trimmed (the lengths go first).
The gloo backend carries a CUDA operand through host memory (its CUDA
support covers only some collectives), a copy of the operand and not
of the computation; NCCL takes it on the card.

JAX's per-mesh table of jitted shard_maps (parallel/sharded.py
`_cached`) has no counterpart: nothing is compiled per mesh here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """The shards this process drives, and the process group joining it
    to the other processes' shards (None in one process)."""
    devices: tuple
    group: object = None
    world: int = 1
    rank: int = 0

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.local * self.world

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.local

    @property
    def device(self) -> torch.device:
        """The first local device: where reductions and gathers land."""
        return self.devices[0]

    def local_shards(self):
        """(global shard index, device) of each local shard."""
        return [(self.first + i, d) for i, d in enumerate(self.devices)]

    def local_bounds(self, n: int):
        """(global shard index, device, lo, hi) of each local shard's
        block of an axis of n rows."""
        b = shard_bounds(n, self.size)
        return [(g, d, *b[g]) for g, d in self.local_shards()]


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> Mesh:
    """A one-process mesh.  `devices` lists the shards' devices (a
    device may repeat); without it, the mesh takes the first `n_devices`
    CUDA cards (all of them by default).  Raises when no GPU is there and
    no devices are given, and when n_devices exceeds the cards; it never
    takes fewer shards than asked and never moves to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA GPU is available (pass "
                               "devices=[...] explicitly, e.g. ['cpu'] * 8)")
        n_cards = torch.cuda.device_count()
        n = n_cards if n_devices is None else n_devices
        if not 1 <= n <= n_cards:
            raise ValueError(f"make_mesh: {n} shards asked for, "
                             f"{n_cards} CUDA cards present")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} but "
                         f"{len(devices)} devices given")
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices=tuple(_device(d) for d in devices))


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d!r}: no CUDA GPU is "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {d!r}")
    return dev


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad `axis` so its size divides evenly across devices."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)


def shard_bounds(n: int, n_shards: int) -> list:
    """[(lo, hi)] of each shard's contiguous block of an axis of n rows:
    ceil(n / n_shards) rows a block, the last ones shorter or empty."""
    block = -(-n // n_shards) if n_shards else 0
    return [(min(g * block, n), min((g + 1) * block, n))
            for g in range(n_shards)]


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def _backend(mesh: Mesh) -> str:
    import torch.distributed as dist
    return dist.get_backend(mesh.group)


def _carried(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The operand as the group's backend takes it: gloo through host
    memory, NCCL on the card."""
    if t.device.type == "cuda" and _backend(mesh) == "gloo":
        return t.cpu()
    return t.contiguous()


def _reduce(mesh: Mesh, parts, local_op, op_name: str) -> torch.Tensor:
    if len(parts) != mesh.local:
        raise ValueError(f"expected {mesh.local} local shards' tensors, "
                         f"got {len(parts)}")
    out = parts[0].to(mesh.device)
    for p in parts[1:]:
        out = local_op(out, p.to(mesh.device))
    if mesh.group is None:
        return out
    import torch.distributed as dist
    buf = _carried(mesh, out)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op_name),
                    group=mesh.group)
    return buf.to(mesh.device)


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """Sum over every shard of the mesh, in shard order locally."""
    return _reduce(mesh, parts, torch.add, "SUM")


def pmin(mesh: Mesh, parts) -> torch.Tensor:
    return _reduce(mesh, parts, torch.minimum, "MIN")


def pmax(mesh: Mesh, parts) -> torch.Tensor:
    return _reduce(mesh, parts, torch.maximum, "MAX")


def all_gather(mesh: Mesh, blocks) -> torch.Tensor:
    """Concatenate every shard's block (dim 0, any length; equal trailing
    shape and dtype) in global shard order, on the first local device."""
    if len(blocks) != mesh.local:
        raise ValueError(f"expected {mesh.local} local shards' blocks, "
                         f"got {len(blocks)}")
    mine = torch.cat([b.to(mesh.device) for b in blocks])
    if mesh.group is None:
        return mine
    import torch.distributed as dist
    n = torch.tensor([mine.shape[0]], dtype=torch.int64, device=mesh.device)
    counts = [torch.zeros_like(_carried(mesh, n)) for _ in range(mesh.world)]
    dist.all_gather(counts, _carried(mesh, n), group=mesh.group)
    counts = [int(c.item()) for c in counts]
    longest = max(counts)
    if longest == 0:
        return mine
    buf = torch.zeros((longest,) + tuple(mine.shape[1:]), dtype=mine.dtype,
                      device=mesh.device)
    buf[:mine.shape[0]] = mine
    buf = _carried(mesh, buf)
    bufs = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(bufs, buf, group=mesh.group)
    return torch.cat([b[:c] for b, c in zip(bufs, counts)]).to(mesh.device)


def gather_fields(mesh: Mesh, parts: list) -> dict:
    """all_gather of each field of per-shard dicts of tensors."""
    return {k: all_gather(mesh, [p[k] for p in parts]) for k in parts[0]}
