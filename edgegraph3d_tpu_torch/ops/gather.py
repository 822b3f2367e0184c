"""Row gather from a row-major table: kernel K5 `gather_rows`.

Counterpart of the Pallas probe's `gather_p` (tools/pallas_probe.py:145)
and of the polyline-row gathers the JAX package runs as XLA
(following.py:275, refpoints.py:1247, polyline_stages.py:431).  The
port's callers view `plg_coords [V, P, L, 2]` as a `[V*P, 2L]` table and
gather whole polylines by `view * P + pl`.

`launch_plan` cuts one launch's work the way the kernel does (16-byte
pieces or single elements, rows a tile, the grid), so that the CPU tests
reach the kernel's mapping through a numpy model of it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from edgegraph3d_tpu_torch import kernels

#: K5's block: THREADS threads, each with UNROLL loads in flight; a tile
#: is TILE pieces (csrc/gather_rows.cu)
THREADS, UNROLL = 256, 8
TILE = THREADS * UNROLL
#: pieces a row for which K5 has a body of its own (no division)
FIXED_PIECES = (8, 16, 32)
#: the grid is at most this many blocks a SM; blocks stride over tiles
BLOCKS_PER_SM = 16


class GatherPlan(NamedTuple):
    """How one K5 launch cuts its work."""
    vec: bool        # 16-byte pieces, else one element a piece
    pieces: int      # pieces a row
    tile_rows: int   # rows a block stages and copies per tile
    blocks: int      # the grid


def launch_plan(W: int, elem_bytes: int, table_ptr: int, out_ptr: int,
                S: int, sms: int) -> GatherPlan:
    """K5's launch plan for S rows of W elements of `elem_bytes` from the
    table at `table_ptr` into `out_ptr`, on a card with `sms` SMs: the
    kernel computes the same pieces and tile rows from (vec, W)."""
    vec = ((W * elem_bytes) % 16 == 0 and table_ptr % 16 == 0
           and out_ptr % 16 == 0)
    pieces = W * elem_bytes // 16 if vec else W
    tile_rows = max(1, TILE // pieces)
    tiles = -(-S // tile_rows)
    return GatherPlan(vec, pieces, tile_rows,
                      min(tiles, BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gather_rows_plain(table: torch.Tensor, rows: torch.Tensor):
    """Plain twin of K5."""
    return table[rows.long()]


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Kernel K5.  table [R, W] f32 or f64 (the f64 polyline table of
    EdgeGraphConfig(dtype="float64")), rows [S] int32 or int64 indices in
    [0, R) -> [S, W] in the table's type, row s = table[rows[s]].  An
    index outside [0, R) raises: IndexError on the CPU; on the card a
    device-side assert, as `table[rows]` gives there, reported at the
    next synchronise (no read back to the host)."""
    if table.device.type == "cpu":
        return _gather_rows_plain(table, rows)
    R, W = table.shape
    table = table.contiguous()
    if rows.dtype not in (torch.int32, torch.int64):
        rows = rows.to(torch.int64)
    rows = rows.contiguous()
    dt = kernels.require_float(table.dtype, "gather_rows")
    kernels.require(table, "table", dt, (R, W))
    kernels.require(rows, "rows", rows.dtype, (rows.numel(),))
    S = rows.shape[0]
    out = torch.empty((S, W), dtype=dt, device=table.device)
    if S == 0 or W == 0:
        return out
    plan = launch_plan(W, table.element_size(), table.data_ptr(),
                       out.data_ptr(), S, _sm_count(table.device))
    entry = "eg3d_gather_rows" if dt == torch.float32 else \
        "eg3d_gather_rows_f64"
    with kernels.on_device(table):
        rc = getattr(kernels.lib(), entry)(
            table.data_ptr(), R, W, rows.data_ptr(),
            int(rows.dtype == torch.int64), S, out.data_ptr(),
            int(plan.vec), plan.blocks, kernels.stream_of(table))
    kernels.check(rc, "gather_rows")
    kernels.count_launch("gather_rows", dt)
    return out
