"""Row gather from a row-major table: kernel K5 `gather_rows`.

Counterpart of the Pallas probe's `gather_p` (tools/pallas_probe.py:145)
and of the polyline-row gathers the JAX package runs as XLA
(following.py:275, refpoints.py:1247, polyline_stages.py:431).  The
port's callers view `plg_coords [V, P, L, 2]` as a `[V*P, 2L]` table and
gather whole polylines by `view * P + pl`.
"""

from __future__ import annotations

import torch

from edgegraph3d_tpu_torch import kernels


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
    if S == 0:
        return out
    entry = "eg3d_gather_rows" if dt == torch.float32 else \
        "eg3d_gather_rows_f64"
    with kernels.on_device(table):
        rc = getattr(kernels.lib(), entry)(
            table.data_ptr(), R, W, rows.data_ptr(),
            int(rows.dtype == torch.int64), S, out.data_ptr(),
            kernels.stream_of(table))
    kernels.check(rc, "gather_rows")
    kernels.count_launch("gather_rows", dt)
    return out
