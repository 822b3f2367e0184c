"""Device-side interval claiming (config.claiming_backend="device").

Port of edgegraph3d_tpu/matching/claiming_device.py: the device
equivalent of the host `MatchesManager.resolve_and_claim`, with the same
semantics, bit for bit (integers only):

    seeds processed in GLOBAL INDEX ORDER; a successful seed is
    accepted iff its starting sample's bucket on the starting view is
    not covered by (a) a claim from earlier chunks or (b) the claimed
    arcs of an earlier ACCEPTED seed; accepted seeds claim their swept
    arcs on all 3 tuple views in both directions.

An OWNER raster [V, P, B] int32 holds the smallest seed index whose
accepted span covers each bucket (-1 = claimed by an earlier chunk,
INF = free).  A fixpoint loop alternates

    accept  = success & ~(owner[start] < my_index)
    owner   = scatter-min of accepted spans

from the optimistic all-accepted state, for at most `max_rounds`
rounds; each round re-derives the owner raster from scratch.  Plain
torch on int32 tensors (a `scatter_reduce_("amin")` over the flattened
index); the rounds run as a Python loop with one host read per round of
the `changed` flag.  A fixpoint cut by max_rounds falls back to the
exact host pass, counted in manager.counters["device_claiming_fallback"]
(the algorithm's exactness guard, as in the JAX package).  The chunks
and their fixpoint rounds are counted too (`device_claiming_chunks`,
`device_claiming_rounds`, `device_claiming_rounds_max`).

On a mesh (`apply_device_claiming(mesh=...)`,
`sharded_resolve_and_claim`) the seed axis is sharded: each shard
scatters its own accepted spans, the owner raster is min-reduced over
the shards every round (mesh.pmin, the cross-device interval merge) and
the `changed` flag max-reduced (mesh.pmax: convergence is global).  The
raster is the single-device one, so are the accept sets and rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch.devices import resolve_device

INF = 2 ** 30
#: fixpoint rounds before apply_device_claiming falls back to the host
MAX_ROUNDS = 64


def _span_masks(b_seed, b_fwd, b_bwd, B: int) -> torch.Tensor:
    """Per (seed, view) claimed bucket span mask [S, 3, B]: from the
    seed bucket out to each direction's final bucket (both inclusive),
    mirroring MatchesManager.mark_spans for the fwd and bwd arcs."""
    lo = torch.minimum(torch.minimum(b_seed, b_fwd), b_bwd)
    hi = torch.maximum(torch.maximum(b_seed, b_fwd), b_bwd)
    rng = torch.arange(B, device=b_seed.device)
    return (rng >= lo[..., None]) & (rng <= hi[..., None])


class _Claims:
    """One shard's seeds: the scatter-min of its accepted spans into
    owner0 and the start check against an owner raster."""

    def __init__(self, owner0, success, index, cams, pl, b_start,
                 span_mask):
        V, P, B = owner0.shape
        dev = owner0.device
        self.owner0, self.success, self.index = owner0, success, index
        self.span_mask = span_mask
        self.inf = torch.tensor(INF, dtype=torch.int32, device=dev)
        self.idx_col = torch.where(success, index.to(torch.int32), self.inf)
        # flat raster index of every (seed, tuple view, bucket)
        self.flat = ((cams.long() * P + pl.long())[..., None] * B
                     + torch.arange(B, device=dev)).reshape(-1)
        self.start = ((cams[:, 0].long() * P + pl[:, 0].long()) * B
                      + b_start.long())

    def claim(self, accept):
        w = torch.where(accept[:, None, None] & self.span_mask,
                        self.idx_col[:, None, None], self.inf).reshape(-1)
        return self.owner0.reshape(-1).clone().scatter_reduce_(
            0, self.flat, w, "amin").view(self.owner0.shape)

    def accepted(self, owner, skip_start_check: bool):
        if skip_start_check:
            return self.success
        owner = owner.to(self.owner0.device)
        return self.success & ~(owner.reshape(-1)[self.start] < self.index)


def resolve_and_claim_device(owner0, success, index, cams, pl, b_start,
                             span_mask, skip_start_check: bool = False,
                             max_rounds: int = MAX_ROUNDS):
    """owner0 [V,P,B] int32 (INF free / -1 earlier chunks), success [S]
    bool, index [S] int32 global seed order, cams/pl [S,3] int,
    b_start [S], span_mask [S,3,B] bool.  Returns (accept [S],
    owner [V,P,B], converged, rounds): `converged` is False when
    max_rounds cut the fixpoint; `rounds` counts the loop's rounds."""
    c = _Claims(owner0, success, index, cams, pl, b_start, span_mask)
    accept = success
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        new_accept = c.accepted(c.claim(accept), skip_start_check)
        changed = bool((new_accept != accept).any())
        accept = new_accept
        rounds += 1
    # converged iff the loop ended because nothing changed
    return accept, c.claim(accept), not changed, rounds


def sharded_resolve_and_claim(mesh, owner0, success, index, cams, pl,
                              b_start, span_mask,
                              skip_start_check: bool = False,
                              max_rounds: int = MAX_ROUNDS):
    """resolve_and_claim_device with the seed axis sharded over `mesh`
    (full inputs, as there; S a multiple of mesh.size, padded with
    success=False rows): each round every shard scatters its accepted
    spans, the rasters are min-reduced over the mesh (pmin) and every
    shard checks its starts against the merged raster; `changed` is
    max-reduced (pmax).  Returns what resolve_and_claim_device returns,
    `accept` over all S seeds on every process."""
    from edgegraph3d_tpu_torch.parallel.mesh import all_gather, pmax, pmin

    owners = {}
    shards = []
    for _, d, lo, hi in mesh.local_bounds(len(success)):
        o0 = owners.setdefault(d, owner0.to(d))
        shards.append(_Claims(o0, *(a[lo:hi].to(d) for a in (
            success, index, cams, pl, b_start, span_mask))))
    accept = [c.success for c in shards]
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        owner = pmin(mesh, [c.claim(a) for c, a in zip(shards, accept)])
        new_accept = [c.accepted(owner, skip_start_check) for c in shards]
        flags = [(n != a).any().to(torch.int32).reshape(1)
                 for n, a in zip(new_accept, accept)]
        changed = bool(pmax(mesh, flags).item())
        accept = new_accept
        rounds += 1
    owner = pmin(mesh, [c.claim(a) for c, a in zip(shards, accept)])
    return all_gather(mesh, accept), owner, not changed, rounds


def owner_from_bool(raster: torch.Tensor) -> torch.Tensor:
    """Bool claim raster (earlier chunks) -> int32 owner raster."""
    return torch.where(raster, -1, INF).to(torch.int32)


def apply_device_claiming(manager, success, cams, pl, seg, t,
                          fwd_seg, fwd_t, bwd_seg, bwd_t,
                          skip_start_check: bool = False,
                          device="cuda", mesh=None) -> np.ndarray:
    """Drop-in device-backed equivalent of
    `MatchesManager.resolve_and_claim` (same argument contract, host
    arrays in and out): builds the owner raster from the manager's bool
    raster on `device`, resolves the chunk there, and writes the
    accepted claims back.  With `mesh`, on the mesh's first device with
    the seeds sharded over the mesh (sharded_resolve_and_claim), padded
    to a multiple of its shard count with success=False rows."""
    S = len(success)
    if S == 0:
        return np.zeros(0, bool)
    dev = resolve_device(device) if mesh is None else mesh.device
    B = manager.B
    bk = lambda s, tt: np.stack([manager.bucket(cams[:, k], pl[:, k],
                                                s[:, k], tt[:, k])
                                 for k in range(3)], axis=1)
    b_seed, b_fwd, b_bwd = (torch.as_tensor(b, device=dev) for b in (
        bk(seg, t), bk(fwd_seg, fwd_t), bk(bwd_seg, bwd_t)))
    span = _span_masks(b_seed, b_fwd, b_bwd, B)
    owner0 = owner_from_bool(torch.as_tensor(manager.raster, device=dev))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    args = (torch.as_tensor(np.asarray(success, bool), device=dev),
            torch.arange(S, dtype=torch.int32, device=dev), i32(cams),
            i32(pl), b_seed[:, 0], span)
    if mesh is None:
        accept, owner, converged, rounds = resolve_and_claim_device(
            owner0, *args, skip_start_check=skip_start_check,
            max_rounds=MAX_ROUNDS)
    else:
        pad = -S % mesh.size
        args = tuple(torch.cat([a, torch.zeros((pad,) + a.shape[1:],
                                               dtype=a.dtype, device=dev)])
                     for a in args)
        accept, owner, converged, rounds = sharded_resolve_and_claim(
            mesh, owner0, *args, skip_start_check=skip_start_check,
            max_rounds=MAX_ROUNDS)
        accept = accept[:S]
    c = manager.counters
    c["device_claiming_chunks"] = c.get("device_claiming_chunks", 0) + 1
    c["device_claiming_rounds"] = c.get("device_claiming_rounds", 0) + rounds
    c["device_claiming_rounds_max"] = max(
        c.get("device_claiming_rounds_max", 0), rounds)
    if not converged:
        # max_rounds cut the fixpoint (dependency chains deeper than its
        # alternations): the exact host pass decides, so the accept set
        # never diverges from the sequential semantics; counted
        manager.counters["device_claiming_fallback"] = \
            manager.counters.get("device_claiming_fallback", 0) + 1
        return manager.resolve_and_claim(
            success, cams, pl, seg, t, fwd_seg, fwd_t, bwd_seg, bwd_t,
            skip_start_check=skip_start_check)
    accept = accept.cpu().numpy()
    manager.raster |= (owner < INF).cpu().numpy()
    n_skipped = int((np.asarray(success, bool) & ~accept).sum())
    manager.counters["seeds_skipped_claimed"] += n_skipped
    return accept
