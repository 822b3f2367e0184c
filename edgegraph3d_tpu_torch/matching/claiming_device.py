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
`device_claiming_rounds`, `device_claiming_rounds_max`).  The sharded
variant (`sharded_resolve_and_claim`, a cross-device min merge) belongs
to the multi-GPU port (ROADMAP queue A item 10).
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


def resolve_and_claim_device(owner0, success, index, cams, pl, b_start,
                             span_mask, skip_start_check: bool = False,
                             max_rounds: int = MAX_ROUNDS):
    """owner0 [V,P,B] int32 (INF free / -1 earlier chunks), success [S]
    bool, index [S] int32 global seed order, cams/pl [S,3] int,
    b_start [S], span_mask [S,3,B] bool.  Returns (accept [S],
    owner [V,P,B], converged, rounds): `converged` is False when
    max_rounds cut the fixpoint; `rounds` counts the loop's rounds."""
    V, P, B = owner0.shape
    dev = owner0.device
    inf = torch.tensor(INF, dtype=torch.int32, device=dev)
    idx_col = torch.where(success, index.to(torch.int32), inf)
    # flat raster index of every (seed, tuple view, bucket)
    flat = ((cams.long() * P + pl.long())[..., None] * B
            + torch.arange(B, device=dev)).reshape(-1)
    start = (cams[:, 0].long() * P + pl[:, 0].long()) * B + b_start.long()

    def claim(accept):
        w = torch.where(accept[:, None, None] & span_mask,
                        idx_col[:, None, None], inf).reshape(-1)
        return owner0.reshape(-1).clone().scatter_reduce_(
            0, flat, w, "amin").view(V, P, B)

    accept = success
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        owner = claim(accept)
        if skip_start_check:
            new_accept = success
        else:
            new_accept = success & ~(owner.reshape(-1)[start] < index)
        changed = bool((new_accept != accept).any())
        accept = new_accept
        rounds += 1
    # converged iff the loop ended because nothing changed
    return accept, claim(accept), not changed, rounds


def owner_from_bool(raster: torch.Tensor) -> torch.Tensor:
    """Bool claim raster (earlier chunks) -> int32 owner raster."""
    return torch.where(raster, -1, INF).to(torch.int32)


def apply_device_claiming(manager, success, cams, pl, seg, t,
                          fwd_seg, fwd_t, bwd_seg, bwd_t,
                          skip_start_check: bool = False,
                          device="cuda") -> np.ndarray:
    """Drop-in device-backed equivalent of
    `MatchesManager.resolve_and_claim` (same argument contract, host
    arrays in and out): builds the owner raster from the manager's bool
    raster on `device`, resolves the chunk there, and writes the
    accepted claims back."""
    S = len(success)
    if S == 0:
        return np.zeros(0, bool)
    dev = resolve_device(device)
    B = manager.B
    bk = lambda s, tt: np.stack([manager.bucket(cams[:, k], pl[:, k],
                                                s[:, k], tt[:, k])
                                 for k in range(3)], axis=1)
    b_seed, b_fwd, b_bwd = (torch.as_tensor(b, device=dev) for b in (
        bk(seg, t), bk(fwd_seg, fwd_t), bk(bwd_seg, bwd_t)))
    span = _span_masks(b_seed, b_fwd, b_bwd, B)
    owner0 = owner_from_bool(torch.as_tensor(manager.raster, device=dev))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    accept, owner, converged, rounds = resolve_and_claim_device(
        owner0, torch.as_tensor(np.asarray(success, bool), device=dev),
        torch.arange(S, dtype=torch.int32, device=dev), i32(cams), i32(pl),
        b_seed[:, 0], span, skip_start_check=skip_start_check,
        max_rounds=MAX_ROUNDS)
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
