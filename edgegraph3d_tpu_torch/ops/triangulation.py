"""N-view DLT triangulation and batched per-point Gauss-Newton.

Port of edgegraph3d_tpu/ops/triangulation.py.  The hot path is kernel
K3 (`triangulate_gn`, csrc/triangulate_gn.cu): one CUDA thread per point
runs the optional DLT init and the GN loop with cameras given as an
index into P_mats; at O = 3 from registers, otherwise over the point's
present observations only, with the P table in shared memory (or, for a
table beyond the card's shared memory, read from device memory).  The
plain-torch functions below carry the same semantics in the kernel's
operation order (the padded form, which the kernel equals bit for bit);
`triangulate_gn` uses them for CPU tensors only.

Semantics (em_GaussNewton parity, see the JAX module): mse = sum r^2 /
(2 n_obs); a point freezes when |mse - last_mse| < epsilon; a step is
refused (and the point turns singular) when |det H| < det_min or
|det H| < 1e-5 * scale(H)^3; valid = !singular && last_mse < accept_mse
&& n_obs >= 2.  Unlike the JAX code, O == 0 is accepted (every point
comes back invalid).

Types.  The computation runs in the promoted type of P_mats, xy and X0
(jnp.result_type under x64, as the JAX GN promotes them): f32, or f64
for EdgeGraphConfig(dtype="float64"), where K3 launches its f64 bodies
(the O = 3 register body in double, and the padded loop as its general
body).
"""

from __future__ import annotations

import numpy as np
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops.geometry import project
from edgegraph3d_tpu_torch.ops.linalg3 import smallest_eigvec4


def p_soa(P_obs: torch.Tensor) -> list:
    """[N, O, 3, 4] per-observation cameras -> nested [O][3][4] lists of
    [N] component vectors (the plain solvers' layout)."""
    O = P_obs.shape[1]
    return [[[P_obs[:, o, r, c] for c in range(4)] for r in range(3)]
            for o in range(O)]


def _guard(v: torch.Tensor, tiny: float) -> torch.Tensor:
    """v, with |v| < tiny replaced by +-tiny in v's own type."""
    t = torch.full((), tiny, dtype=v.dtype, device=v.device)
    return torch.where(v.abs() < tiny, torch.where(v < 0, -t, t), v)


def triangulate_dlt_soa(P: list, ox: list, oy: list, mf: list, N: int,
                        dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous N-view DLT, SoA interface -> X [N, 3].  Rows
    (x*P3 - P1), (y*P3 - P2) per view, each scaled to unit norm times its
    weight; smallest eigenvector of A^T A by ridged inverse iteration."""
    zero = torch.zeros(N, dtype=dtype, device=device)
    ata = [[zero] * 4 for _ in range(4)]
    for o in range(len(P)):
        p = P[o]
        for coord, prow in ((ox[o], 0), (oy[o], 1)):
            row = [coord * p[2][c] - p[prow][c] for c in range(4)]
            nrm = torch.sqrt(row[0] * row[0] + row[1] * row[1]
                             + row[2] * row[2] + row[3] * row[3])
            scale = mf[o] / torch.clamp_min(nrm, 1e-12)
            row = [r * scale for r in row]
            for a in range(4):
                for b in range(a, 4):
                    ata[a][b] = ata[a][b] + row[a] * row[b]
    v = smallest_eigvec4(ata)
    w = _guard(v[3], 1e-12)
    return torch.stack([v[0] / w, v[1] / w, v[2] / w], dim=-1)


def triangulate_dlt(P: torch.Tensor, xy: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Tensor interface: P [..., O, 3, 4], xy [..., O, 2], mask [..., O]
    -> X [..., 3]."""
    batch = mask.shape[:-1]
    O = mask.shape[-1]
    Pf = P.reshape(-1, O, 3, 4)
    xyf = xy.reshape(-1, O, 2)
    mff = mask.reshape(-1, O).to(P.dtype)
    X = triangulate_dlt_soa(
        p_soa(Pf), [xyf[:, o, 0] for o in range(O)],
        [xyf[:, o, 1] for o in range(O)], [mff[:, o] for o in range(O)],
        Pf.shape[0], P.dtype, P.device)
    return X.reshape(batch + (3,))


def gauss_newton_soa(P: list, ox: list, oy: list, mf: list,
                     X0: torch.Tensor, max_iters: int = 30,
                     epsilon: float = 5e-7, accept_mse: float = 9.0,
                     det_min: float = 1e-5):
    """Refine all points at once, SoA interface -> (X, mse, valid).
    Points freeze individually; the loop stops when every point is
    frozen or singular (exact: both states are fixed points).  Runs in
    the promoted type of X0, P and the points (the JAX GN's common
    promotion)."""
    N = X0.shape[0]
    dtype = kernels.compute_dtype(X0, *[p[0][0] for p in P[:1]], *ox[:1])
    X0 = X0.to(dtype)
    zero = torch.zeros(N, dtype=dtype, device=X0.device)
    mask_sum = zero
    for m in mf:
        mask_sum = mask_sum + m
    n_obs = torch.clamp_min(mask_sum, 1.0)
    x, y, z = X0[:, 0], X0[:, 1], X0[:, 2]
    last_mse = zero
    frozen = torch.zeros(N, dtype=torch.bool, device=X0.device)
    singular = frozen
    for _ in range(max_iters):
        if bool((frozen | singular).all()):
            break
        H = [[zero] * 3 for _ in range(3)]
        g = [zero] * 3
        sq = zero
        for o in range(len(P)):
            p = P[o]
            xH = p[0][0] * x + p[0][1] * y + p[0][2] * z + p[0][3]
            yH = p[1][0] * x + p[1][1] * y + p[1][2] * z + p[1][3]
            zH = _guard(p[2][0] * x + p[2][1] * y + p[2][2] * z + p[2][3],
                        1e-12)
            rx = (ox[o] - xH / zH) * mf[o]
            ry = (oy[o] - yH / zH) * mf[o]
            sq = sq + rx * rx + ry * ry
            inv_z2 = mf[o] / (zH * zH)
            Jx = [(p[0][c] * zH - p[2][c] * xH) * inv_z2 for c in range(3)]
            Jy = [(p[1][c] * zH - p[2][c] * yH) * inv_z2 for c in range(3)]
            for a in range(3):
                g[a] = g[a] + Jx[a] * rx + Jy[a] * ry
                for b in range(a, 3):
                    H[a][b] = H[a][b] + Jx[a] * Jx[b] + Jy[a] * Jy[b]
        mse = sq / (2.0 * n_obs)
        now_frozen = frozen | ((mse - last_mse).abs() < epsilon)
        h00, h01, h02 = H[0][0], H[0][1], H[0][2]
        h11, h12, h22 = H[1][1], H[1][2], H[2][2]
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        det = h00 * c00 + h01 * c01 + h02 * c02
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        safe = _guard(det, 1e-20)
        dx = (c00 * g[0] + c01 * g[1] + c02 * g[2]) / safe
        dy = (c01 * g[0] + c11 * g[1] + c12 * g[2]) / safe
        dz = (c02 * g[0] + c12 * g[1] + c22 * g[2]) / safe
        h_sq = (h00 * h00 + h11 * h11 + h22 * h22
                + 2.0 * (h01 * h01 + h02 * h02 + h12 * h12))
        h_scale = torch.sqrt(h_sq / 3.0)
        bad = (det.abs() < det_min) | (
            det.abs() < 1e-5 * (h_scale * (h_scale * h_scale)))
        step_ok = ~(now_frozen | bad)
        x = torch.where(step_ok, x + dx, x)
        y = torch.where(step_ok, y + dy, y)
        z = torch.where(step_ok, z + dz, z)
        last_mse = torch.where(now_frozen, last_mse, mse)
        singular = singular | (bad & ~now_frozen)
        frozen = now_frozen
    X = torch.stack([x, y, z], dim=-1)
    valid = (~singular) & (last_mse < accept_mse) & (mask_sum >= 2)
    return X, last_mse, valid


def gauss_newton_batched(P_obs: torch.Tensor, xy: torch.Tensor,
                         mask: torch.Tensor, X0: torch.Tensor,
                         max_iters: int = 30, epsilon: float = 5e-7,
                         accept_mse: float = 9.0, det_min: float = 1e-5):
    """Tensor interface: P_obs [N, O, 3, 4], xy [N, O, 2], mask [N, O],
    X0 [N, 3] -> (X, mse, valid)."""
    O = mask.shape[1]
    return gauss_newton_soa(
        p_soa(P_obs), [xy[:, o, 0] for o in range(O)],
        [xy[:, o, 1] for o in range(O)],
        [mask[:, o].to(X0.dtype) for o in range(O)], X0,
        max_iters=max_iters, epsilon=epsilon, accept_mse=accept_mse,
        det_min=det_min)


def _triangulate_gn_plain(P_mats, cams, xy, mask, X0, max_iters, epsilon,
                          accept_mse, det_min):
    N, O = mask.shape
    dt = kernels.compute_dtype(P_mats, xy, X0)
    P_mats, xy = P_mats.to(dt), xy.to(dt)
    X0 = None if X0 is None else X0.to(dt)
    P = p_soa(P_mats[cams.long()])
    ox = [xy[:, o, 0] for o in range(O)]
    oy = [xy[:, o, 1] for o in range(O)]
    mf = [mask[:, o].to(xy.dtype) for o in range(O)]
    if X0 is None:
        X0 = triangulate_dlt_soa(P, ox, oy, mf, N, xy.dtype, xy.device)
    return gauss_newton_soa(P, ox, oy, mf, X0, max_iters=max_iters,
                            epsilon=epsilon, accept_mse=accept_mse,
                            det_min=det_min)


def gn_table_bytes(V: int, dtype=torch.float32) -> int:
    """Bytes of K3's general-body table: in f32, P_mats and the probe
    row [(V + 1), 3, 4] and a tame flag per camera (csrc
    triangulate_gn.cu gn_smem_bytes); in f64, P_mats [V, 3, 4] in double
    (the padded body's gn_smem_bytes_f64)."""
    if dtype == torch.float64:
        return V * 96
    return (V + 1) * 48 + V


def triangulate_gn(P_mats: torch.Tensor, cams: torch.Tensor,
                   xy: torch.Tensor, mask: torch.Tensor,
                   X0: torch.Tensor | None = None, max_iters: int = 30,
                   epsilon: float = 5e-7, accept_mse: float = 9.0,
                   det_min: float = 1e-5):
    """Kernel K3: DLT init (when X0 is None) + GN for every point.

    P_mats [V, 3, 4], cams [N, O] i32 camera index per observation,
    xy [N, O, 2], mask [N, O] bool, X0 [N, 3] or None -> (X [N, 3],
    mse [N], valid [N] bool) in the promoted type of P_mats, xy and X0
    (f32 or f64; an f32 input beside an f64 one is widened, as the JAX
    GN promotes it).  CUDA tensors launch the kernel (for O != 3 with
    its camera table placed by kernels.table_placement, so any V runs);
    CPU tensors take the plain-torch twin."""
    if xy.device.type == "cpu":
        return _triangulate_gn_plain(P_mats, cams, xy, mask, X0, max_iters,
                                     epsilon, accept_mse, det_min)
    N, O = mask.shape
    V = P_mats.shape[0]
    dt = kernels.require_float(kernels.compute_dtype(P_mats, xy, X0),
                               "triangulate_gn")
    P_mats, cams, xy, mask = (t.contiguous() for t in (P_mats.to(dt), cams,
                                                        xy.to(dt), mask))
    kernels.require(P_mats, "P_mats", dt, (V, 3, 4))
    kernels.require(cams, "cams", torch.int32, (N, O))
    kernels.require(xy, "xy", dt, (N, O, 2))
    kernels.require(mask, "mask", torch.bool, (N, O))
    if X0 is not None:
        X0 = X0.to(dt).contiguous()
        kernels.require(X0, "X0", dt, (N, 3))
    dev = xy.device
    X = torch.empty((N, 3), dtype=dt, device=dev)
    mse = torch.empty(N, dtype=dt, device=dev)
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return X, mse, valid
    place = 0 if O == 3 else kernels.place(
        "triangulate_gn", gn_table_bytes(V, dt), dev)
    entry = "eg3d_triangulate_gn" if dt == torch.float32 else \
        "eg3d_triangulate_gn_f64"
    with kernels.on_device(xy):
        rc = getattr(kernels.lib(), entry)(
            P_mats.data_ptr(), V, cams.data_ptr(), xy.data_ptr(),
            mask.data_ptr(), N, O, kernels.ptr(X0), max_iters, epsilon,
            accept_mse, det_min, place, X.data_ptr(), mse.data_ptr(),
            valid.data_ptr(), kernels.stream_of(xy))
    kernels.check(rc, "triangulate_gn")
    kernels.count_launch("triangulate_gn", dt)
    return X, mse, valid


def add_observation_to_3d_points(P_obs, xy, mask, X, new_P, new_xy,
                                 new_valid=None, max_iters: int = 30,
                                 epsilon: float = 5e-7,
                                 accept_mse: float = 9.0):
    """Add one observation per point (into its first free slot) and
    re-refine warm-started from X (em_add_new_observation_to_3Dpositions
    parity).  Returns (X', mse, valid, mask')."""
    N = X.shape[0]
    if new_valid is None:
        new_valid = torch.ones(N, dtype=torch.bool, device=X.device)
    free = ~mask
    first_free = torch.argmax(free.to(torch.uint8), dim=-1)
    put = new_valid & free.any(-1)
    rows = torch.arange(N, device=X.device)
    P2 = P_obs.clone()
    xy2 = xy.clone()
    mask2 = mask.clone()
    P2[rows, first_free] = torch.where(put[:, None, None], new_P,
                                       P_obs[rows, first_free])
    xy2[rows, first_free] = torch.where(put[:, None], new_xy,
                                        xy[rows, first_free])
    mask2[rows, first_free] = mask[rows, first_free] | put
    Xr, mse, valid = gauss_newton_batched(
        P2, xy2, mask2, X, max_iters=max_iters, epsilon=epsilon,
        accept_mse=accept_mse)
    return Xr, mse, valid, mask2


# ----------------------------------------------------------------------
# Functions the pipeline does not call (the JAX package's tests do):
# widest-pair init, em_estimate3Dpositions, the reprojection MSE and the
# best-subset triangulation.  Plain torch over per-observation cameras
# P_obs, through gauss_newton_batched as in the JAX module (not K3, which
# takes cameras as an index into P_mats).
# ----------------------------------------------------------------------

def triangulate_pair_minmax(P_obs: torch.Tensor, xy: torch.Tensor,
                            cam_idx: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Two-view DLT on the (min cam id, max cam id) observations, the
    widest-baseline init of em_estimate3Dpositions
    (triangulation.cpp:186-254).  P_obs [..., O, 3, 4], xy [..., O, 2],
    cam_idx [..., O] int (-1 padded), mask [..., O] -> X [..., 3]."""
    big = torch.where(mask, cam_idx, torch.iinfo(torch.int32).max)
    small = torch.where(mask, cam_idx, -1)
    sel = torch.stack([torch.argmin(big, dim=-1),
                       torch.argmax(small, dim=-1)], dim=-1)   # [..., 2]
    P2 = torch.take_along_dim(P_obs, sel[..., None, None], dim=-3)
    xy2 = torch.take_along_dim(xy, sel[..., None], dim=-2)
    return triangulate_dlt(P2, xy2, torch.ones(sel.shape, dtype=torch.bool,
                                               device=sel.device))


def estimate_3d_positions(P_obs: torch.Tensor, xy: torch.Tensor,
                          cam_idx: torch.Tensor, mask: torch.Tensor,
                          max_iters: int = 30, epsilon: float = 5e-7,
                          accept_mse: float = 9.0):
    """em_estimate3Dpositions parity (triangulation.cpp:178-323):
    widest-pair DLT init, then batched GN over all observations.
    P_obs [N, O, 3, 4] -> (X [N, 3], mse [N], valid [N])."""
    X0 = triangulate_pair_minmax(P_obs, xy, cam_idx, mask)
    return gauss_newton_batched(P_obs, xy, mask, X0, max_iters=max_iters,
                                epsilon=epsilon, accept_mse=accept_mse)


def reprojection_mse(P_obs: torch.Tensor, xy: torch.Tensor,
                     mask: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Mean squared pixel reprojection error per point, sum r^2 / (2 n).
    P_obs [..., O, 3, 4], xy [..., O, 2], mask [..., O], X [..., 3]."""
    mf = mask.to(X.dtype)
    r = (xy - project(P_obs, X[..., None, :])) * mf[..., None]
    n = torch.clamp_min(mask.sum(-1), 1).to(X.dtype)
    return (r * r).sum((-2, -1)) / (2.0 * n)


def _greedy_readd(P_obs, xy, X, used, candidates, max_iters, epsilon,
                  accept_mse):
    """Re-add, in view order, each candidate observation whose GN
    re-refinement (warm from X) is accepted (triangulation.cpp:1146-1158)."""
    for o in range(used.shape[0]):
        Xr, _, ok, _ = add_observation_to_3d_points(
            P_obs[None], xy[None], used[None], X[None], P_obs[None, o],
            xy[None, o], new_valid=candidates[o:o + 1], max_iters=max_iters,
            epsilon=epsilon, accept_mse=accept_mse)
        accept = candidates[o] & ok[0]
        X = torch.where(accept, Xr[0], X)
        used[o] |= accept
    return X, used


def triangulate_view_combinations(P_obs: torch.Tensor, xy: torch.Tensor,
                                  mask: torch.Tensor, min_views: int = 3,
                                  max_iters: int = 30, epsilon: float = 5e-7,
                                  accept_mse: float = 9.0,
                                  max_subset_views: int = 12):
    """Best-subset triangulation + greedy re-expansion (parity:
    compute_3d_point_coords_combinations, triangulation.cpp:1105-1158).

    The JAX module's documented deviation from the reference is kept:
    every subset of at least `min_views` observations is solved in one
    batched GN (`estimate_3d_positions`, subsets as the batch, in the
    JAX module's order of subset masks, so ties break the same way), the
    winner is the accepted subset of the largest size, then the least
    MSE, and the excluded observations are re-added greedily in view
    order.  At most `max_subset_views` observations (the first valid
    ones) enter the enumeration; the rest are only re-added.

    P_obs [O, 3, 4], xy [O, 2], mask [O] (one point's candidate views)
    -> (X [3], mse, valid, used_mask [O])."""
    O = int(mask.shape[0])
    kw = dict(max_iters=max_iters, epsilon=epsilon, accept_mse=accept_mse)
    dev = mask.device
    if O > max_subset_views:
        order = torch.argsort((~mask).to(torch.int8), stable=True)
        sel = order[:max_subset_views]
        X, _, valid, used_k = triangulate_view_combinations(
            P_obs[sel], xy[sel], mask[sel], min_views=min_views,
            max_subset_views=max_subset_views, **kw)
        used = torch.zeros(O, dtype=torch.bool, device=dev)
        used[sel] = used_k
        in_enum = torch.zeros(O, dtype=torch.bool, device=dev)
        in_enum[sel] = True
        X, used = _greedy_readd(P_obs, xy, X, used,
                                mask & ~in_enum & valid, **kw)
        mse = reprojection_mse(P_obs[None], xy[None], used[None], X[None])[0]
        return X, mse, valid, used
    bits = np.arange(2 ** O, dtype=np.uint32)
    table = ((bits[:, None] >> np.arange(O)) & 1).astype(bool)   # [S, O]
    table = table[table.sum(axis=1) >= min_views]
    if len(table) == 0:
        return (torch.zeros(3, dtype=P_obs.dtype, device=dev),
                torch.tensor(float("inf"), dtype=P_obs.dtype, device=dev),
                torch.tensor(False, device=dev),
                torch.zeros(O, dtype=torch.bool, device=dev))
    m_sub = torch.as_tensor(table, device=dev) & mask[None, :]   # [S, O]
    S = m_sub.shape[0]
    size = m_sub.sum(-1)
    X_s, mse_s, ok_s = estimate_3d_positions(
        P_obs[None].expand((S,) + P_obs.shape),
        xy[None].expand((S,) + xy.shape),
        torch.arange(O, dtype=torch.int32, device=dev)[None].expand(S, O),
        m_sub, **kw)
    ok_s = ok_s & (size >= min_views)
    # lexicographic (max size, then min mse), in two exact steps
    max_size = torch.where(ok_s, size, -1).max()
    tier = ok_s & (size == max_size)
    best = torch.argmin(torch.where(tier, mse_s, float("inf")))
    any_ok = ok_s.any()
    used = m_sub[best] & any_ok
    X, used = _greedy_readd(P_obs, xy, X_s[best], used,
                            mask & ~used & any_ok, **kw)
    mse = reprojection_mse(P_obs[None], xy[None], used[None], X[None])[0]
    return X, mse, any_ok, used
