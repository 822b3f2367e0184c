"""Multi-view geometry on torch tensors (projection, F tables, epipolar
lines).  Port of edgegraph3d_tpu/ops/geometry.py.

Contractions are written out as elementwise products summed left to
right — the order the hand kernels use — so the plain path and the CUDA
kernels round identically.

LMedS F (`fundamental_lmeds`, config.fmat_source="lmeds") is plain torch
in f32, batched: the normalized 8-point fit of every subset at once
(`torch.linalg.eigh` of the 9x9 normal matrices, `torch.linalg.svd` for
rank 2), scored by the masked median of squared Sampson distances, then
refit on the inliers.  One difference from the JAX package: JAX draws the
8-point subsets with `jax.random.categorical` from PRNGKey(0), which torch
cannot reproduce.  The port draws each index uniformly, with replacement,
among the masked correspondences, from a CPU `torch.Generator` seeded
with 0 (`lmeds_subsets`; the same draws on the CPU and the card), and
takes an optional `subsets` tensor so that tests can feed JAX's own
draws.  The sign of F follows the eigenvector `eigh` returns and may
differ between LAPACK and cuSOLVER; F is defined up to sign.
"""

from __future__ import annotations

import numpy as np
import torch


def _apply34(P: torch.Tensor, X: torch.Tensor):
    """Rows of P [..., 3, 4] applied to homogeneous [X; 1] (X [..., 3])."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    return [P[..., i, 0] * x + P[..., i, 1] * y + P[..., i, 2] * z
            + P[..., i, 3] for i in range(3)]


def _guard_z(z: torch.Tensor) -> torch.Tensor:
    """z, with |z| < 1e-12 replaced by +-1e-12 in z's own type."""
    t = torch.full((), 1e-12, dtype=z.dtype, device=z.device)
    return torch.where(z.abs() < 1e-12, torch.where(z < 0, -t, t), z)


def project(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """P [..., 3, 4], X [..., 3] -> [..., 2] (broadcasting leading dims)."""
    xh, yh, zh = _apply34(P, X)
    z = _guard_z(zh)
    return torch.stack([xh / z, yh / z], dim=-1)


def project_depth(P: torch.Tensor, X: torch.Tensor):
    """Like `project` but also returns the projective depth z."""
    xh, yh, zh = _apply34(P, X)
    z = _guard_z(zh)
    return torch.stack([xh / z, yh / z], dim=-1), zh


def _cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)], dim=-2)


def fundamental_from_cameras(P1: torch.Tensor, P2: torch.Tensor,
                             C1: torch.Tensor) -> torch.Tensor:
    """Exact F mapping view-1 points to view-2 epipolar lines,
    F = [e2]_x P2 P1^+ with e2 = P2 [C1; 1], Frobenius-normalized, in the
    inputs' dtype.  P1, P2 [..., 3, 4], C1 [..., 3] camera-1 center."""
    e2 = torch.stack(_apply34(P2, C1), dim=-1)
    F = _cross_matrix(e2) @ P2 @ torch.linalg.pinv(P1)
    scale = torch.linalg.matrix_norm(F, keepdim=True)
    return F / torch.where(scale < 1e-20, 1.0, scale)


def all_fundamental_matrices(P, centers,
                             dtype=torch.float32) -> torch.Tensor:
    """All-pairs F table [V, V, 3, 3]; F[i, j] maps view-i points to
    view-j lines: F = [e_j]_x P_j P_i^+ with e_j = P_j [C_i; 1],
    Frobenius-normalized.  Computed in float64 on the host (a 49-view
    table is 2401 tiny products) and returned in `dtype` (float32, or
    float64 for EdgeGraphConfig(dtype="float64"))."""
    P = np.asarray(P, np.float64)
    C = np.asarray(centers, np.float64)
    Pp = np.linalg.pinv(P)                                   # [V,4,3]
    e = np.einsum("jab,ib->ija", P,
                  np.concatenate([C, np.ones((len(C), 1))], axis=1))
    zero = np.zeros(e.shape[:2])
    ex = np.stack([
        np.stack([zero, -e[..., 2], e[..., 1]], -1),
        np.stack([e[..., 2], zero, -e[..., 0]], -1),
        np.stack([-e[..., 1], e[..., 0], zero], -1)], -2)     # [i,j,3,3]
    F = ex @ P[None, :] @ Pp[:, None]
    scale = np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    F = F / np.where(scale < 1e-20, 1.0, scale)
    return torch.as_tensor(F, dtype=dtype)


def epipolar_line(F: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """l' = F [x; 1], scaled so a^2 + b^2 = 1
    (cv::computeCorrespondEpilines).  F [..., 3, 3], x [..., 2] -> [..., 3]."""
    px, py = x[..., 0], x[..., 1]
    l0, l1, l2 = [F[..., i, 0] * px + F[..., i, 1] * py + F[..., i, 2]
                  for i in range(3)]
    n = torch.clamp_min(torch.sqrt(l0 * l0 + l1 * l1), 1e-20)
    return torch.stack([l0 / n, l1 / n, l2 / n], dim=-1)


def point_line_distance(line: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Signed distance of 2D points to a*x+b*y+c=0 lines with a^2+b^2=1."""
    return line[..., 0] * x[..., 0] + line[..., 1] * x[..., 1] + line[..., 2]


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e): s = a + b rounded and its exact error, a + b = s + e."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e): p = a * b rounded and its exact error (Dekker's product
    with Veltkamp's split; f64 values far from overflow)."""
    p = a * b
    ca, cb = 134217729.0 * a, 134217729.0 * b           # 2^27 + 1
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd: exact sums as they are, an inexact one to
    the neighbour of the two around it whose last bit is odd."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    return torch.where((e != 0) & even,
                       torch.nextafter(s, torch.where(e > 0, inf, -inf)), s)


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f64 a * b + c, as the hardware's fma gives
    it (XLA's CPU code and common.cuh fmaT on the card): the exact
    product as two doubles, then Boldo and Melquiond's sum of three
    numbers with its inner sum rounded to odd."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    return th + _round_odd_sum(tl, pl)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding of the sum, in the promoted type.  For
    f32 values the f64 product is exact, so only the f64 sum rounds
    before the cast back; for f64 values, _fma64."""
    if torch.float64 in (a.dtype, b.dtype, c.dtype):
        a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
        return _fma64(a.contiguous(), b.contiguous(), c.contiguous())
    return (a.double() * b.double() + c.double()).to(a.dtype)


def epipolar_line_fma(F: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`epipolar_line` with the contractions XLA's CPU dot makes in the
    JAX stage-1/2 sweep (polyline_stages._group_seed_sweep):
    l_i = fma(F_i1, y, F_i0 x) + F_i2 and a^2 + b^2 = fma(a, a, b b).
    The square root is taken in f64, which rounds to the correctly
    rounded f32 root (torch's vectorized f32 sqrt on the CPU is off by an
    ULP on some inputs).  Kernel K6 computes the same form
    (common.cuh epipolar_fma)."""
    px, py = x[..., 0], x[..., 1]
    l0, l1, l2 = [_fma(F[..., i, 1], py, F[..., i, 0] * px) + F[..., i, 2]
                  for i in range(3)]
    n = torch.clamp_min(torch.sqrt(_fma(l0, l0, l1 * l1).double())
                        .to(l0.dtype), 1e-20)
    return torch.stack([l0 / n, l1 / n, l2 / n], dim=-1)


# ----------------------------------------------------------------------
# LMedS fundamental matrices from correspondences
# ----------------------------------------------------------------------

def _normalize_points(x: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization of masked points x [..., N, 2]: zero mean,
    mean distance sqrt(2).  Returns (xn, T [..., 3, 3]) with
    xn_h = T x_h."""
    w = mask.to(x.dtype)[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)
    mean = (x * w).sum(-2, keepdim=True) / n[..., None, :]
    d = torch.sqrt(((x - mean) ** 2).sum(-1, keepdim=True))
    mean_d = (d * w).sum(-2) / n
    s = 2.0 ** 0.5 / torch.clamp_min(mean_d[..., 0], 1e-12)
    xn = (x - mean) * s[..., None, None]
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zeros, -s * mean[..., 0, 0]], dim=-1),
        torch.stack([zeros, s, -s * mean[..., 0, 1]], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    return xn, T


def fundamental_8point(x1: torch.Tensor, x2: torch.Tensor,
                       mask: torch.Tensor):
    """Normalized 8-point algorithm on masked correspondences.

    x1, x2 [..., N, 2]; mask [..., N].  Returns (F [..., 3, 3], valid):
    F maps x1-points to x2-lines (x2h^T F x1h = 0), rank 2, unit
    Frobenius norm; valid needs >= 8 correspondences."""
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], dim=-1)
    A = A * mask.to(A.dtype)[..., None]
    _, vecs = torch.linalg.eigh(A.transpose(-2, -1) @ A)
    F = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = U @ (S[..., :, None] * Vh)
    F = T2.transpose(-2, -1) @ F @ T1
    scale = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    F = F / torch.where(scale < 1e-20, torch.ones_like(scale), scale)
    return F, mask.sum(-1) >= 8


def _sampson_sq(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Squared Sampson distance per correspondence [..., N]."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1h)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2h)
    num = (x2h * Fx1).sum(-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / torch.clamp_min(den, 1e-20)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries along the last axis (the mean of the
    two middle values for an even count)."""
    s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    n = mask.sum(-1)
    top = x.shape[-1] - 1
    lo = ((n - 1) // 2).clamp(0, top)
    hi = ((n - 1) // 2 + (n % 2 == 0).to(n.dtype)).clamp(0, top)
    vlo = torch.take_along_dim(s, lo[..., None], dim=-1)[..., 0]
    vhi = torch.take_along_dim(s, hi[..., None], dim=-1)[..., 0]
    return 0.5 * (vlo + vhi)


def lmeds_subsets(mask: torch.Tensor, n_subsets: int = 64) -> torch.Tensor:
    """Random 8-point subsets [..., n_subsets, 8] (int64 indices into N)
    for masks [..., N]: each index uniform, with replacement, among the
    masked positions.  The uniforms come from a CPU generator seeded
    with 0, so the CPU and the card draw the same subsets."""
    n = mask.sum(-1)
    u = torch.rand(mask.shape[:-1] + (n_subsets, 8),
                   generator=torch.Generator().manual_seed(0))
    k = torch.minimum(torch.floor(u.to(mask.device) * n[..., None, None])
                      .long(), torch.clamp_min(n - 1, 0)[..., None, None])
    cum = mask.long().cumsum(-1)
    idx = torch.searchsorted(cum, (k + 1).reshape(k.shape[:-2] + (-1,)))
    return idx.clamp_max(mask.shape[-1] - 1).reshape(k.shape)


def fundamental_lmeds(x1: torch.Tensor, x2: torch.Tensor,
                      mask: torch.Tensor, n_subsets: int = 64,
                      min_points: int = 10,
                      subsets: torch.Tensor | None = None):
    """LMedS-style robust F (parity: cv::findFundamentalMat(FM_LMEDS)).

    x1, x2 [..., N, 2], mask [..., N].  Fits each 8-point subset
    (`subsets` [..., n_subsets, 8], else `lmeds_subsets(mask,
    n_subsets)`), scores it by the median squared Sampson distance over
    the masked correspondences, keeps the best (the first on ties), then
    refits on the inliers within 2.5 sigma of the robust scale.
    Returns (F [..., 3, 3], valid): valid requires >= min_points
    correspondences."""
    if subsets is None:
        subsets = lmeds_subsets(mask, n_subsets)
    n_pts = mask.sum(-1)
    take = lambda a: torch.take_along_dim(a[..., None, :, :],
                                          subsets[..., None], dim=-2)
    s1, s2 = take(x1), take(x2)                        # [..., S, 8, 2]
    Fs, _ = fundamental_8point(s1, s2, torch.ones(s1.shape[:-1],
                                                  dtype=torch.bool,
                                                  device=s1.device))
    m = mask[..., None, :]
    d2 = torch.where(m, _sampson_sq(Fs, x1[..., None, :, :],
                                    x2[..., None, :, :]), torch.inf)
    meds = _masked_median(d2, m.expand(d2.shape))      # [..., S]
    best = torch.argmin(meds, dim=-1)
    F_best = torch.take_along_dim(Fs, best[..., None, None, None],
                                  dim=-3)[..., 0, :, :]
    med_best = torch.take_along_dim(meds, best[..., None], dim=-1)[..., 0]

    # robust scale (as in LMedS): sigma = 1.4826 (1 + 5/(n-8)) sqrt(med)
    sigma = (1.4826 * (1.0 + 5.0 / torch.clamp_min(n_pts - 8, 1))
             * torch.sqrt(med_best))
    d2 = _sampson_sq(F_best, x1, x2)
    inl = mask & (d2 <= (2.5 * sigma[..., None]) ** 2)
    F_ref, ok8 = fundamental_8point(x1, x2, inl)
    use_refit = ok8 & torch.isfinite(med_best)
    F = torch.where(use_refit[..., None, None], F_ref, F_best)
    return F, n_pts >= min_points
