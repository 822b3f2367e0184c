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

OpenCV's FM_LMEDS (`fundamental_lmeds_opencv`, config.fmat_source=
"opencv_lmeds") is the reference's production estimator,
cv::findFundamentalMat(..., FM_LMEDS) with OpenCV's defaults: 7-point
samples (`CV_TRIALS`, 300: `lmeds_trials` at confidence 0.99), each
solved by run7Point in f64 into up to three models, every model scored by
the upper median of OpenCV's error over the pair's points, the least score
kept with no refit (`fundamental_7point`, `cv_epipolar_error`).
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
    """LMedS-style robust F, as the JAX package's (8-point subsets,
    Sampson scores, an inlier refit; `fundamental_lmeds_opencv` is
    OpenCV's FM_LMEDS).

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


# ----------------------------------------------------------------------
# OpenCV's FM_LMEDS: 7-point samples, up to three models each
# ----------------------------------------------------------------------

#: LMeDSPointSetRegistrator's outlier ratio for the trial count, the
#: points of a minimal sample and findFundamentalMat's most trials
#: (OpenCV ptsetreg.cpp, fundam.cpp)
CV_OUTLIER_RATIO = 0.45
CV_MODEL_POINTS = 7
CV_MAX_ITERS = 1000
_FLT_EPSILON = float(np.finfo(np.float32).eps)
_DBL_EPSILON = float(np.finfo(np.float64).eps)


def lmeds_trials(confidence: float) -> int:
    """The trials LMeDS runs: cv::RANSACUpdateNumIters(confidence,
    0.45, 7, 1000), at least 3; 300 at confidence 0.99."""
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"LMedS confidence {confidence!r} is not in (0, 1)")
    num = np.log(1.0 - confidence)
    denom = np.log(1.0 - (1.0 - CV_OUTLIER_RATIO) ** CV_MODEL_POINTS)
    n = (CV_MAX_ITERS if -num >= CV_MAX_ITERS * -denom
         else round(num / denom))
    return max(int(n), 3)


#: the trials findFundamentalMat(FM_LMEDS) runs at its default
#: confidence 0.99: 300
CV_TRIALS = lmeds_trials(0.99)


def lmeds7_samples(n_common, n_trials: int) -> torch.Tensor:
    """Samples [P, n_trials, 7] (int64, on the CPU): for each pair, 7
    distinct positions among its n_common [P] common points (0..n-1, in
    point order), uniform over the ordered 7-subsets.  The uniforms come
    from a CPU generator seeded with 0, drawn once for all the pairs, so
    that the CPU and the card, and any chunking, fit on the same samples.
    OpenCV draws from its own cv::RNG stream, which this does not
    reproduce; nor does it redraw samples whose points are collinear
    (cv::haveCollinearPoints)."""
    n = torch.as_tensor(n_common, dtype=torch.int64).cpu()[:, None]
    u = torch.rand((len(n), n_trials, CV_MODEL_POINTS), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    picks = []
    for i in range(CV_MODEL_POINTS):
        # the k-th of the n - i positions not picked yet ...
        k = torch.minimum(torch.floor(u[..., i] * (n - i)).long(),
                          torch.clamp_min(n - i - 1, 0))
        # ... skipping the picked ones, smallest first
        if picks:
            for c in torch.sort(torch.stack(picks, -1), dim=-1).values \
                    .unbind(-1):
                k = k + (k >= c).long()
        picks.append(k)
    return torch.stack(picks, -1)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinants of 3x3 matrices given as rows of 9 [..., 9]."""
    return (m[..., 0] * (m[..., 4] * m[..., 8] - m[..., 5] * m[..., 7])
            - m[..., 1] * (m[..., 3] * m[..., 8] - m[..., 5] * m[..., 6])
            + m[..., 2] * (m[..., 3] * m[..., 7] - m[..., 4] * m[..., 6]))


def _cofactors(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices of 3x3 matrices, both as rows of 9 [..., 9]."""
    r = m.unflatten(-1, (3, 3))
    return torch.stack([torch.linalg.cross(r[..., 1, :], r[..., 2, :]),
                        torch.linalg.cross(r[..., 2, :], r[..., 0, :]),
                        torch.linalg.cross(r[..., 0, :], r[..., 1, :])],
                       -2).flatten(-2)


def _solve_cubic(a0, a1, a2, a3):
    """Real roots of a0 x^3 + a1 x^2 + a2 x + a3 = 0 in closed form, as
    cv::solveCubic: three by the trigonometric form where Q^3 - R^2 > 0,
    else one by Cardano's (OpenCV's case Q^3 = R^2 gives its double root
    as well); a quadratic or linear equation where the leading
    coefficients are 0.  Returns (x [..., 3], has [..., 3])."""
    cubic = a0 != 0
    inv = 1.0 / torch.where(cubic, a0, torch.ones_like(a0))
    b1, b2, b3 = a1 * inv, a2 * inv, a3 * inv
    Q = (b1 * b1 - 3 * b2) * (1.0 / 9)
    R = (2 * b1 * b1 * b1 - 9 * b1 * b2 + 27 * b3) * (1.0 / 54)
    Qc = Q * Q * Q
    d = Qc - R * R
    three = d > 0
    t0 = -2 * torch.sqrt(torch.where(three, Q, 0))
    t1 = torch.acos((R / torch.sqrt(torch.where(three, Qc, 1)))
                    .clamp(-1, 1)) * (1.0 / 3)
    t2 = b1 * (1.0 / 3)
    trig = torch.stack([t0 * torch.cos(t1 + a) - t2
                        for a in (0.0, 2 * np.pi / 3, -2 * np.pi / 3)], -1)
    e = torch.pow(torch.sqrt(torch.where(three, 0, -d)) + R.abs(), 1.0 / 3)
    e = torch.where(R > 0, -e, e)
    one = e + Q / e - t2
    # a0 = 0: the quadratic a1 x^2 + a2 x + a3, or the linear a2 x + a3
    dq = a2 * a2 - 4 * a1 * a3
    sq = torch.sqrt(dq.clamp_min(0))
    q1, q2 = (-a2 + sq) * 0.5, (a2 + sq) * -0.5
    q = torch.where(q1.abs() > q2.abs(), q1, q2)
    zero = torch.zeros_like(a0)
    x = torch.where(cubic[..., None],
                    torch.where(three[..., None], trig,
                                torch.stack([one, zero, zero], -1)),
                    torch.where((a1 != 0)[..., None],
                                torch.stack([q / a1, a3 / q, zero], -1),
                                torch.stack([-a3 / a2, zero, zero], -1)))
    n = torch.where(cubic, torch.where(three, 3, 1),
                    torch.where(a1 != 0, (dq > 0).long() + (dq >= 0).long(),
                                (a2 != 0).long()))
    return x, torch.arange(3, device=x.device) < n[..., None]


def fundamental_7point(x1: torch.Tensor, x2: torch.Tensor):
    """cv::run7Point on 7 correspondences x1, x2 [..., 7, 2], in f64:
    Hartley normalisation of each set, the two null vectors F1, F2 of the
    7x9 system (the last right singular vectors; A is padded with two
    zero rows to 9x9, which leaves them as they are and lets the card
    take the batched Jacobi SVD), the real roots of
    det(lambda F1 + (1 - lambda) F2) = 0, each a model scaled so that
    F[2,2] = 1 where that is possible.  F maps x1-points to x2-lines.
    Returns (F [..., 3, 3, 3] f64, one per root, and valid [..., 3]:
    a root there, both sets spread, F finite)."""
    dt = torch.float64
    x1, x2 = x1.to(dt), x2.to(dt)
    c1, c2 = x1.mean(-2, keepdim=True), x2.mean(-2, keepdim=True)
    d1 = torch.linalg.vector_norm(x1 - c1, dim=-1).mean(-1)
    d2 = torch.linalg.vector_norm(x2 - c2, dim=-1).mean(-1)
    spread = (d1 >= _FLT_EPSILON) & (d2 >= _FLT_EPSILON)
    s1 = 2.0 ** 0.5 / torch.where(spread, d1, 1.0)
    s2 = 2.0 ** 0.5 / torch.where(spread, d2, 1.0)
    u = (x1 - c1) * s1[..., None, None]
    v = (x2 - c2) * s2[..., None, None]
    u0, u1, v0, v1 = u[..., 0], u[..., 1], v[..., 0], v[..., 1]
    A = torch.stack([v0 * u0, v0 * u1, v0, v1 * u0, v1 * u1, v1, u0, u1,
                     torch.ones_like(u0)], -1)                 # [...,7,9]
    A = torch.cat([A, torch.zeros_like(A[..., :2, :])], -2)
    Vh = torch.linalg.svd(A).Vh
    f2 = Vh[..., 8, :]
    f1 = Vh[..., 7, :] - f2            # F(lambda) = lambda f1 + f2
    x, has = _solve_cubic(_det3(f1), (f2 * _cofactors(f1)).sum(-1),
                          (f1 * _cofactors(f2)).sum(-1), _det3(f2))
    s = f1[..., 8, None] * x + f2[..., 8, None]
    big = s.abs() > _DBL_EPSILON
    mu = torch.where(big, 1.0 / s, 1.0)
    F = (f1[..., None, :] * (x * mu)[..., None]
         + f2[..., None, :] * mu[..., None])
    F[..., 8] = big.to(dt)
    F = F.unflatten(-1, (3, 3))                              # [...,3,3,3]

    def T(s, c):
        z, o = torch.zeros_like(s), torch.ones_like(s)
        return torch.stack([torch.stack([s, z, -s * c[..., 0, 0]], -1),
                            torch.stack([z, s, -s * c[..., 0, 1]], -1),
                            torch.stack([z, z, o], -1)], -2)[..., None, :, :]
    F = T(s2, c2).transpose(-2, -1) @ F @ T(s1, c1)
    f22 = F[..., 2, 2, None, None]
    F = torch.where(f22.abs() > _FLT_EPSILON, F / f22, F)
    return F, has & spread[..., None] & torch.isfinite(F).all(-1).all(-1)


def cv_epipolar_error(F: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """OpenCV's FM error (FMEstimatorCallback::computeError) of models
    F [..., M, 3, 3] on points x1, x2 [..., N, 2]: the larger of the
    squared distances of x2 to the line F x1h and of x1 to the line
    F^T x2h, in f64, stored as f32 [..., M, N] (NaN as +inf).  Both
    share the residual r = x2h^T F x1h (OpenCV forms it twice, which
    differs in rounding only), so err = r^2 / min(|ab(F x1h)|^2,
    |ab(F^T x2h)|^2).  r and the four line coefficients are one f64
    product of [5M, 15] model rows with [15, N] point features
    (x2h (x) x1h, x1h, x2h): the [M, N] work runs as a matrix product
    and a few elementwise passes."""
    dt = torch.float64
    F = F.to(dt)
    one = lambda x: torch.cat([x.to(dt), torch.ones_like(x[..., :1],
                                                         dtype=dt)], -1)
    x1h, x2h = one(x1), one(x2)
    feats = torch.cat([(x2h[..., :, None] * x1h[..., None, :]).flatten(-2),
                       x1h, x2h], -1)                          # [...,N,15]
    z3 = torch.zeros_like(F[..., 0, :])
    z9 = torch.cat([z3, z3, z3], -1)
    rows = torch.stack([
        torch.cat([F.flatten(-2), z3, z3], -1),
        torch.cat([z9, F[..., 0, :], z3], -1),
        torch.cat([z9, F[..., 1, :], z3], -1),
        torch.cat([z9, z3, F[..., :, 0]], -1),
        torch.cat([z9, z3, F[..., :, 1]], -1)], -3)           # [...,5,M,15]
    out = (rows.flatten(-3, -2) @ feats.transpose(-1, -2)).unflatten(
        -2, rows.shape[-3:-1])                                 # [...,5,M,N]
    r, a2, b2, a1, b1 = out.unbind(-3)
    den = torch.hypot(a2, b2)
    den = torch.minimum(den, torch.hypot(a1, b1), out=den)
    err = r.div_(den).square_().float()
    del out, den
    return err.masked_fill_(err.isnan(), float("inf"))


def _upper_median(err: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """err [P, M, N] with each pair's n [P] points first -> [P, M], the
    element n // 2 of each row's first n sorted (OpenCV's
    nth_element at count / 2: the upper middle of an even count).  One
    selection at N // 2 serves every n: of a pair's N - n other slots,
    N // 2 - n // 2 read below every error and the rest above."""
    N = err.shape[-1]
    j = torch.arange(N, device=err.device)
    n = n.to(err.device)[:, None]
    if bool((n < N).any()):
        low = (j - n) < (N // 2 - n // 2)
        fill = torch.where(low, -1.0, float("inf")).to(err.dtype)
        err = torch.where((j >= n)[:, None, :], fill[:, None, :], err)
    return torch.kthvalue(err, N // 2 + 1, dim=-1).values


def fundamental_lmeds_opencv(x1: torch.Tensor, x2: torch.Tensor,
                             n: torch.Tensor, samples: torch.Tensor,
                             min_points: int = 10) -> dict:
    """OpenCV's FM_LMEDS (LMeDSPointSetRegistrator::run with
    FMEstimatorCallback) for P pairs at once.

    x1, x2 [P, N, 2]: each pair's common points first, n [P] of them
    (the rest ignored); samples [P, T, 7] positions among them
    (`lmeds7_samples`).  Each sample gives up to three models
    (`fundamental_7point`); each model is scored by the upper median of
    `cv_epipolar_error` over the pair's points; the least score wins, the
    first in (sample, root) order on ties; no refit.  The inliers are
    err <= sigma^2, sigma = max(2.5 * 1.4826 (1 + 5 / (n - 7))
    sqrt(score), 0.001).  A pair is valid with >= max(min_points, 8)
    points, a finite score and at least 7 inliers, as OpenCV then
    returns F.  A sample with no finite model scores nothing.

    Returns a dict of [P] tensors: F [P, 3, 3] f64 at unit Frobenius
    norm (F[2,2] >= 0 where run7Point could scale it to 1), valid, score
    (f32, inf without a model), best (the winner's index, sample * 3 +
    root), inliers [P, N], models (models scored) and no_model (samples
    without one)."""
    P, T, _ = samples.shape
    dev = x1.device
    n = n.to(dev)
    idx = samples.to(dev)[..., None]
    Fs, ok = fundamental_7point(torch.take_along_dim(x1[:, None], idx, -2),
                                torch.take_along_dim(x2[:, None], idx, -2))
    no_model = (~ok.any(-1)).sum(-1)
    Fs, ok = Fs.flatten(1, 2), ok.flatten(1)                  # [P,3T,..]
    models = ok.sum(-1)
    M = int(models.max()) if P else 0
    score = torch.full((P,), float("inf"), device=dev)
    best = torch.zeros(P, dtype=torch.int64, device=dev)
    if M:
        # the models with a root, in (sample, root) order, first
        order = torch.argsort((~ok).to(torch.int8), dim=-1,
                              stable=True)[:, :M]
        Fm = torch.take_along_dim(Fs, order[..., None, None], 1)
        scores = _upper_median(cv_epipolar_error(Fm, x1, x2), n)
        scores = torch.where(torch.arange(M, device=dev) < models[:, None],
                             scores, float("inf"))
        b = scores.argmin(-1, keepdim=True)
        score = scores.gather(1, b)[:, 0]
        best = order.gather(1, b)[:, 0]
    F, valid, inliers = lmeds_opencv_finish(
        Fs[torch.arange(P, device=dev), best], score, x1, x2, n, min_points)
    return dict(F=F, valid=valid, score=score, best=best, inliers=inliers,
                models=models, no_model=no_model)


def lmeds_opencv_finish(F: torch.Tensor, score: torch.Tensor,
                        x1: torch.Tensor, x2: torch.Tensor, n: torch.Tensor,
                        min_points: int = 10):
    """The last step of fundamental_lmeds_opencv, from each pair's winner
    F [P, 3, 3] and its score [P] (f32): the inliers [P, N] (err <=
    sigma^2 among the pair's n points), valid [P] and F at unit Frobenius
    norm."""
    dev = x1.device
    err = cv_epipolar_error(F[:, None], x1, x2)[:, 0]
    sigma = (2.5 * 1.4826 * (1.0 + 5.0 / (n - CV_MODEL_POINTS).clamp_min(1))
             * torch.sqrt(score.double())).clamp_min(0.001)
    inliers = ((err <= (sigma * sigma).float()[:, None])
               & (torch.arange(x1.shape[1], device=dev) < n[:, None]))
    valid = ((n >= max(min_points, CV_MODEL_POINTS + 1))
             & torch.isfinite(score) & (inliers.sum(-1) >= CV_MODEL_POINTS))
    F = F / torch.linalg.matrix_norm(F, keepdim=True).clamp_min(1e-300)
    return F, valid, inliers
