"""Closed-form small-matrix linear algebra on torch tensors.

Port of edgegraph3d_tpu/ops/linalg3.py:

  * det3, adjugate3, inv3, solve3 on batched [..., 3, 3] tensors
    (Cramer / adjugate, with the same det_eps guard); the plain path of
    the BA point blocks (ops/ba.py), which kernel K8 computes per thread
    in the same closed forms;
  * the DLT part: the 4x4 Cholesky + inverse iteration of the DLT
    nullspace, on nested lists of batched scalars.  This is the plain
    path under kernel K3 (triangulation.triangulate_gn), which runs the
    same closed forms per thread in the same operation order.  The GN
    step's 3x3 Cramer solve is written out in
    triangulation.gauss_newton_soa.
"""

from __future__ import annotations

import math

import torch


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)


def _safe_det(det: torch.Tensor, det_eps: float) -> torch.Tensor:
    """det, with |det| < det_eps replaced by +-det_eps (sign of det)."""
    tiny = torch.where(det < 0, -det_eps, det_eps).to(det.dtype)
    return torch.where(det.abs() < det_eps, tiny, det)


def inv3(A: torch.Tensor, det_eps: float = 1e-20) -> torch.Tensor:
    """Inverse of [..., 3, 3] via adjugate / det."""
    return adjugate3(A) / _safe_det(det3(A), det_eps)[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor, det_eps: float = 1e-20):
    """Solve A x = b for [..., 3, 3] x [..., 3] -> ([..., 3], det)."""
    det = det3(A)
    adj = adjugate3(A)
    x = (adj * b[..., None, :]).sum(-1) / _safe_det(det, det_eps)[..., None]
    return x, det


def cholesky4(a, eps: float = 1e-30):
    """Closed-form Cholesky of an SPD 4x4 given as a nested list `a` of
    batched scalars (upper triangle used) -> the 10 lower entries."""
    sq = lambda x: torch.sqrt(torch.clamp_min(x, eps))
    L11 = sq(a[0][0])
    L21 = a[0][1] / L11
    L31 = a[0][2] / L11
    L41 = a[0][3] / L11
    L22 = sq(a[1][1] - L21 * L21)
    L32 = (a[1][2] - L31 * L21) / L22
    L42 = (a[1][3] - L41 * L21) / L22
    L33 = sq(a[2][2] - L31 * L31 - L32 * L32)
    L43 = (a[2][3] - L41 * L31 - L42 * L32) / L33
    L44 = sq(a[3][3] - L41 * L41 - L42 * L42 - L43 * L43)
    return (L11, L21, L31, L41, L22, L32, L42, L33, L43, L44)


def cho_solve4(L, b):
    """Solve A x = b given cholesky4 factors; b is a list of 4 batched
    scalars.  Returns the list x."""
    L11, L21, L31, L41, L22, L32, L42, L33, L43, L44 = L
    y1 = b[0] / L11
    y2 = (b[1] - L21 * y1) / L22
    y3 = (b[2] - L31 * y1 - L32 * y2) / L33
    y4 = (b[3] - L41 * y1 - L42 * y2 - L43 * y3) / L44
    x4 = y4 / L44
    x3 = (y3 - L43 * x4) / L33
    x2 = (y2 - L32 * x3 - L42 * x4) / L22
    x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11
    return [x1, x2, x3, x4]


def smallest_eigvec4(a, n_iters: int = 4):
    """Eigenvector of the smallest eigenvalue of a symmetric PSD 4x4
    (nested list of batched scalars, upper triangle): ridged inverse
    iteration x <- (A + eps I)^-1 x from (1, 1, 1, 1.5) / |.|.
    Returns the list of 4 components."""
    a = [list(r) for r in a]
    tr = a[0][0] + a[1][1] + a[2][2] + a[3][3]
    eps = 1e-7 * tr + 1e-30
    for i in range(4):
        a[i][i] = a[i][i] + eps
    L = cholesky4(a)
    nv = math.sqrt(1.0 + 1.0 + 1.0 + 1.5 ** 2)
    v = [torch.full_like(tr, c / nv) for c in (1.0, 1.0, 1.0, 1.5)]
    for _ in range(n_iters):
        x = cho_solve4(L, v)
        n = torch.clamp_min(torch.sqrt(x[0] * x[0] + x[1] * x[1]
                                       + x[2] * x[2] + x[3] * x[3]), 1e-30)
        v = [xi / n for xi in x]
    return v
