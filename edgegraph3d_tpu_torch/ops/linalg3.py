"""Closed-form small-matrix linear algebra on torch tensors.

Port of the DLT part of edgegraph3d_tpu/ops/linalg3.py: the 4x4
Cholesky + inverse iteration of the DLT nullspace, on nested lists of
batched scalars.  This is the plain path under kernel K3
(triangulation.triangulate_gn), which runs the same closed forms per
thread in the same operation order.  The GN step's 3x3 Cramer solve is
written out in triangulation.gauss_newton_soa.
"""

from __future__ import annotations

import math

import torch


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
