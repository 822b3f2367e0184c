"""Multi-view geometry on torch tensors (projection, F table, epipolar
lines).  Port of edgegraph3d_tpu/ops/geometry.py.

Contractions are written out as elementwise products summed left to
right — the order the hand kernels use — so the plain path and the CUDA
kernels round identically.  LMedS F estimation is not ported yet
(ROADMAP queue A item 9).
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
    tiny = torch.where(z < 0, -1e-12, 1e-12).to(z.dtype)
    return torch.where(z.abs() < 1e-12, tiny, z)


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


def all_fundamental_matrices(P, centers) -> torch.Tensor:
    """All-pairs F table [V, V, 3, 3]; F[i, j] maps view-i points to
    view-j lines: F = [e_j]_x P_j P_i^+ with e_j = P_j [C_i; 1],
    Frobenius-normalized.  Computed in float64 on the host (a 49-view
    table is 2401 tiny products) and returned as float32."""
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
    return torch.as_tensor(F, dtype=torch.float32)


def epipolar_line(F: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """l' = F [x; 1], scaled so a^2 + b^2 = 1
    (cv::computeCorrespondEpilines).  F [..., 3, 3], x [..., 2] -> [..., 3]."""
    px, py = x[..., 0], x[..., 1]
    l0, l1, l2 = [F[..., i, 0] * px + F[..., i, 1] * py + F[..., i, 2]
                  for i in range(3)]
    n = torch.clamp_min(torch.sqrt(l0 * l0 + l1 * l1), 1e-20)
    return torch.stack([l0 / n, l1 / n, l2 / n], dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding of the sum: the f64 product of two f32
    values is exact, so only the f64 sum rounds before the cast back."""
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
