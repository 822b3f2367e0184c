"""Plain reference of OpenCV's FM_LMEDS fundamental-matrix fit
(cv::findFundamentalMat(x1, x2, FM_LMEDS) with OpenCV's defaults), for
the F table of configurations with fmat_source="opencv_lmeds".

Given a pair's common points and the same 7-point samples the program
drew, it fits the pair as OpenCV's LMeDSPointSetRegistrator does with
the FMEstimatorCallback, written out plainly:

- each sample (fundam.cpp run7Point): Hartley normalisation of both
  point sets, the null space of the 7x9 system by `torch.linalg.svd` in
  float64, the cubic det(lambda F1 + (1 - lambda) F2) = 0 interpolated
  from its values at four lambdas, its real roots by `numpy.roots`'s
  method (the eigenvalues of the companion matrix; `numpy.roots` itself
  where the leading coefficient is 0), one model per real root;
- each model's error (FMEstimatorCallback::computeError): the larger of
  the squared distances of x2 to the line F x1 and of x1 to the line
  F^T x2, each formed on its own in float64, stored as float32;
- the score: the element n // 2 of the sorted errors (nth_element at
  count / 2); the least score wins, the first in (sample, root) order.

It works pair by pair, so that it fits on the card at full size, with
TF32 off.  Imports torch and numpy only: nothing of the program, nor of
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

#: the lambdas at which the cubic is sampled
LAMBDAS = np.array([-1.0, 0.0, 1.0, 2.0])


def _normalise(x: torch.Tensor):
    """x [S, 7, 2] f64 -> (normalised points, T [S, 3, 3]): centroid at
    the origin, mean distance sqrt(2)."""
    c = x.mean(1, keepdim=True)
    s = np.sqrt(2.0) / torch.linalg.vector_norm(x - c, dim=-1).mean(1)
    T = torch.zeros((len(x), 3, 3), dtype=x.dtype, device=x.device)
    T[:, 0, 0] = T[:, 1, 1] = s
    T[:, 0, 2] = -s * c[:, 0, 0]
    T[:, 1, 2] = -s * c[:, 0, 1]
    T[:, 2, 2] = 1.0
    return (x - c) * s[:, None, None], T


def _real_roots(coeffs: np.ndarray):
    """Real roots of cubics [S, 4] (highest power first): (the cubic of
    each root, the roots), in cubic order."""
    lead = coeffs[:, 0] != 0
    comp = np.zeros((len(coeffs), 3, 3))
    comp[:, 0, :] = -coeffs[:, 1:] / np.where(lead, coeffs[:, 0], 1.0)[:, None]
    comp[:, 1, 0] = comp[:, 2, 1] = 1.0
    eig = np.linalg.eigvals(comp)
    owner, col = np.nonzero((np.imag(eig) == 0) & lead[:, None])
    roots = np.real(eig[owner, col])
    for k in np.flatnonzero(~lead):
        r = np.roots(coeffs[k])
        r = np.real(r[np.imag(r) == 0])
        owner = np.append(owner, [k] * len(r))
        roots = np.append(roots, r)
    at = np.argsort(owner, kind="stable")
    return owner[at].astype(np.int64), roots[at]


def seven_point_models(x1: torch.Tensor, x2: torch.Tensor):
    """Models of 7-point samples x1, x2 [S, 7, 2]: (F [M, 3, 3] f64, the
    sample of each model [M])."""
    u, T1 = _normalise(x1.double())
    v, T2 = _normalise(x2.double())
    A = torch.stack([v[..., 0] * u[..., 0], v[..., 0] * u[..., 1], v[..., 0],
                     v[..., 1] * u[..., 0], v[..., 1] * u[..., 1], v[..., 1],
                     u[..., 0], u[..., 1], torch.ones_like(u[..., 0])], -1)
    Vh = torch.linalg.svd(A, full_matrices=True).Vh
    F1, F2 = Vh[:, 7].reshape(-1, 3, 3), Vh[:, 8].reshape(-1, 3, 3)
    lam = torch.as_tensor(LAMBDAS, device=F1.device)[None, :, None, None]
    dets = torch.linalg.det(lam * F1[:, None] + (1 - lam) * F2[:, None])
    coeffs = np.linalg.solve(np.vander(LAMBDAS, 4),
                             dets.cpu().numpy().T).T              # [S,4]
    owner, roots = _real_roots(coeffs)
    o = torch.as_tensor(owner, device=F1.device)
    r = torch.as_tensor(roots, device=F1.device)[:, None, None]
    F = T2[o].transpose(1, 2) @ (r * F1[o] + (1 - r) * F2[o]) @ T1[o]
    f22 = F[:, 2:, 2:]
    F = torch.where(f22.abs() > np.finfo(np.float32).eps, F / f22, F)
    keep = torch.isfinite(F).all(-1).all(-1)
    return F[keep], owner[keep.cpu().numpy()]


def opencv_error(F: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> torch.Tensor:
    """FMEstimatorCallback::computeError of models F [M, 3, 3] on points
    x1, x2 [n, 2]: [M, n] f32."""
    F = F.double()[:, None]
    x, y = x1.double()[None, :, 0], x1.double()[None, :, 1]
    u, v = x2.double()[None, :, 0], x2.double()[None, :, 1]
    a = F[..., 0, 0] * x + F[..., 0, 1] * y + F[..., 0, 2]
    b = F[..., 1, 0] * x + F[..., 1, 1] * y + F[..., 1, 2]
    c = F[..., 2, 0] * x + F[..., 2, 1] * y + F[..., 2, 2]
    d2 = (u * a + v * b + c) ** 2 / (a * a + b * b)
    a = F[..., 0, 0] * u + F[..., 1, 0] * v + F[..., 2, 0]
    b = F[..., 0, 1] * u + F[..., 1, 1] * v + F[..., 2, 1]
    c = F[..., 0, 2] * u + F[..., 1, 2] * v + F[..., 2, 2]
    d1 = (x * a + y * b + c) ** 2 / (a * a + b * b)
    err = torch.maximum(d1, d2).float()
    return torch.where(err.isnan(), float("inf"), err)


def upper_median(err: torch.Tensor) -> torch.Tensor:
    """Element n // 2 of each row of err [M, n] sorted."""
    return torch.sort(err, dim=-1).values[:, err.shape[1] // 2]


def fit_pair(x1, x2, samples, device="cpu") -> dict:
    """One pair: x1, x2 [n, 2] its common points, samples [T, 7]
    positions among them.  Returns F (unit Frobenius norm, F[2,2] >= 0
    where the model was scaled to F[2,2] = 1), score, sample (the
    winner's) and models (models scored)."""
    x1 = torch.as_tensor(x1, device=device)
    x2 = torch.as_tensor(x2, device=device)
    s = torch.as_tensor(samples, device=device)
    F, owner = seven_point_models(x1[s], x2[s])
    if len(F) == 0:
        return dict(F=None, score=float("inf"), sample=-1, models=0)
    scores = upper_median(opencv_error(F, x1, x2))
    k = int(torch.argmin(scores))
    Fk = F[k] / torch.linalg.matrix_norm(F[k])
    return dict(F=Fk.cpu().numpy(), score=float(scores[k]),
                sample=int(owner[k]), models=len(F))


def fit_pairs(pairs_points, samples, device="cpu") -> list:
    """`fit_pair` over pairs: pairs_points yields (x1, x2) per pair,
    samples [P, T, 7].  Sets TF32 off for the run on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [fit_pair(x1, x2, samples[p], device)
            for p, (x1, x2) in enumerate(pairs_points)]
