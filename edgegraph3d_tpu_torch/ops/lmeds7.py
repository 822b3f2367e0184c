"""OpenCV's FM_LMEDS for many view pairs at once: kernel K9 `lmeds7_fit`.

The card's route of ops.geometry.fundamental_lmeds_opencv, which stays
its plain twin and the route of tensors on the CPU.  One C entry
(csrc/lmeds7_fit.cu) launches two kernels: the 7-point models of every
(pair, sample), then each pair's winner, the least (upper median, model
index), and the plain twin's last step (geometry.lmeds_opencv_finish:
inliers, valid, unit F) on it, with no [pairs, models, points] tensor
and nothing read back.

The scoring launch gives each pair one block, which stages the pair's
points in shared memory where the largest pair fits the card's opt-in
limit, else reads them from device memory (`placement`).
"""

from __future__ import annotations

import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops.geometry import (CV_MODEL_POINTS,
                                                fundamental_lmeds_opencv)

#: warps of a scoring block, each scoring one model at a time; digits of
#: a radix pass of its exact selection (csrc/lmeds7_fit.cu)
WARPS, BINS = 8, 256
#: shared bytes of a scoring block besides its points, at most: the
#: warps' histograms, then 64 B for its best key and block sums
STATIC_SMEM_BYTES = WARPS * BINS * 4 + 64
#: shared bytes a staged point (x1, y1, x2, y2 in f32)
POINT_BYTES = 16


def smem_bytes(n_stage: int) -> int:
    """Shared bytes of a scoring block that stages n_stage points."""
    return STATIC_SMEM_BYTES + POINT_BYTES * n_stage


def placement(n_stage: int, optin_bytes: int) -> str:
    """Where K9's scoring blocks keep the points of pairs of up to
    n_stage points (kernels.PLACEMENTS): in shared memory where a block
    of them fits (kernels.table_placement), else in device memory."""
    return kernels.table_placement(smem_bytes(n_stage), optin_bytes)


def lmeds7_fit(x1: torch.Tensor, x2: torch.Tensor, n, samples: torch.Tensor,
               min_points: int = 10) -> dict:
    """Kernel K9: fundamental_lmeds_opencv's outputs for P pairs.

    x1, x2 [P, N, 2] f32 (each pair's common points first), n [P] (on
    the host; 1 <= n <= N) and samples [P, T, 7] positions among them,
    as the plain twin takes them; on the CPU it is the plain twin.  On
    the card P and T must be at least 1, and nothing is synchronised or
    read back.  The card finds the models by another basis of each
    sample's null space than the twin's SVD, so F and the scores agree to
    rounding and a sample's roots may come in another order (`best` %
    3)."""
    if x1.device.type == "cpu":
        return fundamental_lmeds_opencv(x1, x2, torch.as_tensor(n), samples,
                                        min_points)
    dev = x1.device
    P, N, _ = x1.shape
    T = samples.shape[1]
    n_host = torch.as_tensor(n, dtype=torch.int64).cpu()
    if P == 0 or T == 0 or int(n_host.min()) < 1 or int(n_host.max()) > N:
        raise ValueError(f"lmeds7_fit: {P} pairs, {T} samples, n outside "
                         f"[1, {N}]")
    x1, x2 = x1.contiguous(), x2.contiguous()
    kernels.require(x1, "x1", torch.float32, (P, N, 2))
    kernels.require(x2, "x2", torch.float32, (P, N, 2))
    samples = samples.to(dev, torch.int64).contiguous()
    kernels.require(samples, "samples", torch.int64, (P, T, 7))
    n = n_host.to(dev, non_blocking=True)
    n_stage = int(n_host.max())
    place = placement(n_stage, kernels.smem_optin_bytes(dev))
    empty = lambda *shape, dtype: torch.empty(shape, dtype=dtype, device=dev)
    models = empty(P, 3 * T, 9, dtype=torch.float64)
    ok = empty(P, 3 * T, dtype=torch.uint8)
    counts = empty(P, 2, dtype=torch.int64)
    out = dict(F=empty(P, 3, 3, dtype=torch.float64),
               score=empty(P, dtype=torch.float32),
               best=empty(P, dtype=torch.int64),
               valid=empty(P, dtype=torch.uint8),
               inliers=empty(P, N, dtype=torch.uint8))
    kernels.LAST_PLACEMENT["lmeds7_fit"] = place
    with kernels.on_device(x1):
        rc = kernels.lib().eg3d_lmeds7_fit(
            x1.data_ptr(), x2.data_ptr(), N, n_stage, samples.data_ptr(),
            n.data_ptr(), P, T, kernels.PLACEMENTS.index(place),
            max(min_points, CV_MODEL_POINTS + 1), models.data_ptr(),
            ok.data_ptr(), counts.data_ptr(),
            *(v.data_ptr() for v in out.values()), kernels.stream_of(x1))
    kernels.check(rc, "lmeds7_fit")
    kernels.count_launch("lmeds7_fit", torch.float64)
    for k in ("valid", "inliers"):
        out[k] = out[k].view(torch.bool)
    return dict(out, models=counts[:, 0], no_model=counts[:, 1])
