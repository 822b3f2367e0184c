"""Joint bundle adjustment over edge-point reprojection residuals.

Port of edgegraph3d_tpu/ops/ba.py: a joint Levenberg-Marquardt step over
camera poses AND points (intrinsics fixed), solved by Schur-complement
reduction:

    H = [[Hcc, Hcx], [Hxc, Hxx]]    g = [gc, gx]
    S   = Hcc - sum_i Hcx_i Hxx_i^-1 Hxc_i        (6V x 6V, dense)
    rhs = gc  - sum_i Hcx_i Hxx_i^-1 gx_i
    solve S dc = rhs  ->  dx_i = Hxx_i^-1 (gx_i - Hxc_i dc)

Poses take a left-multiplicative se(3) perturbation (w, u):
p = exp(w) (R X + t) + u.  Two things of the JAX version are dropped
and the math kept:

  * `jax.jacfwd` through exp_so3: the Jacobians are written out.  At
    dpose = 0, with p = R X + t: dp/dw = -[p]x, dp/du = I, dp/dX = R,
    and the GN Jacobian J = d proj / d theta (the JAX code negates the
    Jacobian of the residual xy - proj).  Where |p_z| < 1e-9 the depth
    is the constant 1e-9, so proj does not depend on p_z through it.
  * the one-hot einsums: per-view blocks are scattered by camera with
    `index_add_`, and the per-point camera blocks go straight into dense
    layouts that one `torch.matmul` reads: B [N, 3, V, 6] (Hxc summed per
    (point, view); duplicate cameras in a row add, as the one-hot sum
    does) and A [V, 6, N, 3] (A[:, :, n] = B[n]^T Hxx_n^-1), so that
    S = diag(Hcc) - A.view(6V, 3N) @ B.view(3N, 6V).

`ba_blocks` computes every per-point and per-view piece of one step:
kernel K8 (csrc/ba_blocks.cu) for tensors on the card, else its plain
version `_ba_blocks_plain` (built on `ba_build_blocks`).  K8's per-view
sums walk `observation_index`, which `ba_run` builds once.  The product
for S and the 6V x 6V solve are plain `torch.matmul` and
`torch.linalg.solve`, as the JAX package leaves them to XLA.  Sums run in
another order than JAX's einsums (and K8's than the plain version's), so
results agree to f32 tolerance, never bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops.linalg3 import inv3


class BAState(NamedTuple):
    K: torch.Tensor        # [V,3,3] intrinsics (fixed)
    R: torch.Tensor        # [V,3,3] world->cam rotations
    t: torch.Tensor        # [V,3]
    X: torch.Tensor        # [N,3] points


class BABlocks(NamedTuple):
    """The per-point and per-view pieces of one LM step (K8's outputs)."""
    Hxx_inv: torch.Tensor  # [N,3,3] damped point blocks, inverted
    gx: torch.Tensor       # [N,3]
    B: torch.Tensor        # [N,3,V,6] Hxc summed per (point, view)
    A: torch.Tensor        # [V,6,N,3] B[n]^T Hxx_inv[n]
    Hcc: torch.Tensor      # [V,6,6]
    gc: torch.Tensor       # [V,6]
    rhs: torch.Tensor      # [V,6] gc - sum_n A[:, :, n] gx[n]
    resid_sq: torch.Tensor  # [] sum of squared masked residuals
    n_obs: torch.Tensor    # [] int64 count of masked observations


def _hat(w: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3].  The sin / cos coefficients
    switch to their Taylor series for th^2 < 1e-8, with the square root
    guarded, so w = 0 (where BA linearizes) has exact derivatives."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def _residual_one(K, R, t, dpose, X, xy_obs):
    """Residual xy - proj of observations under the pose perturbation
    dpose = (w, u) (any leading batch shape; the function JAX
    differentiates with jacfwd)."""
    w, u = dpose[..., :3], dpose[..., 3:]
    q = (R @ X[..., None])[..., 0] + t
    p = (exp_so3(w) @ q[..., None])[..., 0] + u
    z = torch.where(p[..., 2].abs() < 1e-9, 1e-9, p[..., 2])
    proj = (K @ (p / z[..., None])[..., None])[..., 0][..., :2]
    return xy_obs - proj


def _residual_jacobians(K, R, t, X, xy_obs):
    """(r [..., 2], Jc [..., 2, 6], Jx [..., 2, 3]) at dpose = 0, with
    the GN Jacobians J = d proj / d(w, u) and d proj / dX written out in
    the closed forms kernel K8 uses per observation."""
    p = [R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1]
         + R[..., i, 2] * X[..., 2] + t[..., i] for i in range(3)]
    small = p[2].abs() < 1e-9
    z = torch.where(small, 1e-9, p[2])
    pz = [p[0] / z, p[1] / z, p[2] / z]
    a = 1.0 / z
    r, jc, jx = [], [], []
    for i in range(2):
        proj = (K[..., i, 0] * pz[0] + K[..., i, 1] * pz[1]
                + K[..., i, 2] * pz[2])
        r.append(xy_obs[..., i] - proj)
        d = [K[..., i, 0] * a, K[..., i, 1] * a,
             torch.where(small, K[..., i, 2], K[..., i, 2] - proj) * a]
        jc.append(torch.stack([p[1] * d[2] - p[2] * d[1],
                               p[2] * d[0] - p[0] * d[2],
                               p[0] * d[1] - p[1] * d[0], *d], dim=-1))
        jx.append(torch.stack([R[..., 0, j] * d[0] + R[..., 1, j] * d[1]
                               + R[..., 2, j] * d[2] for j in range(3)],
                              dim=-1))
    return (torch.stack(r, dim=-1), torch.stack(jc, dim=-2),
            torch.stack(jx, dim=-2))


def _gather_observations(state: BAState, obs_cam, obs_xy):
    N, O = obs_cam.shape
    cam = obs_cam.clamp_min(0).long()
    return (state.K[cam], state.R[cam], state.t[cam],
            state.X[:, None, :].expand(N, O, 3), obs_xy, cam)


def ba_build_blocks(state: BAState, obs_cam, obs_xy, obs_mask):
    """Per-observation normal-equation blocks (plain torch).

    obs_cam [N,O] int, obs_xy [N,O,2], obs_mask [N,O] bool.  Returns
    (r [N,O,2], Hxx [N,3,3], gx [N,3], Hxc [N,O,3,6], Hcc [V,6,6],
    gc [V,6]); masked-out observations contribute exact zeros."""
    V = state.K.shape[0]
    K, R, t, X, xy, cam = _gather_observations(state, obs_cam, obs_xy)
    r, Jc, Jx = _residual_jacobians(K, R, t, X, xy)
    m = obs_mask[..., None]
    r = torch.where(m, r, 0.0)
    Jc = torch.where(m[..., None], Jc, 0.0)
    Jx = torch.where(m[..., None], Jx, 0.0)
    Hxx = torch.einsum("noki,nokj->nij", Jx, Jx)
    gx = torch.einsum("noki,nok->ni", Jx, r)
    Hxc = torch.einsum("noki,nokj->noij", Jx, Jc)
    Hcc_o = torch.einsum("noki,nokj->noij", Jc, Jc)
    gc_o = torch.einsum("noki,nok->noi", Jc, r)
    flat = cam.reshape(-1)
    Hcc = torch.zeros((V, 6, 6), dtype=Hcc_o.dtype, device=Hcc_o.device)
    Hcc.index_add_(0, flat, Hcc_o.reshape(-1, 6, 6))
    gc = torch.zeros((V, 6), dtype=gc_o.dtype, device=gc_o.device)
    gc.index_add_(0, flat, gc_o.reshape(-1, 6))
    return r, Hxx, gx, Hxc, Hcc, gc


def _damped_inverse(Hxx: torch.Tensor, damping: float) -> torch.Tensor:
    """inv3 of Hxx with LM relative damping and a small absolute guard
    (for padding rows): Hxx + damping diag(Hxx) + 1e-8 I."""
    eye3 = torch.eye(3, dtype=Hxx.dtype, device=Hxx.device)
    diag = torch.diagonal(Hxx, dim1=-2, dim2=-1)
    return inv3(Hxx + damping * diag[..., None] * eye3 + 1e-8 * eye3)


def _ba_blocks_plain(state: BAState, obs_cam, obs_xy, obs_mask,
                     damping: float = 1e-4) -> BABlocks:
    """Plain version of kernel K8."""
    V = state.K.shape[0]
    N, O = obs_cam.shape
    r, Hxx, gx, Hxc, Hcc, gc = ba_build_blocks(state, obs_cam, obs_xy,
                                               obs_mask)
    Hxx_inv = _damped_inverse(Hxx, damping)
    cam = obs_cam.clamp_min(0).long()
    row = torch.arange(N, device=cam.device)[:, None] * V + cam
    B = torch.zeros((N * V, 3, 6), dtype=Hxc.dtype, device=Hxc.device)
    B.index_add_(0, row.reshape(-1), Hxc.reshape(-1, 3, 6))
    B = B.view(N, V, 3, 6)
    A = torch.einsum("nvji,njk->nvik", B, Hxx_inv)          # [N,V,6,3]
    rhs = gc - torch.einsum("nvik,nk->vi", A, gx)
    return BABlocks(
        Hxx_inv=Hxx_inv, gx=gx,
        B=B.permute(0, 2, 1, 3).contiguous(),
        A=A.permute(1, 2, 0, 3).contiguous(), Hcc=Hcc, gc=gc, rhs=rhs,
        resid_sq=(r * r).sum(), n_obs=obs_mask.sum())


#: K8's launch geometry (csrc/ba_blocks.cu): points a block of the point
#: kernel, observations a block of the view sums, sums a view partial
BA_POINT_WARPS = 8
BA_VIEW_OBS = 1024
BA_SUMS = 34


def ba_table_bytes(V: int) -> int:
    """Shared memory of a block of K8's point kernel with its tables
    there: the camera table (21 floats a camera), the staged A rows of
    its BA_POINT_WARPS points ([V * 6] rows of 3 floats a point, padded
    by one) and its warps' slot masks (csrc/ba_blocks.cu shared_bytes)."""
    return (V * (21 + 6 * (3 * BA_POINT_WARPS + 1)) * 4
            + BA_POINT_WARPS * 32 * 4)


class BAIndex(NamedTuple):
    """The view-major observation index of K8's view sums."""
    slot: torch.Tensor     # [n_obs] int32 n * O + o, by camera, (n, o) order
    start: torch.Tensor    # [V + 1] int32, view v's slots at start[v]:start[v+1]
    first: torch.Tensor    # [n_obs] bool, the first slot of its (n, v) pair
    max_count: int         # the most observations of one view


def observation_index(obs_cam, obs_mask, V: int) -> BAIndex:
    """The present slots of obs_mask [N, O] sorted stably by camera
    (obs_cam [N, O] clamped at 0, as everywhere in BA), with a flag on
    the first slot of each distinct (point, view) pair, so that a pair's
    term A_vn gx_n counts once however many slots repeat its camera.  It
    depends on the observations only, so `ba_run` builds it once for
    all its steps.  Integer torch ops on the observations' device, read
    back twice (the count of present slots; the largest view and the
    camera range).  A camera >= V raises."""
    N, O = obs_cam.shape
    if N * O >= 2 ** 31:
        raise ValueError(f"ba index: {N} x {O} slots do not fit int32")
    slot = torch.nonzero(obs_mask.reshape(-1)).reshape(-1)
    cam = obs_cam.reshape(-1)[slot].to(torch.int32).clamp_min(0)
    cam, order = torch.sort(cam, stable=True)
    slot = slot[order]
    first = torch.ones(slot.shape, dtype=torch.bool, device=slot.device)
    if slot.numel() > 1:
        n = slot // O
        first[1:] = (cam[1:] != cam[:-1]) | (n[1:] != n[:-1])
    start = torch.searchsorted(
        cam, torch.arange(V + 1, dtype=torch.int32, device=cam.device)
    ).to(torch.int32)
    largest, in_range = (torch.stack([(start[1:] - start[:-1]).max(),
                                      start[V]]).tolist()
                         if V else (0, 0))
    if in_range != slot.numel():
        raise ValueError(f"ba index: a camera index is >= V = {V}")
    return BAIndex(slot=slot.to(torch.int32), start=start, first=first,
                   max_count=largest)


def _view_partials(index: BAIndex, V: int, device) -> torch.Tensor:
    """K8's scratch for the view sums: [V, chunks, BA_SUMS], chunks of
    BA_VIEW_OBS observations covering the largest view."""
    chunks = max(1, -(-index.max_count // BA_VIEW_OBS))
    return torch.empty((V, chunks, BA_SUMS), dtype=torch.float32,
                       device=device)


def _ba_blocks_launch(state: BAState, obs_cam, obs_xy, obs_mask,
                      damping: float, index: BAIndex, out: BABlocks,
                      partial: torch.Tensor) -> None:
    """K8's C entry into the outputs `out` and the scratch `partial`
    [V, chunks, BA_SUMS]; raises if the launch fails.  Counts nothing."""
    K, R, t, X = state
    V = K.shape[0]
    N, O = obs_cam.shape
    place = kernels.place("ba_blocks", ba_table_bytes(V), X.device)
    rc = kernels.lib().eg3d_ba_blocks(
        K.data_ptr(), R.data_ptr(), t.data_ptr(), V, X.data_ptr(),
        obs_cam.data_ptr(), obs_xy.data_ptr(), obs_mask.data_ptr(), N, O,
        float(damping), index.slot.data_ptr(), index.start.data_ptr(),
        index.first.data_ptr(), index.max_count, partial.shape[1], place,
        out.Hxx_inv.data_ptr(), out.gx.data_ptr(), out.B.data_ptr(),
        out.A.data_ptr(), partial.data_ptr(), out.Hcc.data_ptr(),
        out.gc.data_ptr(), out.rhs.data_ptr(), out.resid_sq.data_ptr(),
        out.n_obs.data_ptr(), kernels.stream_of(X))
    kernels.check(rc, "ba_blocks")


def ba_blocks(state: BAState, obs_cam, obs_xy, obs_mask,
              damping: float = 1e-4, index: BAIndex | None = None
              ) -> BABlocks:
    """Kernel K8: every per-point and per-view piece of one LM step.

    state on one device (f32); obs_cam [N,O] int32 (clamped at 0),
    obs_xy [N,O,2] f32, obs_mask [N,O] bool; `index` the observations'
    `observation_index` (built here when None).  On the CPU this is the
    plain version; on the card it launches K8 (a warp per point for
    Hxx^-1, gx, B and A; blocks over chunks of each view's observations
    for Hcc, gc, rhs and the residual sum, summed in a fixed order).
    There is no fallback: a failed build or launch raises."""
    if state.X.device.type == "cpu":
        return _ba_blocks_plain(state, obs_cam, obs_xy, obs_mask, damping)
    state = BAState(*(a.contiguous() for a in state))
    V = state.K.shape[0]
    N, O = obs_cam.shape
    obs_cam = obs_cam.to(torch.int32).contiguous()
    obs_xy = obs_xy.contiguous()
    obs_mask = obs_mask.contiguous()
    if index is None:
        index = observation_index(obs_cam, obs_mask, V)
    n_idx = index.slot.shape[0]
    for name, a, dt, shape in (
            ("K", state.K, torch.float32, (V, 3, 3)),
            ("R", state.R, torch.float32, (V, 3, 3)),
            ("t", state.t, torch.float32, (V, 3)),
            ("X", state.X, torch.float32, (N, 3)),
            ("obs_cam", obs_cam, torch.int32, (N, O)),
            ("obs_xy", obs_xy, torch.float32, (N, O, 2)),
            ("obs_mask", obs_mask, torch.bool, (N, O)),
            ("index.slot", index.slot, torch.int32, (n_idx,)),
            ("index.start", index.start, torch.int32, (V + 1,)),
            ("index.first", index.first, torch.bool, (n_idx,))):
        kernels.require(a, name, dt, shape)
    dev = state.X.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = BABlocks(
        Hxx_inv=torch.empty((N, 3, 3), **f32),
        gx=torch.empty((N, 3), **f32),
        B=torch.empty((N, 3, V, 6), **f32),
        A=torch.empty((V, 6, N, 3), **f32),
        Hcc=torch.empty((V, 6, 6), **f32), gc=torch.empty((V, 6), **f32),
        rhs=torch.empty((V, 6), **f32), resid_sq=torch.empty((), **f32),
        n_obs=torch.empty((), dtype=torch.int64, device=dev))
    _ba_blocks_launch(state, obs_cam, obs_xy, obs_mask, damping, index, out,
                      _view_partials(index, V, dev))
    kernels.LAUNCHES["ba_blocks"] += 1
    return out


def schur_complement(blocks: BABlocks) -> torch.Tensor:
    """S [6V, 6V] (rows and columns in (view, pose component) order):
    the per-view Hcc on the diagonal blocks minus the one product
    A.view(6V, 3N) @ B.view(3N, 6V)."""
    V6, N = blocks.A.shape[0] * 6, blocks.A.shape[2]
    V = V6 // 6
    S = -torch.matmul(blocks.A.reshape(V6, 3 * N),
                      blocks.B.reshape(3 * N, V6))
    idx = torch.arange(V, device=S.device)
    Sv = S.view(V, 6, V, 6)
    Sv[idx, :, idx, :] += blocks.Hcc
    return S


def ba_schur_local(state: BAState, obs_cam, obs_xy, obs_mask,
                   damping: float = 1e-4, index: BAIndex | None = None):
    """(S [6V,6V], blocks): the Schur system of one step and the pieces
    the back-substitution reads."""
    blocks = ba_blocks(state, obs_cam, obs_xy, obs_mask, damping, index)
    return schur_complement(blocks), blocks


def ba_apply(state: BAState, S: torch.Tensor, blocks: BABlocks,
             damping: float = 1e-4, fix_first_camera: bool = True):
    """Solve the camera system and update the state.  The 6V system is
    ill-conditioned in f32 (rotation blocks ~ (f X)^2 against translation
    blocks ~ f^2): relative damping, camera 0 clamped as the gauge and a
    Jacobi preconditioner, as in the JAX package.  Returns
    (new state, dc [V,6], dx [N,3])."""
    V = state.K.shape[0]
    N = state.X.shape[0]
    n = 6 * V
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    rhs = blocks.rhs.reshape(n)
    S = S + (damping * torch.diagonal(S) + 1e-12) * eye
    if fix_first_camera:
        free = torch.arange(n, device=S.device) >= 6
        S = torch.where(free[:, None] & free[None, :], S, eye)
        rhs = torch.where(free, rhs, 0.0)
    precond = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-12))
    S_p = S * precond[:, None] * precond[None, :]
    dc = (torch.linalg.solve(S_p, rhs * precond) * precond).reshape(V, 6)

    # point updates: dx = Hxx^-1 (gx - Hxc dc)
    corr = torch.matmul(blocks.B.reshape(3 * N, n),
                        dc.reshape(n)).reshape(N, 3)
    dx = torch.matmul(blocks.Hxx_inv, (blocks.gx - corr)[..., None])[..., 0]

    # p' = exp(w)(R X + t) + u  ->  R' = exp(w) R, t' = exp(w) t + u
    dR = exp_so3(dc[:, :3])
    R_new = dR @ state.R
    t_new = (dR @ state.t[..., None])[..., 0] + dc[:, 3:]
    return BAState(K=state.K, R=R_new, t=t_new, X=state.X + dx), dc, dx


def ba_step_single(state: BAState, obs_cam, obs_xy, obs_mask,
                   damping: float = 1e-4, index: BAIndex | None = None):
    """One LM step; returns (new state, mse at the linearization point)
    with the mse left on the device."""
    S, blocks = ba_schur_local(state, obs_cam, obs_xy, obs_mask, damping,
                               index)
    new_state, _, _ = ba_apply(state, S, blocks, damping)
    return new_state, blocks.resid_sq / blocks.n_obs.clamp_min(1)


def ba_run(state: BAState, obs_cam, obs_xy, obs_mask, n_steps: int,
           damping: float = 1e-4):
    """n_steps LM steps.  Returns (final state, per-step mse [n_steps] on
    the state's device: each the mean squared residual AT the
    linearization point of its step, so mses[0] is the pre-BA error).
    The observation index is built once, before the first step; nothing
    else is read back to the host."""
    mses = []
    index = observation_index(obs_cam, obs_mask, state.K.shape[0])
    for _ in range(n_steps):
        state, mse = ba_step_single(state, obs_cam, obs_xy, obs_mask,
                                    damping, index)
        mses.append(mse)
    if not mses:
        return state, torch.zeros(0, dtype=state.X.dtype,
                                  device=state.X.device)
    return state, torch.stack(mses)


def ba_mse(state: BAState, obs_cam, obs_xy, obs_mask) -> torch.Tensor:
    """Mean squared pixel residual of the current state (on the device)."""
    K, R, t, X, xy, _ = _gather_observations(state, obs_cam, obs_xy)
    r, _, _ = _residual_jacobians(K, R, t, X, xy)
    r = torch.where(obs_mask[..., None], r, 0.0)
    return (r * r).sum() / obs_mask.sum().clamp_min(1)
