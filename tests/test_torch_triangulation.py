"""Kernel K3 (plain twin on the CPU) against the JAX DLT + Gauss-Newton.

Seeded noisy observations of known points go through JAX
`triangulate_dlt` / `gauss_newton_batched` and the port's
`triangulate_gn` (cameras as an index into P_mats) at O = 2, 3 and 49,
with random masks, gross outliers, and warm and cold starts.
Tolerance: valid identical; X within 1e-4 relative (plus 1e-6 abs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.ops import triangulation as jt
from edgegraph3d_tpu_torch.ops import triangulation as tt


@pytest.fixture(scope="module")
def cams49():
    sfmd = synthetic.ring_cameras(49, width=1600, height_px=1200,
                                  focal=2200.0)
    return sfmd.P.astype(np.float32)


def _problem(P, N, O, seed, mask_p=0.8):
    rng = np.random.default_rng(seed)
    V = len(P)
    X = rng.uniform(-0.6, 0.6, (N, 3))
    cams = np.stack([rng.permutation(V)[:O] for _ in range(N)]) \
        .astype(np.int32)
    Pn = P.astype(np.float64)[cams]
    proj = np.einsum("noij,nj->noi", Pn,
                     np.concatenate([X, np.ones((N, 1))], 1))
    xy = proj[..., :2] / proj[..., 2:3] + rng.normal(0, 1.0, (N, O, 2))
    xy[rng.random(N) < 0.15, 0] += 30.0
    mask = rng.random((N, O)) < mask_p
    X0 = (X + rng.normal(0, 0.01, X.shape)).astype(np.float32)
    return cams, xy.astype(np.float32), mask, X0


def _jax(P, cams, xy, mask, X0, iters, accept):
    if cams.shape[1] > 8:
        # eager: compiling the 49-observation unrolled GN costs a minute
        with jax.disable_jit():
            return _jax_run(P, cams, xy, mask, X0, iters, accept)
    return _jax_run(P, cams, xy, mask, X0, iters, accept)


def _jax_run(P, cams, xy, mask, X0, iters, accept):
    Pg = jnp.asarray(P[cams])
    if X0 is None:
        X0 = jt.triangulate_dlt(Pg, jnp.asarray(xy), jnp.asarray(mask))
    X, mse, ok = jt.gauss_newton_batched(
        Pg, jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(X0),
        max_iters=iters, accept_mse=accept, epsilon=5e-7)
    return np.asarray(X), np.asarray(mse), np.asarray(ok)


@pytest.mark.parametrize("O,warm,accept", [
    (2, False, 9.0), (3, False, 9.0), (3, True, 9.0), (3, False, 2.25),
    (49, True, 9.0)])
def test_triangulate_gn_matches_jax(cams49, O, warm, accept):
    cams, xy, mask, X0 = _problem(cams49, 512 if O < 49 else 256, O,
                                  seed=O * 7 + warm)
    X0 = X0 if warm else None
    iters = 8 if warm else 30
    jX, _, jok = _jax(cams49, cams, xy, mask, X0, iters, accept)
    tX, _, tok = tt.triangulate_gn(
        torch.as_tensor(cams49), torch.as_tensor(cams), torch.as_tensor(xy),
        torch.as_tensor(mask),
        X0=None if X0 is None else torch.as_tensor(X0), max_iters=iters,
        accept_mse=accept)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert 0 < jok.sum() < len(jok)
    np.testing.assert_allclose(tX.numpy()[jok], jX[jok], rtol=1e-4,
                               atol=1e-6)


def test_dlt_matches_jax(cams49):
    cams, xy, mask, _ = _problem(cams49, 512, 5, seed=3, mask_p=0.9)
    mask[:, :2] = True
    P = cams49[cams]
    a = np.asarray(jt.triangulate_dlt(jnp.asarray(P), jnp.asarray(xy),
                                      jnp.asarray(mask)))
    b = tt.triangulate_dlt(torch.as_tensor(P), torch.as_tensor(xy),
                           torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_add_observation_matches_jax(cams49):
    cams, xy, mask, X0 = _problem(cams49, 256, 4, seed=5)
    mask[:, 3] = False
    P = cams49[cams]
    new_P = cams49[(cams[:, 0] + 1) % 49]
    new_xy = xy[:, 0] + 0.5
    ja = jt.add_observation_to_3d_points(
        jnp.asarray(P), jnp.asarray(xy), jnp.asarray(mask),
        jnp.asarray(X0), jnp.asarray(new_P), jnp.asarray(new_xy))
    ta = tt.add_observation_to_3d_points(
        torch.as_tensor(P), torch.as_tensor(xy), torch.as_tensor(mask),
        torch.as_tensor(X0), torch.as_tensor(new_P), torch.as_tensor(new_xy))
    np.testing.assert_array_equal(ta[3].numpy(), np.asarray(ja[3]))
    np.testing.assert_array_equal(ta[2].numpy(), np.asarray(ja[2]))
    ok = np.asarray(ja[2])
    np.testing.assert_allclose(ta[0].numpy()[ok], np.asarray(ja[0])[ok],
                               rtol=1e-4, atol=1e-6)


def test_zero_observations_are_invalid(cams49):
    """O == 0 (the JAX code raises IndexError there): every point comes
    back invalid, with and without a warm start."""
    N = 5
    empty = dict(cams=torch.zeros((N, 0), dtype=torch.int32),
                 xy=torch.zeros((N, 0, 2)),
                 mask=torch.zeros((N, 0), dtype=torch.bool))
    for X0 in (None, torch.ones((N, 3))):
        X, mse, ok = tt.triangulate_gn(torch.as_tensor(cams49), **empty,
                                       X0=X0)
        assert X.shape == (N, 3) and not ok.any()


# ----------------------------------------------------------------------
# A numpy model of K3's general body: DLT and GN over a point's present
# observations only (csrc/triangulate_gn.cu), against the padded form
# ----------------------------------------------------------------------

F32 = np.float32
TAME_P, TAME_XY, PROBE = F32(2.0 ** 41), F32(2.0 ** 60), F32(2.0 ** 88)
PROBE_ROW = np.array([[PROBE, 0, 0, 0], [0, PROBE, PROBE, 0], [0, 0, 0, 1]],
                     F32)


def _guard(v, tiny):
    return np.where(np.abs(v) < F32(tiny), np.where(v < 0, F32(-tiny),
                                                    F32(tiny)), v)


def _visit_dlt(Pv, xv, yv, wv, act):
    """The kernel's DLT over visited observations [N, K] (an inactive
    visit adds nothing), in f32 with one rounding per operation."""
    N, K = xv.shape
    a = {(i, j): np.zeros(N, F32) for i in range(4) for j in range(i, 4)}
    for k in range(K):
        p = Pv[:, k]
        for coord, prow in ((xv[:, k], 0), (yv[:, k], 1)):
            r = [coord * p[:, 2, c] - p[:, prow, c] for c in range(4)]
            nrm = np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
                          + r[3] * r[3])
            scale = wv[:, k] / np.maximum(nrm, F32(1e-12))
            r = [ri * scale for ri in r]
            for (i, j) in a:
                a[i, j] = np.where(act[:, k], a[i, j] + r[i] * r[j], a[i, j])
    tr = a[0, 0] + a[1, 1] + a[2, 2] + a[3, 3]
    eps = F32(1e-7) * tr + F32(1e-30)
    for i in range(4):
        a[i, i] = a[i, i] + eps
    sq = lambda v: np.sqrt(np.maximum(v, F32(1e-30)))
    L11 = sq(a[0, 0])
    L21, L31, L41 = a[0, 1] / L11, a[0, 2] / L11, a[0, 3] / L11
    L22 = sq(a[1, 1] - L21 * L21)
    L32 = (a[1, 2] - L31 * L21) / L22
    L42 = (a[1, 3] - L41 * L21) / L22
    L33 = sq(a[2, 2] - L31 * L31 - L32 * L32)
    L43 = (a[2, 3] - L41 * L31 - L42 * L32) / L33
    L44 = sq(a[3, 3] - L41 * L41 - L42 * L42 - L43 * L43)
    nv = np.sqrt(1.0 + 1.0 + 1.0 + 1.5 * 1.5)
    v = [np.full(N, F32(c / nv)) for c in (1.0, 1.0, 1.0, 1.5)]
    for _ in range(4):
        y1 = v[0] / L11
        y2 = (v[1] - L21 * y1) / L22
        y3 = (v[2] - L31 * y1 - L32 * y2) / L33
        y4 = (v[3] - L41 * y1 - L42 * y2 - L43 * y3) / L44
        x4 = y4 / L44
        x3 = (y3 - L43 * x4) / L33
        x2 = (y2 - L32 * x3 - L42 * x4) / L22
        x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11
        nn = np.maximum(np.sqrt(x1 * x1 + x2 * x2 + x3 * x3 + x4 * x4),
                        F32(1e-30))
        v = [x1 / nn, x2 / nn, x3 / nn, x4 / nn]
    w = _guard(v[3], 1e-12)
    return np.stack([v[0] / w, v[1] / w, v[2] / w], 1)


def _visit_gn(Pv, xv, yv, wv, act, X0, mask_sum, iters, eps=5e-7,
              accept=9.0, det_min=1e-5):
    """gn.cuh gauss_newton over visited observations [N, K]."""
    N, K = xv.shape
    n_obs = np.maximum(mask_sum, F32(1.0))
    x, y, z = (X0[:, i].copy() for i in range(3))
    last = np.zeros(N, F32)
    frozen = np.zeros(N, bool)
    singular = np.zeros(N, bool)
    for _ in range(iters):
        h = {key: np.zeros(N, F32) for key in
             ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}
        g = [np.zeros(N, F32) for _ in range(3)]
        sq = np.zeros(N, F32)
        for k in range(K):
            p, m, on = Pv[:, k], wv[:, k], act[:, k]
            xH = p[:, 0, 0] * x + p[:, 0, 1] * y + p[:, 0, 2] * z + p[:, 0, 3]
            yH = p[:, 1, 0] * x + p[:, 1, 1] * y + p[:, 1, 2] * z + p[:, 1, 3]
            zH = _guard(p[:, 2, 0] * x + p[:, 2, 1] * y + p[:, 2, 2] * z
                        + p[:, 2, 3], 1e-12)
            rx = (xv[:, k] - xH / zH) * m
            ry = (yv[:, k] - yH / zH) * m
            sq = np.where(on, sq + rx * rx + ry * ry, sq)
            iz = m / (zH * zH)
            jx = [(p[:, 0, c] * zH - p[:, 2, c] * xH) * iz for c in range(3)]
            jy = [(p[:, 1, c] * zH - p[:, 2, c] * yH) * iz for c in range(3)]
            for a in range(3):
                g[a] = np.where(on, g[a] + jx[a] * rx + jy[a] * ry, g[a])
            for (a, b) in h:
                h[a, b] = np.where(on, h[a, b] + jx[a] * jx[b]
                                   + jy[a] * jy[b], h[a, b])
        mse = sq / (F32(2.0) * n_obs)
        now_frozen = frozen | (np.abs(mse - last) < F32(eps))
        h00, h01, h02 = h[0, 0], h[0, 1], h[0, 2]
        h11, h12, h22 = h[1, 1], h[1, 2], h[2, 2]
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
                + F32(2.0) * (h01 * h01 + h02 * h02 + h12 * h12))
        hs = np.sqrt(h_sq / F32(3.0))
        bad = (np.abs(det) < F32(det_min)) | (
            np.abs(det) < F32(1e-5) * (hs * (hs * hs)))
        run = ~(frozen | singular)
        step = run & ~(now_frozen | bad)
        x, y, z = (np.where(step, v + d, v) for v, d in ((x, dx), (y, dy),
                                                         (z, dz)))
        last = np.where(run & ~now_frozen, mse, last)
        singular = singular | (run & bad & ~now_frozen)
        frozen = np.where(run, now_frozen, frozen)
    valid = ~singular & (last < F32(accept)) & (mask_sum >= 2)
    return np.stack([x, y, z], 1), last, valid


@np.errstate(all="ignore")
def _gn_model(P, cams, xy, mask, X0, iters, live=True, guard=True):
    """K3's general body (live=True) or the padded loop (live=False) on
    N points: P [V,3,4], cams [N,O], xy [N,O,2], mask [N,O], X0 [N,3] or
    None (DLT).  The live form visits the present observations in
    ascending o, then (GN only) the probe row; with `guard` a point whose
    masked observations are not provably finite, or whose live run ends
    in NaN, takes the padded loop.  Returns (X, mse, valid, redone)."""
    N, O = mask.shape
    V = len(P)
    mask_sum = mask.sum(1).astype(F32)
    Ptab = np.concatenate([P, PROBE_ROW[None]])       # camera V: the probe
    cams_p = np.concatenate([cams, np.full((N, 1), V)], 1)
    xy_p = np.concatenate([xy, np.zeros((N, 1, 2), F32)], 1)
    mask_p = np.concatenate([mask, np.zeros((N, 1), bool)], 1)
    k = np.arange(O + 1)[None]
    n_live = mask.sum(1)[:, None]

    def visits(o_idx, w, act_gn, act_dlt):
        take = lambda a: np.take_along_axis(a, o_idx, 1)
        c = take(cams_p)
        return [Ptab[c], take(xy_p[..., 0]), take(xy_p[..., 1]),
                w.astype(F32), act_gn, act_dlt]

    pad = visits(np.broadcast_to(k, (N, O + 1)), mask_p, k < O, k < O)
    order = np.argsort(~mask_p, axis=1, kind="stable")  # present first
    live_v = visits(np.where(k < n_live, order, O), k < n_live,
                    k <= n_live, k < n_live)
    tame = (np.abs(P) <= TAME_P).all((1, 2))
    risky = (~mask & ~(tame[cams] & (np.abs(xy) <= TAME_XY).all(-1))).any(1)
    redone = risky & guard & live
    pick = lambda cond, a, b: np.where(
        cond.reshape((N,) + (1,) * (a.ndim - 1)), b, a)
    vis = [pick(redone, a, b) for a, b in zip(live_v, pad)] if live else pad
    if X0 is None:
        X0 = _visit_dlt(*vis[:4], vis[5])
    X, mse, ok = _visit_gn(*vis[:5], X0, mask_sum, iters)
    if live and guard:
        nan = np.isnan(mse) | np.isnan(X).any(1)
        Xp, msep, okp = _visit_gn(*pad[:5], X0, mask_sum, iters)
        X, mse, ok = pick(nan, X, Xp), pick(nan, mse, msep), pick(nan, ok, okp)
        redone = redone | nan
    return X, mse, ok, redone


def _bits_equal(a, b):
    """Equal bit for bit (NaNs included)."""
    return all(np.array_equal(np.asarray(x).view(np.uint8),
                              np.asarray(y).view(np.uint8))
               for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["non-prefix", "all-masked", "O=0",
                                  "inf point", "huge camera", "probe"])
@pytest.mark.parametrize("warm", [False, True])
def test_live_observation_gn_model_matches_padded(cams49, case, warm):
    """K3's general body walks only the present observations.  A numpy
    model of it equals the padded loop (which the plain twin and JAX
    run) bit for bit: on random non-prefix masks, on rows with every
    observation masked, at O = 0, and where a masked observation's terms
    overflow (a point of inf, a camera with entries of 1e30: 0 * inf =
    NaN in the padded form, which the unguarded skip would miss), and
    where X starts beyond the probe's 2^40.  The padded model also gives
    the plain twin's decisions, and its X within 1e-5 (torch's CPU sqrt
    is not correctly rounded)."""
    O = 0 if case == "O=0" else 8
    N = 200
    cams, xy, mask, X0 = _problem(cams49, N, max(O, 1), seed=40 + warm,
                                  mask_p=0.5)
    cams, xy, mask = cams[:, :O], xy[:, :O].copy(), mask[:, :O].copy()
    P = cams49.copy()
    if O:
        mask[::3, :2] = True                       # most rows triangulate
    if case == "all-masked":
        mask[::4] = False
    if case == "inf point":
        xy[~mask] = np.inf
    if case == "huge camera":
        P = np.concatenate([P, P[:1] * F32(1e30)])
        cams[~mask] = len(cams49)
    if case == "probe":
        X0[::5, 0] = F32(2.0 ** 41)
        warm = True
    X0 = X0 if warm else None
    iters = 8 if warm else 30
    live = _gn_model(P, cams, xy, mask, X0, iters)
    padded = _gn_model(P, cams, xy, mask, X0, iters, live=False)
    assert _bits_equal(live[:3], padded[:3])
    plain = tt._triangulate_gn_plain(
        torch.as_tensor(P), torch.as_tensor(cams), torch.as_tensor(xy),
        torch.as_tensor(mask), None if X0 is None else torch.as_tensor(X0),
        iters, 5e-7, 9.0, 1e-5)
    np.testing.assert_array_equal(plain[2].numpy(), padded[2])
    ok = padded[2]
    np.testing.assert_allclose(plain[0].numpy()[ok], padded[0][ok],
                               rtol=1e-5, atol=1e-6)
    unguarded = _gn_model(P, cams, xy, mask, X0, iters, guard=False)
    if case in ("inf point", "huge camera"):
        assert np.isnan(padded[1]).any() and live[3].any()
        assert not _bits_equal(unguarded[:3], padded[:3])
        assert (unguarded[2] & ~padded[2]).any()
    elif case == "probe":
        assert live[3][::5].all()
    elif O:
        assert ok.any() and not ok.all() and not live[3].any()
        assert _bits_equal(unguarded[:3], padded[:3])
