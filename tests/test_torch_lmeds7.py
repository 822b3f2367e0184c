"""K9 `lmeds7_fit` (ops/lmeds7.py, csrc/lmeds7_fit.cu) on the CPU: a
numpy model of the scoring kernel's selection and reduction against the
plain twin's upper median and argmin (ops/geometry.py); a model of the
kernel's last step (sigma in the twin's float32 and float64 steps,
inliers, valid, unit F) against geometry.lmeds_opencv_finish; the
wrapper's placement of the pair's points.
The kernel itself runs in the `cuda` tests of
test_torch_cuda_kernels.py.

The model runs the warps of a pair's block in a seeded random
interleaving: each warp takes its models in the kernel's order, reads
the threshold the block has reached, counts the errors at or below it
and below it, and selects the upper median by the kernel's four radix
passes only where that count leaves the median below the threshold.  Whatever
the interleaving, the pair's least key must be the plain twin's winner,
bit for bit.
"""

import numpy as np
import pytest
import torch

from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.ops import geometry as tg
from edgegraph3d_tpu_torch.ops import lmeds7

NONE = np.uint64(2 ** 64 - 1)


def _bits(err):
    """err_bits: the f32 errors' bits, NaN as +inf."""
    e = np.where(np.isnan(err), np.float32(np.inf), err).astype(np.float32)
    return e.view(np.uint32)


def _radix_select(e, k):
    """select_rank: the element of rank k of the bits e by four 8-bit
    passes, most significant first, each a histogram of the digits of the
    elements that match the digits found so far."""
    prefix, mask, rank = np.uint32(0), np.uint32(0), k
    for shift in (24, 16, 8, 0):
        match = (e & mask) == prefix
        digits = (e[match] >> np.uint32(shift)) & np.uint32(lmeds7.BINS - 1)
        hist = np.bincount(digits, minlength=lmeds7.BINS)
        ends = np.cumsum(hist)
        d = int(np.searchsorted(ends, rank, side="right"))
        rank -= int(ends[d] - hist[d])
        prefix |= np.uint32(d << shift)
        mask |= np.uint32((lmeds7.BINS - 1) << shift)
    return prefix


def k9_model(err, ok, n, rng):
    """The scoring kernel on errors err [P, 3T, N] (f32, the pair's n
    first) and flags ok [P, 3T], one block a pair: the keys [P] as
    int64, all ones for a pair without a model."""
    P, M, _ = err.shape
    W = lmeds7.WARPS
    keys = np.full(P, NONE, np.uint64)
    for p in range(P):
        k = int(n[p]) // 2
        bits = _bits(err[p, :, :n[p]])
        todo = {w: list(range(w, M, W)) for w in range(W)}
        while todo:
            w = list(todo)[rng.integers(len(todo))]
            steps = todo[w]
            if steps:
                m = steps.pop(0)
                if ok[p, m]:
                    t = np.uint32(int(keys[p]) >> 32)
                    e = bits[m]
                    if (e <= t).sum() > k:
                        med = t if (e < t).sum() <= k else _radix_select(e, k)
                        key = np.uint64((int(med) << 32) | m)
                        keys[p] = min(keys[p], key)
            if not steps:
                del todo[w]
    return keys


def decode(keys):
    """The block's reading of its pair's key: (best, score), model 0
    and +inf without a model."""
    has = keys != NONE
    best = np.where(has, keys & np.uint64(0xFFFFFFFF), 0).astype(np.int64)
    bits = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return (torch.as_tensor(best),
            torch.as_tensor(np.where(has, bits, np.float32(np.inf))))


def plain_winner(err, ok, n):
    """fundamental_lmeds_opencv's choice from the same errors: the
    models with a root first, _upper_median, the first least score."""
    err = torch.as_tensor(err)
    err = err.masked_fill(err.isnan(), float("inf"))
    ok = torch.as_tensor(ok)
    n = torch.as_tensor(n)
    P = err.shape[0]
    models = ok.sum(-1)
    M = int(models.max())
    score = torch.full((P,), float("inf"))
    best = torch.zeros(P, dtype=torch.int64)
    if M:
        order = torch.argsort((~ok).to(torch.int8), dim=-1,
                              stable=True)[:, :M]
        em = torch.take_along_dim(err, order[..., None], 1)
        scores = tg._upper_median(em, n)
        scores = torch.where(torch.arange(M) < models[:, None], scores,
                             float("inf"))
        b = scores.argmin(-1, keepdim=True)
        score = scores.gather(1, b)[:, 0]
        best = order.gather(1, b)[:, 0]
    return best, score


def _case(seed, P=10, T=6, N=37):
    """Errors with ties (values from a small set), +inf, NaN, runs of
    equal medians, mixed n (odd, even, 1 and N) and pairs without a
    model."""
    rng = np.random.default_rng(seed)
    M = 3 * T
    pool = np.array([0.0, 1e-9, 3e-4, 3e-4, 0.25, 1.0, 1.0, 7.5, np.inf,
                     np.nan], np.float32)
    err = rng.choice(pool, (P, M, N))
    smooth = rng.random((P, M, N)) < 0.3
    err[smooth] = rng.exponential(1.0, smooth.sum()).astype(np.float32)
    err[0, 3:9] = err[0, 3]                   # equal medians, later models
    err[1, :, ::2] = np.inf                   # half the points infinite
    ok = rng.random((P, M)) < 0.7
    ok[2] = False                             # a pair without a model
    ok[3] = False
    ok[3, M - 1] = True                       # one model, the last
    n = rng.integers(1, N + 1, P)
    n[:4] = [N, N - 1, 8, 1]
    return err, ok, n


@pytest.mark.parametrize("order", [1, 10, 132])
@pytest.mark.parametrize("seed", range(4))
def test_k9_selection_model_matches_plain(seed, order):
    """The kernel's keys, decoded as its blocks do, are the plain twin's
    winner and score, bit for bit, in three interleavings of the warps
    seeded by `order`."""
    err, ok, n = _case(seed)
    want_best, want_score = plain_winner(err, ok, n)
    assert torch.isinf(want_score[2])
    rng = np.random.default_rng(order)
    for _ in range(3):
        best, score = decode(k9_model(err, ok, n, rng))
        assert torch.equal(best, want_best), (order, best, want_best)
        assert torch.equal(score.view(torch.int32),
                           want_score.view(torch.int32)), order


@pytest.mark.parametrize("seed", range(3))
def test_k9_radix_select_is_the_rank(seed):
    """select_rank's four passes give np.partition's element, at every
    rank, on bits with many equal digits."""
    rng = np.random.default_rng(seed)
    err = rng.choice(np.float32([0, 1e-30, 1e-7, 0.5, 0.5000001, 1, 3e38,
                                 np.inf]), 101)
    e = _bits(err)
    for k in range(len(e)):
        assert _radix_select(e, k) == np.partition(e, k)[k]


@pytest.mark.parametrize("n,where", [(1, "static"), (2556, "static"),
                                     (2557, "optin"), (6268, "optin"),
                                     (14012, "optin"), (14013, "global"),
                                     (50000, "global")])
def test_k9_plan_streams_above_the_shared_budget(n, where):
    """The pair's points go to shared memory while the largest pair fits
    the H100's opt-in limit (dtu49's 6,268 points do), else the kernel
    reads them from device memory."""
    assert lmeds7.placement(n, kernels.H100_SMEM_OPTIN_BYTES) == where
    assert lmeds7.smem_bytes(n) == 8256 + 16 * n


def _threshold(n, score):
    """The block's sigma^2 in float32, in the plain twin's steps:
    5.0 / (n - 7) is a float32 reciprocal times 5, the factor float32,
    sqrt(score) float64, the floor 0.001."""
    k = np.maximum(n - 7, 1).astype(np.float32)
    f = np.float32(1) + (np.float32(1) / k) * np.float32(5)
    sigma = (np.float32(2.5 * 1.4826) * f).astype(np.float64) * np.sqrt(
        score.astype(np.float64))
    sigma = np.where(sigma < 0.001, 0.001, sigma)
    with np.errstate(over="ignore"):
        return (sigma * sigma).astype(np.float32)


def _err(F, x1, x2):
    """err_bits' values: r^2 / min(|ab(F x1h)|^2, |ab(F^T x2h)|^2) in
    float64, stored as float32, NaN as +inf."""
    x1h = np.concatenate([x1, np.ones_like(x1[..., :1])], -1).astype(float)
    x2h = np.concatenate([x2, np.ones_like(x2[..., :1])], -1).astype(float)
    l2 = np.einsum("pij,pnj->pni", F, x1h)
    l1 = np.einsum("pji,pnj->pni", F, x2h)
    r = (x2h * l2).sum(-1)
    den = np.minimum((l2[..., :2] ** 2).sum(-1), (l1[..., :2] ** 2).sum(-1))
    with np.errstate(divide="ignore", invalid="ignore"):
        e = (r * r / den).astype(np.float32)
    return np.where(np.isnan(e), np.float32(np.inf), e)


def test_k9_threshold_is_the_plain_sigma():
    """The block's threshold is bit for bit the plain twin's
    (sigma * sigma).float() at every n up to 400 and dtu49's, for scores
    from 0 through the float32 range to +inf."""
    rng = np.random.default_rng(2)
    n = np.concatenate([np.arange(1, 401), [6268]])
    for score in (np.float32([0, 1e-45, 3.5e-10, 0.25, 1, 7.5, 3e38,
                              np.inf]),
                  rng.exponential(1e-3, 50).astype(np.float32)):
        nn, ss = np.meshgrid(n, score, indexing="ij")
        want = (2.5 * 1.4826 * (1.0 + 5.0 / (torch.as_tensor(nn) - 7)
                                .clamp_min(1))
                * torch.sqrt(torch.as_tensor(ss).double())).clamp_min(0.001)
        want = (want * want).float().numpy()
        assert np.array_equal(_threshold(nn, ss).view(np.uint32),
                              want.view(np.uint32))


@pytest.mark.parametrize("seed", range(3))
def test_k9_last_step_model_matches_plain(seed):
    """The block's inliers, valid and unit F from the winner and its
    score, as geometry.lmeds_opencv_finish gives them: pairs under 8
    points, without a model (+inf), with a zero score (sigma's floor) and
    around 7 inliers."""
    rng = np.random.default_rng(seed)
    P, N = 12, 40
    x1 = rng.uniform(0, 640, (P, N, 2)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.5, (P, N, 2))).astype(np.float32)
    F = rng.normal(0, 1, (P, 3, 3))
    F[:, 2, 2] = 1.0
    n = rng.integers(8, N + 1, P)
    n[:3] = [5, 7, 8]
    err = _err(F, x1, x2)
    score = np.array([np.sort(e[:k])[k // 2] for e, k in zip(err, n)],
                     np.float32) * rng.uniform(0.05, 1.5, P).astype(
                         np.float32)
    score[3], score[4] = np.inf, 0.0
    inl = (err <= _threshold(n, score)[:, None]) & (np.arange(N) < n[:, None])
    valid = (n >= 10) & np.isfinite(score) & (inl.sum(-1) >= 7)
    unit = F / np.maximum(np.sqrt((F * F).sum((-2, -1))),
                          1e-300)[:, None, None]
    want_F, want_valid, want_inl = tg.lmeds_opencv_finish(
        torch.as_tensor(F), torch.as_tensor(score), torch.as_tensor(x1),
        torch.as_tensor(x2), torch.as_tensor(n))
    assert want_valid.any() and not want_valid.all()
    assert np.array_equal(inl, want_inl.numpy())
    assert np.array_equal(valid, want_valid.numpy())
    np.testing.assert_allclose(unit, want_F.numpy(), rtol=0, atol=1e-15)


def test_lmeds7_fit_on_the_cpu_is_the_plain_twin():
    rng = np.random.default_rng(1)
    x1 = torch.as_tensor(rng.uniform(0, 640, (2, 30, 2)).astype(np.float32))
    x2 = x1 + 3.0
    n = torch.tensor([30, 12])
    s = tg.lmeds7_samples(n, 20)
    got = lmeds7.lmeds7_fit(x1, x2, n, s)
    want = tg.fundamental_lmeds_opencv(x1, x2, n, s)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
