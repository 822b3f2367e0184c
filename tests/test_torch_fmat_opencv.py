"""OpenCV's FM_LMEDS F table (fmat_source="opencv_lmeds"): the port's
estimator (ops/geometry.py) against cv2 where cv2 can show it, against the
plain reference (h100bench/lmeds_reference.py) on the same samples, and
the table, its spans and counters and the pipeline on small scenes.  CPU;
only the tests that call cv2 skip without it.

Tolerances: the 7-point models within 1e-9 per entry of a unit-Frobenius
F, up to sign (float64 solves of the same 7 points; 1e-11 read); the
inlier masks equal (the same float64 error and sigma rule as OpenCV's);
against the reference, the same winning sample on every pair and F
within 1e-10 (both float64; 4e-13 read).  Against cv2's FM_LMEDS, which
draws other samples, the port's upper median within a factor 1.5 of
cv2's and the inlier sets overlapping by 90% (Jaccard), on pairs with
0.5 px noise and 20% outliers.
"""

import numpy as np
import pytest
import torch

from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.matching import refpoints as rp
from edgegraph3d_tpu_torch.ops import geometry as tg
from edgegraph3d_tpu_torch.plgs.extraction import extract_plgs
from h100bench import lmeds_reference, reference, run, scenes

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128,
                                fmat_source="opencv_lmeds")


def _rotation(rng, sigma):
    w = rng.normal(0, sigma, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    k = k / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _pair(seed, n, noise=0.0, outliers=0.0):
    """Correspondences of two 640x480 views of n points: x1, x2 [n, 2]
    float32, and the outliers' mask."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([_rotation(rng, 0.2), rng.normal(0, 1, (3, 1))])

    def proj(P):
        h = np.hstack([X, np.ones((n, 1))]) @ P.T
        return h[:, :2] / h[:, 2:] + rng.normal(0, noise, (n, 2))
    x1, x2 = proj(P1), proj(P2)
    bad = rng.random(n) < outliers
    x2[bad] += rng.uniform(30, 80, (int(bad.sum()), 2))
    return x1.astype(np.float32), x2.astype(np.float32), bad


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)


def _up_to_sign(a, b):
    a, b = _unit(a), _unit(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.mark.parametrize("seed", range(4))
def test_seven_point_matches_cv2(seed):
    """The same number of models as cv2's FM_7POINT, each equal up to
    scale to one of cv2's (the order of the roots follows the null
    space's basis, which the SVDs choose differently)."""
    cv2 = pytest.importorskip("cv2")
    counts = set()
    for k in range(25):
        x1, x2, _ = _pair(100 * seed + k, 7)
        Fc, _ = cv2.findFundamentalMat(x1, x2, cv2.FM_7POINT)
        F, ok = tg.fundamental_7point(torch.as_tensor(x1)[None],
                                      torch.as_tensor(x2)[None])
        F = F[0][ok[0]].numpy()
        Fc = np.zeros((0, 3, 3)) if Fc is None else Fc.reshape(-1, 3, 3)
        assert len(F) == len(Fc)
        counts.add(len(F))
        for a in F:
            assert min(_up_to_sign(a, b) for b in Fc) < 1e-9
            # scaled so that F[2,2] = 1, as run7Point leaves it
            assert a[2, 2] == pytest.approx(1.0, abs=1e-12)
        for b in Fc:
            assert min(_up_to_sign(a, b) for a in F) < 1e-9
    assert 3 in counts and 1 in counts


@pytest.mark.parametrize("coeffs", [(1.0, -6.0, 11.0, -6.0),
                                    (2.0, 0.0, 0.0, -16.0),
                                    (1.0, 0.0, 1.0, 5.0),
                                    (0.0, 1.0, -3.0, 2.0),
                                    (0.0, 0.0, 4.0, -2.0),
                                    (0.0, 1.0, 0.0, 1.0)])
def test_solve_cubic_real_roots(coeffs):
    """Closed-form real roots (cv::solveCubic's cases: three, one, a
    quadratic, a linear equation, none) against numpy.roots."""
    x, has = tg._solve_cubic(*torch.tensor(coeffs, dtype=torch.float64))
    got = np.sort(x[has].numpy())
    r = np.roots(np.trim_zeros(np.asarray(coeffs), "f"))
    want = np.sort(np.real(r[np.abs(np.imag(r)) < 1e-12]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_error_and_sigma_give_cv2_lmeds_mask(seed):
    """cv_epipolar_error of cv2's FM_LMEDS F, its upper median and
    sigma = 2.5 * 1.4826 (1 + 5 / (n - 7)) sqrt(median) give cv2's inlier
    mask exactly."""
    cv2 = pytest.importorskip("cv2")
    n = 400 + 51 * seed
    x1, x2, _ = _pair(seed, n, noise=0.5, outliers=0.2)
    F, mask = cv2.findFundamentalMat(x1, x2, cv2.FM_LMEDS)
    err = tg.cv_epipolar_error(torch.as_tensor(F)[None], torch.as_tensor(x1),
                               torch.as_tensor(x2))[0].numpy()
    assert err.dtype == np.float32
    med = float(np.sort(err)[n // 2])
    sigma = max(2.5 * 1.4826 * (1 + 5 / (n - 7)) * np.sqrt(med), 0.001)
    np.testing.assert_array_equal(err <= np.float32(sigma * sigma),
                                  mask[:, 0].astype(bool))


@pytest.mark.parametrize("seed", range(3))
def test_fit_against_cv2_lmeds(seed):
    """On noisy pairs with 20% outliers the port's fit (its own samples)
    is as good as cv2's (cv::RNG's): upper median within a factor 1.5,
    inlier sets overlapping by 90%."""
    cv2 = pytest.importorskip("cv2")
    n = 500
    x1, x2, bad = _pair(10 + seed, n, noise=0.5, outliers=0.2)
    Fc, mask = cv2.findFundamentalMat(x1, x2, cv2.FM_LMEDS)
    med_cv = float(np.sort(tg.cv_epipolar_error(
        torch.as_tensor(Fc)[None], torch.as_tensor(x1),
        torch.as_tensor(x2))[0].numpy())[n // 2])
    nn = torch.tensor([n])
    fit = tg.fundamental_lmeds_opencv(
        torch.as_tensor(x1)[None], torch.as_tensor(x2)[None], nn,
        tg.lmeds7_samples(nn, tg.lmeds_trials(0.99)))
    assert bool(fit["valid"][0])
    assert 1 / 1.5 < float(fit["score"][0]) / med_cv < 1.5
    ours, theirs = fit["inliers"][0].numpy(), mask[:, 0].astype(bool)
    assert (ours & theirs).sum() / (ours | theirs).sum() > 0.9
    # the inliers are the pair's good points
    assert (ours & bad).sum() <= 0.01 * n


def test_trials_and_samples():
    assert tg.lmeds_trials(0.99) == tg.CV_TRIALS == 300
    assert tg.lmeds_trials(0.5) == 45
    assert tg.lmeds_trials(0.999999) == 901
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            tg.lmeds_trials(bad)
    n = torch.tensor([7, 8, 20, 6268])
    s = tg.lmeds7_samples(n, 300)
    assert s.shape == (4, 300, 7) and s.dtype == torch.int64
    assert (s >= 0).all() and (s < n[:, None, None]).all()
    srt = torch.sort(s, -1).values
    assert (srt[..., 1:] > srt[..., :-1]).all()              # distinct
    assert (srt[0] == torch.arange(7)).all()                 # n = 7: all
    torch.testing.assert_close(s, tg.lmeds7_samples(n, 300))
    # the draws of a pair do not depend on the pairs after it
    torch.testing.assert_close(s[:2], tg.lmeds7_samples(n[:2], 300))
    # uniform: every position of 20 drawn about 300 * 7 / 20 times
    counts = torch.bincount(s[2].flatten(), minlength=20).double()
    assert (counts - 105).abs().max() < 45


@pytest.fixture(scope="module")
def noisy_scene():
    """A 6-view scene whose refpoint observations carry 0.5 px of noise
    (so that the winning samples are not tied)."""
    sfmd, imgs, _ = synthetic.make_dtu_scale_scene(
        n_cams=6, n_refpoints=300, width=400, height_px=300, focal=550.0,
        seed=1)
    rng = np.random.default_rng(0)
    sfmd.obs_xy = [x + rng.normal(0, 0.5, x.shape) for x in sfmd.obs_xy]
    return sfmd, imgs


def test_table_matches_reference(noisy_scene):
    """The port's fit and lmeds_reference on the port's samples: every
    pair valid on both, the same winning sample and score, F within 1e-10
    up to sign; the table holds each fit F at its pair, not transposed."""
    sfmd, _ = noisy_scene
    fit = rp.opencv_lmeds_fit(sfmd, CFG, "cpu")
    V = sfmd.n_cameras
    assert len(fit.pairs) == V * (V - 1)
    assert fit.samples.shape[1:] == (300, 7)
    xy, mask = rp.dense_observations(sfmd)
    points = []
    for i, j in fit.pairs:
        both = mask[:, i] & mask[:, j]
        points.append((xy[both, i], xy[both, j]))
    ref = lmeds_reference.fit_pairs(points, fit.samples)
    assert fit.valid.all()
    for p, r in enumerate(ref):
        assert int(fit.best[p]) // 3 == r["sample"]
        assert float(fit.score[p]) == pytest.approx(r["score"], rel=1e-6)
        assert _up_to_sign(fit.F[p], r["F"]) < 1e-10
    assert int(fit.models.sum()) == sum(r["models"] for r in ref)
    table = rp.opencv_lmeds_fundamental_table(sfmd, CFG, "cpu")
    assert table.dtype == torch.float32
    for p, (i, j) in enumerate(fit.pairs):
        np.testing.assert_allclose(table[i, j].numpy(), fit.F[p].numpy(),
                                   rtol=0, atol=1e-7)
    i, j = fit.pairs[0]
    assert _up_to_sign(table[i, j], table[j, i].T) > 1e-6


def test_chunks_do_not_change_the_fit(noisy_scene, monkeypatch):
    sfmd, _ = noisy_scene
    whole = rp.opencv_lmeds_fit(sfmd, CFG, "cpu")
    # one pair a chunk
    monkeypatch.setattr(rp, "OPENCV_LMEDS_CHUNK_BYTES", 1)
    one = rp.opencv_lmeds_fit(sfmd, CFG, "cpu")
    for k in ("F", "valid", "score", "best", "models", "no_model"):
        torch.testing.assert_close(getattr(one, k), getattr(whole, k),
                                   rtol=1e-12, atol=0)


def test_card_sized_chunks_do_not_change_the_fit(noisy_scene, monkeypatch):
    """The chunks the card takes (opencv_lmeds_chunk with on_card), here
    at a budget of 7 pairs, so that the last of 5 chunks is short, give
    the one-chunk fit: every chunk lands in its rows of the outputs."""
    sfmd, _ = noisy_scene
    whole = rp.opencv_lmeds_fit(sfmd, CFG, "cpu")
    chunk = rp.opencv_lmeds_chunk
    n_ref, n_max = sfmd.n_points, int(whole.n_common.max())
    monkeypatch.setattr(rp, "OPENCV_LMEDS_CARD_CHUNK_BYTES",
                        7 * (48 * n_ref + 17 * n_max + 73 * 900) + 1)
    assert chunk(n_ref, n_max, 300, True) == 7
    seen = []

    def card_chunk(n_refpoints, n_max, trials, on_card):
        seen.append(on_card)
        return chunk(n_refpoints, n_max, trials, True)

    monkeypatch.setattr(rp, "opencv_lmeds_chunk", card_chunk)
    part = rp.opencv_lmeds_fit(sfmd, CFG, "cpu")
    assert seen == [False] and len(whole.pairs) == 30
    for k in ("F", "valid", "score", "best", "models", "no_model"):
        torch.testing.assert_close(getattr(part, k), getattr(whole, k),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_ref,n_max,trials,on_card,pairs", [
    (6268, 6268, 300, True, 4538),         # dtu49: its 2,352 pairs at once
    (100_000, 30_000, 300, True, 399),     # 300 views of 100k refpoints
    (6268, 6268, 300, False, 11),          # the CPU's plain route
    (6268, 6268, 45, False, 79)])
def test_chunk_keeps_the_work_under_its_budget(n_ref, n_max, trials,
                                               on_card, pairs):
    """opencv_lmeds_chunk: the pairs of a chunk, at most the budget's
    bytes of work (common_points over every refpoint, the pair's points
    and K9's models on the card; the plain twin's [pairs, 3T, points]
    work on the CPU)."""
    got = rp.opencv_lmeds_chunk(n_ref, n_max, trials, on_card)
    assert got == pairs
    if on_card:
        pair = 48 * n_ref + 17 * n_max + 73 * 3 * trials
        assert got * pair <= rp.OPENCV_LMEDS_CARD_CHUNK_BYTES \
            < (got + 1) * pair
    else:
        assert got * 3 * trials * n_max * 64 <= rp.OPENCV_LMEDS_CHUNK_BYTES


@pytest.mark.parametrize("confidence,trials", [(0.99, 300), (0.5, 45)])
def test_confidence_sets_the_trials(noisy_scene, confidence, trials):
    """fmat_lmeds_confidence sets the samples a pair, as findFundamentalMat's
    confidence does; the first 45 of 300 draws are not the 45 of 45, since
    the draws are made for the whole table at once."""
    sfmd, _ = noisy_scene
    cfg = CFG.replace(fmat_lmeds_confidence=confidence)
    assert CFG.fmat_lmeds_confidence == 0.99
    fit = rp.opencv_lmeds_fit(sfmd, cfg, "cpu")
    assert fit.samples.shape[1:] == (trials, 7)
    assert fit.valid.all()
    assert (fit.models + fit.no_model >= trials).all()
    assert (fit.models <= 3 * trials).all()


def test_too_few_common_points_get_the_sentinel(noisy_scene):
    sfmd, _ = noisy_scene
    V = sfmd.n_cameras
    stats = tp.PipelineStats()
    cfg = CFG.replace(fmat_min_common_points=10 ** 6)
    F = rp.opencv_lmeds_fundamental_table(sfmd, cfg, "cpu", stats)
    sentinel = torch.zeros(3, 3)
    sentinel[2, 2] = 1.0
    assert (F == sentinel).all()
    assert stats.counters == dict(fmat_pairs_fit=0,
                                  fmat_pairs_sentinel=V * (V - 1),
                                  fmat_models_scored=0,
                                  fmat_samples_no_model=0,
                                  fmat_pairs_kernel=0)


def test_fmat_pairs_kernel_is_zero_on_the_cpu(noisy_scene):
    """fmat_pairs_kernel counts the pairs K9 scored on the card: none on
    the CPU, where the plain twin fits every pair."""
    sfmd, _ = noisy_scene
    stats = tp.PipelineStats()
    rp.opencv_lmeds_fundamental_table(sfmd, CFG, "cpu", stats)
    assert stats.counters["fmat_pairs_fit"] == 30
    assert stats.counters["fmat_pairs_kernel"] == 0
    assert rp.opencv_lmeds_fit(sfmd, CFG, "cpu").pairs_kernel == 0


def test_unknown_fmat_source_raises(noisy_scene):
    sfmd, imgs = noisy_scene
    stack = extract_plgs(imgs, CFG)
    with pytest.raises(ValueError, match="fmat_source"):
        rp.build_context(sfmd, stack, CFG.replace(fmat_source="ransac"),
                         device="cpu")


def test_context_spans_and_counters(noisy_scene):
    """build_context's F table is the span f_table and its grids the span
    grids, both inside context(F+grids); the fit's four counters."""
    sfmd, imgs = noisy_scene
    V = sfmd.n_cameras
    stats = tp.PipelineStats()
    tp.run_pipeline(sfmd, imgs, CFG, stats=stats, stages=(3,),
                    device="cpu")
    parents = {n: p for n, p, _, _ in stats.spans}
    assert parents["f_table"] == parents["grids"] == "context(F+grids)"
    spans = {n: (s, e) for n, _, s, e in stats.spans}
    lo, hi = spans["context(F+grids)"]
    for name in ("f_table", "grids"):
        assert lo <= spans[name][0] <= spans[name][1] <= hi
    assert (stats.timings["f_table"] + stats.timings["grids"]
            <= stats.timings["context(F+grids)"])
    c = stats.counters
    assert c["fmat_pairs_fit"] + c["fmat_pairs_sentinel"] == V * (V - 1)
    assert c["fmat_pairs_fit"] == V * (V - 1)
    assert 300 * c["fmat_pairs_fit"] <= (c["fmat_models_scored"]
                                         + c["fmat_samples_no_model"])
    assert c["fmat_models_scored"] <= 3 * 300 * c["fmat_pairs_fit"]
    # the exact table is a span too, and counts no fit
    exact = tp.PipelineStats()
    rp.build_context(sfmd, extract_plgs(imgs, CFG),
                     CFG.replace(fmat_source="exact"), device="cpu",
                     stats=exact)
    assert {"f_table", "grids"} <= set(exact.timings)
    assert not any(k.startswith("fmat_") for k in exact.counters)


def test_pipeline_on_cube_is_correct():
    """run_pipeline(stages=(3,)) with the OpenCV table on the cube scene,
    judged by the benchmark's reference.  Limits from the exact table's
    readings on this scene (571 edge-points, coverage 0.752, median
    distance 0.00649) with room."""
    scene = scenes.make_cube_scene(n_cams=8, n_refpoints_per_edge=8, seed=0,
                                   width=320, height_px=240, focal=400.0)
    g = dict(filter_gn_max_mse=2.25, filter_min_views=3,
             density_cell_size_px=3)
    out = tp.run_pipeline(run.program_scene(scene), scene.edge_images.copy(),
                          CFG, stages=(3,), device="cpu")
    nums = reference.judge_numbers(scene, reference.output_of(out), g)
    limits = dict(gap_px=0.01, edge_points=500, coverage=0.7,
                  med_dist3d=0.008, min_views=4, unclaimed=0,
                  mse_px2=2.25 * (1 + reference.F32_GATE_SLACK))
    rows = reference.verdict(nums, limits)
    assert all(ok for *_, ok in rows), rows
