"""Device claiming (claiming_backend="device"): the port's fixpoint
(matching/claiming_device.py, plain torch on the CPU here) against the
host `MatchesManager.resolve_and_claim` and against the JAX package's
`apply_device_claiming`.

Claiming compares only integers, so every comparison is exact: the
accept masks, the claim rasters and the skip counters must be equal,
and the stage-3 reconstruction with the device backend must equal the
host backend's bit for bit (and JAX's device backend to the port's usual
1e-4 on coordinates, with the same view lists).
"""

import numpy as np
import pytest
import torch

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import claiming_device as j_claim
from edgegraph3d_tpu.pipeline import run_pipeline as jax_run
from edgegraph3d_tpu_torch import pipeline as tp
from edgegraph3d_tpu_torch.config import EdgeGraphConfig as TConfig
from edgegraph3d_tpu_torch.matching import claiming_device as t_claim
from edgegraph3d_tpu_torch.matching import matches as t_matches
from test_claiming import _random_claim_problem
from test_torch_native import require_jax_native_lib

KW = dict(max_polylines_per_view=256, max_polyline_len=128,
          max_follow_steps=16)


def _port_manager(jax_manager):
    m = t_matches.MatchesManager(jax_manager.lengths, buckets=jax_manager.B)
    m.raster = jax_manager.raster.copy()
    return m


@pytest.mark.parametrize("trial", range(4))
def test_device_claiming_matches_host_and_jax(trial):
    """Collision-rich random chunks (arcs pre-claimed by earlier chunks,
    90% successful seeds, overlapping spans), resolved first with the
    start check and then without it on the same managers."""
    rng = np.random.default_rng(100 + trial)
    mm_host, mm_jdev, args = _random_claim_problem(rng)
    mm_port = _port_manager(mm_jdev)
    for skip in (False, True):
        a_host = mm_host.resolve_and_claim(*args, skip_start_check=skip)
        a_jdev = j_claim.apply_device_claiming(mm_jdev, *args,
                                               skip_start_check=skip)
        a_port = t_claim.apply_device_claiming(mm_port, *args,
                                               skip_start_check=skip,
                                               device="cpu")
        assert a_port.dtype == bool and (~a_port & args[0]).any() != skip
        np.testing.assert_array_equal(a_port, a_host)
        np.testing.assert_array_equal(a_port, a_jdev)
        np.testing.assert_array_equal(mm_port.raster, mm_host.raster)
        np.testing.assert_array_equal(mm_port.raster, mm_jdev.raster)
        assert mm_port.counters["seeds_skipped_claimed"] == \
            mm_host.counters["seeds_skipped_claimed"]
    assert "device_claiming_fallback" not in mm_port.counters
    # two chunks, each of at least one round, the larger counted as max
    c = mm_port.counters
    assert c["device_claiming_chunks"] == 2
    assert c["device_claiming_rounds"] >= c["device_claiming_rounds_max"] + 1
    assert not any(k.startswith("device_claiming") for k in mm_host.counters)


def test_owner_raster_and_rounds_match_jax():
    """resolve_and_claim_device itself: the same accept mask, owner
    raster and convergence flag as JAX's, and more than one round (a
    seed blocked in round 1 is unblocked later)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    mm_host, _, args = _random_claim_problem(rng)
    success, cams, pl, seg, t, f_seg, f_t, b_seg, b_t = args
    m = mm_host
    bk = lambda s, tt: np.stack([m.bucket(cams[:, k], pl[:, k], s[:, k],
                                          tt[:, k]) for k in range(3)], 1)
    b_seed, b_fwd, b_bwd = bk(seg, t), bk(f_seg, f_t), bk(b_seg, b_t)
    S = len(success)
    owner0 = np.where(m.raster, np.int32(-1), np.int32(2 ** 30))
    span_j = j_claim._span_masks(jnp.asarray(b_seed), jnp.asarray(b_fwd),
                                 jnp.asarray(b_bwd), m.B)
    acc_j, own_j, conv_j = j_claim.resolve_and_claim_device(
        jnp.asarray(owner0), jnp.asarray(success),
        jnp.arange(S, dtype=jnp.int32), jnp.asarray(cams, jnp.int32),
        jnp.asarray(pl, jnp.int32), jnp.asarray(b_seed[:, 0], jnp.int32),
        span_j)
    span_t = t_claim._span_masks(torch.as_tensor(b_seed),
                                 torch.as_tensor(b_fwd),
                                 torch.as_tensor(b_bwd), m.B)
    np.testing.assert_array_equal(span_t.numpy(), np.asarray(span_j))
    acc_t, own_t, conv_t, rounds = t_claim.resolve_and_claim_device(
        t_claim.owner_from_bool(torch.as_tensor(m.raster)),
        torch.as_tensor(success), torch.arange(S, dtype=torch.int32),
        torch.as_tensor(cams), torch.as_tensor(pl),
        torch.as_tensor(b_seed[:, 0]), span_t)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(own_t.numpy(), np.asarray(own_j))
    assert own_t.dtype == torch.int32
    assert conv_t == bool(conv_j) and rounds > 1


def test_max_rounds_one_falls_back_and_counts(monkeypatch):
    """A fixpoint cut by max_rounds takes the exact host pass and counts
    it; a chunk that converges in its first round does not."""
    monkeypatch.setattr(t_claim, "MAX_ROUNDS", 1)
    rng = np.random.default_rng(0)
    mm_host, mm_jdev, args = _random_claim_problem(rng)
    mm_port = _port_manager(mm_jdev)
    a_host = mm_host.resolve_and_claim(*args)
    a_port = t_claim.apply_device_claiming(mm_port, *args, device="cpu")
    assert mm_port.counters["device_claiming_fallback"] == 1
    assert mm_port.counters["device_claiming_rounds"] == 1
    np.testing.assert_array_equal(a_port, a_host)
    np.testing.assert_array_equal(mm_port.raster, mm_host.raster)
    # skip_start_check: nothing can block, round 1 is the fixpoint
    a_host = mm_host.resolve_and_claim(*args, skip_start_check=True)
    a_port = t_claim.apply_device_claiming(mm_port, *args, device="cpu",
                                           skip_start_check=True)
    assert mm_port.counters["device_claiming_fallback"] == 1
    assert mm_port.counters["device_claiming_chunks"] == 2
    assert mm_port.counters["device_claiming_rounds"] == 2
    np.testing.assert_array_equal(a_port, a_host)
    np.testing.assert_array_equal(mm_port.raster, mm_host.raster)


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mm_host, _, args = _random_claim_problem(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_claim.apply_device_claiming(_port_manager(mm_host), *args)


@pytest.fixture(scope="module")
def cube():
    require_jax_native_lib()
    return synthetic.make_cube_scene(n_cams=8, n_refpoints_per_edge=8,
                                     width=320, height_px=240, focal=400.0,
                                     seed=7)


def test_stage3_device_claiming_matches_host_and_jax(cube):
    """Stage 3 through run_pipeline with both backends: the device
    backend gives the host backend's output exactly (points, view lists,
    counts, skip counter) and JAX's device backend's view lists."""
    sfmd, imgs, _ = cube
    outs, stats = {}, {}
    for backend in ("host", "device"):
        stats[backend] = tp.PipelineStats()
        outs[backend] = tp.run_pipeline(
            sfmd, imgs, TConfig().replace(claiming_backend=backend, **KW),
            max_starting_views=2, stages=(3,), stats=stats[backend],
            device="cpu")
    h, d = outs["host"], outs["device"]
    n0 = sfmd.n_points
    assert d.n_points == h.n_points > n0 + 20
    np.testing.assert_array_equal(d.points, h.points)
    assert [c.tolist() for c in d.obs_cam] == [c.tolist() for c in h.obs_cam]
    assert stats["device"].counts == stats["host"].counts
    for k in ("seeds_skipped_claimed", "continuation_rounds"):
        assert stats["device"].counters[k] == stats["host"].counters[k], k
    assert stats["device"].counters["seeds_skipped_claimed"] > 0
    assert "device_claiming_fallback" not in stats["device"].counters
    dc = stats["device"].counters
    assert dc["device_claiming_rounds"] >= dc["device_claiming_chunks"] > 0
    assert not any(k.startswith("device_claiming")
                   for k in stats["host"].counters)
    j = jax_run(sfmd, imgs, EdgeGraphConfig().replace(
        claiming_backend="device", **KW), max_starting_views=2, stages=(3,))
    assert j.n_points == d.n_points
    assert [c.tolist() for c in d.obs_cam[n0:]] == \
        [c.tolist() for c in j.obs_cam[n0:]]
    np.testing.assert_allclose(d.points, j.points, rtol=0, atol=1e-4)
