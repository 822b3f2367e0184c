"""CPU models of the kernels' device-side rules, held against the plain
twins and the JAX package:

  * kernels.table_placement, which places K3's, K6's, K7's and K8's
    per-block tables in shared memory (up to 48 KiB, then opted in up to the card's
    limit) or in device memory, at the byte counts of each kernel's
    boundaries on an H100 (232,448 B opt-in limit);
  * K6's selection, as one thread runs it per (sample, member) pair: a
    scan of the segments below len - 1 that stops at the second crossing,
    then the lowest segments without a crossing as fill slots.  It must
    pick what the reference's stable argsort picks
    (polyline_line_intersections, port and JAX) and what
    _group_seed_sample_plain returns, bit for bit where both sides are
    torch / numpy f32 and within 1e-4 px / 1e-4 against XLA, which
    contracts the crossing arithmetic differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu.ops import polyline_ops as jpo
from edgegraph3d_tpu_torch import kernels
from edgegraph3d_tpu_torch.matching import expansion
from edgegraph3d_tpu_torch.matching import polyline_stages as tps
from edgegraph3d_tpu_torch.ops import ba
from edgegraph3d_tpu_torch.ops import polyline_ops as tpo
from edgegraph3d_tpu_torch.ops import triangulation
from edgegraph3d_tpu_torch.ops.geometry import epipolar_line_fma

OPTIN = kernels.H100_SMEM_OPTIN_BYTES


@pytest.mark.parametrize("kernel,size,where", [
    ("K3", 1002, "static"), ("K3", 1003, "optin"), ("K3", 4742, "optin"),
    ("K3", 4743, "global"),
    ("K7 epipolar", 78, "static"), ("K7 epipolar", 79, "optin"),
    ("K7 epipolar", 372, "optin"), ("K7 epipolar", 373, "global"),
    ("K7 closest", 1024, "static"), ("K7 closest", 1025, "optin"),
    ("K7 closest", 4842, "optin"), ("K7 closest", 4843, "global"),
    ("K6", 93, "static"), ("K6", 94, "optin"), ("K6", 443, "optin"),
    ("K6", 444, "global"),
    ("K8", 70, "static"), ("K8", 71, "optin"), ("K8", 338, "optin"),
    ("K8", 339, "global")])
def test_table_placement_at_kernel_boundaries(kernel, size, where):
    """`size` is K3's, K7's and K8's camera count V, K6's member count K
    (at L = 64, the stage-1/2 sweep's S = 24 samples staying in device
    memory)."""
    n_bytes = {"K3": lambda n: triangulation.gn_table_bytes(n),
               "K8": lambda n: ba.ba_table_bytes(n),
               "K7 epipolar": lambda n: expansion.k7_table_bytes(n, True),
               "K7 closest": lambda n: expansion.k7_table_bytes(n, False),
               "K6": lambda n: tps.k6_table_bytes(n, 64)}[kernel](size)
    assert kernels.table_placement(n_bytes, OPTIN) == where


def test_table_placement_rule():
    s = kernels.SMEM_STATIC_BYTES
    assert [kernels.table_placement(n, OPTIN) for n in
            (0, s, s + 1, OPTIN, OPTIN + 1)] == \
        ["static", "static", "optin", "optin", "global"]
    # a card whose opt-in limit is the static one never opts in
    assert kernels.table_placement(s + 1, s) == "global"
    assert kernels.PLACEMENTS.index("global") == 2


def scan_slots(has, s, length: int):
    """K6's selection for one (line, polyline) pair: has / s [L - 1] are
    each segment's seg_line test.  Returns [(q, s, hit)] for the two
    output slots."""
    slots = []
    for q in range(max(length - 1, 0)):
        if len(slots) == 2:
            break
        if has[q]:
            slots.append((q, s[q], True))
    if not slots:
        return [(0, s[0], False), (1, s[1], False)]
    if len(slots) == 1:
        f = 1 if slots[0][0] == 0 else 0
        slots.append((f, s[f], False))
    return slots


def _model(coords, lengths, lines, qcos=0.965, qdist=5.0):
    """scan_slots over rows of polylines [n, L, 2] and lines [n, 3] ->
    (xy [n, 2, 2], seg [n, 2], t [n, 2], ok [n, 2]) as the kernel writes
    them: x = ax + s (bx - ax) in f32."""
    n, L, _ = coords.shape
    c = torch.as_tensor(coords)
    has, s, _ = tpo._segments_line_intersection_xy(
        c[:, :-1, 0], c[:, :-1, 1], c[:, 1:, 0], c[:, 1:, 1],
        torch.as_tensor(lines), qcos, qdist)
    has, s = has.numpy(), s.numpy()
    xy = np.zeros((n, 2, 2), np.float32)
    seg = np.zeros((n, 2), np.int32)
    t = np.zeros((n, 2), np.float32)
    ok = np.zeros((n, 2), bool)
    for r in range(n):
        for m, (q, sq, h) in enumerate(scan_slots(has[r], s[r],
                                                  int(lengths[r]))):
            a, b = coords[r, q], coords[r, q + 1]
            xy[r, m] = a + np.float32(sq) * (b - a)
            seg[r, m], t[r, m], ok[r, m] = q, sq, h
    return xy, seg, t, ok


def _zigzag_cases(L=40):
    """Zigzag polylines (x = 10 k, y alternating 0 / 10; every segment at
    45 degrees, so none is quasi-parallel to an axis-parallel line) and
    lines with 0, 1, 2 and 3 or more crossings below len - 1, crossings
    only on segments q >= len - 1 (len < L), a crossing on segment 0 (the
    fill slot is then segment 1) and crossings deep in the polyline
    (q >= 32)."""
    k = np.arange(L, dtype=np.float32)
    zig = np.stack([10.0 * k, 10.0 * (k % 2)], 1).astype(np.float32)
    horiz = lambda y: [0.0, 1.0, -y]          # y = const: every segment
    vert = lambda x: [1.0, 0.0, -x]           # x = const: one segment
    cases = [  # (length, line, crossings below len - 1)
        (L, horiz(20.0), 0), (L, vert(15.0), 1), (3, horiz(5.0), 2),
        (L, horiz(5.0), 39), (5, horiz(5.0), 4), (4, vert(155.0), 0),
        (2, horiz(5.0), 1), (1, horiz(5.0), 0), (0, vert(15.0), 0),
        (L, vert(345.0), 1), (36, horiz(5.0), 35), (35, vert(345.0), 0),
        (L, vert(5.0), 1), (L, vert(-4.0), 0), (34, horiz(3.0), 33)]
    coords = np.repeat(zig[None], len(cases), 0)
    lengths = np.array([c[0] for c in cases], np.int32)
    lines = np.array([c[1] for c in cases], np.float32)
    return coords, lengths, lines, [c[2] for c in cases]


def _random_cases(rng, n=400, L=40):
    steps = rng.normal(0, 8.0, (n, L, 2)) + rng.normal(0, 6.0, (n, 1, 2))
    coords = (rng.uniform(40, 280, (n, 1, 2)) + np.cumsum(steps, 1))
    lengths = rng.integers(0, L + 1, n)
    ang = rng.uniform(0, np.pi, n)
    ab = np.stack([np.cos(ang), np.sin(ang)], 1)
    anchor = coords[:, rng.integers(0, L)] + rng.normal(0, 10.0, (n, 2))
    lines = np.concatenate([ab, -(ab * anchor).sum(1, keepdims=True)], 1)
    return (coords.astype(np.float32), lengths.astype(np.int32),
            lines.astype(np.float32))


@pytest.mark.parametrize("case", ["zigzag", "random"])
def test_k6_selection_matches_argsort(case):
    """K6's selection rule against polyline_line_intersections: the port's
    (bit for bit) and the JAX package's (segments and flags exact,
    positions and parameters within 1e-4)."""
    if case == "zigzag":
        coords, lengths, lines, n_cross = _zigzag_cases()
    else:
        coords, lengths, lines = _random_cases(np.random.default_rng(6))
    m = _model(coords, lengths, lines)
    t = [a.numpy() for a in tpo.polyline_line_intersections(
        torch.as_tensor(coords), torch.as_tensor(lengths),
        torch.as_tensor(lines), 2)]
    for a, b in zip(m, t):
        np.testing.assert_array_equal(a, b)
    j = [np.asarray(a) for a in jax.vmap(
        lambda c, n, l: jpo.polyline_line_intersections(c, n, l, 2))(
        jnp.asarray(coords), jnp.asarray(lengths), jnp.asarray(lines))]
    np.testing.assert_array_equal(m[1], j[1])
    np.testing.assert_array_equal(m[3], j[3])
    np.testing.assert_allclose(m[0], j[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(m[2], j[2], rtol=0, atol=1e-4)
    if case == "zigzag":
        assert m[3].sum(1).tolist() == [min(c, 2) for c in n_cross]
        assert m[1][9].tolist() == [34, 0]    # deep crossing, fill slot 0
        assert m[1][12].tolist() == [0, 1]    # crossing at 0, fill slot 1
    else:
        assert m[3][:, 1].any() and not m[3].all()


def test_k6_selection_matches_plain_twin():
    """K6's selection rule applied to every (sample, member) pair of one
    group, with the twin's own samples and FMA-form lines, gives
    _group_seed_sample_plain's crossings, fill slots and i_ok."""
    rng = np.random.default_rng(11)
    G, K, L, S, V = 2, 5, 40, 6, 4
    coords, lengths, _ = _random_cases(rng, G * K, L)
    coords = coords.reshape(G, K, L, 2)
    lengths = lengths.reshape(G, K)
    lengths[0, :3] = [L, 2, 0]
    cams = rng.integers(0, V, (G, K)).astype(np.int32)
    cams[1, 0] = -1
    mask = rng.random((G, K)) < 0.85
    mask[1, 0] = False
    F = rng.normal(0, 1.0, (V, V, 3, 3))
    x0 = rng.uniform(40, 280, (V, V, 2, 1))   # each line passes (x0, y0)
    F[..., 2, :] = -(x0[..., 0, :] * F[..., 0, :] + x0[..., 1, :] * F[..., 1, :])
    F = F.astype(np.float32)
    tt = lambda a: torch.as_tensor(a)
    out = tps._group_seed_sample_plain(
        tt(coords), tt(lengths), tt(cams), tt(mask), tt(F), S, 20.0,
        0.965, 5.0)
    s_xy, s_valid = out[0].numpy(), out[3].numpy()
    cs = np.maximum(cams, 0)
    rows, lns, lens, usable = [], [], [], []
    for g in range(G):
        for k in range(K):
            for i in range(S):
                Fk = tt(F[cs[g, k]][cs[g]])                   # [K, 3, 3]
                line = epipolar_line_fma(
                    Fk, tt(np.repeat(s_xy[g, k, i][None], K, 0))).numpy()
                for j in range(K):
                    rows.append(coords[g, j])
                    lns.append(line[j])
                    lens.append(lengths[g, j])
                    usable.append(bool(mask[g, j]) and cams[g, j] != cams[g, k]
                                  and bool(s_valid[g, k, i]))
    xy, seg, t, ok = _model(np.stack(rows), np.array(lens, np.int32),
                            np.stack(lns).astype(np.float32))
    ok &= np.array(usable)[:, None]
    np.testing.assert_array_equal(xy, out[4].numpy().reshape(-1, 2, 2))
    np.testing.assert_array_equal(seg, out[5].numpy().reshape(-1, 2))
    np.testing.assert_array_equal(t, out[6].numpy().reshape(-1, 2))
    np.testing.assert_array_equal(ok, out[7].numpy().reshape(-1, 2))
    assert ok[:, 0].any() and ok[:, 1].any() and not ok[:, 0].all()
