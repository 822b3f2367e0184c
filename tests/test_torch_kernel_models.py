"""CPU models of the kernels' device-side rules, held against the plain
twins and the JAX package:

  * kernels.table_placement, which places K3's, K6's, K7's and K8's
    per-block tables in shared memory (up to 48 KiB, then opted in up to the card's
    limit) or in device memory, at the byte counts of each kernel's
    boundaries on an H100 (232,448 B opt-in limit), in f32 and, for the
    f64 bodies of K3 and K7, in f64;
  * K6's selection, as one thread runs it per (sample, member) pair: a
    scan of the segments below len - 1 that stops at the second crossing,
    then the lowest segments without a crossing as fill slots.  It must
    pick what the reference's stable argsort picks
    (polyline_line_intersections, port and JAX) and what
    _group_seed_sample_plain returns, bit for bit where both sides are
    torch / numpy f32 and within 1e-4 px / 1e-4 against XLA, which
    contracts the crossing arithmetic differently;
  * K5's launch plan (ops/gather.launch_plan) and the kernel's mapping
    of threads to (row, piece) pairs, as csrc/gather_rows.cu runs it
    block by block and tile by tile: every output element is written
    exactly once, from table[rows[s]], for any row width, element size,
    base offset, row count and grid (the grid-stride loop included);
  * K7's launch plan (matching/expansion.launch_plan) and the kernel's
    mapping of pair tasks, warps and lanes to chains and slots, as
    csrc/expand_chains.cu runs it: every chain served once, longest
    first, each slot by one lane; and its run scans
    on the lanes that plan gives them: the one-warp tiles, the 64-slot
    chain over two warps with its exchange at the warp boundary, and the
    single-warp two-slot tile it replaces, against each other and the
    plain version's run test (expansion._monotone_runs).
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
from edgegraph3d_tpu_torch.ops import ba, gather
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


@pytest.mark.parametrize("kernel,size,where", [
    ("K3", 512, "static"), ("K3", 513, "optin"), ("K3", 2421, "optin"),
    ("K3", 2422, "global"),
    ("K7 epipolar", 39, "static"), ("K7 epipolar", 40, "optin"),
    ("K7 epipolar", 49, "optin"), ("K7 epipolar", 186, "optin"),
    ("K7 epipolar", 187, "global"),
    ("K7 closest", 512, "static"), ("K7 closest", 513, "optin"),
    ("K7 closest", 2421, "optin"), ("K7 closest", 2422, "global")])
def test_table_placement_at_f64_boundaries(kernel, size, where):
    """The f64 bodies' tables take 8 bytes an entry: K3's general body
    (the padded loop) stages P alone, 96 V bytes; K7 96 V, or 1,248 V in
    "epipolar" mode, so the full scene's 49 views (61,152 B) opt in."""
    f64 = torch.float64
    n_bytes = {"K3": lambda n: triangulation.gn_table_bytes(n, f64),
               "K7 epipolar": lambda n: expansion.k7_table_bytes(n, True,
                                                                 f64),
               "K7 closest": lambda n: expansion.k7_table_bytes(n, False,
                                                                f64)
               }[kernel](size)
    assert kernels.table_placement(n_bytes, OPTIN) == where
    if kernel == "K7 epipolar" and size == 49:
        assert n_bytes == 61_152


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


def _k5_model(table, rows, plan, blocks):
    """K5 as csrc/gather_rows.cu runs it with `plan` on a grid of
    `blocks`: each block strides over the tiles, stages a tile's row
    indices, and each of its THREADS threads copies UNROLL pieces a pass
    (16 bytes, or one element without `plan.vec`).  Returns the output
    and how often each of its pieces was written."""
    R, W = table.shape
    P, TH, U, TILE = plan.pieces, gather.THREADS, gather.UNROLL, gather.TILE
    src = table.reshape(R, P, -1)
    fixed = P in gather.FIXED_PIECES
    tile_rows = max(1, TILE // P)
    assert tile_rows == plan.tile_rows
    S = len(rows)
    out = np.full((S * P, src.shape[2]), np.nan, table.dtype)
    writes = np.zeros(S * P, np.int64)
    tid = np.arange(TH)
    tiles = -(-S // tile_rows)
    for b in range(blocks):
        for tile in range(b, tiles, blocks):
            first = tile * tile_rows
            s_src = rows[first:first + min(S - first, tile_rows)]
            assert ((s_src >= 0) & (s_src < R)).all()      # the assert
            assert len(s_src) <= (TILE // P if fixed else TILE)  # smem
            n = len(s_src) * P
            assert not fixed or n <= TILE       # one pass in a fixed body
            row, col = (0, 0) if fixed else (tid // P, tid % P)
            for base in range(0, n, TILE):
                for u in range(U):
                    p = base + u * TH + tid
                    if fixed:
                        row, col = p // P, p % P
                    live = p < n
                    out[first * P + p[live]] = src[s_src[row[live]],
                                                   col[live]]
                    writes[first * P + p[live]] += 1
                    if not fixed:
                        row, col = row + TH // P, col + TH % P
                        carry = col >= P
                        row, col = row + carry, col - P * carry
    return out.reshape(S, W), writes


@pytest.mark.parametrize("S", ["0", "1", "31", "33", "tile+1"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 7, 31, 32, 62, 64, 66, 128, 130,
                               2051])
def test_k5_model_writes_every_element_once(W, elem, offset, S):
    """Every output element written once, from table[rows[s]]: with the
    plan's grid on an H100 (132 SMs) and on one block (every tile by
    the grid-stride loop).  `offset` elements off a 16-byte aligned
    base: a misaligned table takes single elements; W = 2051 (a row
    longer than a tile) takes several passes a tile."""
    rng = np.random.default_rng(W * 100 + elem * 10 + offset)
    dt = np.float32 if elem == 4 else np.float64
    R = 37
    table = rng.normal(0, 100.0, (R, W)).astype(dt)
    table_ptr, out_ptr = (1 << 20) + offset * elem, 1 << 21
    probe = gather.launch_plan(W, elem, table_ptr, out_ptr, 1, 132)
    n = probe.tile_rows + 1 if S == "tile+1" else int(S)
    rows = rng.integers(0, R, n)
    plan = gather.launch_plan(W, elem, table_ptr, out_ptr, n, 132)
    assert plan.vec == ((W * elem) % 16 == 0 and offset * elem % 16 == 0)
    assert plan.pieces * (16 // elem if plan.vec else 1) == W
    assert plan.blocks == min(-(-n // plan.tile_rows),
                              gather.BLOCKS_PER_SM * 132)
    for blocks in sorted({plan.blocks, 1}):
        if n == 0:                   # the wrapper launches nothing
            assert plan.blocks == 0
            break
        out, writes = _k5_model(table, rows, plan, blocks)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out, table[rows])



# ----------------------------------------------------------------------
# K7: the launch plan and the run scans
# ----------------------------------------------------------------------

def _k7_tiles(plan):
    """Every tile K7 runs for `plan`, in launch order and, inside a
    launch, in task order (pair task p is block p // 2's pair p % 2):
    (launch, task, bucket, chain or -1, [(warp of the pair, lane,
    slot)]), as csrc expand_chains_kernel maps them."""
    tiles = []
    for li, launch in enumerate(plan.launches):
        order = plan.order[launch.first:]
        b, n = launch.bucket, launch.n
        W, per_task = expansion.TILE_SLOTS[b], expansion.TASK_CHAINS[b]
        assert launch.tasks == -(-n // per_task)
        for p in range(launch.tasks):
            if b == 3:
                units = [(p, [(h, l, 32 * h + l) for h in (0, 1)
                              for l in range(32)])]
            else:
                units = [(p * per_task + h * (32 // W) + tile,
                          [(h, tile * W + tl, tl) for tl in range(W)])
                         for h in (0, 1) for tile in range(32 // W)]
            for i, lanes in units:
                tiles.append((li, p, b, int(order[i]) if i < n else -1,
                              lanes))
    return tiles


def _k7_extents(case, rng):
    edges = [1, 2, 3, 8, 9, 16, 17, 32, 33, 63, 64]
    return {"edges": np.array(edges * 3),
            "random": rng.integers(0, 65, 500),
            "short": rng.integers(1, 9, 300),
            "long only": rng.integers(33, 65, 37),
            "stage-3 like": np.concatenate([
                rng.integers(1, 9, 400), rng.integers(9, 17, 70),
                rng.integers(17, 33, 20), rng.integers(33, 65, 7)]),
            "none": np.zeros(0, np.int64)}[case]


@pytest.mark.parametrize("case", ["edges", "random", "short", "long only",
                                  "stage-3 like", "none"])
def test_k7_plan_serves_every_chain_once(case):
    """Every chain in exactly one tile as wide as its extent, the tiles
    longest bucket first (launches, then tasks), each of the chain's slots
    on one lane, no lane with two slots; one launch per non-empty bucket,
    the 64-slot one first."""
    rng = np.random.default_rng(len(case))
    extent = _k7_extents(case, rng)
    plan = expansion.launch_plan(extent)
    bucket = np.searchsorted(expansion.TILE_SLOTS, extent)
    counts = np.bincount(bucket, minlength=4)
    assert sorted(plan.order) == list(range(len(extent)))
    assert np.all(np.diff(extent[plan.order]) <= 0)           # longest first
    assert [(L.bucket, L.n) for L in plan.launches] == \
        [(b, counts[b]) for b in (3, 2, 1, 0) if counts[b]]
    tiles = _k7_tiles(plan)
    served = [c for *_, c, _ in tiles if c >= 0]
    assert sorted(served) == list(range(len(extent)))
    assert np.all(np.diff([b for _, _, b, _, _ in tiles]) <= 0)
    lanes, slots = set(), set()
    for li, p, b, c, own in tiles:
        for h, l, t in own:
            assert (li, p, h, l) not in lanes
            lanes.add((li, p, h, l))
            if c >= 0 and t < extent[c]:
                slots.add((c, t))
        if c >= 0:
            assert bucket[c] == b and extent[c] <= expansion.TILE_SLOTS[b]
    assert len(slots) == int(extent.sum())


def _up(x, d, W):
    """__shfl_up_sync(x, d, W) over lanes in segments of W."""
    tl = np.arange(len(x)) % W
    return np.where(tl >= d, np.roll(x, d), x)


def _down(x, d, W):
    tl = np.arange(len(x)) % W
    return np.where(tl + d < W, np.roll(x, -d), x)


def _prefix_max(a, W):
    tl = np.arange(len(a)) % W
    off = 1
    while off < W:
        a = np.where(tl >= off, np.maximum(a, _up(a, off, W)), a)
        off *= 2
    return a


def _suffix_min(b, W):
    tl = np.arange(len(b)) % W
    off = 1
    while off < W:
        b = np.where(tl + off < W, np.minimum(b, _down(b, off, W)), b)
        off *= 2
    return b


def _link_terms(pl, pos, ok, pl_up, pos_up, ok_up, first):
    d = pos - pos_up
    base = ~first & (pl == pl_up) & ok & ok_up & (np.abs(d) > 0)
    return base, np.sign(d)


def _run_bounds(pl, pos, ok, T, W):
    """run_bounds<W> over one warp's lanes (tiles of W lanes, slot tl)."""
    tl = np.arange(len(pl)) % W
    base, sg = _link_terms(pl, pos, ok, _up(pl, 1, W), _up(pos, 1, W),
                           _up(ok, 1, W), tl == 0)
    pb = (tl != 0) & _up(base, 1, W)
    link = base & (~pb | (sg == _up(sg, 1, W)))
    st = np.maximum(_prefix_max(np.where(link, -1, tl), W), 0)
    lnext = (tl != W - 1) & _down(link, 1, W)
    return st, _suffix_min(np.where(lnext, T, tl), W)


def _run_bounds_two_slots(pl, pos, ok, T):
    """run_bounds<32, 2>, the one-warp tile of a 33-64-slot chain that
    the pair body replaced: lane l owns slots l and l + 32 ([2, 32]
    arrays)."""
    lane = np.arange(32)
    first = lane == 0
    ppl1 = np.where(first, pl[0, 31], _up(pl[1], 1, 32))
    ppos1 = np.where(first, pos[0, 31], _up(pos[1], 1, 32))
    pok1 = np.where(first, ok[0, 31], _up(ok[1], 1, 32))
    base0, sg0 = _link_terms(pl[0], pos[0], ok[0], _up(pl[0], 1, 32),
                             _up(pos[0], 1, 32), _up(ok[0], 1, 32), first)
    base1, sg1 = _link_terms(pl[1], pos[1], ok[1], ppl1, ppos1, pok1,
                             np.zeros(32, bool))
    pb0 = ~first & _up(base0, 1, 32)
    pb1 = np.where(first, base0[31], _up(base1, 1, 32))
    ps1 = np.where(first, sg0[31], _up(sg1, 1, 32))
    link0 = base0 & (~pb0 | (sg0 == _up(sg0, 1, 32)))
    link1 = base1 & (~pb1 | (sg1 == ps1))
    a0 = _prefix_max(np.where(link0, -1, lane), 32)
    a1 = np.maximum(_prefix_max(np.where(link1, -1, lane + 32), 32), a0[31])
    last = lane == 31
    lnext0 = np.where(last, link1[0], _down(link0, 1, 32))
    lnext1 = ~last & _down(link1, 1, 32)
    b1 = _suffix_min(np.where(lnext1, T, lane + 32), 32)
    b0 = np.minimum(_suffix_min(np.where(lnext0, T, lane), 32), b1[0])
    return (np.stack([np.maximum(a0, 0), np.maximum(a1, 0)]),
            np.stack([b0, b1]))


def _run_bounds_pair(pl, pos, ok, T):
    """run_bounds_pair: warp h's lane l owns slot 32 h + l ([2, 32]
    arrays); each warp runs its part, writes its PairEdge, meets the
    other at the barrier and reads the other's edge."""
    lane = np.arange(32)
    t = np.stack([lane, lane + 32])
    base, sg, link = [], [], []
    for h in (0, 1):
        bh, sh = _link_terms(pl[h], pos[h], ok[h], _up(pl[h], 1, 32),
                             _up(pos[h], 1, 32), _up(ok[h], 1, 32),
                             lane == 0)
        base.append(bh)
        sg.append(sh)
        link.append(bh & ((lane == 0) | ~_up(bh, 1, 32)
                          | (sh == _up(sh, 1, 32))))
    # before the barrier: warp 0's prefix max, warp 1's suffix min (its
    # lane 0 is fixed after the barrier)
    a0 = _prefix_max(np.where(link[0], -1, t[0]), 32)
    b1 = _suffix_min(np.where((lane != 31) & _down(link[1], 1, 32), T, t[1]),
                     32)
    edge0 = dict(pos=pos[0, 31], sg=sg[0][31], pl=pl[0, 31], scan=a0[31],
                 ok=ok[0, 31], base=base[0][31])
    edge1 = dict(pos=pos[1, 0], sg=sg[1][1], pl=pl[1, 0], scan=b1[1],
                 ok=ok[1, 0], base=base[1][1])
    # warp 0, lane 31: slots 32 and 33's links
    d32 = edge1["pos"] - pos[0, 31]
    base32 = (edge1["pl"] == pl[0, 31]) & edge1["ok"] & ok[0, 31] \
        & (np.abs(d32) > 0)
    sg32 = np.sign(d32)
    link32 = base32 & (~base[0][31] | (sg32 == sg[0][31]))
    link33 = edge1["base"] & (~base32 | (edge1["sg"] == sg32))
    tail = min(T if link33 else 32, edge1["scan"])
    lnext = np.where(lane == 31, link32, _down(link[0], 1, 32))
    en0 = np.minimum(_suffix_min(np.where(lnext, T, t[0]), 32), tail)
    st0 = np.maximum(a0, 0)
    # warp 1: slot 32's step from slot 31, the links of slots 32 and 33
    d = pos[1, 0] - edge0["pos"]
    base[1][0] = (edge0["pl"] == pl[1, 0]) & ok[1, 0] & edge0["ok"] \
        & (np.abs(d) > 0)
    sg[1][0] = np.sign(d)
    link[1][0] = base[1][0] & (~edge0["base"] | (sg[1][0] == edge0["sg"]))
    link[1][1] = base[1][1] & (~base[1][0] | (sg[1][1] == sg[1][0]))
    a1 = _prefix_max(np.where(link[1], -1, t[1]), 32)
    st1 = np.maximum(np.maximum(a1, edge0["scan"]), 0)
    en1 = b1.copy()
    en1[0] = min(T if link[1][1] else 32, b1[1])
    return np.stack([st0, st1]), np.stack([en0, en1])


def _k7_scan_case(rng, dtype):
    """Chains of every extent 1-64 (and the bucket edges again), each a
    chain_valid prefix with some empty slots, candidates on few
    polylines with long monotone runs, reversals and repeated
    positions: (extent [C], pl, pos, okc, chain_valid [C, 64])."""
    extent = np.concatenate([np.arange(1, 65),
                             [1, 2, 3, 32, 33, 63, 64, 64, 33, 32]])
    C, T = len(extent), 64
    valid = np.arange(T)[None, :] < extent[:, None]
    valid &= rng.random((C, T)) > 0.08
    valid[np.arange(C), extent - 1] = True
    pl = np.repeat(rng.integers(0, 3, (C, T // 8)), 8, 1)
    pl[rng.random((C, T)) < 0.05] = 9
    step = rng.choice([1.0, 1.0, 1.0, -1.0, 0.0], (C, T)) \
        * rng.uniform(0.1, 2.0, (C, T))
    pos = np.cumsum(step, 1).astype(dtype)
    cok = rng.random((C, T)) < 0.85
    return extent, pl.astype(np.int32), pos, cok & valid, valid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(6))
def test_k7_pair_scan_matches_one_tile_and_plain(seed, dtype):
    """K7's run scans, each chain on the lanes launch_plan gives it: run
    start and end of the 64-slot pair equal run_bounds<32, 2>'s (the
    single-warp tile it replaces) on every slot, and every tile's run
    length and end-touch equal the plain version's run test (its
    cont decision too, short chains included), for extents 1-64."""
    rng = np.random.default_rng(seed)
    extent, pl, pos, okc, valid = _k7_scan_case(rng, dtype)
    C, T = valid.shape
    run_len, touches = (a.numpy() for a in expansion._monotone_runs(
        torch.as_tensor(pl), torch.as_tensor(pos), torch.as_tensor(okc),
        torch.as_tensor(valid)))
    short = valid.sum(1) <= 2
    cont_plain = (run_len >= np.where(touches, 2, 3)) | short[:, None]
    plan = expansion.launch_plan(extent)
    pairs = across = 0
    for _, _, b, c, lanes in _k7_tiles(plan):
        if c < 0:
            continue
        t = np.array([s for _, _, s in lanes])
        W = expansion.TILE_SLOTS[b]
        args = (pl[c, t], pos[c, t], okc[c, t], T)
        if W == 64:
            pairs += 1
            # a run through slots 31 and 32 (both ok, one run length)
            across += int(run_len[c, 31] > 1 and okc[c, 32]
                          and run_len[c, 32] == run_len[c, 31])
            two = [a.reshape(2, 32) for a in args[:3]]
            st, en = (a.reshape(-1) for a in _run_bounds_pair(*two, T))
            st2, en2 = (a.reshape(-1)
                        for a in _run_bounds_two_slots(*two, T))
            np.testing.assert_array_equal(st, st2)
            np.testing.assert_array_equal(en, en2)
        else:
            st, en = _run_bounds(*args, W)
        vm = np.flatnonzero(valid[c, t])
        first_valid = vm[0] if len(vm) else T + 1
        last_valid = vm[-1] if len(vm) else -1
        ok = okc[c, t]
        rl = np.where(ok, en - st + 1, 0)
        tch = (st <= first_valid) | (en >= last_valid)
        np.testing.assert_array_equal(rl, run_len[c, t])
        np.testing.assert_array_equal(tch[ok], touches[c, t][ok])
        cont = (rl >= np.where(tch, 2, 3)) | (len(vm) <= 2)
        np.testing.assert_array_equal(cont[ok], cont_plain[c, t][ok])
    assert pairs == int((extent > 32).sum())
    assert across and (run_len >= 3).any() and short.any()
