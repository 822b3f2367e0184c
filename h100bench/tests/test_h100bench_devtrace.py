"""Device busy time as the union of intervals, idle gaps and their
labels, on hand-made traces."""

import numpy as np

from h100bench import devtrace


def test_union_merges_overlapping_streams():
    s = np.array([0, 5, 2, 20, 21, 30])
    e = np.array([4, 8, 6, 25, 22, 31])
    bs, be = devtrace.union(s, e)
    assert bs.tolist() == [0, 20, 30] and be.tolist() == [8, 25, 31]


def test_busy_counts_overlap_once_and_gaps_are_labelled():
    ms = 1_000_000
    # two kernels on two streams overlap for 5 ms; a copy later
    dev = [("k_a", 10 * ms, 30 * ms), ("k_b", 25 * ms, 40 * ms),
           ("Memcpy HtoD (Pageable -> Device)", 70 * ms, 80 * ms)]
    cpu = [("aten::nonzero", 42 * ms, 60 * ms),
           ("cudaStreamSynchronize", 45 * ms, 55 * ms),
           ("aten::copy_", 69 * ms, 81 * ms)]
    t = devtrace.reduce_events(dev, cpu, (0, 100 * ms))
    assert abs(t.window_s - 0.1) < 1e-12
    assert abs(t.busy_s - 0.040) < 1e-12     # 30 + 10, not 35 + 10
    assert abs(t.device_s["k_a"] - 0.020) < 1e-12
    gaps = dict((round(s, 6), n) for n, s in t.gaps)
    # 40-70: the innermost CPU op at 55 ms; 0-10 and 80-100: none (host)
    assert gaps == {0.03: "cudaStreamSynchronize", 0.01: "host",
                    0.02: "host"}
    assert sorted(s for _, s in t.gaps) == [0.01, 0.02, 0.03]


def test_gap_at_the_middle_of_an_inner_op():
    ms = 1_000_000
    dev = [("k", 0, 10 * ms), ("k", 40 * ms, 50 * ms)]
    cpu = [("aten::item", 12 * ms, 38 * ms),
           ("cudaStreamSynchronize", 20 * ms, 30 * ms)]
    t = devtrace.reduce_events(dev, cpu, (0, 50 * ms))
    assert t.gaps == [("cudaStreamSynchronize", 0.03)]
    assert abs(1 - t.busy_s / t.window_s - 0.6) < 1e-12


def test_no_device_entry():
    t = devtrace.reduce_events([], [], (0, 5_000_000))
    assert t.busy_s == 0 and t.n_device == 0
    assert t.gaps == [("host", 0.005)]


def test_breakdown_keeps_the_largest():
    ms = 1_000_000
    traces = [devtrace.reduce_events(
        [(f"k{i}", 0, (i + 1) * ms) for i in range(12)], [], (0, 20 * ms))
        for _ in range(2)]
    b = devtrace.breakdown(traces)
    assert [n for n, _ in b["device_ops"]] == [f"k{i}" for i in
                                              range(11, 1, -1)]
    assert abs(b["device_ops"][0][1] - 0.024) < 1e-12
    assert len(b["idle_gaps"]) == 2
