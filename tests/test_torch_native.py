"""The port's native extraction loader (edgegraph3d_tpu_torch/native).

The port builds the C++ extraction library under an inter-process lock
into a file of its own per process, and raises on a failed build or
load instead of falling back to the numpy twin.  The JAX package keeps
its own loader, which can return None when several processes build at
once; `require_jax_native_lib` makes sure the reference side of a parity
test runs its native path too.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from edgegraph3d_tpu_torch import native
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.plgs import extraction

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def require_jax_native_lib(tries: int = 120, wait_s: float = 0.5) -> None:
    """Assert that the JAX package's native extraction library loads.

    Its loader returns None (and caches that for the process) when it
    loses a build race with another process; then the reference would
    run the numpy twin, whose polylines differ from the C++ ones.  Reset
    its cache and retry while the other process's build finishes."""
    from edgegraph3d_tpu import native as jnative
    for _ in range(tries):
        if jnative.get_extraction_lib() is not None:
            return
        jnative._TRIED = False
        time.sleep(wait_s)
    raise AssertionError("the JAX package's native extraction library did "
                         "not load: its parity runs would use the numpy twin")


_LOAD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from edgegraph3d_tpu_torch import native
    native._SRC, native._SO = sys.argv[1], sys.argv[2]
    lib = native.get_extraction_lib()
    print("LOADED", lib._name)
""")


@pytest.fixture
def fresh_paths(tmp_path, monkeypatch):
    """The library's source copied into an empty directory, and the
    loader pointed at it."""
    src = tmp_path / "extraction.cpp"
    shutil.copy(native._SRC, src)
    so = tmp_path / "_extraction.so"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_LIB", None)
    return src, so


def test_concurrent_first_builds_all_load(fresh_paths):
    """Four processes build the library at once into a fresh directory:
    every one of them loads it, and no temporary file is left."""
    src, so = fresh_paths
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD.format(root=ROOT), str(src), str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert f"LOADED {so}" in out
    left = sorted(os.listdir(so.parent))
    assert left == ["_extraction.so", "_extraction.so.lock", "extraction.cpp"]


def test_failed_build_raises(fresh_paths):
    src, so = fresh_paths
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native.get_extraction_lib()
    assert native._LIB is None and not so.exists()
    assert [f for f in os.listdir(so.parent) if f.endswith(".tmp")] == []


def test_rebuilds_when_source_is_newer(fresh_paths):
    src, so = fresh_paths
    native.get_extraction_lib()
    first = so.stat().st_mtime
    os.utime(src, (first + 10, first + 10))
    native._LIB = None
    native.get_extraction_lib()
    assert so.stat().st_mtime > first


@pytest.fixture(scope="module")
def edge_image():
    _, imgs, _ = synthetic.make_scene(n_cams=2, n_refpoints_per_curve=8,
                                      width=320, height_px=240, focal=400.0,
                                      seed=5)
    return imgs[0]


CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=64)


def test_native_failure_raises_not_falls_back(edge_image, monkeypatch):
    """use_native=True (the default) raises when the library is
    unavailable; it never runs the numpy twin instead."""
    def broken():
        raise RuntimeError("native extraction build failed (1)")

    def twin_called(*a, **k):
        raise AssertionError("the numpy twin ran on the native path")

    monkeypatch.setattr(native, "get_extraction_lib", broken)
    monkeypatch.setattr(extraction, "build_pixel_edges", twin_called)
    with pytest.raises(RuntimeError, match="build failed"):
        extraction.extract_plg(edge_image, CFG)


def test_numpy_twin_runs_only_when_asked(edge_image, monkeypatch):
    """use_native=False runs the numpy twin without touching the native
    library; the default path runs the C++ chains."""
    twin_edges = extraction.build_pixel_edges
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return twin_edges(*a, **k)

    monkeypatch.setattr(extraction, "build_pixel_edges", spy)
    nat = extraction.extract_plg(edge_image, CFG)
    assert calls == []

    def no_native(*a, **k):
        raise AssertionError("the native path ran with use_native=False")

    monkeypatch.setattr(extraction, "extract_chains_native", no_native)
    twin = extraction.extract_plg(edge_image, CFG, use_native=False)
    assert calls == [1]
    assert (twin.length >= 2).sum() > 5 and (nat.length >= 2).sum() > 5


def test_jax_helper_recovers_from_a_lost_race(monkeypatch):
    """A JAX loader that returned None once (a lost build race) is reset
    and retried until it loads."""
    from edgegraph3d_tpu import native as jnative
    real = jnative.get_extraction_lib
    calls = []

    def flaky():
        calls.append(jnative._TRIED)
        return None if len(calls) == 1 else real()

    monkeypatch.setattr(jnative, "get_extraction_lib", flaky)
    require_jax_native_lib(wait_s=0.0)
    assert len(calls) == 2
