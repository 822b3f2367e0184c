"""The port's native loader (edgegraph3d_tpu_torch/native).

The port builds each C++ library (extraction, density, louvain) under
an inter-process lock into a file of its own per process, and raises on
a failed build or load: extraction, the density filter and host
Louvain's sequential local-moving pass have no other path.  The JAX package keeps its own loader, which can return None when
several processes build at once; `require_jax_native_lib` makes sure the
reference side of a parity test runs its native path too.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from edgegraph3d_tpu_torch import native
from edgegraph3d_tpu_torch.config import EdgeGraphConfig
from edgegraph3d_tpu_torch.core import synthetic
from edgegraph3d_tpu_torch.matching import communities
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
    import subprocess
    import sys
    sys.path.insert(0, {root!r})
    from edgegraph3d_tpu_torch import native
    builds = []
    run = subprocess.run
    subprocess.run = lambda *a, **k: builds.append(1) or run(*a, **k)
    lib = getattr(native, sys.argv[1])
    lib.src, lib.so = sys.argv[2], sys.argv[3]
    print("LOADED", lib.get()._name, "BUILDS", len(builds))
""")


@pytest.fixture(params=["EXTRACTION", "DENSITY", "LOUVAIN"], ids=str.lower)
def fresh_paths(request, tmp_path, monkeypatch):
    """A library's source copied into an empty directory, and the
    loader pointed at it: (library attribute, library, src, so)."""
    attr = request.param
    lib = getattr(native, attr)
    src = tmp_path / os.path.basename(lib.src)
    shutil.copy(lib.src, src)
    so = tmp_path / os.path.basename(lib.so)
    monkeypatch.setattr(lib, "src", str(src))
    monkeypatch.setattr(lib, "so", str(so))
    monkeypatch.setattr(lib, "lib", None)
    return attr, lib, src, so


def test_concurrent_first_builds_all_load(fresh_paths):
    """Four processes build the library at once into a fresh directory:
    every one of them loads it, g++ runs once among them, and no
    temporary file is left."""
    attr, _, src, so = fresh_paths
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD.format(root=ROOT), attr, str(src),
         str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    builds = 0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert f"LOADED {so}" in out
        builds += int(out.split("BUILDS")[1])
    assert builds == 1
    left = sorted(os.listdir(so.parent))
    assert left == sorted([so.name, so.name + ".lock", src.name])


def test_failed_build_raises(fresh_paths):
    """A source g++ refuses raises RuntimeError with g++'s output, and
    leaves no library and no temporary file."""
    _, lib, src, so = fresh_paths
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed") as err:
        lib.get()
    assert "error" in str(err.value) and str(src) in str(err.value)
    assert lib.lib is None and not so.exists()
    assert [f for f in os.listdir(so.parent) if f.endswith(".tmp")] == []


def test_rebuilds_when_source_is_newer(fresh_paths):
    _, lib, src, so = fresh_paths
    lib.get()
    first = so.stat().st_mtime
    os.utime(src, (first + 10, first + 10))
    lib.lib = None
    lib.get()
    assert so.stat().st_mtime > first


@pytest.fixture(scope="module")
def edge_image():
    _, imgs, _ = synthetic.make_scene(n_cams=2, n_refpoints_per_curve=8,
                                      width=320, height_px=240, focal=400.0,
                                      seed=5)
    return imgs[0]


CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=64)


#: a small graph whose sequential Louvain pass has work to do
_EDGES = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3)]


@pytest.mark.parametrize("getter,call", [
    ("get_extraction_lib",
     lambda image: extraction.extract_plg(image, CFG)),
    ("get_louvain_lib",
     lambda image: communities.louvain_host(np.array(_EDGES), np.ones(7),
                                            6, parallel=False)),
], ids=["extraction", "louvain"])
def test_native_failure_raises_not_falls_back(edge_image, monkeypatch,
                                              getter, call):
    """extract_plg and host Louvain's sequential pass raise when their
    library is unavailable; neither has another path to fall back to."""
    def broken():
        raise RuntimeError("native library build failed (1)")

    monkeypatch.setattr(native, getter, broken)
    with pytest.raises(RuntimeError, match="build failed"):
        call(edge_image)


def test_louvain_is_built_without_contraction(tmp_path, monkeypatch):
    """g++ builds the Louvain pass with -ffp-contract=off, so that no
    fused multiply-add rounds its gains otherwise than numpy does."""
    lib = native.LOUVAIN
    src = tmp_path / os.path.basename(lib.src)
    shutil.copy(lib.src, src)
    monkeypatch.setattr(lib, "src", str(src))
    monkeypatch.setattr(lib, "so", str(tmp_path / os.path.basename(lib.so)))
    monkeypatch.setattr(lib, "lib", None)
    cmds, run = [], subprocess.run
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **k: cmds.append(cmd) or run(cmd, **k))
    lib.get()
    assert len(cmds) == 1 and "-ffp-contract=off" in cmds[0]


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
