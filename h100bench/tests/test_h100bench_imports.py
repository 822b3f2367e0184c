"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program either (top-level module
names compared whole: edgegraph3d_tpu_torch is not edgegraph3d_tpu)."""

import json
import os
import subprocess
import sys

from h100bench.tests.conftest import ROOT

PROBE = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
for m in {mods!r}:
    __import__(m)
if {readers}:
    from h100bench import run
    for f in sorted(glob.glob(os.path.join({root!r}, "h100bench", "metrics",
                                           "*.py"))):
        run.load_reader(os.path.basename(f)[:-3])
if {program}:
    from edgegraph3d_tpu_torch import pipeline, kernels  # what run.py calls
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(mods, readers=False, program=False):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, mods=mods,
                                            readers=readers,
                                            program=program)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = loaded(["h100bench.run", "h100bench.reference", "h100bench.scenes",
                  "h100bench.devtrace", "h100bench.readers",
                  "h100bench.faults", "h100bench.control"],
                 readers=True, program=True)
    assert not top & {"jax", "jaxlib", "flax", "edgegraph3d_tpu"}
    assert "edgegraph3d_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = loaded(["h100bench.reference", "h100bench.scenes"])
    assert not top & {"jax", "jaxlib", "flax", "edgegraph3d_tpu",
                      "edgegraph3d_tpu_torch"}
