"""Native (C++) host-runtime components, loaded via ctypes.

The reference's runtime outside the compute kernels is C++; here the
host-side passes that cannot ride the device run in C++ compiled on
first use with g++: the sequential chain tracing of PLG extraction
(`extraction.cpp`), the sequential first-claim pass of the density
filter (`density.cpp`) and the sequential local-moving pass of host
Louvain (`louvain.cpp`, built with `-ffp-contract=off` so that its
float64 gains round as numpy's do).

Unlike the JAX package's loader, this one never returns None: a build or
load that fails raises RuntimeError with g++'s output, and the caller
has no other path.  The JAX package falls back to a numpy formulation of
extraction whose polylines differ (PARITY_EXTRACTION.md: exact polylines
agree on 0.7025 of cases), so a silent switch to it would change the
reconstruction.  Concurrent first uses (several
processes, e.g. test workers) are safe: each compiles into a file of its
own under an inter-process lock held around "is it built? else build",
so a second process waits and loads the finished library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_DIR = os.path.dirname(__file__)

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64


class Library:
    """One C++ source built into one shared library at first use.

    `src` and `so` are read at build time (tests point them at a fresh
    directory); the lock file is `so + ".lock"`.  `entries` maps each
    exported C function to (restype, argtypes); `flags` are added to
    g++'s command line."""

    def __init__(self, name: str, entries: dict, flags: tuple = ()):
        self.name = name
        self.src = os.path.join(_DIR, f"{name}.cpp")
        self.so = os.path.join(_DIR, f"_{name}.so")
        self.entries = entries
        self.flags = tuple(flags)
        self.lib = None
        self._lock = threading.Lock()

    def get(self):
        """ctypes handle to the library (built on first use).  Raises
        RuntimeError when it cannot be built or loaded."""
        with self._lock:
            if self.lib is None:
                so = _build(self.src, self.so, self.name, self.flags)
                try:
                    lib = ctypes.CDLL(so)
                    for entry, (restype, argtypes) in self.entries.items():
                        fn = getattr(lib, entry)
                        fn.restype = restype
                        fn.argtypes = argtypes
                except (OSError, AttributeError) as e:
                    raise RuntimeError(
                        f"native {self.name} library {so} did not load: "
                        f"{e}") from e
                self.lib = lib
            return self.lib


def _build(src: str, so: str, name: str, flags: tuple) -> str:
    """Compile `src` into `so` unless `so` is newer; returns `so`."""
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so) and os.path.getmtime(so) >= \
                os.path.getmtime(src):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", *flags, src, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native {name} build failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"native {name} build failed ({res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
        return so


EXTRACTION = Library("extraction", {"eg3d_extract_chains": (ctypes.c_int, [
    _u8p, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int,
    _f32p, _i64, _i64p, _i64, _i64p, _i64p,
])})

#: keep[N] from obs_xy [N,V,2], obs_mask [N,V], N, V, width, height, cell
DENSITY = Library("density", {
    f"eg3d_density_keep_{t}": (None, [xyp, _u8p, _i64, _i64, _i64, _i64,
                                      _i64, _u8p])
    for t, xyp in (("f32", _f32p), ("f64", _f64p))})

#: labels [n] and counts [3] from indptr [n + 1], nbr, w, deg [n], n,
#: two_m; segment sums as np.add.reduceat gives them, for the tests
LOUVAIN = Library("louvain", {
    "eg3d_louvain_one_level": (None, [_i64p, _i64p, _f64p, _f64p, _i64,
                                      ctypes.c_double, _i64p, _i64p]),
    "eg3d_segment_sums": (None, [_f64p, _i64p, _i64, _i64, _f64p]),
}, flags=("-ffp-contract=off",))


def get_extraction_lib():
    """The native extraction library (`extraction.cpp`)."""
    return EXTRACTION.get()


def get_density_lib():
    """The native density filter library (`density.cpp`)."""
    return DENSITY.get()


def get_louvain_lib():
    """The native Louvain local-moving library (`louvain.cpp`)."""
    return LOUVAIN.get()
