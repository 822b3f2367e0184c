"""Native (C++) host-runtime components, loaded via ctypes.

The reference's runtime outside the compute kernels is C++; here the
host-side preprocessing that cannot ride the device (sequential chain
tracing, graph surgery) has a C++ fast path compiled on first use with
g++.

Unlike the JAX package's loader, this one never returns None: a build or
load that fails raises RuntimeError with g++'s output.  The numpy twin in
plgs/extraction.py computes different polylines (PARITY_EXTRACTION.md:
exact polylines agree on 0.7025 of cases), so a silent switch to it
would change the reconstruction.  Concurrent first uses (several
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

_LOCK = threading.Lock()
_LIB = None

#: source and library paths, read at call time (tests point them at a
#: fresh directory); the lock file is `_SO + ".lock"`
_SRC = os.path.join(os.path.dirname(__file__), "extraction.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_extraction.so")

_ARGTYPES = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
]


def _build() -> str:
    """Compile _SRC into _SO unless _SO is newer; returns _SO."""
    src, so = _SRC, _SO
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so) and os.path.getmtime(so) >= \
                os.path.getmtime(src):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native extraction build failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"native extraction build failed ({res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
        return so


def get_extraction_lib():
    """ctypes handle to the native extraction library (built on first
    use).  Raises RuntimeError when it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = _build()
            try:
                lib = ctypes.CDLL(so)
                fn = lib.eg3d_extract_chains
            except (OSError, AttributeError) as e:
                raise RuntimeError(
                    f"native extraction library {so} did not load: {e}") \
                    from e
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES
            _LIB = lib
        return _LIB
