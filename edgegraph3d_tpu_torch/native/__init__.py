"""Native (C++) host-runtime components, loaded via ctypes.

The reference's runtime outside the compute kernels is C++; here the
host-side preprocessing that cannot ride XLA (sequential chain tracing,
graph surgery) has a C++ fast path compiled on first use with g++.
Python implementations remain as behavior-defining fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "extraction.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_extraction.so")


def _build() -> str | None:
    try:
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return _SO
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", _SO + ".tmp"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(_SO + ".tmp", _SO)
        return _SO
    except Exception:
        return None


def get_extraction_lib():
    """ctypes handle to the native extraction library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            fn = lib.eg3d_extract_chains
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB
