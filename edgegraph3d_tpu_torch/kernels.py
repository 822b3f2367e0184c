"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

All four kernels of the stage-3 main path live in one shared library
with a plain C interface, compiled by nvcc for Hopper (sm_90a) at first
use into `_build/` and loaded with ctypes.  The library is rebuilt when
any source is newer than it.  Each C entry launches on the caller's
stream and returns `cudaGetLastError()`; `check()` raises on non-zero.

`LAUNCHES` holds one plain-integer launch count per kernel.  The
wrappers (detection.grid_topm_query / epipolar_topm_query,
triangulation.triangulate_gn, following.follow_walk) add one right after
each launch of their kernel and nowhere else.

Arithmetic is compiled with `--fmad=false`: the plain-torch twins round
after every multiply and add, and contracting `a*b+c` into one FMA would
shift values that sit on the pipeline's thresholds (MSE gates, walk
bounds, quasi-parallel cos).  IEEE division and sqrt stay nvcc's
defaults (`-prec-div=true -prec-sqrt=true`).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(_DIR, "_build")
LIB_PATH = os.path.join(BUILD, "libeg3d_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

KERNEL_NAMES = ("grid_topm_query", "epipolar_topm_query", "triangulate_gn",
                "follow_walk")
LAUNCHES = {k: 0 for k in KERNEL_NAMES}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # grids, V, GH, GW, Kc, view, pts, Q, cell, radius, M,
    # pl, seg, t, xy, dist, valid, stream
    "eg3d_grid_topm": [_P, _I, _I, _I, _I, _P, _P, _I, _F, _F, _I,
                       _P, _P, _P, _P, _P, _P, _P],
    # grids, V, GH, GW, Kc, view, pts, lines, radius, Q, cell, M,
    # use_excl, excl_cos, pl, seg, t, xy, dist, valid, stream
    "eg3d_epipolar_topm": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _F, _I,
                           _I, _F, _P, _P, _P, _P, _P, _P, _P],
    # P_mats, V, cams, xy, mask, N, O, X0 (nullable), max_iters,
    # epsilon, accept_mse, det_min, X, mse, valid, stream
    "eg3d_triangulate_gn": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _F, _F, _F,
                            _P, _P, _P, _P],
    # coords, lengths, V, P, L, F_table, cams, pl, seg0, t0, xy0, dirs,
    # active0, S, T, step, min_d, max_d, qcos, qdist,
    # obs, seg, t, alive, stream
    "eg3d_follow_walk": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _F, _F, _F, _F, _F,
                         _P, _P, _P, _P, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every
    source.  Returns the library path."""
    srcs = sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in srcs)):
        return LIB_PATH
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    if verbose:
        print(res.stderr)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(t, name: str, dtype, shape=None) -> None:
    """Wrapper-side argument check for a CUDA launch: device, dtype,
    contiguity and (optionally) shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
