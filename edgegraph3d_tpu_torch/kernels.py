"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

All nine kernels (K1-K7 of the main path, K8 of joint BA and K9 of
OpenCV's FM_LMEDS F table) live in one shared library with a plain C
interface, compiled by nvcc for Hopper (sm_90a) at first use into
`_build/` and loaded with ctypes.  The
library is rebuilt when any source is newer than it.  Each C entry
launches on the caller's stream and returns `cudaGetLastError()`;
`check()` raises on non-zero.  Every wrapper calls its C entry inside
`on_device(t)`, so that the launch, `cudaFuncSetAttribute` and
`cudaGetDevice` in the entry act on the device of the tensors it was
given, not on the thread's current device (a mesh's shards sit on
`cuda:1` and above while `cuda:0` is current).

`LAUNCHES[name][dtype]` counts the launches of kernel `name`'s
instantiation for one compute type ("float32", or "float64" for the f64
bodies of K1-K5 and K7 that EdgeGraphConfig(dtype="float64") runs, and
for K9, which computes in float64 only);
`launch_totals()` sums them per kernel.  The wrappers
(detection.grid_topm_query / epipolar_topm_query,
triangulation.triangulate_gn, following.follow_walk, gather.gather_rows,
polyline_stages.group_seed_sample, expansion.expand_chains_compact,
ba.ba_blocks, lmeds7.lmeds7_fit) call `count_launch` right after each
launch of their kernel and nowhere else.

A wrapper picks its instantiation from the promoted type of its float
inputs, as jnp.result_type would under x64 (`compute_dtype`); it widens
an f32 input to f64 only where the JAX package promotes it, never
narrows f64 to f32, and raises for a type it has no instantiation of
(`require_float`).

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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC"]

#: the kernels every default run_pipeline call launches (K1-K7)
MAIN_PATH_KERNELS = ("grid_topm_query", "epipolar_topm_query",
                     "triangulate_gn", "follow_walk", "gather_rows",
                     "group_seed_sample", "expand_chains")
#: K8 runs only with joint BA (config.ba_steps > 0), K9 (float64 only)
#: only with fmat_source="opencv_lmeds"
KERNEL_NAMES = MAIN_PATH_KERNELS + ("ba_blocks", "lmeds7_fit")
#: the kernels with a float64 instantiation (the stage-3 path's)
F64_KERNELS = ("grid_topm_query", "epipolar_topm_query", "triangulate_gn",
               "follow_walk", "gather_rows", "expand_chains")
DTYPES = ("float32", "float64")
LAUNCHES = {k: {d: 0 for d in DTYPES} for k in KERNEL_NAMES}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_int64
_SIGNATURES = {
    # device, bytes out
    "eg3d_smem_optin": [_I, _P],
    # grids, V, GH, GW, Kc, view, pts, Q, cell, radius, M, n_rows,
    # pl, seg, t, xy, dist, valid, stream
    "eg3d_grid_topm": [_P, _I, _I, _I, _I, _P, _P, _I, _F, _F, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P],
    # grids, V, GH, GW, Kc, view, pts, lines, radius, order (nullable),
    # n_rows, tile_rows, Q, cell, M, body, min_share, use_excl, excl_cos,
    # pl, seg, t, xy, dist, valid, stream
    "eg3d_epipolar_topm": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                           _I, _F, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P,
                           _P, _P],
    # P_mats, V, cams, xy, mask, N, O, X0 (nullable), max_iters,
    # epsilon, accept_mse, det_min, place, X, mse, valid, stream
    "eg3d_triangulate_gn": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _F, _F, _F,
                            _I, _P, _P, _P, _P],
    # V, O -> dynamic shared-memory bytes of a block of K3's general body
    "eg3d_triangulate_gn_smem": [_I, _I],
    # coords, lengths, V, P, L, F_table, P_mats, cams, pl, seg0, t0, xy0,
    # dirs, active0, X0 (nullable), S, T, step, min_d, max_d, qcos, qdist,
    # gn_iters, epsilon, accept_mse, det_min, counter,
    # valid, n_steps, X, obs, seg, t, final_seg, final_t, stream
    "eg3d_follow_walk": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _F, _F, _F, _F, _F,
                         _I, _F, _F, _F, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # table, R, W, rows, idx64 (rows int64, else int32), S, out, vec
    # (16-byte pieces), blocks, stream
    "eg3d_gather_rows": [_P, _L, _L, _P, _I, _L, _P, _I, _I, _P],
    "eg3d_gather_rows_f64": [_P, _L, _L, _P, _I, _L, _P, _I, _I, _P],
    # K, L, S -> bytes of one block's member table
    "eg3d_group_seed_sample_smem": [_I, _I, _I],
    # coords, lengths, cams, mask, G, K, L, F_table, V, S, spacing, qcos,
    # qdist, place, s_xy, s_seg, s_t, s_valid, i_xy, i_seg, i_t, i_ok,
    # stream
    "eg3d_group_seed_sample": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _F,
                               _F, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P],
    # grids, V, GH, GW, Kc, cell, P_mats, F_table, obs3, cams3, slot_k,
    # chain_valid, order, bucket, n, T, Omax, tol, epipolar, qp_cos,
    # gn_iters, gn_eps, accept_mse, det_min, place, X, cam_buf, obs_x,
    # obs_y, out_xy, out_ok, stream
    "eg3d_expand_chains": [_P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _I, _F, _I, _F, _I, _F, _F, _F,
                           _I, _P, _P, _P, _P, _P, _P, _P],
    # V, epipolar, pairs -> shared-memory bytes of a K7 block
    "eg3d_expand_chains_smem": [_I, _I, _I],
    # V -> shared-memory bytes of a K8 point block with its tables
    "eg3d_ba_blocks_smem": [_I],
    # K, R, t, V, X, cam, xy, mask, N, O, damping, slot, start, first,
    # max_count, chunks, place, Hinv, gx, B, A, partial, Hcc, gc, rhs,
    # rsum, nobs, stream
    "eg3d_ba_blocks": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _F,
                       _P, _P, _P, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # n_stage -> shared-memory bytes of a K9 scoring block
    "eg3d_lmeds7_smem": [_L],
    # x1, x2, N, n_stage, samples, n_common, P, T, place, min_valid,
    # models, ok, counts, F, score, best, valid, inliers, stream
    "eg3d_lmeds7_fit": [_P, _P, _L, _L, _P, _P, _L, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _f64(name: str) -> list:
    """The f32 entry `name`'s argument types with every float made a
    double: its f64 entry takes its scalars in double."""
    return [_D if t is _F else t for t in _SIGNATURES[name]]


_K2_F64 = _f64("eg3d_epipolar_topm")
_SIGNATURES.update({
    "eg3d_grid_topm_f64": _f64("eg3d_grid_topm"),
    # eg3d_epipolar_topm's, with pts_f64 after pts (double or float points)
    "eg3d_epipolar_topm_f64": _K2_F64[:7] + [_I] + _K2_F64[7:],
    "eg3d_triangulate_gn_f64": _f64("eg3d_triangulate_gn"),
    "eg3d_triangulate_gn_smem_f64": [_I, _I],
    "eg3d_follow_walk_f64": _f64("eg3d_follow_walk"),
    "eg3d_expand_chains_f64": _f64("eg3d_expand_chains"),
    "eg3d_expand_chains_smem_f64": [_I, _I, _I],
})


def reset_launch_counts() -> None:
    for counts in LAUNCHES.values():
        for d in counts:
            counts[d] = 0


def count_launch(name: str, dtype) -> None:
    """One launch of kernel `name`'s instantiation for `dtype` (a torch
    dtype or its name)."""
    LAUNCHES[name][str(dtype).replace("torch.", "")] += 1


def launch_totals() -> dict:
    """Launches per kernel, over all its instantiations."""
    return {k: sum(c.values()) for k, c in LAUNCHES.items()}


def compute_dtype(*tensors):
    """The promoted floating type of the given tensors (None entries
    skipped), torch.promote_types pairwise, as jnp.result_type promotes
    arrays under x64."""
    import torch
    out = None
    for t in tensors:
        if t is not None:
            out = t.dtype if out is None else torch.promote_types(out, t.dtype)
    return out


def require_float(dtype, name: str):
    """`dtype` if a kernel has an instantiation for it (float32, float64),
    else a TypeError naming the kernel: no wrapper falls back to its
    plain version on a CUDA tensor."""
    import torch
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: no kernel instantiation for {dtype}")
    return dtype


#: dynamic shared memory a block may take without opting in
SMEM_STATIC_BYTES = 48 * 1024
#: an H100's cudaDevAttrMaxSharedMemoryPerBlockOptin
H100_SMEM_OPTIN_BYTES = 232_448
#: where a launch places a per-block table; the index is the `place`
#: argument of the C entries that stage one (K3's general body, K6, K7,
#: K8's point kernel, K9's scoring kernel)
PLACEMENTS = ("static", "optin", "global")
#: the placement each of those kernels' last launch used (for logs)
LAST_PLACEMENT: dict[str, str] = {}

_OPTIN: dict[int, int] = {}


def table_placement(n_bytes: int, optin_bytes: int) -> str:
    """Where a launch puts a table of `n_bytes` that its blocks read:
    "static" (dynamic shared memory, up to 48 KiB), "optin" (shared
    memory after cudaFuncSetAttribute(MaxDynamicSharedMemorySize), up to
    the device's opt-in limit `optin_bytes`), else "global" (the
    kernel's body that reads the same table from device memory through
    the read-only path).  Decided from sizes known before the launch."""
    if n_bytes <= SMEM_STATIC_BYTES:
        return "static"
    if n_bytes <= optin_bytes:
        return "optin"
    return "global"


def smem_optin_bytes(device) -> int:
    """The device's opt-in shared-memory limit per block (cached)."""
    index = device.index if device.index is not None else 0
    if index not in _OPTIN:
        out = ctypes.c_int(0)
        check(lib().eg3d_smem_optin(index, ctypes.addressof(out)),
              "smem_optin")
        _OPTIN[index] = out.value
    return _OPTIN[index]


def place(name: str, n_bytes: int, device) -> int:
    """table_placement on `device`, recorded in LAST_PLACEMENT[name];
    returns the C entries' `place` code."""
    where = table_placement(n_bytes, smem_optin_bytes(device))
    LAST_PLACEMENT[name] = where
    return PLACEMENTS.index(where)


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
    source: one nvcc per source, all started together, then one link.
    Returns the library path."""
    srcs = sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in srcs)):
        return LIB_PATH
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", obj, src]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    steps = []
    for obj, cmd, proc in jobs:
        _, err = proc.communicate()
        steps.append((cmd, proc.returncode, err))
    tmp = f"{LIB_PATH}.{tag}"
    if all(rc == 0 for _, rc, _ in steps):
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(o for o, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, res.returncode, res.stderr))
    for obj, _, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    for cmd, rc, err in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")
        if verbose:
            print(err)
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


def on_device(t):
    """Context manager that makes t's CUDA device the current one for a
    C entry's launch (a launch goes to the current device)."""
    import torch
    return torch.cuda.device(t.device)


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(t, name: str, dtype, shape=None, align: int = 1) -> None:
    """Wrapper-side argument check for a CUDA launch: device, dtype,
    contiguity, (optionally) shape, and the data pointer's alignment in
    bytes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected data aligned to {align} bytes")
