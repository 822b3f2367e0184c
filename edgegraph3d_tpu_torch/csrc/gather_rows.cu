// K5 gather_rows — whole rows of a row-major [R, W] f32 (or f64) table by
// index.
//
// Replaces (Pallas): tools/pallas_probe.py `gather_p` (pl.pallas_call at
//   :145, body `kernel` at :120): S rows of the flat [V*P, 2L] polyline
//   table picked by an int32 row index, eight async DMAs per grid step
//   with the indices scalar-prefetched.  The JAX package's production
//   code runs the same gather as XLA at matching/following.py:275,
//   matching/refpoints.py:1247 and matching/polyline_stages.py:431; the
//   port calls it from refpoints._locate_on_polylines (chain extension)
//   and polyline_stages._group_seed_sweep (stage-1/2 member rows).
//
// One warp per output row: the warp reads its row index once and copies
// the row with 16-byte loads and stores when W % 4 == 0 and both base
// pointers are 16-byte aligned, 4-byte ones otherwise.  The TPU needed
// explicit DMAs because a vector load cannot address an arbitrary HBM
// row; on Hopper plain coalesced loads do, and a row of 2L = 128 floats
// is 512 B, one 16-byte load per lane.  Indices are int32 or int64 (a
// template on the index type, so the wrapper copies nothing).  An index
// outside [0, R) fails a device-side assert, as `table[rows]` does on the
// card: the launch then reports cudaErrorAssert at the next synchronise.
// The kernel never clamps and never writes a silent zero row, and the
// wrapper reads nothing back to the host.
//
// Bound on the H100: memory.  Each output row is one read and one write
// of W*4 bytes plus the index; rows are independent, so enough warps are
// in flight to hide the gather latency.
//
// f64 (EdgeGraphConfig(dtype="float64"): the polyline table is f64): the
// same template on double, 16-byte double2 pieces when W is even and
// both pointers are 16-byte aligned, else 8-byte doubles.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T, typename I>
__global__ void gather_rows_kernel(const T* __restrict__ table, int64_t R,
                                   int64_t Wv, const I* __restrict__ rows,
                                   int64_t S, T* __restrict__ out) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S) return;
  const int64_t r = (int64_t)rows[warp];
  assert(r >= 0 && r < R);
  const T* src = table + r * Wv;
  T* dst = out + warp * Wv;
  for (int64_t c = lane; c < Wv; c += 32) dst[c] = src[c];
}

template <typename I>
void launch(const float* table, int64_t R, int64_t W, const I* rows,
            int64_t S, float* out, cudaStream_t s) {
  const int threads = 256;  // 8 rows per block
  const dim3 blocks((unsigned)((S * 32 + threads - 1) / threads));
  const bool vec = (W % 4 == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) {
    gather_rows_kernel<float4, I><<<blocks, threads, 0, s>>>(
        (const float4*)table, R, W / 4, rows, S, (float4*)out);
  } else {
    gather_rows_kernel<float, I><<<blocks, threads, 0, s>>>(table, R, W,
                                                            rows, S, out);
  }
}

template <typename I>
void launch(const double* table, int64_t R, int64_t W, const I* rows,
            int64_t S, double* out, cudaStream_t s) {
  const int threads = 256;  // 8 rows per block
  const dim3 blocks((unsigned)((S * 32 + threads - 1) / threads));
  const bool vec = (W % 2 == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) {
    gather_rows_kernel<double2, I><<<blocks, threads, 0, s>>>(
        (const double2*)table, R, W / 2, rows, S, (double2*)out);
  } else {
    gather_rows_kernel<double, I><<<blocks, threads, 0, s>>>(table, R, W,
                                                             rows, S, out);
  }
}

template <typename E>
int gather_rows(const E* table, int64_t R, int64_t W, const void* rows,
                int idx64, int64_t S, E* out, void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    launch(table, R, W, (const int64_t*)rows, S, out, s);
  } else {
    launch(table, R, W, (const int32_t*)rows, S, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: int64 when idx64 != 0, else int32.
extern "C" int eg3d_gather_rows(const float* table, int64_t R, int64_t W,
                                const void* rows, int idx64, int64_t S,
                                float* out, void* stream) {
  return gather_rows(table, R, W, rows, idx64, S, out, stream);
}

// The f64 table: [R, W] doubles.
extern "C" int eg3d_gather_rows_f64(const double* table, int64_t R,
                                    int64_t W, const void* rows, int idx64,
                                    int64_t S, double* out, void* stream) {
  return gather_rows(table, R, W, rows, idx64, S, out, stream);
}
