// K5 gather_rows — whole rows of a row-major [R, W] f32 (or f64) table by
// index: out[s, :] = table[rows[s], :], bit for bit.
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
// Bound on the H100: memory.  The least the card can move is each
// distinct row read once, the indices read once and every output row
// written once, over 3.35 TB/s.  At the chain-extension shape (307,132
// rows of 2L = 64 floats) that is ~79 MB written against ~4 MB of
// distinct rows, each read many times.
//
// What `gather_p` does on the TPU (many row copies in flight, indices
// known ahead) becomes, on Hopper, one answer to each of three limits:
//  * Every lane busy.  A row is cut into 16-byte pieces (float4 /
//    double2) when its byte width is a multiple of 16 and both base
//    pointers are 16-byte aligned, else into single elements.  Threads
//    cover the flattened (row, piece) pairs of a tile, consecutive
//    threads on consecutive pieces, so all 32 lanes of a warp work for
//    any row width: two rows a warp at 16 pieces (a 64-float row), four
//    at 8.  (A warp a row would leave lanes 16-31 idle on a 64-float
//    row.)  8, 16 and 32 pieces a row have bodies of their own (row and
//    piece by shift and mask); any other width takes the general body,
//    which steps each thread's (row, piece) by THREADS pieces with one
//    carry and no division per piece.
//  * No index-then-row chain per row.  A block takes a tile of TILE
//    pieces (TILE / pieces rows, at least one) and first loads the
//    tile's row indices in one coalesced pass into shared memory, each
//    checked against [0, R) by a device-side assert (as `table[rows]`
//    asserts on the card; reported at the next synchronise).  Nothing is
//    clamped and no zero row is written in silence.  Then each thread
//    issues UNROLL independent loads into registers before its first
//    store: the counterpart of the probe's eight outstanding DMAs.
//  * The output does not evict the table.  The table is read through
//    the read-only path (`__ldg`, ld.global.nc) and the output written
//    with streaming stores (`__stcs`, st.global.cs): at the extension
//    shape the output is larger than the 50 MB L2, the reused rows are
//    not.
// The grid is sized to the card: the wrapper (ops/gather.launch_plan)
// passes min(tiles, BLOCKS_PER_SM blocks a SM), and blocks loop over
// tiles with a grid stride, so S reaches 2^31 rows and every offset is
// 64-bit.
//
// Indices are int32 or int64 (a template on the index type, so the
// wrapper copies nothing); the wrapper reads nothing back to the host.
// f64 (EdgeGraphConfig(dtype="float64"): the polyline table is f64): the
// same template on double2 / double.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;            // threads a block
constexpr int UNROLL = 8;               // loads a thread issues before storing
constexpr int TILE = THREADS * UNROLL;  // pieces a tile (one unrolled pass)

// P: pieces a row when it has a body of its own (8, 16, 32), else 0 and
// the row width `Wp` is read at run time.  T: the piece type.
template <typename T, int P, typename I>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ table, int64_t R, int64_t Wp,
                   const I* __restrict__ rows, int64_t S,
                   T* __restrict__ out) {
  constexpr int MAX_ROWS = P ? TILE / P : TILE;
  __shared__ int64_t s_src[MAX_ROWS];  // piece offset of each staged row
  const int64_t W = P ? P : Wp;
  const int tile_rows = P ? TILE / P : (int)(W < TILE ? TILE / W : 1);
  const int tid = threadIdx.x;
  // general body: the thread's first (row, piece) in a tile, and the
  // rows and pieces one step of THREADS pieces advances
  const int row0 = P ? 0 : (int)(tid / W);
  const int64_t col0 = P ? 0 : tid % W;
  const int drow = P ? 0 : (int)(THREADS / W);
  const int64_t dcol = P ? 0 : THREADS % W;
  const int64_t tiles = (S + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * tile_rows;
    const int n_rows = (int)(S - first < tile_rows ? S - first : tile_rows);
    __syncthreads();  // the previous tile's reads of s_src are done
    for (int i = tid; i < n_rows; i += THREADS) {
      const int64_t r = (int64_t)rows[first + i];
      assert(r >= 0 && r < R);
      s_src[i] = r * W;
    }
    __syncthreads();
    const int64_t n = (int64_t)n_rows * W;  // pieces of this tile
    T* dst = out + first * W;               // the tile's output is contiguous
    int row = row0;
    int64_t col = col0;
    // one pass unless a general-body row is longer than TILE pieces
    for (int64_t base = 0; base < n; base += TILE) {
      T v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t p = base + u * THREADS + tid;
        if (P) {  // one pass covers the tile: p < TILE
          row = (unsigned)p / P;
          col = (unsigned)p % P;
        }
        if (p < n) v[u] = __ldg(table + s_src[row] + col);
        if (!P) {
          row += drow;
          col += dcol;
          if (col >= W) {
            col -= W;
            ++row;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t p = base + u * THREADS + tid;
        if (p < n) __stcs(dst + p, v[u]);
      }
    }
  }
}

template <typename T, typename I>
void launch(const T* table, int64_t R, int64_t Wp, const I* rows, int64_t S,
            T* out, int blocks, cudaStream_t s) {
  switch (Wp) {
    case 8:
      gather_rows_kernel<T, 8, I><<<blocks, THREADS, 0, s>>>(
          table, R, Wp, rows, S, out);
      break;
    case 16:
      gather_rows_kernel<T, 16, I><<<blocks, THREADS, 0, s>>>(
          table, R, Wp, rows, S, out);
      break;
    case 32:
      gather_rows_kernel<T, 32, I><<<blocks, THREADS, 0, s>>>(
          table, R, Wp, rows, S, out);
      break;
    default:
      gather_rows_kernel<T, 0, I><<<blocks, THREADS, 0, s>>>(
          table, R, Wp, rows, S, out);
  }
}

// V: the 16-byte piece of element type E (float4, double2).
template <typename E, typename V, typename I>
void launch_pieces(const E* table, int64_t R, int64_t W, const I* rows,
                   int64_t S, E* out, int vec, int blocks, cudaStream_t s) {
  if (vec) {
    launch((const V*)table, R, W * (int64_t)sizeof(E) / 16, rows, S,
           (V*)out, blocks, s);
  } else {
    launch(table, R, W, rows, S, out, blocks, s);
  }
}

template <typename E, typename V>
int gather_rows(const E* table, int64_t R, int64_t W, const void* rows,
                int idx64, int64_t S, E* out, int vec, int blocks,
                void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    launch_pieces<E, V>(table, R, W, (const int64_t*)rows, S, out, vec,
                        blocks, s);
  } else {
    launch_pieces<E, V>(table, R, W, (const int32_t*)rows, S, out, vec,
                        blocks, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: int64 when idx64 != 0, else int32.  vec: 16-byte pieces (the
// caller has checked that W * 4 is a multiple of 16 and both pointers
// are 16-byte aligned), else one float a piece.  blocks: the grid
// (ops/gather.launch_plan).
extern "C" int eg3d_gather_rows(const float* table, int64_t R, int64_t W,
                                const void* rows, int idx64, int64_t S,
                                float* out, int vec, int blocks,
                                void* stream) {
  return gather_rows<float, float4>(table, R, W, rows, idx64, S, out, vec,
                                    blocks, stream);
}

// The f64 table: [R, W] doubles, 16-byte pieces of two.
extern "C" int eg3d_gather_rows_f64(const double* table, int64_t R,
                                    int64_t W, const void* rows, int idx64,
                                    int64_t S, double* out, int vec,
                                    int blocks, void* stream) {
  return gather_rows<double, double2>(table, R, W, rows, idx64, S, out,
                                      vec, blocks, stream);
}
