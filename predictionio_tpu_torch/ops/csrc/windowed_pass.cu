// Windowed ALS edge pass for Hopper (sm_90a): per-block partial sums of the
// b-vector and flattened gram terms, then their ordered combine into
// output windows.
//
// Replaces the TPU kernel predictionio_tpu/ops/windowed_pallas.py:
// block_partials (body _kernel), and the block-level segment sum that
// predictionio_tpu/ops/windowed.py:windowed_gram_b runs after it. For
// every block c of B_E edge slots and every row r < S of its window:
//
//   pb[c, r, d]       = sum over slots e of c with local[e] = r
//                       of w_b[e] * y[src[e], d]
//   pg[c, r, i*K + j] = the same sum of w_g[e] * (y[src[e], i] * y[src[e], j])
//
// then out[w*S + r, :] = sum over the blocks c of window w, in block order,
// of p[c, r, :]. Slots whose local id lies outside [0, S) are padding and
// are skipped (the TPU kernel's one-hot never matches them). All in f32 on
// CUDA cores, as the TPU kernel's Precision.HIGHEST: y_i * y_j is rounded
// on its own (__fmul_rn), each term is fused into its sum (__fmaf_rn).
//
// Design. The TPU kernel builds an (S, B_E) one-hot in VMEM per block and
// contracts it on the MXU. Here one CTA owns one block, and thread t owns
// the output components d = t, t + T, ... of the D = K + K^2 per row
// (T = 128 threads at K = 10, one component each). The CTA stages a tile
// of 256 slots in shared memory (src, weights, local id and the gathered
// factor row: the gather happens here, y_t is never materialized), and
// each thread walks the slots in order, keeping a register sum while the
// local id repeats and flushing it to the row when the id changes. So each
// output cell has one writer, summing in slot order: no atomics, and two
// launches give the same bits. A block's valid slots are sorted by row,
// so rows are flushed in increasing order: rows skipped on the way are
// written 0, each cell is written once and never read back. Should an id
// come again after a larger one (block_partials permits unsorted ids), the
// flush adds into the row already written, by the same thread. Every
// block's whole (S, D) output is written, 0 where no slot lands, so the
// output needs no clearing. Skew does not pile onto one CTA: a block holds
// at most B_E slots, and a most-rated row spans many blocks.
//
// The combine: one thread per output element walks its window's blocks
// (contiguous, as block_window is sorted) in order. Windows without blocks
// read 0; padding blocks carry zero weights, so their partials are +-0 and
// add exactly nothing.
//
// Bound at the main path's shape (ML-25M's users side: 25,088 blocks of
// 1,024 slots, K = 10): reading the slots (src, w_b, w_g, local: 16 B
// each, 0.41 GB) and the factors once, and writing the partials (S * D *
// 4 B per block, 1.41 GB) once, is 0.545 ms at 3.35 TB/s. The operations,
// 2 per term (5.5 GFLOP), are 0.08 ms at 67 TFLOP/s f32. So the pass is
// bytes-bound; the combine reads the partials once more (0.44 ms). This
// kernel is simple, not fast (5.3 ms on an H100, PERF.md): every slot
// costs every thread of the CTA a few shared-memory reads and a compare,
// and the partials make a round trip through device memory that a fused
// combine would avoid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;
constexpr int MAX_THREADS = 256;
constexpr int EDGE_TILE = 256;  // slots staged in shared memory per step
constexpr int MAX_PER_THREAD = (MAX_K + MAX_K * MAX_K + MAX_THREADS - 1) /
                               MAX_THREADS;  // components per thread, at most

// This thread's components c: pointer to row 0 of its output column and
// the row stride, and the factor entries (yi, yj) of its term (yj < 0: a
// b component, w_b * y[yi]). yi < 0 marks a component past D.
template <int C>
struct Columns {
  float* col[C];
  int stride[C];
  int yi[C];
  int yj[C];
};

template <int C>
__device__ __forceinline__ void write_zero_rows(const Columns<C>& cols,
                                                int from, int to) {
  for (int q = from; q < to; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (cols.yi[c] >= 0) cols.col[c][static_cast<long long>(q) * cols.stride[c]] = 0.0f;
  }
}

// Writes this thread's running sums to row r and clears them; rows below
// `hi` were written before, rows from `hi` on were not.
template <int C>
__device__ __forceinline__ void flush(const Columns<C>& cols, float (&acc)[C],
                                      int r, int& hi) {
  if (r >= hi) {
    write_zero_rows(cols, hi, r);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (cols.yi[c] >= 0) cols.col[c][static_cast<long long>(r) * cols.stride[c]] = acc[c];
    hi = r + 1;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (cols.yi[c] < 0) continue;
      float* p = cols.col[c] + static_cast<long long>(r) * cols.stride[c];
      *p = __fadd_rn(*p, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
}

template <int C>
__global__ void __launch_bounds__(MAX_THREADS)
    partials_kernel(const float* __restrict__ Y, long long n_src, int K,
                    const int* __restrict__ SRC, const float* __restrict__ WB,
                    const float* __restrict__ WG, const int* __restrict__ LOC,
                    int b_e, int s_rows, float* __restrict__ PB,
                    float* __restrict__ PG) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);         // EDGE_TILE x K
  float* wbs = ys + EDGE_TILE * K;                     // EDGE_TILE
  float* wgs = wbs + EDGE_TILE;                        // EDGE_TILE
  int* ls = reinterpret_cast<int*>(wgs + EDGE_TILE);   // EDGE_TILE
  int* ss = ls + EDGE_TILE;                            // EDGE_TILE
  const int D = K + K * K;
  const long long blk = blockIdx.x;
  const long long base = blk * b_e;

  Columns<C> cols;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = threadIdx.x + c * blockDim.x;
    if (d < K) {
      cols.col[c] = PB + blk * s_rows * K + d;
      cols.stride[c] = K;
      cols.yi[c] = d;
      cols.yj[c] = -1;
    } else if (d < D) {
      const int t = d - K;
      cols.col[c] = PG + blk * s_rows * K * K + t;
      cols.stride[c] = K * K;
      cols.yi[c] = t / K;
      cols.yj[c] = t - (t / K) * K;
    } else {
      cols.col[c] = PB;
      cols.stride[c] = 0;
      cols.yi[c] = -1;
      cols.yj[c] = -1;
    }
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  int cur = -1;  // the row whose terms `acc` holds; -1 before the first
  int hi = 0;    // rows [0, hi) of this block's output are written
  for (int e0 = 0; e0 < b_e; e0 += EDGE_TILE) {
    const int n = b_e - e0 < EDGE_TILE ? b_e - e0 : EDGE_TILE;
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      wbs[t] = WB[base + e0 + t];
      wgs[t] = WG[base + e0 + t];
      ls[t] = LOC[base + e0 + t];
      ss[t] = SRC[base + e0 + t];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n * K; t += blockDim.x) {
      const int e = t / K;
      const int s = ss[e];
      // an index outside the factors reads a zero row, never past them
      ys[t] = s >= 0 && s < n_src
                  ? Y[static_cast<long long>(s) * K + (t - e * K)]
                  : 0.0f;
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const int l = ls[e];  // the same for every thread: no divergence
      if (l < 0 || l >= s_rows) continue;  // a padding slot
      if (l != cur) {
        if (cur >= 0) flush(cols, acc, cur, hi);
        cur = l;
      }
      const float* y = ys + e * K;
      const float wb = wbs[e];
      const float wg = wgs[e];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (cols.yi[c] < 0) continue;
        if (cols.yj[c] < 0)
          acc[c] = __fmaf_rn(wb, y[cols.yi[c]], acc[c]);
        else
          acc[c] = __fmaf_rn(wg, __fmul_rn(y[cols.yi[c]], y[cols.yj[c]]),
                             acc[c]);
      }
    }
  }
  if (cur >= 0) flush(cols, acc, cur, hi);
  write_zero_rows(cols, hi, s_rows);  // rows no slot reached
}

// out[w * width + m] = sum over the blocks c of window w, in order, of
// P[c * width + m]; bwin (n_blocks) is non-decreasing.
__global__ void combine_kernel(const float* __restrict__ P,
                               const int* __restrict__ BWIN,
                               long long n_blocks, long long width,
                               long long n_windows, float* __restrict__ O) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_windows * width) return;
  const long long w = i / width;
  const long long m = i - w * width;
  long long lo = 0, hi = n_blocks;  // first block of window >= w
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (BWIN[mid] < w)
      lo = mid + 1;
    else
      hi = mid;
  }
  float v = 0.0f;
  for (long long c = lo; c < n_blocks && BWIN[c] == w; ++c)
    v = __fadd_rn(v, P[c * width + m]);
  O[i] = v;
}

template <int C>
cudaError_t launch_partials(unsigned grid, int threads, size_t smem,
                            cudaStream_t st, const float* y, long long n_src,
                            int K, const int* src, const float* wb,
                            const float* wg, const int* local, int b_e,
                            int s_rows, float* pb, float* pg) {
  partials_kernel<C><<<grid, threads, smem, st>>>(y, n_src, K, src, wb, wg,
                                                  local, b_e, s_rows, pb, pg);
  return cudaGetLastError();
}

}  // namespace

// Per-block partials: pb (n_blocks, s_rows, K) and pg (n_blocks, s_rows,
// K^2) f32 from the factors y (n_src, K) f32 and the per-slot src, w_b, w_g,
// local (n_blocks, b_e), int32 / f32 / f32 / int32. Launches on `stream`,
// allocates nothing. Returns the CUDA error code, 0 on success.
extern "C" int block_partials(const void* y, long long n_src, int K,
                              const void* src, const void* wb, const void* wg,
                              const void* local, long long n_blocks, int b_e,
                              int s_rows, void* pb, void* pg, int device,
                              void* stream) {
  if (y == nullptr || src == nullptr || wb == nullptr || wg == nullptr ||
      local == nullptr || pb == nullptr || pg == nullptr || n_src <= 0 ||
      K < 1 || K > MAX_K || n_blocks < 0 || n_blocks > 0x7fffffffLL ||
      b_e < 1 || s_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks == 0) return 0;
  const int D = K + K * K;
  const int threads = D < MAX_THREADS ? (D + 31) / 32 * 32 : MAX_THREADS;
  const int per = (D + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(EDGE_TILE) * (K + 4) * 4;
  auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(n_blocks);
  const auto* yp = static_cast<const float*>(y);
  const auto* sp = static_cast<const int*>(src);
  const auto* bp = static_cast<const float*>(wb);
  const auto* gp = static_cast<const float*>(wg);
  const auto* lp = static_cast<const int*>(local);
  auto* ob = static_cast<float*>(pb);
  auto* og = static_cast<float*>(pg);
  static_assert(MAX_PER_THREAD == 5, "the dispatch below covers 1..5");
  switch (per) {
    case 1:
      err = launch_partials<1>(grid, threads, smem, st, yp, n_src, K, sp, bp,
                               gp, lp, b_e, s_rows, ob, og);
      break;
    case 2:
      err = launch_partials<2>(grid, threads, smem, st, yp, n_src, K, sp, bp,
                               gp, lp, b_e, s_rows, ob, og);
      break;
    case 3:
      err = launch_partials<3>(grid, threads, smem, st, yp, n_src, K, sp, bp,
                               gp, lp, b_e, s_rows, ob, og);
      break;
    case 4:
      err = launch_partials<4>(grid, threads, smem, st, yp, n_src, K, sp, bp,
                               gp, lp, b_e, s_rows, ob, og);
      break;
    case 5:
      err = launch_partials<5>(grid, threads, smem, st, yp, n_src, K, sp, bp,
                               gp, lp, b_e, s_rows, ob, og);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Combine: ob (n_windows * s_rows, K) and og (n_windows * s_rows, K^2) f32,
// each window's blocks of pb / pg added in block order; block_window
// (n_blocks) int32 must be non-decreasing. Same contract as block_partials.
extern "C" int combine_windows(const void* pb, const void* pg,
                               const void* block_window, long long n_blocks,
                               int s_rows, int K, long long n_windows,
                               void* ob, void* og, int device, void* stream) {
  if (pb == nullptr || pg == nullptr || block_window == nullptr ||
      ob == nullptr || og == nullptr || n_blocks < 0 || s_rows < 1 || K < 1 ||
      K > MAX_K || n_windows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* bw = static_cast<const int*>(block_window);
  const long long widths[2] = {static_cast<long long>(s_rows) * K,
                               static_cast<long long>(s_rows) * K * K};
  const float* in[2] = {static_cast<const float*>(pb),
                        static_cast<const float*>(pg)};
  float* out[2] = {static_cast<float*>(ob), static_cast<float*>(og)};
  for (int a = 0; a < 2; ++a) {
    const long long total = n_windows * widths[a];
    if (total == 0) continue;
    const long long grid = (total + MAX_THREADS - 1) / MAX_THREADS;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    combine_kernel<<<static_cast<unsigned>(grid), MAX_THREADS, 0, st>>>(
        in[a], bw, n_blocks, widths[a], n_windows, out[a]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
