// Dense ALS half-step edge pass over an int8 rating matrix R, for Hopper
// (sm_90a): one read of R per pass, both outputs from the same tile.
//
// Replaces the TPU kernels predictionio_tpu/ops/dense_pallas.py:
// fused_row_pass (body _make_row_kernel) and fused_col_pass (body
// _make_col_kernel). For every row (row pass) or column (col pass) n:
//
//   b[n, k]         = sum over the other axis m of w1(q) * bf16(y[m, k])
//   corr[n, i*K+j]  = sum over m of wg(q) * bf16(y[m, i] * y[m, j])
//
// with q = R[n, m] (row pass) or R[m, n] (col pass), and f32 weights
//   implicit: w1 = 1[q>0] + a*relu(q),  wg = a*|q|      (a = alpha/s)
//   explicit: w1 = a*q,                 wg = 1[q != 0]   (a = 1/s)
// each operation rounded on its own (__fmul_rn / __fadd_rn: nvcc's default
// -fmad=true would contract 1 + a*relu(q) into an FMA, which can flip the
// bf16 rounding), then rounded to bf16 (nearest, ties to even). y is the
// f32 factor matrix; z = y (x) y is formed per term in f32 and rounded to
// bf16, so it never reaches memory.
//
// Design. The TPU kernel walks a (row tile, col tile) grid in order and
// accumulates in the output block. Here a CTA owns a tile of output rows
// (row pass) or columns (col pass) and walks the other axis in order:
// each R tile is copied into shared memory once, with the matching slice
// of y, and the CTA's f32 accumulators (K + K^2 per output) stay in
// shared memory for the whole walk. One warp owns each output row (row
// pass) or each group of 4 output columns (col pass); lane l owns
// accumulator entries l, l + 32, ... So every sum is taken by one thread
// in index order of the walked axis (the col pass in blocks of 512 rows,
// see col_pass_kernel): no atomics, and two launches give the same bits.
// A bf16 x bf16 product is exact in f32, so __fmaf_rn of it is the
// rounded sum alone.
//
// Zero cells give w1 = wg = 0 exactly, so their terms are +-0 for finite
// factors and leave every sum unchanged: the warp finds the nonzero
// 32-bit words of its tile row with one ballot and visits only those.
//
// Bound at the main-path shape (ML-20M: R 139,264 x 26,880 int8 = 3.74 GB,
// K = 10): reading R once is 1.12 ms at 3.35 TB/s; y, x and the outputs
// add ~0.06 GB. The dense-equivalent work 2*n_r*n_c*(K+K^2) = 8.2e11
// operations is 0.83 ms at 989 TFLOP/s of bf16 tensor-core peak, so the
// pass is bytes-bound at ~1.14 ms. Skipping zero cells (0.54 % are set)
// leaves ~4.4 GFLOP of real work. This kernel is simple, not fast: tile
// copies are synchronous (no cp.async or TMA double buffering), and in
// the col pass one warp walks all the ratings of its 4 columns, so under
// a skewed item degree the warp holding the most-rated item sets the
// pass's time. No wgmma: at 0.54 % density the tensor cores would
// multiply zeros. PERF.md holds the times chip_smoke.py measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr int ROW_TC = 128;  // row pass: R columns per tile (a word per lane)
constexpr int ROW_TR_MAX = 64;   // row pass: R rows per CTA, at most
constexpr int COL_TR = 64;   // col pass: R rows per tile
constexpr int COL_TC_MAX = 32;  // col pass: R columns per CTA, at most
constexpr int COL_CHUNKS = 32;  // col pass: row chunks (CTAs) per column tile
// tiles per block of the two-level sums: 512 of the walked axis
constexpr int SUM_BLOCK = 512;
constexpr int ROW_BLOCK_TILES = SUM_BLOCK / ROW_TC;
constexpr int COL_BLOCK_TILES = SUM_BLOCK / COL_TR;
constexpr int ACC_BUDGET = 112 * 1024;  // shared bytes for both sum levels

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Weights {
  float w1, wg;
};

template <bool IMPLICIT>
__device__ __forceinline__ Weights weights(int q, float a) {
  const float qf = static_cast<float>(q);
  float w1, wg;
  if (IMPLICIT) {
    w1 = __fadd_rn(qf > 0.0f ? 1.0f : 0.0f, __fmul_rn(a, fmaxf(qf, 0.0f)));
    wg = __fmul_rn(a, fabsf(qf));
  } else {
    w1 = __fmul_rn(a, qf);
    wg = qf != 0.0f ? 1.0f : 0.0f;
  }
  return {bf16_round(w1), bf16_round(wg)};
}

// acc[o] += w * v(o) for this lane's entries o = lane, lane + 32, ...:
// o < K takes w1 * bf16(y[o]); o >= K is (i, j) = divmod(o - K, K) and
// takes wg * bf16(y[i] * y[j]).
__device__ __forceinline__ void accumulate(float* acc, const float* y,
                                           Weights w, int K, int nout,
                                           int lane) {
  for (int o = lane; o < nout; o += 32) {
    float v, wt;
    if (o < K) {
      v = bf16_round(y[o]);
      wt = w.w1;
    } else {
      const int t = o - K;
      const int i = t / K;
      const int j = t - i * K;
      v = bf16_round(__fmul_rn(y[i], y[j]));
      wt = w.wg;
    }
    acc[o] = __fmaf_rn(wt, v, acc[o]);
  }
}

// Adds one output's block sums to its running sums and clears them, each
// entry by the lane that summed it (see accumulate): no sync needed.
__device__ __forceinline__ void flush(float* acc, float* part, int nout,
                                      int lane) {
  for (int o = lane; o < nout; o += 32) {
    acc[o] = __fadd_rn(acc[o], part[o]);
    part[o] = 0.0f;
  }
}

// Copies rows [r0, r0 + tr) x columns [c0, c0 + tc) of R (n_r x n_c int8,
// row-major) into shared rows of `stride` bytes; cells outside R read as
// 0. tc and c0 are multiples of 16, stride a multiple of 4. `vec`: R's
// rows start 16-byte aligned, so whole chunks load as one uint4.
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ R,
                                          long long n_r, long long n_c,
                                          long long r0, long long c0, int tr,
                                          int tc, int8_t* tile, int stride,
                                          bool vec) {
  const int chunks = tc / 16;
  for (int idx = threadIdx.x; idx < tr * chunks; idx += blockDim.x) {
    const int lr = idx / chunks;
    const int ch = idx - lr * chunks;
    const long long gr = r0 + lr;
    const long long gc = c0 + 16LL * ch;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (gr < n_r && gc < n_c) {
      const int8_t* src = R + gr * n_c + gc;
      if (vec && gc + 16 <= n_c) {
        // streaming load: each pass reads R once
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(src));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        for (int b = 0; b < 16 && gc + b < n_c; ++b)
          w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                       << (8 * (b & 3));
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + lr * stride + ch * 16);
    dst[0] = w[0];
    dst[1] = w[1];
    dst[2] = w[2];
    dst[3] = w[3];
  }
}

// Both passes sum in two levels. A sum runs over the whole walked axis,
// up to n_r = 139,264 terms in the col pass (67,310 of them nonzero for
// ML-20M's most-rated item). One serial f32 sum of n positive terms
// drifts by ~eps * sqrt(n / 3) of their total, past 1e-5 of it at n ~
// 67,000. So the terms of each block of 512 along the walked axis go into
// `part`, which is added to `acc` and cleared at the block's end, in block
// order: the drift falls to ~eps * (sqrt(512 / 3) + sqrt(n / 1536)). A
// warp only flushes an output that got terms in the block (`dirty`).

// Row pass: CTA blockIdx.x owns R rows [r0, r0 + tr) and walks the column
// tiles in order. Warp w owns rows w, w + WARPS, ... of the tile.
template <bool IMPLICIT>
__global__ void __launch_bounds__(THREADS)
    row_pass_kernel(const int8_t* __restrict__ R, const float* __restrict__ Y,
                    float a, long long n_r, long long n_c, int K, int tr,
                    bool vec, float* __restrict__ B, float* __restrict__ C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nout = K + K * K;
  const int stride = ROW_TC + 4;
  float* acc = reinterpret_cast<float*>(smem);  // tr x nout
  float* part = acc + tr * nout;                // tr x nout
  float* ys = part + tr * nout;                 // ROW_TC x K
  int8_t* tile = reinterpret_cast<int8_t*>(ys + ROW_TC * K);  // tr x stride
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * tr;
  for (int i = threadIdx.x; i < 2 * tr * nout; i += blockDim.x) acc[i] = 0.0f;
  uint32_t dirty = 0u;  // bit n: this warp's n-th row has terms in `part`
  for (long long c0 = 0, t = 0; c0 < n_c; c0 += ROW_TC, ++t) {
    __syncthreads();  // the previous tile is consumed
    load_tile(R, n_r, n_c, r0, c0, tr, ROW_TC, tile, stride, vec);
    for (int i = threadIdx.x; i < ROW_TC * K; i += blockDim.x)
      ys[i] = c0 + i / K < n_c ? Y[c0 * K + i] : 0.0f;
    __syncthreads();
    const bool block_end =
        t % ROW_BLOCK_TILES == ROW_BLOCK_TILES - 1 || c0 + ROW_TC >= n_c;
    for (int lr = warp, n = 0; lr < tr; lr += WARPS, ++n) {
      const uint32_t word =
          reinterpret_cast<const uint32_t*>(tile + lr * stride)[lane];
      uint32_t live = __ballot_sync(0xffffffffu, word != 0u);
      if (live) dirty |= 1u << n;
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const uint32_t wd = __shfl_sync(0xffffffffu, word, src);
        for (int b = 0; b < 4; ++b) {
          const int q = static_cast<int8_t>(wd >> (8 * b));
          if (q == 0) continue;
          accumulate(part + lr * nout, ys + (src * 4 + b) * K,
                     weights<IMPLICIT>(q, a), K, nout, lane);
        }
      }
      if (block_end && (dirty >> n & 1u)) {
        flush(acc + lr * nout, part + lr * nout, nout, lane);
        dirty &= ~(1u << n);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tr * nout; i += blockDim.x) {
    const int lr = i / nout;
    const int o = i - lr * nout;
    const long long gr = r0 + lr;
    if (gr >= n_r) continue;
    if (o < K)
      B[gr * K + o] = acc[i];
    else
      C[gr * K * K + (o - K)] = acc[i];
  }
}

// Col pass: CTA (blockIdx.x, blockIdx.y) owns R columns [c0, c0 + tc) and
// walks the row tiles of row chunk blockIdx.y in order. Warp w owns the
// 4-column groups w, w + WARPS, ... and reads one 32-bit word per row, 32
// rows per ballot. The chunks split a column's walk over up to COL_CHUNKS
// CTAs: under skewed item degrees one most-rated item would otherwise
// hold its warp for its whole walk while the rest of the card idles. Each
// CTA writes its chunk's sums to `S` (n_chunks x n_c x nout), and
// col_reduce_kernel adds the chunks in order.
template <bool IMPLICIT>
__global__ void __launch_bounds__(THREADS)
    col_pass_kernel(const int8_t* __restrict__ R, const float* __restrict__ X,
                    float a, long long n_r, long long n_c, int K, int tc,
                    long long chunk_rows, bool vec, float* __restrict__ S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nout = K + K * K;
  const int stride = tc + 4;  // odd word stride: a column read hits 32 banks
  float* acc = reinterpret_cast<float*>(smem);  // tc x nout
  float* part = acc + tc * nout;                // tc x nout
  float* xs = part + tc * nout;                 // COL_TR x K
  int8_t* tile = reinterpret_cast<int8_t*>(xs + COL_TR * K);  // COL_TR x stride
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = tc / 4;
  const long long c0 = static_cast<long long>(blockIdx.x) * tc;
  // chunk_rows is a multiple of SUM_BLOCK: tiles and blocks never straddle
  const long long r_begin = blockIdx.y * chunk_rows;
  const long long r_end =
      r_begin + chunk_rows < n_r ? r_begin + chunk_rows : n_r;
  for (int i = threadIdx.x; i < 2 * tc * nout; i += blockDim.x) acc[i] = 0.0f;
  uint32_t dirty = 0u;  // bit n: this warp's n-th group has terms in `part`
  for (long long r0 = r_begin, t = 0; r0 < r_end; r0 += COL_TR, ++t) {
    __syncthreads();
    load_tile(R, n_r, n_c, r0, c0, COL_TR, tc, tile, stride, vec);
    for (int i = threadIdx.x; i < COL_TR * K; i += blockDim.x)
      xs[i] = r0 + i / K < n_r ? X[r0 * K + i] : 0.0f;
    __syncthreads();
    const bool block_end =
        t % COL_BLOCK_TILES == COL_BLOCK_TILES - 1 || r0 + COL_TR >= r_end;
    for (int g = warp, n = 0; g < groups; g += WARPS, ++n) {
      for (int m = 0; m < COL_TR; m += 32) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            tile + (m + lane) * stride + g * 4);
        uint32_t live = __ballot_sync(0xffffffffu, word != 0u);
        if (live) dirty |= 1u << n;
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const uint32_t wd = __shfl_sync(0xffffffffu, word, src);
          const float* xrow = xs + (m + src) * K;
          for (int b = 0; b < 4; ++b) {
            const int q = static_cast<int8_t>(wd >> (8 * b));
            if (q == 0) continue;
            accumulate(part + (g * 4 + b) * nout, xrow,
                       weights<IMPLICIT>(q, a), K, nout, lane);
          }
        }
      }
      if (block_end && (dirty >> n & 1u)) {
        for (int b = 0; b < 4; ++b)
          flush(acc + (g * 4 + b) * nout, part + (g * 4 + b) * nout, nout,
                lane);
        dirty &= ~(1u << n);
      }
    }
  }
  __syncthreads();
  float* out = S + (blockIdx.y * n_c + c0) * nout;
  for (int i = threadIdx.x; i < tc * nout; i += blockDim.x)
    if (c0 + i / nout < n_c) out[i] = acc[i];
}

// b and corr of the col pass: for each (column, entry), the chunk sums
// of S added in chunk order.
__global__ void col_reduce_kernel(const float* __restrict__ S, int n_chunks,
                                  long long n_c, int K, float* __restrict__ B,
                                  float* __restrict__ C) {
  const long long nout = K + K * K;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n_c * nout) return;
  float v = S[i];
  for (int ch = 1; ch < n_chunks; ++ch)
    v = __fadd_rn(v, S[ch * n_c * nout + i]);
  const long long gc = i / nout;
  const long long o = i - gc * nout;
  if (o < K)
    B[gc * K + o] = v;
  else
    C[gc * K * K + (o - K)] = v;
}

long long col_chunk_rows(long long n_r) {
  const long long per = (n_r + COL_CHUNKS - 1) / COL_CHUNKS;
  return (per + SUM_BLOCK - 1) / SUM_BLOCK * SUM_BLOCK;
}

int col_chunks(long long n_r) {
  return static_cast<int>((n_r + col_chunk_rows(n_r) - 1) / col_chunk_rows(n_r));
}

template <typename Kern>
cudaError_t launch(Kern kern, unsigned grid, size_t smem, cudaStream_t st,
                   const int8_t* r, const float* x, float a, long long n_r,
                   long long n_c, int K, int tile, bool vec, float* b,
                   float* c) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(r, x, a, n_r, n_c, K, tile, vec, b, c);
  return cudaGetLastError();
}

bool valid(const void* r, const void* x, long long n_r, long long n_c, int K,
           const void* b, const void* c) {
  return r != nullptr && x != nullptr && b != nullptr && c != nullptr &&
         n_r > 0 && n_c > 0 && K >= 1 && K <= MAX_K;
}

bool aligned16(const void* r, long long n_c) {
  return n_c % 16 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
}

}  // namespace

// Row pass: b (n_r, K) and corr (n_r, K^2) f32 from R (n_r, n_c) int8 and
// y (n_c, K) f32. Launches on `stream`, allocates nothing. Returns the
// CUDA error code, 0 on success.
extern "C" int dense_row_pass(int implicit, const void* r, const void* y,
                              float ascale, long long n_r, long long n_c,
                              int K, void* b, void* corr, int device,
                              void* stream) {
  if (!valid(r, y, n_r, n_c, K, b, corr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nout = K + K * K;
  int tr = ROW_TR_MAX;  // rows per CTA: as many as the sums allow
  while (tr > WARPS && 2 * tr * nout * 4 > ACC_BUDGET) tr -= WARPS;
  const long long grid = (n_r + tr - 1) / tr;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * tr) * nout * 4 +
                      static_cast<size_t>(ROW_TC) * K * 4 +
                      static_cast<size_t>(tr) * (ROW_TC + 4);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int8_t*>(r);
  const auto* yp = static_cast<const float*>(y);
  auto* bp = static_cast<float*>(b);
  auto* cp = static_cast<float*>(corr);
  const bool vec = aligned16(r, n_c);
  err = implicit ? launch(row_pass_kernel<true>, grid, smem, st, rp, yp,
                          ascale, n_r, n_c, K, tr, vec, bp, cp)
                 : launch(row_pass_kernel<false>, grid, smem, st, rp, yp,
                          ascale, n_r, n_c, K, tr, vec, bp, cp);
  return static_cast<int>(err);
}

// Floats of scratch the col pass needs for these dims: the chunk sums.
extern "C" long long dense_col_pass_scratch(long long n_r, long long n_c,
                                            int K) {
  if (n_r <= 0 || n_c <= 0 || K < 1 || K > MAX_K) return -1;
  return col_chunks(n_r) * n_c * (K + K * K);
}

// Col pass: b (n_c, K) and corr (n_c, K^2) f32 from R (n_r, n_c) int8 and
// x (n_r, K) f32, through `scratch` (dense_col_pass_scratch floats). Same
// contract as dense_row_pass otherwise.
extern "C" int dense_col_pass(int implicit, const void* r, const void* x,
                              float ascale, long long n_r, long long n_c,
                              int K, void* b, void* corr, void* scratch,
                              int device, void* stream) {
  if (!valid(r, x, n_r, n_c, K, b, corr) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nout = K + K * K;
  int tc = COL_TC_MAX;  // columns per CTA: halved until the sums fit
  while (tc > 16 && 2 * tc * nout * 4 > ACC_BUDGET) tc /= 2;
  const long long grid_x = (n_c + tc - 1) / tc;
  const long long chunk_rows = col_chunk_rows(n_r);
  const int chunks = col_chunks(n_r);
  if (grid_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * tc) * nout * 4 +
                      static_cast<size_t>(COL_TR) * K * 4 +
                      static_cast<size_t>(COL_TR) * (tc + 4);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int8_t*>(r);
  const auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<float*>(scratch);
  const bool vec = aligned16(r, n_c);
  auto kern = implicit ? &col_pass_kernel<true> : &col_pass_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(grid_x), chunks), THREADS, smem, st>>>(
      rp, xp, ascale, n_r, n_c, K, tc, chunk_rows, vec, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n_c * nout;
  col_reduce_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                      THREADS, 0, st>>>(sp, chunks, n_c, K,
                                        static_cast<float*>(b),
                                        static_cast<float*>(corr));
  return static_cast<int>(cudaGetLastError());
}
