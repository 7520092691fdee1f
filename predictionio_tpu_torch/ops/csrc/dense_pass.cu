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
// f32 factor matrix; z = y (x) y is formed in f32 and rounded to bf16:
// by the row pass's wrapper once per call, as the JAX wrapper forms its
// y16/z16, and by the col pass per term in registers.
//
// Bound at the main-path shape (ML-20M: R 139,264 x 26,880 int8 = 3.74 GB,
// K = 10): reading R once is 1.12 ms at 3.35 TB/s; y, x and the outputs
// add ~0.06 GB. The dense-equivalent work 2*n_r*n_c*(K+K^2) = 8.2e11
// operations is 0.83 ms at 989 TFLOP/s of bf16 tensor-core peak, so a pass
// is bytes-bound at ~1.14 ms. PERF.md holds the times chip_smoke.py
// measures.
//
// Row pass (row_pass_tc_kernel): as the TPU kernel, two matrix products
// per R tile, b = w1 @ bf16(Y) and corr = wg @ bf16(Z), on the tensor
// cores (mma.sync bf16 -> f32), over every cell, zero or not: its cost no
// longer depends on how the ratings spread. corr is symmetric, so only
// the K (K + 1) / 2 pairs i <= j are multiplied, each written twice. Each
// CTA streams a strip of 128 rows of R once (two CTAs an SM), through a
// cp.async pipeline that overlaps the copy of the next stages with the
// products. 72 accumulator columns fit one CTA at K <= 10 (b padded to
// 16, 55 pairs to 56); larger ranks split the output columns over
// CTAs, and R is read once per column block (8 times at K = 32:
// 32 + 528 columns). The products: 2 * n_r * n_c * 72 = 0.54 TFLOP at
// the main-path shape.
//
// Col pass (col_pass_kernel): a CTA owns a tile of output columns and
// walks R's rows in order: each R tile is copied into shared memory
// once, with the matching slice of x, and the CTA's f32 accumulators
// (K + K^2 per output) stay in shared memory for the whole walk. A warp
// owns each group of 4 output columns; lane l owns accumulator entries
// l, l + 32, ... So every sum is taken by one thread in row order (in
// blocks of 512 rows, per row chunk): no atomics, and two launches give
// the same bits. A bf16 x bf16 product is exact in f32, so __fmaf_rn of
// it is the rounded sum alone. Zero cells give w1 = wg = 0 exactly, so
// their terms are +-0 for finite factors and leave every sum unchanged:
// the warp finds the nonzero 32-bit words of its tile rows with one
// ballot and visits only those (0.54 % of ML-20M's cells are set). It is
// simple, not fast: the cost is per-rating work (K + K^2 shared-memory
// sums per rating), tile copies are synchronous, and under a skewed item
// degree the most-rated item's walk sets the pass's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr int COL_TR = 64;   // col pass: R rows per tile
constexpr int COL_TC_MAX = 32;  // col pass: R columns per CTA, at most
constexpr int COL_CHUNKS = 32;  // col pass: row chunks (CTAs) per column tile
// tiles per block of the two-level sums: 512 of the walked axis
constexpr int SUM_BLOCK = 512;
constexpr int COL_BLOCK_TILES = SUM_BLOCK / COL_TR;
constexpr int ACC_BUDGET = 112 * 1024;  // shared bytes for both sum levels
// row pass, on the tensor cores (row_pass_tc_kernel)
constexpr int TC_WARPS = 8;  // two CTAs an SM
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // R rows per CTA (a strip), 16 a warp
constexpr int TC_COLS = 128;  // R columns per pipeline stage, one mma sum block
constexpr int TC_RSTRIDE = TC_COLS + 16;  // shared bytes per R row: no bank conflicts
constexpr int TC_STAGES = 3;  // stages in flight (cp.async)
constexpr int TC_TILES = 9;   // 8-wide output tiles per CTA (a column block)
constexpr int TC_W = 8 * TC_TILES;  // operand columns per column block: 72
// an odd number of 16-byte units per shared operand row: the 8 rows of
// an ldmatrix matrix fall in 8 distinct bank groups
static_assert(TC_TILES % 2 == 1, "operand rows must span an odd number of 16 B");

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

// Row pass on the tensor cores. The wrapper (ops/dense_fused.py:
// row_operand) forms the B operand once per call, (n_c, n_cb * TC_W)
// bf16: bf16(y) in kp = K rounded up to 8 columns, then bf16(y_i * y_j)
// for the K (K + 1) / 2 pairs i <= j in row-major order (corr is
// symmetric: each pair's sum is written to (i, j) and (j, i)), zeros to
// the end of the last of n_cb column blocks of TC_W columns.
//
// CTA x = strip * n_cb + cb (a 1-D grid, up to 2^31 - 1 CTAs: the
// column blocks of a strip run side by side, so R's re-reads at larger
// ranks come from L2) owns R rows [r0, r0 + TC_ROWS) of strip `strip` and
// column block cb of the outputs, and walks R's columns in stages of
// TC_COLS: cp.async copies the stage's R tile and operand rows into
// shared memory TC_STAGES - 1 stages ahead, so the R stream overlaps the
// products. Warp w owns strip rows 16w .. 16w + 15 and, per 16 columns,
// derives both A tiles (w1 and wg in bf16) from R through a 256-entry
// table built with weights<IMPLICIT>, and issues one mma.sync m16n8k16
// per output tile: the b tiles take w1, the pair tiles wg. Lane (g, t)
// of a warp reads R's bytes [32t, 32t + 32) of its rows g and g + 8: in
// step j its k slots 2t, 2t + 1 hold columns 32t + 4j + {0, 1} and slots
// 2t + 8, 2t + 9 columns 32t + 4j + {2, 3}. So shared operand row 16j + s
// of a stage holds stage column stage_column(16j + s), copied there from
// device memory, and ldmatrix.trans reads 8 consecutive rows per matrix.
//
// Sums: the mma accumulators sum one stage (128 columns) and are then
// added, each by its lane, to running f32 sums in registers with
// __fadd_rn, in column order: tensor-core accumulation rounds
// differently from __fadd_rn, so no mma sum spans more than 128 columns
// (within SUM_BLOCK). No atomics, no split over CTAs: a relaunch gives
// the same bits. Zero cells give w1 = wg = 0, so their products are exact
// zeros for finite factors, as in the plain version.
__device__ __forceinline__ int stage_column(int p) {
  const int s = p & 15;
  return (TC_COLS / 4) * ((s & 7) >> 1) + 4 * (p >> 4) + 2 * (s >> 3) +
         (s & 1);
}

template <bool IMPLICIT>
__device__ __forceinline__ uint32_t weight_bits(int q, float a) {
  const Weights w = weights<IMPLICIT>(q, a);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(w.w1))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(w.wg)))
             << 16;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` < 16 fills the rest
// with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Stores operand column o's sum for one row: b, or both (i, j) and
// (j, i) of corr for pair o - kp (row-major over i <= j).
__device__ __forceinline__ void store_output(float v, long long row, int o,
                                             int K, int kp, float* B,
                                             float* C) {
  if (o < K) {
    B[row * K + o] = v;
    return;
  }
  int p = o - kp;
  if (p < 0 || p >= K * (K + 1) / 2) return;  // padding
  int i = 0;
  while (p >= K - i) {  // row i of the upper triangle holds K - i pairs
    p -= K - i;
    ++i;
  }
  const int j = i + p;
  C[row * K * K + i * K + j] = v;
  C[row * K * K + j * K + i] = v;
}

template <bool IMPLICIT>
__global__ void __launch_bounds__(TC_THREADS, 2) row_pass_tc_kernel(
    const int8_t* __restrict__ R, const __nv_bfloat16* __restrict__ Y,
    float a, long long n_r, long long n_c, int K, int kp, int n_cb, bool vec,
    float* __restrict__ B, float* __restrict__ C) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);       // 256
  int8_t* rs = reinterpret_cast<int8_t*>(table + 256);       // stages
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(
      rs + TC_STAGES * TC_ROWS * TC_RSTRIDE);                 // stages
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int cb = static_cast<int>(blockIdx.x % n_cb);
  const long long r0 = static_cast<long long>(blockIdx.x / n_cb) * TC_ROWS;
  const long long ld = static_cast<long long>(n_cb) * TC_W;  // operand row
  // this block's tiles below ny are b's (w1), the rest corr's (wg)
  const int ny = max(0, min(TC_TILES, kp / 8 - cb * TC_TILES));
  for (int i = tid; i < 256; i += TC_THREADS)
    table[i] = weight_bits<IMPLICIT>(static_cast<int8_t>(i), a);
  const int n_stages = static_cast<int>((n_c + TC_COLS - 1) / TC_COLS);

  auto load_stage = [&](int s) {
    const int buf = s % TC_STAGES;
    int8_t* rt = rs + buf * (TC_ROWS * TC_RSTRIDE);
    const long long c0 = static_cast<long long>(s) * TC_COLS;
    if (vec) {
      for (int i = tid; i < TC_ROWS * (TC_COLS / 16); i += TC_THREADS) {
        const int lr = i / (TC_COLS / 16);
        const int ch = i % (TC_COLS / 16);
        const long long gr = r0 + lr;
        const long long gc = c0 + 16 * ch;
        const bool in = gr < n_r && gc < n_c;  // chunks lie wholly in or out
        cp_async16(rt + lr * TC_RSTRIDE + 16 * ch,
                   in ? R + gr * n_c + gc : R, in ? 16 : 0);
      }
    } else {
      load_tile(R, n_r, n_c, r0, c0, TC_ROWS, TC_COLS, rt, TC_RSTRIDE, false);
    }
    __nv_bfloat16* yt = ys + buf * (TC_COLS * TC_W);
    for (int i = tid; i < TC_COLS * TC_TILES; i += TC_THREADS) {
      const int row = i / TC_TILES;
      const int ch = i % TC_TILES;
      const long long gc = c0 + stage_column(row);
      const bool in = gc < n_c;
      cp_async16(yt + row * TC_W + 8 * ch,
                 in ? Y + gc * ld + cb * TC_W + 8 * ch : Y, in ? 16 : 0);
    }
  };

  float acc[TC_TILES][4];  // this stage's mma sums
  float run[TC_TILES][4];  // the running sums, stage by stage
#pragma unroll
  for (int t = 0; t < TC_TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = run[t][e] = 0.0f;
  const int row_a = (tid >> 5) * 16 + g;  // this lane's rows: row_a, row_a + 8
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // stage s is in; stage s - 1's buffers are free
    if (s + TC_STAGES - 1 < n_stages) load_stage(s + TC_STAGES - 1);
    cp_async_commit();
    const int buf = s % TC_STAGES;
    const int8_t* rt = rs + buf * (TC_ROWS * TC_RSTRIDE) + 32 * tig;
    const __nv_bfloat16* yt = ys + buf * (TC_COLS * TC_W);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 qa = *reinterpret_cast<const uint4*>(
          rt + row_a * TC_RSTRIDE + 16 * half);
      const uint4 qb = *reinterpret_cast<const uint4*>(
          rt + (row_a + 8) * TC_RSTRIDE + 16 * half);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * half + jj;  // 16-column step of the stage
        const uint32_t xa = word_of(qa, jj);
        const uint32_t xb = word_of(qb, jj);
        uint32_t ea[4], eb[4];  // (w1 | wg << 16) of the 4 cells of each row
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ea[e] = table[(xa >> (8 * e)) & 255u];
          eb[e] = table[(xb >> (8 * e)) & 255u];
        }
        const uint32_t a1[4] = {
            __byte_perm(ea[0], ea[1], 0x5410), __byte_perm(eb[0], eb[1], 0x5410),
            __byte_perm(ea[2], ea[3], 0x5410), __byte_perm(eb[2], eb[3], 0x5410)};
        const uint32_t ag[4] = {
            __byte_perm(ea[0], ea[1], 0x7632), __byte_perm(eb[0], eb[1], 0x7632),
            __byte_perm(ea[2], ea[3], 0x7632), __byte_perm(eb[2], eb[3], 0x7632)};
        // ldmatrix: lanes 8m .. 8m + 7 address matrix m's rows, matrix m
        // holding k rows (m & 1) * 8 .. + 7 of tile t + (m >> 1)
        const __nv_bfloat16* brow =
            yt + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * TC_W;
        uint32_t bf[4];
#pragma unroll
        for (int t = 0; t < TC_TILES; ++t) {
          if ((t & 1) == 0)  // the last, odd tile reads itself twice
            ldmatrix_x4_trans(
                bf, brow + 8 * min(t + (lane >> 4), TC_TILES - 1));
          if (t < ny)
            mma_bf16(acc[t], a1, bf[2 * (t & 1)], bf[2 * (t & 1) + 1]);
          else
            mma_bf16(acc[t], ag, bf[2 * (t & 1)], bf[2 * (t & 1) + 1]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TC_TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run[t][e] = __fadd_rn(run[t][e], acc[t][e]);
        acc[t][e] = 0.0f;
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stage buffers are free: stage the sums there
  float* out = reinterpret_cast<float*>(rs);  // TC_ROWS x TC_W
#pragma unroll
  for (int t = 0; t < TC_TILES; ++t) {
    float* oa = out + row_a * TC_W + 8 * t + 2 * tig;
    float* ob = oa + 8 * TC_W;
    oa[0] = run[t][0];
    oa[1] = run[t][1];
    ob[0] = run[t][2];
    ob[1] = run[t][3];
  }
  __syncthreads();
  for (int i = tid; i < TC_ROWS * TC_W; i += TC_THREADS) {
    const int lr = i / TC_W;
    const long long gr = r0 + lr;
    if (gr < n_r)
      store_output(out[i], gr, cb * TC_W + (i - lr * TC_W), K, kp, B, C);
  }
}

// Both passes sum in two levels (the row pass as row_pass_tc_kernel
// says). A sum runs over the whole walked axis, up to n_r = 139,264
// terms in the col pass (67,310 of them nonzero for ML-20M's most-rated
// item). One serial f32 sum of n positive terms
// drifts by ~eps * sqrt(n / 3) of their total, past 1e-5 of it at n ~
// 67,000. So the terms of each block of 512 along the walked axis go into
// `part`, which is added to `acc` and cleared at the block's end, in block
// order: the drift falls to ~eps * (sqrt(512 / 3) + sqrt(n / 1536)). In
// the col pass a warp only flushes an output that got terms in the block
// (`dirty`).

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
// the operand y_op, (n_c, n_cb * TC_W) bf16 (ops/dense_fused.py:
// row_operand). Launches on `stream`, allocates nothing. Returns the
// CUDA error code, 0 on success.
extern "C" int dense_row_pass(int implicit, const void* r, const void* y_op,
                              float ascale, long long n_r, long long n_c,
                              int K, void* b, void* corr, int device,
                              void* stream) {
  if (!valid(r, y_op, n_r, n_c, K, b, corr) ||
      reinterpret_cast<uintptr_t>(y_op) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kp = (K + 7) / 8 * 8;
  const int width = kp + (K * (K + 1) / 2 + 7) / 8 * 8;
  const int n_cb = (width + TC_W - 1) / TC_W;
  const long long ctas = (n_r + TC_ROWS - 1) / TC_ROWS * n_cb;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 256 * 4 + static_cast<size_t>(TC_STAGES) *
                                    (TC_ROWS * TC_RSTRIDE + TC_COLS * TC_W * 2);
  auto kern = implicit ? &row_pass_tc_kernel<true> : &row_pass_tc_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(ctas), TC_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(r), static_cast<const __nv_bfloat16*>(y_op),
      ascale, n_r, n_c, K, kp, n_cb, aligned16(r, n_c), static_cast<float*>(b),
      static_cast<float*>(corr));
  return static_cast<int>(cudaGetLastError());
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
