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
// f32 factor matrix; z = y (x) y is formed in f32 and rounded to bf16,
// once per call by the wrappers (ops/dense_fused.py: pass_operand), as the
// JAX wrapper forms its y16/z16.
//
// Bound at the main-path shape (ML-20M: R 139,264 x 26,880 int8 = 3.74 GB,
// K = 10): reading R once is 1.12 ms at 3.35 TB/s; y, x and the outputs
// add ~0.06 GB. The dense-equivalent work 2*n_r*n_c*(K+K^2) = 8.2e11
// operations is 0.83 ms at 989 TFLOP/s of bf16 tensor-core peak, so a pass
// is bytes-bound at ~1.14 ms. PERF.md holds the times chip_smoke.py
// measures.
//
// Both passes, as the TPU kernel, take two matrix products per R tile,
// b = w1 @ bf16(Y) and corr = wg @ bf16(Z), on the tensor cores
// (mma.sync bf16 -> f32), over every cell, zero or not: their cost does
// not depend on how the ratings spread. corr is symmetric, so only the
// K (K + 1) / 2 pairs i <= j are multiplied, each written twice. 72
// accumulator columns fit one CTA at K <= 10 (b padded to 16, 55 pairs to
// 56); larger ranks split the output columns over CTAs, and R is read once
// per column block (8 times at K = 32: 32 + 528 columns). The products:
// 2 * n_r * n_c * 72 = 0.54 TFLOP at the main-path shape. Each CTA
// streams its R tile through a cp.async pipeline that overlaps the copy
// of the next stages with the products.
//
// Row pass (row_pass_tc_kernel): a CTA owns a strip of 128 rows of R (two
// CTAs an SM) and walks R's columns; the mma's M axis is R's rows, its K
// axis R's columns, so the A tiles are R's rows as they lie in memory.
//
// Col pass (col_pass_tc_kernel): the contraction runs over R's rows, so
// the A tiles are R transposed. A CTA owns a tile of 128 columns of R
// (two CTAs an SM) and walks a chunk of R's rows; each warp owns 32
// columns as two m tiles and reads one 32-bit word (4 neighbouring
// columns) from each of 4 rows per 16-row step, which gives both m tiles'
// A fragments (see col_pass_tc_kernel). Each operand tile read by
// ldmatrix feeds two mma, twice the row pass's reuse. R's rows split into
// chunks that fill the card (col_plan: 210 column tiles for 264 CTA slots
// at ML-20M width, K = 10); each chunk's sums go to scratch and
// col_reduce_kernel adds them in chunk order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;
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
// col pass, on the tensor cores (col_pass_tc_kernel)
constexpr int CP_WARPS = 4;  // two CTAs an SM
constexpr int CP_THREADS = 32 * CP_WARPS;
constexpr int CP_COLS = 32 * CP_WARPS;  // R columns per CTA (a tile), 32 a warp
constexpr int CP_ROWS = 128;  // R rows per pipeline stage, one mma sum block
// shared bytes per R row: 36 words, so the 4 rows 2t (t = 0..3) a warp
// reads at once start 8 banks apart and its 8 words per row fill them
constexpr int CP_RSTRIDE = CP_COLS + 16;
static_assert(CP_RSTRIDE / 4 % 16 == 4, "the R words a warp reads must hit 32 banks");
constexpr int CP_STAGES = 3;  // stages in flight (cp.async)
constexpr int CP_CTAS_PER_SM = 2;  // col_pass_tc_kernel's launch bounds
constexpr int CP_WAVES = 4;  // waves of CTAs the row chunks aim to fill
constexpr int REDUCE_THREADS = 256;

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
// pass_operand) forms the B operand once per call, (n_c, n_cb * TC_W)
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
// (see col_pass_tc_kernel for the bar). No atomics, no split over CTAs: a
// relaunch gives the same bits. Zero cells give w1 = wg = 0, so their
// products are exact zeros for finite factors, as in the plain version.
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

// Col pass on the tensor cores: the row pass's two products with the
// contraction over R's rows. The mma computes D[m, n] += A[m, k] B[k, n]
// with m an R column, k an R row and n an operand column: B is the
// operand of pass_operand (the row-side factors x, (n_r, n_cb * TC_W)
// bf16), its rows in R's row order, so ldmatrix.trans reads a stage's
// operand rows as they were copied; A is w1 or wg of R transposed.
//
// CTA x = (chunk * n_tiles + tile) * n_cb + cb (a 1-D grid; the column
// blocks of a tile run side by side, so R's re-reads at larger ranks come
// from L2) owns R columns [c0, c0 + CP_COLS) of tile `tile`, column block
// cb of the outputs, and R rows [r_begin, r_begin + chunk_rows) of chunk
// `chunk`, and walks them in stages of CP_ROWS with cp.async, CP_STAGES - 1
// stages ahead, as the row pass does. Warp w owns tile columns 32w ..
// 32w + 31 as two m tiles. In each 16-row step lane (g, t) reads one
// 32-bit word, columns 32w + 4g .. 32w + 4g + 3, from each of the step's
// rows 2t, 2t + 1, 2t + 8, 2t + 9: exactly its A fragments' k slots, so
// the k order is R's row order. The word's 4 columns take m slots g
// (columns 4g and 4g + 2) and g + 8 (4g + 1 and 4g + 3) of m tiles 0 and
// 1: the 16 bytes go through the 256-entry weight table to (w1 | wg << 16)
// pairs, and __byte_perm packs the two rows' halves of each register.
// So 4 shared loads and 16 table lookups give the A fragments (w1 and
// wg) of both m tiles, and each B fragment feeds two mma. The output
// column of a D entry follows from its m slot in the same way.
//
// Sums: as in the row pass, the mma accumulators sum one stage (128 rows)
// and are then added to running f32 sums in registers with __fadd_rn, in
// row order. A chunk's sums go to `S` (n_chunks x n_c x n_cb * TC_W),
// and col_reduce_kernel adds them in chunk order. No atomics: a relaunch
// gives the same bits. The bar: a serial f32 sum of n positive terms
// drifts by ~eps * sqrt(n / 3) of their total; the terms here are the
// n_r / 128 stage sums (1,088 at ML-20M width, ~1.1e-6 of the total in
// one chunk; per chunk fewer), each with the mma's own rounding of 128
// exact products, well inside 1e-5 of the sum of the absolute terms.
//
// One CTA of the col pass (see above). NY, the CTA's b tiles (w1), is a
// template argument: a run-time choice per output tile splits every 16-row
// step into basic blocks the compiler cannot schedule across (a first
// version did so: slower, and it spilled registers).
template <bool IMPLICIT, int NY>
__device__ __forceinline__ void col_pass_cta(
    const int8_t* __restrict__ R, const __nv_bfloat16* __restrict__ X,
    float a, long long n_r, long long n_c, int n_cb, long long chunk_rows,
    bool vec, float* __restrict__ S, unsigned char* smem) {
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);  // 256
  int8_t* rs = reinterpret_cast<int8_t*>(table + 256);  // stages
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      rs + CP_STAGES * CP_ROWS * CP_RSTRIDE);  // stages
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const long long n_tiles = (n_c + CP_COLS - 1) / CP_COLS;
  const int cb = static_cast<int>(blockIdx.x % n_cb);
  const long long tile_chunk = blockIdx.x / n_cb;
  const long long chunk = tile_chunk / n_tiles;
  const long long c0 = (tile_chunk - chunk * n_tiles) * CP_COLS;
  const long long r_begin = chunk * chunk_rows;
  // chunk_rows is a multiple of CP_ROWS: stages never straddle chunks
  const long long r_end =
      r_begin + chunk_rows < n_r ? r_begin + chunk_rows : n_r;
  const long long ld = static_cast<long long>(n_cb) * TC_W;  // operand row
  for (int i = tid; i < 256; i += CP_THREADS)
    table[i] = weight_bits<IMPLICIT>(static_cast<int8_t>(i), a);
  const int n_stages = static_cast<int>((r_end - r_begin + CP_ROWS - 1) / CP_ROWS);

  auto load_stage = [&](int s) {
    const int buf = s % CP_STAGES;
    int8_t* rt = rs + buf * (CP_ROWS * CP_RSTRIDE);
    const long long r0 = r_begin + static_cast<long long>(s) * CP_ROWS;
    if (vec) {
      for (int i = tid; i < CP_ROWS * (CP_COLS / 16); i += CP_THREADS) {
        const int lr = i / (CP_COLS / 16);
        const int ch = i % (CP_COLS / 16);
        const long long gr = r0 + lr;
        const long long gc = c0 + 16 * ch;
        const bool in = gr < n_r && gc < n_c;  // chunks lie wholly in or out
        cp_async16(rt + lr * CP_RSTRIDE + 16 * ch,
                   in ? R + gr * n_c + gc : R, in ? 16 : 0);
      }
    } else {
      load_tile(R, n_r, n_c, r0, c0, CP_ROWS, CP_COLS, rt, CP_RSTRIDE, false);
    }
    __nv_bfloat16* xt = xs + buf * (CP_ROWS * TC_W);
    for (int i = tid; i < CP_ROWS * TC_TILES; i += CP_THREADS) {
      const int row = i / TC_TILES;
      const int ch = i % TC_TILES;
      const long long gr = r0 + row;
      const bool in = gr < n_r;
      cp_async16(xt + row * TC_W + 8 * ch,
                 in ? X + gr * ld + cb * TC_W + 8 * ch : X, in ? 16 : 0);
    }
  };

  float acc[2][TC_TILES][4];  // this stage's mma sums, per m tile
  float run[2][TC_TILES][4];  // the running sums, stage by stage
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < TC_TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = run[m][t][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < CP_STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<CP_STAGES - 2>();
    __syncthreads();  // stage s is in; stage s - 1's buffers are free
    if (s + CP_STAGES - 1 < n_stages) load_stage(s + CP_STAGES - 1);
    cp_async_commit();
    const int buf = s % CP_STAGES;
    // this lane's words: rows 2t, 2t + 1, 2t + 8, 2t + 9 of each step
    const int8_t* rt = rs + buf * (CP_ROWS * CP_RSTRIDE) +
                       2 * tig * CP_RSTRIDE + 32 * warp + 4 * g;
    const __nv_bfloat16* xt = xs + buf * (CP_ROWS * TC_W);
#pragma unroll
    for (int j = 0; j < CP_ROWS / 16; ++j) {
      const int8_t* p = rt + 16 * j * CP_RSTRIDE;
      const uint32_t q[4] = {
          *reinterpret_cast<const uint32_t*>(p),
          *reinterpret_cast<const uint32_t*>(p + CP_RSTRIDE),
          *reinterpret_cast<const uint32_t*>(p + 8 * CP_RSTRIDE),
          *reinterpret_cast<const uint32_t*>(p + 9 * CP_RSTRIDE)};
      // e[r][c]: (w1 | wg << 16) of row r's column 4g + c
      uint32_t e[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = table[(q[r] >> (8 * c)) & 255u];
      // m tile m: slot g is column 4g + 2m, slot g + 8 column 4g + 2m + 1
      uint32_t a1[2][4], ag[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int c = 2 * m;
        a1[m][0] = __byte_perm(e[0][c], e[1][c], 0x5410);
        a1[m][1] = __byte_perm(e[0][c + 1], e[1][c + 1], 0x5410);
        a1[m][2] = __byte_perm(e[2][c], e[3][c], 0x5410);
        a1[m][3] = __byte_perm(e[2][c + 1], e[3][c + 1], 0x5410);
        ag[m][0] = __byte_perm(e[0][c], e[1][c], 0x7632);
        ag[m][1] = __byte_perm(e[0][c + 1], e[1][c + 1], 0x7632);
        ag[m][2] = __byte_perm(e[2][c], e[3][c], 0x7632);
        ag[m][3] = __byte_perm(e[2][c + 1], e[3][c + 1], 0x7632);
      }
      // ldmatrix: lanes 8m .. 8m + 7 address matrix m's rows, matrix m
      // holding k rows (m & 1) * 8 .. + 7 of tile t + (m >> 1)
      const __nv_bfloat16* brow =
          xt + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * TC_W;
      uint32_t bf[4];
#pragma unroll
      for (int t = 0; t < TC_TILES; ++t) {
        if ((t & 1) == 0)  // the last, odd tile reads itself twice
          ldmatrix_x4_trans(bf, brow + 8 * min(t + (lane >> 4), TC_TILES - 1));
        const uint32_t b0 = bf[2 * (t & 1)], b1 = bf[2 * (t & 1) + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (t < NY)  // known at compile time: no branch
            mma_bf16(acc[m][t], a1[m], b0, b1);
          else
            mma_bf16(acc[m][t], ag[m], b0, b1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < TC_TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          run[m][t][e] = __fadd_rn(run[m][t][e], acc[m][t][e]);
          acc[m][t][e] = 0.0f;
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stage buffers are free: stage the sums there
  float* out = reinterpret_cast<float*>(rs);  // CP_COLS x TC_W
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < TC_TILES; ++t) {
      // d0, d1: m slot g (column 4g + 2m); d2, d3: slot g + 8 (next column)
      float* oa = out + (32 * warp + 4 * g + 2 * m) * TC_W + 8 * t + 2 * tig;
      oa[0] = run[m][t][0];
      oa[1] = run[m][t][1];
      oa[TC_W] = run[m][t][2];
      oa[TC_W + 1] = run[m][t][3];
    }
  __syncthreads();
  for (int i = tid; i < CP_COLS * TC_W; i += CP_THREADS) {
    const int lc = i / TC_W;
    const long long gc = c0 + lc;
    if (gc >= n_c) continue;
    S[(chunk * n_c + gc) * ld + cb * TC_W + (i - lc * TC_W)] = out[i];
  }
}

// b's tiles in a column block: kp / 8 <= 4 in the first, none after
static_assert((MAX_K + 7) / 8 <= 4 && (MAX_K + 7) / 8 < TC_TILES,
              "b must fit the first column block's first 4 tiles");

template <bool IMPLICIT>
__global__ void __launch_bounds__(CP_THREADS, CP_CTAS_PER_SM) col_pass_tc_kernel(
    const int8_t* __restrict__ R, const __nv_bfloat16* __restrict__ X,
    float a, long long n_r, long long n_c, int kp, int n_cb,
    long long chunk_rows, bool vec, float* __restrict__ S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb = static_cast<int>(blockIdx.x % n_cb);
#define COL_PASS_CTA(ny)                                                    \
  col_pass_cta<IMPLICIT, ny>(R, X, a, n_r, n_c, n_cb, chunk_rows, vec, S, \
                             smem)
  switch (cb == 0 ? kp / 8 : 0) {
    case 0: COL_PASS_CTA(0); break;
    case 1: COL_PASS_CTA(1); break;
    case 2: COL_PASS_CTA(2); break;
    case 3: COL_PASS_CTA(3); break;
    default: COL_PASS_CTA(4); break;
  }
#undef COL_PASS_CTA
}

// b and corr of the col pass from its chunk sums: for each (column,
// operand column), the chunks added in chunk order, then stored as
// store_output expands them (a grid-stride loop).
__global__ void col_reduce_kernel(const float* __restrict__ S,
                                  long long n_chunks, long long n_c, int K,
                                  int kp, long long ld, float* __restrict__ B,
                                  float* __restrict__ C) {
  const long long n = n_c * ld;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = S[i];
    for (long long ch = 1; ch < n_chunks; ++ch) v = __fadd_rn(v, S[ch * n + i]);
    const long long gc = i / ld;
    store_output(v, gc, static_cast<int>(i - gc * ld), K, kp, B, C);
  }
}

// Column blocks of TC_W operand columns for rank K: b padded to 8, then
// the K(K+1)/2 pairs of corr padded to 8.
int column_blocks(int K) {
  const int width = (K + 7) / 8 * 8 + (K * (K + 1) / 2 + 7) / 8 * 8;
  return (width + TC_W - 1) / TC_W;
}

// One col pass launch on a card of `sms` SMs. A CTA owns CP_COLS columns
// of R in one column block; R's rows split into chunks of whole CP_ROWS
// stages, as many as make about CP_WAVES waves of CTAs (five at ML-20M
// width and K = 10, one at K = 32), at most one per stage. `scratch`
// floats hold each chunk's sums of the operand columns. False where the
// 1-D grid cannot hold the CTAs.
struct ColPlan {
  long long chunk_rows, chunks, ctas, scratch;
};

bool col_plan(long long n_r, long long n_c, int K, int sms, ColPlan* p) {
  const int n_cb = column_blocks(K);
  const long long tiles = (n_c + CP_COLS - 1) / CP_COLS * n_cb;
  const long long stages = (n_r + CP_ROWS - 1) / CP_ROWS;
  const long long slots = static_cast<long long>(CP_WAVES) * CP_CTAS_PER_SM * sms;
  long long want = (2 * slots + tiles) / (2 * tiles);  // to the nearest
  want = want < 1 ? 1 : want > stages ? stages : want;
  p->chunk_rows = (stages + want - 1) / want * CP_ROWS;
  p->chunks = (n_r + p->chunk_rows - 1) / p->chunk_rows;
  p->ctas = p->chunks * tiles;
  p->scratch = p->chunks * n_c * n_cb * TC_W;
  return p->ctas <= 0x7fffffffLL;
}

// col_plan for `device`, from its SM count.
cudaError_t col_plan_on(long long n_r, long long n_c, int K, int device,
                        ColPlan* p) {
  if (n_r <= 0 || n_c <= 0 || K < 1 || K > MAX_K) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return col_plan(n_r, n_c, K, sms, p) ? cudaSuccess : cudaErrorInvalidValue;
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
// pass_operand). Launches on `stream`, allocates nothing. Returns the
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

// The col pass's row chunks and scratch on `device` (see col_plan):
// *chunk_rows R rows a chunk, *scratch floats for dense_col_pass. Returns
// the CUDA error code, cudaErrorInvalidValue past the grid.
extern "C" int dense_col_pass_plan(long long n_r, long long n_c, int K,
                                   int device, long long* chunk_rows,
                                   long long* scratch) {
  ColPlan p;
  const cudaError_t err = col_plan_on(n_r, n_c, K, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *chunk_rows = p.chunk_rows;
  *scratch = p.scratch;
  return 0;
}

// Col pass: b (n_c, K) and corr (n_c, K^2) f32 from R (n_r, n_c) int8 and
// the operand x_op, (n_r, n_cb * TC_W) bf16 (ops/dense_fused.py:
// pass_operand of the row-side factors), through `scratch` (the floats
// dense_col_pass_plan gives). Same contract as dense_row_pass otherwise.
extern "C" int dense_col_pass(int implicit, const void* r, const void* x_op,
                              float ascale, long long n_r, long long n_c,
                              int K, void* b, void* corr, void* scratch,
                              int device, void* stream) {
  if (!valid(r, x_op, n_r, n_c, K, b, corr) || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(x_op) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ColPlan p;
  err = col_plan_on(n_r, n_c, K, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kp = (K + 7) / 8 * 8;
  const int n_cb = column_blocks(K);
  const long long ld = static_cast<long long>(n_cb) * TC_W;
  const long long reduce_blocks =
      (n_c * ld + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const size_t smem = 256 * 4 + static_cast<size_t>(CP_STAGES) *
                                    (CP_ROWS * CP_RSTRIDE + CP_ROWS * TC_W * 2);
  auto st = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<float*>(scratch);
  auto kern = implicit ? &col_pass_tc_kernel<true> : &col_pass_tc_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(p.ctas), CP_THREADS, smem, st>>>(
      static_cast<const int8_t*>(r), static_cast<const __nv_bfloat16*>(x_op),
      ascale, n_r, n_c, kp, n_cb, p.chunk_rows, aligned16(r, n_c), sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  col_reduce_kernel<<<static_cast<unsigned>(reduce_blocks < 0x7fffffffLL
                                                ? reduce_blocks
                                                : 0x7fffffffLL),
                      REDUCE_THREADS, 0, st>>>(sp, p.chunks, n_c, K, kp, ld,
                                               static_cast<float*>(b),
                                               static_cast<float*>(corr));
  return static_cast<int>(cudaGetLastError());
}
