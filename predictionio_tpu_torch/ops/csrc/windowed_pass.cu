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
// Why not the tensor cores. The TPU kernel builds an (S, B_E) one-hot in
// VMEM per block and contracts it on the MXU. On Hopper that product is
// 128 times the real arithmetic (S one-hot rows for each slot's one), and
// f32 accuracy would need three TF32 products: over 4 ms at ML-25M's
// shape, against a bound of 0.55 ms set by the bytes. So the design is
// about shared-memory instructions per term, overlapped staging and one
// streaming store, not about mma.
//
// partials_kernel. Read the sums as the augmented outer product of
// z = (y_0 .. y_{K-1}, 1): gram pairs (i, j) with i <= j < K weigh
// z_i z_j by w_g, the b entries (d, K) weigh z_d * 1 by w_b, and only
// pairs a <= b are summed, K + K(K+1)/2 of them (65 at K = 10, not 110).
// One thread owns a 2 x 2 register tile of that upper triangle, rows a0,
// a0+1 by columns b0, b0+1 (20 tiles, one warp, at K = 10; 152 tiles,
// five warps, at K = 32): a slot costs a warp two 8-byte loads of its
// staged factor row for four terms a thread, and every 4 slots three
// 16-byte broadcast loads of their local ids and weights. One CTA owns
// one block and one group of its output rows (all 128 at K = 10, 26 at
// K = 32, so that a group's tile fits TILE_BYTES); the group's sums live
// in a shared-memory tile, zeroed first, and the CTA skips the slots of
// other groups. Each thread keeps its four sums in registers while the
// local id repeats and adds them into its own cells of the tile when the
// id changes: one writer per cell, in slot order, so unsorted and
// recurring ids are summed right with no atomics, and a relaunch gives
// the same bits. A batch of 16 slots that all continue the current row
// (the common case: the planner sorts the ids) is summed with no check
// between slots. At the end the CTA stores its rows of pb and pg,
// contiguous spans, in one pass (16-byte streaming stores where a row is
// a multiple of 4 floats), each gram pair to both (i, j) and (j, i): the
// two cells hold the same bits, as y_i * y_j = y_j * y_i exactly. Rows no
// slot reaches are stored as the tile's zeros, so the output needs no
// clearing.
//
// Staging, in stages of STAGE slots: each stage's four per-slot arrays
// are copied to shared memory with cp.async four stages ahead, and the
// factor rows of the CTA's slots gathered from L2 with cp.async (16, 8
// or 4 bytes a copy, as K's alignment allows) two stages ahead, so the
// CTA sums one stage while later ones arrive. A src outside the factors
// reads a zero row, never past them.
//
// Bound at the main path's shape (ML-25M's users side: 25,088 blocks of
// 1,024 slots, K = 10): reading the slots (src, w_b, w_g, local: 16 B
// each, 0.41 GB) and the factors once, and writing the partials (S * D *
// 4 B per block, D = K + K^2, 1.41 GB) once, is 0.545 ms at 3.35 TB/s.
// The operations, 2 per term (5.5 GFLOP), are 0.08 ms at 67 TFLOP/s f32.
// So the pass is bytes-bound; the combine reads the partials once more
// (0.44 ms). Times against the bound: PERF.md.
//
// The combine: one thread per output element walks its window's blocks
// (contiguous, as block_window is sorted) in order. Windows without blocks
// read 0; padding blocks carry zero weights, so their partials are +-0 and
// add exactly nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;
constexpr int MAX_THREADS = 256;  // the combine's CTA
constexpr int WARP = 32;
constexpr int STAGE = 64;         // slots a stage
constexpr int SLOT_BUFS = 5;      // stages of slot arrays: read 4 ahead
constexpr int ROW_BUFS = 3;       // stages of factor rows: gathered 2 ahead
constexpr int UNROLL = 16;        // slots whose loads are issued together
constexpr int TILE_BYTES = 64 * 1024;  // most output tile a CTA holds

// One partials launch. The 2 x 2 tiles cover the upper triangle of the
// augmented outer product z z^T (rows of the first K entries only), one
// thread each; a block's S output rows are cut into groups of `rows`,
// one CTA per block and group, so that a group's tile fits TILE_BYTES.
struct PartialsPlan {
  int kp;       // staged entries a slot: K, the 1, zeros to 4-aligned
  int nb;       // tile columns: ceil((K + 1) / 2)
  int tiles;    // tiles, and threads that sum
  int threads;  // a CTA: whole warps
  int rows;     // output rows a CTA (the last group may hold fewer)
  int groups;   // CTAs a block
  size_t smem;
};

bool partials_plan(int K, int s_rows, PartialsPlan* p) {
  if (K < 1 || K > MAX_K || s_rows < 1) return false;
  p->kp = (K + 1 + 3) / 4 * 4;
  p->nb = (K + 2) / 2;
  const int na = (K + 1) / 2;  // tile rows
  p->tiles = 0;
  for (int bi = 0; bi < na; ++bi) p->tiles += p->nb - bi;
  p->threads = (p->tiles + WARP - 1) / WARP * WARP;
  const int fit = max(1, TILE_BYTES / (16 * p->tiles));
  p->groups = (s_rows + fit - 1) / fit;
  p->rows = (s_rows + p->groups - 1) / p->groups;
  const size_t map = (static_cast<size_t>(K) + K * K) * 2;
  p->smem = static_cast<size_t>(p->rows) * p->tiles * 16 +  // output tile
            SLOT_BUFS * STAGE * 16 +                          // slot arrays
            ROW_BUFS * STAGE * static_cast<size_t>(p->kp) * 4 +  // rows
            (map + 15) / 16 * 16;
  return p->groups <= 65535;
}

// The linear index of tile (bi, bj), bi <= bj, row-major over the
// triangle of `nb` tile columns.
__device__ __forceinline__ int tile_index(int bi, int bj, int nb) {
  return bi * nb - bi * (bi - 1) / 2 + (bj - bi);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most the N groups committed last are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage's slot arrays in shared memory: local ids, w_b, w_g, src.
struct Slots {
  int* loc;
  float* wb;
  float* wg;
  int* src;
  __device__ __forceinline__ explicit Slots(unsigned char* at)
      : loc(reinterpret_cast<int*>(at)),
        wb(reinterpret_cast<float*>(at) + STAGE),
        wg(reinterpret_cast<float*>(at) + 2 * STAGE),
        src(reinterpret_cast<int*>(at) + 3 * STAGE) {}
};

// Starts the copies of the four slot arrays of the stage at e0 (n slots
// of the block at `base`) into `s`: 16 bytes a copy where `vec` (a whole
// stage, 16-byte aligned); slots past n become padding (local id -1).
__device__ __forceinline__ void copy_slots(
    Slots s, const int* __restrict__ SRC, const float* __restrict__ WB,
    const float* __restrict__ WG, const int* __restrict__ LOC, long long base,
    int e0, int n, bool vec) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  if (vec && n == STAGE) {
    constexpr int PER = STAGE / 4;  // 16-byte copies an array
    for (int q = tid; q < 4 * PER; q += nt) {
      const int a = q / PER, e = (q - a * PER) * 4;
      const long long g = base + e0 + e;
      if (a == 0) cp_async(s.loc + e, LOC + g, 16);
      else if (a == 1) cp_async(s.wb + e, WB + g, 16);
      else if (a == 2) cp_async(s.wg + e, WG + g, 16);
      else cp_async(s.src + e, SRC + g, 16);
    }
    return;
  }
  for (int e = tid; e < STAGE; e += nt) {
    if (e < n) {
      const long long g = base + e0 + e;
      cp_async(s.loc + e, LOC + g, 4);
      cp_async(s.wb + e, WB + g, 4);
      cp_async(s.wg + e, WG + g, 4);
      cp_async(s.src + e, SRC + g, 4);
    } else {
      s.loc[e] = -1;
    }
  }
}

// Starts the copies of the factor rows of a stage's slots (landed in
// `s`) into `ys`, `chunk` floats a copy, for the slots of the CTA's
// output rows [g0, g0 + nr) only; a src outside the factors reads a zero
// row. The entries from K on (the 1, then zeros) are written once, at
// the start.
__device__ __forceinline__ void gather_rows(Slots s, float* ys,
                                            const float* __restrict__ Y,
                                            long long n_src, int K, int kp,
                                            int g0, int nr, int chunk) {
  for (int e = static_cast<int>(threadIdx.x); e < STAGE;
       e += static_cast<int>(blockDim.x)) {
    if (static_cast<unsigned>(s.loc[e] - g0) >= static_cast<unsigned>(nr))
      continue;
    float* row = ys + e * kp;
    const int src = s.src[e];
    if (src >= 0 && src < n_src) {
      const float* g = Y + static_cast<long long>(src) * K;
      for (int c = 0; c < K; c += chunk) cp_async(row + c, g + c, chunk * 4);
    } else {
      for (int c = 0; c < K; ++c) row[c] = 0.0f;
    }
  }
}

// Adds a thread's run sums into its four cells of a tile row.
__device__ __forceinline__ void add_run(float4& cells, const float (&acc)[4]) {
  float4 v = cells;
  v.x = __fadd_rn(v.x, acc[0]);
  v.y = __fadd_rn(v.y, acc[1]);
  v.z = __fadd_rn(v.z, acc[2]);
  v.w = __fadd_rn(v.w, acc[3]);
  cells = v;
}

// One slot's four terms into a thread's sums: rows a0, a0 + 1 (ya) by
// columns b0, b0 + 1 (yb) of z z^T, each column weighed by w0 or w1.
__device__ __forceinline__ void add_terms(float (&acc)[4], float w0, float w1,
                                          float2 ya, float2 yb) {
  acc[0] = __fmaf_rn(w0, __fmul_rn(ya.x, yb.x), acc[0]);
  acc[1] = __fmaf_rn(w1, __fmul_rn(ya.x, yb.y), acc[1]);
  acc[2] = __fmaf_rn(w0, __fmul_rn(ya.y, yb.x), acc[2]);
  acc[3] = __fmaf_rn(w1, __fmul_rn(ya.y, yb.y), acc[3]);
}

// Stores nr rows of `width` cells, contiguous at `out`, from the tile:
// cell m of row r is tile word r * row_words + map[m]. A thread keeps its
// cells' places for all rows, and consecutive threads take consecutive
// cells of a row: 16 bytes a thread where a row is a multiple of 4 floats.
__device__ __forceinline__ void store_rows(float* __restrict__ out, int width,
                                           int nr, const short* map,
                                           const float* tile, int row_words) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  if (width % 4 == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    const int w4 = width / 4;
    for (int c = tid; c < w4; c += nt) {
      const int p0 = map[4 * c], p1 = map[4 * c + 1], p2 = map[4 * c + 2],
                p3 = map[4 * c + 3];
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float* row = tile + r * row_words;
        __stcs(out4 + r * w4 + c,
               make_float4(row[p0], row[p1], row[p2], row[p3]));
      }
    }
    return;
  }
  for (int m = tid; m < width; m += nt) {
    const int p = map[m];
#pragma unroll 4
    for (int r = 0; r < nr; ++r)
      __stcs(out + r * width + m, tile[r * row_words + p]);
  }
}

// GROUPS: the block's rows are cut into several groups, so a CTA checks
// a batch of slots for its rows before it loads their weights and rows;
// with one group every slot but padding is the CTA's, and the loads go
// first.
template <bool GROUPS>
__global__ void partials_kernel(
    const float* __restrict__ Y, long long n_src, int K,
    const int* __restrict__ SRC, const float* __restrict__ WB,
    const float* __restrict__ WG, const int* __restrict__ LOC, int b_e,
    int s_rows, PartialsPlan plan, int chunk, bool vec_slots,
    float* __restrict__ PB, float* __restrict__ PG) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = plan.kp, nb = plan.nb, tiles = plan.tiles;
  const int g0 = static_cast<int>(blockIdx.y) * plan.rows;  // first row
  const int nr = min(plan.rows, s_rows - g0);               // rows here
  float4* tile = reinterpret_cast<float4*>(smem);  // nr x tiles
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      tile + static_cast<size_t>(plan.rows) * tiles);  // SLOT_BUFS stages
  float* ys = reinterpret_cast<float*>(slots + SLOT_BUFS * STAGE * 16);
  short* map = reinterpret_cast<short*>(ys + ROW_BUFS * STAGE * kp);
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  const long long blk = blockIdx.x;
  const long long base = blk * b_e;
  const int n_stages = (b_e + STAGE - 1) / STAGE;
  auto slots_of = [&](int st) {
    return Slots(slots + (st % SLOT_BUFS) * STAGE * 16);
  };
  auto rows_of = [&](int st) { return ys + (st % ROW_BUFS) * STAGE * kp; };
  // one cp.async group a stage: the stage's own slot arrays in the
  // prologue, then those of the stage 4 ahead with the rows 2 ahead
  auto copy_stage = [&](int st) {
    if (st < n_stages)
      copy_slots(slots_of(st), SRC, WB, WG, LOC, base, st * STAGE,
                 min(STAGE, b_e - st * STAGE), vec_slots);
  };
  auto gather_stage = [&](int st) {
    if (st < n_stages)
      gather_rows(slots_of(st), rows_of(st), Y, n_src, K, kp, g0, nr, chunk);
  };
  for (int st = 0; st < 4; ++st) {
    copy_stage(st);
    cp_async_commit();
  }

  // where each output cell's value sits in a tile row: pb's cell d is the
  // entry (d, K) of z z^T, pg's cell (i, j) the pair (min, max)
  for (int d = tid; d < K + K * K; d += nt) {
    int a = d, b = K;
    if (d >= K) {
      const int i = (d - K) / K, j = (d - K) - i * K;
      a = min(i, j);
      b = max(i, j);
    }
    map[d] = static_cast<short>(tile_index(a >> 1, b >> 1, nb) * 4 +
                                (a & 1) * 2 + (b & 1));
  }
  for (int i = tid; i < nr * tiles; i += nt)
    tile[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < ROW_BUFS * STAGE; i += nt)
    for (int c = K; c < kp; ++c) ys[i * kp + c] = c == K ? 1.0f : 0.0f;

  // this thread's tile: rows a0, a0 + 1, columns b0, b0 + 1 of z z^T
  int bi = 0, g = tid;
  while (bi < nb && g >= nb - bi) {
    g -= nb - bi;
    ++bi;
  }
  const int a0 = 2 * bi, b0 = 2 * (bi + g);
  const bool col0_b = b0 == K, col1_b = b0 + 1 == K;  // weighed by w_b
  const bool owner = tid < tiles;

  cp_async_wait<3>();  // stage 0's slot arrays are in
  __syncthreads();
  gather_stage(0);
  cp_async_commit();
  cp_async_wait<3>();  // stage 1's
  __syncthreads();
  gather_stage(1);
  cp_async_commit();

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cur = -1;  // the row whose terms `acc` holds; -1 before the first
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<1>();  // this stage's rows, and the slots 2 ahead, are in
    __syncthreads();
    gather_stage(st + 2);
    copy_stage(st + 4);
    cp_async_commit();  // possibly empty: one group a stage
    if (owner) {
      const Slots s = slots_of(st);
      const float* y = rows_of(st);
      for (int e = 0; e < STAGE; e += UNROLL) {
        // the ids are the same for every thread: the branches below do
        // not diverge
        int l[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u += 4) {
          const int4 l4 = *reinterpret_cast<const int4*>(s.loc + e + u);
          l[u] = l4.x, l[u + 1] = l4.y, l[u + 2] = l4.z, l[u + 3] = l4.w;
        }
        if (GROUPS) {  // skip a batch with no slot on this CTA's rows
          unsigned off = ~0u;
#pragma unroll
          for (int u = 0; u < UNROLL; u += 4)
            off = min(off, min(min(static_cast<unsigned>(l[u] - g0),
                                   static_cast<unsigned>(l[u + 1] - g0)),
                               min(static_cast<unsigned>(l[u + 2] - g0),
                                   static_cast<unsigned>(l[u + 3] - g0))));
          if (off >= static_cast<unsigned>(nr)) continue;
        }
        float wb[UNROLL], wg[UNROLL];
        float2 ya[UNROLL], yb[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; u += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(s.wb + e + u);
          const float4 g4 = *reinterpret_cast<const float4*>(s.wg + e + u);
          wb[u] = b4.x, wb[u + 1] = b4.y, wb[u + 2] = b4.z, wb[u + 3] = b4.w;
          wg[u] = g4.x, wg[u + 1] = g4.y, wg[u + 2] = g4.z, wg[u + 3] = g4.w;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          ya[u] = *reinterpret_cast<const float2*>(y + (e + u) * kp + a0);
          yb[u] = *reinterpret_cast<const float2*>(y + (e + u) * kp + b0);
        }
        // every slot on row `cur`: reduced four slots at a time, not as
        // one chain of compares
        int diff = 0;
#pragma unroll
        for (int u = 0; u < UNROLL; u += 4)
          diff |= ((l[u] ^ cur) | (l[u + 1] ^ cur)) |
                  ((l[u + 2] ^ cur) | (l[u + 3] ^ cur));
        const bool run = diff == 0;
        if (run) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            add_terms(acc, col0_b ? wb[u] : wg[u], col1_b ? wb[u] : wg[u],
                      ya[u], yb[u]);
          continue;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (static_cast<unsigned>(l[u] - g0) >= static_cast<unsigned>(nr))
            continue;  // padding, or another group's row
          if (l[u] != cur) {
            if (cur >= 0) add_run(tile[(cur - g0) * tiles + tid], acc);
            acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
            cur = l[u];
          }
          add_terms(acc, col0_b ? wb[u] : wg[u], col1_b ? wb[u] : wg[u],
                    ya[u], yb[u]);
        }
      }
    }
    __syncthreads();  // this stage's buffers are consumed before refills
  }
  if (owner && cur >= 0) add_run(tile[(cur - g0) * tiles + tid], acc);
  __syncthreads();

  const float* words = reinterpret_cast<const float*>(tile);
  const long long row0 = blk * s_rows + g0;
  store_rows(PB + row0 * K, K, nr, map, words, tiles * 4);
  store_rows(PG + row0 * K * K, K * K, nr, map + K, words, tiles * 4);
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

auto partials_kernel_for(const PartialsPlan& p) {
  return p.groups > 1 ? &partials_kernel<true> : &partials_kernel<false>;
}

}  // namespace

// The partials launch at rank K and s_rows window rows on `device`:
// out[0] tiles (threads that sum), out[1] threads a CTA, out[2] output
// rows a CTA, out[3] CTAs a block, out[4] dynamic shared memory bytes a
// CTA, out[5] CTAs an SM can hold. Returns the CUDA error code, 0 on
// success.
extern "C" int block_partials_plan(int K, int s_rows, int device, int* out) {
  PartialsPlan p;
  if (out == nullptr || !partials_plan(K, s_rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kern = partials_kernel_for(p);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      p.threads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.tiles;
  out[1] = p.threads;
  out[2] = p.rows;
  out[3] = p.groups;
  out[4] = static_cast<int>(p.smem);
  out[5] = per_sm;
  return 0;
}

// Per-block partials: pb (n_blocks, s_rows, K) and pg (n_blocks, s_rows,
// K^2) f32 from the factors y (n_src, K) f32 and the per-slot src, w_b, w_g,
// local (n_blocks, b_e), int32 / f32 / f32 / int32. Launches on `stream`,
// allocates nothing. Returns the CUDA error code, 0 on success.
extern "C" int block_partials(const void* y, long long n_src, int K,
                              const void* src, const void* wb, const void* wg,
                              const void* local, long long n_blocks, int b_e,
                              int s_rows, void* pb, void* pg, int device,
                              void* stream) {
  PartialsPlan p;
  if (y == nullptr || src == nullptr || wb == nullptr || wg == nullptr ||
      local == nullptr || pb == nullptr || pg == nullptr || n_src <= 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffffLL || b_e < 1 ||
      !partials_plan(K, s_rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks == 0) return 0;
  const auto kern = partials_kernel_for(p);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the slot arrays in 16-byte copies where every stage is so aligned
  const bool vec_slots =
      b_e % 4 == 0 && (reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(wb) |
                       reinterpret_cast<uintptr_t>(wg) |
                       reinterpret_cast<uintptr_t>(local)) % 16 == 0;
  // floats a gathered copy: 4 or 2 where every factor row is so aligned
  const auto at = reinterpret_cast<uintptr_t>(y);
  const int chunk = K % 4 == 0 && at % 16 == 0   ? 4
                    : K % 2 == 0 && at % 8 == 0 ? 2
                                                : 1;
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(p.groups));
  kern<<<grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n_src, K, static_cast<const int*>(src),
      static_cast<const float*>(wb), static_cast<const float*>(wg),
      static_cast<const int*>(local), b_e, s_rows, p, chunk, vec_slots,
      static_cast<float*>(pb), static_cast<float*>(pg));
  return static_cast<int>(cudaGetLastError());
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
