// Fused score + exclusion + top-k over a padded item-factor slab, for
// Hopper (sm_90a). Never writes the (B, I_p) score matrix to memory.
//
// Replaces two TPU kernels of predictionio_tpu/ops/recommend_pallas.py,
// which share one assembly (_fused_call) and one body (_make_kernel):
// fused_recommend_topk (entries recommend_select and recommend_topk
// below) and fused_masked_topk (entries masked_select and masked_topk),
// the same exclusion and top-k over a PRECOMPUTED (B, I_p) score matrix,
// the tail of the Universal Recommender's batched history scoring. The
// TPU kernel walks item tiles in order and merges each into one running
// list in VMEM; blocks here run in parallel with no carry, so the work
// splits into passes, all launched on the caller's stream. Each selector
// has two routes, chosen by k alone (ops/recommend.py:topk_route):
//
// k <= SELECT_MAX_K (1,024), the select route, two launches
// (recommend_select, masked_select):
//   segment pass  one block per (segment of SEGMENT = 4,096 columns,
//                 row): each column's score computed from the slab rows,
//                 staged in shared memory (ScoredSlab), or read with
//                 16-byte loads (ScoreMatrix), the masks, the keys below,
//                 and a radix
//                 select of the segment's top min(k, columns) keys (a
//                 256-bin histogram of 8 score bits per round, in shared
//                 memory, narrowing to the bin that holds rank k; bits
//                 that all remaining keys share cost no round), the
//                 score it stops at taken by the lowest columns, ranked
//                 by one scan.
//   row pass      one block per row: the same radix select over the
//                 segments' k candidates each, a bitonic sort of the k
//                 selected keys, and the emit.
//
// k > SELECT_MAX_K, the sort route (recommend_topk, masked_topk):
//   pass 1  one block per (chunk of CHUNK item columns, query row): score
//           or read every column of the chunk, apply the masks, sort the
//           chunk's keys in shared memory (bitonic), write the top
//           min(k, CHUNK).
//   merge   a tree of launches; each block merges two neighbouring sorted
//           lists of one row into the top min(k, a + b) by rank (every
//           key's output slot = its index in its own list + the count of
//           keys above it in the other list, by binary search).
//   emit    the final list of each row → (values, indices).
//
// Order is (score descending, column ascending): the key is the score's
// order-preserving bits above (0xffffffff - column), so keys are unique
// and any exact selection reproduces lax.top_k bit for bit, ties
// included. Masked columns score NEG_INF (-1e30); pad columns at or above
// n_items score -FLT_MAX, below NEG_INF; columns past I_p in the last
// chunk or segment never reach the output.
//
// Scores: one chain over K in index order per (query, column), each
// multiply and add rounded on its own (__fmul_rn/__fadd_rn are never
// contracted into an FMA), int8 summed in int32 and converted once, bf16
// widened to f32. The plain PyTorch version (ops/recommend.py:
// plain_scores) does the same operations, so the two agree bit for bit,
// and no score depends on the batch it rides in. Optional scales then
// multiply as (s * q_scale[b]) * item_scale[col]. That chain is why
// there are no tensor cores (wgmma, mma.sync) here: they sum in their own
// order and at their own precision, and a row's answer would then depend
// on the kernel's tiling and differ from the plain version's. Nor would
// they pay: at the main-path shape the whole product is 34 MFLOP at
// B = 64, ~0.5 us on the CUDA cores.
//
// Bound at the main-path shape (ML-20M: I_p = 26,752, K = 10, k = 128,
// f32): B = 64 moves ~1.14 MB (1.07 MB of item factors, outputs 65 KB),
// 0.34 us at 3.35 TB/s, and does 34 MFLOP, 0.51 us at 67 TFLOP/s of f32
// CUDA-core peak: operations-bound at ~0.5 us. B = 1 is bytes-bound at
// ~0.32 us. Neither rate bounds the kernel: its time goes to launches,
// to selecting, and to the latency of the chains (one dependent add a
// factor). The select route needs no sort of the whole row and two
// launches where the sort route takes 2 + log2(chunks) (seven at this
// shape). At B = 64 each of the 7 x 64 segment blocks copies its
// segment's slab rows from L2 into shared memory (~68 MB in all at f32);
// one block for several rows of a segment would share the copies, but
// they are a small share of the segment pass (PERF.md §6).
//
// The precomputed-score selector at the UR catalog (I_p = 100,096, k =
// 64, bit words) is bytes-bound: the scores, the words and the outputs
// once, 25.7 MB at B = 64, ~7.7 us at 3.35 TB/s; at B = 64, 25 x 64 =
// 1,600 segment blocks fill the 132 SMs ~3 times over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 1024;  // == ops/recommend.py:_CHUNK
constexpr int THREADS = 256;
constexpr float NEG_INF_F = -1e30f;
constexpr float SENTINEL_F = -FLT_MAX;

__device__ __forceinline__ uint64_t make_key(float v, uint32_t col) {
  v = __fadd_rn(v, 0.0f);  // -0.0 -> +0.0: the two zeros are one value
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | (0xffffffffu - col);
}

__device__ __forceinline__ float key_value(uint64_t key) {
  uint32_t u = static_cast<uint32_t>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_column(uint64_t key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// the key of one column: masked columns score NEG_INF, dead pads at or
// above n_items the sentinel
__device__ __forceinline__ uint64_t masked_key(float s, bool masked, int col,
                                               int n_items) {
  if (masked) s = NEG_INF_F;
  if (col >= n_items) s = SENTINEL_F;
  return make_key(s, static_cast<uint32_t>(col));
}

// the key of one column after exclusion (bit words, else the row list)
// and the dead-pad sentinel
__device__ __forceinline__ uint64_t column_key(
    float s, int b, int col, int I_p, int n_items,
    const int32_t* __restrict__ mask_bits, const int* ex, int n_excl) {
  bool masked = false;
  if (mask_bits != nullptr) {
    const uint32_t w = static_cast<uint32_t>(
        mask_bits[static_cast<size_t>(b) * (I_p / 32) + (col >> 5)]);
    masked = (w >> (col & 31)) & 1u;
  } else {
    for (int e = 0; e < n_excl; ++e) masked |= (ex[e] == col);
  }
  return masked_key(s, masked, col, n_items);
}

// bitonic sort of n (a power of two) keys in shared memory, descending;
// every thread of the block calls it
__device__ __forceinline__ void sort_desc(uint64_t* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = keys[i];
        const uint64_t c = keys[j];
        const bool desc = (i & size) == 0;
        if (desc ? (a < c) : (a > c)) {
          keys[i] = c;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// a chunk's keys sorted, then the top kc to dst
__device__ __forceinline__ void sort_chunk_and_write(uint64_t* keys,
                                                     uint64_t* dst, int kc) {
  sort_desc(keys, CHUNK);
  for (int t = threadIdx.x; t < kc; t += blockDim.x) dst[t] = keys[t];
}

// DT: 0 f32, 1 bf16, 2 int8 (q and itf share it)
template <int DT>
__global__ void __launch_bounds__(THREADS) score_chunk_kernel(
    const void* __restrict__ q_, const void* __restrict__ itf_,
    const float* __restrict__ q_scale, const float* __restrict__ item_scale,
    const int32_t* __restrict__ mask_bits, const int32_t* __restrict__ excl,
    int n_excl, int K, int I_p, int n_items, int kc,
    uint64_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;                                      // CHUNK
  float* qf = reinterpret_cast<float*>(keys + CHUNK);         // K (f32/bf16)
  int* qi = reinterpret_cast<int*>(keys + CHUNK);             // K (int8)
  int* ex = reinterpret_cast<int*>(keys + CHUNK) + K;         // n_excl

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * K + j;
    if constexpr (DT == 2) {
      qi[j] = static_cast<const int8_t*>(q_)[o];
    } else if constexpr (DT == 1) {
      qf[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(q_)[o]);
    } else {
      qf[j] = static_cast<const float*>(q_)[o];
    }
  }
  for (int e = threadIdx.x; e < n_excl; e += blockDim.x)
    ex[e] = excl[static_cast<size_t>(b) * n_excl + e];
  __syncthreads();

  const float qs = q_scale != nullptr ? q_scale[b] : 1.0f;
  for (int t = threadIdx.x; t < CHUNK; t += blockDim.x) {
    const int col = chunk * CHUNK + t;
    if (col >= I_p) {  // past the slab: below every real column
      keys[t] = 0xffffffffu - static_cast<uint32_t>(col);
      continue;
    }
    const size_t row = static_cast<size_t>(col) * K;
    float s;
    if constexpr (DT == 2) {
      const int8_t* x = static_cast<const int8_t*>(itf_) + row;
      int acc = qi[0] * static_cast<int>(x[0]);
      for (int j = 1; j < K; ++j) acc += qi[j] * static_cast<int>(x[j]);
      s = __int2float_rn(acc);
    } else if constexpr (DT == 1) {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(itf_) + row;
      s = __fmul_rn(qf[0], __bfloat162float(x[0]));
      for (int j = 1; j < K; ++j)
        s = __fadd_rn(s, __fmul_rn(qf[j], __bfloat162float(x[j])));
    } else {
      const float* x = static_cast<const float*>(itf_) + row;
      s = __fmul_rn(qf[0], x[0]);
      for (int j = 1; j < K; ++j) s = __fadd_rn(s, __fmul_rn(qf[j], x[j]));
    }
    if (q_scale != nullptr) s = __fmul_rn(__fmul_rn(s, qs), item_scale[col]);
    keys[t] = column_key(s, b, col, I_p, n_items, mask_bits, ex, n_excl);
  }
  __syncthreads();
  sort_chunk_and_write(
      keys, out + (static_cast<size_t>(b) * gridDim.x + chunk) * kc, kc);
}

// pass 1 over a precomputed (B, I_p) f32 score matrix: the same masks,
// keys and chunk sort as score_chunk_kernel, with the score read in
// place of the dot product
__global__ void __launch_bounds__(THREADS) masked_chunk_kernel(
    const float* __restrict__ scores, const int32_t* __restrict__ mask_bits,
    const int32_t* __restrict__ excl, int n_excl, int I_p, int n_items,
    int kc, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;                              // CHUNK
  int* ex = reinterpret_cast<int*>(keys + CHUNK);     // n_excl

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  for (int e = threadIdx.x; e < n_excl; e += blockDim.x)
    ex[e] = excl[static_cast<size_t>(b) * n_excl + e];
  __syncthreads();

  const float* row = scores + static_cast<size_t>(b) * I_p;
  for (int t = threadIdx.x; t < CHUNK; t += blockDim.x) {
    const int col = chunk * CHUNK + t;
    if (col >= I_p) {  // past the matrix: below every real column
      keys[t] = 0xffffffffu - static_cast<uint32_t>(col);
      continue;
    }
    keys[t] = column_key(row[col], b, col, I_p, n_items, mask_bits, ex,
                         n_excl);
  }
  __syncthreads();
  sort_chunk_and_write(
      keys, out + (static_cast<size_t>(b) * gridDim.x + chunk) * kc, kc);
}

// keys in a (descending, unique) list of n above `key`
__device__ __forceinline__ int count_above(const uint64_t* a, int n,
                                           uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// length of list m at merge level `level`: the top k of the columns of
// the chunks it covers
__device__ __forceinline__ int list_len(int level, int m, int n0, int k) {
  const long long first = static_cast<long long>(m) << level;
  long long span = 1LL << level;
  if (n0 - first < span) span = n0 - first;
  const long long cols = span * CHUNK;
  return static_cast<int>(cols < k ? cols : k);
}

__global__ void __launch_bounds__(THREADS) merge_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int level,
    int n_in, int stride_in, int stride_out, int n0, int k) {
  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const uint64_t* A = in + (static_cast<size_t>(b) * n_in + 2 * m) * stride_in;
  const uint64_t* B = A + stride_in;
  const int la = list_len(level, 2 * m, n0, k);
  const int lb = 2 * m + 1 < n_in ? list_len(level, 2 * m + 1, n0, k) : 0;
  const int lo = la + lb < k ? la + lb : k;
  uint64_t* O = out + (static_cast<size_t>(b) * gridDim.x + m) * stride_out;
  for (int i = threadIdx.x; i < la; i += blockDim.x) {
    const int p = i + count_above(B, lb, A[i]);
    if (p < lo) O[p] = A[i];
  }
  for (int j = threadIdx.x; j < lb; j += blockDim.x) {
    const int p = j + count_above(A, la, B[j]);
    if (p < lo) O[p] = B[j];
  }
}

__global__ void __launch_bounds__(THREADS) emit_kernel(
    const uint64_t* __restrict__ in, int stride, int k,
    float* __restrict__ vals, int32_t* __restrict__ idx) {
  const int b = blockIdx.x;
  const uint64_t* L = in + static_cast<size_t>(b) * stride;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const uint64_t key = L[t];
    vals[static_cast<size_t>(b) * k + t] = key_value(key);
    idx[static_cast<size_t>(b) * k + t] = key_column(key);
  }
}

// The merge tree over pass 1's n0 lists per row (in a), then the emit;
// returns the CUDA error code, 0 on success.
int merge_and_emit(uint64_t* a, uint64_t* bb, int n0, int kc, int B, int k,
                   cudaStream_t st, float* vals, int32_t* idx) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = n0, level = 0, stride = kc;
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    const long long cap = static_cast<long long>(CHUNK) << (level + 1);
    const int stride_out = static_cast<int>(cap < k ? cap : k);
    merge_kernel<<<dim3(n_out, B), THREADS, 0, st>>>(
        a, bb, level, n, stride, stride_out, n0, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    uint64_t* t = a;
    a = bb;
    bb = t;
    n = n_out;
    stride = stride_out;
    ++level;
  }
  emit_kernel<<<B, THREADS, 0, st>>>(a, stride, k, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// masked_select: the precomputed-score selector by radix select
// ---------------------------------------------------------------------------

constexpr int SEGMENT = 4096;       // == ops/recommend.py:SELECT_SEGMENT
constexpr int SELECT_MAX_K = 1024;  // == ops/recommend.py:SELECT_MAX_K
constexpr int SEL_THREADS = 256;    // the bin scan gives each thread one bin
constexpr int SEG_VECS = SEGMENT / (4 * SEL_THREADS);  // float4s per thread
constexpr int SEG_KEYS = 4 * SEG_VECS;
// copies of the radix histogram: lane l counts into copy l % HIST_COPIES,
// so the lanes of a warp whose keys share a bin (scores of one magnitude)
// collide HIST_COPIES times less; 257 words apart, the copies of a bin
// fall in distinct banks
constexpr int HIST_COPIES = 8;
constexpr int HIST_STRIDE = 257;
// candidate keys the row pass copies into shared memory; more stream
// from device memory on every round
constexpr int ROW_SMEM_MAX = 200 * 1024;

struct SelectShared {
  unsigned hist[HIST_COPIES * HIST_STRIDE];
  unsigned warp_sum[SEL_THREADS / 32];
  uint64_t all[SEL_THREADS / 32], any[SEL_THREADS / 32];
  uint64_t scan[SEL_THREADS / 32];  // the segment pass's tie-rank scan
  unsigned bin, above, count, fill;
};

__device__ __forceinline__ uint32_t warp_and(uint32_t v) {
  return __reduce_and_sync(0xffffffffu, v);
}
__device__ __forceinline__ uint32_t warp_or(uint32_t v) {
  return __reduce_or_sync(0xffffffffu, v);
}
__device__ __forceinline__ uint64_t warp_and(uint64_t v) {
  return static_cast<uint64_t>(warp_and(static_cast<uint32_t>(v >> 32))) << 32 |
         warp_and(static_cast<uint32_t>(v));
}
__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  return static_cast<uint64_t>(warp_or(static_cast<uint32_t>(v >> 32))) << 32 |
         warp_or(static_cast<uint32_t>(v));
}
__device__ __forceinline__ int highest_bit(uint32_t v) { return 31 - __clz(v); }
__device__ __forceinline__ int highest_bit(uint64_t v) {
  return 63 - __clzll(static_cast<long long>(v));
}

// What a radix select picks: the keys above t, and, when `exact`, the
// first `ties` of the keys equal to t (else every key at or above t).
template <class Key>
struct Threshold {
  Key t;
  bool exact;
  unsigned ties;
};

// Radix select of the block's kk largest keys. Each round counts an
// 8-bit digit of the keys that share the bits fixed so far (shared-memory
// atomics into HIST_COPIES copies of the histogram), and a suffix scan
// finds the bin that holds rank `remaining`. When that bin holds
// exactly the keys still wanted, every key at or above the threshold
// (its lower bits zero) is selected; when all bits are fixed and more
// keys than wanted equal the threshold, the caller takes `ties` of them
// (unique keys never tie). Counts do not depend on the order of the
// atomics, so the selection is exact. When a bin keeps many keys (every
// score 0 of a user with little history, say), the next round first ANDs
// and ORs them: the bits they all share are fixed at once, and the digit
// starts at the highest bit where they differ, so long common prefixes
// cost no rounds. Needs kk not above the valid keys. for_each(f) calls
// f(key, valid) on each of the thread's keys, equally often in every
// lane. Every thread of the block calls it. It returns with no barrier
// after its last reads of sh.all, sh.any, sh.bin, sh.above and sh.count,
// which slower warps may still be making: the caller writes none of them
// before a __syncthreads().
template <class Key, class ForEach>
__device__ Threshold<Key> radix_threshold(ForEach for_each, unsigned kk,
                                          SelectShared& sh) {
  constexpr int BITS = 8 * sizeof(Key);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Key prefix = 0;  // candidates' bits at and above `top` are prefix's
  int top = BITS;
  unsigned remaining = kk;
  bool narrow = false;
  for (;;) {
    Key high = top == BITS ? Key(0) : ~Key(0) << top;
    if (narrow) {
      Key all = ~Key(0), any = 0;
      for_each([&](Key key, bool valid) {
        if (valid && (key & high) == prefix) {
          all &= key;
          any |= key;
        }
      });
      all = warp_and(all);
      any = warp_or(any);
      if (lane == 0) {
        sh.all[warp] = all;
        sh.any[warp] = any;
      }
      __syncthreads();
      for (int w = 0; w < SEL_THREADS / 32; ++w) {
        all &= static_cast<Key>(sh.all[w]);
        any |= static_cast<Key>(sh.any[w]);
      }
      const Key diff = (all ^ any) & ~high;
      if (diff == 0) return {all, true, remaining};  // one value is left
      const int b = highest_bit(diff);
      prefix |= all & ~high & ~((Key(2) << b) - Key(1));  // shared above b
      top = b + 1;
      high = ~Key(0) << top;
    }
    const int shift = top > 8 ? top - 8 : 0;
    for (int c = 0; c < HIST_COPIES; ++c)
      sh.hist[c * HIST_STRIDE + threadIdx.x] = 0u;
    __syncthreads();
    unsigned* hist = sh.hist + (lane % HIST_COPIES) * HIST_STRIDE;
    for_each([&](Key key, bool valid) {
      if (valid && (key & high) == prefix)
        atomicAdd(&hist[static_cast<unsigned>(key >> shift) & 255u], 1u);
    });
    __syncthreads();
    // thread t holds bin 255 - t; its inclusive sum counts the keys in
    // bins >= 255 - t
    unsigned h = 0u;
    for (int c = 0; c < HIST_COPIES; ++c)
      h += sh.hist[c * HIST_STRIDE + 255 - threadIdx.x];
    unsigned incl = h;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh.warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sh.warp_sum[w];
    if (incl - h < remaining && remaining <= incl) {
      sh.bin = 255u - threadIdx.x;
      sh.above = incl - h;
      sh.count = h;
    }
    __syncthreads();
    // the digit's bits at and above `top` are prefix's own: OR is a no-op
    prefix |= static_cast<Key>(sh.bin) << shift;
    remaining -= sh.above;
    if (sh.count == remaining) return {prefix, false, 0u};
    if (shift == 0) return {prefix, true, remaining};  // all bits fixed
    narrow = sh.count > 32u;
    top = shift;
  }
}

// Where the segment pass's scores come from. prepare(b, smem) runs on
// every thread before the kernel's first barrier; load4(b, col, smem)
// gives the scores of columns col..col+3 of row b (col a multiple of 4,
// below I_p), called by all lanes of a warp together.
//
// ScoreMatrix: a precomputed (B, I_p) f32 matrix, one 16-byte load.
struct ScoreMatrix {
  const float* scores;
  int I_p;
  __device__ __forceinline__ void prepare(int, float*) const {}
  __device__ __forceinline__ float4 load4(int b, int col, const float*) const {
    return __ldcs(reinterpret_cast<const float4*>(
        scores + static_cast<size_t>(b) * I_p + col));
  }
};

// ScoredSlab: each column's score from the row's query factors (put in
// shared memory by prepare) and its slab row; DT as in
// score_chunk_kernel. A warp's threads hold the keys of 128 consecutive
// columns, four each, but score them lane + 32 e (e < 4): four chains a
// lane, each over K in index order, side by side, with a lane's rows K
// elements apart; the scores then trade places through shared memory.
// STAGED first copies the warp's 128 slab rows (128 K esz contiguous
// bytes) into shared memory with 16-byte loads, all lanes on neighbouring
// addresses; else each factor is read from the slab where it lies. The
// dynamic shared memory holds XCH_FLOATS exchange floats, the K query
// factors (rounded up to 4) and, STAGED, each warp's rows. Needs a warp's
// 128 columns all below I_p (I_p a multiple of 128).
constexpr int XCH_FLOATS = SEL_THREADS * 4;  // 128 scores a warp
// the most shared memory the STAGED rows of a block may take: two blocks
// an SM (f32 up to K = 24, bf16 48, int8 96); wider rows are read where
// they lie
constexpr int STAGE_MAX_BYTES = 96 * 1024;

template <int DT, bool STAGED>
struct ScoredSlab {
  static constexpr int ESZ = DT == 0 ? 4 : (DT == 1 ? 2 : 1);
  const void* q;
  const void* itf;
  const float* q_scale;
  const float* item_scale;
  int K;
  __device__ __forceinline__ void prepare(int b, float* smem) const {
    float* qf = smem + XCH_FLOATS;
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const size_t o = static_cast<size_t>(b) * K + j;
      if constexpr (DT == 2) {
        reinterpret_cast<int*>(qf)[j] = static_cast<const int8_t*>(q)[o];
      } else if constexpr (DT == 1) {
        qf[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(q)[o]);
      } else {
        qf[j] = static_cast<const float*>(q)[o];
      }
    }
  }
  // element m of the rows, widened (int8 as int)
  __device__ __forceinline__ auto at(const char* rows, size_t m) const {
    if constexpr (DT == 0) {
      const float* p = reinterpret_cast<const float*>(rows) + m;
      if constexpr (STAGED) return *p; else return __ldg(p);
    } else if constexpr (DT == 1) {  // a bf16 is an f32's high half
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(rows) + m;
      const unsigned short h = STAGED ? *p : __ldg(p);
      return __uint_as_float(static_cast<uint32_t>(h) << 16);
    } else {
      const signed char* p = reinterpret_cast<const signed char*>(rows) + m;
      return static_cast<int>(STAGED ? *p : __ldg(p));
    }
  }
  __device__ __forceinline__ float4 load4(int b, int col, float* smem) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int first = col - 4 * lane;  // the warp's first column
    const char* rows = static_cast<const char*>(itf) +
                       static_cast<size_t>(first) * K * ESZ;
    if constexpr (STAGED) {
      char* stage =
          reinterpret_cast<char*>(smem + XCH_FLOATS + ((K + 3) & ~3)) +
          static_cast<size_t>(warp) * 128 * K * ESZ;
      const uint4* src = reinterpret_cast<const uint4*>(rows);
      uint4* dst = reinterpret_cast<uint4*>(stage);
#pragma unroll 4
      for (int i = lane; i < 8 * K * ESZ; i += 32) dst[i] = __ldg(src + i);
      __syncwarp();
      rows = stage;
    }
    // -0.0 adds exactly to every value (+0.0 too): the chain's first sum
    // is its first product, as in the plain version
    using Acc = decltype(at(rows, 0));
    Acc acc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = DT == 2 ? Acc(0) : Acc(-0.0f);
    const float* qf = smem + XCH_FLOATS;
#pragma unroll 2
    for (int j = 0; j < K; ++j) {
      if constexpr (DT == 2) {
        const int qj = reinterpret_cast<const int*>(qf)[j];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] += qj * at(rows, static_cast<size_t>(lane + 32 * e) * K + j);
      } else {
        const float qj = qf[j];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = __fadd_rn(
              acc[e],
              __fmul_rn(qj, at(rows, static_cast<size_t>(lane + 32 * e) * K + j)));
      }
    }
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DT == 2) {
        s[e] = __int2float_rn(acc[e]);
      } else {
        s[e] = acc[e];
      }
    }
    if (q_scale != nullptr) {
      const float qs = q_scale[b];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = __fmul_rn(__fmul_rn(s[e], qs), item_scale[first + lane + 32 * e]);
    }
    float* xch = smem + warp * 128;
#pragma unroll
    for (int e = 0; e < 4; ++e) xch[lane + 32 * e] = s[e];
    __syncwarp();
    const float4 mine = reinterpret_cast<const float4*>(xch)[lane];
    __syncwarp();  // the next call writes xch (and the staged rows) again
    return mine;
  }
};

// Segment pass: block (segment, row) takes the row's scores of SEGMENT
// columns from its Source and their exclusion bits, and writes the keys
// of the segment's top min(k, columns) columns in any order to its k
// slots of `out`, key 0 (below every column's key) in the rest. The
// select runs on the keys' 32 score bits; the score it stops at is taken
// by the lowest columns first, ranked by one scan in column order: thread
// t holds columns 4 (t + SEL_THREADS v) + e of the segment.
template <class Source>
__global__ void __launch_bounds__(SEL_THREADS) segment_select_kernel(
    Source src, const int32_t* __restrict__ mask_bits,
    const int32_t* __restrict__ excl, int n_excl, int I_p, int n_items,
    int k, uint64_t* __restrict__ out) {
  extern __shared__ float src_smem[];  // the Source's own (see ScoredSlab)
  __shared__ unsigned words[SEGMENT / 32];  // the segment's exclusion bits
  __shared__ SelectShared sh;
  const int seg = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = seg * SEGMENT;
  const int len = min(SEGMENT, I_p - c0);  // a multiple of 32, as I_p
  src.prepare(b, src_smem);
  for (int w = threadIdx.x; w < SEGMENT / 32; w += SEL_THREADS)
    words[w] = mask_bits != nullptr && w < len / 32
                   ? static_cast<unsigned>(
                         mask_bits[static_cast<size_t>(b) * (I_p / 32) +
                                   c0 / 32 + w])
                   : 0u;
  __syncthreads();
  if (mask_bits == nullptr) {  // the row list, set as bits (-1 is inert)
    for (int e = threadIdx.x; e < n_excl; e += SEL_THREADS) {
      const int c = excl[static_cast<size_t>(b) * n_excl + e] - c0;
      if (c >= 0 && c < len) atomicOr(&words[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
  }
  uint32_t u[SEG_KEYS];  // each column's score bits: its key's high word
#pragma unroll
  for (int v = 0; v < SEG_VECS; ++v) {
    const int j = 4 * (threadIdx.x + SEL_THREADS * v);
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < len) s = src.load4(b, c0 + j, src_smem);
    const unsigned w = words[j >> 5];
    const float f[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      u[4 * v + e] = static_cast<uint32_t>(
          masked_key(f[e], (w >> ((j + e) & 31)) & 1u, c0 + j + e, n_items) >>
          32);
  }
  auto valid = [&](int v) {
    return 4 * (static_cast<int>(threadIdx.x) + SEL_THREADS * v) < len;
  };
  auto for_each = [&](auto f) {
#pragma unroll
    for (int i = 0; i < SEG_KEYS; ++i) f(u[i], valid(i / 4));
  };
  const unsigned kk = min(k, len);
  const Threshold<uint32_t> th = radix_threshold<uint32_t>(for_each, kk, sh);
  // ranks of the keys equal to the threshold, in column order: a scan of
  // each thread's counts per float4 slice, 16 bits a slice
  uint64_t before = 0, total = 0;
  if (th.exact) {
    uint64_t mine = 0;
#pragma unroll
    for (int i = 0; i < SEG_KEYS; ++i)
      if (valid(i / 4) && u[i] == th.t) mine += 1ull << (16 * (i / 4));
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint64_t incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) sh.scan[warp] = incl;
    __syncthreads();
    before = incl - mine;
    for (int w = 0; w < SEL_THREADS / 32; ++w) {
      if (w < warp) before += sh.scan[w];
      total += sh.scan[w];
    }
  }
  if (threadIdx.x == 0) sh.fill = 0u;
  __syncthreads();
  uint64_t* dst = out + (static_cast<size_t>(b) * gridDim.x + seg) * k;
  unsigned rank = 0;  // ties of earlier slices, then earlier threads, keys
#pragma unroll
  for (int v = 0; v < SEG_VECS; ++v) {
    rank = 0;
    for (int w = 0; w < v; ++w)
      rank += static_cast<unsigned>(total >> (16 * w)) & 0xffffu;
    rank += static_cast<unsigned>(before >> (16 * v)) & 0xffffu;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t x = u[4 * v + e];
      bool take = false;
      if (valid(v)) {
        if (!th.exact) {
          take = x >= th.t;
        } else if (x == th.t) {
          take = rank < th.ties;
          ++rank;
        } else {
          take = x > th.t;
        }
      }
      if (take) {
        const uint32_t col = c0 + 4 * (threadIdx.x + SEL_THREADS * v) + e;
        dst[atomicAdd(&sh.fill, 1u)] =
            static_cast<uint64_t>(x) << 32 | (0xffffffffu - col);
      }
    }
  }
  for (int p = kk + threadIdx.x; p < k; p += SEL_THREADS) dst[p] = 0ull;
}

// Row pass: block b selects the top k of its row's n_cand segment keys
// the same way (from shared memory when they fit), sorts them (bitonic)
// and emits (values, indices).
__global__ void __launch_bounds__(SEL_THREADS) row_select_kernel(
    const uint64_t* __restrict__ cand, int n_cand, int k, bool staged,
    float* __restrict__ vals, int32_t* __restrict__ idx) {
  extern __shared__ uint64_t staged_keys[];  // n_cand when `staged`
  __shared__ uint64_t top[SELECT_MAX_K];
  __shared__ SelectShared sh;
  const int b = blockIdx.x;
  const uint64_t* src = cand + static_cast<size_t>(b) * n_cand;
  if (staged) {
#pragma unroll 8
    for (int i = threadIdx.x; i < n_cand; i += SEL_THREADS)
      staged_keys[i] = src[i];
    __syncthreads();
    src = staged_keys;
  }
  const int per = (n_cand + SEL_THREADS - 1) / SEL_THREADS;
  auto for_each = [&](auto f) {
    for (int n = 0, i = threadIdx.x; n < per; ++n, i += SEL_THREADS) {
      const uint64_t key = i < n_cand ? src[i] : 0ull;
      f(key, key != 0ull);
    }
  };
  // the candidates are unique keys: the threshold never ties
  const uint64_t t = radix_threshold<uint64_t>(for_each, k, sh).t;
  int n = 1;
  while (n < k) n <<= 1;
  if (threadIdx.x == 0) sh.fill = 0u;
  for (int p = k + threadIdx.x; p < n; p += SEL_THREADS) top[p] = 0ull;
  __syncthreads();
  for_each([&](uint64_t key, bool valid) {
    if (valid && key >= t) top[atomicAdd(&sh.fill, 1u)] = key;
  });
  __syncthreads();
  sort_desc(top, n);
  for (int p = threadIdx.x; p < k; p += SEL_THREADS) {
    vals[static_cast<size_t>(b) * k + p] = key_value(top[p]);
    idx[static_cast<size_t>(b) * k + p] = key_column(top[p]);
  }
}

// The row pass over the segment pass's candidates (n_seg x k keys a row
// in cand), on `st`; returns the CUDA error code, 0 on success.
int row_pass(const uint64_t* cand, int n_seg, int B, int k, float* vals,
             int32_t* idx, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();  // the segment pass's launch
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_cand = n_seg * k;
  const bool staged = static_cast<size_t>(n_cand) * 8 <= ROW_SMEM_MAX;
  const size_t smem = staged ? static_cast<size_t>(n_cand) * 8 : 0;
  if (staged) {  // with the static shared memory, past the 48 KB default
    err = cudaFuncSetAttribute(row_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_select_kernel<<<B, SEL_THREADS, smem, st>>>(cand, n_cand, k, staged,
                                                  vals, idx);
  return static_cast<int>(cudaGetLastError());
}

// The scored segment pass at one dtype, STAGED when the slab is 16-byte
// aligned and a block's rows fit STAGE_MAX_BYTES; returns the CUDA error
// code of the set-up, 0 on success.
template <int DT>
int scored_segments(dim3 grid, cudaStream_t st, const void* q,
                    const void* itf, const float* qs, const float* isc, int K,
                    const int32_t* bits, const int32_t* ex, int n_excl,
                    int I_p, int n_items, int k, uint64_t* cand) {
  constexpr int ESZ = ScoredSlab<DT, true>::ESZ;
  const size_t base = (XCH_FLOATS + ((K + 3) & ~3)) * sizeof(float);
  const size_t rows = static_cast<size_t>(SEL_THREADS / 32) * 128 * K * ESZ;
  if (reinterpret_cast<uintptr_t>(itf) % 16 == 0 && rows <= STAGE_MAX_BYTES) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_select_kernel<ScoredSlab<DT, true>>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(base + rows));
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_select_kernel<<<grid, SEL_THREADS, base + rows, st>>>(
        ScoredSlab<DT, true>{q, itf, qs, isc, K}, bits, ex, n_excl, I_p,
        n_items, k, cand);
  } else {
    segment_select_kernel<<<grid, SEL_THREADS, base, st>>>(
        ScoredSlab<DT, false>{q, itf, qs, isc, K}, bits, ex, n_excl, I_p,
        n_items, k, cand);
  }
  return 0;
}

}  // namespace

// Launches pass 1, the merge tree and the emit on `stream`; allocates
// nothing. scratch_a/scratch_b each hold B x max over levels of
// (lists x stride) keys (ops/recommend.py:merge_levels). Pointers for
// absent inputs are null. Returns the CUDA error code, 0 on success.
extern "C" int recommend_topk(
    int dtype, const void* q, const void* itf, const void* q_scale,
    const void* item_scale, const void* mask_bits, const void* excl,
    int n_excl, int B, int K, int I_p, int n_items, int k, int chunk,
    void* scratch_a, void* scratch_b, void* vals, void* idx, int device,
    void* stream) {
  if (chunk != CHUNK || dtype < 0 || dtype > 2 || B <= 0 || B > 65535 ||
      K <= 0 || I_p <= 0 || I_p % 32 != 0 || k <= 0 || k > I_p ||
      n_excl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n0 = (I_p + CHUNK - 1) / CHUNK;
  const int kc = k < CHUNK ? k : CHUNK;
  const size_t smem = CHUNK * sizeof(uint64_t) + (K + n_excl) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n0, B);
  auto* a = static_cast<uint64_t*>(scratch_a);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* isc = static_cast<const float*>(item_scale);
  const auto* bits = static_cast<const int32_t*>(mask_bits);
  const auto* ex = static_cast<const int32_t*>(excl);
  switch (dtype) {
    case 0:
      score_chunk_kernel<0><<<grid, THREADS, smem, st>>>(
          q, itf, qs, isc, bits, ex, n_excl, K, I_p, n_items, kc, a);
      break;
    case 1:
      score_chunk_kernel<1><<<grid, THREADS, smem, st>>>(
          q, itf, qs, isc, bits, ex, n_excl, K, I_p, n_items, kc, a);
      break;
    default:
      score_chunk_kernel<2><<<grid, THREADS, smem, st>>>(
          q, itf, qs, isc, bits, ex, n_excl, K, I_p, n_items, kc, a);
      break;
  }
  return merge_and_emit(a, static_cast<uint64_t*>(scratch_b), n0, kc, B, k,
                        st, static_cast<float*>(vals),
                        static_cast<int32_t*>(idx));
}

// The same selection over a precomputed (B, I_p) f32 score matrix
// (fused_masked_topk): pass 1 reads each score instead of computing it;
// the merge tree, the emit and the scratch sizes are recommend_topk's.
extern "C" int masked_topk(
    const void* scores, const void* mask_bits, const void* excl, int n_excl,
    int B, int I_p, int n_items, int k, int chunk, void* scratch_a,
    void* scratch_b, void* vals, void* idx, int device, void* stream) {
  if (chunk != CHUNK || B <= 0 || B > 65535 || I_p <= 0 || I_p % 32 != 0 ||
      k <= 0 || k > I_p || n_excl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n0 = (I_p + CHUNK - 1) / CHUNK;
  const int kc = k < CHUNK ? k : CHUNK;
  const size_t smem = CHUNK * sizeof(uint64_t) + n_excl * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<uint64_t*>(scratch_a);
  masked_chunk_kernel<<<dim3(n0, B), THREADS, smem, st>>>(
      static_cast<const float*>(scores),
      static_cast<const int32_t*>(mask_bits),
      static_cast<const int32_t*>(excl), n_excl, I_p, n_items, kc, a);
  return merge_and_emit(a, static_cast<uint64_t*>(scratch_b), n0, kc, B, k,
                        st, static_cast<float*>(vals),
                        static_cast<int32_t*>(idx));
}

// The same selection over a precomputed (B, I_p) f32 score matrix in two
// launches, for k <= SELECT_MAX_K: the segment pass, then the row pass.
// `scores` must be 16-byte aligned. scratch holds B x ceil(I_p /
// SEGMENT) x k keys (ops/recommend.py:select_scratch_keys). Launches on
// `stream`, allocates nothing. Returns the CUDA error code, 0 on success.
extern "C" int masked_select(
    const void* scores, const void* mask_bits, const void* excl, int n_excl,
    int B, int I_p, int n_items, int k, void* scratch, void* vals,
    void* idx, int device, void* stream) {
  if (B <= 0 || B > 65535 || I_p <= 0 ||
      I_p % 32 != 0 || k <= 0 || k > I_p || k > SELECT_MAX_K ||
      n_excl < 0 || reinterpret_cast<uintptr_t>(scores) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_seg = (I_p + SEGMENT - 1) / SEGMENT;
  auto* cand = static_cast<uint64_t*>(scratch);
  segment_select_kernel<<<dim3(n_seg, B), SEL_THREADS, 0, st>>>(
      ScoreMatrix{static_cast<const float*>(scores), I_p},
      static_cast<const int32_t*>(mask_bits),
      static_cast<const int32_t*>(excl), n_excl, I_p, n_items, k, cand);
  return row_pass(cand, n_seg, B, k, static_cast<float*>(vals),
                  static_cast<int32_t*>(idx), st);
}

// recommend_topk's selection in two launches, for k <= SELECT_MAX_K: the
// segment pass scoring each column (ScoredSlab), then the row pass. I_p
// must be a multiple of 128 (ops/recommend.py:ITEM_PAD). scratch holds B x ceil(I_p / SEGMENT) x k keys
// (ops/recommend.py:select_scratch_keys). Launches on `stream`, allocates
// nothing. Returns the CUDA error code, 0 on success.
extern "C" int recommend_select(
    int dtype, const void* q, const void* itf, const void* q_scale,
    const void* item_scale, const void* mask_bits, const void* excl,
    int n_excl, int B, int K, int I_p, int n_items, int k, void* scratch,
    void* vals, void* idx, int device, void* stream) {
  // the exchange and the query factors: the unstaged dynamic shared memory
  const size_t smem = (XCH_FLOATS + ((K + 3) & ~3)) * sizeof(float);
  if (dtype < 0 || dtype > 2 || B <= 0 || B > 65535 || K <= 0 ||
      smem > 48 * 1024 || I_p <= 0 || I_p % 128 != 0 || k <= 0 || k > I_p ||
      k > SELECT_MAX_K || n_excl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_seg = (I_p + SEGMENT - 1) / SEGMENT;
  const dim3 grid(n_seg, B);
  auto* cand = static_cast<uint64_t*>(scratch);
  const auto* qs = static_cast<const float*>(q_scale);
  const auto* isc = static_cast<const float*>(item_scale);
  const auto* bits = static_cast<const int32_t*>(mask_bits);
  const auto* ex = static_cast<const int32_t*>(excl);
  int code;
  switch (dtype) {
    case 0:
      code = scored_segments<0>(grid, st, q, itf, qs, isc, K, bits, ex, n_excl,
                                I_p, n_items, k, cand);
      break;
    case 1:
      code = scored_segments<1>(grid, st, q, itf, qs, isc, K, bits, ex, n_excl,
                                I_p, n_items, k, cand);
      break;
    default:
      code = scored_segments<2>(grid, st, q, itf, qs, isc, K, bits, ex, n_excl,
                                I_p, n_items, k, cand);
      break;
  }
  if (code != 0) return code;
  return row_pass(cand, n_seg, B, k, static_cast<float*>(vals),
                  static_cast<int32_t*>(idx), st);
}
