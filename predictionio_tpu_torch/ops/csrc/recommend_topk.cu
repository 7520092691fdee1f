// Fused score + exclusion + top-k over a padded item-factor slab, for
// Hopper (sm_90a). Never writes the (B, I_p) score matrix to memory.
//
// Replaces the TPU kernel predictionio_tpu/ops/recommend_pallas.py:
// fused_recommend_topk (assembly _fused_call, body _make_kernel). The TPU
// kernel walks item tiles in order and merges each into one running list
// in VMEM; blocks here run in parallel with no carry, so the work splits
// into passes, all launched on the caller's stream:
//
//   pass 1  one block per (chunk of CHUNK item columns, query row): score
//           every column of the chunk in registers, apply the masks, sort
//           the chunk's (score, column) keys in shared memory (bitonic),
//           write the top min(k, CHUNK) keys.
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
// chunk get keys below every real column and never reach the output.
//
// Scores: one chain over K in index order per (query, column), each
// multiply and add rounded on its own (__fmul_rn/__fadd_rn are never
// contracted into an FMA), int8 summed in int32 and converted once, bf16
// widened to f32. The plain PyTorch version (ops/recommend.py:
// plain_scores) does the same operations, so the two agree bit for bit,
// and no score depends on the batch it rides in. Optional scales then
// multiply as (s * q_scale[b]) * item_scale[col].
//
// Bound at the main-path shape (ML-20M: I_p = 26,752, K = 10, k = 128,
// f32): B = 64 moves ~1.14 MB (1.07 MB of item factors, outputs 65 KB),
// 0.34 us at 3.35 TB/s, and does 34 MFLOP, 0.51 us at 67 TFLOP/s of f32
// CUDA-core peak: operations-bound at ~0.5 us. B = 1 is bytes-bound at
// ~0.32 us. The kernel is far from either: it is launch- and
// selection-bound (a full bitonic sort of every chunk per row, and
// log2(chunks) merge launches). No wgmma or TMA: at K = 10 tensor cores
// do not pay. Making it fast is later work.

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
    bool masked = false;
    if (mask_bits != nullptr) {
      const uint32_t w = static_cast<uint32_t>(
          mask_bits[static_cast<size_t>(b) * (I_p / 32) + (col >> 5)]);
      masked = (w >> (col & 31)) & 1u;
    } else {
      for (int e = 0; e < n_excl; ++e) masked |= (ex[e] == col);
    }
    if (masked) s = NEG_INF_F;
    if (col >= n_items) s = SENTINEL_F;
    keys[t] = make_key(s, static_cast<uint32_t>(col));
  }
  __syncthreads();

  // bitonic sort, descending
  for (int size = 2; size <= CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < CHUNK / 2; t += blockDim.x) {
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

  uint64_t* dst = out + (static_cast<size_t>(b) * gridDim.x + chunk) * kc;
  for (int t = threadIdx.x; t < kc; t += blockDim.x) dst[t] = keys[t];
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
  auto* bb = static_cast<uint64_t*>(scratch_b);
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
  err = cudaGetLastError();
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
  emit_kernel<<<B, THREADS, 0, st>>>(a, stride, k,
                                     static_cast<float*>(vals),
                                     static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
