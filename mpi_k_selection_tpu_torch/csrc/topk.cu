// Hopper (sm_90a) kernel of the batched top-k values.
//
// batched_topk_kernel<T, M>  replaces mpi_k_selection_tpu/ops/pallas/topk.py:183
//                     pallas_batched_topk_values (_chain_kernel and
//                     _fold_kernel), for T = float32 and T = bfloat16.
//   For each row of a contiguous (rows, d) array, out[row, 0..k) holds the
//   row's k largest elements, in descending order of the sortable key
//   (utils/dtypes.py: neg ? ~raw : raw | MSB; bfloat16 keys are 16 bits,
//   widened to 32). That is a total order: -0.0 < +0.0, -NaN below -inf,
//   +NaN above +inf, the order of lax.top_k and of the port's other top-k
//   methods. The outputs are the input's own bits (key -> raw inverts the
//   transform), so a bfloat16 row never passes through float32.
//   Bound: bytes. One read of rows * d elements (512 MiB for 4096 x 32768
//   float32: 0.160 ms at 3.35 TB/s; 0.080 ms for bfloat16) and rows * k
//   written. The work is a few integer operations per element (the key
//   transform and one compare), far below what the card can execute.
//   Design: one warp per row, 16-byte loads (kUnroll in flight per thread),
//   neighbouring lanes on neighbouring addresses. Each lane keeps its own M
//   largest keys sorted in registers (M = 8 for k <= 8, 16 for k <= 16, a
//   template parameter, so every index into the list is static). The list
//   is filled from the lane's first M elements, so no sentinel key exists
//   that could collide with a real one (key 0 is a NaN pattern). After
//   that an element costs one compare with the lane's M-th key and is
//   inserted, by one pass of compare-exchanges, only when it beats it. The
//   row's top-k is then the top-k of the 32 sorted lists: k rounds of a
//   warp max over the lanes' heads (__reduce_max_sync); one lane holding
//   the maximum pops its head. The envelope (d >= 4096, d % 1024 == 0)
//   gives every lane at least M elements.
//   Exact by construction: a lane's list holds its M largest keys, and the
//   row's top k <= M are among the union of those lists. The TPU kernel's
//   depth-3/4 insert chains per lane, its 128-lane bitonic fold, the
//   suspect flag and the lax.top_k rescue (with its full fallback) exist
//   there for the VPU's layout and have no counterpart here.
//
// Launches go on the caller's stream and allocate nothing; each entry point
// returns cudaGetLastError() so that the Python wrapper raises on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr int kUnroll = 4;

// float32: four 32-bit elements per 16-byte load
struct F32 {
  using Raw = uint32_t;
  static constexpr int kPerLoad = 4;
  static __device__ __forceinline__ uint32_t key(uint32_t raw) {
    return raw ^ ((uint32_t)((int32_t)raw >> 31) | 0x80000000u);
  }
  static __device__ __forceinline__ Raw raw(uint32_t key) {
    return key ^ ((key & 0x80000000u) ? 0x80000000u : 0xffffffffu);
  }
  static __device__ __forceinline__ void keys(const uint4& v, uint32_t (&k)[kPerLoad]) {
    k[0] = key(v.x); k[1] = key(v.y); k[2] = key(v.z); k[3] = key(v.w);
  }
};

// bfloat16: eight 16-bit elements per load, the lower address in the low half
struct BF16 {
  using Raw = uint16_t;
  static constexpr int kPerLoad = 8;
  static __device__ __forceinline__ uint32_t key(uint32_t raw) {  // raw < 2^16
    return raw ^ (((0u - (raw >> 15)) & 0x7fffu) | 0x8000u);
  }
  static __device__ __forceinline__ Raw raw(uint32_t key) {
    return (Raw)(key ^ ((key & 0x8000u) ? 0x8000u : 0xffffu));
  }
  static __device__ __forceinline__ void keys(const uint4& v, uint32_t (&k)[kPerLoad]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[2 * i] = key(w[i] & 0xffffu);
      k[2 * i + 1] = key(w[i] >> 16);
    }
  }
};

// One descending compare-exchange.
__device__ __forceinline__ void cx(uint32_t& hi, uint32_t& lo) {
  const uint32_t a = hi, b = lo;
  hi = max(a, b);
  lo = min(a, b);
}

// Inserts key into the descending list when it beats the M-th key: it
// replaces the M-th and one pass of compare-exchanges moves it up.
template <int M>
__device__ __forceinline__ void insert(uint32_t (&top)[M], uint32_t key) {
  if (key > top[M - 1]) {
    top[M - 1] = key;
#pragma unroll
    for (int i = M - 1; i > 0; --i) cx(top[i - 1], top[i]);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
batched_topk_kernel(const uint4* __restrict__ x, long long rows, int nvec,
                    int k, typename T::Raw* __restrict__ out) {
  constexpr int P = T::kPerLoad;
  constexpr int kFill = M / P;  // loads that fill the list
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const uint4* src = x + row * nvec;

  uint32_t top[M];
#pragma unroll
  for (int u = 0; u < kFill; ++u) {
    uint32_t kk[P];
    T::keys(__ldg(src + lane + u * 32), kk);
#pragma unroll
    for (int j = 0; j < P; ++j) top[u * P + j] = kk[j];
  }
#pragma unroll
  for (int i = 0; i < M - 1; ++i) {  // bubble sort, descending
#pragma unroll
    for (int j = 0; j < M - 1 - i; ++j) cx(top[j], top[j + 1]);
  }

  int i = lane + kFill * 32;
  for (; i + (kUnroll - 1) * 32 < nvec; i += kUnroll * 32) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + i + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t kk[P];
      T::keys(v[u], kk);
#pragma unroll
      for (int j = 0; j < P; ++j) insert(top, kk[j]);
    }
  }
  for (; i < nvec; i += 32) {
    uint32_t kk[P];
    T::keys(__ldg(src + i), kk);
#pragma unroll
    for (int j = 0; j < P; ++j) insert(top, kk[j]);
  }

  // merge the 32 sorted lists: k <= M rounds, so no lane is popped more
  // than M times and every head read before the last round is a real key
  typename T::Raw* dst = out + row * k;
  for (int r = 0; r < k; ++r) {
    const uint32_t best = __reduce_max_sync(0xffffffffu, top[0]);
    const unsigned who = __ballot_sync(0xffffffffu, top[0] == best);
    if (lane == __ffs(who) - 1) {
#pragma unroll
      for (int j = 0; j < M - 1; ++j) top[j] = top[j + 1];
    }
    if (lane == 0) dst[r] = T::raw(best);
  }
}

template <typename T>
int launch_batched_topk(const void* x, long long rows, int d, int k, void* out,
                        void* stream) {
  constexpr int P = T::kPerLoad;
  if (k < 1 || k > 16 || d % P != 0 || d / P < 32 * (16 / P) ||
      (reinterpret_cast<uintptr_t>(x) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const uint4* src = static_cast<const uint4*>(x);
  auto* dst = static_cast<typename T::Raw*>(out);
  if (k <= 8)
    batched_topk_kernel<T, 8><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, rows, d / P, k, dst);
  else
    batched_topk_kernel<T, 16><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, rows, d / P, k, dst);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ksel_batched_topk32(const void* x, long long rows, int d, int k, void* out,
                        void* stream) {
  return launch_batched_topk<F32>(x, rows, d, k, out, stream);
}

int ksel_batched_topk16(const void* x, long long rows, int d, int k, void* out,
                        void* stream) {
  return launch_batched_topk<BF16>(x, rows, d, k, out, stream);
}

const char* ksel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
