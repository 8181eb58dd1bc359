// Hopper (sm_90a) kernel of the batched top-k: values and positions.
//
// batched_topk_kernel<T, M, kIdx>  replaces mpi_k_selection_tpu/ops/pallas/topk.py:183
//                     pallas_batched_topk_values (_chain_kernel and
//                     _fold_kernel), for T = float32 and T = bfloat16, and
//                     with kIdx the index recovery that the JAX package
//                     runs after it (mpi_k_selection_tpu/ops/topk.py:
//                     _block_topk_indices, torch passes in the port before).
//   For each row of a contiguous (rows, d) array, out[row, 0..k) holds the
//   row's k largest elements, in descending order of the sortable key
//   (utils/dtypes.py: neg ? ~raw : raw | MSB; bfloat16 keys are 16 bits),
//   equal keys by ascending position, and idx[row, 0..k) (int64, kIdx
//   only) their column positions. That is a total order: -0.0 < +0.0, -NaN
//   below -inf, +NaN above +inf, ties by position: the order of lax.top_k
//   and of the port's other top-k methods. The outputs are the input's own
//   bits (key -> raw inverts the transform), so a bfloat16 row never
//   passes through float32.
//   Bound: bytes. One read of rows * d elements (512 MiB for 4096 x 32768
//   float32: 0.160 ms at 3.35 TB/s; 0.080 ms for bfloat16) and rows * k
//   values (and int64 positions) written. The work is a few integer
//   operations per element (the key transform and one compare), below what
//   the card can issue in that time once inserts are rare (below).
//   Design: one warp per row, 16-byte loads (kUnroll in flight per thread),
//   neighbouring lanes on neighbouring addresses: load t of lane l holds
//   the elements (32 t + l) * P .. + P-1, so a lane reads its elements in
//   ascending position and every element of load t precedes every element
//   of load t+1. Each lane keeps its own M largest (key, position) pairs
//   sorted in registers (M = 8 for k <= 8, 16 for k <= 16, a template
//   parameter, so every index into the list is static), filled from its
//   first M elements (no sentinel key exists: key 0 is a NaN pattern) by a
//   bubble sort that swaps only on a strictly greater key. Since a later
//   element never outranks an earlier one of equal key, a strict 32-bit
//   compare on the key alone decides an insert, and the insert puts the
//   new pair below every key it does not strictly beat: the list stays in
//   (key desc, position asc) order and positions move only there.
//   The filter. An element is inserted only when its key beats thr, the
//   larger of the lane's M-th key and T, the k-th largest of the 32
//   lanes' head keys (a few rounds of __reduce_max_sync), refreshed after
//   the fill and each time the loads read so far double. At least k
//   elements of key >= T precede every later element, so a later element
//   of key <= T is outranked k times and can never be in the row's top k:
//   the filter is exact, and it turns the per-lane insert rate (about M /
//   i at the lane's i-th element, which made nearly every warp step run
//   some lane's insert) into about k / (32 i). A load's keys are tested
//   together (their maximum against thr; for bfloat16 two keys per word,
//   one prmt for both sign masks and max.u16x2 over the words), and only a
//   load that holds a winner runs the per-element inserts.
//   The merge: k rounds over the 32 sorted lists. The round's key is
//   __reduce_max_sync of the heads; among the lanes whose head equals it,
//   __reduce_min_sync of the head positions picks the earliest (lane order
//   is not position order: lane 1's first element lies after lane 0's
//   first load), and that lane pops its head. k <= M rounds pop no lane
//   more than M times, so every head read is a real pair.
//   Exact by construction: a lane's list holds its M best offered pairs,
//   every pair of the row's top k is offered (the filter above) and has
//   at most k-1 <= M-1 pairs of its lane ahead of it. The TPU kernel's
//   depth-3/4 insert chains per lane, its 128-lane bitonic fold, the
//   suspect flag and the lax.top_k rescue (with its full fallback), and the
//   index recovery's counts, block ranks and pairwise tie order, exist
//   there for the VPU's layout and have no counterpart here.
//   Without kIdx (values only) the same kernel keeps no positions.
//
// Launches go on the caller's stream and allocate nothing; each entry point
// returns cudaGetLastError() so that the Python wrapper raises on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// float32: four 32-bit elements per 16-byte load, one key a word
struct F32 {
  using Raw = uint32_t;
  static constexpr int kPerLoad = 4;
  static __device__ __forceinline__ uint32_t key(uint32_t raw) {
    return raw ^ ((uint32_t)((int32_t)raw >> 31) | 0x80000000u);
  }
  static __device__ __forceinline__ Raw raw(uint32_t key) {
    return key ^ ((key & 0x80000000u) ? 0x80000000u : 0xffffffffu);
  }
  static __device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
    w[0] = key(v.x); w[1] = key(v.y); w[2] = key(v.z); w[3] = key(v.w);
  }
  static __device__ __forceinline__ uint32_t key_at(const uint32_t (&w)[4], int j) { return w[j]; }
  static __device__ __forceinline__ uint32_t spread(uint32_t thr) { return thr; }
  // whether any key of the load beats thr
  static __device__ __forceinline__ bool above(const uint32_t (&w)[4], uint32_t thr, uint32_t) {
    return max(max(w[0], w[1]), max(w[2], w[3])) > thr;
  }
};

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bfloat16: eight 16-bit elements per load, two keys a word (the lower
// address in the low half)
struct BF16 {
  using Raw = uint16_t;
  static constexpr int kPerLoad = 8;
  static __device__ __forceinline__ Raw raw(uint32_t key) {
    return (Raw)(key ^ ((key & 0x8000u) ? 0x8000u : 0xffffu));
  }
  // both halves' keys at once: prmt replicates each half's sign bit over
  // the half (selector nibbles 9 and b: the sign of bytes 1 and 3), so
  // the mask is 0xffff for a negative half and 0x8000 for the other
  static __device__ __forceinline__ uint32_t key2(uint32_t w) {
    uint32_t s;
    asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(s) : "r"(w), "r"(0u));
    return w ^ (s | 0x80008000u);
  }
  static __device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
    w[0] = key2(v.x); w[1] = key2(v.y); w[2] = key2(v.z); w[3] = key2(v.w);
  }
  static __device__ __forceinline__ uint32_t key_at(const uint32_t (&w)[4], int j) {
    return (j & 1) ? w[j >> 1] >> 16 : w[j >> 1] & 0xffffu;
  }
  static __device__ __forceinline__ uint32_t spread(uint32_t thr) { return thr * 0x10001u; }
  // thr2 = thr in both halves: some half of the words' maximum beats thr
  // exactly when the maximum of it and thr2 differs from thr2
  static __device__ __forceinline__ bool above(const uint32_t (&w)[4], uint32_t, uint32_t thr2) {
    const uint32_t m = max_u16x2(max_u16x2(w[0], w[1]), max_u16x2(w[2], w[3]));
    return max_u16x2(m, thr2) != thr2;
  }
};

// One descending compare-exchange of (key, position) pairs: swaps only
// when the lower key is strictly greater, so equal keys keep their order.
template <bool kIdx>
__device__ __forceinline__ void cx(uint32_t& hi, uint32_t& lo, uint32_t& phi, uint32_t& plo) {
  if constexpr (kIdx) {
    const bool c = lo > hi;
    const uint32_t a = hi, b = lo, pa = phi, pb = plo;
    hi = c ? b : a;
    lo = c ? a : b;
    phi = c ? pb : pa;
    plo = c ? pa : pb;
  } else {
    const uint32_t a = hi, b = lo;
    hi = max(a, b);
    lo = min(a, b);
  }
}

// Inserts (key, p), whose key beats the M-th key, below the keys it does
// not beat (equal ones included: they come first). Every slot decides from
// its own compare and its upper neighbour's, so the M slots update in
// parallel instead of along a chain of M-1 dependent compare-exchanges.
template <int M, bool kIdx>
__device__ __forceinline__ void insert(uint32_t (&top)[M], uint32_t (&pos)[M], uint32_t key, uint32_t p) {
  bool beats[M];
#pragma unroll
  for (int i = 0; i < M; ++i) beats[i] = key > top[i];
#pragma unroll
  for (int i = M - 1; i > 0; --i) {  // top[i - 1] is read before it changes
    if constexpr (kIdx) pos[i] = beats[i] ? (beats[i - 1] ? pos[i - 1] : p) : pos[i];
    top[i] = beats[i] ? min(top[i - 1], key) : top[i];
  }
  if constexpr (kIdx) pos[0] = beats[0] ? p : pos[0];
  top[0] = beats[0] ? key : top[0];
}

// Offers the P elements of vector vi, whose keys are w, to the list.
template <typename T, int M, bool kIdx>
__device__ __forceinline__ void offer(const uint32_t (&w)[4], int vi, uint32_t (&top)[M], uint32_t (&pos)[M],
                                      uint32_t& thr, uint32_t& thr2) {
  if (!T::above(w, thr, thr2)) return;
#pragma unroll
  for (int j = 0; j < T::kPerLoad; ++j) {
    const uint32_t key = T::key_at(w, j);
    if (key > thr) {
      insert<M, kIdx>(top, pos, key, (uint32_t)vi * T::kPerLoad + j);
      thr = max(thr, top[M - 1]);
    }
  }
  thr2 = T::spread(thr);
}

// T: the k-th largest of the warp's head keys (repeats counted). At least
// k listed elements have a key >= T.
__device__ __forceinline__ uint32_t kth_head(uint32_t head, int k) {
  bool active = true;
  int seen = 0;
  uint32_t best = 0;
  while (seen < k) {  // warp-uniform: seen is a ballot's count
    best = __reduce_max_sync(kFull, active ? head : 0u);
    const bool hit = active && head == best;
    seen += __popc(__ballot_sync(kFull, hit));
    active = active && !hit;
  }
  return best;
}

template <typename T, int M, bool kIdx>
__global__ void __launch_bounds__(kThreads)
batched_topk_kernel(const uint4* __restrict__ x, long long rows, int nvec, int k,
                    typename T::Raw* __restrict__ out, long long* __restrict__ idx) {
  constexpr int P = T::kPerLoad;
  constexpr int kFill = M / P;  // loads that fill the list
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const uint4* src = x + row * nvec;

  uint32_t top[M], pos[M];
#pragma unroll
  for (int u = 0; u < kFill; ++u) {
    uint32_t w[4];
    T::words(__ldg(src + lane + u * 32), w);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      top[u * P + j] = T::key_at(w, j);
      pos[u * P + j] = (uint32_t)(lane + u * 32) * P + j;
    }
  }
#pragma unroll
  for (int i = 0; i < M - 1; ++i) {  // bubble sort, descending, stable
#pragma unroll
    for (int j = 0; j < M - 1 - i; ++j) cx<kIdx>(top[j], top[j + 1], pos[j], pos[j + 1]);
  }

  uint32_t thr = top[M - 1];
  uint32_t thr2 = T::spread(thr);

  int i = lane + kFill * 32;
  int refresh = kFill * 32;  // lane-relative vector offset of the next T
  for (; i + (kUnroll - 1) * 32 < nvec; i += kUnroll * 32) {
    if (i - lane >= refresh) {  // warp-uniform
      thr = max(thr, kth_head(top[0], k));
      thr2 = T::spread(thr);
      refresh *= 2;
    }
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + i + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t w[4];
      T::words(v[u], w);
      offer<T, M, kIdx>(w, i + u * 32, top, pos, thr, thr2);
    }
  }
  for (; i < nvec; i += 32) {
    uint32_t w[4];
    T::words(__ldg(src + i), w);
    offer<T, M, kIdx>(w, i, top, pos, thr, thr2);
  }

  // merge the 32 sorted lists: lane r keeps round r's pair
  uint32_t mine = 0, mine_pos = 0;
  for (int r = 0; r < k; ++r) {
    const uint32_t best = __reduce_max_sync(kFull, top[0]);
    bool pop;
    if constexpr (kIdx) {
      const uint32_t p = __reduce_min_sync(kFull, top[0] == best ? pos[0] : 0xffffffffu);
      pop = pos[0] == p;  // positions are distinct across the lists
      if (lane == r) mine_pos = p;
    } else {
      pop = lane == __ffs(__ballot_sync(kFull, top[0] == best)) - 1;
    }
    if (pop) {
#pragma unroll
      for (int j = 0; j < M - 1; ++j) {
        top[j] = top[j + 1];
        pos[j] = pos[j + 1];
      }
    }
    if (lane == r) mine = best;
  }
  if (lane < k) {
    out[row * k + lane] = T::raw(mine);
    if constexpr (kIdx) idx[row * k + lane] = (long long)mine_pos;
  }
}

template <typename T, int M>
void launch_m(long long grid, const uint4* src, long long rows, int nvec, int k,
              typename T::Raw* dst, long long* idx, cudaStream_t stream) {
  if (idx)
    batched_topk_kernel<T, M, true><<<(unsigned)grid, kThreads, 0, stream>>>(src, rows, nvec, k, dst, idx);
  else
    batched_topk_kernel<T, M, false><<<(unsigned)grid, kThreads, 0, stream>>>(src, rows, nvec, k, dst, idx);
}

template <typename T>
int launch_batched_topk(const void* x, long long rows, int d, int k, void* out, void* idx,
                        void* stream) {
  constexpr int P = T::kPerLoad;
  // (d / P) % 32 == 0: only then does every lane of a warp run the main
  // loop as often (its index starts at the lane), so that the full-mask
  // collectives in it (kth_head) see all 32 lanes
  if (k < 1 || k > 16 || d % P != 0 || (d / P) % 32 != 0 || d / P < 32 * (16 / P) ||
      (reinterpret_cast<uintptr_t>(x) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const uint4* src = static_cast<const uint4*>(x);
  auto* dst = static_cast<typename T::Raw*>(out);
  auto* pos = static_cast<long long*>(idx);
  if (k <= 8)
    launch_m<T, 8>(grid, src, rows, d / P, k, dst, pos, (cudaStream_t)stream);
  else
    launch_m<T, 16>(grid, src, rows, d / P, k, dst, pos, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx: rows * k int64 positions, or null for the values alone
int ksel_batched_topk32(const void* x, long long rows, int d, int k, void* out, void* idx,
                        void* stream) {
  return launch_batched_topk<F32>(x, rows, d, k, out, idx, stream);
}

int ksel_batched_topk16(const void* x, long long rows, int d, int k, void* out, void* idx,
                        void* stream) {
  return launch_batched_topk<BF16>(x, rows, d, k, out, idx, stream);
}

const char* ksel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
