// Hopper (sm_90a) kernel of the streamed descent's per-chunk ingest.
//
// sweep_ingest<W>  replaces mpi_k_selection_tpu/ops/pallas/sweep_ingest.py:
//                  sweep_ingest_core (W = uint32; W = uint64 replaces the
//                  XLA fusion tier ops/pallas/fused_ingest.py, which the
//                  JAX package runs for 64-bit key spaces).
//   One read of a staged bucket of L raw words, of which the first n_valid
//   are keys and the rest are pads (key 0), gives every enabled part:
//   - hist: (nq, 2^radix_bits) counts of the digit z = (key >> shift) ^
//     (prefix_q << radix_bits) for z < 2^radix_bits, i.e. of the digit at
//     shift over the keys whose bits above it equal prefix_q, over the
//     whole padded bucket (pads counted; the caller subtracts them);
//   - collect: for each of nc (shift, prefix) specs, the valid keys with
//     key >> shift == prefix (every key matches prefix 0 at shift >= the
//     word width, as JAX's logical shift gives 0 there), front-packed in
//     chunk order into an L-word buffer the caller zeroed, and their count;
//   - tee: the same over the union of nt specs, into one more buffer;
//   - cert: (#valid keys < vkey, #valid keys <= vkey), unsigned compares;
//   - sketch: counts of the top sketch_bits key bits over the padded
//     bucket, and the min and max of the valid keys.
//   key = raw ^ key_xor, or the float transform when is_float (neg ? ~raw :
//   raw | MSB): host chunks cross to the card as their own bytes.
//   Bound: bytes. One read of L words (4L or 8L bytes) at 3.35 TB/s, plus
//   the survivors written once. Per key the work is nq + nc + nt compares
//   and a few integer operations, below the bytes for the descent's small
//   nq and specs.
//   Design. The TPU kernel walks the bucket's tiles in grid order and
//   carries each buffer's running offset in scratch memory; CUDA blocks run
//   in no order. So blocks take 256 x 64-byte tiles in order from an atomic
//   ticket, each thread holds its 64 bytes of keys in registers (one 16-byte
//   load of four, read once), and for each survivor buffer the block scans
//   its threads' counts and gets its tile's output offset from a chained
//   (decoupled look-back) prefix over the tiles: a tile publishes its
//   aggregate, then the sum of its predecessors, in a status word per
//   (buffer, tile). A tile's predecessors all hold tickets already, so the
//   look-back always ends. Histograms count in shared memory when they fit
//   (64 KB for hist, up to 96 KB with the sketch), else straight into the
//   global counters; the counts, the certificate and the extremes fold into
//   global memory once per tile or once per block.
//
// The launch goes on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadBytes = 64;  // four 16-byte loads per thread per tile
constexpr int kHistSmem = 64 * 1024;
constexpr int kSmemMax = 96 * 1024;
constexpr unsigned long long kFlagAgg = 1ull << 62;   // tile aggregate only
constexpr unsigned long long kFlagIncl = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

template <typename W> struct Signed;
template <> struct Signed<uint32_t> { using type = int32_t; };
template <> struct Signed<uint64_t> { using type = int64_t; };

template <typename W> struct Atom;
template <> struct Atom<uint32_t> { using type = unsigned int; };
template <> struct Atom<uint64_t> { using type = unsigned long long; };

template <typename W>
__device__ __forceinline__ W to_key(W raw, bool is_float, W key_xor) {
  constexpr int B = sizeof(W) * 8;
  using S = typename Signed<W>::type;
  const W m = is_float ? ((W)((S)raw >> (B - 1)) | ((W)1 << (B - 1))) : key_xor;
  return raw ^ m;
}

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& v, uint64_t* w) {
  w[0] = ((uint64_t)v.y << 32) | v.x;
  w[1] = ((uint64_t)v.w << 32) | v.z;
}

// (key >> shift) == prefix, where a shift of the word width or more leaves
// 0 (JAX's shift_right_logical), which C++ leaves undefined.
template <typename W>
__device__ __forceinline__ bool spec_match(W key, W shift, W prefix) {
  constexpr int B = sizeof(W) * 8;
  return shift >= (W)B ? prefix == (W)0 : (key >> shift) == prefix;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
sweep_ingest_kernel(const W* __restrict__ data, long long L, long long n_valid,
                    int is_float, W key_xor, const W* __restrict__ params,
                    int nq, int shift, int radix_bits, int nc, int nt,
                    int cert, W vkey, int sketch_bits, int hist_smem,
                    int deep_smem, int vec, unsigned* __restrict__ hist,
                    unsigned* __restrict__ counts, W* __restrict__ surv,
                    unsigned* __restrict__ cert_out, unsigned* __restrict__ deep,
                    W* __restrict__ ext, unsigned long long* __restrict__ scratch,
                    long long n_tiles) {
  constexpr int B = sizeof(W) * 8;
  constexpr int kItems = kThreadBytes / sizeof(W);
  constexpr long long kTile = (long long)kThreads * kItems;
  extern __shared__ unsigned smem_counts[];
  __shared__ long long s_tile;
  __shared__ long long s_offset;
  __shared__ unsigned s_warp[kWarps];

  // params: nq z references (prefix << radix_bits), nc shifts, nc
  // prefixes, nt shifts, nt prefixes
  const W* zref = params;
  const W* cshift = params + nq;
  const W* cpref = cshift + nc;
  const W* tshift = cpref + nc;
  const W* tpref = tshift + nt;
  const int nb = 1 << radix_bits;
  const int n_surv = nc + (nt ? 1 : 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool fl = is_float != 0;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + 1;

  const int hist_words = hist_smem ? nq * nb : 0;
  const int deep_words = deep_smem ? 1 << sketch_bits : 0;
  for (int i = threadIdx.x; i < hist_words + deep_words; i += kThreads) smem_counts[i] = 0u;
  __syncthreads();
  unsigned* hacc = hist_smem ? smem_counts : hist;
  unsigned* dacc = deep_smem ? smem_counts + hist_words : deep;
  const int dshift = B - sketch_bits;

  unsigned lt = 0, le = 0;
  W kmin = ~(W)0, kmax = 0;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long t = s_tile;
    __syncthreads();  // s_tile is rewritten at the next tile
    if (t >= n_tiles) break;
    const long long base = t * kTile + (long long)threadIdx.x * kItems;
    const long long left = L - base;
    const int present = left <= 0 ? 0 : (left < kItems ? (int)left : kItems);
    const long long vleft = n_valid - base;
    const int valid = vleft <= 0 ? 0 : (vleft < kItems ? (int)vleft : kItems);

    W key[kItems];
    if (vec && present == kItems) {
      const uint4* v = reinterpret_cast<const uint4*>(data + base);
#pragma unroll
      for (int u = 0; u < kThreadBytes / 16; ++u) unpack(__ldg(v + u), key + u * (16 / sizeof(W)));
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) key[j] = j < present ? data[base + j] : (W)0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) key[j] = j < valid ? to_key(key[j], fl, key_xor) : (W)0;

    // every loop over a thread's keys is unrolled, so key[] stays in
    // registers; pads (present, not valid) count as key 0 in the histograms
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < present) {
        const W s = key[j] >> shift;
        for (int q = 0; q < nq; ++q) {
          const W z = s ^ __ldg(zref + q);
          if (z < (W)nb) atomicAdd(hacc + q * nb + (int)z, 1u);
        }
        if (sketch_bits) atomicAdd(dacc + (int)(key[j] >> dshift), 1u);
      }
      if (j < valid && (cert || sketch_bits)) {
        lt += key[j] < vkey;
        le += key[j] <= vkey;
        kmin = key[j] < kmin ? key[j] : kmin;
        kmax = key[j] > kmax ? key[j] : kmax;
      }
    }

    for (int s = 0; s < n_surv; ++s) {
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j >= valid) break;
        bool hit = false;
        if (s < nc) {
          hit = spec_match(key[j], __ldg(cshift + s), __ldg(cpref + s));
        } else {
          for (int u = 0; u < nt && !hit; ++u) hit = spec_match(key[j], __ldg(tshift + u), __ldg(tpref + u));
        }
        m |= (unsigned)hit << j;
      }
      const unsigned c = __popc(m);
      unsigned incl = c;  // inclusive scan over the warp's lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned agg = 0;
        for (int w = 0; w < kWarps; ++w) {
          const unsigned x = s_warp[w];
          s_warp[w] = agg;  // now the warp's exclusive prefix
          agg += x;
        }
        unsigned long long* st = status + (long long)s * n_tiles;
        long long excl = 0;
        if (t == 0) {
          atomicExch(st, kFlagIncl | agg);
        } else {
          atomicExch(st + t, kFlagAgg | agg);
          for (long long p = t - 1;; --p) {  // decoupled look-back
            unsigned long long v;
            do { v = peek(st + p); } while (v == 0);
            excl += (long long)(v & kValueMask);
            if (v & kFlagIncl) break;
          }
          atomicExch(st + t, kFlagIncl | (unsigned long long)(excl + agg));
        }
        if (agg) atomicAdd(counts + s, agg);
        s_offset = excl;
      }
      __syncthreads();
      W* out = surv + (long long)s * L + s_offset + s_warp[warp] + (incl - c);
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if ((m >> j) & 1u) *out++ = key[j];
      __syncthreads();  // s_warp and s_offset are reused by the next buffer
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < hist_words; i += kThreads)
    if (smem_counts[i]) atomicAdd(hist + i, smem_counts[i]);
  for (int i = threadIdx.x; i < deep_words; i += kThreads)
    if (smem_counts[hist_words + i]) atomicAdd(deep + i, smem_counts[hist_words + i]);
  using A = typename Atom<W>::type;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lt += __shfl_down_sync(0xffffffffu, lt, d);
    le += __shfl_down_sync(0xffffffffu, le, d);
    const W a = __shfl_down_sync(0xffffffffu, kmin, d);
    const W b = __shfl_down_sync(0xffffffffu, kmax, d);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
  }
  if (lane == 0) {
    if (cert) {
      if (lt) atomicAdd(cert_out, lt);
      if (le) atomicAdd(cert_out + 1, le);
    }
    if (sketch_bits) {
      atomicMin(reinterpret_cast<A*>(ext), (A)kmin);
      atomicMax(reinterpret_cast<A*>(ext) + 1, (A)kmax);
    }
  }
}

template <typename W>
int launch(const W* data, long long L, long long n_valid, int is_float, W key_xor,
           const W* params, int nq, int shift, int radix_bits, int nc, int nt,
           int cert, W vkey, int sketch_bits, unsigned* hist, unsigned* counts,
           W* surv, unsigned* cert_out, unsigned* deep, W* ext,
           unsigned long long* scratch, int max_blocks, cudaStream_t stream) {
  constexpr long long kTile = (long long)kThreads * (kThreadBytes / sizeof(W));
  const long long n_tiles = (L + kTile - 1) / kTile;
  const long long hist_bytes = nq ? (long long)nq * 4 << radix_bits : 0;
  const long long deep_bytes = sketch_bits ? 4ll << sketch_bits : 0;
  const int hist_smem = hist_bytes && hist_bytes <= kHistSmem;
  const long long used = hist_smem ? hist_bytes : 0;
  const int deep_smem = deep_bytes && used + deep_bytes <= kSmemMax;
  const int smem = (int)(used + (deep_smem ? deep_bytes : 0));
  auto kernel = sweep_ingest_kernel<W>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const long long blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      data, L, n_valid, is_float, key_xor, params, nq, shift, radix_bits, nc, nt,
      cert, vkey, sketch_bits, hist_smem, deep_smem, vec, hist, counts, surv,
      cert_out, deep, ext, scratch, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define KSEL_SWEEP_ENTRY(BITS, W)                                               \
  extern "C" int ksel_sweep_ingest##BITS(                                       \
      const void* data, long long L, long long n_valid, int is_float,          \
      W key_xor, const void* params, int nq, int shift, int radix_bits,        \
      int nc, int nt, int cert, W vkey, int sketch_bits, void* hist,           \
      void* counts, void* surv, void* cert_out, void* deep, void* ext,         \
      void* scratch, int max_blocks, void* stream) {                           \
    return launch<W>(static_cast<const W*>(data), L, n_valid, is_float,         \
                     key_xor, static_cast<const W*>(params), nq, shift,         \
                     radix_bits, nc, nt, cert, vkey, sketch_bits,               \
                     static_cast<unsigned*>(hist), static_cast<unsigned*>(counts), \
                     static_cast<W*>(surv), static_cast<unsigned*>(cert_out),   \
                     static_cast<unsigned*>(deep), static_cast<W*>(ext),        \
                     static_cast<unsigned long long*>(scratch), max_blocks,     \
                     static_cast<cudaStream_t>(stream));                        \
  }

KSEL_SWEEP_ENTRY(32, uint32_t)
KSEL_SWEEP_ENTRY(64, uint64_t)

extern "C" const char* ksel_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
