// Hopper (sm_90a) kernels of the radix select, the multi-rank select and
// the threshold top-k.
//
// radix_histogram<W>  replaces mpi_k_selection_tpu/ops/pallas/histogram.py:
//                     pallas_radix_histogram (W = uint32) and
//                     pallas_radix_histogram64 (W = uint64).
//   Computes the (2^radix_bits,) counts of the digit (key >> shift) & mask
//   over the keys whose bits above the digit equal *prefix (every key when
//   prefix is null). key = raw ^ key_xor, or the float transform when
//   is_float (neg ? ~raw : raw | MSB), so the kernel reads the caller's raw
//   array in place: no key pass, no pad copy, no hi/lo plane split.
//   Bound: bytes. One read of n words (4n or 8n bytes) per pass; the
//   arithmetic is a few integer operations per key. The design streams the
//   input with 16-byte loads, kUnroll of them in flight per thread, and
//   counts into per-warp shared-memory sub-histograms so that a hot bin
//   (all keys equal) serialises one warp's atomics, not the block's. Each
//   block adds its sums into the int64 global output with one atomic per
//   bin. A misaligned base (a sliced tensor) takes the scalar loop.
//
// match_counts<W>     replaces mpi_k_selection_tpu/ops/pallas/histogram.py:
//                     pallas_match_counts.
//   For each 128-element row r and each of nq prefixes q, out[q, r] counts
//   the keys of the row whose top resolved bits equal prefixes[q] (the
//   caller passes mshift = key bits - resolved bits). Elements past n are
//   masked. 64-bit keys are read as whole words: no hi plane.
//   Bound: bytes. One read of the n words plus 4 * nq * rows bytes written.
//   The design gives each row to one warp: lane l reads elements l, l+32,
//   l+64 and l+96 (four coalesced loads), and each prefix's count is the
//   population count of four warp ballots.
//
// radix_histogram_multi<W>  replaces mpi_k_selection_tpu/ops/pallas/histogram.py:
//                     pallas_radix_histogram_multi (W = uint32) and
//                     pallas_radix_histogram64_multi (W = uint64).
//   For each of nq prefixes q, out[q, :] is radix_histogram's output under
//   prefixes[q]: one read of the data serves every query. Two queries may
//   hold the same prefix (close or repeated ranks); each gets the whole
//   histogram. 64-bit keys are read as whole words: the Pallas kernel's
//   shift >= 32 reroute to the hi plane has no counterpart.
//   Bound: bytes. One read of the n words, and one prefix lookup per key
//   whatever nq: at the card's memory rate its SMs issue about 30
//   instructions a key, a budget that a compare with every prefix overran
//   from nq = 4 on. Each block first hashes the nq prefixes into a shared
//   table of 2^tbits 16-bit entries (tbits = min(prefix bits, 12)): a
//   query claims an empty entry with atomicCAS and becomes the owner of
//   its prefix, and a query whose prefix an earlier claim already holds
//   takes that owner's row instead, so the table holds the distinct
//   prefixes only and a repeated prefix is counted once. With 12 prefix
//   bits or fewer the entry index is the prefix itself (no collision, no
//   compare); with more, a multiplicative hash of it and linear probing,
//   the table at most half full (nq <= 2048 per launch). A key whose top
//   bits fall outside [smallest, largest] valid prefix (two compares on
//   registers) touches no shared memory; any other key reads one entry,
//   and an empty entry ends the lookup. A hit counts one shared atomic in
//   its owner's row of one of `copies` (8, 4, 2 or 1) sub-histograms, warp
//   w counting into copy w % copies, so that a hot bin serialises a few
//   warps and not the block; the wrapper picks the most copies within an
//   eighth of the SM's shared memory (the rest is L1 cache, which holds
//   the loads in flight), and splits the queries over launches so that a
//   block leaves two on an SM. The flush gives each query the sum of its
//   owner's row over the copies, one int64 global atomic per non-zero bin.
//   The launch raises the kernel's dynamic shared memory limit above 48 KB
//   and clamps the grid to the blocks that fit on the card at once.
//
// tau_counts<W>       replaces mpi_k_selection_tpu/ops/pallas/histogram.py:
//                     pallas_tau_counts.
//   For each 128-element row r, out[r] counts the keys strictly beyond the
//   full-width key *tau (greater when largest, else less, in unsigned key
//   order) and out[rows + r] the keys equal to it. Elements past n are
//   masked. tau is read through a device pointer, so the caller never
//   syncs for it.
//   Bound: bytes. One read of the n words plus 8 * rows bytes written. The
//   geometry is match_counts': one warp per row, two ballots per load.
//
// Launches go on the caller's stream; each entry point returns
// cudaGetLastError() so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kRow = 128;

template <typename W> struct Signed;
template <> struct Signed<uint32_t> { using type = int32_t; };
template <> struct Signed<uint64_t> { using type = int64_t; };

// The sortable key of a raw word. For floats the arithmetic shift spreads
// the sign bit into the xor mask: ~0 for negatives, MSB otherwise.
template <typename W>
__device__ __forceinline__ W to_key(W raw, bool is_float, W key_xor) {
  constexpr int B = sizeof(W) * 8;
  using S = typename Signed<W>::type;
  const W m = is_float ? ((W)((S)raw >> (B - 1)) | ((W)1 << (B - 1))) : key_xor;
  return raw ^ m;
}

// The words of one 16-byte load, in address order.
__device__ __forceinline__ void unpack(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& v, uint64_t (&w)[2]) {
  w[0] = ((uint64_t)v.y << 32) | v.x;
  w[1] = ((uint64_t)v.w << 32) | v.z;
}

// Streams data[0, n) with 16-byte loads (kUnroll in flight per thread)
// when vec, else with scalar loads, and calls count(word) on every word.
template <typename W, typename F>
__device__ __forceinline__ void stream_words(const W* __restrict__ data,
                                             long long n, int vec, F&& count) {
  constexpr int V = 16 / sizeof(W);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? n / V : 0;
  const uint4* vdata = reinterpret_cast<const uint4*>(data);
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vdata + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      W w[V];
      unpack(v[u], w);
#pragma unroll
      for (int j = 0; j < V; ++j) count(w[j]);
    }
  }
  for (; i < nvec; i += stride) {
    W w[V];
    unpack(__ldg(vdata + i), w);
#pragma unroll
    for (int j = 0; j < V; ++j) count(w[j]);
  }
  for (long long e = nvec * V + tid; e < n; e += stride) count(data[e]);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const W* __restrict__ data, long long n, int shift,
                       int radix_bits, int is_float, W key_xor,
                       const W* __restrict__ prefix,
                       unsigned long long* __restrict__ out, int vec) {
  extern __shared__ unsigned int sub[];  // kWarps x 2^radix_bits
  const int nb = 1 << radix_bits;
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) sub[i] = 0u;
  __syncthreads();

  unsigned int* mine = sub + (threadIdx.x >> 5) * nb;
  const bool has_prefix = prefix != nullptr;
  const W want = has_prefix ? *prefix : (W)0;
  // the prefix shift is only formed when there is a prefix: without one,
  // shift + radix_bits may equal the word width, a shift C++ leaves undefined
  const int pshift = has_prefix ? shift + radix_bits : 0;
  const W dmask = (W)(nb - 1);
  const bool fl = is_float != 0;

  stream_words(data, n, vec, [&](W raw) {
    const W key = to_key(raw, fl, key_xor);
    if (!has_prefix || (key >> pshift) == want)
      atomicAdd(mine + (unsigned)((key >> shift) & dmask), 1u);
  });
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sub[w * nb + b];
    if (s) atomicAdd(out + b, s);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
match_counts_kernel(const W* __restrict__ data, long long n, long long rows,
                    int mshift, int is_float, W key_xor,
                    const W* __restrict__ prefixes, int nq,
                    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarp = ((long long)gridDim.x * blockDim.x) >> 5;
  const bool fl = is_float != 0;
  for (long long r = warp; r < rows; r += nwarp) {  // warp-uniform loop
    W top[kRow / 32];
    bool ok[kRow / 32];
#pragma unroll
    for (int j = 0; j < kRow / 32; ++j) {
      const long long pos = r * kRow + j * 32 + lane;
      ok[j] = pos < n;
      top[j] = ok[j] ? to_key(data[pos], fl, key_xor) >> mshift : (W)0;
    }
    for (int q = 0; q < nq; ++q) {
      const W p = prefixes[q];
      int c = 0;
#pragma unroll
      for (int j = 0; j < kRow / 32; ++j)
        c += __popc(__ballot_sync(0xffffffffu, ok[j] && top[j] == p));
      if (lane == 0) out[(long long)q * rows + r] = c;
    }
  }
}

// The prefix table of radix_histogram_multi (ops/cuda/histogram.py mirrors
// both numbers): at most 2^kTableBits entries, at most half of them used.
constexpr int kTableBits = 12;
constexpr int kMaxMultiQueries = 1 << (kTableBits - 1);

// The table entry a prefix starts from: the prefix itself when the table
// has an entry for every prefix (exact), else a multiplicative hash.
template <typename W>
__device__ __forceinline__ unsigned table_home(W top, bool exact, int tbits) {
  const unsigned folded = (unsigned)top ^ (unsigned)((unsigned long long)top >> 32);
  return exact ? (unsigned)top : (folded * 0x9E3779B1u) >> (32 - tbits);
}

// Shared memory of one block, in order: the smallest and largest valid
// prefix (two 64-bit words), the nq prefixes, copies x nq x 2^radix_bits
// uint32 counters, the nq owners and the 2^tbits table entries
// (ops/cuda/histogram.py:_multi_smem_bytes).
template <typename W>
size_t multi_smem_bytes(int nq, int copies, int radix_bits, int tbits) {
  return 2 * sizeof(unsigned long long) + (size_t)nq * sizeof(W) +
         (size_t)copies * nq * (1u << radix_bits) * sizeof(unsigned int) +
         (size_t)nq * sizeof(unsigned short) + ((size_t)1 << tbits) * sizeof(unsigned short);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
radix_histogram_multi_kernel(const W* __restrict__ data, long long n,
                             int shift, int radix_bits, int is_float,
                             W key_xor, const W* __restrict__ prefixes,
                             int nq, int copies, int tbits,
                             unsigned long long* __restrict__ out, int vec) {
  extern __shared__ unsigned long long smem_multi[];
  unsigned long long* range = smem_multi;  // smallest, largest valid prefix
  W* pref = reinterpret_cast<W*>(range + 2);
  unsigned int* hist = reinterpret_cast<unsigned int*>(pref + nq);
  const int nb = 1 << radix_bits;
  const int rowbins = nq * nb;
  unsigned short* owner = reinterpret_cast<unsigned short*>(hist + copies * rowbins);
  unsigned short* table = owner + nq;
  const int pbits = sizeof(W) * 8 - shift - radix_bits;  // >= 1: every query has a prefix
  const bool exact = pbits <= kTableBits;                // then tbits == pbits
  const unsigned tmask = (1u << tbits) - 1;

  if (threadIdx.x == 0) {
    range[0] = ~0ull;
    range[1] = 0;
  }
  for (int i = threadIdx.x; i < nq; i += blockDim.x) pref[i] = prefixes[i];
  for (int i = threadIdx.x; i <= (int)tmask; i += blockDim.x) table[i] = 0;
  for (int i = threadIdx.x; i < copies * rowbins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const W p = pref[q];
    owner[q] = q;  // a prefix no key can hold keeps its own row, all zero
    if (p >> pbits) continue;
    atomicMin(range, (unsigned long long)p);
    atomicMax(range + 1, (unsigned long long)p);
    for (unsigned h = table_home(p, exact, tbits);; h = (h + 1) & tmask) {
      const unsigned short e = atomicCAS(table + h, (unsigned short)0, (unsigned short)(q + 1));
      if (e == 0) break;                                      // q owns p
      if (pref[e - 1] == p) { owner[q] = e - 1; break; }      // p is already owned
    }
  }
  __syncthreads();

  const W lo = (W)range[0], hi = (W)range[1];  // no valid prefix: lo > hi
  const int pshift = shift + radix_bits;
  const W dmask = (W)(nb - 1);
  const bool fl = is_float != 0;
  unsigned int* mine = hist + ((threadIdx.x >> 5) % copies) * rowbins;
  stream_words(data, n, vec, [&](W raw) {
    const W key = to_key(raw, fl, key_xor);
    const W top = key >> pshift;
    if (top < lo || top > hi) return;
    unsigned e;
    for (unsigned h = table_home(top, exact, tbits); (e = table[h]) != 0; h = (h + 1) & tmask) {
      if (exact || pref[e - 1] == top) {
        atomicAdd(mine + (e - 1) * nb + (unsigned)((key >> shift) & dmask), 1u);
        break;
      }
    }
  });
  __syncthreads();

  for (int i = threadIdx.x; i < rowbins; i += blockDim.x) {
    const unsigned int* bin = hist + owner[i >> radix_bits] * nb + (i & (nb - 1));
    unsigned long long s = 0;
    for (int c = 0; c < copies; ++c) s += bin[c * rowbins];
    if (s) atomicAdd(out + i, s);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
tau_counts_kernel(const W* __restrict__ data, long long n, long long rows,
                  int is_float, W key_xor, const W* __restrict__ tau_ptr,
                  int largest, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarp = ((long long)gridDim.x * blockDim.x) >> 5;
  const bool fl = is_float != 0;
  const W tau = *tau_ptr;
  for (long long r = warp; r < rows; r += nwarp) {  // warp-uniform loop
    W key[kRow / 32];
    bool ok[kRow / 32];
#pragma unroll
    for (int j = 0; j < kRow / 32; ++j) {
      const long long pos = r * kRow + j * 32 + lane;
      ok[j] = pos < n;
      key[j] = ok[j] ? to_key(data[pos], fl, key_xor) : (W)0;
    }
    int beyond = 0, equal = 0;
#pragma unroll
    for (int j = 0; j < kRow / 32; ++j) {
      const bool b = largest ? key[j] > tau : key[j] < tau;
      beyond += __popc(__ballot_sync(0xffffffffu, ok[j] && b));
      equal += __popc(__ballot_sync(0xffffffffu, ok[j] && key[j] == tau));
    }
    if (lane == 0) {
      out[r] = beyond;
      out[rows + r] = equal;
    }
  }
}

template <typename W>
int launch_histogram(const void* data, long long n, int shift, int radix_bits,
                     int is_float, W key_xor, const void* prefix, void* out,
                     int grid, void* stream) {
  const size_t smem = (size_t)kWarps * (1u << radix_bits) * sizeof(unsigned int);
  const int vec = (reinterpret_cast<uintptr_t>(data) % 16) == 0;
  radix_histogram_kernel<W><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const W*>(data), n, shift, radix_bits, is_float, key_xor,
      static_cast<const W*>(prefix), static_cast<unsigned long long*>(out), vec);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_match_counts(const void* data, long long n, long long rows,
                        int mshift, int is_float, W key_xor,
                        const void* prefixes, int nq, void* out, int grid,
                        void* stream) {
  match_counts_kernel<W><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const W*>(data), n, rows, mshift, is_float, key_xor,
      static_cast<const W*>(prefixes), nq, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

template <typename W>
int launch_histogram_multi(const void* data, long long n, int shift,
                           int radix_bits, int is_float, W key_xor,
                           const void* prefixes, int nq, int copies, void* out,
                           int grid, void* stream) {
  if (nq > kMaxMultiQueries || copies < 1) return (int)cudaErrorInvalidValue;
  const int pbits = (int)sizeof(W) * 8 - shift - radix_bits;
  const int tbits = pbits < kTableBits ? pbits : kTableBits;
  const size_t smem = multi_smem_bytes<W>(nq, copies, radix_bits, tbits);
  const auto kernel = radix_histogram_multi_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // every block resident at once: a second, partial wave of equal blocks
  // would leave most of the card idle while it runs
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (grid > per_sm * sms) grid = per_sm * sms;
  const int vec = (reinterpret_cast<uintptr_t>(data) % 16) == 0;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const W*>(data), n, shift, radix_bits, is_float, key_xor,
      static_cast<const W*>(prefixes), nq, copies, tbits,
      static_cast<unsigned long long*>(out), vec);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_tau_counts(const void* data, long long n, long long rows,
                      int is_float, W key_xor, const void* tau, int largest,
                      void* out, int grid, void* stream) {
  tau_counts_kernel<W><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const W*>(data), n, rows, is_float, key_xor,
      static_cast<const W*>(tau), largest, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ksel_radix_histogram32(const void* data, long long n, int shift,
                           int radix_bits, int is_float, unsigned int key_xor,
                           const void* prefix, void* out, int grid,
                           void* stream) {
  return launch_histogram<uint32_t>(data, n, shift, radix_bits, is_float,
                                    key_xor, prefix, out, grid, stream);
}

int ksel_radix_histogram64(const void* data, long long n, int shift,
                           int radix_bits, int is_float,
                           unsigned long long key_xor, const void* prefix,
                           void* out, int grid, void* stream) {
  return launch_histogram<uint64_t>(data, n, shift, radix_bits, is_float,
                                    key_xor, prefix, out, grid, stream);
}

int ksel_match_counts32(const void* data, long long n, long long rows,
                        int mshift, int is_float, unsigned int key_xor,
                        const void* prefixes, int nq, void* out, int grid,
                        void* stream) {
  return launch_match_counts<uint32_t>(data, n, rows, mshift, is_float,
                                       key_xor, prefixes, nq, out, grid,
                                       stream);
}

int ksel_match_counts64(const void* data, long long n, long long rows,
                        int mshift, int is_float, unsigned long long key_xor,
                        const void* prefixes, int nq, void* out, int grid,
                        void* stream) {
  return launch_match_counts<uint64_t>(data, n, rows, mshift, is_float,
                                       key_xor, prefixes, nq, out, grid,
                                       stream);
}

int ksel_radix_histogram_multi32(const void* data, long long n, int shift,
                                 int radix_bits, int is_float,
                                 unsigned int key_xor, const void* prefixes,
                                 int nq, int copies, void* out, int grid,
                                 void* stream) {
  return launch_histogram_multi<uint32_t>(data, n, shift, radix_bits, is_float,
                                          key_xor, prefixes, nq, copies, out,
                                          grid, stream);
}

int ksel_radix_histogram_multi64(const void* data, long long n, int shift,
                                 int radix_bits, int is_float,
                                 unsigned long long key_xor,
                                 const void* prefixes, int nq, int copies,
                                 void* out, int grid, void* stream) {
  return launch_histogram_multi<uint64_t>(data, n, shift, radix_bits, is_float,
                                          key_xor, prefixes, nq, copies, out,
                                          grid, stream);
}

int ksel_tau_counts32(const void* data, long long n, long long rows,
                      int is_float, unsigned int key_xor, const void* tau,
                      int largest, void* out, int grid, void* stream) {
  return launch_tau_counts<uint32_t>(data, n, rows, is_float, key_xor, tau,
                                     largest, out, grid, stream);
}

int ksel_tau_counts64(const void* data, long long n, long long rows,
                      int is_float, unsigned long long key_xor,
                      const void* tau, int largest, void* out, int grid,
                      void* stream) {
  return launch_tau_counts<uint64_t>(data, n, rows, is_float, key_xor, tau,
                                     largest, out, grid, stream);
}

const char* ksel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
