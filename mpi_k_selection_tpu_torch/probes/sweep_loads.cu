// Probe kernels for the order-free route of ../csrc/sweep_ingest.cu: one
// digit histogram under one prefix and the certificate pair, over raw
// words (key = raw ^ key_xor), counted the same way in both kernels
// (a range test, per-warp sub-histograms, per-thread certificate sums)
// and read two ways:
//   regs_kernel  kUnroll 16-byte loads in flight per thread, grid-stride
//                (the way the shipped order-free route reads);
//   bulk_kernel  a ring of kStages shared-memory stages of kChunk bytes per
//                block, each filled by one cp.async.bulk (one issuing
//                thread, completion on an mbarrier), chunks grid-strided.
// Each launch may hold `pad` more bytes of shared memory than it uses, to
// stand for what the shipped kernel keeps there (sub-histogram copies, the
// prefix table), which limits the blocks an SM holds. sweep_probe.py beside
// this file builds it with nvcc, times both against the shipped kernel and
// checks that all three agree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kChunk = 16 * 1024;
constexpr int kCopies = 8;

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& v, uint64_t* w) {
  w[0] = ((uint64_t)v.y << 32) | v.x;
  w[1] = ((uint64_t)v.w << 32) | v.z;
}

template <typename W>
struct Counter {
  unsigned* mine;
  W key_xor, prefix, vkey;
  int shift, rb;
  unsigned lt = 0, le = 0;
  __device__ __forceinline__ void operator()(W raw) {
    const W key = raw ^ key_xor;
    const W s = key >> shift;
    if ((s >> rb) == prefix) atomicAdd(mine + (int)(s & ((W)(1 << rb) - 1)), 1u);
    lt += key < vkey;
    le += key <= vkey;
  }
};

template <typename W>
__device__ void flush(Counter<W>& c, unsigned* sub, unsigned* hist, unsigned* cert, int nb) {
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    unsigned s = 0;
    for (int k = 0; k < kCopies; ++k) s += sub[k * nb + i];
    if (s) atomicAdd(hist + i, s);
  }
  for (int d = 16; d > 0; d >>= 1) {
    c.lt += __shfl_down_sync(0xffffffffu, c.lt, d);
    c.le += __shfl_down_sync(0xffffffffu, c.le, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(cert, c.lt);
    atomicAdd(cert + 1, c.le);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
regs_kernel(const W* __restrict__ data, long long n, W key_xor, W prefix, int shift, int rb, W vkey,
            unsigned* hist, unsigned* cert) {
  constexpr int V = 16 / sizeof(W);
  extern __shared__ unsigned sub[];
  const int nb = 1 << rb;
  for (int i = threadIdx.x; i < kCopies * nb; i += kThreads) sub[i] = 0u;
  __syncthreads();
  Counter<W> c{sub + (threadIdx.x >> 5) % kCopies * nb, key_xor, prefix, vkey, shift, rb};
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nvec = n / V;
  const uint4* vdata = reinterpret_cast<const uint4*>(data);
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vdata + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      W w[V];
      unpack(v[u], w);
#pragma unroll
      for (int j = 0; j < V; ++j) c(w[j]);
    }
  }
  for (; i < nvec; i += stride) {
    W w[V];
    unpack(__ldg(vdata + i), w);
    for (int j = 0; j < V; ++j) c(w[j]);
  }
  for (long long e = nvec * V + (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) c(data[e]);
  flush(c, sub, hist, cert, nb);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Waits for the phase of the mbarrier at addr with the given parity to
// complete; traps rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  for (long long spins = 0;; ++spins) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(addr), "r"(parity) : "memory");
    if (ok) return;
    if (spins > (1ll << 24)) __trap();
  }
}

template <typename W, int kStages>
__global__ void __launch_bounds__(kThreads)
bulk_kernel(const W* __restrict__ data, long long n, W key_xor, W prefix, int shift, int rb, W vkey,
            unsigned* hist, unsigned* cert) {
  constexpr int V = 16 / sizeof(W);
  constexpr int kWords = kChunk / sizeof(W);
  extern __shared__ __align__(128) unsigned char smem[];
  W* stage = reinterpret_cast<W*>(smem);
  unsigned* sub = reinterpret_cast<unsigned*>(smem + kStages * kChunk);
  __shared__ __align__(8) unsigned long long bar[kStages];
  const int nb = 1 << rb;
  for (int i = threadIdx.x; i < kCopies * nb; i += kThreads) sub[i] = 0u;
  const long long n_chunks = (n + kWords - 1) / kWords;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread fills stage k % kStages with the block's k-th chunk: the
  // 16-byte multiple by cp.async.bulk, a ragged tail by the consumers
  auto fill = [&](long long k) {
    const long long chunk = blockIdx.x + k * gridDim.x;
    if (chunk >= n_chunks) return;
    const long long left = n - chunk * kWords;
    const unsigned bytes = (unsigned)((left < kWords ? left : kWords) * sizeof(W)) & ~15u;
    const unsigned b = smem_addr(bar + k % kStages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
    if (bytes)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(smem_addr(stage + (k % kStages) * kWords)), "l"(data + chunk * kWords), "r"(bytes), "r"(b)
                   : "memory");
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages; ++k) fill(k);
  Counter<W> c{sub + (threadIdx.x >> 5) % kCopies * nb, key_xor, prefix, vkey, shift, rb};
  for (long long k = 0;; ++k) {
    const long long chunk = blockIdx.x + k * gridDim.x;
    if (chunk >= n_chunks) break;
    mbar_wait(smem_addr(bar + k % kStages), (unsigned)((k / kStages) & 1));
    const W* s = stage + (k % kStages) * kWords;
    const long long left = n - chunk * kWords;
    const int words = (int)(left < kWords ? left : kWords);
    const int vwords = (words * (int)sizeof(W) & ~15) / (int)sizeof(W);
    for (int i = threadIdx.x; i < vwords / V; i += kThreads) {
      W w[V];
      unpack(reinterpret_cast<const uint4*>(s)[i], w);
#pragma unroll
      for (int j = 0; j < V; ++j) c(w[j]);
    }
    for (int e = vwords + threadIdx.x; e < words; e += kThreads) c(data[chunk * kWords + e]);
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0) fill(k + kStages);
  }
  flush(c, sub, hist, cert, nb);
}

template <typename W>
int run(int which, int pad, const void* data, long long n, W key_xor, W prefix, int shift, int rb, W vkey,
        void* hist, void* cert, int sms, void* stream) {
  const int nb = 1 << rb;
  const int sub_bytes = kCopies * nb * 4;
  auto go = [&](auto kernel, int used) -> int {
    const int smem = used + pad;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<per_sm * sms, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const W*>(data), n, key_xor, prefix, shift, rb, vkey, static_cast<unsigned*>(hist),
        static_cast<unsigned*>(cert));
    return (int)cudaGetLastError();
  };
  if (which == 0) return go(regs_kernel<W>, sub_bytes);
  if (which == 3) return go(bulk_kernel<W, 3>, 3 * kChunk + sub_bytes);
  if (which == 4) return go(bulk_kernel<W, 4>, 4 * kChunk + sub_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int probe_loads32(int which, int pad, const void* data, long long n, unsigned key_xor,
                             unsigned prefix, int shift, int rb, unsigned vkey, void* hist, void* cert, int sms,
                             void* stream) {
  return run<uint32_t>(which, pad, data, n, key_xor, prefix, shift, rb, vkey, hist, cert, sms, stream);
}

extern "C" int probe_loads64(int which, int pad, const void* data, long long n, unsigned long long key_xor,
                             unsigned long long prefix, int shift, int rb, unsigned long long vkey, void* hist,
                             void* cert, int sms, void* stream) {
  return run<uint64_t>(which, pad, data, n, key_xor, prefix, shift, rb, vkey, hist, cert, sms, stream);
}
