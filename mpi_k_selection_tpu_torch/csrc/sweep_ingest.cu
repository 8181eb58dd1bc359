// Hopper (sm_90a) kernel of the streamed descent's per-chunk ingest.
//
// sweep_ingest<W>  replaces mpi_k_selection_tpu/ops/pallas/sweep_ingest.py:
//                  sweep_ingest_core (W = uint32; W = uint64 replaces the
//                  XLA fusion tier ops/pallas/fused_ingest.py:
//                  fused_ingest_core / compact_core, which the JAX package
//                  runs for 64-bit key spaces).
//   One read of a staged bucket of L raw words, of which the first n_valid
//   are keys and the rest are pads (key 0), gives every enabled part:
//   - hist: for each of nd distinct prefixes, the 2^rb counts of the digit
//     (key >> shift) & (2^rb - 1) over the keys whose bits above the digit
//     equal the prefix, over the whole padded bucket (pads counted; the
//     caller subtracts them). The wrapper folds repeated prefixes into one
//     row and expands the rows again, so the kernel counts each key once;
//   - collect: for each of nc specs, the valid keys with key & mask == want
//     (the wrapper's form of key >> shift == prefix, shifts of the word
//     width included), front-packed in chunk order into an L-word buffer
//     with zeros after, and their count;
//   - tee: the same over the union of nt specs, into one more buffer;
//   - cert: (#valid keys < vkey, #valid keys <= vkey), unsigned compares;
//   - sketch: counts of the top sketch_bits key bits over the padded
//     bucket, and the min and max of the valid keys.
//   key = raw ^ key_xor, or the float transform when is_float (neg ? ~raw :
//   raw | MSB): host chunks cross to the card as their own bytes.
//   Bound: bytes. One read of the L words (4L or 8L bytes) at 3.35 TB/s,
//   plus each survivor buffer written once (L words: the survivors, then
//   zeros). A key costs a few integer operations: one prefix lookup
//   whatever nd, one compare per spec.
//   Design. Two routes, chosen at launch from the parts (kOrdered):
//   - order-free (no collect, no tee: every histogram pass, every
//     certificate, the sketch). Nothing depends on chunk order, so a
//     persistent grid, clamped to the blocks resident at once, streams the
//     bucket with kUnroll 16-byte loads in flight per thread: no ticket,
//     no look-back, no barrier inside the loop, and no shared memory for
//     staging, which the sub-histogram copies and the prefix table need
//     (../probes/sweep_probe.py weighs this against a cp.async.bulk ring).
//   - ordered (collect or tee). Blocks of 512 threads, one an SM, take
//     64 KB tiles in chunk order from an atomic ticket into a ring of three
//     shared-memory stages (cp.async): one tile being written, one counted,
//     one loading. The next tile's ticket is taken during the count of the
//     current one (never earlier: a look-back then only waits on tiles that
//     other blocks are counting) and its loads are issued before the
//     current tile's look-back. The work goes in items, a group of up to
//     kGroup buffers of one tile (the tee buffer last in the last group):
//     one block scan serves a group, its counts packed as 16-bit fields of
//     one 64-bit word. A step counts one item and publishes its aggregate
//     while one warp per buffer of the item before looks back: 32
//     predecessor status words per probe, a ballot finds the nearest
//     inclusive prefix and a warp sum adds the aggregates up to it. Those
//     predecessors had a whole step to publish, and a tile's predecessors
//     already hold tickets, so every look-back ends. The step then writes
//     the item before: each warp compacts a 512-byte row's survivors in
//     shared memory and writes them as one coalesced run, and the tile also
//     zeroes its non-survivors' share of the buffer's tail (counted from
//     the end), so every output word is written once and no separate clear
//     runs.
//   Counting, both routes: with one prefix a range test on registers
//   decides; with more, a shared table of 2^tbits 16-bit entries maps a
//   prefix to its row (tbits = prefix bits up to kTableBits, no compare;
//   above, a multiplicative hash with linear probing, at most half full),
//   after a range test on registers against [lo, hi]. Hits count in one
//   of `copies` per-warp sub-histograms (warp w into copy w % copies), so
//   a hot bin serialises a few warps and not the block; the flush adds the
//   copies into the global rows, one atomic per non-zero bin. Counters go
//   straight to global memory when they do not fit.
//   The sketch, and a histogram of one prefix, at 15 and 16 bits: 2^16
//   int32 counters (256 KB) fit no block, so each counter is 16 bits, two
//   to a 32-bit word (128 KB at 16 bits), in an order-free block of
//   kWideThreads threads, one an SM, with as many loads in flight per SM
//   as six narrow blocks. An add that carries a half past 0xFFFF credits
//   the 2^16 counts it dropped, and the one it carried into the high half,
//   to the global int32 counters (add_packed): exact whatever the counts,
//   the timing of the warps, or the data. Those counters, and the
//   sketch's in any memory, go through warp_count: in a warp step whose
//   first keys share a bin in a quarter of the lanes, the lanes of each
//   bin add as one (__match_any_sync), so a bin that every key hits takes
//   one atomic a warp and not 32; other steps add a key at a time, which
//   distinct bins need. The ordered route counts a key at a time.
//   A kernel compiles only
//   the parts a launch asks for (kParts), which keeps the per-key code of
//   the streamed passes short. Parameters travel by value (a
//   __grid_constant__ struct); only more than kParamPrefixes prefixes or
//   kParamSpecs specs come through device arrays. The last block to finish
//   turns the complemented minimum into the minimum, so one memset clears
//   the whole arena of counters.
//
// The launch clears the arena of counters (one memset) and starts the
// kernel on the caller's stream; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;       // order-free route
constexpr int kWideThreads = 1024;  // order-free route with 16-bit counters: one block an SM
constexpr int kUnroll = 4;          // order-free: 16-byte loads in flight per thread
constexpr int kOrdThreads = 512;  // ordered route
constexpr int kOrdWarps = kOrdThreads / 32;
constexpr int kTileBytes = 64 * 1024;
constexpr int kStages = 3;      // ordered: a tile written, a tile counted, a tile loading
constexpr int kRowBytes = 512;  // one warp row: 32 lanes x 16 bytes
constexpr int kRows = kTileBytes / kOrdWarps / kRowBytes;  // rows per warp per tile
constexpr int kGroup = 4;       // buffers per block scan: 16-bit fields of 64 bits
constexpr int kParamPrefixes = 64;
constexpr int kParamSpecs = 16;
constexpr int kTableBits = 12;
constexpr unsigned long long kFlagAgg = 1ull << 62;   // tile aggregate only
constexpr unsigned long long kFlagIncl = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
static_assert(kRows * kOrdWarps * kRowBytes == kTileBytes, "tile rows");
// a tile's count of one buffer fits a 16-bit field
static_assert(kTileBytes / 4 < (1 << 16), "tile counts");
static_assert(kGroup * kRows <= 64 && kGroup == 4 && kGroup <= kOrdWarps,
              "a group's row bits; its buffers unrolled by hand; a warp per buffer");

template <int N> struct Int {  // a loop index known at compile time
  static constexpr int value = N;
};

template <typename W> struct Signed;
template <> struct Signed<uint32_t> { using type = int32_t; };
template <> struct Signed<uint64_t> { using type = int64_t; };

template <typename W> struct Atom;
template <> struct Atom<uint32_t> { using type = unsigned int; };
template <> struct Atom<uint64_t> { using type = unsigned long long; };

// A warp step looks hot when kHotLanes of its lanes hold lane 0's bin
// (warp_hot); its lanes of one bin then add as one (warp_count).
// ../probes/sweep_probe.py times this against an atomic a key and against
// __match_any_sync on every step (PERF.md §6).
constexpr int kHotLanes = 8;

template <typename W>
struct Params {
  const W* data;
  long long L, n_valid, n_tiles;
  W key_xor;
  int is_float;
  // histogram: nd distinct prefixes, counted into rows 0 .. nd-1 of hist;
  // hist_smem and deep_smem: the bytes of a counter in shared memory, 4
  // (int32) or 2 (16-bit halves, the wide order-free block only), or 0
  // (global memory)
  int nd, shift, rb, pbits, tbits, copies, hist_smem;
  W lo, hi;           // the smallest and largest prefix
  const W* pref_dev;  // the nd prefixes, when nd > kParamPrefixes
  W pref[kParamPrefixes];
  // survivor specs: nc collect specs, then nt tee specs; key & mask == want
  int nc, nt;
  const W* spec_dev;  // nc + nt masks, then nc + nt wants, when nc + nt > kParamSpecs
  W smask[kParamSpecs];
  W swant[kParamSpecs];
  // certificate and sketch
  int cert, sketch_bits, deep_smem;
  W vkey;
  // outputs and scratch
  unsigned* hist;    // nd x 2^rb
  unsigned* counts;  // nc + (nt > 0)
  unsigned* cert_out;
  unsigned* deep;    // 2^sketch_bits
  W* ext;            // ~min, then max; the last block leaves min, max
  unsigned* done;    // blocks finished (the sketch's last block)
  unsigned* ticket;
  unsigned long long* status;  // (buffer, tile) look-back words
  W* surv;           // (nc + (nt > 0)) x L
};

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

// The table entry a prefix starts from: the prefix itself when the table
// has an entry for every prefix (exact), else a multiplicative hash.
template <typename W>
__device__ __forceinline__ unsigned table_home(W top, bool exact, int tbits) {
  const unsigned folded = (unsigned)top ^ (unsigned)((unsigned long long)top >> 32);
  return exact ? (unsigned)top : (folded * 0x9E3779B1u) >> (32 - tbits);
}

__host__ __device__ constexpr long long align16(long long b) { return (b + 15) / 16 * 16; }

// Dynamic shared memory of one block, in order (ops/cuda/sweep_ingest.py
// mirrors it in _smem_bytes): the tile stages and the warps' row staging
// (ordered route), the specs (ordered route), the prefix table and the
// prefixes (nd > 1), the sub-histogram copies (hist_smem) and the sketch
// counters (deep_smem).
struct Layout {
  long long stage, staging, specs, table, pref, hist, deep, total;
};

template <typename W, bool kOrdered>
__host__ __device__ Layout layout(int nd, int tbits, int copies, int rb, int hist_smem,
                                  int n_specs, int sketch_bits, int deep_smem) {
  Layout s{};
  long long o = 0;
  s.stage = o;
  o += kOrdered ? (long long)kStages * kTileBytes : 0;
  s.staging = o;
  o += kOrdered ? (long long)kOrdWarps * kRowBytes : 0;
  s.specs = o;
  o += kOrdered ? align16(2ll * n_specs * (long long)sizeof(W)) : 0;
  s.table = o;
  o += nd > 1 ? align16(2ll << tbits) : 0;
  s.pref = o;
  o += nd > 1 ? align16((long long)nd * sizeof(W)) : 0;
  s.hist = o;
  o += (long long)copies * nd * ((long long)hist_smem << rb);
  s.deep = o;
  o += (long long)deep_smem << sketch_bits;
  s.total = o;
  return s;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// cp.async of 16 bytes (the bytes past src_bytes zero-filled) or of one
// word, global to shared; their commit and wait
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_word(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The exclusive prefix of tile t in one buffer's chain of status words,
// found by the calling warp: each probe reads the 32 newest predecessors
// not yet summed (lane l the l-th newest), waits until every one up to the
// nearest inclusive prefix has published, and adds their values.
__device__ long long warp_lookback(const unsigned long long* st, long long t, int lane) {
  long long excl = 0;
  for (long long top = t - 1;; top -= 32) {
    const long long idx = top - lane;
    unsigned long long v = idx >= 0 ? peek(st + idx) : kFlagIncl;  // before tile 0: an inclusive 0
    unsigned incl, upto;
    for (;;) {
      incl = __ballot_sync(0xffffffffu, (v & kFlagIncl) != 0);
      const unsigned busy = __ballot_sync(0xffffffffu, v == 0);
      upto = incl ? ((incl & (0u - incl)) << 1) - 1u : 0xffffffffu;  // lanes up to the nearest inclusive
      if (!(busy & upto)) break;
      if (v == 0) v = peek(st + idx);  // a lane still at 0 has idx >= 0
    }
    unsigned long long val = ((upto >> lane) & 1u) ? (v & kValueMask) : 0ull;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) val += __shfl_xor_sync(0xffffffffu, val, d);
    excl += (long long)val;
    if (incl) return excl;
  }
}

// Adds c (at most 32) to the 16-bit counter `bin` of `cnt`, two to a word
// (bin 2j in the low half of word j, 2j + 1 in the high half), exactly: the
// atomic returns the word as it was, so the thread knows what its add did
// to both halves. A half that passes 0xFFFF keeps its count mod 2^16, and
// the thread credits the 2^16 to glob[bin], the global int32 counter; a
// low half's carry raised the high half by one (or, from 0xFFFF, wrapped
// it to 0), which glob[bin + 1] takes back. So a counter's half plus its
// global credits is its count after every add, and the flush adds the half.
// A half wraps once in 2^16 counts of its bin: the credits cost nothing on
// most keys. (This is the flush threshold T = 2^16, the half's own range:
// no half can ever hold more, so no scheduling of the warps can break it.)
__device__ __forceinline__ void add_packed(unsigned* cnt, unsigned* glob, unsigned bin, unsigned c) {
  const unsigned sh = (bin & 1u) << 4;
  const unsigned old = atomicAdd(cnt + (bin >> 1), c << sh);
  if (((old >> sh) & 0xffffu) + c > 0xffffu) {
    atomicAdd(glob + bin, 0x10000u);
    if (!sh) atomicAdd(glob + bin + 1, (old >> 16) == 0xffffu ? 0xffffu : 0xffffffffu);
  }
}

// The end of a block's 16-bit counters: each non-zero half into glob.
__device__ __forceinline__ void flush_packed(const unsigned* cnt, unsigned* glob, int words, int nthreads) {
  for (int i = threadIdx.x; i < words; i += nthreads) {
    const unsigned w = cnt[i];
    if (w & 0xffffu) atomicAdd(glob + 2 * i, w & 0xffffu);
    if (w >> 16) atomicAdd(glob + 2 * i + 1, w >> 16);
  }
}

// Whether a warp step looks hot: kHotLanes of the warp's lanes hold lane
// 0's bin (the same answer in every lane).
__device__ __forceinline__ bool warp_hot(unsigned bin) {
  return __popc(__ballot_sync(0xffffffffu, bin == __shfl_sync(0xffffffffu, bin, 0))) >= kHotLanes;
}

// Counts `bin` once for each lane of the warp with `on` through add(bin,
// c). In a hot step (kHot) every lane of the warp calls it together (bins
// lie below 2^20, so ~0u is no bin) and the lanes of each bin add as one;
// else each lane adds its own key. kHot is a template argument so that a
// cold step's adds carry no warp-wide instruction between them.
template <bool kHot, typename F>
__device__ __forceinline__ void warp_count(bool on, unsigned bin, int lane, F add) {
  if constexpr (kHot) {
    const unsigned peers = __match_any_sync(0xffffffffu, on ? bin : ~0u);
    if (on && lane == __ffs(peers) - 1) add(bin, (unsigned)__popc(peers));
  } else if (on) {
    add(bin, 1u);
  }
}

// Zeroes out[z0, z1) with the whole block: scalar stores up to a 16-byte
// boundary, 16-byte stores, scalar stores after.
template <typename W>
__device__ void zero_run(W* out, long long z0, long long z1, int nthreads) {
  constexpr int V = 16 / sizeof(W);
  if (z0 >= z1) return;
  const long long mis = (long long)(reinterpret_cast<uintptr_t>(out + z0) & 15) / (long long)sizeof(W);
  const long long a0 = min(z1, z0 + (mis ? V - mis : 0));
  const long long nv = (z1 - a0) / V;
  const long long a1 = a0 + nv * V;
  for (long long e = z0 + threadIdx.x; e < a0; e += nthreads) out[e] = 0;
  uint4* vo = reinterpret_cast<uint4*>(out + a0);
  for (long long i = threadIdx.x; i < nv; i += nthreads) vo[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long e = a1 + threadIdx.x; e < z1; e += nthreads) out[e] = 0;
}

// The parts besides the survivors, as the kernel's kParts template bits: a
// kernel compiles only the parts it names, so the streamed passes'
// histogram-only, certificate-only and collect-only launches carry no code
// of the others. kPartsChecked compiles all three and tests each at run
// time (the ordered route's launches with any of them).
constexpr int kPartHist = 1, kPartCert = 2, kPartSketch = 4, kPartsChecked = 8;

// Launch bounds: the ordered route's one block an SM may use 128
// registers a thread; an order-free block leaves room for 6 on an SM (42);
// the wide order-free block (kWide: 16-bit counters), one an SM, 64.
template <typename W, bool kOrdered, int kParts, bool kWide>
__global__ void __launch_bounds__(kOrdered ? kOrdThreads : (kWide ? kWideThreads : kThreads),
                                  kOrdered || kWide ? 1 : 6)
sweep_ingest_kernel(const __grid_constant__ Params<W> p) {
  constexpr int B = sizeof(W) * 8;
  constexpr bool kChecked = (kParts & kPartsChecked) != 0;
  constexpr bool kHist = kChecked || (kParts & kPartHist);
  constexpr bool kCert = kChecked || (kParts & kPartCert);
  constexpr bool kSketch = kChecked || (kParts & kPartSketch);
  constexpr int V = 16 / sizeof(W);  // words per 16-byte load
  constexpr int nthreads = kOrdered ? kOrdThreads : (kWide ? kWideThreads : kThreads);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_specs = p.nc + p.nt;
  const Layout lay = layout<W, kOrdered>(p.nd, p.tbits, p.copies, p.rb, p.hist_smem, n_specs,
                                         p.sketch_bits, p.deep_smem);
  W* sspec = reinterpret_cast<W*>(smem + lay.specs);  // masks, then wants
  unsigned short* table = reinterpret_cast<unsigned short*>(smem + lay.table);
  W* pref = reinterpret_cast<W*>(smem + lay.pref);
  unsigned* shist = reinterpret_cast<unsigned*>(smem + lay.hist);
  unsigned* sdeep = reinterpret_cast<unsigned*>(smem + lay.deep);

  // set-up: the specs, the prefix table and the counters in shared memory
  const int nd = p.nd;
  const int nb = 1 << p.rb;
  const bool exact = p.pbits <= kTableBits;  // then tbits == pbits
  const unsigned tmask = (1u << p.tbits) - 1;
  const W* psrc = nd > kParamPrefixes ? p.pref_dev : p.pref;
  if (kOrdered) {
    const W* ssrc_m = n_specs > kParamSpecs ? p.spec_dev : p.smask;
    const W* ssrc_w = n_specs > kParamSpecs ? p.spec_dev + n_specs : p.swant;
    for (int i = threadIdx.x; i < n_specs; i += nthreads) {
      sspec[i] = ssrc_m[i];
      sspec[n_specs + i] = ssrc_w[i];
    }
  }
  if (nd > 1) {
    for (int i = threadIdx.x; i <= (int)tmask; i += nthreads) table[i] = 0;
    for (int i = threadIdx.x; i < nd; i += nthreads) pref[i] = psrc[i];
  }
  const int hist_words = p.hist_smem ? p.copies * nd * (nb * p.hist_smem / 4) : 0;  // 32-bit words in shared memory
  const int deep_words = p.deep_smem ? (p.deep_smem << p.sketch_bits) / 4 : 0;
  const bool hist_packed = kWide && p.hist_smem == 2;  // one row, one copy (the launch checks)
  const bool deep_packed = kWide && p.deep_smem == 2;
  for (int i = threadIdx.x; i < hist_words; i += nthreads) shist[i] = 0u;
  for (int i = threadIdx.x; i < deep_words; i += nthreads) sdeep[i] = 0u;
  __syncthreads();
  if (nd > 1) {
    for (int d = threadIdx.x; d < nd; d += nthreads) {  // distinct prefixes: every claim succeeds
      for (unsigned h = table_home(pref[d], exact, p.tbits);; h = (h + 1) & tmask)
        if (atomicCAS(table + h, (unsigned short)0, (unsigned short)(d + 1)) == 0) break;
    }
    __syncthreads();
  }

  const bool fl = p.is_float != 0;
  const W key_xor = p.key_xor;
  const int shift = p.shift, rb = p.rb, tbits = p.tbits;
  const W dmask = (W)(nb - 1);
  const W lo = p.lo, hi = p.hi, vkey = p.vkey;
  const bool cert = p.cert != 0;
  const int sketch_bits = p.sketch_bits;
  const int dshift = B - (sketch_bits ? sketch_bits : 1);
  unsigned* hacc = p.hist_smem ? shist + (warp % p.copies) * nd * nb : p.hist;
  unsigned* dacc = p.deep_smem ? sdeep : p.deep;
  unsigned lt = 0, le = 0;
  unsigned d_all = 0, d_top = 0;  // an order-free 1-bit sketch, in registers: keys counted, keys with the top bit
  W kmin = ~(W)0, kmax = 0;

  // every part but the survivors, for one word of the bucket; pads
  // (present, not valid) arrive as key 0. The whole warp calls it together
  // (warp_count): lanes past the bucket come as not present. hot: an
  // Int<1> when the step looks hot (hot_of), else an Int<0>.
  auto count = [&](W key, bool present, bool valid, auto hot) {
    constexpr bool kHot = decltype(hot)::value != 0;
    if (kHist && (!kChecked || nd)) {
      if (hist_packed) {  // one prefix: a range test
        const W s = key >> shift;
        const W top = s >> rb;  // two shifts: shift + rb may equal the word width
        warp_count<kHot>(present && top >= lo && top <= hi, (unsigned)(s & dmask), lane,
                         [&](unsigned b, unsigned c) { add_packed(shist, p.hist, b, c); });
      } else if (present) {
        const W s = key >> shift;
        const W top = s >> rb;
        if (top >= lo && top <= hi) {
          int row = 0;
          bool hit = true;
          if (nd > 1) {
            hit = false;
            unsigned e;
            for (unsigned h = table_home(top, exact, tbits); (e = table[h]) != 0; h = (h + 1) & tmask) {
              if (exact || pref[e - 1] == top) {
                row = (int)e - 1;
                hit = true;
                break;
              }
            }
          }
          if (hit) atomicAdd(hacc + row * nb + (int)(s & dmask), 1u);
        }
      }
    }
    if (!kOrdered && kSketch && sketch_bits == 1) {  // the extremes' launch of sub-32-bit keys: one hot counter
      d_all += present;
      d_top += present && (key >> (B - 1));
    } else if (kSketch && (!kChecked || sketch_bits)) {
      const unsigned bin = (unsigned)(key >> dshift);
      if (deep_packed)
        warp_count<kHot>(present, bin, lane, [&](unsigned b, unsigned c) { add_packed(sdeep, p.deep, b, c); });
      else
        warp_count<kHot>(present, bin, lane, [&](unsigned b, unsigned c) { atomicAdd(dacc + b, c); });
    }
    if ((kCert || kSketch) && valid) {
      if (kCert && (!kChecked || cert)) {
        lt += key < vkey;
        le += key <= vkey;
      }
      if (kSketch && (!kChecked || sketch_bits)) {
        kmin = key < kmin ? key : kmin;
        kmax = key > kmax ? key : kmax;
      }
    }
  };

  // whether an order-free step whose first key is k looks hot, in the
  // histogram's 16-bit counters or the sketch's (a heuristic: any answer
  // counts exactly); the whole warp calls it together
  auto hot_of = [&](W k) -> bool {
    const bool h = hist_packed && warp_hot((unsigned)((k >> shift) & dmask));
    return h || (kSketch && sketch_bits > 1 && warp_hot((unsigned)(k >> dshift)));
  };

  const long long L = p.L, n_valid = p.n_valid;
  const bool vec = (reinterpret_cast<uintptr_t>(p.data) & 15) == 0;

  if constexpr (!kOrdered) {
    // A kernel that counts through warp_count runs each loop the same
    // number of times in every lane of a warp (the warp's last lane, or
    // its first, decides), so the warp counts together; the others keep
    // each lane's own bounds.
    constexpr bool kWarpCount = kSketch || kWide;
    const int up = kWarpCount ? 31 - lane : 0, down = kWarpCount ? lane : 0;
    const long long stride = (long long)gridDim.x * nthreads;
    const long long tid = (long long)blockIdx.x * nthreads + threadIdx.x;
    const long long nvec = vec ? L / V : 0;
    const long long nfull = vec ? min(n_valid, L) / V : 0;  // vectors of valid keys only
    const uint4* vdata = reinterpret_cast<const uint4*>(p.data);
    long long i = tid;
    for (; i + up + (kUnroll - 1) * stride < nfull; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(vdata + i + u * stride);
      W w0[V];
      unpack(v[0], w0);
      auto step = [&](auto hot) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          W w[V];
          unpack(v[u], w);
#pragma unroll
          for (int j = 0; j < V; ++j) count(to_key(w[j], fl, key_xor), true, true, hot);
        }
      };
      if (hot_of(to_key(w0[0], fl, key_xor)))
        step(Int<1>{});
      else
        step(Int<0>{});
    }
    for (; i - down < nvec; i += stride) {  // the last valid vectors and the pads
      const bool in = i < nvec;
      W w[V];
      unpack(in ? __ldg(vdata + i) : make_uint4(0u, 0u, 0u, 0u), w);
      const bool hot = hot_of(in && i * V < n_valid ? to_key(w[0], fl, key_xor) : (W)0);
      for (int j = 0; j < V; ++j) {
        const bool valid = in && i * V + j < n_valid;
        const W key = valid ? to_key(w[j], fl, key_xor) : (W)0;
        if (hot)
          count(key, in, valid, Int<1>{});
        else
          count(key, in, valid, Int<0>{});
      }
    }
    for (long long e = nvec * V + tid; e - down < L; e += stride) {  // a tail, or a base not 16-byte aligned
      const bool valid = e < n_valid;
      const W key = valid ? to_key(p.data[e], fl, key_xor) : (W)0;
      if (hot_of(key))
        count(key, e < L, valid, Int<1>{});
      else
        count(key, e < L, valid, Int<0>{});
    }
  } else {
    constexpr long long kTile = kTileBytes / sizeof(W);  // words per tile
    constexpr int kRowWords = kRowBytes / sizeof(W);
    // The work comes as items: a group of up to kGroup buffers of one tile,
    // the tee buffer last in the last group. A step counts the
    // current item and publishes its aggregate, while the previous item's
    // warps look back (its predecessors had a whole step to publish), then
    // writes the previous item's survivors and zeros.
    struct Item {
      long long t;  // the tile (n_tiles or more: none)
      int gb, gn;   // the group's first buffer and its buffers
      int st;       // the tile's stage
      int tee;      // the group's buffer that is the tee union, or -1
    };
    __shared__ long long s_ticket[kStages];               // the tile in each stage
    __shared__ unsigned long long s_wsum[2][kOrdWarps];   // per item parity: a warp's counts, then its prefix
    __shared__ unsigned long long s_agg[2];               // per item parity: the item's counts
    __shared__ long long s_excl[kGroup];                  // the previous item's output offsets
    const int n_surv = p.nc + (p.nt ? 1 : 0);
    const long long n_tiles = p.n_tiles;
    W* staging = reinterpret_cast<W*>(smem + lay.staging) + warp * kRowWords;
    const unsigned lt_mask = (1u << lane) - 1u;
    const unsigned stage0 = smem_u32(smem + lay.stage);
    auto group = [&](long long t, int gb, int st) -> Item {
      const int gn = min(kGroup, n_surv - gb);
      return Item{t, gb, gn, st, p.nt && gb + gn - 1 == p.nc ? gn - 1 : -1};
    };

    // cp.async of tile t into stage st: 16-byte copies (zero-filled past
    // L), or word copies when the base is not 16-byte aligned
    auto issue = [&](long long t, int st) {
      const unsigned dst = stage0 + st * kTileBytes;
      const long long base = t * kTile;
      if (vec) {
        for (int i = threadIdx.x; i < kTile / V; i += nthreads) {
          const long long left = L - (base + (long long)i * V);
          const int bytes = left >= V ? 16 : (left <= 0 ? 0 : (int)left * (int)sizeof(W));
          cp_async16(dst + 16 * i, p.data + (bytes ? base + (long long)i * V : 0), bytes);
        }
      } else {
        for (int i = threadIdx.x; i < kTile; i += nthreads) {
          const bool in = base + i < L;
          cp_async_word<sizeof(W)>(dst + sizeof(W) * i, p.data + (in ? base + i : 0), in ? (int)sizeof(W) : 0);
        }
      }
    };
    // one row of a tile: lane's V keys (pads as key 0) and a mask of the
    // valid ones
    auto load_row = [&](const Item& it, int row, W* k) -> unsigned {
      const W* tile = reinterpret_cast<const W*>(smem + lay.stage + (long long)it.st * kTileBytes);
      unpack(*reinterpret_cast<const uint4*>(tile + (row * 32 + lane) * V), k);
      const long long rem = n_valid - (it.t * kTile + (long long)(row * 32 + lane) * V);
      const unsigned vm = rem >= V ? (1u << V) - 1u : (rem <= 0 ? 0u : (1u << rem) - 1u);
#pragma unroll
      for (int j = 0; j < V; ++j) k[j] = (vm >> j) & 1u ? to_key(k[j], fl, key_xor) : (W)0;
      return vm;
    };
    // the V-bit mask of lane's valid keys that buffer gb + q takes
    auto match = [&](const W* k, unsigned vm, int tee, const W* gmask, const W* gwant, auto q) -> unsigned {
      unsigned bits = 0;
      if (q.value == tee) {
        for (int u = p.nc; u < n_specs; ++u) {
          const W m = sspec[u], w = sspec[n_specs + u];
#pragma unroll
          for (int j = 0; j < V; ++j) bits |= (unsigned)((k[j] & m) == w) << j;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) bits |= (unsigned)((k[j] & gmask[q.value]) == gwant[q.value]) << j;
      }
      return bits & vm;
    };
    auto specs_of = [&](const Item& it, W* gmask, W* gwant) {  // a missing spec never matches
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const bool on = q < it.gn && q != it.tee;
        gmask[q] = on ? sspec[it.gb + q] : (W)0;
        gwant[q] = on ? sspec[n_specs + it.gb + q] : (W)1;
      }
    };

    if (threadIdx.x == 0) s_ticket[0] = atomicAdd(p.ticket, 1u);
    __syncthreads();
    Item cur = group(s_ticket[0], 0, 0), prev{};
    bool have_prev = false;
    if (cur.t < n_tiles) issue(cur.t, 0);
    cp_async_commit();
    W pmask[kGroup], pwant[kGroup];  // the previous item's specs
    unsigned long long prows = 0;     // the previous item's rows with a survivor, this warp's
    for (int par = 0;; par ^= 1) {
      const bool have_cur = cur.t < n_tiles;
      if (!have_cur && !have_prev) break;
      if (have_cur && cur.gb == 0) cp_async_wait<0>();  // this thread's copies of the tile have landed
      __syncthreads();                                  // and every thread's

      // the previous item's look-back, one warp per buffer
      if (have_prev && warp < prev.gn) {
        unsigned long long* st_words = p.status + (long long)(prev.gb + warp) * n_tiles;
        const long long agg = (long long)((s_agg[par ^ 1] >> (16 * warp)) & 0xffffull);
        const long long excl = prev.t == 0 ? 0 : warp_lookback(st_words, prev.t, lane);
        if (lane == 0) {
          if (prev.t) atomicExch(st_words + prev.t, kFlagIncl | (unsigned long long)(excl + agg));
          s_excl[warp] = excl;
          if (prev.t == n_tiles - 1) p.counts[prev.gb + warp] = (unsigned)(excl + agg);
        }
      }
      // the current item's count: per lane and buffer the survivors, per
      // buffer the rows of this warp that hold one
      W cmask[kGroup], cwant[kGroup];
      unsigned long long crows = 0;  // bit q * kRows + r
      if (have_cur) {
        specs_of(cur, cmask, cwant);
        // the next tile's ticket, taken by a warp that does no look-back
        // and stored after the rows, so its latency hides
        const bool ticket_lane = cur.gb == 0 && threadIdx.x == nthreads - 32;
        const unsigned next_ticket = ticket_lane ? atomicAdd(p.ticket, 1u) : 0u;
        unsigned c[kGroup] = {};
#pragma unroll 2
        for (int r = 0; r < kRows; ++r) {
          const int row = warp * kRows + r;
          W k[V];
          const unsigned vm = load_row(cur, row, k);
          if (cur.gb == 0) {
            const long long pos0 = cur.t * kTile + (long long)(row * 32 + lane) * V;
#pragma unroll
            for (int j = 0; j < V; ++j) count(k[j], pos0 + j < L, (vm >> j) & 1u, Int<0>{});
          }
          unsigned bits[kGroup];
          bits[0] = match(k, vm, cur.tee, cmask, cwant, Int<0>{});
          bits[1] = cur.gn > 1 ? match(k, vm, cur.tee, cmask, cwant, Int<1>{}) : 0u;
          bits[2] = cur.gn > 2 ? match(k, vm, cur.tee, cmask, cwant, Int<2>{}) : 0u;
          bits[3] = cur.gn > 3 ? match(k, vm, cur.tee, cmask, cwant, Int<3>{}) : 0u;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            c[q] += __popc(bits[q]);
            if (bits[q]) crows |= 1ull << (q * kRows + r);
          }
        }
        if (ticket_lane) s_ticket[(cur.st + 1) % kStages] = next_ticket;
        unsigned long long cnt = 0;  // 16-bit fields
#pragma unroll
        for (int q = 0; q < kGroup; ++q) cnt |= (unsigned long long)c[q] << (16 * q);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
          crows |= __shfl_xor_sync(0xffffffffu, crows, d);
        }
        if (lane == 0) s_wsum[par][warp] = cnt;
      }
      __syncthreads();
      if (have_cur && warp == 0) {  // exclusive scan of the warps' packed counts
        const unsigned long long x = lane < kOrdWarps ? s_wsum[par][lane] : 0ull;
        unsigned long long incl = x;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        if (lane < kOrdWarps) s_wsum[par][lane] = incl - x;
        if (lane == kOrdWarps - 1) s_agg[par] = incl;
      }
      __syncthreads();
      if (have_cur) {
        if (warp < cur.gn && lane == 0) {  // the aggregate, or tile 0's inclusive prefix
          const unsigned long long agg = (s_agg[par] >> (16 * warp)) & 0xffffull;
          atomicExch(p.status + (long long)(cur.gb + warp) * n_tiles + cur.t, (cur.t ? kFlagAgg : kFlagIncl) | agg);
        }
        if (cur.gb == 0) {  // the next tile's loads, into the stage of the tile two back
          const int nst = (cur.st + 1) % kStages;
          if (s_ticket[nst] < n_tiles) issue(s_ticket[nst], nst);
          cp_async_commit();
        }
      }

      // the previous item's writes: each row's survivors, compacted in the
      // warp's staging row, as one coalesced run; then the tile's share of
      // the zeros, counted from the end of the buffer
      if (have_prev) {
        const unsigned long long wexcl = s_wsum[par ^ 1][warp];
        const long long tile0 = prev.t * kTile;
        const long long tile_len = min(kTile, L - tile0);
        auto write = [&](auto q) {
          if (q.value >= prev.gn) return;
          W* out = p.surv + (long long)(prev.gb + q.value) * L;
          long long pos = s_excl[q.value] + (long long)((wexcl >> (16 * q.value)) & 0xffffull);
          for (unsigned long long rows = (prows >> (q.value * kRows)) & ((1ull << kRows) - 1ull); rows;
               rows &= rows - 1) {
            const int row = warp * kRows + __ffsll((long long)rows) - 1;
            W k[V];
            const unsigned bits = match(k, load_row(prev, row, k), prev.tee, pmask, pwant, q);
            unsigned below = 0, total = 0;
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const unsigned m = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
              below += __popc(m & lt_mask);
              total += __popc(m);
            }
#pragma unroll
            for (int j = 0; j < V; ++j)
              if ((bits >> j) & 1u) staging[below++] = k[j];
            __syncwarp();
            for (unsigned m = lane; m < total; m += 32) out[pos + m] = staging[m];
            __syncwarp();
            pos += total;
          }
          const long long agg = (long long)((s_agg[par ^ 1] >> (16 * q.value)) & 0xffffull);
          const long long z1 = L - (tile0 - s_excl[q.value]);  // past the zeros of earlier tiles
          zero_run(out, z1 - (tile_len - agg), z1, nthreads);
        };
        write(Int<0>{});
        write(Int<1>{});
        write(Int<2>{});
        write(Int<3>{});
      }
      __syncthreads();  // s_excl and the previous item's stage are free

      prev = cur;
      have_prev = have_cur;
      prows = crows;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        pmask[q] = cmask[q];
        pwant[q] = cwant[q];
      }
      if (have_cur) {
        const int nst = (cur.st + 1) % kStages;
        cur = cur.gb + cur.gn < n_surv ? group(cur.t, cur.gb + cur.gn, cur.st) : group(s_ticket[nst], 0, nst);
      }
    }
  }

  // flush: the sub-histograms, the sketch counters, the certificate and the
  // extremes, into global memory
  __syncthreads();
  if (hist_packed) {
    flush_packed(shist, p.hist, hist_words, nthreads);
  } else {
    for (int i = threadIdx.x; i < nd * nb && p.hist_smem; i += nthreads) {
      unsigned s = 0;
      for (int c = 0; c < p.copies; ++c) s += shist[c * nd * nb + i];
      if (s) atomicAdd(p.hist + i, s);
    }
  }
  if (deep_packed) {
    flush_packed(sdeep, p.deep, deep_words, nthreads);
  } else {
    for (int i = threadIdx.x; i < deep_words; i += nthreads)
      if (sdeep[i]) atomicAdd(p.deep + i, sdeep[i]);
  }
  using A = typename Atom<W>::type;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lt += __shfl_down_sync(0xffffffffu, lt, d);
    le += __shfl_down_sync(0xffffffffu, le, d);
    if (!kOrdered) {
      d_all += __shfl_down_sync(0xffffffffu, d_all, d);
      d_top += __shfl_down_sync(0xffffffffu, d_top, d);
    }
    const W a = __shfl_down_sync(0xffffffffu, kmin, d);
    const W b = __shfl_down_sync(0xffffffffu, kmax, d);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
  }
  if (lane == 0) {
    if (cert) {
      if (lt) atomicAdd(p.cert_out, lt);
      if (le) atomicAdd(p.cert_out + 1, le);
    }
    if (!kOrdered && sketch_bits == 1) {
      if (d_all - d_top) atomicAdd(p.deep, d_all - d_top);
      if (d_top) atomicAdd(p.deep + 1, d_top);
    }
    if (sketch_bits) {
      atomicMax(reinterpret_cast<A*>(p.ext), (A)~kmin);  // zero is the identity of ~min
      atomicMax(reinterpret_cast<A*>(p.ext) + 1, (A)kmax);
    }
  }
  if (sketch_bits) {  // the last block to finish turns ~min into min
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(p.done, 1u) == gridDim.x - 1) {
      __threadfence();
      A* e = reinterpret_cast<A*>(p.ext);
      atomicExch(e, ~atomicOr(e, (A)0));
    }
  }
}

// The blocks of a kernel an SM holds at a dynamic shared memory size, after
// raising the kernel's limit to that size: both asked of the runtime once
// per device, kernel and size, then kept.
struct Resident {
  int dev;
  const void* kernel;
  int smem, per_sm;
};
std::mutex g_resident_mu;
Resident g_resident[64];
int g_n_resident = 0;
Resident g_limit[64];  // per_sm unused: the largest limit set per kernel
int g_n_limit = 0;

template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_resident_mu);
  for (int i = 0; i < g_n_resident; ++i) {
    const Resident& r = g_resident[i];
    if (r.dev == dev && r.kernel == key && r.smem == smem) {
      *per_sm = r.per_sm;
      return cudaSuccess;
    }
  }
  int i = 0;
  while (i < g_n_limit && !(g_limit[i].dev == dev && g_limit[i].kernel == key)) ++i;
  if (i == g_n_limit || g_limit[i].smem < smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (i < g_n_limit) g_limit[i].smem = smem;
    else if (g_n_limit < 64) g_limit[g_n_limit++] = {dev, key, smem, 0};
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e == cudaSuccess && g_n_resident < 64) g_resident[g_n_resident++] = {dev, key, smem, *per_sm};
  return e;
}

template <typename W>
int launch(const W* data, long long L, long long n_valid, int is_float, W key_xor,
           int nd, const W* pref_host, const W* pref_dev, int shift, int rb, int pbits,
           int tbits, int copies, int hist_smem, int nc, int nt, const W* spec_host,
           const W* spec_dev, int cert, W vkey, int sketch_bits, int deep_smem,
           unsigned* hist, unsigned* counts, unsigned* cert_out, unsigned* deep, W* ext,
           unsigned* done, unsigned* ticket, unsigned long long* status, W* surv,
           void* arena, long long arena_bytes, int blocks, int sms, cudaStream_t stream) {
  // a prefix table at most half full (the build and the lookup end);
  // counters of 4 or 2 bytes in shared memory, or none; 16-bit counters
  // only in the wide order-free block, and of a histogram of one row and copy
  const bool ordered = nc + nt > 0;
  const bool wide = hist_smem == 2 || deep_smem == 2;
  if (nd < 0 || nd > 1 << (kTableBits - 1) || tbits > kTableBits || nc < 0 || nt < 0 || copies < 1 ||
      blocks < 1 || (hist_smem != 0 && hist_smem != 2 && hist_smem != 4) ||
      (deep_smem != 0 && deep_smem != 2 && deep_smem != 4) || (wide && ordered) ||
      (hist_smem == 2 && (nd != 1 || copies != 1)))
    return (int)cudaErrorInvalidValue;
  Params<W> p{};
  p.data = data;
  p.L = L;
  p.n_valid = n_valid;
  p.key_xor = key_xor;
  p.is_float = is_float;
  p.nd = nd;
  p.shift = shift;
  p.rb = rb;
  p.pbits = pbits;
  p.tbits = tbits;
  p.copies = copies;
  p.hist_smem = hist_smem;
  p.lo = ~(W)0;
  p.hi = 0;
  for (int i = 0; i < nd; ++i) {
    p.lo = pref_host[i] < p.lo ? pref_host[i] : p.lo;
    p.hi = pref_host[i] > p.hi ? pref_host[i] : p.hi;
    if (i < kParamPrefixes) p.pref[i] = pref_host[i];
  }
  p.pref_dev = pref_dev;
  if (nd > kParamPrefixes && !pref_dev) return (int)cudaErrorInvalidValue;
  const int n_specs = nc + nt;
  p.nc = nc;
  p.nt = nt;
  for (int i = 0; i < n_specs && i < kParamSpecs; ++i) {
    p.smask[i] = spec_host[i];
    p.swant[i] = spec_host[n_specs + i];
  }
  p.spec_dev = spec_dev;
  if (n_specs > kParamSpecs && !spec_dev) return (int)cudaErrorInvalidValue;
  p.cert = cert;
  p.vkey = vkey;
  p.sketch_bits = sketch_bits;
  p.deep_smem = deep_smem;
  p.hist = hist;
  p.counts = counts;
  p.cert_out = cert_out;
  p.deep = deep;
  p.ext = ext;
  p.done = done;
  p.ticket = ticket;
  p.status = status;
  p.surv = surv;
  constexpr long long kTile = kTileBytes / sizeof(W);
  p.n_tiles = ordered ? (L + kTile - 1) / kTile : 0;

  auto go = [&](auto kernel, int threads, const Layout& lay) -> int {
    const int smem = (int)lay.total;
    // every block resident at once: the ordered route's look-back needs
    // it, and a partial second wave would leave most of the card idle
    int per_sm = 0;
    cudaError_t e = resident_blocks(kernel, threads, smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (arena_bytes && (e = cudaMemsetAsync(arena, 0, arena_bytes, stream)) != cudaSuccess) return (int)e;
    const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
    kernel<<<grid, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  };
  // the kernel of exactly the parts asked for; the ordered route has one
  // without other parts (the streamed collect) and one that checks them
  const int parts = (nd ? kPartHist : 0) | (cert ? kPartCert : 0) | (sketch_bits ? kPartSketch : 0);
  if (ordered)
    return go(parts ? sweep_ingest_kernel<W, true, kPartsChecked, false> : sweep_ingest_kernel<W, true, 0, false>,
              kOrdThreads,
              layout<W, true>(nd, tbits, copies, rb, hist_smem, n_specs, sketch_bits, deep_smem));
  using Kernel = void (*)(Params<W>);
  const Kernel order_free[2][8] = {
      {sweep_ingest_kernel<W, false, 0, false>, sweep_ingest_kernel<W, false, 1, false>,
       sweep_ingest_kernel<W, false, 2, false>, sweep_ingest_kernel<W, false, 3, false>,
       sweep_ingest_kernel<W, false, 4, false>, sweep_ingest_kernel<W, false, 5, false>,
       sweep_ingest_kernel<W, false, 6, false>, sweep_ingest_kernel<W, false, 7, false>},
      // the wide block serves launches with 16-bit counters: a histogram or a sketch
      {nullptr, sweep_ingest_kernel<W, false, 1, true>,
       nullptr, sweep_ingest_kernel<W, false, 3, true>,
       sweep_ingest_kernel<W, false, 4, true>, sweep_ingest_kernel<W, false, 5, true>,
       sweep_ingest_kernel<W, false, 6, true>, sweep_ingest_kernel<W, false, 7, true>},
  };
  const Kernel k = order_free[wide][parts];
  if (!k) return (int)cudaErrorInvalidValue;  // 16-bit counters of a part the launch does not have
  return go(k, wide ? kWideThreads : kThreads,
            layout<W, false>(nd, tbits, copies, rb, hist_smem, n_specs, sketch_bits, deep_smem));
}

}  // namespace

#define KSEL_SWEEP_ENTRY(BITS, W)                                                          \
  extern "C" int ksel_sweep_ingest##BITS(                                                  \
      const void* data, long long L, long long n_valid, int is_float, W key_xor, int nd,   \
      const void* pref_host, const void* pref_dev, int shift, int rb, int pbits, int tbits, \
      int copies, int hist_smem, int nc, int nt, const void* spec_host,                    \
      const void* spec_dev, int cert, W vkey, int sketch_bits, int deep_smem, void* hist,  \
      void* counts, void* cert_out, void* deep, void* ext, void* done, void* ticket,       \
      void* status, void* surv, void* arena, long long arena_bytes, int blocks, int sms,   \
      void* stream) {                                                                      \
    return launch<W>(static_cast<const W*>(data), L, n_valid, is_float, key_xor, nd,       \
                     static_cast<const W*>(pref_host), static_cast<const W*>(pref_dev),    \
                     shift, rb, pbits, tbits, copies, hist_smem, nc, nt,                   \
                     static_cast<const W*>(spec_host), static_cast<const W*>(spec_dev),    \
                     cert, vkey, sketch_bits, deep_smem, static_cast<unsigned*>(hist),     \
                     static_cast<unsigned*>(counts), static_cast<unsigned*>(cert_out),     \
                     static_cast<unsigned*>(deep), static_cast<W*>(ext),                   \
                     static_cast<unsigned*>(done), static_cast<unsigned*>(ticket),         \
                     static_cast<unsigned long long*>(status), static_cast<W*>(surv),      \
                     arena, arena_bytes, blocks, sms, static_cast<cudaStream_t>(stream));  \
  }

KSEL_SWEEP_ENTRY(32, uint32_t)
KSEL_SWEEP_ENTRY(64, uint64_t)

extern "C" const char* ksel_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
