// K5: the anchored position-domain Count — every slice of a Count on a node
// in one launch, each leaf read through its own container format.
//
// Replaces _build_anchored / compiled_anchored_count / anchored_count_exec
// (pilosa_tpu/exec/plan.py:855-934) with the membership kernels
// membership_dense / membership_sparse / membership_rle
// (pilosa_tpu/ops/bitplane.py:429-453).  The JAX package compiled and
// launched one program per per-leaf format signature, with every axis
// padded to a pow2 bucket with 0xFFFFFFFF sentinels, over anchor positions
// the host copied out of the anchor's row; here formats are run-time
// values, lengths are real, and the anchor is one of the slice's leaves,
// read on the card like the others.
//
// For slice s, with anchor A_s (a leaf whose row is a superset of the
// tree's result, chosen by the executor):
//
//   out[s] = #{ p in A_s : tree(member(leaf_0, p), ..., member(leaf_L-1, p)) }
//
// Inputs.  `meta` is one int64 buffer on the device:
//   [0, S)              anchor[s]: the index of slice s's anchor leaf, or -1
//                       (the slice counts 0)
//   [S, S + 3 S L)      leaf table: for slice s, leaf i, (format, address,
//                       length) — format 0 dense words (a row of a
//                       fragment's mirror, read in place, or a dense
//                       payload), 1 sorted positions, 2 sorted half-open
//                       runs (start, end); length in entries, 0 for an
//                       absent row (never a member)
//   [S + 3 S L, +n_prog) the tree as a postfix program: i >= 0 pushes
//                       member(leaf i, p); -1 and, -2 or, -3 and-not, -4 xor
//                       pop two and push one; -5 pushes 0 (an empty Union)
// `out` is int32 [S], zeroed by the wrapper.  The wrapper checks that the
// program is well formed, at most 64 deep, and passes its depth.
//
// Bound: memory.  Each leaf's bytes in the windows where the anchor has a
// bit are read once (a leaf that is also the anchor once in all), plus the
// table; at phase 4's shape (954 slices, a dense anchor that is also a leaf,
// a 16,384-position and an 8,192-run leaf) 250 MB, 0.075 ms at 3.35 TB/s.
// In practice the SMs bound it: a window is a few KB behind a chain of
// dependent loads (the table, the searches, the chunks) and a few dozen
// steps of shared-memory work, so the design keeps the chain short, the
// shared-memory accesses free of bank conflicts and 11 blocks resident.
//
// Design: one block of 128 threads per (slice, window of W words: W * 32
// positions); W = 1024 unless the program's stack does not fit in shared
// memory, then 512 (the wrapper picks it from the depth).  Shared memory
// holds the slice's leaf table and the program, the anchor's window as a
// bitmap, a ring of three staging buffers of half a window, and the
// program's stack as `depth` window bitmaps.  Thread t owns words 4 * (g *
// 128 + t) .. + 3 of every bitmap (g < W / 512), so a warp reads or writes
// its words as 512 contiguous bytes of 16-byte vectors, free of bank
// conflicts (with 8 contiguous words a thread, every access was an 8-way
// conflict, and the kernel took twice as long).
//   1. The anchor's index, the slice's table row and the program come in
//      with one round of loads.  For a positions or runs anchor one warp
//      finds its entry range [lo, hi) in the window and the block exits at
//      once if it is empty, so the bytes read follow where the anchor lies.
//   2. Every compressed leaf's entry range in the window: two warp searches
//      a leaf, spread over the block's 4 warps, while a dense anchor's copy
//      is in flight.  A search first reads, coalesced, the 256 keys around
//      where evenly spread keys would put the bound (one round for evenly
//      spread rows); otherwise it probes 128 entries a round, 4 a lane,
//      keeping one of 129 parts by ballots.  Probes bypass the L1.
//   3. The entries are read once, coalesced: thread 0 copies each range
//      (or a dense leaf's W words) in chunks of at most 2 W bytes with
//      Hopper's 1-D bulk copy (cp.async.bulk, global -> shared) into the
//      ring, each buffer completing on its own mbarrier.  A copy starts at
//      the chunk's address rounded down to 16 bytes (its length rounded
//      up), and the readers skip the head.  Thread 0 keeps the ring full
//      as soon as the ranges are known, so the leaves of a window are in
//      flight together; the block barrier after each chunk frees its
//      buffer.
//   4. Each chunk is expanded into the stack's top bitmap: positions by
//      atomicOr into shared words; runs one a thread, partial words by
//      atomicOr, whole words stored (a run over more than 32 whole words is
//      left to the whole block); dense words copied.  A leaf that is the
//      anchor copies the anchor's bitmap.
//   5. Each op of the program combines the two top bitmaps a word at a
//      time, 32 positions per bitwise op, each thread on its own words, so
//      no barrier is needed between ops.
//   6. popcount(result & anchor) over the thread's words, a block
//      reduction, and one integer atomicAdd into out[s] per block:
//      integer addition is order-free, so the result is deterministic.
// A wait that outlasts about four seconds traps, so a fault ends the
// launch with an error instead of hanging the card.  The kernel allocates
// nothing and launches on the caller's stream; the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
// Blocks resident on an SM: the register cap (40 a thread) that lets 11
// fit, as the shared memory of a 1,024-word window does.
constexpr int kMinBlocks = 11;
constexpr int kSliceWords = 32768;
constexpr int kDense = 0, kPositions = 1, kRuns = 2;
constexpr int kMaxSmem = 232448;

// Shared memory: the barriers, the block's reduction, the anchor's range
// and the long runs of a chunk (at most 32: each covers 1,024 positions);
// the slice's leaf table, each leaf's range and the program; the
// anchor bitmap; the staging ring; the stack.
// ops/anchored_count.py:smem_bytes computes the same.
__host__ __device__ constexpr long long align16(long long x) { return (x + 15) & ~15LL; }
__host__ __device__ constexpr long long stage_bytes(int w) { return 2LL * w + 16; }
__host__ __device__ constexpr long long smem_bytes(int w, int n_leaves, int n_prog, int depth) {
  return 320 + align16(24LL * n_leaves) + align16(8LL * n_leaves) + align16(4LL * n_prog) +
         4LL * w + kStages * stage_bytes(w) + 4LL * w * depth;
}

// A thread's words of a window bitmap: G groups of 4, group g at word
// 4 * (g * kThreads + t), so a warp's access to a group is 512 contiguous
// bytes — 16-byte vectors, free of bank conflicts.
template <int W>
struct Own {
  static constexpr int G = W / (4 * kThreads);
  __device__ static __forceinline__ uint32_t word(int g) { return 4u * (g * kThreads + threadIdx.x); }
  __device__ static __forceinline__ uint4& at(uint32_t* bitmap, int g) {
    return *reinterpret_cast<uint4*>(bitmap + word(g));
  }
};

struct Leaf {
  int fmt;
  const uint32_t* src;
  uint32_t n;  // entries; 0 for an absent row
};

__device__ __forceinline__ Leaf leaf_at(const long long* table, long long i) {
  const long long* e = table + 3 * i;
  return {(int)e[0], reinterpret_cast<const uint32_t*>(e[1]), (uint32_t)e[2]};
}

__device__ __forceinline__ uint32_t entry_words(int fmt) { return fmt == kRuns ? 2u : 1u; }

// First index i in [lo, hi] with key(i) >= x, key(i) = src[stride * i +
// off] ascending, given that the answer lies in [lo, hi], found by one
// whole warp: each round its 32 lanes probe 128 points, 4 a lane, that cut
// the range into 129 parts, and the ballots keep the part holding the
// answer (two rounds for 16,384 entries).  Every lane returns the answer.
// Probes are read through L2 only, so they do not evict the L1.
__device__ __forceinline__ uint32_t warp_search(const uint32_t* __restrict__ src, uint32_t lo,
                                                uint32_t hi, int stride, int off, uint32_t x) {
  const uint32_t lane = threadIdx.x & 31u;
  while (lo < hi) {
    const uint32_t len = hi - lo;
    uint32_t below[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t idx = lo + (4u * lane + j + 1u) * len / 129u;  // < hi
      below[j] = __ldcg(src + stride * idx + off) < x;
    }
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) c += __popc(__ballot_sync(0xffffffffu, below[j]));
    const uint32_t nlo = c == 0 ? lo : lo + c * len / 129u + 1u;
    hi = c == 128 ? hi : lo + (c + 1u) * len / 129u;
    lo = nlo;
  }
  return lo;
}

// First index i in [0, n) with key(i) >= x (n if none), keys in [0,
// 2^20].  The warp first reads, coalesced, the 256 keys around where
// evenly spread keys would put x; where the answer lies among them that is
// all (evenly spread rows: one round), else warp_search takes the side
// that holds it.
__device__ __forceinline__ uint32_t warp_lower_bound(const uint32_t* __restrict__ src, uint32_t n,
                                                     int stride, int off, uint32_t x) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t m = min(n, 256u);
  const uint32_t guess = (uint32_t)(((unsigned long long)n * x) >> 20);
  const uint32_t g0 = min(guess > 128u ? guess - 128u : 0u, n - m);
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t i = 32u * j + lane;
    c += __popc(__ballot_sync(0xffffffffu, i < m && __ldcg(src + stride * (g0 + i) + off) < x));
  }
  if (c == 0 && g0 > 0) return warp_search(src, 0, g0, stride, off, x);
  if (c == m && g0 + m < n) return warp_search(src, g0 + m, n, stride, off, x);
  return g0 + c;
}

// One end of a compressed leaf's entry range in the window [p0, p1): side
// 0 the first entry that reaches p0, side 1 the first that starts at or
// past p1.  Called by a whole warp.
__device__ __forceinline__ uint32_t window_bound(const Leaf& l, int side, uint32_t p0,
                                                 uint32_t p1) {
  if (l.fmt == kPositions) return warp_lower_bound(l.src, l.n, 1, 0, side ? p1 : p0);
  // Runs: the first whose end > p0 (end >= p0 + 1), the first whose start >= p1.
  return side ? warp_lower_bound(l.src, l.n, 2, 0, p1) : warp_lower_bound(l.src, l.n, 2, 1, p0 + 1u);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t"
        "}"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// Copy `bytes` (a multiple of 16) from 16-byte aligned global `src` to
// shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// What the block reads for source k: k = -1 the anchor, k >= 0 op k of
// the program.  An empty range [lo, lo) reads nothing: an op, a leaf that
// is the anchor (its bitmap is copied), an absent row, a window the leaf
// has no entry in.
struct Src {
  int fmt;
  const uint32_t* src;
  uint32_t lo, hi;  // entries (words for a dense leaf)
};

struct Block {
  const long long* table;  // the slice's row, in shared memory
  const int* program;      // in shared memory
  int n_prog;
  long long anchor;
  Leaf a;
  uint32_t alo, ahi;
  const uint2* ranges;
  uint32_t w0;  // the window's first word
  uint32_t p0;  // its first position
  unsigned char* stage;
  uint64_t* bar;
  uint2* spans;  // a chunk's runs over more than 32 whole words
  int* n_spans;
};

template <int W>
__device__ __forceinline__ Src source_of(const Block& b, int k) {
  if (k < 0) return {b.a.fmt, b.a.src, b.alo, b.ahi};
  const int op = b.program[k];
  if (op < 0 || op == b.anchor) return {kDense, nullptr, 0, 0};
  const Leaf l = leaf_at(b.table, op);
  if (l.n == 0) return {l.fmt, l.src, 0, 0};
  if (l.fmt == kDense) return {kDense, l.src, b.w0, b.w0 + W};
  const uint2 r = b.ranges[op];
  return {l.fmt, l.src, r.x, r.y};
}

// The chunk of source `src` that starts at entry e: at most half a
// window's bytes, its first byte rounded down to 16, its length rounded
// up, and the words to skip.
struct Chunk {
  const unsigned char* from;
  unsigned bytes;
  uint32_t n;     // entries
  uint32_t head;  // words
};

template <int W>
__device__ __forceinline__ Chunk chunk_at(const Src& src, uint32_t e) {
  const uint32_t ew = entry_words(src.fmt);
  const uint32_t n = min((W / 2u) >> (ew - 1u), src.hi - e);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src.src + (size_t)e * ew);
  const uintptr_t from = at & ~(uintptr_t)15;
  const unsigned head = (unsigned)(at - from);
  return {reinterpret_cast<const unsigned char*>(from), (head + 4u * ew * n + 15u) & ~15u, n,
          head / 4u};
}

// Thread 0's cursor over every chunk the block reads, in order: chunk i
// goes into staging buffer i % kStages.
struct Producer {
  int k = -1;
  uint32_t e = 0;
  bool in = false;
  uint32_t issued = 0;
};

// Issue chunks while a buffer is free (fewer than kStages ahead of the
// `consumed` chunks) and `k_end` is not reached.
template <int W>
__device__ void fill(Producer& p, const Block& b, uint32_t consumed, int k_end) {
  while (p.k < k_end && p.issued < consumed + kStages) {
    const Src src = source_of<W>(b, p.k);
    if (!p.in) {
      p.e = src.lo;
      p.in = true;
    }
    if (p.e < src.hi) {
      const Chunk c = chunk_at<W>(src, p.e);
      const int buf = p.issued % kStages;
      bulk_load(b.stage + buf * stage_bytes(W), c.from, c.bytes, b.bar + buf);
      ++p.issued;
      p.e += c.n;
      if (p.e < src.hi) continue;
    }
    ++p.k;
    p.in = false;
  }
}

// Bits [lo, hi) of a word, 0 <= lo < hi <= 32.
__device__ __forceinline__ uint32_t bit_range(uint32_t lo, uint32_t hi) {
  return (uint32_t)(((1ull << hi) - 1ull) & ~((1ull << lo) - 1ull));
}

// OR run [st, en) into the window bitmap `dest` that starts at position
// p0, clipped to the window: partial words by atomicOr (two runs may
// share a word), whole words by stores (a whole word lies in one run);
// a run over more than 32 whole words leaves them to the block: it is
// listed in `spans` (whole words [lo, hi)), counted by `n_spans`.
__device__ __forceinline__ void run_into(uint32_t* dest, uint32_t p0, uint32_t window_bits,
                                         uint32_t st, uint32_t en, uint2* spans, int* n_spans) {
  const uint32_t a = st > p0 ? st - p0 : 0u;
  const uint32_t z = min(en - p0, window_bits);  // en > p0 within a window's range
  if (a >= z) return;
  const uint32_t wa = a >> 5, wz = (z - 1u) >> 5;
  if (wa == wz) {
    atomicOr(dest + wa, bit_range(a & 31u, ((z - 1u) & 31u) + 1u));
    return;
  }
  atomicOr(dest + wa, bit_range(a & 31u, 32u));
  atomicOr(dest + wz, bit_range(0u, ((z - 1u) & 31u) + 1u));
  if (wz - wa - 1u > 32u) {
    const int k = atomicAdd(n_spans, 1);
    spans[k] = make_uint2(wa + 1u, wz);
    return;
  }
  for (uint32_t w = wa + 1u; w < wz; ++w) dest[w] = 0xffffffffu;
}

__device__ __forceinline__ uint4 op4(int op, uint4 u, uint4 v) {
  switch (op) {
    case -1: return make_uint4(u.x & v.x, u.y & v.y, u.z & v.z, u.w & v.w);
    case -2: return make_uint4(u.x | v.x, u.y | v.y, u.z | v.z, u.w | v.w);
    case -3: return make_uint4(u.x & ~v.x, u.y & ~v.y, u.z & ~v.z, u.w & ~v.w);
    default: return make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
  }
}

// Expand source k of the block into the bitmap `dest`, consuming its
// chunks (thread 0 refilling the ring first).  Ends with a block barrier
// when it read a chunk.
template <int W>
__device__ void consume(const Block& b, int k, uint32_t* dest, Producer& p, uint32_t& consumed) {
  using O = Own<W>;
  const int tid = threadIdx.x;
  const Src src = source_of<W>(b, k);
  if (src.fmt != kDense || src.lo >= src.hi) {
#pragma unroll
    for (int g = 0; g < O::G; ++g) O::at(dest, g) = make_uint4(0u, 0u, 0u, 0u);
    if (src.lo >= src.hi) return;
    if (tid == 0) *b.n_spans = 0;
    __syncthreads();  // zeroed before any thread ORs in
  }
  for (uint32_t e = src.lo; e < src.hi;) {
    const Chunk c = chunk_at<W>(src, e);
    if (tid == 0) fill<W>(p, b, consumed, b.n_prog);
    const int buf = consumed % kStages;
    bar_wait(b.bar + buf, (consumed / kStages) & 1u);
    const uint32_t* in =
        reinterpret_cast<const uint32_t*>(b.stage + buf * stage_bytes(W)) + c.head;
    if (src.fmt == kDense) {
      // A chunk is half the window: each group of 4 lies in one of them.
#pragma unroll
      for (int g = 0; g < O::G; ++g) {
        const uint32_t at = O::word(g) - (e - b.w0);
        if (at < c.n) {
          O::at(dest, g) = c.head == 0 ? *reinterpret_cast<const uint4*>(in + at)
                                       : make_uint4(in[at], in[at + 1], in[at + 2], in[at + 3]);
        }
      }
    } else if (src.fmt == kPositions) {
      for (uint32_t i = tid; i < c.n; i += kThreads) {
        const uint32_t r = in[i] - b.p0;
        atomicOr(dest + (r >> 5), 1u << (r & 31u));
      }
    } else {
      for (uint32_t i = tid; i < c.n; i += kThreads) {
        run_into(dest, b.p0, 32u * W, in[2 * i], in[2 * i + 1], b.spans, b.n_spans);
      }
      __syncthreads();
      const int n_spans = *b.n_spans;
      if (n_spans > 0) {  // long runs: the whole block
        for (int k2 = 0; k2 < n_spans; ++k2) {
          const uint2 sp = b.spans[k2];
          for (uint32_t w = sp.x + tid; w < sp.y; w += kThreads) dest[w] = 0xffffffffu;
        }
        __syncthreads();
        if (tid == 0) *b.n_spans = 0;
      }
    }
    ++consumed;
    e += c.n;
    __syncthreads();  // the buffer is free, the bitmap complete
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
anchored_count_kernel(const long long* __restrict__ meta, int n_slices, int n_leaves, int n_prog,
                      int* __restrict__ out) {
  using O = Own<W>;
  const int s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* red = reinterpret_cast<int*>(smem + 8 * kStages);
  uint32_t* arange = reinterpret_cast<uint32_t*>(smem + 8 * kStages + 4 * kWarps);
  int* n_spans = reinterpret_cast<int*>(smem + 56);
  uint2* spans = reinterpret_cast<uint2*>(smem + 64);
  long long* table = reinterpret_cast<long long*>(smem + 320);
  uint2* ranges = reinterpret_cast<uint2*>(smem + 320 + align16(24LL * n_leaves));
  int* program = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(ranges) +
                                        align16(8LL * n_leaves));
  uint32_t* anc = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(program) +
                                              align16(4LL * n_prog));
  unsigned char* stage = reinterpret_cast<unsigned char*>(anc + W);
  uint32_t* stack = reinterpret_cast<uint32_t*>(stage + kStages * stage_bytes(W));

  // The anchor's index, the slice's table row and the program come in
  // together.
  const long long anchor = __ldg(meta + s);
  const long long* row = meta + n_slices + 3LL * n_leaves * s;
  for (int i = tid; i < 3 * n_leaves; i += kThreads) table[i] = __ldg(row + i);
  const long long* prog = meta + n_slices + 3LL * n_leaves * n_slices;
  for (int i = tid; i < n_prog; i += kThreads) program[i] = (int)__ldg(prog + i);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) bar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (anchor < 0) return;
  const Leaf a = leaf_at(table, anchor);
  if (a.n == 0) return;  // every exit above and below is block-uniform

  const uint32_t w0 = blockIdx.x * (uint32_t)W;
  const uint32_t p0 = 32u * w0, p1 = p0 + 32u * W;
  if (a.fmt != kDense) {
    if (warp < 2) {
      const uint32_t r = window_bound(a, warp, p0, p1);
      if (lane == 0) arange[warp] = r;
    }
    __syncthreads();
  }
  Block b{table, program, n_prog, anchor, a,      w0,    w0 + W,  ranges,
          w0,    p0,      stage,  bar,    spans, n_spans};
  if (a.fmt != kDense) {
    b.alo = arange[0];
    b.ahi = arange[1];
    if (b.alo >= b.ahi) return;  // the anchor has no bit here: nothing in flight
  }
  Producer p;
  uint32_t consumed = 0;
  if (tid == 0) fill<W>(p, b, 0, 0);  // the anchor's chunks
  for (int t = warp; t < 2 * n_leaves; t += kWarps) {
    const int i = t >> 1;
    const Leaf l = leaf_at(table, i);
    if (l.fmt != kDense && l.n > 0 && i != anchor) {
      const uint32_t r = window_bound(l, t & 1, p0, p1);
      if (lane == 0) reinterpret_cast<uint32_t*>(ranges + i)[t & 1] = r;
    }
  }
  __syncthreads();
  consume<W>(b, -1, anc, p, consumed);
  if (a.fmt == kDense) {
    bool any = false;
#pragma unroll
    for (int g = 0; g < O::G; ++g) {
      const uint4 v = O::at(anc, g);
      any |= (v.x | v.y | v.z | v.w) != 0u;
    }
    if (!__syncthreads_or(any)) {
      // No bit here: let the chunks in flight land before the block's
      // shared memory is released.
      if (tid == 0) {
        for (uint32_t i = consumed; i < p.issued; ++i) bar_wait(bar + i % kStages, (i / kStages) & 1u);
      }
      return;
    }
  }
  int sp = 0;
  for (int k = 0; k < n_prog; ++k) {
    const int op = program[k];
    if (op >= 0 || op == -5) {
      uint32_t* dst = stack + (size_t)sp * W;
      if (op == anchor) {
#pragma unroll
        for (int g = 0; g < O::G; ++g) O::at(dst, g) = O::at(anc, g);
      } else {
        consume<W>(b, k, dst, p, consumed);  // -5 reads nothing: zeroed
      }
      ++sp;
    } else {
      --sp;
      uint32_t* x = stack + (size_t)(sp - 1) * W;
      uint32_t* y = stack + (size_t)sp * W;
#pragma unroll
      for (int g = 0; g < O::G; ++g) O::at(x, g) = op4(op, O::at(x, g), O::at(y, g));
    }
  }
  int total = 0;
#pragma unroll
  for (int g = 0; g < O::G; ++g) {
    const uint4 v = op4(-1, O::at(stack, g), O::at(anc, g));
    total += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  total = __reduce_add_sync(0xffffffffu, total);
  if (lane == 0) red[warp] = total;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i];
    if (sum > 0) atomicAdd(out + s, sum);
  }
}

template <int W>
int launch(const void* meta, int n_slices, int n_leaves, int n_prog, int depth, void* out,
           void* stream) {
  const long long smem = smem_bytes(W, n_leaves, n_prog, depth);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anchored_count_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(kSliceWords / W), (unsigned)n_slices);
  anchored_count_kernel<W><<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(meta), n_slices, n_leaves, n_prog, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// out[s] += the anchored count of slice s for s < n_slices, with `meta` and
// `out` on the device as described above; 1 <= n_slices <= 65535, n_leaves
// >= 1, n_prog >= 1, depth the program's stack depth (1 to 64), window_words
// 1024 or 512.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_anchored_count(const void* meta, int n_slices, int n_leaves, int n_prog,
                                     int depth, int window_words, void* out, void* stream) {
  if (n_slices < 1 || n_slices > 65535 || n_leaves < 1 || n_prog < 1 || depth < 1 || depth > 64 ||
      meta == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  switch (window_words) {
    case 1024: return launch<1024>(meta, n_slices, n_leaves, n_prog, depth, out, stream);
    case 512: return launch<512>(meta, n_slices, n_leaves, n_prog, depth, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

