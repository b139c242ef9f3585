// K6: payload expansion — compressed sparse-tier rows become dense
// 32,768-word rows, every row a call needs in one launch, written straight
// into its destination row.
//
// Replaces _expand_sparse_xla / _expand_rle_xla / expand_payload
// (pilosa_tpu/ops/bitplane.py:458, 480, 508), which the JAX package jitted
// once per payload bucket and dispatched once per row.
//
// Inputs.  `table` is int64 [N, 4], one line per row: the payload's address,
// its format (0 dense words, 1 sorted positions, 2 sorted half-open runs
// (start, end)), its REAL length in entries (32768 words, n positions or R
// runs: no sentinel padding) and the destination row's address (32768 int32
// words, 16-byte aligned).  A length of 0 writes a zero row and reads
// nothing.  Positions are < 2^20 and run ends <= 2^20; the wrapper checks
// shapes, devices and alignment.
//
// Bound: memory.  Per row it must read the payload once (4 B a position,
// 8 B a run, 128 KiB for a dense payload) and write 128 KiB.  At 954 rows
// the writes alone are 125 MB: 0.037 ms at the 3.35 TB/s of an H100 SXM.
//
// Design: one block of 256 threads per (row, tile of 4,096 words = 131,072
// positions): grid (8, N).  Two warps find, by a 32-way search, the
// payload entries that touch the tile; the block ORs them into a 16 KiB
// tile in shared memory (each position one shared atomicOr; a run sets its
// boundary words with atomicOr and stores its interior words, which no
// other run touches: runs are disjoint); then the tile goes out in 16-byte
// stores; a tile this large pays the searches' latency 8 times a row.
// Every payload entry is read once (a run spanning tiles once per tile)
// and every output word written once; OR is commutative, so the result
// does not depend on the order of the shared atomics.  A dense payload is
// copied with 16-byte loads.  The kernel allocates nothing and launches
// on the caller's stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;
constexpr int kVecsPerThread = kTileWords / 4 / kThreads;
constexpr uint32_t kTileBits = kTileWords * 32;
constexpr int kTiles = 32768 / kTileWords;

// Bits [lo, hi) of a 32-bit word, 0 <= lo < hi <= 32.
__device__ __forceinline__ uint32_t span_mask(uint32_t lo, uint32_t hi) {
  const uint32_t width = hi - lo;
  const uint32_t m = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  return m << lo;
}

// First index i in [0, n) with key(i) >= x (n if none), key(i) =
// src[stride * i + off] ascending, found by one whole warp: each round its
// 32 lanes probe 32 points that cut the range into 33 parts, and a ballot
// keeps the part holding the answer — about log33(n) rounds of parallel
// loads instead of log2(n) dependent ones.  Every lane returns the answer.
__device__ __forceinline__ long long warp_lower_bound(const uint32_t* src, long long n,
                                                      int stride, int off, uint32_t x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const long long len = hi - lo;
    const long long idx = lo + ((long long)(lane + 1) * len) / 33;  // < hi
    const int c = __popc(__ballot_sync(0xffffffffu, src[stride * idx + off] < x));
    const long long nlo = c == 0 ? lo : lo + ((long long)c * len) / 33 + 1;
    hi = c == 32 ? hi : lo + ((long long)(c + 1) * len) / 33;
    lo = nlo;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_payload_kernel(const long long* __restrict__ table) {
  const long long* line = table + 4LL * blockIdx.y;
  const int fmt = (int)line[1];
  const long long n = line[2];
  const uint32_t* src = reinterpret_cast<const uint32_t*>(line[0]);
  uint4* dest = reinterpret_cast<uint4*>(reinterpret_cast<uint32_t*>(line[3]) +
                                         (long long)blockIdx.x * kTileWords);
  if (fmt == 0 && n > 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src + (long long)blockIdx.x * kTileWords);
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      dest[threadIdx.x + k * kThreads] = s[threadIdx.x + k * kThreads];
    }
    return;
  }
  __shared__ __align__(16) uint32_t tile[kTileWords];
  __shared__ long long span[2];
  const uint32_t base = blockIdx.x * kTileBits;
  uint4* vtile = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    vtile[threadIdx.x + k * kThreads] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    // Warp 0 finds the first entry of the tile, warp 1 the first past it:
    // positions >= base and >= base + kTileBits; for runs, the first whose
    // end > base and the first whose start >= base + kTileBits.
    long long v = 0;
    if (n > 0 && fmt == 1) {
      v = warp_lower_bound(src, n, 1, 0, base + warp * kTileBits);
    } else if (n > 0) {
      v = warp == 0 ? warp_lower_bound(src, n, 2, 1, base + 1)
                    : warp_lower_bound(src, n, 2, 0, base + kTileBits);
    }
    if ((threadIdx.x & 31) == 0) span[warp] = v;
  }
  __syncthreads();
  const long long lo = span[0], hi = span[1];
  if (fmt == 1) {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const uint32_t p = src[i] - base;
      atomicOr(&tile[p >> 5], 1u << (p & 31u));
    }
  } else if (fmt == 2) {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const uint32_t s = src[2 * i] > base ? src[2 * i] - base : 0u;
      const uint32_t e = min(src[2 * i + 1] - base, kTileBits);  // e > s
      const uint32_t w0 = s >> 5, wl = (e - 1) >> 5;
      if (w0 == wl) {
        atomicOr(&tile[w0], span_mask(s & 31u, e - (w0 << 5)));
      } else {
        atomicOr(&tile[w0], span_mask(s & 31u, 32u));
        for (uint32_t w = w0 + 1; w < wl; ++w) tile[w] = 0xFFFFFFFFu;
        atomicOr(&tile[wl], span_mask(0u, e - (wl << 5)));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    dest[threadIdx.x + k * kThreads] = vtile[threadIdx.x + k * kThreads];
  }
}

}  // namespace

// Expand the n_rows rows of `table` (on the device, laid out as above),
// 1 <= n_rows <= 65535.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_expand_payload(const void* table, int n_rows, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || table == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(kTiles, (unsigned)n_rows);
  expand_payload_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table));
  return (int)cudaGetLastError();
}
