// Stream-floor read-sum: the int32 sum of a flat uint32 buffer, wrapping
// mod 2^32.
//
// Replaces the XLA program of the stream-floor probe, _measure in
// pilosa_tpu/device/floorprobe.py:96 (jnp.sum(a.astype(jnp.int32)), jitted
// at :108).  Its one purpose is to read every byte of a large buffer once,
// as fast as the card streams device memory, so that the probe's GB/s is
// the roofline denominator of every launch site's floorPct.
//
// Bound: memory.  The kernel reads words x 4 bytes and writes 4; per word it
// does one add.  At the probe's size (at least 8x the L2, 512 MiB on an
// H100) that is ~0.16 ms at 3.35 TB/s.
//
// Design: the layout of the fused popcount K1 (csrc/fused_popcount.cu),
// which streams at ~94% of the card's memory rate: one block per chunk of
// 4,096 16-byte vectors (64 KiB), 256 threads, each thread issuing its 16
// vector loads four at a time before it adds any, so that many short
// blocks keep every SM's loads in flight.  Adds are uint32, which wrap
// exactly as the int32 sum of the reference does.  A warp-shuffle reduce,
// a block reduce through an 8-entry shared array, and one atomicAdd a
// block into the uint32 result: unsigned addition mod 2^32 is associative
// and commutative, so the result is exact and independent of the order in
// which blocks finish.  The words past the last whole vector are added by
// block 0.  out must be zeroed by the caller.  The kernel allocates
// nothing and launches on the caller's stream; the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunkVecs = kThreads * 16;

__device__ __forceinline__ unsigned vsum(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const uint4* __restrict__ vecs, long long n_vecs,
                  const unsigned* __restrict__ tail, int n_tail,
                  unsigned* __restrict__ out) {
  const long long begin = (long long)blockIdx.x * kChunkVecs;
  long long end = begin + kChunkVecs;
  if (end > n_vecs) end = n_vecs;
  unsigned acc = 0;
  for (long long i = begin + threadIdx.x; i < end; i += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = i + (long long)u * kThreads;
      v[u] = k < end ? vecs[k] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += vsum(v[u]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n_tail) acc += tail[threadIdx.x];

  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ unsigned warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int off = 4; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0 && acc != 0u) atomicAdd(out, acc);
  }
}

}  // namespace

// out[0] += sum(words[0:n_words]) mod 2^32.  words must be 16-byte aligned;
// 1 <= n_words < 2^40.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int pilosa_stream_sum(const void* words, long long n_words,
                                 void* out, void* stream) {
  if (n_words <= 0 || n_words >= (1LL << 40) || words == nullptr ||
      out == nullptr || (reinterpret_cast<uintptr_t>(words) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_vecs = n_words / 4;
  const int n_tail = (int)(n_words - n_vecs * 4);
  long long blocks = (n_vecs + kChunkVecs - 1) / kChunkVecs;
  if (blocks < 1) blocks = 1;  // the tail alone
  const unsigned* base = static_cast<const unsigned*>(words);
  stream_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(base), n_vecs, base + n_vecs * 4, n_tail,
      static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
