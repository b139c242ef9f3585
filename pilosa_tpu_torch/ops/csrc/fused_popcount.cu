// Fused bitwise op + popcount + per-row reduce over slice-row bit-planes.
//
// Replaces the TPU kernel _fused_count_pallas (pilosa_tpu/ops/bitplane.py:615,
// body _pallas_count_kernel at :597): sum(popcount(a OP b)), OP in
// {and, or, xor, andnot}.  Here the output is one popcount per row
// (out[r] = popcount(a[r] OP b[r])), which the caller sums in int64; a
// slice-row holds at most 2^20 bits, so every per-row count is exact in
// int32.  Op "none" is a plain popcount of a (counts, rank-cache recounts).
//
// Inputs are int32 bit-views of the uint32 plane words: a is [rows, words]
// contiguous and 16-byte aligned; b is either the same shape, or ONE row
// read by every row of a (b_row_stride = 0: the TopN src broadcast), or
// absent for op none.
//
// Bound: the kernel is memory-bound.  It reads rows x words x 4 bytes of a,
// and as much again of b unless b is absent or broadcast (one row, which
// stays in L2), and writes 4 bytes per row.  Per word it does one bitwise
// op, one __popc and one add.  For Count(Intersect) over 954 slice-rows per
// leaf that is 954 x 128 KiB x 2 = 250 MB, about 75 us at the 3.35 TB/s of
// an H100 SXM; the operation count (3 x 31.3M) is negligible beside it.
//
// Design: one block per (row, chunk of 4096 words); 256 threads, each
// loading uint4 (16 bytes) of a and b, so a warp reads 512 contiguous
// bytes per load.  The op and __popc run on unsigned words; the block
// reduces with warp shuffles and a 8-entry shared array, and one thread
// adds the block's partial into out[row] with an integer atomicAdd, which
// is order-independent, so the result is deterministic.  out must be
// zeroed by the caller.  The kernel allocates nothing and launches on the
// caller's stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkWords = 4096;
constexpr int kChunkVecs = kChunkWords / 4;

enum Op { kNone = 0, kAnd = 1, kOr = 2, kXor = 3, kAndNot = 4 };

template <int OP>
__device__ __forceinline__ unsigned apply_op(unsigned a, unsigned b) {
  if (OP == kAnd) return a & b;
  if (OP == kOr) return a | b;
  if (OP == kXor) return a ^ b;
  if (OP == kAndNot) return a & ~b;
  return a;
}

template <int OP>
__device__ __forceinline__ int popc_vec(uint4 x, uint4 y) {
  return __popc(apply_op<OP>(x.x, y.x)) + __popc(apply_op<OP>(x.y, y.y)) +
         __popc(apply_op<OP>(x.z, y.z)) + __popc(apply_op<OP>(x.w, y.w));
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
fused_popcount_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      long long b_row_stride_vecs, int* __restrict__ out,
                      long long vecs_per_row) {
  const long long row = blockIdx.x;
  const long long begin = (long long)blockIdx.y * kChunkVecs;
  long long end = begin + kChunkVecs;
  if (end > vecs_per_row) end = vecs_per_row;
  const uint4* ar = a + row * vecs_per_row;
  const uint4* br = (OP == kNone) ? nullptr : b + row * b_row_stride_vecs;

  int cnt = 0;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const uint4 x = ar[i];
    if (OP == kNone) {
      cnt += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    } else {
      cnt += popc_vec<OP>(x, br[i]);
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 4; off > 0; off >>= 1) {
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0 && cnt != 0) atomicAdd(out + row, cnt);
  }
}

template <int OP>
void launch(const void* a, const void* b, long long b_row_stride_words,
            void* out, long long rows, long long words, cudaStream_t stream) {
  const long long vecs = words / 4;
  const dim3 grid((unsigned)rows, (unsigned)((words + kChunkWords - 1) / kChunkWords));
  fused_popcount_kernel<OP><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      b_row_stride_words / 4, static_cast<int*>(out), vecs);
}

}  // namespace

// out[r] += popcount(a[r] OP b[r * b_row_stride_words]) for r < rows.
// words must be a positive multiple of 4 and b_row_stride_words a multiple
// of 4 (0 for a broadcast row); a and b 16-byte aligned; 1 <= rows < 2^31.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_fused_popcount(const void* a, const void* b,
                                     long long b_row_stride_words, void* out,
                                     long long rows, long long words, int op,
                                     void* stream) {
  if (rows <= 0 || rows >= (1LL << 31) || words <= 0 || words % 4 != 0 ||
      b_row_stride_words % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (op != kNone && b == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kNone: launch<kNone>(a, b, 0, out, rows, words, s); break;
    case kAnd: launch<kAnd>(a, b, b_row_stride_words, out, rows, words, s); break;
    case kOr: launch<kOr>(a, b, b_row_stride_words, out, rows, words, s); break;
    case kXor: launch<kXor>(a, b, b_row_stride_words, out, rows, words, s); break;
    case kAndNot: launch<kAndNot>(a, b, b_row_stride_words, out, rows, words, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
