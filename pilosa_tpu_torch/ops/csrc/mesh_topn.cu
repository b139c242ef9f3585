// K9: the mesh TopN scorer — per (slice, row) the popcount of a plane row
// ANDed with its slice's src row, over one member's contiguous block.
//
// Replaces _topn_partials and _topn_total_fn (pilosa_tpu/parallel/mesh.py:187,
// 206) and the TopN half of query_step (:264):
//
//   partials: out[s, r] = popcount(plane[s, r, :] & src[s, :])   int32 [S, R]
//   total:    out[r]    = sum over s of the same                  int64 [R]
//
// The total reduce never writes the [S, R] partials to memory: each block adds
// its part of a row's count into out[r] with one 64-bit atomic.  A slice-row
// holds at most 2^20 bits, so a partial is int32-exact; the per-row totals are
// unbounded and sum in 64 bits (the JAX package's (hi, lo) limbs are not
// needed).
//
// Inputs.  `plane` is uint32 [S, R, words], contiguous, and `src` uint32
// [S, words] with a row stride of `src_stride` words (the src rows may be a
// row of each slice of the plane itself, as in query_step); rows are 16-byte
// aligned and words and the stride are multiples of 4 (the loads are
// uint4).  `out` is zeroed on the stream by the launcher.
//
// Bound: the kernel is memory-bound.  It must read every plane row and every
// src row once and write 4 bytes per partial (8 per total); per word it does
// one and, one __popc and one add.  At [954, 8, 32768] plus src that is
// 954 x 9 x 131,072 B = 1.125 GB, 0.336 ms at the 3.35 TB/s of an H100 SXM.
//
// Design (simple first; a TMA ring is later work): the word axis is cut into
// chunks of kChunk = 4,096 words.  One block of 256 threads per (slice,
// chunk, tile of kRowTile rows): grid (S * chunks, ceil(R / kRowTile)).  The
// block stages its slice's src chunk (16 KiB) in shared memory once, then
// streams each row of its tile against it with 16-byte loads, 4 uint4 a
// thread; each thread's count is reduced by warp shuffles and the warps'
// sums by shared-memory atomics, and one thread a row adds the block's sum
// into the output with one atomic (32-bit for partials, 64-bit for totals).
// Integer atomics commute, so the result is exact and the same on every run.
// The kernel allocates nothing and launches on the caller's stream; the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;                 // words of a block's chunk
constexpr int kChunkVecs = kChunk / 4;       // uint4 of a chunk
constexpr int kRowTile = 64;                 // rows of a block

__device__ __forceinline__ int popc_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) + __popc(a.w & b.w);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool kTotal>
__global__ void __launch_bounds__(kThreads)
mesh_topn_kernel(const uint4* __restrict__ plane, const uint4* __restrict__ src,
                 long long src_vecs, int rows, long long vecs, int chunks,
                 void* __restrict__ out) {
  __shared__ uint4 s_src[kChunkVecs];
  __shared__ int s_sum[kRowTile];
  const long long s = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, rows - r0);
  const long long v0 = (long long)chunk * kChunkVecs;
  const int nv = (int)min((long long)kChunkVecs, vecs - v0);

  const uint4* src_s = src + s * src_vecs + v0;
  for (int i = threadIdx.x; i < nv; i += kThreads) s_src[i] = src_s[i];
  for (int j = threadIdx.x; j < nr; j += kThreads) s_sum[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nr; ++j) {
    const uint4* row = plane + (s * rows + r0 + j) * vecs + v0;
    int acc = 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads) acc += popc_and(row[i], s_src[i]);
    acc = warp_sum(acc);
    if (lane == 0 && acc != 0) atomicAdd(&s_sum[j], acc);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nr; j += kThreads) {
    const int v = s_sum[j];
    if (v == 0) continue;
    if (kTotal) {
      atomicAdd(static_cast<unsigned long long*>(out) + r0 + j, (unsigned long long)v);
    } else {
      atomicAdd(static_cast<int*>(out) + s * rows + r0 + j, v);
    }
  }
}

}  // namespace

// src row s starts src_stride words after src row s - 1.  total == 0: out is
// int32 [n_slices, rows], the partials; total == 1: out is int64 [rows], the
// per-row sums over the slices.  1 <= n_slices, 1 <= rows, words > 0 and a
// multiple of 4, src_stride >= words and a multiple of 4.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int pilosa_mesh_topn(const void* plane, const void* src, long long src_stride,
                                int n_slices, int rows, int words, int total, void* out,
                                void* stream) {
  if (n_slices < 1 || rows < 1 || words < 4 || words % 4 != 0 || src_stride < words ||
      src_stride % 4 != 0 || plane == nullptr ||
      src == nullptr || out == nullptr || (total != 0 && total != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long vecs = words / 4;
  const int chunks = (int)((vecs + kChunkVecs - 1) / kChunkVecs);
  const long long blocks_x = (long long)n_slices * chunks;
  const long long tiles = (rows + kRowTile - 1) / kRowTile;
  if (blocks_x > 0x7FFFFFFFLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = total ? (size_t)rows * 8 : (size_t)n_slices * rows * 4;
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_x, (unsigned)tiles);
  if (total) {
    mesh_topn_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(plane), static_cast<const uint4*>(src), src_stride / 4,
        rows, vecs, chunks, out);
  } else {
    mesh_topn_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(plane), static_cast<const uint4*>(src), src_stride / 4,
        rows, vecs, chunks, out);
  }
  return (int)cudaGetLastError();
}
