// K4: the cross-fragment TopN scorer — every candidate row of every fragment
// of a node scored against its fragment's src row in one launch, read in
// place from the fragments' mirrors.
//
// Replaces bp.score_planes (pilosa_tpu/ops/bitplane.py:815), the jitted
// programs _score_planes_self_src (:785) and _score_planes_host_src (:800):
//
//   out[f, j] = popcount(plane_f[slot[f, j]] & src_f)      int32 [F, R]
//
// Inputs.  `table` is int64 [F, 2 + R], one line per fragment: the base
// address of the fragment's mirror (int32 [rows, 32768], 16-byte aligned),
// the address of its src row (32768 words, 16-byte aligned: a row of the
// same mirror — the TopN(Bitmap(frame=f), frame=f) shape — or a row the src
// tree was evaluated into), then R candidate slots, -1 for a pad (the
// fragments' candidate lists are ragged; a pad reads nothing and scores 0).
// The wrapper checks every slot against its mirror's rows before the launch.
//
// Bound: the kernel is memory-bound.  It must read each real candidate row
// and each src row once, 128 KiB apiece, and write 4 bytes per score; per
// word it does one and, one __popc and one add.  At [954 fragments, 8
// candidates] that is 954 x 9 x 131,072 B = 1.125 GB, 0.336 ms at the
// 3.35 TB/s of an H100 SXM; at [954, 64], 8.13 GB and 2.43 ms.
//
// Design: one block of 256 threads per (fragment, tile of kTile = 8
// candidate rows): grid (ceil(R / 8), F).  The block streams the src row
// once per tile with 16-byte loads, and for each uint4 of src reads the same
// uint4 of each of its candidate rows; the tiles of one fragment are
// neighbours in launch order, so src's later reads come from L2.  Each thread
// keeps 8 counters in registers; the block reduces them with warp shuffles and
// one 8 x 8 shared array, and thread j writes out[f, tile + j].  There are no
// atomics: each score has one writer, so the result is deterministic.  A pad
// slot is a block-uniform branch.  The kernel allocates nothing and launches
// on the caller's stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;
constexpr long long kVecsPerRow = 32768 / 4;

__device__ __forceinline__ int popc_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) + __popc(a.w & b.w);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
score_planes_kernel(const long long* __restrict__ table, int rows, int* __restrict__ out) {
  const int f = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const long long* line = table + (long long)f * (2 + rows);
  const uint4* base = reinterpret_cast<const uint4*>(line[0]);
  const uint4* src = reinterpret_cast<const uint4*>(line[1]);

  const uint4* cand[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const long long slot = (r0 + j < rows) ? line[2 + r0 + j] : -1;
    cand[j] = slot < 0 ? nullptr : base + slot * kVecsPerRow;
  }

  int acc[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = 0;

#pragma unroll 2
  for (long long i = threadIdx.x; i < kVecsPerRow; i += kThreads) {
    const uint4 s = src[i];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (cand[j] != nullptr) acc[j] += popc_and(cand[j][i], s);
    }
  }

  __shared__ int partial[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int v = warp_sum(acc[j]);
    if (lane == 0) partial[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTile && r0 + (int)threadIdx.x < rows) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w][threadIdx.x];
    out[(long long)f * rows + r0 + threadIdx.x] = total;
  }
}

}  // namespace

// out[f * rows + j] = popcount(plane_f[slot] & src_f) for f < n_frag, j < rows,
// with `table` as described above (on the device); 1 <= n_frag <= 65535,
// 1 <= rows.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_score_planes(const void* table, int n_frag, int rows, void* out,
                                   void* stream) {
  if (n_frag < 1 || n_frag > 65535 || rows < 1 || table == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((rows + kTile - 1) / kTile), (unsigned)n_frag);
  score_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), rows, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
