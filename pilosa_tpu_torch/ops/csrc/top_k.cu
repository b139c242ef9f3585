// top_k: the k largest counts with their indices, count descending, ties
// toward the lower index — selected on the card.
//
// Replaces top_k (pilosa_tpu/ops/bitplane.py:850, jax.lax.top_k), which the
// JAX package's query_step (pilosa_tpu/parallel/mesh.py:264) runs on the
// per-row TopN totals.  torch.topk promises no order among equal values, and
// the reference's Pair order (cache.go:316-330) needs one: ties go to the
// lower index.
//
// Inputs.  `counts` is int32 or int64 [n] (`is64`), or — in a later round —
// int64 candidate counts with their int32 indices (`idx_in`, null in the
// first round: an element's index is its position).  `k` <= the tile: up
// to kTile in one tile, at most kTile / 2 when a round has several (the
// wrapper's rule, so that each round shrinks the candidates).
//
// Bound: launch-bound at the sizes the port calls it with (a few to a few
// thousand counts: one block, one launch); the bytes are n x 8 in and k x 12
// out, microseconds of memory time.
//
// Design: one block per tile of at most kTile = 2,048 elements; a round
// over fewer elements sorts a tile of the next power of two (at least 32),
// with one thread per element up to 1,024, so a handful of counts costs a
// handful of network stages.  The block loads its tile into shared memory
// as (count, index) pairs, pads the tail with sentinels that lose to every
// element (count INT64_MIN, index INT32_MAX), and sorts the tile by a
// bitonic network on the key (count descending, index ascending), then
// writes its first k pairs.  The pairs of a round are a total order, so the
// k best of the whole input are among the k best of each tile: the wrapper
// runs rounds over the candidates (each cuts them by kTile / k >= 2) until
// one tile holds them all, and that last round writes the answer.  The kernel allocates nothing and launches
// on the caller's stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 2048;

__device__ __forceinline__ bool better(long long ca, int ia, long long cb, int ib) {
  return ca > cb || (ca == cb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
top_k_kernel(const void* __restrict__ counts, int is64, const int* __restrict__ idx_in, int n,
             int k, int tile, long long* __restrict__ out_counts, int* __restrict__ out_idx) {
  __shared__ long long s_cnt[kTile];
  __shared__ int s_idx[kTile];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (g < n) {
      s_cnt[i] = is64 ? static_cast<const long long*>(counts)[g]
                      : (long long)static_cast<const int*>(counts)[g];
      s_idx[i] = idx_in != nullptr ? idx_in[g] : (int)g;
    } else {
      s_cnt[i] = (long long)INT64_MIN;
      s_idx[i] = INT32_MAX;
    }
  }
  __syncthreads();
  // Bitonic sort, best first: in a run whose bit `size` is clear the pair
  // (i, i ^ stride) is ordered best first, in the other worst first.
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const bool best_first = (i & size) == 0;
        const bool j_better = better(s_cnt[j], s_idx[j], s_cnt[i], s_idx[i]);
        if (best_first == j_better) {
          const long long c = s_cnt[i];
          s_cnt[i] = s_cnt[j];
          s_cnt[j] = c;
          const int x = s_idx[i];
          s_idx[i] = s_idx[j];
          s_idx[j] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_counts[(long long)blockIdx.x * k + i] = s_cnt[i];
    out_idx[(long long)blockIdx.x * k + i] = s_idx[i];
  }
}

}  // namespace

// One round over n elements: ceil(n / tile) blocks (tile = 2048 past 2048
// elements, else the next power of two of n, at least 32), each writing its
// k best pairs to out_counts / out_idx at [block * k, block * k + k).
// 1 <= k <= tile, 1 <= n.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int pilosa_top_k(const void* counts, int is64, const void* idx_in, int n, int k,
                            void* out_counts, void* out_idx, void* stream) {
  if (n < 1 || k < 1 || k > kTile || counts == nullptr || out_counts == nullptr ||
      out_idx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int tile = 32;
  while (tile < n && tile < kTile) tile <<= 1;
  if (k > tile) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + tile - 1) / tile);
  const int threads = tile < kThreads ? tile : kThreads;
  top_k_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, is64, static_cast<const int*>(idx_in), n, k, tile,
      static_cast<long long*>(out_counts), static_cast<int*>(out_idx));
  return (int)cudaGetLastError();
}
