// K5: the anchored position-domain Count — every slice of a Count on a node
// in one launch, each leaf read through its own container format.
//
// Replaces _build_anchored / compiled_anchored_count / anchored_count_exec
// (pilosa_tpu/exec/plan.py:855-934) with the membership kernels
// membership_dense / membership_sparse / membership_rle
// (pilosa_tpu/ops/bitplane.py:429-453).  The JAX package compiled and
// launched one program per per-leaf format signature, with every axis
// padded to a pow2 bucket with 0xFFFFFFFF sentinels; here formats are
// runtime values and lengths are real, so any mix of formats, lengths and
// absent rows goes in one launch and no sentinel is ever read.
//
// For slice s, with anchor positions P_s (a leaf whose row is a superset of
// the tree's result, chosen by the executor):
//
//   out[s] = #{ p in P_s : tree(member(leaf_0, p), ..., member(leaf_L-1, p)) }
//
// Inputs.  `meta` is one int64 buffer on the device:
//   [0, S]                 CSR offsets of each slice's positions in `positions`
//   [S+1, S+1 + 3 S L)     leaf table: for slice s, leaf i, (format, address,
//                          length) — format 0 dense words (a row of a
//                          fragment's mirror, read in place, or a dense
//                          payload), 1 sorted positions, 2 sorted half-open
//                          runs (start, end); length in entries, 0 for an
//                          absent row (never a member)
//   [S+1 + 3 S L, +n_prog) the tree as a postfix program: i >= 0 pushes
//                          member(leaf i, p); -1 and, -2 or, -3 and-not,
//                          -4 xor pop two and push one; -5 pushes 0 (an
//                          empty Union)
// `positions` is uint32, each slice's anchor ascending (< 2^20).  `out` is
// int32 [S], zeroed by the wrapper.  The wrapper checks that the program
// is well formed and at most 64 deep.
//
// Bound: memory.  It must read the anchor (4 B a position) and, per
// position, one word of a dense leaf or the entries near it of a
// compressed one; its bound counts the anchor plus every leaf's encoded
// bytes once, as the JAX package's eff_bytes does.
//
// Design: one thread per 16 consecutive anchor positions of a slice, 256
// threads a block: grid (ceil(max |P_s| / 4096), S).  The block brings its
// 4,096 positions in with coalesced loads through shared memory.  A
// thread computes each leaf's membership for its positions as one 16-bit
// mask: the positions ascend, so after one warp-wide search for the warp's
// first position (32 lanes probe at once, a ballot keeps the right part)
// a lane walks the leaf's entries forward, galloping where they are far
// apart — about one read per position instead of one binary search per
// position.  The program then runs on the masks, 16 positions per bitwise
// op, on a stack in local memory; the popcount of the result (valid lanes
// only) goes into a warp sum, and lane 0 adds it to out[s] with one integer
// atomicAdd: integer addition is order-free, so the result is
// deterministic.  The kernel allocates nothing and launches on the
// caller's stream; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 16;  // positions per thread
constexpr int kPerBlock = kThreads * kLane;
constexpr int kMaxDepth = 64;

// Entry indices are 32-bit: a leaf holds at most 2^20 positions, 2^19
// runs or 32,768 words.

// First index in [i, n) whose key src[stride * j + off] >= x (n if none),
// given that every key before i is < x: gallop from i, then bisect.
__device__ __forceinline__ uint32_t seek(const uint32_t* src, uint32_t i, uint32_t n,
                                         int stride, int off, uint32_t x) {
  if (i >= n || src[stride * i + off] >= x) return i;
  uint32_t lo = i + 1, step = 1, hi = lo;
  while (hi < n && src[stride * hi + off] < x) {
    lo = hi + 1;
    step <<= 1;
    hi = lo + step - 1;
  }
  if (hi > n) hi = n;
  while (lo < hi) {  // answer in [lo, hi]
    const uint32_t m = (lo + hi) >> 1;
    if (src[stride * m + off] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

// First index i in [0, n) with key(i) >= x (n if none), key(i) =
// src[stride * i + off] ascending, found by one whole warp: each round its
// 32 lanes probe 32 points that cut the range into 33 parts, and a ballot
// keeps the part holding the answer.  Every lane returns the answer.
__device__ __forceinline__ uint32_t warp_lower_bound(const uint32_t* src, uint32_t n,
                                                     int stride, int off, uint32_t x) {
  const uint32_t lane = threadIdx.x & 31u;
  uint32_t lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const uint32_t len = hi - lo;
    const uint32_t idx = lo + (lane + 1u) * len / 33u;  // < hi
    const uint32_t c = __popc(__ballot_sync(0xffffffffu, src[stride * idx + off] < x));
    const uint32_t nlo = c == 0 ? lo : lo + c * len / 33u + 1u;
    hi = c == 32 ? hi : lo + (c + 1u) * len / 33u;
    lo = nlo;
  }
  return lo;
}

// Membership mask of one leaf (fmt, src, n) for the thread's positions
// p[0..cnt), ascending: bit j for p[j].  Called by the whole warp, whose
// first position is p0 (<= every lane's positions): one warp search finds
// p0's place, and each lane gallops on from there.
__device__ __forceinline__ uint32_t leaf_mask(const long long* leaf, const uint32_t (&p)[kLane],
                                              int cnt, uint32_t p0) {
  const uint32_t n = (uint32_t)leaf[2];
  if (n == 0) return 0u;
  const int fmt = (int)leaf[0];
  const uint32_t* src = reinterpret_cast<const uint32_t*>(leaf[1]);
  uint32_t m = 0u;
  if (fmt == 0) {
#pragma unroll
    for (int j = 0; j < kLane; ++j) {
      if (j < cnt) m |= ((src[p[j] >> 5] >> (p[j] & 31u)) & 1u) << j;
    }
    return m;
  }
  if (fmt == 1) {  // sorted positions: the first >= p[j]
    uint32_t i = warp_lower_bound(src, n, 1, 0, p0);
#pragma unroll
    for (int j = 0; j < kLane; ++j) {
      if (j < cnt) {
        i = seek(src, i, n, 1, 0, p[j]);
        if (i < n && src[i] == p[j]) m |= 1u << j;
      }
    }
    return m;
  }
  uint32_t i = warp_lower_bound(src, n, 2, 1, p0 + 1u);
#pragma unroll
  for (int j = 0; j < kLane; ++j) {  // runs: the first whose end > p[j]
    if (j < cnt) {
      i = seek(src, i, n, 2, 1, p[j] + 1u);
      if (i < n && src[2 * i] <= p[j]) m |= 1u << j;
    }
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
anchored_count_kernel(const long long* __restrict__ meta, int n_slices, int n_leaves,
                      int n_prog, const uint32_t* __restrict__ positions,
                      int* __restrict__ out) {
  const int s = blockIdx.y;
  const long long lo = meta[s];
  const long long hi = meta[s + 1];
  const long long block_first = lo + (long long)blockIdx.x * kPerBlock;
  if (block_first >= hi) return;  // block-uniform
  // The block's positions come in with coalesced loads through shared
  // memory; each thread then takes its 16 as four 16-byte reads.
  __shared__ __align__(16) uint32_t staged[kPerBlock];
  const int block_cnt = (int)min((long long)kPerBlock, hi - block_first);
  for (int k = threadIdx.x; k < block_cnt; k += kThreads) staged[k] = positions[block_first + k];
  __syncthreads();
  const int cnt = max(0, min(kLane, block_cnt - (int)threadIdx.x * kLane));
  uint32_t p[kLane];
  const uint4* mine = reinterpret_cast<const uint4*>(staged) + threadIdx.x * (kLane / 4);
#pragma unroll
  for (int q = 0; q < kLane / 4; ++q) {
    const uint4 v = mine[q];
    p[4 * q] = v.x;
    p[4 * q + 1] = v.y;
    p[4 * q + 2] = v.z;
    p[4 * q + 3] = v.w;
  }
  // Lanes hold ascending positions, so lane 0's first is the warp's least;
  // a warp whose lane 0 has none has none at all (warp-uniform branch).
  const uint32_t p0 = __shfl_sync(0xffffffffu, cnt > 0 ? p[0] : 0u, 0);
  uint32_t total = 0;
  if (__shfl_sync(0xffffffffu, cnt, 0) > 0) {
    const long long* table = meta + (n_slices + 1) + 3LL * n_leaves * s;
    const long long* program = meta + (n_slices + 1) + 3LL * n_leaves * n_slices;
    uint32_t stack[kMaxDepth];
    int sp = 0;
    for (int k = 0; k < n_prog; ++k) {
      const long long op = program[k];
      if (op >= 0) {
        stack[sp++] = leaf_mask(table + 3 * op, p, cnt, p0);
      } else if (op == -5) {
        stack[sp++] = 0u;
      } else {
        const uint32_t b = stack[--sp];
        const uint32_t a = stack[sp - 1];
        stack[sp - 1] = op == -1 ? (a & b) : op == -2 ? (a | b) : op == -3 ? (a & ~b) : (a ^ b);
      }
    }
    const uint32_t valid = cnt == kLane ? 0xFFFFu : ((1u << cnt) - 1u);
    total = __popc(stack[0] & valid);
  }
  for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  if ((threadIdx.x & 31) == 0 && total > 0) atomicAdd(out + s, (int)total);
}

}  // namespace

// out[s] += the anchored count of slice s for s < n_slices, with `meta`,
// `positions` and `out` on the device as described above; 1 <= n_slices <=
// 65535, max_positions the largest |P_s| (>= 1), n_prog >= 1.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pilosa_anchored_count(const void* meta, int n_slices, int n_leaves, int n_prog,
                                     int max_positions, const void* positions, void* out,
                                     void* stream) {
  if (n_slices < 1 || n_slices > 65535 || n_leaves < 1 || n_prog < 1 || max_positions < 1 ||
      meta == nullptr || positions == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((max_positions + kPerBlock - 1) / kPerBlock), (unsigned)n_slices);
  anchored_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(meta), n_slices, n_leaves, n_prog,
      static_cast<const uint32_t*>(positions), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
