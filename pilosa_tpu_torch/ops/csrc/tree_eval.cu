// K2: the fused tree eval — one bitmap tree over every slice of a node,
// its leaf rows read in place through a table of row addresses.
//
// Replaces the XLA programs _eval_expr / _make_fn / _build_batched /
// _build_total_count (pilosa_tpu/exec/plan.py:179,298,810,779), which fold
// an Intersect/Union/Difference/Xor tree over a stacked uint32[S, L, 32768]
// copy of the leaf rows.  Here nothing is stacked: table[s * L + l] is the
// address of leaf l's row in slice s (a row of a fragment's mirror, a
// scratch row, or a shared zero row), and the tree is a postfix program in
// device memory: op >= 0 pushes that leaf's row, -1 and, -2 or, -3 and-not,
// -4 xor pop b then a and push (a op b), -5 pushes the empty row.
//
// Reduces: 0 count — out is int32[S], out[s] += popcount of slice s's
// result (a slice-row holds at most 2^20 bits: int32 is exact); 1 row —
// out is int32[S, words], the result rows; 2 total — out is one uint64,
// the popcount over every slice (64-bit atomics: no limbs).  out must be
// zeroed by the caller for count and total.
//
// Bound: memory.  The kernel reads each distinct leaf row once (L x S x
// 128 KiB; two leaves over 954 slices are 250 MB, 75 us at 3.35 TB/s) and
// writes 4 bytes a slice (count), 8 bytes (total) or the result rows (row).
// Per 16-byte vector it runs the program (a few bitwise ops) and four
// __popc; no inner result row is written to memory.
//
// Design: one block per (word tile of 2,048 words, slice); 128 threads,
// each loading 16 bytes (uint4) of a row per step, so a warp reads 512
// contiguous bytes.  The program is read from memory (uniform across the
// block: no divergence) and each thread keeps its operand stack in shared
// memory, MAX_DEPTH (8) rows of one uint4 per thread (16 KiB, so that 14
// blocks fit an SM and keep enough loads in flight); the host checks the
// depth, and deeper trees run on K3.  The block reduces with warp
// shuffles, and one thread adds its partial with an integer atomic
// (order-free: the result is deterministic).
// The kernel allocates nothing and launches on the caller's stream; the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileVecs = 512;  // 2,048 words
constexpr int kMaxDepth = 8;

enum Reduce { kCount = 0, kRow = 1, kTotal = 2 };
enum Op { kAnd = -1, kOr = -2, kAndNot = -3, kXor = -4, kZero = -5 };

__device__ __forceinline__ uint4 apply_op(int op, uint4 a, uint4 b) {
  switch (op) {
    case kAnd: return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case kOr: return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case kAndNot: return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    default: return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
}

template <int RED>
__global__ void __launch_bounds__(kThreads)
tree_eval_kernel(const long long* __restrict__ table, int n_leaves,
                 const int* __restrict__ program, int prog_len, int vecs_per_row,
                 void* __restrict__ out) {
  __shared__ uint4 stack[kMaxDepth][kThreads];
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const long long* rows = table + (long long)s * n_leaves;
  const int begin = blockIdx.x * kTileVecs;
  int end = begin + kTileVecs;
  if (end > vecs_per_row) end = vecs_per_row;

  long long cnt = 0;
  for (int v = begin + t; v < end; v += kThreads) {
    int sp = 0;
    for (int i = 0; i < prog_len; ++i) {
      const int op = __ldg(program + i);
      if (op >= 0) {
        const uint4* row = reinterpret_cast<const uint4*>(__ldg(rows + op));
        stack[sp++][t] = __ldg(row + v);
      } else if (op == kZero) {
        stack[sp++][t] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint4 b = stack[--sp][t];
        stack[sp - 1][t] = apply_op(op, stack[sp - 1][t], b);
      }
    }
    const uint4 r = stack[0][t];
    if (RED == kRow) {
      reinterpret_cast<uint4*>(out)[(long long)s * vecs_per_row + v] = r;
    } else {
      cnt += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
    }
  }
  if (RED == kRow) return;

  // A block covers at most 2,048 words (65,536 bits): int is exact.
  int c = (int)cnt;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int warp_sums[kThreads / 32];
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (t == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    if (sum != 0) {
      if (RED == kCount) {
        atomicAdd(static_cast<int*>(out) + s, sum);
      } else {
        atomicAdd(static_cast<unsigned long long*>(out), (unsigned long long)sum);
      }
    }
  }
}

}  // namespace

// Evaluate the postfix program over n_slices slices of n_leaves leaves
// (table: int64 device addresses, 16-byte aligned rows of `words` words;
// program: int32 device array of prog_len entries whose stack never passes
// 8 — the host checks it) with reduce 0 count, 1 row or 2 total into out.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_tree_eval(const void* table, int n_slices, int n_leaves,
                                const void* program, int prog_len, int words,
                                int reduce, void* out, void* stream) {
  if (n_slices <= 0 || n_slices > 65535 || n_leaves <= 0 || prog_len <= 0 ||
      words <= 0 || words % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int vecs = words / 4;
  const dim3 grid((unsigned)((vecs + kTileVecs - 1) / kTileVecs), (unsigned)n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(table);
  const int* prog = static_cast<const int*>(program);
  switch (reduce) {
    case kCount:
      tree_eval_kernel<kCount><<<grid, kThreads, 0, s>>>(tab, n_leaves, prog, prog_len, vecs, out);
      break;
    case kRow:
      tree_eval_kernel<kRow><<<grid, kThreads, 0, s>>>(tab, n_leaves, prog, prog_len, vecs, out);
      break;
    case kTotal:
      tree_eval_kernel<kTotal><<<grid, kThreads, 0, s>>>(tab, n_leaves, prog, prog_len, vecs, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
