// K2: the fused tree eval — one bitmap tree over every slice of a node,
// its leaf rows read in place through a table of row addresses.
//
// Replaces the XLA programs _eval_expr / _make_fn / _build_batched /
// _build_total_count (pilosa_tpu/exec/plan.py:179,298,810,779), which fold
// an Intersect/Union/Difference/Xor tree over a stacked uint32[S, L, 32768]
// copy of the leaf rows.  Here nothing is stacked: table[s * L + l] is the
// address of leaf l's row in slice s (a row of a fragment's mirror, a
// scratch row, or a shared zero row), and the tree is a postfix program:
// op >= 0 pushes that leaf's row, -1 and, -2 or, -3 and-not, -4 xor pop b
// then a and push (a op b), -5 pushes the empty row.
//
// Reduces: 0 count — out is int32[S], the popcount of slice s's result (a
// slice-row holds at most 2^20 bits: int32 is exact); 1 row — out is
// int32[S, words], the result rows; 2 total — out is one uint64, the
// popcount over every slice (64-bit atomics: no limbs).  The launcher
// zeroes out for count and total on the stream itself.
//
// Bound: bytes.  The kernel reads each pushed leaf row once (two leaves
// over 954 slices are 250 MB, 75 us at 3.35 TB/s) and writes 4 bytes a
// slice (count), 8 bytes (total) or the result rows (row: 375 MB in all,
// 112 us).  Per 16-byte vector it runs a few bitwise ops and four __popc:
// an H100 issues some 9 thread-instructions for each byte its memory
// delivers, and this kernel spends under one.
//
// What held the first design (86% of the bound in count and row mode)
// back, and what this one does about it:
// 1. One load in flight per thread: a leaf's 16 bytes went straight into
//    an operand stack in shared memory, so the warp waited for each load
//    before it read the next program entry.  Here a thread issues every
//    leaf's loads for its U vectors (U = 4 up to 4 pushes, 2 up to 8)
//    into registers before it evaluates anything: 8 to 16 independent
//    16-byte loads in flight a thread.
// 2. A warp ceiling: the stack took 16 KiB of shared memory a 128-thread
//    block (14 blocks an SM).  Here the operands live in registers (54
//    for two leaves: 9 blocks an SM) and a block's shared memory is 16
//    bytes.
// 3. One block per 2,048-word tile (15,264 blocks at 954 slices, 8.3
//    waves).  Kept, after measuring the alternatives on an H100 SXM (row
//    mode at 954 slices x 2 leaves): persistent blocks each walking a
//    contiguous range of (slice, tile) items took 0.131 ms, in a strided
//    order 0.129, taking items in order from an atomic counter 0.125, and
//    one block a tile 0.124; count mode 0.081 against 0.080.  Blocks that
//    run together should read neighbouring tiles (a persistent range
//    spreads ~1,000 streams over every mirror at once), and the block
//    scheduler balances the tail better than a static split.  The same
//    walk with each leaf's tile bulk-copied into a shared-memory ring by a
//    producer warp (tools/tree_eval_tma.cu) took 0.130 and 0.0815.
// 4. The reduction: one atomic a block, onto one 64-bit address for
//    total, and a separate zeroing launch.  The atomics are kept: the
//    total mode runs as fast as count.  The zeroing is one memset the
//    launcher puts on the stream (an order-free sum across blocks needs
//    its memory in a known state before the first block arrives).
// 5. Row stores went through L2 with default caching while the leaves
//    streamed.  Here they are 16-byte streaming stores (st.global.cs).
//
// The fast variant (up to 8 leaf pushes) takes the program resolved on the
// host into fixed register slots: push k loads into slot k, and step j
// sets slot a[j] = slot a[j] op[j] slot b[j] (a < b: the value under the
// top of the stack lives in the slot of its first push).  The kernel is
// specialised on the push count P, and each step picks its (a, b) pair by
// a warp-uniform branch among the P(P-1)/2 pairs written out at compile
// time, so no register array is indexed at run time; the steps travel
// packed in one 64-bit parameter.  The result is slot 0.  The general
// variant (more pushes, a stack of at most 8) runs the postfix program
// from device memory over a stack of 8 slots in registers, each push and
// op placed by a uniform branch on the stack depth.  The kernel allocates
// nothing and launches on the caller's stream; the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPush = 8;  // the fast variant's leaf pushes
constexpr int kMaxDepth = 8;  // the general variant's stack
constexpr int kGeneralU = 2;
constexpr int kRowQuantum = kThreads * 4 * 4;  // words: the largest tile

enum Reduce { kCount = 0, kRow = 1, kTotal = 2 };
enum Op { kAnd = -1, kOr = -2, kAndNot = -3, kXor = -4, kZero = -5 };

struct Params {
  const long long* table;  // [S, L] row addresses
  void* out;
  const int* prog;  // general variant: the postfix program (device)
  // Fast variant: step j is byte j, (a * 8 + b) << 2 | (-op - 1).
  unsigned long long steps;
  int leaf[kMaxPush];  // fast variant: push k's leaf column, or -1
  int n_leaves, prog_len, vecs;  // vecs: 16-byte vectors a row
};

__device__ __forceinline__ unsigned popc4(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// x = x op y over U vectors (op uniform across the grid).
template <int U>
__device__ __forceinline__ void apply(int op, uint4 (&x)[U], const uint4 (&y)[U]) {
  switch (op) {
    case kAnd:
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = make_uint4(x[u].x & y[u].x, x[u].y & y[u].y, x[u].z & y[u].z, x[u].w & y[u].w);
      break;
    case kOr:
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = make_uint4(x[u].x | y[u].x, x[u].y | y[u].y, x[u].z | y[u].z, x[u].w | y[u].w);
      break;
    case kAndNot:
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = make_uint4(x[u].x & ~y[u].x, x[u].y & ~y[u].y, x[u].z & ~y[u].z,
                          x[u].w & ~y[u].w);
      break;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = make_uint4(x[u].x ^ y[u].x, x[u].y ^ y[u].y, x[u].z ^ y[u].z, x[u].w ^ y[u].w);
      break;
  }
}

// The block's result tile r (U vectors a thread, vector v + u * kThreads
// of slice s): the row's words streamed out, or the tile's popcount
// summed over the block and added by one thread.
template <int RED, int U>
__device__ __forceinline__ void reduce_tile(const Params& p, int s, int v, const uint4 (&r)[U]) {
  if (RED == kRow) {
    uint4* o = reinterpret_cast<uint4*>(p.out) + (long long)s * p.vecs + v;
#pragma unroll
    for (int u = 0; u < U; ++u) __stcs(o + u * kThreads, r[u]);
    return;
  }
  __shared__ unsigned sums[kWarps];
  unsigned x = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) x += popc4(r[u]);
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    // A tile holds at most 65,536 bits: 32 bits are exact.
    unsigned t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sums[w];
    if (t == 0) return;
    if (RED == kCount) {
      atomicAdd(static_cast<int*>(p.out) + s, (int)t);
    } else {
      atomicAdd(static_cast<unsigned long long*>(p.out), (unsigned long long)t);
    }
  }
}

template <int RED, int P, int U>
__global__ void __launch_bounds__(kThreads)
tree_eval_fast_kernel(const __grid_constant__ Params p) {
  constexpr int TV = kThreads * U;  // vectors of a tile
  const int tpr = p.vecs / TV;
  const int s = blockIdx.x / tpr;
  const int v = (blockIdx.x % tpr) * TV + threadIdx.x;
  const long long* t = p.table + (long long)s * p.n_leaves;
  // Every load first: P x U independent 16-byte loads in flight.
  uint4 st[P][U];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int l = p.leaf[k];
    const uint4* row = l >= 0 ? reinterpret_cast<const uint4*>(__ldg(t + l)) : nullptr;
#pragma unroll
    for (int u = 0; u < U; ++u)
      st[k][u] = row ? __ldg(row + v + u * kThreads) : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned long long code = p.steps;
#pragma unroll 1
  for (int j = 0; j < P - 1; ++j, code >>= 8) {
    const int op = -1 - (int)(code & 3);
    const int pair = (int)(code >> 2) & 63;
#pragma unroll
    for (int A = 0; A < P - 1; ++A) {
#pragma unroll
      for (int B = A + 1; B < P; ++B) {
        if (pair == A * 8 + B) apply<U>(op, st[A], st[B]);
      }
    }
  }
  reduce_tile<RED, U>(p, s, v, st[0]);
}

template <int RED>
__global__ void __launch_bounds__(kThreads)
tree_eval_general_kernel(const __grid_constant__ Params p) {
  constexpr int U = kGeneralU;
  constexpr int TV = kThreads * U;
  const int tpr = p.vecs / TV;
  const int s = blockIdx.x / tpr;
  const int v = (blockIdx.x % tpr) * TV + threadIdx.x;
  const long long* t = p.table + (long long)s * p.n_leaves;
  uint4 st[kMaxDepth][U];
  int sp = 0;
  for (int e = 0; e < p.prog_len; ++e) {
    const int op = __ldg(p.prog + e);
    if (op >= 0 || op == kZero) {
      const uint4* row = op >= 0 ? reinterpret_cast<const uint4*>(__ldg(t + op)) : nullptr;
#pragma unroll
      for (int D = 0; D < kMaxDepth; ++D) {
        if (sp == D) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            st[D][u] = row ? __ldg(row + v + u * kThreads) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      ++sp;
    } else {
#pragma unroll
      for (int D = 2; D <= kMaxDepth; ++D) {
        if (sp == D) apply<U>(op, st[D - 2], st[D - 1]);
      }
      --sp;
    }
  }
  reduce_tile<RED, U>(p, s, v, st[0]);
}

// One block per tile of U x 128 vectors: n_slices x tiles a row blocks.
template <typename K>
void launch(K kernel, int u, const Params& p, int n_slices, cudaStream_t stream) {
  const long long blocks = (long long)n_slices * (p.vecs / (kThreads * u));
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
}

template <int RED, int P>
void launch_fast(const Params& p, int n_slices, cudaStream_t stream) {
  constexpr int U = P <= 4 ? 4 : 2;
  launch(tree_eval_fast_kernel<RED, P, U>, U, p, n_slices, stream);
}

template <int RED>
int launch_red(const Params& p, int n_push, int n_slices, cudaStream_t stream) {
  switch (n_push) {
    case 0: launch(tree_eval_general_kernel<RED>, kGeneralU, p, n_slices, stream); break;
    case 1: launch_fast<RED, 1>(p, n_slices, stream); break;
    case 2: launch_fast<RED, 2>(p, n_slices, stream); break;
    case 3: launch_fast<RED, 3>(p, n_slices, stream); break;
    case 4: launch_fast<RED, 4>(p, n_slices, stream); break;
    case 5: launch_fast<RED, 5>(p, n_slices, stream); break;
    case 6: launch_fast<RED, 6>(p, n_slices, stream); break;
    case 7: launch_fast<RED, 7>(p, n_slices, stream); break;
    case 8: launch_fast<RED, 8>(p, n_slices, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Evaluate the tree over n_slices slices of n_leaves leaves (table: int64
// device addresses, 16-byte aligned rows of `words` words, a multiple of
// 2,048) with reduce 0 count, 1 row or 2 total into out.  The tree is
// `slots` (host memory, the fast variant's resolved program: [P, leaf[8],
// op[7], a[7], b[7]], 1 <= P <= 8, each leaf -1 or a column, each step
// 0 <= a < b < P) or, when slots is null, `program` (device memory,
// prog_len postfix entries whose stack never passes 8 — the host checks
// it; the general variant).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int pilosa_tree_eval(const void* table, int n_slices, int n_leaves, const int* slots,
                                const void* program, int prog_len, int words, int reduce,
                                void* out, void* stream) {
  if (n_slices <= 0 || n_leaves <= 0 || words <= 0 || words % kRowQuantum != 0 ||
      (long long)n_slices * (words / (kThreads * 4 * 2)) > 0x7FFFFFFFLL || reduce < kCount ||
      reduce > kTotal) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.table = static_cast<const long long*>(table);
  p.out = out;
  p.n_leaves = n_leaves;
  p.vecs = words / 4;
  int n_push = 0;
  if (slots != nullptr) {
    n_push = slots[0];
    if (n_push < 1 || n_push > kMaxPush) return (int)cudaErrorInvalidValue;
    const int* leaf = slots + 1;
    const int* op = leaf + kMaxPush;
    const int* a = op + kMaxPush - 1;
    const int* b = a + kMaxPush - 1;
    for (int k = 0; k < kMaxPush; ++k) {
      p.leaf[k] = k < n_push ? leaf[k] : -1;
      if (p.leaf[k] < -1 || p.leaf[k] >= n_leaves) return (int)cudaErrorInvalidValue;
    }
    for (int j = 0; j < n_push - 1; ++j) {
      if (op[j] < kXor || op[j] > kAnd || a[j] < 0 || b[j] <= a[j] || b[j] >= n_push)
        return (int)cudaErrorInvalidValue;
      p.steps |= (unsigned long long)(((a[j] * 8 + b[j]) << 2) | (-op[j] - 1)) << (8 * j);
    }
  } else {
    if (program == nullptr || prog_len <= 0) return (int)cudaErrorInvalidValue;
    p.prog = static_cast<const int*>(program);
    p.prog_len = prog_len;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reduce != kRow) {
    const size_t bytes = reduce == kCount ? (size_t)n_slices * 4 : 8;
    const cudaError_t rc = cudaMemsetAsync(out, 0, bytes, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  int rc = 0;
  switch (reduce) {
    case kCount: rc = launch_red<kCount>(p, n_push, n_slices, s); break;
    case kRow: rc = launch_red<kRow>(p, n_push, n_slices, s); break;
    default: rc = launch_red<kTotal>(p, n_push, n_slices, s); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
