// K3: the multi-query interpreter — a register machine over an opcode table,
// per slice, over a union leaf set read in place through row addresses.
//
// Replaces the XLA program _build_interp / interp_exec
// (pilosa_tpu/exec/plan.py:571,667), a lax.scan over an int32[n_ops, 4]
// instruction table vmapped over a stacked uint32[S, L, 32768] copy of the
// leaves.  Here table[s * L + l] is the address of leaf l's row in slice s,
// and the opcode table and the output selection are data, so one compiled
// kernel serves every mix of programs.
//
// Registers: 0 .. L-1 are the leaves.  An instruction (op, a, b, aux)
// with its (dest, emit): 0 and, 1 or, 2 and-not (a & ~b), 3 xor, 4 maskw
// — all-ones where bit 0 of word aux of leaf a is set, else zero (the BSI
// ripple's predicate mask, read from the leaf's row in memory) — written
// to register dest >= L; emit >= 0 reduces the result as output emit at
// once.  The host allocates dest from the table's liveness (a register is
// reused once its last reader ran), checks that every operand is a live
// register and lists the outputs that are leaves (lout: (leaf, output)).
//
// Reduces per output j: 0 count — out int32[S, k], popcounts; 1 row — out
// int32[S, k, words], the rows; 2 total — out uint64[k], popcounts over
// every slice.  out must be zeroed by the caller for count and total.
//
// Bound: memory.  Each leaf row is read once per launch (16 programs over 8
// union leaves at 954 slices: 1.0 GB, 0.30 ms at 3.35 TB/s); the ops run on
// the register file in shared memory and write nothing to device memory
// but the reduces.
//
// Design: one block of one warp per (chunk of a row, slice); a chunk is
// 1/16 of the row, walked tile by tile.  A tile is 32 x VEC words, VEC 4
// (16-byte copies and shared-memory accesses a lane) unless the registers
// need a narrower one.  Dynamic shared memory holds the instructions, the
// leaf outputs, the leaves' row addresses, a count per (output, lane), the
// leaf registers twice (the tile being run and the next one, loading) and
// the P physical op registers (the liveness keeps P small: the 16-program
// storm table of 31 ops over 8 leaves needs 3, and takes 13 KiB at VEC 4).
// Lane t owns words t*VEC .. t*VEC+VEC-1 of every register: it copies them
// from each leaf with cp.async (a warp reads 32 x VEC x 4 contiguous
// bytes), so the next tile's copies are in flight while the table runs
// over this one, and adds each output's popcount to its own count; no lane
// reads another lane's words.  At the end the warp sums each output's
// counts and one lane adds them to device memory with an integer atomic
// (order-free).  The kernel allocates nothing and launches on the caller's
// stream; the launcher returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kCount = 0, kRow = 1, kTotal = 2 };
enum Op { kAnd = 0, kOr = 1, kAndNot = 2, kXor = 3, kMaskW = 4 };

constexpr int kMaxSmem = 232448;  // 227 KiB a block on Hopper
constexpr int kChunks = 16;       // blocks a row is split into
constexpr int kLanes = 32;

template <int VEC>
struct alignas(4 * VEC) Words {
  unsigned w[VEC];
};

// Shared-memory layout of a block, in bytes: the instructions (int4) and
// their (dest, emit) (int2), the leaf outputs (int2), the leaves' row
// addresses, the counts (not for row), the two leaf buffers and the op
// registers.
struct Layout {
  size_t meta, lout, rows, cnt, regs, total;
};

__host__ __device__ inline Layout layout(int n_leaves, int n_ops, int n_phys, int n_lout, int k,
                                         int red, int vec) {
  Layout o;
  o.meta = (size_t)n_ops * 16;
  o.lout = o.meta + (size_t)n_ops * 8;
  o.rows = o.lout + (size_t)n_lout * 8;
  o.cnt = o.rows + (size_t)n_leaves * 8;
  o.regs = (o.cnt + (red != kRow ? (size_t)k * kLanes * 4 : 0) + 15) / 16 * 16;
  o.total = o.regs + (size_t)(2 * n_leaves + n_phys) * kLanes * vec * 4;
  return o;
}

template <int RED, int VEC>
__device__ __forceinline__ void emit(const Words<VEC>& v, int j, int k, int s, int w0,
                                     unsigned* cnt, int lane, void* out, int words) {
  if (RED == kRow) {
    *reinterpret_cast<Words<VEC>*>(static_cast<unsigned*>(out) +
                                   ((long long)s * k + j) * words + w0) = v;
  } else {
    unsigned c = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) c += __popc(v.w[e]);
    cnt[j * kLanes + lane] += c;
  }
}

template <int RED, int VEC>
__global__ void __launch_bounds__(kLanes)
interp_kernel(const long long* __restrict__ table, int n_leaves, const int* __restrict__ meta,
              int n_ops, int n_phys, int n_lout, int k, int words, int tiles_per_block,
              void* __restrict__ out) {
  using W = Words<VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(n_leaves, n_ops, n_phys, n_lout, k, RED, VEC);
  int4* sprog = reinterpret_cast<int4*>(smem);
  int2* smeta = reinterpret_cast<int2*>(smem + lay.meta);
  int2* slout = reinterpret_cast<int2*>(smem + lay.lout);
  const unsigned** srows = reinterpret_cast<const unsigned**>(smem + lay.rows);
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + lay.cnt);
  W* leaves = reinterpret_cast<W*>(smem + lay.regs);  // [2][n_leaves][32]
  W* ops = leaves + 2 * n_leaves * kLanes;             // [n_phys][32], register L + p
  const int lane = threadIdx.x;
  const int s = blockIdx.y;
  const int4* gprog = reinterpret_cast<const int4*>(meta);
  const int2* gmeta = reinterpret_cast<const int2*>(meta + 4 * n_ops);
  const int2* glout = gmeta + n_ops;
  for (int i = lane; i < n_ops; i += kLanes) {
    sprog[i] = __ldg(gprog + i);
    smeta[i] = __ldg(gmeta + i);
  }
  for (int i = lane; i < n_lout; i += kLanes) slout[i] = __ldg(glout + i);
  for (int l = lane; l < n_leaves; l += kLanes) {
    srows[l] = reinterpret_cast<const unsigned*>(__ldg(table + (long long)s * n_leaves + l));
  }
  if (RED != kRow) {
    for (int j = lane; j < k * kLanes; j += kLanes) cnt[j] = 0;
  }
  __syncwarp();

  const int first = blockIdx.x * tiles_per_block;
  auto fetch = [&](int tile, int buf) {
    const int w0 = (first + tile) * kLanes * VEC + lane * VEC;
    W* dst = leaves + buf * n_leaves * kLanes + lane;
    for (int l = 0; l < n_leaves; ++l) {
      __pipeline_memcpy_async(dst + l * kLanes, srows[l] + w0, sizeof(W));
    }
    __pipeline_commit();
  };
  fetch(0, 0);
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles_per_block) {
      fetch(tile + 1, buf ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    const int w0 = (first + tile) * kLanes * VEC + lane * VEC;
    const W* leaf = leaves + buf * n_leaves * kLanes + lane;
    W* reg = ops + lane;  // register r >= n_leaves is reg[(r - n_leaves) * kLanes]
    for (int i = 0; i < n_ops; ++i) {
      const int4 ins = sprog[i];
      const int2 de = smeta[i];
      W v;
      if (ins.x == kMaskW) {
        const unsigned m = (__ldg(srows[ins.y] + ins.w) & 1u) ? 0xFFFFFFFFu : 0u;
#pragma unroll
        for (int e = 0; e < VEC; ++e) v.w[e] = m;
      } else {
        const W a = ins.y < n_leaves ? leaf[ins.y * kLanes] : reg[(ins.y - n_leaves) * kLanes];
        const W b = ins.z < n_leaves ? leaf[ins.z * kLanes] : reg[(ins.z - n_leaves) * kLanes];
        switch (ins.x) {
          case kAnd:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = a.w[e] & b.w[e];
            break;
          case kOr:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = a.w[e] | b.w[e];
            break;
          case kAndNot:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = a.w[e] & ~b.w[e];
            break;
          default:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = a.w[e] ^ b.w[e];
            break;
        }
      }
      reg[(de.x - n_leaves) * kLanes] = v;
      if (de.y >= 0) emit<RED, VEC>(v, de.y, k, s, w0, cnt, lane, out, words);
    }
    for (int i = 0; i < n_lout; ++i) {
      const int2 lo = slout[i];
      emit<RED, VEC>(leaf[lo.x * kLanes], lo.y, k, s, w0, cnt, lane, out, words);
    }
  }
  if (RED == kRow) return;
  __syncwarp();
  // A block covers 1/16 of a row (65,536 bits): its sums are exact in int.
  for (int j = 0; j < k; ++j) {
    const unsigned c = __reduce_add_sync(0xffffffffu, cnt[j * kLanes + lane]);
    if (lane == 0 && c != 0) {
      if (RED == kCount) {
        atomicAdd(static_cast<int*>(out) + (long long)s * k + j, (int)c);
      } else {
        atomicAdd(static_cast<unsigned long long*>(out) + j, (unsigned long long)c);
      }
    }
  }
}

template <int RED, int VEC>
int launch(const long long* table, int n_slices, int n_leaves, const int* meta, int n_ops,
           int n_phys, int n_lout, int k, int words, void* out, cudaStream_t s) {
  const size_t smem = layout(n_leaves, n_ops, n_phys, n_lout, k, RED, VEC).total;
  cudaError_t err = cudaFuncSetAttribute(
      interp_kernel<RED, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = words / (kLanes * VEC);
  const dim3 grid((unsigned)kChunks, (unsigned)n_slices);
  interp_kernel<RED, VEC><<<grid, kLanes, smem, s>>>(table, n_leaves, meta, n_ops, n_phys,
                                                     n_lout, k, words, tiles / kChunks, out);
  return (int)cudaGetLastError();
}

template <int RED>
int launch_vec(int vec, const long long* table, int n_slices, int n_leaves, const int* meta,
               int n_ops, int n_phys, int n_lout, int k, int words, void* out, cudaStream_t s) {
  switch (vec) {
    case 4: return launch<RED, 4>(table, n_slices, n_leaves, meta, n_ops, n_phys, n_lout, k, words, out, s);
    case 2: return launch<RED, 2>(table, n_slices, n_leaves, meta, n_ops, n_phys, n_lout, k, words, out, s);
    default: return launch<RED, 1>(table, n_slices, n_leaves, meta, n_ops, n_phys, n_lout, k, words, out, s);
  }
}

}  // namespace

// The widest lane vector (4, 2 or 1 words) whose block fits its shared
// memory for this table and reduce, or 0 when none does.
extern "C" int pilosa_interp_vec(int n_leaves, int n_ops, int n_phys, int n_lout, int k,
                                 int reduce) {
  for (int vec = 4; vec >= 1; vec >>= 1) {
    if (layout(n_leaves, n_ops, n_phys, n_lout, k, reduce, vec).total <= (size_t)kMaxSmem) {
      return vec;
    }
  }
  return 0;
}

// Run the n_ops allocated instructions of meta (int32, device: [n_ops, 4]
// instructions, [n_ops, 2] (dest, emit), [n_lout, 2] leaf outputs; n_phys
// op registers) over n_slices slices of n_leaves leaves (table: int64
// device row addresses, 16-byte aligned rows of `words` words, words a
// multiple of 2,048) and reduce the k outputs with reduce 0 count, 1 row or
// 2 total into out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pilosa_interp(const void* table, int n_slices, int n_leaves, const void* meta,
                             int n_ops, int n_phys, int n_lout, int k, int words, int reduce,
                             void* out, void* stream) {
  if (n_slices <= 0 || n_slices > 65535 || n_leaves <= 0 || n_ops < 0 || n_phys < 0 ||
      n_lout < 0 || k <= 0 || words <= 0 || words % (kLanes * 4 * kChunks) != 0 ||
      reduce < kCount || reduce > kTotal) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = pilosa_interp_vec(n_leaves, n_ops, n_phys, n_lout, k, reduce);
  if (vec == 0) return (int)cudaErrorInvalidValue;
  const long long* tab = static_cast<const long long*>(table);
  const int* m = static_cast<const int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reduce) {
    case kCount: return launch_vec<kCount>(vec, tab, n_slices, n_leaves, m, n_ops, n_phys, n_lout, k, words, out, s);
    case kRow: return launch_vec<kRow>(vec, tab, n_slices, n_leaves, m, n_ops, n_phys, n_lout, k, words, out, s);
    default: return launch_vec<kTotal>(vec, tab, n_slices, n_leaves, m, n_ops, n_phys, n_lout, k, words, out, s);
  }
}
