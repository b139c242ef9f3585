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
// Registers: 0 .. L-1 are the leaves, L + p the p-th physical op register.
// The host (ops/interp.py: allocate) drops dead instructions and encodes
// each live one as an int4 (code, a, b, dest): code holds the op (0 and,
// 1 or, 2 and-not a & ~b, 3 xor, 4 maskw, 5 not-and ~a & b: an and-not
// whose operands the host swapped), FWD (the first operand is the
// previous instruction's result, which the kernel holds in registers),
// STORE (write the result to register dest: a later instruction reads it
// other than forwarded) and emit + 1 (reduce the result as output emit at
// once).  A maskw is all-ones where bit 0 of word aux of leaf a is set,
// else zero (the BSI ripple's predicate mask): its b is the index of its
// (leaf, aux) pair in the mask list, whose values the producer reads from
// the rows in memory.  The leaf outputs (lout: (leaf, output)) are
// reduced after the program.
//
// Reduces per output j: 0 count — out int32[S, k], popcounts; 1 row — out
// int32[S, k, words], the rows; 2 total — out uint64[k], popcounts over
// every slice.  out must be zeroed by the caller for count and total.
//
// Bound: memory.  Each leaf row is read once per launch (16 programs over 8
// union leaves at 954 slices: 1.0 GB, 0.30 ms at 3.35 TB/s); the ops write
// nothing to device memory but the reduces.  In practice the SMs bound it:
// the storm table takes as long from L2 as from device memory.  Each
// instruction costs a few dozen warp instructions of decode and a chain
// of dependent latencies (an operand load, the op's branch, the emit)
// however many words it covers, and each operand that is not forwarded is
// a shared-memory read (the storm table reads its 8 leaves 45 times, ~250
// bytes a word against 128 a clock an SM).  So the design keeps many warps
// resident, each carrying up to 8 words a lane through an instruction.
//
// Design: persistent blocks, as many as fit on the card, each walking one
// contiguous range of the launch's (slice, tile) items, so a 16-slice
// launch fills the card and a 954-slice one has no tail wave.  A block is
// W consumer warps (1, 2, 4 or 8) and one producer warp.  A tile is W x 32
// x VEC words of every register (VEC 1, 2, 4 or 8); warp w owns VEC words a
// lane of it, read and written as 4-, 8- or 16-byte shared-memory accesses
// (two independent 16-byte vectors a lane at VEC 8).  The producer fills
// the block's leaf buffer: for each tile, the maskw values, then one
// cp.async.bulk (TMA, global -> shared) per leaf completing on the full
// mbarrier; the consumer warps release the buffer through the empty
// mbarrier, so no lane issues a copy.  The buffer holds one tile: a ring
// of two to four would double to quadruple a block's shared memory and cut
// the blocks an SM holds, and the blocks' single buffers already overlap
// one another's loads while the extra warps hide the instructions'
// latency (on an H100 SXM the storm table at 954 slices took 0.52 ms with
// two stages, 0.42 with one, and no table ran faster with more).  Shared
// memory holds once a block: the instructions, the leaf outputs, the two
// barriers, the maskw values (four copies, so a 16-byte load broadcasts
// one), a count per (warp, output), the leaf buffer and the op registers.
// Every leaf's tile is copied, also a leaf that only maskw reads (the BSI
// depth-31 table copies 35 rows a slice where it needs 33).  Each consumer
// warp runs the table over its words of a tile, two instructions a round,
// each fetched a round ahead: the first operand is the previous result, or
// a predicated load into its registers; the second a load (a maskw loads
// its value, as and(m, m)); the result's store is predicated; nothing but
// the op and the emit branches.  The op is a switch, or in the branch-free
// variant the algebraic normal form, three logic ops a word: with few
// words in flight the switch's branch costs more than the extra ops (on an
// H100 SXM the BSI depth-31 table at 954 slices took 12.9 ms branch-free
// against 16.3 with the switch, while the storm table took 0.53 against
// 0.42).
// An emitted count is summed over the warp (__reduce_add_sync) and added
// by one lane to the warp's count with a shared atomic nobody waits for;
// when a warp's next tile is in another slice, it adds its counts to
// device memory with integer atomics (order-free, so the result is exact).
// The host picks (W, VEC) and the variant from the table
// (ops/interp.py: launch_plan, measured by tools/torch_interp_shapes.py);
// pilosa_interp_smem gives the shared memory of any shape.  The kernel
// allocates nothing and launches on the caller's stream; the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kCount = 0, kRow = 1, kTotal = 2 };
// kNotAnd (~a & b) is an and-not whose operands the host swapped.
enum Op { kAnd = 0, kOr = 1, kAndNot = 2, kXor = 3, kMaskW = 4, kNotAnd = 5 };
constexpr int kFwd = 1 << 3;
constexpr int kStore = 1 << 5;
constexpr int kEmitShift = 8;  // code >> 8 is emit + 1 (0: no output)
// The kernel variant that runs the op without a branch (else a switch).
constexpr int kBranchFree = 1;

constexpr int kMaxSmem = 232448;  // 227 KiB a block on Hopper
constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;      // consumer warps a block
constexpr int kThreads = (kMaxWarps + 1) * kLanes;

__host__ __device__ inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// Shared-memory layout of a block, in bytes: the instructions (int4), the
// leaf outputs (int2), then 16-byte aligned the full and empty barriers,
// the maskw values (four copies each), the counts (warps x k, not for row),
// then 128-byte aligned the leaf buffer (a tile a leaf) and the op
// registers (n_phys tiles), a tile being warps x 32 x vec words.
struct Layout {
  size_t lout, bars, masks, cnt, buf, regs, total;
};

__host__ __device__ inline Layout layout(int n_leaves, int n_ops, int n_phys, int n_mask,
                                         int n_lout, int k, int red, int warps, int vec) {
  const size_t tile = (size_t)warps * kLanes * vec * 4;
  Layout o;
  o.lout = (size_t)n_ops * 16;
  o.bars = align_up(o.lout + (size_t)n_lout * 8, 16);
  o.masks = o.bars + 16;
  o.cnt = o.masks + (size_t)n_mask * 16;
  o.buf = align_up(o.cnt + (red != kRow ? (size_t)warps * k * 4 : 0), 128);
  o.regs = o.buf + (size_t)n_leaves * tile;
  o.total = o.regs + (size_t)n_phys * tile;
  return o;
}

struct Params {
  const long long* table;  // [S, L] row addresses
  const int4* prog;        // [n_ops] instructions
  const int2* masks;       // [n_mask] maskw (leaf, word)
  const int2* lout;        // [n_lout] leaf outputs (leaf, output)
  void* out;
  long long tiles;         // slices x tiles a row
  int n_leaves, n_ops, n_phys, n_mask, n_lout, k, words;
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// VEC words of a lane: NC accesses of CW words, access c at word
// c * 32 * CW + lane * CW of the warp's part of a tile.
template <int VEC>
struct Vec {
  static constexpr int CW = VEC < 4 ? VEC : 4;
  static constexpr int NC = VEC / CW;
  unsigned w[VEC];
};

// v's words from shared address `addr` (access c at addr + c * stride)
// when p, else v unchanged: a predicated load, no branch.
template <int VEC>
__device__ __forceinline__ void load_if(Vec<VEC>& v, unsigned addr, unsigned stride, int p) {
  constexpr int CW = Vec<VEC>::CW;
#pragma unroll
  for (int c = 0; c < Vec<VEC>::NC; ++c) {
    const unsigned q = addr + c * stride;
    if constexpr (CW == 4) {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
          "@p ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
          : "+r"(v.w[4 * c]), "+r"(v.w[4 * c + 1]), "+r"(v.w[4 * c + 2]), "+r"(v.w[4 * c + 3])
          : "r"(q), "r"(p)
          : "memory");
    } else if constexpr (CW == 2) {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
          "@p ld.shared.v2.u32 {%0, %1}, [%2];\n\t}"
          : "+r"(v.w[2 * c]), "+r"(v.w[2 * c + 1])
          : "r"(q), "r"(p)
          : "memory");
    } else {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
          "@p ld.shared.u32 %0, [%1];\n\t}"
          : "+r"(v.w[c])
          : "r"(q), "r"(p)
          : "memory");
    }
  }
}

// v's words to shared address `addr` (access c at addr + c * stride) when
// p: a predicated store, no branch.
template <int VEC>
__device__ __forceinline__ void store_if(unsigned addr, unsigned stride, const Vec<VEC>& v,
                                         int p) {
  constexpr int CW = Vec<VEC>::CW;
#pragma unroll
  for (int c = 0; c < Vec<VEC>::NC; ++c) {
    const unsigned q = addr + c * stride;
    if constexpr (CW == 4) {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
          "@p st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n\t}" ::"r"(q),
          "r"(v.w[4 * c]), "r"(v.w[4 * c + 1]), "r"(v.w[4 * c + 2]), "r"(v.w[4 * c + 3]),
          "r"(p)
          : "memory");
    } else if constexpr (CW == 2) {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
          "@p st.shared.v2.u32 [%0], {%1, %2};\n\t}" ::"r"(q),
          "r"(v.w[2 * c]), "r"(v.w[2 * c + 1]), "r"(p)
          : "memory");
    } else {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
          "@p st.shared.u32 [%0], %1;\n\t}" ::"r"(q),
          "r"(v.w[c]), "r"(p)
          : "memory");
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_global(unsigned* p, const Vec<VEC>& v) {
  constexpr int CW = Vec<VEC>::CW;
#pragma unroll
  for (int c = 0; c < Vec<VEC>::NC; ++c) {
    unsigned* q = p + c * kLanes * CW;
    if constexpr (CW == 4) {
      *reinterpret_cast<uint4*>(q) =
          make_uint4(v.w[4 * c], v.w[4 * c + 1], v.w[4 * c + 2], v.w[4 * c + 3]);
    } else if constexpr (CW == 2) {
      *reinterpret_cast<uint2*>(q) = make_uint2(v.w[2 * c], v.w[2 * c + 1]);
    } else {
      *q = v.w[c];
    }
  }
}

// Output j of the tile: the row's words to device memory, or the warp's
// popcount (summed over the warp) added to the warp's count of j by one
// lane, with a shared atomic whose result no one waits for.
template <int RED, int VEC>
__device__ __forceinline__ void emit(const Vec<VEC>& v, int j, unsigned* cnt, int lane,
                                     unsigned* orow, int words) {
  if (RED == kRow) {
    store_global<VEC>(orow + (long long)j * words, v);
    return;
  }
  unsigned c = 0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) c += __popc(v.w[e]);
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) atomicAdd(cnt + j, c);
}

// The warp's counts of slice s to device memory, and zeroed.  A warp
// counts at most one row per output between flushes (1,048,576 bits):
// exact in 32 bits.
template <int RED>
__device__ __forceinline__ void flush(unsigned* cnt, int k, int lane, int s, void* out) {
  __syncwarp();
  for (int j = lane; j < k; j += kLanes) {
    const unsigned c = cnt[j];
    if (c == 0) continue;
    if (RED == kCount) {
      atomicAdd(static_cast<int*>(out) + (long long)s * k + j, (int)c);
    } else {
      atomicAdd(static_cast<unsigned long long*>(out) + j, (unsigned long long)c);
    }
    cnt[j] = 0;
  }
  __syncwarp();
}

template <int RED, int VEC, int V>
__global__ void __launch_bounds__(kThreads)
interp_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / kLanes - 1;
  const int L = p.n_leaves;
  const Layout lay = layout(L, p.n_ops, p.n_phys, p.n_mask, p.n_lout, p.k, RED, warps, VEC);
  int4* sprog = reinterpret_cast<int4*>(smem);
  int2* slout = reinterpret_cast<int2*>(smem + lay.lout);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + 1;
  uint4* smask = reinterpret_cast<uint4*>(smem + lay.masks);
  unsigned* scnt = reinterpret_cast<unsigned*>(smem + lay.cnt);
  unsigned* buf = reinterpret_cast<unsigned*>(smem + lay.buf);
  const int tw = warps * kLanes * VEC;  // words of a tile
  const int per_row = p.words / tw;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;

  for (int i = threadIdx.x; i < p.n_ops; i += blockDim.x) sprog[i] = __ldg(p.prog + i);
  for (int i = threadIdx.x; i < p.n_lout; i += blockDim.x) slout[i] = __ldg(p.lout + i);
  if (RED != kRow) {
    for (int i = threadIdx.x; i < warps * p.k; i += blockDim.x) scnt[i] = 0;
  }
  if (threadIdx.x == 0) {
    bar_init(full, 1);
    bar_init(empty, warps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long t0 = p.tiles * blockIdx.x / gridDim.x;
  const long long t1 = p.tiles * (blockIdx.x + 1) / gridDim.x;
  const int n_tiles = (int)(t1 - t0);
  const int s0 = (int)(t0 / per_row), c0 = (int)(t0 % per_row);

  if (warp == warps) {
    // The producer: once the consumers released the buffer, the tile's
    // maskw values (four copies each, so a 16-byte load broadcasts one),
    // then one bulk copy a leaf.
    const unsigned bytes = (unsigned)tw * 4;
    int s = s0, c = c0;
    unsigned phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      if (it > 0) bar_wait(empty, phase ^ 1u);
      const long long* rows = p.table + (long long)s * L;
      for (int m = lane; m < p.n_mask; m += kLanes) {
        const int2 mk = __ldg(p.masks + m);
        const unsigned* row = reinterpret_cast<const unsigned*>(__ldg(rows + mk.x));
        const unsigned v = (__ldg(row + mk.y) & 1u) ? 0xFFFFFFFFu : 0u;
        smask[m] = make_uint4(v, v, v, v);
      }
      __syncwarp();
      if (lane == 0) bar_expect(full, bytes * (unsigned)L);
      __syncwarp();
      for (int l = lane; l < L; l += kLanes) {
        const unsigned* row = reinterpret_cast<const unsigned*>(__ldg(rows + l));
        bulk_load(buf + (size_t)l * tw, row + c * tw, bytes, full);
      }
      if (++c == per_row) c = 0, ++s;
      phase ^= 1u;
    }
    return;
  }

  constexpr int CW = Vec<VEC>::CW;
  const int lw = warp * kLanes * VEC + lane * CW;  // the lane's first word in a tile
  const unsigned tile_b = (unsigned)tw * 4;
  const unsigned chunk_b = kLanes * CW * 4;
  const unsigned lane_b = (unsigned)lw * 4;
  // Shared addresses: register r >= L of this lane at reg_a + r * tile_b.
  const unsigned reg_a = saddr(smem + lay.regs) - (unsigned)L * tile_b + lane_b;
  unsigned* cnt = scnt + warp * p.k;
  const unsigned leaf_a = saddr(buf) + lane_b;
  const unsigned mask_a = saddr(smask);
  int s = s0, c = c0, cur = -1;
  unsigned phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (RED != kRow && s != cur) {
      if (cur >= 0) flush<RED>(cnt, p.k, lane, cur, p.out);
      cur = s;
    }
    const int w0 = c * tw;
    unsigned* orow = RED == kRow ? static_cast<unsigned*>(p.out) + (long long)s * p.k * p.words +
                                       w0 + lw
                                 : nullptr;
    bar_wait(full, phase);
    Vec<VEC> prev;
#pragma unroll
    for (int e = 0; e < VEC; ++e) prev.w[e] = 0;
    // One instruction over the lane's words: the first operand forwarded
    // (prev) or read by a predicated load into prev's registers, the
    // second read (a maskw reads its value twice, broadcast), the op, the
    // store predicated.
    auto step = [&](const int4 ins) {
      const int code = ins.x;
      const int op = code & 7;
      const bool mk = op == kMaskW;
      const unsigned ma = mask_a + (unsigned)ins.z * 16u;
      const unsigned aa = mk ? ma : (ins.y < L ? leaf_a : reg_a) + ins.y * tile_b;
      const unsigned ab = mk ? ma : (ins.z < L ? leaf_a : reg_a) + ins.z * tile_b;
      const unsigned stride = mk ? 0u : chunk_b;
      Vec<VEC> b, v;
      load_if<VEC>(prev, aa, stride, !(code & kFwd));
      load_if<VEC>(b, ab, stride, 1);
      if (!(V & kBranchFree)) {
        switch (op) {
          case kOr:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = prev.w[e] | b.w[e];
            break;
          case kAndNot:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = prev.w[e] & ~b.w[e];
            break;
          case kXor:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = prev.w[e] ^ b.w[e];
            break;
          case kNotAnd:
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = ~prev.w[e] & b.w[e];
            break;
          default:  // and, maskw
#pragma unroll
            for (int e = 0; e < VEC; ++e) v.w[e] = prev.w[e] & b.w[e];
            break;
        }
      } else {
        // a op b = (a & ((b & c3) ^ c1)) ^ (b & c2), the op's algebraic
        // normal form; (c1, c2, c3) by op: and and maskw (0, 0, 1), or (1,
        // 1, 1), and-not (1, 0, 1), xor (1, 1, 0), not-and (0, 1, 1).
        const unsigned c1 = 0u - ((0x0Eu >> op) & 1u);
        const unsigned c2 = 0u - ((0x2Au >> op) & 1u);
        const unsigned c3 = 0u - ((0x37u >> op) & 1u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v.w[e] = (prev.w[e] & ((b.w[e] & c3) ^ c1)) ^ (b.w[e] & c2);
        }
      }
      store_if<VEC>(reg_a + ins.w * tile_b, chunk_b, v, code & kStore);
      const int j = (code >> kEmitShift) - 1;
      if (j >= 0) emit<RED, VEC>(v, j, cnt, lane, orow, p.words);
      prev = v;
    };
    const int last = p.n_ops > 0 ? p.n_ops - 1 : 0;
    // Two instructions a round, each fetched a round ahead.
    int4 ia = sprog[0 < last ? 0 : last], ib = sprog[1 < last ? 1 : last];
    for (int i = 0; i < p.n_ops; i += 2) {
      step(ia);
      ia = sprog[i + 2 < last ? i + 2 : last];
      if (i + 1 < p.n_ops) step(ib);
      ib = sprog[i + 3 < last ? i + 3 : last];
    }
    for (int i = 0; i < p.n_lout; ++i) {
      const int2 lo = slout[i];
      Vec<VEC> v = prev;
      load_if<VEC>(v, leaf_a + lo.x * tile_b, chunk_b, 1);
      emit<RED, VEC>(v, lo.y, cnt, lane, orow, p.words);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty);
    if (++c == per_row) c = 0, ++s;
    phase ^= 1u;
  }
  if (RED != kRow && cur >= 0) flush<RED>(cnt, p.k, lane, cur, p.out);
}

template <int RED, int VEC>
int launch(Params p, int n_slices, int warps, int variant, cudaStream_t s) {
  auto kernel = variant ? interp_kernel<RED, VEC, kBranchFree> : interp_kernel<RED, VEC, 0>;
  const size_t smem =
      layout(p.n_leaves, p.n_ops, p.n_phys, p.n_mask, p.n_lout, p.k, RED, warps, VEC).total;
  // The attribute is the most a block may take, the same for every launch,
  // so launches from several host threads do not race on it.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (warps + 1) * kLanes;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p.tiles = (long long)n_slices * (p.words / (warps * kLanes * VEC));
  const long long grid = p.tiles < (long long)sms * per_sm ? p.tiles : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int RED>
int launch_vec(Params p, int n_slices, int warps, int vec, int variant, cudaStream_t s) {
  switch (vec) {
    case 8: return launch<RED, 8>(p, n_slices, warps, variant, s);
    case 4: return launch<RED, 4>(p, n_slices, warps, variant, s);
    case 2: return launch<RED, 2>(p, n_slices, warps, variant, s);
    default: return launch<RED, 1>(p, n_slices, warps, variant, s);
  }
}

bool valid_shape(int warps, int vec, int variant) {
  return (warps == 1 || warps == 2 || warps == 4 || warps == kMaxWarps) &&
         (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
         (variant == 0 || variant == kBranchFree);
}

}  // namespace

// The shared memory, in bytes, of a block of `warps` consumer warps at
// `vec` words a lane for this table and reduce (ops/interp.py: smem_bytes
// is the same function), or -1 for a shape the kernel has no build of.
extern "C" long long pilosa_interp_smem(int n_leaves, int n_ops, int n_phys, int n_mask,
                                        int n_lout, int k, int reduce, int warps, int vec) {
  if (!valid_shape(warps, vec, 0)) return -1;
  return (long long)layout(n_leaves, n_ops, n_phys, n_mask, n_lout, k, reduce, warps, vec).total;
}

// Run the n_ops allocated instructions of meta (int32, device: [n_ops, 4]
// instructions, [n_mask, 2] maskw (leaf, word), [n_lout, 2] leaf outputs;
// n_phys op registers) over n_slices slices of n_leaves leaves (table:
// int64 device row addresses, 16-byte aligned rows of `words` words, words
// a multiple of a tile) and reduce the k outputs with reduce 0 count, 1 row
// or 2 total into out, in blocks of `warps` consumer warps at `vec` words a
// lane, the op by a switch (variant 0) or branch-free (1).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pilosa_interp(const void* table, int n_slices, int n_leaves, const void* meta,
                             int n_ops, int n_phys, int n_mask, int n_lout, int k, int words,
                             int reduce, int warps, int vec, int variant, void* out,
                             void* stream) {
  if (n_slices <= 0 || n_slices > 65535 || n_leaves <= 0 || n_ops < 0 || n_phys < 0 ||
      n_mask < 0 || n_lout < 0 || k <= 0 || words <= 0 || reduce < kCount || reduce > kTotal ||
      !valid_shape(warps, vec, variant) || words % (warps * kLanes * vec) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (pilosa_interp_smem(n_leaves, n_ops, n_phys, n_mask, n_lout, k, reduce, warps, vec) >
      kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int* m = static_cast<const int*>(meta);
  Params p;
  p.table = static_cast<const long long*>(table);
  p.prog = reinterpret_cast<const int4*>(m);
  p.masks = reinterpret_cast<const int2*>(m + 4 * n_ops);
  p.lout = p.masks + n_mask;
  p.out = out;
  p.tiles = 0;
  p.n_leaves = n_leaves, p.n_ops = n_ops, p.n_phys = n_phys, p.n_mask = n_mask;
  p.n_lout = n_lout, p.k = k, p.words = words;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reduce) {
    case kCount: return launch_vec<kCount>(p, n_slices, warps, vec, variant, s);
    case kRow: return launch_vec<kRow>(p, n_slices, warps, vec, variant, s);
    default: return launch_vec<kTotal>(p, n_slices, warps, vec, variant, s);
  }
}
