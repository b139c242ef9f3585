// K2's persistent designs, kept for tools/torch_tree_eval_ab.py beside
// the kernel the package keeps (pilosa_tpu_torch/ops/csrc/tree_eval.cu,
// one block per tile).  The C interface is that file's; only its fast
// variant (up to 8 leaf pushes, the resolved program) is written here, and
// a call without slots returns cudaErrorNotSupported.
//
// Blocks are persistent, as many as fit on the card, and each walks its
// items (a slice's tile of 128 x U vectors) in one of two orders:
// K2_STRIDED 0 a contiguous range of the launch's (slice, tile) items,
// 1 items blockIdx.x, blockIdx.x + gridDim.x, ...  Leaves reach the
// registers in one of two ways: K2_TMA 0, each lane loads its U vectors
// of every pushed leaf itself (the package kernel's loads); 1, a producer
// warp bulk-copies each leaf's tile into a three-stage shared-memory ring
// (cp.async.bulk completing on mbarriers), and each consumer lane waits
// on the stage, reads its vectors, releases the stage (one arrival a
// warp) and evaluates.  Either way the tree runs as the package's fast
// variant does, counts are flushed once per (block, slice) through a
// named barrier of the 128 evaluating threads, row results go out with
// st.global.cs, and the launcher zeroes count and total.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K2_TMA
#define K2_TMA 1
#endif
#ifndef K2_STRIDED
#define K2_STRIDED 0
#endif

namespace {

constexpr int kThreads = 128;  // evaluating threads
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kMaxPush = 8;
constexpr int kRowQuantum = kThreads * 4 * 4;

enum Reduce { kCount = 0, kRow = 1, kTotal = 2 };
enum Op { kAnd = -1, kOr = -2, kAndNot = -3, kXor = -4, kZero = -5 };

struct Slots {
  int leaf[kMaxPush];
  int op[kMaxPush - 1];
  int a[kMaxPush - 1];
  int b[kMaxPush - 1];
};

struct Params {
  const long long* table;
  void* out;
  long long items;
  int n_leaves, vecs;
  Slots slots;
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ unsigned popc4(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

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

// The block's items in order: first(), then next(i) while i < end.
struct Items {
  long long first, end, step;
};

__device__ __forceinline__ Items items_of(long long items) {
  if (K2_STRIDED) return {(long long)blockIdx.x, items, (long long)gridDim.x};
  return {items * blockIdx.x / gridDim.x, items * (blockIdx.x + 1) / gridDim.x, 1};
}

template <int RED, int P, int U>
__global__ void __launch_bounds__(kThreads + 32 * K2_TMA)
tree_eval_persistent_kernel(const __grid_constant__ Params p) {
  constexpr int TV = kThreads * U;
  constexpr unsigned kTileBytes = TV * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* buf = reinterpret_cast<uint4*>(smem);  // [kStages][P][TV] (K2_TMA)
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int steps[kMaxPush];
  __shared__ unsigned sums[2][kWarps];
  __shared__ unsigned long long tsums[kWarps];
  if (threadIdx.x == 0) {
    if (K2_TMA) {
      for (int i = 0; i < kStages; ++i) {
        bar_init(&full[i], 1);
        bar_init(&empty[i], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
#pragma unroll
    for (int j = 0; j < P - 1; ++j)
      steps[j] = (-p.slots.op[j] << 16) | (p.slots.a[j] << 8) | p.slots.b[j];
  }
  __syncthreads();
  const int tpr = p.vecs / TV;
  const Items its = items_of(p.items);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* rows[P];
  unsigned bytes = 0;
  auto new_slice = [&](int s) {
    const long long* t = p.table + (long long)s * p.n_leaves;
    bytes = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int l = p.slots.leaf[k];
      rows[k] = l >= 0 ? reinterpret_cast<const uint4*>(__ldg(t + l)) : nullptr;
      if (l >= 0) bytes += kTileBytes;
    }
  };

  if (K2_TMA && warp == kWarps) {
    // The producer: one bulk copy a pushed leaf, once the stage is free.
    if (lane != 0) return;
    int cur = -1;
    for (long long i = its.first, n = 0; i < its.end; i += its.step, ++n) {
      const int s = (int)(i / tpr), c = (int)(i % tpr);
      if (s != cur) new_slice(cur = s);
      const int st = (int)(n % kStages);
      if (n >= kStages) bar_wait(&empty[st], (unsigned)((n / kStages) & 1) ^ 1u);
      bar_expect(&full[st], bytes);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (rows[k]) bulk_load(buf + ((size_t)st * P + k) * TV, rows[k] + (size_t)c * TV,
                               kTileBytes, &full[st]);
      }
    }
    return;
  }

  int parity = 0, cur = -1;
  unsigned cnt = 0;
  unsigned long long tot = 0;
  auto flush_count = [&](int slice) {
    const unsigned w = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) sums[parity][warp] = w;
    consumers_sync();
    if (threadIdx.x == 0) {
      unsigned t = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) t += sums[parity][k];
      if (t) atomicAdd(static_cast<int*>(p.out) + slice, (int)t);
    }
    parity ^= 1;
    cnt = 0;
  };
  for (long long i = its.first, n = 0; i < its.end; i += its.step, ++n) {
    const int s = (int)(i / tpr), c = (int)(i % tpr);
    if (s != cur) {
      if (RED == kCount && cur >= 0) flush_count(cur);
      cur = s;
      if (!K2_TMA) new_slice(s);
    }
    uint4 v[P][U];
    if (K2_TMA) {
      const int st = (int)(n % kStages);
      bar_wait(&full[st], (unsigned)((n / kStages) & 1));
      const uint4* tile = buf + (size_t)st * P * TV + threadIdx.x;
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[k][u] = p.slots.leaf[k] >= 0 ? tile[k * TV + u * kThreads]
                                         : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    } else {
      const int w = c * TV + threadIdx.x;
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[k][u] = rows[k] ? __ldg(rows[k] + w + u * kThreads) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll 1
    for (int j = 0; j < P - 1; ++j) {
      const int code = steps[j];
      const int op = -(code >> 16), pair = code & 0xFFFF;
#pragma unroll
      for (int A = 0; A < P - 1; ++A) {
#pragma unroll
        for (int B = A + 1; B < P; ++B) {
          if (pair == ((A << 8) | B)) apply<U>(op, v[A], v[B]);
        }
      }
    }
    if (RED == kRow) {
      uint4* o = reinterpret_cast<uint4*>(p.out) + (long long)s * p.vecs + c * TV + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) __stcs(o + u * kThreads, v[0][u]);
    } else {
      unsigned x = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) x += popc4(v[0][u]);
      if (RED == kCount) {
        cnt += x;
      } else {
        tot += x;
      }
    }
  }
  if (RED == kCount && cur >= 0) flush_count(cur);
  if (RED == kTotal) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, off);
    if (lane == 0) tsums[warp] = tot;
    consumers_sync();
    if (threadIdx.x == 0) {
      unsigned long long t = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) t += tsums[k];
      if (t) atomicAdd(static_cast<unsigned long long*>(p.out), t);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

template <int RED, int P>
int launch(Params& p, cudaStream_t stream) {
  constexpr int U = P <= 4 ? 4 : 2;
  constexpr int smem = K2_TMA ? kStages * P * kThreads * U * 16 : 0;
  constexpr int threads = kThreads + 32 * K2_TMA;
  auto kernel = tree_eval_persistent_kernel<RED, P, U>;
  static const int per_sm = [&] {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess)
      return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) !=
        cudaSuccess)
      return 0;
    return n;
  }();
  const int sms = sm_count();
  if (per_sm <= 0 || sms <= 0) return (int)cudaErrorInvalidConfiguration;
  p.items = p.items * (p.vecs / (kThreads * U));
  long long blocks = (long long)sms * per_sm;
  if (blocks > p.items) blocks = p.items;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return 0;
}

template <int RED>
int launch_red(Params& p, int n_push, cudaStream_t stream) {
  switch (n_push) {
    case 1: return launch<RED, 1>(p, stream);
    case 2: return launch<RED, 2>(p, stream);
    case 3: return launch<RED, 3>(p, stream);
    case 4: return launch<RED, 4>(p, stream);
    case 5: return launch<RED, 5>(p, stream);
    case 6: return launch<RED, 6>(p, stream);
    case 7: return launch<RED, 7>(p, stream);
    case 8: return launch<RED, 8>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pilosa_tree_eval(const void* table, int n_slices, int n_leaves, const int* slots,
                                const void* program, int prog_len, int words, int reduce,
                                void* out, void* stream) {
  (void)program;
  (void)prog_len;
  if (slots == nullptr) return (int)cudaErrorNotSupported;
  if (n_slices <= 0 || n_leaves <= 0 || words <= 0 || words % kRowQuantum != 0 ||
      reduce < kCount || reduce > kTotal || slots[0] < 1 || slots[0] > kMaxPush) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.table = static_cast<const long long*>(table);
  p.out = out;
  p.items = n_slices;
  p.n_leaves = n_leaves;
  p.vecs = words / 4;
  const int n_push = slots[0];
  for (int k = 0; k < kMaxPush; ++k) p.slots.leaf[k] = k < n_push ? slots[1 + k] : -1;
  for (int j = 0; j < kMaxPush - 1; ++j) {
    const bool live = j < n_push - 1;
    p.slots.op[j] = live ? slots[1 + kMaxPush + j] : kAnd;
    p.slots.a[j] = live ? slots[1 + kMaxPush + (kMaxPush - 1) + j] : 0;
    p.slots.b[j] = live ? slots[1 + kMaxPush + 2 * (kMaxPush - 1) + j] : 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reduce != kRow) {
    const cudaError_t rc =
        cudaMemsetAsync(out, 0, reduce == kCount ? (size_t)n_slices * 4 : 8, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  int rc = 0;
  switch (reduce) {
    case kCount: rc = launch_red<kCount>(p, n_push, s); break;
    case kRow: rc = launch_red<kRow>(p, n_push, s); break;
    default: rc = launch_red<kTotal>(p, n_push, s); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
