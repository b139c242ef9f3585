// K8: the BSI ripple — signed comparison, Sum and Min/Max over the bit-planes
// of an integer field, read in place from the field fragments' mirrors.
//
// Replaces the jitted XLA programs that pilosa_tpu/exec/plan.py:183-210
// builds from pilosa_tpu/bsi/ripple.py:27-146 (signed_cmp / between_row,
// sum_vec, minmax_vec); the plain PyTorch version is
// pilosa_tpu_torch/bsi/ripple.py.  Three kernels, one per function:
//
//   bsi_cmp_kernel     signed_cmp (lt/le/eq/ne/ge/gt) and between_row, as a
//                      result row per slice (int32 [S, 32768]) or as its
//                      popcount (int32 [S]);
//   bsi_sum_kernel     sum_vec: per slice [pos_0..pos_{B-1}, neg_0..neg_{B-1}, n];
//   bsi_minmax_kernel  minmax_vec: per slice [bit_0..bit_{B-1}, negative, count].
//
// B is the field's depth bucket (a multiple of 8).  The JAX package pads the
// magnitude planes to B with zero planes; here the kernels read only the
// `depth` real planes and write the pad entries as the zero planes would
// make them: 0 in sum_vec; in minmax_vec 0 when maximizing, and when
// minimizing 1 exactly when the candidate set is empty.
//
// Inputs.  The planes are read where they live: `table` is int64
// [S, 3 + depth], one line per slice: the base address of the slice's field
// fragment mirror (int32 [rows, 32768], 16-byte aligned), then the mirror
// row of the exists plane, the sign plane and magnitude bit k, with -1 for a
// row the fragment does not hold (read as zero; a slice without the fragment
// has base 0 and every row -1).  A predicate is its magnitude (uint64,
// < 2^depth) and a sign flag.  `filt`, when given, is an int32 [S, 32768]
// row per slice ANDed into the valued columns of Sum and Min/Max.
//
// Bound: every kernel is memory-bound.  It reads (2 + depth) plane rows of
// 128 KiB per slice (plus the filter row), and the comparison in row mode
// writes one 128 KiB row per slice; the and/or/popcount work per word is a
// few dozen integer operations against 4 bytes.  At 954 slices and depth 31
// that is 33 x 954 x 131,072 B = 4.126 GB read, 1.232 ms at the 3.35 TB/s of
// an H100 SXM (row mode: +0.125 GB written, 1.269 ms).
//
// Design.
// * bsi_cmp: grid (16 word tiles, S); 256 threads, each holding 2 uint4 (8
//   words) of exists and the (lt, eq, gt) ripple state in registers while it
//   reads the planes from high to low; `between` carries both ripples in one
//   pass, so each plane is read once.  Count mode popcounts with __popc,
//   reduces per warp and per block, and adds into out[s] with an integer
//   atomicAdd (order-free, so exact and deterministic: at most 2^20 a slice).
// * bsi_sum: grid (8 word tiles, S); 256 threads, each holding the pos/neg
//   masks of 4 uint4 in registers; per plane one warp reduction of the two
//   popcounts into shared counters, then one atomicAdd per counter and block.
// * bsi_minmax: one block of 1024 threads per slice; the candidate set (32768
//   words) stays in 128 KiB of dynamic shared memory, each thread owning the
//   same 8 uint4 throughout.  Per plane, high to low: one block-wide
//   reduction of popcount(cand & plane); the candidate count is carried
//   (n1 if bit 1 is taken, else count - n1), which equals the JAX's
//   popcount(cand) at every step, so one reduction per plane suffices.
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kWordsPerRow = 32768;
constexpr long long kVecsPerRow = kWordsPerRow / 4;
constexpr int kMaxDepth = 62;

enum Op { kLt = 0, kLe = 1, kEq = 2, kNe = 3, kGe = 4, kGt = 5, kBetween = 6 };

__device__ __forceinline__ const uint4* plane_row(const long long* line, int j) {
  // line = [base, slot(exists), slot(sign), slot(bit 0), ...]; j indexes the slots.
  const long long slot = line[1 + j];
  if (slot < 0 || line[0] == 0) return nullptr;
  return reinterpret_cast<const uint4*>(line[0]) + slot * kVecsPerRow;
}

__device__ __forceinline__ uint4 load_vec(const uint4* row, long long i) {
  return row ? row[i] : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void split(uint4 x, unsigned* w) {
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// signed_cmp's composition of one op from the magnitude partition.
__device__ __forceinline__ unsigned compose(int op, unsigned nm, unsigned ex, unsigned pos,
                                            unsigned neg, unsigned lt, unsigned eq,
                                            unsigned gt) {
  const unsigned eq_row = (~nm & pos & eq) | (nm & neg & eq);
  if (op == kEq) return eq_row;
  if (op == kNe) return ex & ~eq_row;
  const unsigned lt_row = (~nm & (neg | (pos & lt))) | (nm & neg & gt);
  if (op == kLt) return lt_row;
  if (op == kLe) return lt_row | eq_row;
  const unsigned gt_row = (~nm & pos & gt) | (nm & (pos | (neg & lt)));
  if (op == kGt) return gt_row;
  return gt_row | eq_row;  // kGe
}

// ---------------------------------------------------------------------------
// (a) signed comparison / between
// ---------------------------------------------------------------------------

constexpr int kCmpThreads = 256;
constexpr int kCmpVecs = 2;
constexpr int kCmpWords = 4 * kCmpVecs;
constexpr int kCmpTileVecs = kCmpThreads * kCmpVecs;

template <bool COUNT, bool BETWEEN>
__global__ void __launch_bounds__(kCmpThreads)
bsi_cmp_kernel(const long long* __restrict__ table, int stride, int depth, int op,
               unsigned long long mag1, int neg1, unsigned long long mag2, int neg2,
               uint4* __restrict__ out_rows, int* __restrict__ out_counts) {
  const int s = blockIdx.y;
  const long long* line = table + (long long)s * stride;
  const long long i0 = (long long)blockIdx.x * kCmpTileVecs + threadIdx.x;

  unsigned ex[kCmpWords], lt1[kCmpWords], eq1[kCmpWords], gt1[kCmpWords];
  unsigned lt2[kCmpWords], eq2[kCmpWords], gt2[kCmpWords];
  const uint4* ex_row = plane_row(line, 0);
#pragma unroll
  for (int v = 0; v < kCmpVecs; ++v) split(load_vec(ex_row, i0 + v * kCmpThreads), ex + 4 * v);
#pragma unroll
  for (int w = 0; w < kCmpWords; ++w) {
    eq1[w] = ex[w]; lt1[w] = 0u; gt1[w] = 0u;
    eq2[w] = ex[w]; lt2[w] = 0u; gt2[w] = 0u;
  }

  for (int k = depth - 1; k >= 0; --k) {
    const uint4* row = plane_row(line, 2 + k);
    unsigned b[kCmpWords];
#pragma unroll
    for (int v = 0; v < kCmpVecs; ++v) split(load_vec(row, i0 + v * kCmpThreads), b + 4 * v);
    const unsigned m1 = ((mag1 >> k) & 1ull) ? ~0u : 0u;
    const unsigned m2 = ((mag2 >> k) & 1ull) ? ~0u : 0u;
#pragma unroll
    for (int w = 0; w < kCmpWords; ++w) {
      lt1[w] |= eq1[w] & ~b[w] & m1;
      gt1[w] |= eq1[w] & b[w] & ~m1;
      eq1[w] &= b[w] ^ ~m1;
      if (BETWEEN) {
        lt2[w] |= eq2[w] & ~b[w] & m2;
        gt2[w] |= eq2[w] & b[w] & ~m2;
        eq2[w] &= b[w] ^ ~m2;
      }
    }
  }

  const uint4* sign_row = plane_row(line, 1);
  unsigned sg[kCmpWords];
#pragma unroll
  for (int v = 0; v < kCmpVecs; ++v) split(load_vec(sign_row, i0 + v * kCmpThreads), sg + 4 * v);
  const unsigned nm1 = neg1 ? ~0u : 0u;
  const unsigned nm2 = neg2 ? ~0u : 0u;
  unsigned r[kCmpWords];
#pragma unroll
  for (int w = 0; w < kCmpWords; ++w) {
    const unsigned pos = ex[w] & ~sg[w];
    const unsigned neg = ex[w] & sg[w];
    if (BETWEEN) {
      r[w] = compose(kGe, nm1, ex[w], pos, neg, lt1[w], eq1[w], gt1[w]) &
             compose(kLe, nm2, ex[w], pos, neg, lt2[w], eq2[w], gt2[w]);
    } else {
      r[w] = compose(op, nm1, ex[w], pos, neg, lt1[w], eq1[w], gt1[w]);
    }
  }

  if (!COUNT) {
    uint4* out = out_rows + (long long)s * kVecsPerRow;
#pragma unroll
    for (int v = 0; v < kCmpVecs; ++v) {
      out[i0 + v * kCmpThreads] = make_uint4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
    }
    return;
  }
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kCmpWords; ++w) cnt += __popc(r[w]);
  cnt = warp_sum(cnt);
  __shared__ int warp_sums[kCmpThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kCmpThreads / 32 ? warp_sums[lane] : 0;
    cnt = warp_sum(cnt);
    if (lane == 0 && cnt != 0) atomicAdd(out_counts + s, cnt);
  }
}

// ---------------------------------------------------------------------------
// (b) Sum partials
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumVecs = 4;
constexpr int kSumWords = 4 * kSumVecs;
constexpr int kSumTileVecs = kSumThreads * kSumVecs;

template <bool FILTER>
__global__ void __launch_bounds__(kSumThreads)
bsi_sum_kernel(const long long* __restrict__ table, int stride, int depth, int bucket,
               const uint4* __restrict__ filt, int* __restrict__ out) {
  __shared__ int acc[2 * kMaxDepth + 1];  // pos_k at k, neg_k at depth + k, n at 2 depth
  const int s = blockIdx.y;
  const long long* line = table + (long long)s * stride;
  const long long i0 = (long long)blockIdx.x * kSumTileVecs + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < 2 * depth + 1; j += kSumThreads) acc[j] = 0;
  __syncthreads();

  unsigned pos[kSumWords], neg[kSumWords];
  const uint4* ex_row = plane_row(line, 0);
  const uint4* sign_row = plane_row(line, 1);
  const uint4* f_row = FILTER ? filt + (long long)s * kVecsPerRow : nullptr;
  int n = 0;
#pragma unroll
  for (int v = 0; v < kSumVecs; ++v) {
    const long long i = i0 + v * kSumThreads;
    unsigned e[4], g[4], f[4] = {~0u, ~0u, ~0u, ~0u};
    split(load_vec(ex_row, i), e);
    split(load_vec(sign_row, i), g);
    if (FILTER) split(f_row[i], f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned base = e[c] & f[c];
      pos[4 * v + c] = base & ~g[c];
      neg[4 * v + c] = base & g[c];
      n += __popc(base);
    }
  }
  n = warp_sum(n);
  if (lane == 0 && n != 0) atomicAdd(acc + 2 * depth, n);

  for (int k = 0; k < depth; ++k) {
    const uint4* row = plane_row(line, 2 + k);
    if (row == nullptr) continue;  // an absent plane counts 0 everywhere
    int cp = 0, cn = 0;
#pragma unroll
    for (int v = 0; v < kSumVecs; ++v) {
      unsigned b[4];
      split(row[i0 + v * kSumThreads], b);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        cp += __popc(b[c] & pos[4 * v + c]);
        cn += __popc(b[c] & neg[4 * v + c]);
      }
    }
    cp = warp_sum(cp);
    cn = warp_sum(cn);
    if (lane == 0) {
      if (cp) atomicAdd(acc + k, cp);
      if (cn) atomicAdd(acc + depth + k, cn);
    }
  }
  __syncthreads();
  int* o = out + (long long)s * (2 * bucket + 1);
  for (int j = threadIdx.x; j < 2 * depth + 1; j += kSumThreads) {
    const int v = acc[j];
    if (v == 0) continue;
    const int at = j < depth ? j : (j < 2 * depth ? bucket + (j - depth) : 2 * bucket);
    atomicAdd(o + at, v);
  }
}

// ---------------------------------------------------------------------------
// (c) Min/Max partials
// ---------------------------------------------------------------------------

constexpr int kMmThreads = 1024;
constexpr int kMmVecs = kVecsPerRow / kMmThreads;  // 8 uint4 per thread
constexpr int kMmSmemBytes = kVecsPerRow * 16;      // 128 KiB: the candidate row

__device__ __forceinline__ int popc4(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 andnot4(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// Sum of v over the block, returned to every thread.  red holds 33 ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(red[lane]);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const int total = red[32];
  __syncthreads();  // red is reused by the next call
  return total;
}

template <bool FILTER>
__global__ void __launch_bounds__(kMmThreads)
bsi_minmax_kernel(const long long* __restrict__ table, int stride, int depth, int bucket,
                  int which_max, const uint4* __restrict__ filt, int* __restrict__ out) {
  extern __shared__ uint4 cand[];
  __shared__ int red[33];
  const int s = blockIdx.x;
  const long long* line = table + (long long)s * stride;
  const uint4* ex_row = plane_row(line, 0);
  const uint4* sign_row = plane_row(line, 1);
  const uint4* f_row = FILTER ? filt + (long long)s * kVecsPerRow : nullptr;

  // base = exists & filter into cand; the sign words stay in registers
  // until the group is chosen.
  uint4 g[kMmVecs];
  int c_pos = 0, c_neg = 0;
#pragma unroll
  for (int j = 0; j < kMmVecs; ++j) {
    const long long i = threadIdx.x + (long long)j * kMmThreads;
    uint4 base = load_vec(ex_row, i);
    if (FILTER) base = and4(base, f_row[i]);
    g[j] = load_vec(sign_row, i);
    cand[i] = base;
    c_pos += popc4(andnot4(base, g[j]));
    c_neg += popc4(and4(base, g[j]));
  }
  const int n_pos = block_sum(c_pos, red);
  const int n_neg = block_sum(c_neg, red);
  // Max prefers the non-negative group, Min the negative one; the preferred
  // group is maximized, the other (when the preferred one is empty) minimized.
  const bool use_prefer = which_max ? (n_pos > 0) : (n_neg > 0);
  const bool take_neg = which_max ? !use_prefer : use_prefer;
  const bool maximize = use_prefer;
  int ntot = take_neg ? n_neg : n_pos;
#pragma unroll
  for (int j = 0; j < kMmVecs; ++j) {
    const long long i = threadIdx.x + (long long)j * kMmThreads;
    cand[i] = take_neg ? and4(cand[i], g[j]) : andnot4(cand[i], g[j]);
  }

  int* o = out + (long long)s * (bucket + 2);
  for (int k = depth - 1; k >= 0; --k) {
    const uint4* row = plane_row(line, 2 + k);
    uint4 b[kMmVecs];
    int n1 = 0;
#pragma unroll
    for (int j = 0; j < kMmVecs; ++j) {
      const long long i = threadIdx.x + (long long)j * kMmThreads;
      b[j] = load_vec(row, i);
      n1 += popc4(and4(cand[i], b[j]));
    }
    n1 = block_sum(n1, red);
    // maximize: take bit 1 iff any candidate has it;
    // minimize: take bit 1 only when every candidate has it.
    const bool one = maximize ? (n1 > 0) : (n1 == ntot);
#pragma unroll
    for (int j = 0; j < kMmVecs; ++j) {
      const long long i = threadIdx.x + (long long)j * kMmThreads;
      cand[i] = one ? and4(cand[i], b[j]) : andnot4(cand[i], b[j]);
    }
    ntot = one ? n1 : ntot - n1;
    if (threadIdx.x == 0) o[k] = one ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    // Pad planes are zero: bit 0 when maximizing; when minimizing, 1
    // exactly when the candidate set is empty (it never changes emptiness).
    for (int k = depth; k < bucket; ++k) o[k] = (!maximize && ntot == 0) ? 1 : 0;
    o[bucket] = which_max ? (use_prefer ? 0 : 1) : (use_prefer ? 1 : 0);
    o[bucket + 1] = ntot;
  }
}

bool bad_shape(int stride, int depth, int bucket, int n_slices) {
  return depth < 1 || depth > kMaxDepth || stride != 3 + depth || bucket < depth ||
         n_slices < 1;
}

}  // namespace

// Signed comparison of every slice's valued columns against the predicate
// (mag1, neg1) with op 0-5 (lt, le, eq, ne, ge, gt), or lo <= v <= hi with
// op 6 (between; lo = (mag1, neg1), hi = (mag2, neg2)).  count_mode 0 writes
// the result rows to out (int32 [n_slices, 32768]); 1 adds each row's
// popcount into out (int32 [n_slices], zeroed by the caller).  Magnitudes
// must be < 2^depth; 1 <= n_slices <= 65535.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int pilosa_bsi_cmp(const void* table, int stride, int depth, int n_slices, int op,
                              unsigned long long mag1, int neg1, unsigned long long mag2,
                              int neg2, int count_mode, void* out, void* stream) {
  if (bad_shape(stride, depth, depth, n_slices) || n_slices > 65535 || op < kLt ||
      op > kBetween) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(kVecsPerRow / kCmpTileVecs), (unsigned)n_slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  uint4* rows = static_cast<uint4*>(out);
  int* counts = static_cast<int*>(out);
  const bool between = op == kBetween;
  if (count_mode) {
    if (between) {
      bsi_cmp_kernel<true, true><<<grid, kCmpThreads, 0, st>>>(
          t, stride, depth, op, mag1, neg1, mag2, neg2, nullptr, counts);
    } else {
      bsi_cmp_kernel<true, false><<<grid, kCmpThreads, 0, st>>>(
          t, stride, depth, op, mag1, neg1, mag2, neg2, nullptr, counts);
    }
  } else if (between) {
    bsi_cmp_kernel<false, true><<<grid, kCmpThreads, 0, st>>>(
        t, stride, depth, op, mag1, neg1, mag2, neg2, rows, nullptr);
  } else {
    bsi_cmp_kernel<false, false><<<grid, kCmpThreads, 0, st>>>(
        t, stride, depth, op, mag1, neg1, mag2, neg2, rows, nullptr);
  }
  return (int)cudaGetLastError();
}

// Sum partials: out is int32 [n_slices, 2 * bucket + 1], zeroed by the
// caller; filt is NULL or int32 [n_slices, 32768].  1 <= n_slices <= 65535.
extern "C" int pilosa_bsi_sum(const void* table, int stride, int depth, int bucket,
                              int n_slices, const void* filt, void* out, void* stream) {
  if (bad_shape(stride, depth, bucket, n_slices) || n_slices > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(kVecsPerRow / kSumTileVecs), (unsigned)n_slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  if (filt != nullptr) {
    bsi_sum_kernel<true><<<grid, kSumThreads, 0, st>>>(
        t, stride, depth, bucket, static_cast<const uint4*>(filt), static_cast<int*>(out));
  } else {
    bsi_sum_kernel<false><<<grid, kSumThreads, 0, st>>>(
        t, stride, depth, bucket, nullptr, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}

// Min (which_max 0) or Max (1) partials: out is int32 [n_slices, bucket + 2];
// filt is NULL or int32 [n_slices, 32768].
extern "C" int pilosa_bsi_minmax(const void* table, int stride, int depth, int bucket,
                                 int n_slices, int which_max, const void* filt, void* out,
                                 void* stream) {
  if (bad_shape(stride, depth, bucket, n_slices)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  cudaError_t err;
  if (filt != nullptr) {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmemBytes);
    if (err != cudaSuccess) return (int)err;
    bsi_minmax_kernel<true><<<n_slices, kMmThreads, kMmSmemBytes, st>>>(
        t, stride, depth, bucket, which_max, static_cast<const uint4*>(filt),
        static_cast<int*>(out));
  } else {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmemBytes);
    if (err != cudaSuccess) return (int)err;
    bsi_minmax_kernel<false><<<n_slices, kMmThreads, kMmSmemBytes, st>>>(
        t, stride, depth, bucket, which_max, nullptr, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
