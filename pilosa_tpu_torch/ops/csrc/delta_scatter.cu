// Delta-scatter: apply folded point-write deltas to a resident plane.
//
// Replaces the jitted XLA program plan._build_scatter
// (pilosa_tpu/exec/plan.py:814, driven by pilosa_tpu/ingest/scatter.py:104):
// for every entry i,
//
//     plane[slots[i], words[i]] = (plane[slots[i], words[i]] & ~andnot[i]) | or[i]
//
// over int32 bit-views of the uint32 plane words ([rows, words_per_row],
// contiguous).  Entries come from ingest.scatter.fold, which leaves one
// entry per (slot, word), so no two threads touch the same word and no
// atomics are needed; the kernel still assumes no order between entries.
// The plane is updated IN PLACE (the JAX program returned a new array);
// the fragment lock, one launch per applied queue and one stream keep
// readers on old-or-new (see core/fragment.py).
//
// Bound: at ~1,100 entries per fragment (an /import of 2^20 bits over 954
// slices) the work is 1,100 x (16 B of entry + a 32 B sector read + a 32 B
// sector write) ~= 88 KB, about 0.03 us at the 3.35 TB/s of an H100 SXM;
// one kernel launch costs far more, so the kernel is bound by launch
// latency, not by bytes or operations.  Making it fast (one launch for
// every fragment an import touches) is later work.
//
// Design: one thread per entry, 256 threads per block; each thread reads
// its entry's four 4-byte fields (coalesced across the warp), reads the
// word, applies the masks on unsigned words and writes it back.  The
// kernel allocates nothing and launches on the caller's stream; the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
delta_scatter_kernel(unsigned* __restrict__ plane, long long words_per_row,
                     const int* __restrict__ slots, const int* __restrict__ words,
                     const unsigned* __restrict__ or_m,
                     const unsigned* __restrict__ andnot_m, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  unsigned* w = plane + (long long)slots[i] * words_per_row + words[i];
  *w = (*w & ~andnot_m[i]) | or_m[i];
}

__global__ void noop_kernel() {}

}  // namespace

// Apply n entries to plane [rows, words_per_row].  The caller has checked
// 0 <= slots[i] < rows and 0 <= words[i] < words_per_row, and that the
// (slot, word) pairs are unique.  n == 0 launches nothing.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pilosa_delta_scatter(void* plane, long long rows,
                                    long long words_per_row, const void* slots,
                                    const void* words, const void* or_m,
                                    const void* andnot_m, long long n,
                                    void* stream) {
  if (rows <= 0 || words_per_row <= 0 || n < 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  delta_scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(plane), words_per_row, static_cast<const int*>(slots),
      static_cast<const int*>(words), static_cast<const unsigned*>(or_m),
      static_cast<const unsigned*>(andnot_m), n);
  return (int)cudaGetLastError();
}

// Launch one empty block on the stream: the launch-latency floor that
// bounds delta_scatter, measured beside it.  Returns cudaGetLastError().
extern "C" int pilosa_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
