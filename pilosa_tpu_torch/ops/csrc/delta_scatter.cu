// Delta-scatter: apply folded write deltas to resident planes, any number
// of planes in one launch.
//
// Replaces the jitted XLA program plan._build_scatter
// (pilosa_tpu/exec/plan.py:814, driven by pilosa_tpu/ingest/scatter.py:104),
// which the JAX package runs once per fragment: for every entry i,
//
//     plane[job[i]][word[i]] = (plane[job[i]][word[i]] & ~andnot[i]) | or[i]
//
// over int32 bit-views of the uint32 plane words (each plane a contiguous
// [rows, 32768] tensor, word[i] = slot * 32768 + word within the row).
// The planes are updated IN PLACE (the JAX program returned a new array);
// the fragment locks, held until this launch is enqueued, and one stream
// keep readers on old-or-new (see core/fragment.py).
//
// Launch buffer (int64, one host-to-device copy per launch):
//     [0, n_addr)          the planes' addresses, n_addr = n_jobs rounded up to even
//     [n_addr, n_addr+2n)  n records of four 32-bit fields: job, word, or, andnot
// The records come from ingest.scatter.fold_many sorted by (job, word), one
// per pair, and were checked on the host: job < n_jobs, word inside its
// plane, no (job, word) twice and no two planes sharing memory.  So no two
// threads touch one word and no atomics are needed.
//
// Design: one thread per record, 256 a block, one grid over every record of
// the batch.  A record is one 16-byte load (neighbouring threads read
// neighbouring records, so a warp reads 512 contiguous bytes); the plane's
// address is the job's entry of the address table, read through the
// read-only cache — the records are sorted by job, so a warp nearly always
// reads one address, broadcast.  A per-record job index was chosen over a
// search of a job-offset table: it costs no bytes (slot and word share one
// 32-bit field, which the search would need too), no dependent loads, and
// no shared-memory limit on the number of planes a batch holds.  Records
// sorted by word make neighbouring threads touch neighbouring words, so a
// 32-byte sector of a plane serves up to eight records.
//
// Bound: records 16 B each + the address table 8 B a plane + one 32-byte
// sector read and one written per touched word.  A launch for one plane
// of ~1,100 records is bound by the launch, not the bytes (PERF.md's
// kernel table), which is why the flush batches every pending plane of
// a read into one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
delta_scatter_kernel(const long long* __restrict__ addrs, const int4* __restrict__ recs,
                     int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int4 r = __ldg(recs + i);
  unsigned* w = reinterpret_cast<unsigned*>(__ldg(addrs + r.x)) + (unsigned)r.y;
  *w = (*w & ~(unsigned)r.w) | (unsigned)r.z;
}

__global__ void noop_kernel() {}

}  // namespace

// Apply the n records of the launch buffer `buf` (layout above) to the
// n_jobs planes it addresses.  n == 0 launches nothing.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pilosa_delta_scatter_many(const void* buf, long long n_jobs, long long n,
                                         void* stream) {
  if (n_jobs <= 0 || n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long* addrs = static_cast<const long long*>(buf);
  const int4* recs = reinterpret_cast<const int4*>(addrs + ((n_jobs + 1) & ~1LL));
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  delta_scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      addrs, recs, (int)n);
  return (int)cudaGetLastError();
}

// Launch one empty block on the stream: the launch-latency floor that
// bounds delta_scatter, measured beside it.  Returns cudaGetLastError().
extern "C" int pilosa_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
