// One BFS level of the positional PRecursive join: frontier vertices -> the
// CSR positions of their out-edges, concatenated in frontier order.
//
// Replaces: src/repro/kernels/frontier_expand/frontier_expand.py,
//   expand_index_pallas (phase A, rank inversion) together with the
//   late_gather_pallas call that its wrapper (ops.py, frontier_expand_fused)
//   runs as phase B (the perm gather).
//
// What bounds it on an H100: device-memory bytes.  Per output slot it reads
// about log2(F) entries of `ends` (mostly L2 hits: the frontier arrays are a
// few MB at most), one entry each of `estart`, `deg` and `perm`, and writes
// one int32: about capacity x 16 bytes a level against 3.35 TB/s.  There is
// no arithmetic to speak of.
//
// Design: one thread per output slot j.  The TPU kernel counted #{ends <= j}
// with chunked compare-counts and picked with one-hot sums because VMEM has
// no dynamic gather; here a thread does an upper_bound binary search over
// `ends` and gathers directly.  Phase A and phase B are fused, so the
// intermediate CSR index (gidx) never goes to device memory.  The level's
// total is read on the device from ends[F-1]: no host sync.  Slots at or
// past the total get the sentinel num_edges.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void frontier_expand_kernel(const int32_t* __restrict__ ends,
                                       const int32_t* __restrict__ estart,
                                       const int32_t* __restrict__ deg,
                                       const int32_t* __restrict__ perm,
                                       int32_t* __restrict__ out,
                                       int frontier, int capacity,
                                       int32_t num_edges) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= capacity) return;
  const int32_t total = __ldg(ends + frontier - 1);
  int32_t result = num_edges;
  if (j < total) {
    // upper_bound: the first slot s with ends[s] > j.  ends[F-1] = total > j,
    // so s < F.
    int lo = 0;
    int hi = frontier - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(ends + mid) <= j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int32_t start = __ldg(ends + lo) - __ldg(deg + lo);
    result = __ldg(perm + __ldg(estart + lo) + (j - start));
  }
  out[j] = result;
}

}  // namespace

extern "C" int frontier_expand_launch(const void* ends, const void* estart,
                                      const void* deg, const void* perm,
                                      void* out, int64_t frontier,
                                      int64_t capacity, int64_t num_edges,
                                      void* stream) {
  constexpr int kThreads = 256;
  const int blocks = static_cast<int>((capacity + kThreads - 1) / kThreads);
  frontier_expand_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(estart),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(perm),
      static_cast<int32_t*>(out), static_cast<int>(frontier),
      static_cast<int>(capacity), static_cast<int32_t>(num_edges));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
