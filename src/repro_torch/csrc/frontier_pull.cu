// One bottom-up (pull) level of direction-optimizing BFS: the next frontier
// is every unvisited vertex with an in-neighbor (over the join view) in the
// frontier bitmap.
//
// Replaces: src/repro/kernels/frontier_pull/frontier_pull.py,
//   pull_contrib_pallas (the per-entry membership test) together with the
//   two perm-ordered gathers and the per-vertex segment-OR + `& ~visited`
//   that its wrapper (ops.py, frontier_pull_fused) runs around it in XLA.
//
// What bounds it on an H100: device-memory bytes.  Per reverse-CSR entry q
// it reads perm[q] (coalesced) and two scattered int32 columns at perm[q];
// the (V,) byte bitmaps are a few MB at most and mostly L2 hits.  About
// E x 12 bytes plus the bitmaps and the (V,) output against 3.35 TB/s; no
// arithmetic to speak of.
//
// Design: one thread per reverse-CSR entry q.  The TPU kernel resolved both
// bitmap lookups with chunked one-hot masked sums because VMEM has no
// dynamic gather, and left the segment-OR to an XLA scatter-max; here a
// thread gathers directly and stores the OR itself.  Every writer of
// out[vtx] stores the same byte 1, so the OR needs no atomics, and the
// store is gated on !visited[vtx], so the reference's final `& ~visited`
// is part of the test.  visited is tested first: as the traversal
// saturates most entries stop before the frontier gather.  Ids are clamped
// onto [0, V) as the reference clips them, per entry (a walk over indptr
// would miss entries whose id is out of range: build_csr leaves them in
// perm but out of indptr's counts).  The output is zeroed on the stream
// before the launch.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int32_t clamp_id(int32_t v, int32_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void frontier_pull_kernel(const int32_t* __restrict__ perm,
                                     const int32_t* __restrict__ join_src,
                                     const int32_t* __restrict__ join_dst,
                                     const uint8_t* __restrict__ frontier,
                                     const uint8_t* __restrict__ visited,
                                     uint8_t* __restrict__ out,
                                     int64_t num_entries,
                                     int32_t num_vertices) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= num_entries) return;
  // perm is a permutation of the E join positions; the clamp keeps a
  // malformed one inside the columns, as a JAX gather clamps
  const int32_t p = clamp_id(__ldg(perm + q),
                             static_cast<int32_t>(num_entries - 1));
  const int32_t hi = num_vertices - 1;
  const int32_t vtx = clamp_id(__ldg(join_dst + p), hi);
  if (__ldg(visited + vtx)) return;
  const int32_t nbr = clamp_id(__ldg(join_src + p), hi);
  if (__ldg(frontier + nbr)) out[vtx] = 1;
}

}  // namespace

extern "C" int frontier_pull_launch(const void* perm, const void* join_src,
                                    const void* join_dst,
                                    const void* frontier,
                                    const void* visited, void* out,
                                    int64_t num_entries,
                                    int64_t num_vertices, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, num_vertices, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  const int64_t blocks = (num_entries + kThreads - 1) / kThreads;
  frontier_pull_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(join_src),
      static_cast<const int32_t*>(join_dst),
      static_cast<const uint8_t*>(frontier),
      static_cast<const uint8_t*>(visited), static_cast<uint8_t*>(out),
      num_entries, static_cast<int32_t>(num_vertices));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
