// Fused gather-scale-segment-sum over edges grouped by destination:
//   out[v, :] = sum over edges i of segment v of w[i] * x[src[i], :]
// where segment v is [offsets[v], offsets[v + 1]) of the destination-sorted
// edge arrays; an empty segment gives a zero row and an edge whose src is
// outside [0, N) contributes 0 (the caller's padding is src = N).
//
// Replaces: src/repro/kernels/spmm_segment/spmm_segment.py,
//   spmm_segment_pallas (the per-edge gather, scale and accumulate), and
//   the `touched` pass of its wrapper (ops.py), which zeroes rows the
//   kernel never visited.
//
// What bounds it on an H100: device-memory bytes.  Per edge it reads
// src[i] and, for a live edge, w[i] and one x row, the x row a scattered
// read; per output row two offsets and one write.  At the engine's D = 1
// that is about 12 bytes per edge plus 8 per vertex against 3.35 TB/s; one
// multiply and one add per element is nothing against the card's float32
// rate.
//
// Design: the TPU kernel ran a sequential grid of (feature blocks x edges)
// and revisited a VMEM output block once per edge, which the grid's order
// made safe.  Blocks on Hopper run in no order, so here one thread owns one
// output element (row v, column c) and walks its row's edges in sorted
// order: each element is written once, with no atomics and no zero-fill
// pass.  Consecutive threads take consecutive columns of a row, so for
// D >= 32 a warp reads an x row coalesced and src/w are broadcasts.  The
// sum starts from the first edge's term and adds the rest in order, the
// Pallas kernel's own order; __fmul_rn/__fadd_rn keep nvcc from
// contracting the two into an FMA, so each term rounds as the plain
// version's does.
//
// D = 1 (the engine's value plane) has its own kernel: one thread per row
// still, but in a block whose rows hold more than kBlockSerial edges
// together, a row of more than kLongRow edges is summed by the whole block
// (thread t takes edges t, t + 256, ... in order; each warp adds its 32
// partial sums with a fixed butterfly, then the row's owner adds the 8
// warp sums in order), so one hub vertex does not leave one thread walking
// all its edges, one memory latency per edge, while the card waits: on the
// 2^20-vertex tree's inbound view vertex 0 owns 83,619 edges.  Such a row
// is summed in another order than the plain version's, the same order on
// every run; every other row keeps the sequential order.  A block reads
// its edge total from two offsets, so a sparse block (the engine's
// outbound view has in-degree 1) decides alone and meets no barrier.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a multiple of the warp
constexpr int kWarps = kThreads / 32;
constexpr int kLongRow = 32;
constexpr int kBlockSerial = 2 * kThreads;
constexpr unsigned kFullMask = 0xffffffffu;

// w[i] * x[src[i] * dim + c], or 0 for a padded source
__device__ __forceinline__ float edge_term(const float* __restrict__ x,
                                          const int32_t* __restrict__ src,
                                          const float* __restrict__ w,
                                          int32_t i, int32_t num_nodes,
                                          int32_t dim, int32_t c) {
  const int32_t s = __ldg(src + i);
  if (s < 0 || s >= num_nodes) return 0.0f;
  return __fmul_rn(__ldg(x + static_cast<int64_t>(s) * dim + c),
                   __ldg(w + i));
}

// column c of a row: its terms added in sorted order from the first one
__device__ __forceinline__ float row_sum(const float* __restrict__ x,
                                        const int32_t* __restrict__ src,
                                        const float* __restrict__ w,
                                        int32_t lo, int32_t hi,
                                        int32_t num_nodes, int32_t dim,
                                        int32_t c) {
  float acc = 0.0f;
  for (int32_t i = lo; i < hi; ++i) {
    const float term = edge_term(x, src, w, i, num_nodes, dim, c);
    acc = (i == lo) ? term : __fadd_rn(acc, term);
  }
  return acc;
}

__global__ void spmm_segment_kernel(const float* __restrict__ x,
                                    const int32_t* __restrict__ src,
                                    const float* __restrict__ w,
                                    const int32_t* __restrict__ offsets,
                                    float* __restrict__ out,
                                    int64_t num_elements, int32_t num_nodes,
                                    int32_t dim) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= num_elements) return;
  const int64_t v = t / dim;
  const int32_t c = static_cast<int32_t>(t - v * dim);
  out[t] = row_sum(x, src, w, __ldg(offsets + v), __ldg(offsets + v + 1),
                   num_nodes, dim, c);
}

// D = 1, launched with kThreads threads a block.  A block returns early
// only as a whole; otherwise every thread takes part in its barriers.
__global__ void spmm_segment_rows_kernel(const float* __restrict__ x,
                                         const int32_t* __restrict__ src,
                                         const float* __restrict__ w,
                                         const int32_t* __restrict__ offsets,
                                         float* __restrict__ out,
                                         int64_t num_out,
                                         int32_t num_nodes) {
  __shared__ int num_long;
  __shared__ int32_t long_lo[kThreads], long_hi[kThreads];
  __shared__ int long_owner[kThreads];
  __shared__ float warp_sum[kWarps];
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const bool mine = v < num_out;
  int32_t lo = 0, hi = 0;
  if (mine) {
    lo = __ldg(offsets + v);
    hi = __ldg(offsets + v + 1);
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t last = first + kThreads < num_out ? first + kThreads
                                                  : num_out;
  if (__ldg(offsets + last) - __ldg(offsets + first) <= kBlockSerial) {
    if (mine) out[v] = row_sum(x, src, w, lo, hi, num_nodes, 1, 0);
    return;
  }
  if (threadIdx.x == 0) num_long = 0;
  __syncthreads();
  float acc = 0.0f;
  if (hi - lo > kLongRow) {          // the list's order does not matter:
    const int k = atomicAdd(&num_long, 1);   // each row is summed alone
    long_lo[k] = lo;
    long_hi[k] = hi;
    long_owner[k] = threadIdx.x;
  } else {
    acc = row_sum(x, src, w, lo, hi, num_nodes, 1, 0);
  }
  __syncthreads();
  for (int k = 0; k < num_long; ++k) {
    float part = 0.0f;
    for (int64_t i = long_lo[k] + threadIdx.x; i < long_hi[k];
         i += kThreads) {
      part = __fadd_rn(part, edge_term(x, src, w, static_cast<int32_t>(i),
                                       num_nodes, 1, 0));
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(kFullMask, part, offset));
    }
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32] = part;
    __syncthreads();
    if (threadIdx.x == long_owner[k]) {
      acc = warp_sum[0];
      for (int j = 1; j < kWarps; ++j) acc = __fadd_rn(acc, warp_sum[j]);
    }
    __syncthreads();
  }
  if (mine) out[v] = acc;
}

}  // namespace

extern "C" int spmm_segment_launch(const void* x, const void* src,
                                   const void* w, const void* offsets,
                                   void* out, int64_t num_out,
                                   int64_t num_nodes, int64_t dim,
                                   void* stream) {
  const int64_t num_elements = num_out * dim;
  if (num_elements == 0) return 0;
  const int64_t blocks = (num_elements + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 1) {
    spmm_segment_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(src),
        static_cast<const float*>(w), static_cast<const int32_t*>(offsets),
        static_cast<float*>(out), num_out, static_cast<int32_t>(num_nodes));
  } else {
    spmm_segment_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(src),
        static_cast<const float*>(w), static_cast<const int32_t*>(offsets),
        static_cast<float*>(out), num_elements,
        static_cast<int32_t>(num_nodes), static_cast<int32_t>(dim));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
