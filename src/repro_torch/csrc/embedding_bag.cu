// EmbeddingBag: ragged gather and weighted segment sum over bag-sorted
// entries,
//   out[b, :] = sum over entries i of bag b of w[i] * table[idx[i], :]
// where bag b is [offsets[b], offsets[b + 1]) of the bag-sorted arrays; an
// empty bag gives a zero row.  An index >= R contributes 0; a negative
// index in [-R, 0) counts from the end once (row R + idx), as a JAX index
// does; one below -R contributes 0.  With `mean`, each bag is divided by
// its count of indices < R, at least 1.  Weights may be absent (all ones).
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py,
//   embedding_bag_pallas (the per-index gather and the accumulation into
//   the bag's output block), together with its wrapper's one sentinel
//   entry per bag (ops.py), which made empty bags zero, and the `mean`
//   division that follows it.
//
// What bounds it on an H100: device-memory bytes.  It reads each bag's
// two offsets, each entry's index (and weight), and one table row of D
// floats per entry, the rows a scattered read; it writes each output row
// once.  At DeepFM's serving shape (D = 10, 39 entries a bag, no
// weights) that is 4 bytes per entry, the distinct rows' 40 bytes and
// 40 + 4 bytes per bag against 3.35 TB/s; one multiply and one add per
// element is nothing against the card's float32 rate.
//
// Design: the TPU kernel walked one index per step of a sequential grid
// and carried the bag's sum in its VMEM output block between steps, which
// only the grid's order made safe.  Blocks on Hopper run in no order, so
// here one warp owns one bag and nothing is carried between blocks: lanes
// take the columns (32 at a time), each lane keeps its column's sum in a
// register, and the warp walks the bag's entries in sorted order, so each
// output element is written once, with no atomics and no zero-fill pass.
// The warp reads 32 entries at a time coalesced, one index and weight per
// lane, and broadcasts them with shuffles; each table row is then read by
// neighbouring lanes at neighbouring addresses.  The sum starts at 0 and
// adds the terms in the bags' sorted (stable, so original) order;
// __fmul_rn/__fadd_rn keep nvcc from contracting a multiply and an add
// into an FMA, so each term rounds as the plain version's does.  Row
// addresses are computed in 64 bits: R x D passes 2^31 on wide tables.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a multiple of the warp
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int32_t* __restrict__ indices,
                                     const float* __restrict__ weights,
                                     const int32_t* __restrict__ offsets,
                                     float* __restrict__ out,
                                     int64_t num_bags, int64_t num_rows,
                                     int32_t dim, int mean) {
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  if (bag >= num_bags) return;    // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int32_t lo = __ldg(offsets + bag);
  const int32_t hi = __ldg(offsets + bag + 1);
  const bool weighted = weights != nullptr;
  int32_t count = 0;              // entries with index < R
  for (int32_t c0 = 0; c0 < dim; c0 += 32) {
    const int32_t c = c0 + lane;
    const bool column = c < dim;
    float acc = 0.0f;
    for (int32_t base = lo; base < hi; base += 32) {
      // lane j brings entry base + j: its row (-1: contributes 0), weight
      const int32_t i = base + lane;
      int32_t row = -1;
      float w = 1.0f;
      bool counted = false;
      if (i < hi) {
        const int64_t k = __ldg(indices + i);
        counted = k < num_rows;
        const int64_t wrapped = k < 0 ? k + num_rows : k;
        if (wrapped >= 0 && wrapped < num_rows) {
          row = static_cast<int32_t>(wrapped);
        }
        if (weighted) w = __ldg(weights + i);
      }
      if (c0 == 0) count += __popc(__ballot_sync(kFullMask, counted));
      const int32_t n = hi - base < 32 ? hi - base : 32;
#pragma unroll 4
      for (int32_t j = 0; j < n; ++j) {
        const int32_t r = __shfl_sync(kFullMask, row, j);
        const float wj = __shfl_sync(kFullMask, w, j);
        if (r >= 0 && column) {
          const float v = __ldg(table + static_cast<int64_t>(r) * dim + c);
          acc = __fadd_rn(acc, weighted ? __fmul_rn(v, wj) : v);
        }
      }
    }
    if (column) {
      out[bag * dim + c] =
          mean ? __fdiv_rn(acc, static_cast<float>(count > 0 ? count : 1))
               : acc;
    }
  }
}

}  // namespace

// The caller guarantees num_rows, dim and the entry count below 2^31, and
// weights either null or as long as indices.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, const void* offsets,
                                    void* out, int64_t num_bags,
                                    int64_t num_rows, int64_t dim, int mean,
                                    void* stream) {
  if (num_bags == 0 || dim == 0) return 0;
  const int64_t blocks = (num_bags + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out),
      num_bags, num_rows, static_cast<int32_t>(dim), mean);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
