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
// element is nothing against the card's float32 rate.  Every entry still
// reads its row, mostly from L2, and a 40-byte row spans two 32-byte
// sectors, so the SMs pull 64 bytes per entry through the L2 whatever the
// table's distinct rows come to.
//
// Design.  The TPU kernel walked one index per step of a sequential grid
// and carried the bag's sum in its VMEM output block between steps, which
// only the grid's order made safe.  Blocks on Hopper run in no order, so
// here a group of lanes owns a bag and nothing is carried between groups:
// each output element is written once, with no atomics and no zero-fill
// pass.  The launcher (kernels/embedding_bag/embedding_bag.py,
// bag_layout) chooses the layout per call and passes it in; it is checked
// here:
//
//  1. Vector lanes.  A lane loads V floats at once: V = 4 where
//     D % 4 == 0 and the table's base is 16-byte aligned, V = 2 where
//     D % 2 == 0 and it is 8-byte aligned, else 1 (a contiguous table can
//     be a view at a storage offset, so D alone does not settle it).  A
//     row is U = D / V units; L = min(U, 32) lanes cover it.
//  2. One walk of each bag for all of D.  Where U > 32, lane t holds C =
//     ceil(U / 32) accumulators, for units t, t + 32, ..., and the bag is
//     walked once.  Only past C = 4 (128 units: 512 columns with float4s,
//     128 with scalars) is the row cut into slices of 128 units, each
//     walked by its own warp: at C = 4 with float4s the kernel already
//     holds 116 registers (ptxas -v), against 55-80 at C = 1.
//  3. Several bags a warp.  Where L <= 16, a warp holds G = floor(32 / L)
//     lane groups, each walking its own bag (D = 10: float2 x 5 lanes, 6
//     bags a warp; D = 16: float4 x 4 lanes, 8 bags).  A group loads the
//     indices (and weights) of K entries, then their K rows into
//     registers, and only then adds them, in sorted order (K = 8 for
//     C = 1, 4 above).
//
// No shuffles: every lane of a group reads the bag's offsets and each
// entry's index and weight itself.  The lanes of a group read the same
// address, which the load unit serves as one transaction for all of them,
// so this costs no more bytes than one lane reading and shuffling, and it
// lets L be any count (a shuffle's `width` must be a power of two, which
// would round D = 10's 5 lanes up to 8 and fit 4 bags a warp, not 6) and
// lets groups of one warp walk bags of different lengths without a common
// mask.
//
// The order of addition is the correctness anchor: a bag is summed from
// +0 in its sorted (stable, so original) order, one term after another,
// with __fmul_rn/__fadd_rn so that nvcc contracts no multiply and add into
// an FMA: the order and rounding of the plain version's index_add_ on the
// CPU, bit for bit.  Batching the loads changes when a row arrives, not
// when it is added.  Row addresses are computed in 64 bits: R x D passes
// 2^31 on wide tables.  What stays serial is one bag's walk: a bag of
// thousands of entries is one group's chain of batches.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a multiple of the warp
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;   // C at most; 4 x 32 units a slice

template <int V>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T add(T a, T b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ T scale(T a, float w) {
    return __fmul_rn(a, w);
  }
  static __device__ __forceinline__ T div(T a, float n) {
    return __fdiv_rn(a, n);
  }
};

template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ T scale(T a, float w) {
    return make_float2(__fmul_rn(a.x, w), __fmul_rn(a.y, w));
  }
  static __device__ __forceinline__ T div(T a, float n) {
    return make_float2(__fdiv_rn(a.x, n), __fdiv_rn(a.y, n));
  }
};

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ T scale(T a, float w) {
    return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w),
                       __fmul_rn(a.z, w), __fmul_rn(a.w, w));
  }
  static __device__ __forceinline__ T div(T a, float n) {
    return make_float4(__fdiv_rn(a.x, n), __fdiv_rn(a.y, n),
                       __fdiv_rn(a.z, n), __fdiv_rn(a.w, n));
  }
};

// Adds the terms of the first n <= K entries of e (weights ew, null for
// none) to acc, in that order, where unit[c] is this lane's unit of chunk
// c.  It loads all the indices (and weights), then all the rows, and only
// then adds, so that a batch waits for two memory round trips, not 2K.  A
// term whose index is out of range is skipped, which changes no bit: its
// plain term is +0 (times the weight), and the sum is never -0 (it starts
// at +0, and x + (-x) is +0 when rounding to nearest).  `count` gains the
// entries with index < R.  Index arithmetic is 32-bit (R < 2^31), row
// offsets 64-bit.
template <int V, int C, int K>
__device__ __forceinline__ void add_batch(
    const typename Vec<V>::T* __restrict__ rows,
    const int32_t* __restrict__ e, const float* __restrict__ ew, int32_t n,
    int32_t num_rows, int32_t units, const int32_t (&unit)[C],
    typename Vec<V>::T (&acc)[C], int32_t& count) {
  using Op = Vec<V>;
  int32_t row[K];
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row[k] = k < n ? __ldg(e + k) : num_rows;   // past the end: no term
    w[k] = ew != nullptr && k < n ? __ldg(ew + k) : 1.0f;
  }
  typename Op::T v[K][C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    count += row[k] < num_rows;
    const int32_t r = row[k] < 0 ? row[k] + num_rows : row[k];
    row[k] = static_cast<uint32_t>(r) < static_cast<uint32_t>(num_rows)
                 ? r : -1;
    if (row[k] >= 0) {
      const int64_t at = static_cast<int64_t>(row[k]) * units;
#pragma unroll
      for (int c = 0; c < C; ++c) v[k][c] = __ldg(rows + at + unit[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (row[k] >= 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = Op::add(acc[c], ew != nullptr ? Op::scale(v[k][c], w[k])
                                               : v[k][c]);
      }
    }
  }
}

// Lane group g of a warp sums bag (warp * groups + g) / slices, slice
// (warp * groups + g) % slices: units first + c * lanes, c < C, where
// first = slice * 32 * C + (lane within the group).  A lane whose unit
// lies past the row reads the row's last unit instead (a valid address)
// and stores nothing.  The bag is walked in batches of K entries.
template <int V, int C, int K>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ indices,
    const float* __restrict__ weights, const int32_t* __restrict__ offsets,
    float* __restrict__ out, int64_t num_bags, int32_t num_rows,
    int32_t units, int lanes, int groups, int slices, int mean) {
  using Op = Vec<V>;
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int g = lane / lanes;
  if (g >= groups) return;        // a lane left over by the groups
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          groups + g;
  const int64_t bag = slices == 1 ? item : item / slices;
  if (bag >= num_bags) return;
  const int32_t first =
      static_cast<int32_t>(item - bag * slices) * (32 * C) + lane -
      g * lanes;
  int32_t unit[C];
#pragma unroll
  for (int c = 0; c < C; ++c) unit[c] = min(first + c * lanes, units - 1);
  const T* __restrict__ rows = reinterpret_cast<const T*>(table);
  const int32_t lo = __ldg(offsets + bag);
  const int32_t hi = __ldg(offsets + bag + 1);
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = Op::zero();
  int32_t count = 0;              // entries with index < R
  for (int32_t base = lo; base < hi;) {
    const int32_t n = min(hi - base, K);
    add_batch<V, C, K>(rows, indices + base,
                       weights == nullptr ? nullptr : weights + base, n,
                       num_rows, units, unit, acc, count);
    base += n;
  }
  T* __restrict__ dst = reinterpret_cast<T*>(out) + bag * units;
  const float n = static_cast<float>(count > 0 ? count : 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t u = first + c * lanes;
    if (u < units) dst[u] = mean ? Op::div(acc[c], n) : acc[c];
  }
}

// K for C accumulators a lane: bag_layout's `batch`.
constexpr int batch_for(int chunks) { return chunks == 1 ? 8 : 4; }

template <int V, int C>
int launch(const void* table, const void* indices, const void* weights,
           const void* offsets, void* out, int64_t num_bags,
           int64_t num_rows, int32_t units, int lanes, int groups,
           int slices, int mean, unsigned blocks, cudaStream_t stream) {
  embedding_bag_kernel<V, C, batch_for(C)><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(indices),
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out),
      num_bags, static_cast<int32_t>(num_rows), units, lanes, groups, slices,
      mean);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_chunks(int chunks, const void* table, const void* indices,
                  const void* weights, const void* offsets, void* out,
                  int64_t num_bags, int64_t num_rows, int32_t units,
                  int lanes, int groups, int slices, int mean,
                  unsigned blocks, cudaStream_t stream) {
  switch (chunks) {
    case 1:
      return launch<V, 1>(table, indices, weights, offsets, out, num_bags,
                          num_rows, units, lanes, groups, slices, mean,
                          blocks, stream);
    case 2:
      return launch<V, 2>(table, indices, weights, offsets, out, num_bags,
                          num_rows, units, lanes, groups, slices, mean,
                          blocks, stream);
    case 3:
      return launch<V, 3>(table, indices, weights, offsets, out, num_bags,
                          num_rows, units, lanes, groups, slices, mean,
                          blocks, stream);
    case 4:
      return launch<V, 4>(table, indices, weights, offsets, out, num_bags,
                          num_rows, units, lanes, groups, slices, mean,
                          blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The layout is bag_layout's: `vec` floats a load, `lanes` lanes across a
// row (or a slice of it), `groups` bags a warp, `chunks` accumulators a
// lane, `slices` warps across one bag's row, `batch` entries loaded at
// once (K).  It is checked here against D and the pointers' alignment: a
// layout that does not cover the row, or that a load could not take, is
// refused.  The caller guarantees dim and the entry count below 2^31, and
// weights either null or as long as indices.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, const void* offsets,
                                    void* out, int64_t num_bags,
                                    int64_t num_rows, int64_t dim, int vec,
                                    int lanes, int groups, int chunks,
                                    int slices, int batch, int mean,
                                    void* stream) {
  if (num_bags == 0 || dim == 0) return 0;
  if (num_rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [vec](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (4u * vec) == 0;
  };
  if ((vec != 1 && vec != 2 && vec != 4) || dim % vec != 0 ||
      !aligned(table) || !aligned(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t units = dim / vec;
  const bool split = slices > 1;
  if (lanes < 1 || lanes > 32 || groups < 1 || groups * lanes > 32 ||
      chunks < 1 || chunks > kMaxChunks || slices < 1 ||
      batch != batch_for(chunks) ||
      (split && (lanes != 32 || groups != 1 || chunks != kMaxChunks)) ||
      (chunks > 1 && lanes != 32) ||
      static_cast<int64_t>(slices) * lanes * chunks < units ||
      (!split && chunks == 1 && lanes != units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = (num_bags * slices + groups - 1) / groups;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto u = static_cast<int32_t>(units);
  const auto b = static_cast<unsigned>(blocks);
  switch (vec) {
    case 1:
      return launch_chunks<1>(chunks, table, indices, weights, offsets, out,
                              num_bags, num_rows, u, lanes, groups, slices,
                              mean, b, s);
    case 2:
      return launch_chunks<2>(chunks, table, indices, weights, offsets, out,
                              num_bags, num_rows, u, lanes, groups, slices,
                              mean, b, s);
    default:
      return launch_chunks<4>(chunks, table, indices, weights, offsets, out,
                              num_bags, num_rows, u, lanes, groups, slices,
                              mean, b, s);
  }
}

extern "C" const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
