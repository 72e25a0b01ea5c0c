// One BFS level of the positional PRecursive join: frontier vertices -> the
// CSR positions of their out-edges, concatenated in frontier order.
//
// Replaces: src/repro/kernels/frontier_expand/frontier_expand.py,
//   expand_index_pallas (phase A, rank inversion), together with its
//   wrapper's prologue and phase B (src/repro/kernels/frontier_expand/ops.py,
//   frontier_expand_fused: csr_degrees, the cumsum of the degrees, the CSR
//   range starts, and the late_gather_pallas gather of perm).
//
// What bounds it on an H100: device-memory bytes.  It must read each target
// and its valid flag once (5 bytes), two indptr entries per live target and
// the perm entries the level reaches, and write the (capacity,) output once:
// about 3.7 MB at the engine's widest level, about a microsecond at
// 3.35 TB/s.  There is no arithmetic to speak of.  What kept the earlier
// port from that bound was the host and the search: its wrapper ran the
// degrees, the cumsum and the range starts as 17 torch launches a level,
// each with its own host cost, and its kernel gave every output slot a
// dependent binary search over all F entries of `ends`.
//
// Design: frontier_expand_launch issues three kernels back to back on one
// stream from one C call: no torch op between them, no host sync.
//   1. frontier_degree_sums: a block of kThreads threads owns a tile of
//      kTile targets, kItems a thread, warp-striped so that every load of
//      a warp is coalesced.  It computes each degree as csr_degrees does
//      and writes the tile's sum to block_sums.
//   2. frontier_scan_ends: each block recomputes its tile's degrees,
//      reduces the sums of the tiles before it (F / kTile values at most,
//      L2 hits) into its exclusive prefix, scans the tile with warp
//      shuffles and writes the inclusive int32 `ends`, equal to
//      torch.cumsum(deg, dtype=int32).  The engine deduplicates targets,
//      so the total is at most E and cannot wrap.
//   3. frontier_expand_slots: a block owns kThreads output slots.  Two
//      lanes of warp 0 find, by upper_bound over all of `ends`, the
//      producing frontier slot of the tile's first and last live output
//      slot; every thread then searches only that range for its own slot
//      (one entry when a hub vertex fills the tile) and gathers
//      perm[indptr[target] + (j - start)].  Slots at or past the level's
//      total (ends[F-1], read on the device) get the sentinel E.  Degrees
//      and range starts never go to memory.  Block 0 writes
//      min(total, capacity) and total > capacity.
// At F = 0 only the expansion runs, with a total of 0.
//
// Lanes: a batch of roots expands L frontiers of one F over the one shared
// CSR in the same three launches, blockIdx.y being the lane.  Each lane
// has its own rows of targets, flags, block sums, ends and output, its own
// count and overflow flag; the pointers are moved to the lane's row at the
// top of each kernel, so a lane's scan reads only its own tile sums.  One
// root is L = 1.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // targets a thread, kernels 1-2
constexpr int kTile = kThreads * kItems;    // targets a block, kernels 1-2
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int64_t kMaxLanes = 65535;        // gridDim.y's limit

// The degrees of this thread's kItems targets of the block's tile.  Warp w
// owns the tile's targets [w * 32 * kItems, (w + 1) * 32 * kItems); item k
// of lane l is the (k * 32 + l)-th of them.  A degree is
// indptr[t + 1] - indptr[t] for a valid target t in [0, V), else 0.
// `targets` and `valid` are the block's lane's rows.
__device__ __forceinline__ void tile_degrees(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ targets,
    const uint8_t* __restrict__ valid, int64_t frontier,
    int32_t num_vertices, int32_t (&deg)[kItems]) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       (threadIdx.x >> 5) * (32 * kItems) +
                       (threadIdx.x & 31);
  int32_t t[kItems];
  uint8_t live[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {   // every load in flight at once
    const int64_t i = base + k * 32;
    t[k] = i < frontier ? __ldg(targets + i) : -1;
    live[k] = i < frontier ? __ldg(valid + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    deg[k] = (live[k] && t[k] >= 0 && t[k] < num_vertices)
                 ? __ldg(indptr + t[k] + 1) - __ldg(indptr + t[k])
                 : 0;
  }
}

// The sum of v over the block, in every thread.  `scratch` holds kWarps
// values and is not written again by the caller.
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
frontier_degree_sums(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ targets,
                     const uint8_t* __restrict__ valid,
                     int32_t* __restrict__ block_sums, int64_t frontier,
                     int32_t num_vertices) {
  __shared__ int32_t scratch[kWarps];
  const int64_t lane_row = static_cast<int64_t>(blockIdx.y) * frontier;
  targets += lane_row;
  valid += lane_row;
  block_sums += static_cast<int64_t>(blockIdx.y) * gridDim.x;
  int32_t deg[kItems];
  tile_degrees(indptr, targets, valid, frontier, num_vertices, deg);
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += deg[k];
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
frontier_scan_ends(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ targets,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ block_sums,
                   int32_t* __restrict__ ends, int64_t frontier,
                   int32_t num_vertices) {
  __shared__ int32_t scratch[kWarps];
  __shared__ int32_t warp_totals[kWarps];
  const int64_t lane_row = static_cast<int64_t>(blockIdx.y) * frontier;
  targets += lane_row;
  valid += lane_row;
  ends += lane_row;
  block_sums += static_cast<int64_t>(blockIdx.y) * gridDim.x;
  int32_t deg[kItems];
  tile_degrees(indptr, targets, valid, frontier, num_vertices, deg);

  // the exclusive prefix of this tile: the sums of the lane's tiles before
  // it
  int32_t before = 0;
  for (unsigned b = threadIdx.x; b < blockIdx.x; b += kThreads) {
    before += __ldg(block_sums + b);
  }
  before = block_sum(before, scratch);

  // warp scan in target order: item k of lanes 0..31, then item k + 1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t incl[kItems];
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int32_t x = deg[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    incl[k] = carry + x;
    carry += __shfl_sync(kFullMask, x, 31);
  }
  if (lane == 0) warp_totals[warp] = carry;
  __syncthreads();
  int32_t prefix = before;
  for (int w = 0; w < warp; ++w) prefix += warp_totals[w];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       warp * (32 * kItems) + lane;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * 32;
    if (i < frontier) ends[i] = prefix + incl[k];
  }
}

// The first s in [lo, hi] with ends[s] > j; the caller guarantees
// ends[hi] > j.
__device__ __forceinline__ int32_t upper_bound(
    const int32_t* __restrict__ ends, int32_t lo, int32_t hi, int32_t j) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(ends + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
frontier_expand_slots(const int32_t* __restrict__ indptr,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ targets,
                      const int32_t* __restrict__ ends,
                      int32_t* __restrict__ out,
                      int32_t* __restrict__ out_count,
                      uint8_t* __restrict__ out_overflow, int32_t frontier,
                      int64_t capacity, int32_t num_edges) {
  __shared__ int32_t range[2];   // producing slots of the first, last live
  const int64_t lane_row = static_cast<int64_t>(blockIdx.y) * frontier;
  targets += lane_row;
  ends += lane_row;
  out += static_cast<int64_t>(blockIdx.y) * capacity;
  out_count += blockIdx.y;
  out_overflow += blockIdx.y;
  const int32_t total = frontier > 0 ? __ldg(ends + frontier - 1) : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *out_count = static_cast<int32_t>(
        total < capacity ? static_cast<int64_t>(total) : capacity);
    *out_overflow = total > capacity ? 1 : 0;
  }
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kThreads;
  int64_t live_end = tile_start + kThreads;   // exclusive
  if (live_end > capacity) live_end = capacity;
  if (live_end > total) live_end = total;
  const int64_t j = tile_start + threadIdx.x;
  if (tile_start >= live_end) {               // every slot is a sentinel
    if (j < capacity) out[j] = num_edges;
    return;
  }
  if (threadIdx.x < 2) {
    const int64_t key = threadIdx.x == 0 ? tile_start : live_end - 1;
    range[threadIdx.x] =
        upper_bound(ends, 0, frontier - 1, static_cast<int32_t>(key));
  }
  __syncthreads();
  if (j >= capacity) return;
  int32_t result = num_edges;
  if (j < live_end) {
    const int32_t jj = static_cast<int32_t>(j);
    const int32_t s = upper_bound(ends, range[0], range[1], jj);
    // ends[s] > j >= ends[s - 1], so the degree of slot s is positive: its
    // target is valid and in [0, V)
    const int32_t start = s > 0 ? __ldg(ends + s - 1) : 0;
    result = __ldg(perm + __ldg(indptr + __ldg(targets + s)) + (jj - start));
  }
  out[j] = result;
}

}  // namespace

// indptr (V + 1,), perm (E,) shared; targets (L, F) int32 and valid
// (L, F) bytes of 0 or 1 in; block_sums (L, ceil(F / kTile)) and ends
// (L, F) int32 scratch; out (L, capacity) int32, out_count (L,) int32 and
// out_overflow (L,) bytes written, all row-major and contiguous.  The
// caller guarantees F, V, E and capacity in [0, 2^31) and L in [1, 65535]
// (gridDim.y's limit); anything else is refused, never cut.  Returns the
// first launch error, or 0.
extern "C" int frontier_expand_launch(
    const void* indptr, const void* perm, const void* targets,
    const void* valid, void* block_sums, void* ends, void* out,
    void* out_count, void* out_overflow, int64_t lanes, int64_t frontier,
    int64_t num_vertices, int64_t num_edges, int64_t capacity,
    void* stream) {
  constexpr int64_t kMax = int64_t{1} << 31;
  if (lanes < 1 || lanes > kMaxLanes || frontier < 0 || frontier >= kMax ||
      num_vertices < 0 || num_vertices >= kMax || num_edges < 0 ||
      num_edges >= kMax || capacity < 0 || capacity >= kMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* indptr_ = static_cast<const int32_t*>(indptr);
  const auto* targets_ = static_cast<const int32_t*>(targets);
  const auto* valid_ = static_cast<const uint8_t*>(valid);
  auto* block_sums_ = static_cast<int32_t*>(block_sums);
  auto* ends_ = static_cast<int32_t*>(ends);
  if (frontier > 0) {
    const dim3 tiles(static_cast<unsigned>((frontier + kTile - 1) / kTile),
                     static_cast<unsigned>(lanes));
    frontier_degree_sums<<<tiles, kThreads, 0, s>>>(
        indptr_, targets_, valid_, block_sums_, frontier,
        static_cast<int32_t>(num_vertices));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    frontier_scan_ends<<<tiles, kThreads, 0, s>>>(
        indptr_, targets_, valid_, block_sums_, ends_, frontier,
        static_cast<int32_t>(num_vertices));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = (capacity + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;   // block 0 writes the count and the flag
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(lanes));
  frontier_expand_slots<<<grid, kThreads, 0, s>>>(
      indptr_, static_cast<const int32_t*>(perm), targets_, ends_,
      static_cast<int32_t*>(out), static_cast<int32_t*>(out_count),
      static_cast<uint8_t*>(out_overflow), static_cast<int32_t>(frontier),
      capacity, static_cast<int32_t>(num_edges));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
