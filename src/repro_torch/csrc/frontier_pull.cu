// One bottom-up (pull) level of direction-optimizing BFS: the next frontier
// is every unvisited vertex with an in-neighbor (over the join view) in the
// frontier bitmap.
//
// Replaces: src/repro/kernels/frontier_pull/frontier_pull.py,
//   pull_contrib_pallas (the per-entry membership test) together with the
//   two perm-ordered gathers and the per-vertex segment-OR + `& ~visited`
//   that its wrapper (ops.py, frontier_pull_fused) runs around it in XLA.
//
// Input: the reverse layout (kernels/frontier_pull/layout.py), built once
// per dataset and orientation: ptr (V+1), the clamped in-neighbors nbr (E)
// in reverse-CSR order, and the hub tiles (tile_vtx, tile_start) of every
// row longer than kShortRow.
//
// What bounds it on an H100: device-memory bytes and, at a level where
// few vertices are open, launch latency.  Every vertex reads its visited
// byte and writes its output byte, coalesced (2 V bytes); only an
// unvisited vertex reads its two ptr words and its row of nbr, up to the
// first entry whose in-neighbor is in the frontier (one scattered byte
// each).  The TPU kernel tested every entry with chunked one-hot masked
// sums (VMEM has no dynamic gather) and left the OR to an XLA scatter-max;
// here the walk stops at the first hit, and nothing is read for a vertex
// already visited.
//
// Design: two kernels from one C call, on one stream.
//   frontier_pull_rows — one thread per vertex.  It writes out[v] once:
//     0 when visited; otherwise it walks a row of at most kShortRow
//     entries, kBatch entries' loads in flight at a time, stopping after
//     the first batch with a hit.  A longer row is left 0 here.
//   frontier_pull_tiles — one warp per hub tile of kTile entries (8 a
//     lane, all loads in flight), launched only when the layout has tiles.
//     A tile of an unvisited vertex with a hit stores 1; several tiles of
//     one row store the same byte, so no atomics, and the stream orders
//     them after the rows kernel's 0.  One thread walking the deployment
//     tree's 83,619-entry row would set the whole call's time; its tiles
//     spread it over 327 warps.
// Every output byte is written by the kernels, so no memset precedes them.
// The result is boolean: bit-equal to the plain version on any input.
//
// Lanes: a batch of roots pulls L (V,) byte planes of frontier, visited
// and output over the one shared layout in the same 1 or 2 launches,
// blockIdx.y being the lane; each kernel moves the plane pointers to its
// lane's row first.  One root is L = 1.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kShortRow = 16;        // SHORT_ROW in layout.py
constexpr int kTile = 256;           // HUB_TILE in layout.py
constexpr int kPerLane = kTile / 32;
constexpr int kBatch = 4;            // a thread row's loads in flight
constexpr int64_t kMaxLanes = 65535; // gridDim.y's limit

__global__ void __launch_bounds__(kThreads)
frontier_pull_rows(const int32_t* __restrict__ ptr,
                   const int32_t* __restrict__ nbr,
                   const uint8_t* __restrict__ frontier,
                   const uint8_t* __restrict__ visited,
                   uint8_t* __restrict__ out, int32_t num_vertices) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (v >= num_vertices) return;
  const int64_t plane = static_cast<int64_t>(blockIdx.y) * num_vertices;
  frontier += plane;
  visited += plane;
  out += plane;
  bool hit = false;
  if (!__ldg(visited + v)) {
    const int32_t begin = __ldg(ptr + v);
    const int32_t end = __ldg(ptr + v + 1);
    if (end - begin <= kShortRow) {
      for (int32_t q = begin; q < end && !hit; q += kBatch) {
        int32_t ids[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          ids[k] = q + k < end ? __ldg(nbr + q + k) : -1;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          hit |= ids[k] >= 0 && __ldg(frontier + ids[k]) != 0;
      }
    }
  }
  out[v] = hit;
}

__global__ void __launch_bounds__(kThreads)
frontier_pull_tiles(const int32_t* __restrict__ ptr,
                    const int32_t* __restrict__ nbr,
                    const int32_t* __restrict__ tile_vtx,
                    const int32_t* __restrict__ tile_start,
                    int32_t num_tiles,
                    const uint8_t* __restrict__ frontier,
                    const uint8_t* __restrict__ visited,
                    uint8_t* __restrict__ out, int32_t num_vertices) {
  // warp-uniform exits, so the whole warp reaches the vote below
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / 32;
  if (t >= num_tiles) return;
  const int64_t plane = static_cast<int64_t>(blockIdx.y) * num_vertices;
  frontier += plane;
  visited += plane;
  out += plane;
  const int32_t v = __ldg(tile_vtx + t);
  if (__ldg(visited + v)) return;
  const int lane = threadIdx.x & 31;
  const int32_t begin = __ldg(tile_start + t);
  const int32_t end = min(begin + kTile, __ldg(ptr + v + 1));
  int32_t ids[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int32_t q = begin + k * 32 + lane;
    ids[k] = q < end ? __ldg(nbr + q) : -1;
  }
  bool hit = false;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    hit |= ids[k] >= 0 && __ldg(frontier + ids[k]) != 0;
  if (__any_sync(0xffffffffu, hit) && lane == 0) out[v] = 1;
}

}  // namespace

// The layout (ptr, nbr, tile_vtx, tile_start) is shared; frontier,
// visited and out are (L, V) row-major byte planes.  L must be in
// [1, 65535] (gridDim.y's limit): anything else is refused, never cut.
extern "C" int frontier_pull_launch(const void* ptr, const void* nbr,
                                    const void* tile_vtx,
                                    const void* tile_start,
                                    int64_t num_tiles, const void* frontier,
                                    const void* visited, void* out,
                                    int64_t lanes, int64_t num_vertices,
                                    int64_t short_row, int64_t tile,
                                    void* stream) {
  // the layout must have been cut for this kernel's row limit and tile
  if (short_row != kShortRow || tile != kTile || num_vertices < 1 ||
      num_vertices > INT32_MAX || num_tiles < 0 || num_tiles > INT32_MAX ||
      lanes < 1 || lanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int32_t*>(ptr);
  const auto* n = static_cast<const int32_t*>(nbr);
  const auto* f = static_cast<const uint8_t*>(frontier);
  const auto* vis = static_cast<const uint8_t*>(visited);
  auto* o = static_cast<uint8_t*>(out);
  const dim3 row_grid(
      static_cast<unsigned>((num_vertices + kThreads - 1) / kThreads),
      static_cast<unsigned>(lanes));
  frontier_pull_rows<<<row_grid, kThreads, 0, s>>>(
      p, n, f, vis, o, static_cast<int32_t>(num_vertices));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_tiles == 0) return static_cast<int>(err);
  const dim3 tile_grid(
      static_cast<unsigned>((num_tiles + kWarpsPerBlock - 1) /
                            kWarpsPerBlock),
      static_cast<unsigned>(lanes));
  frontier_pull_tiles<<<tile_grid, kThreads, 0, s>>>(
      p, n, static_cast<const int32_t*>(tile_vtx),
      static_cast<const int32_t*>(tile_start),
      static_cast<int32_t>(num_tiles), f, vis, o,
      static_cast<int32_t>(num_vertices));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
