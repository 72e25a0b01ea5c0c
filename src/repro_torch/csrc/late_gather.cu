// Positional row gather of several columns at once: the late Materialize of
// the PRecursive plan.  For every column c and every position i,
//   out_c[i, :] = table_c[row(positions[i]), :]
// where row(p) = p for 0 <= p < R, p + R for -R <= p < 0 (wrapped once, as
// a JAX index is), and a zero row for p >= R (the engines' padding
// sentinel is num_rows) or p < -R.  All columns share R and the positions.
//
// Replaces: src/repro/kernels/late_gather/late_gather.py,
//   late_gather_pallas, together with the fusion of its ops.materialize,
//   which gathers every output column in one wide pass.
//
// What bounds it on an H100: device-memory bytes.  It reads each position
// once (4 bytes), each distinct live row of each column once and writes
// each output row of each column once: at most P x 4 + 2 x P x (the sum of
// the columns' row bytes) against 3.35 TB/s.  No arithmetic.
//
// Design: the TPU kernel DMA'd one (1, 128)-lane row block per grid step,
// steered by scalar-prefetched positions, and ops.materialize cast every
// column to float32 and concatenated them so that one gather served all.
// Here one launch takes up to kMaxColumns column descriptors by value, each
// column in its own dtype, copied as bit patterns (int32 ids above 2^24
// survive, which a float32 round trip would round).  A block owns a tile of
// kTile positions: it loads them once, wraps or masks them into rows in
// shared memory, then copies the tile's rows of every column in turn.  A
// row is copied in chunks of the widest of 16, 8, 4 or 2 bytes that
// divides its row bytes and both base addresses; neighbouring threads take
// neighbouring chunks of the tile's output, so stores are coalesced and a
// row's read is one contiguous run.  Each thread keeps kUnroll chunks in
// flight before it stores any.  Offsets into the tables and outputs are
// 64-bit; an index inside a tile is 32-bit (kTile x a row's chunks, which
// the launcher bounds).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;        // positions per block, one per thread
constexpr int kUnroll = 4;        // chunks a thread loads before it stores
constexpr int kMaxColumns = 32;   // must match the launcher's MAX_COLUMNS
constexpr int64_t kMaxRowBytes = int64_t{1} << 24;

struct Column {
  const void* src;
  void* dst;
  uint32_t chunks;   // chunks of `width` bytes in one row
  int32_t width;     // 16, 8, 4 or 2
};

struct Columns {
  Column col[kMaxColumns];
  int32_t count;
};

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0, 0, 0, 0);
}
template <>
__device__ __forceinline__ uint2 zero<uint2>() {
  return make_uint2(0, 0);
}
template <>
__device__ __forceinline__ unsigned int zero<unsigned int>() {
  return 0u;
}
template <>
__device__ __forceinline__ unsigned short zero<unsigned short>() {
  return 0;
}

// One column's rows of this block's tile: chunk idx of the tile's output
// is chunk idx % chunks of the row of tile position idx / chunks.
template <typename V>
__device__ __forceinline__ void copy_column(const Column& c,
                                            const int64_t* rows,
                                            int64_t tile_start,
                                            uint32_t tile_rows) {
  const uint32_t chunks = c.chunks;
  const uint32_t total = tile_rows * chunks;
  const V* __restrict__ src = static_cast<const V*>(c.src);
  V* __restrict__ dst = static_cast<V*>(c.dst) + tile_start * chunks;
  for (uint32_t base = threadIdx.x; base < total; base += kTile * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t idx = base + u * kTile;
      v[u] = zero<V>();
      if (idx < total) {
        const uint32_t i = idx / chunks;
        const int64_t row = rows[i];
        if (row >= 0) v[u] = __ldg(src + row * chunks + (idx - i * chunks));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t idx = base + u * kTile;
      if (idx < total) dst[idx] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kTile)
late_gather_kernel(const Columns cols, const int32_t* __restrict__ positions,
                   int64_t num_pos, int64_t num_rows) {
  __shared__ int64_t rows[kTile];   // the tile's rows; -1: a zero row
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t left = num_pos - tile_start;
  const uint32_t tile_rows =
      static_cast<uint32_t>(left < kTile ? left : kTile);
  if (threadIdx.x < tile_rows) {
    int64_t p = __ldg(positions + tile_start + threadIdx.x);
    if (p < 0) p += num_rows;
    rows[threadIdx.x] = (p >= 0 && p < num_rows) ? p : -1;
  }
  __syncthreads();
  for (int k = 0; k < cols.count; ++k) {
    const Column c = cols.col[k];
    if (c.width == 16) {
      copy_column<uint4>(c, rows, tile_start, tile_rows);
    } else if (c.width == 8) {
      copy_column<uint2>(c, rows, tile_start, tile_rows);
    } else if (c.width == 4) {
      copy_column<unsigned int>(c, rows, tile_start, tile_rows);
    } else {
      copy_column<unsigned short>(c, rows, tile_start, tile_rows);
    }
  }
}

// The widest of 16, 8, 4 and 2 bytes that divides the row bytes and both
// addresses; 0 if not even 2 does.
int copy_width(int64_t row_bytes, const void* src, const void* dst) {
  const uint64_t bits = static_cast<uint64_t>(row_bytes) |
                        reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(dst);
  for (int w = 16; w >= 2; w /= 2) {
    if (bits % w == 0) return w;
  }
  return 0;
}

}  // namespace

// desc holds num_cols triples (source address, destination address, row
// bytes) of (num_rows, row bytes) tables and (num_pos, row bytes) outputs.
// The caller guarantees num_pos >= 1, 1 <= num_cols <= kMaxColumns, and
// each row bytes even, in [2, kMaxRowBytes).
extern "C" int late_gather_launch(const int64_t* desc, int num_cols,
                                  const void* positions, int64_t num_pos,
                                  int64_t num_rows, void* stream) {
  if (num_cols < 1 || num_cols > kMaxColumns || num_pos < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Columns cols{};
  cols.count = num_cols;
  for (int k = 0; k < num_cols; ++k) {
    const auto src = reinterpret_cast<const void*>(desc[3 * k]);
    const auto dst = reinterpret_cast<void*>(desc[3 * k + 1]);
    const int64_t row_bytes = desc[3 * k + 2];
    const int width = copy_width(row_bytes, src, dst);
    if (width == 0 || row_bytes < 2 || row_bytes >= kMaxRowBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cols.col[k] = {src, dst, static_cast<uint32_t>(row_bytes / width),
                   width};
  }
  const int64_t blocks = (num_pos + kTile - 1) / kTile;
  late_gather_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      cols, static_cast<const int32_t*>(positions), num_pos, num_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* late_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
