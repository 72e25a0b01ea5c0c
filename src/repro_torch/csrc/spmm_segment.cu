// Fused gather-scale-segment-sum over edges grouped by destination:
//   out[v, :] = sum over edges i of segment v of w[i] * x[src[i], :]
// where segment v is [offsets[v], offsets[v + 1]) of the destination-sorted
// edge arrays; an empty segment gives a zero row and an edge whose src is
// outside [0, N) contributes 0 (the caller's padding is src = N).  The
// edges before offsets[0] and from offsets[num_out] on are dropped (their
// destination was out of range).
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
// rate.  What keeps a kernel from that bound is a long row: a row summed
// by one thread, or one block, is one chain of dependent adds and one
// memory latency after another while the other SMs idle (the 2^20-vertex
// tree's inbound view gives vertex 0 83,619 edges).
//
// Design.  The rule: no thread walks more than 64 edges, or 64 partial
// sums, one after another, at any D.  Rows fall into three classes by
// degree, with S = 32 and a tile of P edges and a hub threshold H = 2P
// chosen per D by the launcher (kernels/spmm_segment/spmm_segment.py,
// tile_plan): P = max(256, 4096 / L) for L = min(32, next power of two
// >= D), so D = 1: P = 4,096, H = 8,192; D = 2: 2,048 / 4,096;
// D = 4: 1,024 / 2,048; D = 8: 512 / 1,024; D >= 16: 256 / 512.  A
// larger P means fewer tile blocks, which cost every call with E > H
// whether or not it has a hub.
//
// Threads cover a row's columns in units of one float, or of a float4
// where D % 4 == 0 and x is 16-byte aligned.  `lanes` threads (a power of
// two, at most 32) share one row or one edge stride and take the units
// lane, lane + lanes, ...; a block of 256 threads holds 256 / lanes such
// slots.
//
//  1. Short rows (at most S edges).  spmm_segment_rows gives each block
//     256 / lanes rows; the slot of a row adds its terms in sorted order,
//     starting from +0, with __fmul_rn/__fadd_rn (no FMA contraction):
//     the order and rounding of the plain version's index_add_ on the
//     CPU, bit for bit.  A slot of one lane reads w[i] and the x row only
//     for a live source (the engine pads most sources of a level); a
//     wider slot loads 4 terms at once.
//  2. Medium rows (S < degree <= H).  The block that owns the row sums it
//     with all its threads, one row after another: slot j adds edges
//     lo + j, lo + j + slots, ... from +0; the slots of a warp are added
//     by a fixed xor butterfly, then the 8 warp sums in warp order.
//  3. Hub rows (degree > H).  The sorted edge array is cut at the fixed
//     tile starts k * P (T = ceil(E / P) of them); every hub holds at
//     least two, since H = 2P.
//     - spmm_segment_rows runs T tile blocks before its row blocks.  Tile
//       block k finds the row that holds edge k * P by a warp-wide 32-ary
//       search of the offsets (4 dependent loads for 2^20 rows) and writes
//       tile_row[k]: that row if it is a hub, else -1 (also where the
//       edge's destination was dropped).  So every entry has one writer
//       and nothing is filled beforehand.  For a hub it sums the hub's
//       edges [k * P, min((k + 1) * P, hi)) block-wide, as a medium row,
//       into partial[k, :]; at the hub's first tile start it also takes
//       the prefix from the hub's first edge, which no tile start owns.
//       Row blocks leave hub rows alone.
//     - spmm_segment_hub_fixup, one block per tile start: where k is its
//       hub's first tile start, it adds the hub's partials in tile order
//       by the same fixed tree (slot j takes partials j, j + slots, ...)
//       and writes out[hub].  Blocks whose tile_row is -1 return after
//       one load.
// One C call issues the two kernels on one stream, the second only when
// E > H (the host knows E), so a call is 1 or 2 device launches.  No host
// sync, no fill, no atomics on the output, no library kernel; the scratch
// (partial (T, D) float32, tile_row (T,) int32) comes from the launcher's
// torch.empty.  Every order of addition is fixed by the offsets alone, so
// two calls give the same bits.
//
// Chains: a tile with its prefix is under 2P edges and a medium row at
// most 2P, so a slot walks at most 2P / slots of them: 32 at D <= 16, 64
// from D = 17 on (8 slots).  In a medium row or a tile a slot loads the
// source ids and weights of 4 terms (8 in a hub tile), then their x rows,
// and only then adds them in order, rather than waiting one memory
// latency per term.  A fixup walks (hub degree / P) / slots partials: 41
// for an 83,619-edge hub at D >= 17.  What is left serial is a block
// whose rows are all medium: it sums them one after another (up to 256
// rows of H = 8,192 edges at D = 1).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a multiple of the warp
constexpr int kWarps = kThreads / 32;
constexpr int kShortRow = 32;   // S
constexpr unsigned kFullMask = 0xffffffffu;

// How a block's threads cover a row's columns (see the note above).
struct Layout {
  int32_t units;   // column units of a row: D, or D / 4 with float4s
  int lanes;       // threads a slot: a power of two, at most 32
  int slots;       // kThreads / lanes
};

Layout make_layout(int32_t dim, bool vec4) {
  Layout l;
  l.units = vec4 ? dim / 4 : dim;
  l.lanes = 1;
  while (l.lanes < 32 && l.lanes < l.units) l.lanes <<= 1;
  l.slots = kThreads / l.lanes;
  return l;
}

template <bool kVec4>
struct Vec;

template <>
struct Vec<false> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T add(T a, T b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ T scale(T a, float w) {
    return __fmul_rn(a, w);
  }
  static __device__ __forceinline__ T shfl_xor(T a, int o) {
    return __shfl_xor_sync(kFullMask, a, o);
  }
};

template <>
struct Vec<true> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ T scale(T a, float w) {
    return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w),
                       __fmul_rn(a.z, w), __fmul_rn(a.w, w));
  }
  static __device__ __forceinline__ T shfl_xor(T a, int o) {
    return make_float4(__shfl_xor_sync(kFullMask, a.x, o),
                       __shfl_xor_sync(kFullMask, a.y, o),
                       __shfl_xor_sync(kFullMask, a.z, o),
                       __shfl_xor_sync(kFullMask, a.w, o));
  }
};

// Edge i's term, in two steps so that a thread can have several loads in
// flight: ref(i) loads src[i] and w[i], value(ref, u) loads unit u of the
// x row and gives w[i] * x[src[i], u], or 0 for a padded source.
template <bool kVec4>
struct EdgeTerms {
  using T = typename Vec<kVec4>::T;
  struct Ref {
    int32_t s;
    float w;
  };
  const T* __restrict__ x;   // (N, units)
  const int32_t* __restrict__ src;
  const float* __restrict__ w;
  int32_t num_nodes;
  int32_t units;

  __device__ __forceinline__ Ref ref(int64_t i) const {
    return {__ldg(src + i), __ldg(w + i)};
  }
  __device__ __forceinline__ T value(const Ref& r, int32_t u) const {
    const bool live = r.s >= 0 && r.s < num_nodes;
    const T v = live ? __ldg(x + static_cast<int64_t>(r.s) * units + u)
                     : Vec<kVec4>::zero();
    return live ? Vec<kVec4>::scale(v, r.w) : Vec<kVec4>::zero();
  }

  // Unit u of the sum of terms lo, lo + 1, ... below hi, in that order
  // from +0, one term at a time: w[i] and the x row are read only for a
  // live source (skipping a padded term's +0 changes no sum).
  __device__ __forceinline__ T live_sum(int64_t lo, int64_t hi,
                                        int32_t u) const {
    T acc = Vec<kVec4>::zero();
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t s = __ldg(src + i);
      if (s >= 0 && s < num_nodes) {
        acc = Vec<kVec4>::add(acc, Vec<kVec4>::scale(
            __ldg(x + static_cast<int64_t>(s) * units + u), __ldg(w + i)));
      }
    }
    return acc;
  }
};

// Tile k's partial sum (written by spmm_segment_rows' tile blocks), in
// the same two steps.
template <bool kVec4>
struct PartialTerms {
  using T = typename Vec<kVec4>::T;
  using Ref = int64_t;
  const T* __restrict__ partial;   // (T, units)
  int32_t units;

  __device__ __forceinline__ Ref ref(int64_t k) const { return k; }
  __device__ __forceinline__ T value(Ref k, int32_t u) const {
    return __ldg(partial + k * units + u);
  }
};

// The sum of unit u of the terms i = lo, lo + stride, ... below hi, added
// in that order from +0; kBatch refs, then kBatch values, are loaded at
// once.
template <bool kVec4, int kBatch, class Term>
__device__ __forceinline__ typename Vec<kVec4>::T range_sum(
    const Term& term, int64_t lo, int64_t hi, int stride, int32_t u) {
  using Op = Vec<kVec4>;
  typename Op::T acc = Op::zero();
  int64_t i = lo;
  for (; i + (kBatch - 1) * static_cast<int64_t>(stride) < hi;
       i += kBatch * static_cast<int64_t>(stride)) {
    typename Term::Ref r[kBatch];
    typename Op::T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) r[q] = term.ref(i + q * stride);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) v[q] = term.value(r[q], u);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) acc = Op::add(acc, v[q]);
  }
  for (; i < hi; i += stride) acc = Op::add(acc, term.value(term.ref(i), u));
  return acc;
}

// The first tile start at or after edge i: ceil(i / P), P = 2^tile_shift.
__device__ __forceinline__ int64_t first_tile(int64_t i, int tile_shift) {
  return (i + (int64_t{1} << tile_shift) - 1) >> tile_shift;
}

// dst[u] = the sum over i in [a, b) of unit u of term i, for every unit u,
// by the whole block in a fixed order: slot j adds i = a + j, a + j + slots,
// ... from +0; the slots of a warp are added by an xor butterfly, then
// the warp sums in warp order.  Every thread of the block calls it with
// the same arguments (it has barriers); `wsum` holds kWarps * 32 units.
template <bool kVec4, int kBatch, class Term>
__device__ void block_range_sum(const Term& term, int64_t a, int64_t b,
                                const Layout& l,
                                typename Vec<kVec4>::T* __restrict__ dst,
                                typename Vec<kVec4>::T* wsum) {
  using Op = Vec<kVec4>;
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x & (l.lanes - 1);
  const int slot = threadIdx.x / l.lanes;
  for (int32_t u0 = 0; u0 < l.units; u0 += l.lanes) {
    const int32_t u = u0 + c;
    T part = u < l.units
                 ? range_sum<kVec4, kBatch>(term, a + slot, b, l.slots, u)
                 : Op::zero();
    for (int o = 16; o >= l.lanes; o >>= 1) {
      part = Op::add(part, Op::shfl_xor(part, o));
    }
    if (lane < l.lanes) wsum[warp * 32 + lane] = part;
    __syncthreads();
    if (threadIdx.x < l.lanes && u < l.units) {   // here c == threadIdx.x
      T s = wsum[threadIdx.x];
      for (int k = 1; k < kWarps; ++k) {
        s = Op::add(s, wsum[k * 32 + threadIdx.x]);
      }
      dst[u] = s;
    }
    __syncthreads();
  }
}

// The first i in [0, n) with a[i] > t (n if none), a non-decreasing, by a
// whole warp: each step probes 32 evenly spaced entries of the range left
// and keeps the piece between the last probe <= t and the first > t, so
// n = 2^20 + 1 offsets take 4 dependent loads.
__device__ __forceinline__ int64_t warp_upper_bound(
    const int32_t* __restrict__ a, int64_t n, int64_t t) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;   // a[i] <= t below lo, a[i] > t from hi on
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + (lane + 1) * step - 1;
    const bool le = probe < hi && __ldg(a + probe) <= t;
    const int m = __popc(__ballot_sync(kFullMask, le));   // a prefix
    const int64_t above = lo + (m + 1) * step - 1;   // lane m's probe
    lo += m * step;
    if (above < hi) hi = above;
  }
  return lo;
}

// Kernel 1, blocks [0, num_tiles): block k finds the row that holds edge
// k * P, writes tile_row[k] (that row if it is a hub, else -1) and for a
// hub sums the hub's edges of tile k, with the hub's prefix at its first
// tile start, into partial[k, :].
template <bool kVec4>
__device__ void hub_tile(const EdgeTerms<kVec4>& term,
                         const int32_t* __restrict__ offsets,
                         typename Vec<kVec4>::T* __restrict__ partial,
                         int32_t* __restrict__ tile_row, int64_t num_out,
                         const Layout& l, int tile_shift, int64_t hub_edges,
                         int64_t k, typename Vec<kVec4>::T* wsum,
                         int64_t* bounds) {
  const int64_t start = k << tile_shift;
  if (threadIdx.x < 32) {
    // row idx - 1 holds edge `start` when 0 < idx <= num_out; otherwise
    // the edge's destination was dropped
    const int64_t idx = warp_upper_bound(offsets, num_out + 1, start);
    int64_t v = -1, lo = 0, hi = 0;
    if (idx > 0 && idx <= num_out) {
      lo = __ldg(offsets + idx - 1);
      hi = __ldg(offsets + idx);
      if (hi - lo > hub_edges) v = idx - 1;
    }
    if (threadIdx.x == 0) {
      tile_row[k] = static_cast<int32_t>(v);
      bounds[0] = v;
      bounds[1] = lo;
      bounds[2] = hi;
    }
  }
  __syncthreads();
  if (bounds[0] < 0) return;   // the whole block
  const int64_t lo = bounds[1], hi = bounds[2];
  const int64_t next = (k + 1) << tile_shift;
  const int64_t a = first_tile(lo, tile_shift) == k ? lo : start;
  const int64_t b = next < hi ? next : hi;
  block_range_sum<kVec4, 8>(term, a, b, l, partial + k * l.units, wsum);
}

// Kernel 1: blocks [0, num_tiles) are the hub tiles above; after them a
// block owns l.slots consecutive rows.  Short rows are summed by their
// slot, medium rows by the block, and hub rows left to the tiles (there
// is none unless E > H, when num_tiles > 0).  A block of short rows only
// (the common case) meets one barrier.  The tile path would raise the
// kernel to 40 registers (59 with float4s); the bound keeps it at 32 (48),
// 8 (5) blocks an SM, for the row blocks, which are latency-bound.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads, kVec4 ? 5 : 8)
spmm_segment_rows(EdgeTerms<kVec4> term, const int32_t* __restrict__ offsets,
                  typename Vec<kVec4>::T* __restrict__ out,
                  typename Vec<kVec4>::T* __restrict__ partial,
                  int32_t* __restrict__ tile_row, int64_t num_out, Layout l,
                  int tile_shift, int64_t hub_edges, int64_t num_tiles) {
  using T = typename Vec<kVec4>::T;
  __shared__ int32_t medium_rows[kThreads];
  __shared__ int num_medium;
  __shared__ int64_t bounds[3];
  __shared__ float4 wsum_raw[kWarps * 32];
  T* wsum = reinterpret_cast<T*>(wsum_raw);

  if (blockIdx.x < num_tiles) {
    hub_tile<kVec4>(term, offsets, partial, tile_row, num_out, l, tile_shift,
                    hub_edges, blockIdx.x, wsum, bounds);
    return;
  }
  const int tid = threadIdx.x;
  const int c = tid & (l.lanes - 1);
  const int j = tid / l.lanes;   // this thread's slot and row r0 + j
  const int64_t r0 =
      (blockIdx.x - num_tiles) * static_cast<int64_t>(l.slots);
  const bool mine = r0 + j < num_out;
  int32_t lo = 0, hi = 0;
  if (mine) {
    lo = __ldg(offsets + r0 + j);
    hi = __ldg(offsets + r0 + j + 1);
  }
  const bool is_medium = hi - lo > kShortRow && hi - lo <= hub_edges;
  if (tid == 0) num_medium = 0;
  if (mine && hi - lo <= kShortRow) {   // unit by unit, in sorted order
    T* row = out + (r0 + j) * l.units;
    for (int32_t u = c; u < l.units; u += l.lanes) {
      row[u] = l.lanes == 1 ? term.live_sum(lo, hi, u)
                            : range_sum<kVec4, 4>(term, lo, hi, 1, u);
    }
  }
  if (!__syncthreads_or(is_medium)) return;   // the whole block, or none

  // medium rows, one after another (the list's order changes no sum)
  if (is_medium && c == 0) medium_rows[atomicAdd(&num_medium, 1)] = j;
  __syncthreads();
  const int n_medium = num_medium;
  for (int m = 0; m < n_medium; ++m) {
    const int64_t r = r0 + medium_rows[m];
    block_range_sum<kVec4, 4>(term, __ldg(offsets + r),
                              __ldg(offsets + r + 1), l, out + r * l.units,
                              wsum);
  }
}

// Kernel 2: at its hub's first tile start, block k adds the hub's
// partials in tile order and writes the hub's output row.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spmm_segment_hub_fixup(PartialTerms<kVec4> partials,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ tile_row,
                       typename Vec<kVec4>::T* __restrict__ out, Layout l,
                       int tile_shift) {
  using T = typename Vec<kVec4>::T;
  __shared__ float4 wsum_raw[kWarps * 32];
  const int64_t k = blockIdx.x;
  const int32_t v = __ldg(tile_row + k);
  if (v < 0) return;
  const int64_t lo = __ldg(offsets + v);
  if (first_tile(lo, tile_shift) != k) return;   // not the hub's first
  const int64_t hi = __ldg(offsets + v + 1);
  block_range_sum<kVec4, 4>(partials, k, first_tile(hi, tile_shift), l,
                         out + static_cast<int64_t>(v) * l.units,
                         reinterpret_cast<T*>(wsum_raw));
}

template <bool kVec4>
int launch(const void* x, const void* src, const void* w,
           const int32_t* offsets, void* out, float* scratch,
           int64_t num_out, int32_t num_nodes, int32_t dim, int tile_shift,
           int64_t hub_edges, int64_t num_tiles, cudaStream_t s) {
  using T = typename Vec<kVec4>::T;
  const Layout l = make_layout(dim, kVec4);
  const EdgeTerms<kVec4> term{static_cast<const T*>(x),
                              static_cast<const int32_t*>(src),
                              static_cast<const float*>(w), num_nodes,
                              l.units};
  auto* partial = reinterpret_cast<T*>(scratch);
  auto* tile_row = reinterpret_cast<int32_t*>(scratch + num_tiles * dim);
  const int64_t row_blocks = (num_out + l.slots - 1) / l.slots;
  spmm_segment_rows<kVec4>
      <<<static_cast<unsigned>(num_tiles + row_blocks), kThreads, 0, s>>>(
          term, offsets, static_cast<T*>(out), partial, tile_row, num_out, l,
          tile_shift, hub_edges, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_tiles == 0) return static_cast<int>(err);
  spmm_segment_hub_fixup<kVec4><<<static_cast<unsigned>(num_tiles), kThreads,
                                  0, s>>>(
      PartialTerms<kVec4>{partial, l.units}, offsets, tile_row,
      static_cast<T*>(out), l, tile_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D) float32, src (E,) int32 and w (E,) float32 in destination
// order, offsets (num_out + 1,) int32 non-decreasing within [0, E); out
// (num_out, D) float32 written.  scratch holds num_tiles * (D + 1)
// 4-byte words: partial (num_tiles, D) float32, then tile_row
// (num_tiles,) int32, with num_tiles = ceil(E / P) when E > H and 0
// otherwise (P = tile_edges, a power of two above S; H = hub_edges >= 2P).
// The caller guarantees num_out, N, D and E in [0, 2^31).  Returns the
// first launch error, or 0.
extern "C" int spmm_segment_launch(const void* x, const void* src,
                                   const void* w, const void* offsets,
                                   void* out, void* scratch, int64_t num_out,
                                   int64_t num_nodes, int64_t dim,
                                   int64_t num_edges, int64_t tile_edges,
                                   int64_t hub_edges, int64_t num_tiles,
                                   void* stream) {
  constexpr int64_t kMax = int64_t{1} << 31;
  const bool tiled = num_edges > hub_edges;
  if (num_out < 0 || num_out >= kMax || num_nodes < 0 || num_nodes >= kMax ||
      dim < 0 || dim >= kMax || num_edges < 0 || num_edges >= kMax ||
      tile_edges <= kShortRow || tile_edges >= kMax ||
      (tile_edges & (tile_edges - 1)) != 0 || hub_edges < 2 * tile_edges ||
      num_tiles != (tiled ? (num_edges + tile_edges - 1) / tile_edges : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_out == 0 || dim == 0) return 0;
  int tile_shift = 0;
  while ((int64_t{1} << tile_shift) < tile_edges) ++tile_shift;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* offsets_ = static_cast<const int32_t*>(offsets);
  auto* scratch_ = static_cast<float*>(scratch);
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  if (vec4) {
    return launch<true>(x, src, w, offsets_, out, scratch_, num_out,
                        static_cast<int32_t>(num_nodes),
                        static_cast<int32_t>(dim), tile_shift, hub_edges,
                        num_tiles, s);
  }
  return launch<false>(x, src, w, offsets_, out, scratch_, num_out,
                       static_cast<int32_t>(num_nodes),
                       static_cast<int32_t>(dim), tile_shift, hub_edges,
                       num_tiles, s);
}

extern "C" const char* spmm_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
