// Positional row gather: the late Materialize of the PRecursive plan.
// out[i, :] = table[positions[i], :], and a zero row where positions[i] is
// not a row of the table (the engine's padding sentinel is num_rows).
//
// Replaces: src/repro/kernels/late_gather/late_gather.py, late_gather_pallas.
//
// What bounds it on an H100: device-memory bytes.  It reads each position
// once (4 bytes), each live row once (W x elt bytes) and writes each output
// row once (W x elt bytes): at most P x W x elt x 2 + P x 4 bytes against
// 3.35 TB/s.  No arithmetic.
//
// Design: the TPU kernel DMA'd one (1, 128)-lane row block per grid step,
// steered by scalar-prefetched positions.  Here the output is cut into
// blocks of 256 consecutive elements: a block covers 256 / W rows, and
// neighbouring threads copy neighbouring elements of a row, so the writes
// are coalesced and each row read is one contiguous run.  Elements are
// copied as 2- or 4-byte bit patterns, so one kernel serves bf16, f32 and
// int32 without converting anything (no f32 round trip that would cut
// int32 ids above 2^24).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void late_gather_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ positions,
                                   T* __restrict__ out, int64_t rows,
                                   int width, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int i = idx / width;
  const int k = idx - i * width;
  const int32_t p = __ldg(positions + i);
  T value = 0;
  if (p >= 0 && p < rows) {
    value = __ldg(table + static_cast<int64_t>(p) * width + k);
  }
  out[idx] = value;
}

}  // namespace

// The caller guarantees num_pos * width in [1, 2^31) and elt_bytes in {2, 4}.
extern "C" int late_gather_launch(const void* table, const void* positions,
                                  void* out, int64_t rows, int64_t width,
                                  int64_t num_pos, int elt_bytes,
                                  void* stream) {
  constexpr int kThreads = 256;
  const int total = static_cast<int>(num_pos * width);
  const int blocks = (total + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto pos = static_cast<const int32_t*>(positions);
  if (elt_bytes == 4) {
    late_gather_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(table), pos, static_cast<uint32_t*>(out),
        rows, static_cast<int>(width), total);
  } else if (elt_bytes == 2) {
    late_gather_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(table), pos, static_cast<uint16_t*>(out),
        rows, static_cast<int>(width), total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* late_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
