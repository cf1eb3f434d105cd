// K3: the LK tracker's search-strip fetch.
//
// Replaces the TPU kernel rssync_tpu/frontend/tracking.py
// _gather_strips_pallas (body _dma_strips_kernel), which double-buffers
// one DMA per (pair, point) from the HBM-resident level image into a
// VMEM block.
//
// For every pair b and point n it copies the strip
//   out[b, n, r, :] = img[fidx[b], 8 * oyq[b, n] + r, 128 * obx[b, n] + (0 .. 255)]
// for r in [0, 40): 40 rows of 256 pixels, in the image dtype (uint8 or
// float32; the kernel moves bytes and never converts). The 8-row and
// 128-lane quantization of the start is the TPU's DMA tiling rule; it
// is kept because the tracker's sampling taps downstream are computed
// from it, so the values the Gauss-Newton steps read stay those of
// rssync_tpu.
//
// Layouts (contiguous): img (T, Hp, Wp) with Wp % 128 == 0 and 16-byte
// aligned rows; oyq, obx (B, N) int32; fidx (B,) int32; out
// (B, N, 40, 256).
//
// What bounds it on the card: bytes. It is a gather-copy with no
// arithmetic; at the tracker's full-width launch (B = 16 pairs, N = 130
// points, uint8) it moves 21.3 MB each way, ~12.7 us at 3.35 TB/s.
// Design: one thread block per (b, n) strip; each row is 256 contiguous
// pixels (256 B for uint8, 1 KiB for float32), copied as 16-byte
// vectors, neighbouring threads on neighbouring vectors of a row, so
// every warp reads and writes whole 128-byte lines.
//
// Indices must be in bounds (the tracker clamps them first). The
// kernel checks them and traps on one that is not, which surfaces as a
// CUDA error at the caller's next synchronization; it never reads
// outside the image.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripRows = 40;
constexpr int kLane = 128;
constexpr int kThreads = 128;

__global__ void gather_strips_kernel(
    const uint4* __restrict__ img, const int* __restrict__ oyq,
    const int* __restrict__ obx, const int* __restrict__ fidx,
    uint4* __restrict__ out, int N, int T, int Hp, int pitch_vecs,
    int lane_vecs, int max_oyq, int max_obx) {
  const int strip = blockIdx.x;  // = b * N + n
  const int b = strip / N;
  const int f = fidx[b];
  const int qy = oyq[strip];
  const int bx = obx[strip];
  if (f < 0 || f >= T || qy < 0 || qy > max_oyq || bx < 0 || bx > max_obx) {
    __trap();
  }
  const int row_vecs = 2 * lane_vecs;
  const uint4* src = img
      + (static_cast<size_t>(f) * Hp + 8 * static_cast<size_t>(qy)) * pitch_vecs
      + static_cast<size_t>(bx) * lane_vecs;
  uint4* dst = out + static_cast<size_t>(strip) * kStripRows * row_vecs;
  for (int i = threadIdx.x; i < kStripRows * row_vecs; i += kThreads) {
    const int r = i / row_vecs;
    const int c = i - r * row_vecs;
    dst[i] = src[static_cast<size_t>(r) * pitch_vecs + c];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). itemsize is the pixel size in bytes (1 or 4). Allocates
// nothing; the caller owns every buffer.
int gather_strips_launch(const void* img, const void* oyq, const void* obx,
                         const void* fidx, void* out, int B, int N, int T,
                         int Hp, int Wp, int itemsize, void* stream) {
  const int lane_vecs = kLane * itemsize / 16;
  const int pitch_vecs = Wp * itemsize / 16;
  const int max_oyq = (Hp - kStripRows) / 8;
  const int max_obx = Wp / kLane - 2;
  const unsigned int strips = static_cast<unsigned int>(B) * N;
  gather_strips_kernel<<<strips, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(img), static_cast<const int*>(oyq),
      static_cast<const int*>(obx), static_cast<const int*>(fidx),
      static_cast<uint4*>(out), N, T, Hp, pitch_vecs, lane_vecs, max_oyq,
      max_obx);
  return static_cast<int>(cudaGetLastError());
}

const char* gather_strips_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
