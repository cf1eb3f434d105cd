// E7: copy n frames of a clip from a start index held on the device.
//
// Replaces the TPU kernel experiments/r4_slice2.py dma_block (body
// _copy_block_kernel), one HBM -> HBM async copy of
// frames[start : start + n] with `start` a prefetched scalar.
//
//   out[j] = frames[start + j] for j < n, start = *start_ptr
//
// The kernel reads `start` itself, so the caller never synchronizes to
// learn it. It must satisfy 0 <= start <= T - n; the kernel checks that
// and traps on a start that does not, which surfaces as a CUDA error at
// the caller's next synchronization; it never reads outside the clip.
//
// Layouts (contiguous): frames (T, frame_bytes) of any dtype, viewed as
// bytes, frame_bytes % 16 == 0, 16-byte aligned; out (n, frame_bytes).
//
// What bounds it on the card: bytes, each byte of the block read once
// and written once (197 MB for 17 frames of 2056 x 2816 u8). Design: a
// grid-stride copy of 16-byte vectors, neighbouring threads on
// neighbouring vectors, four loads in flight per thread before their
// stores; the block is contiguous in both tensors, so there is no index
// arithmetic beyond the start offset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void copy_block_kernel(const uint4* __restrict__ frames,
                                  const int* __restrict__ start_ptr,
                                  uint4* __restrict__ out, int T, int n,
                                  size_t frame_vecs) {
  const int start = *start_ptr;
  if (start < 0 || start > T - n) {
    __trap();
  }
  const uint4* src = frames + static_cast<size_t>(start) * frame_vecs;
  const size_t total = static_cast<size_t>(n) * frame_vecs;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < total; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = src[i + k * stride];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) out[i + k * stride] = v[k];
  }
  for (; i < total; i += stride) out[i] = src[i];
}

}  // namespace

extern "C" {

// Launches the copy on `stream` and returns cudaGetLastError() (0 on
// success). frame_bytes must be a multiple of 16. Allocates nothing.
int copy_block_launch(const void* frames, const void* start, void* out, int T,
                      int n, long long frame_bytes, int sm_count, void* stream) {
  const size_t frame_vecs = static_cast<size_t>(frame_bytes) / 16;
  const size_t total = static_cast<size_t>(n) * frame_vecs;
  const size_t need = (total + kThreads - 1) / kThreads;
  const size_t most = static_cast<size_t>(sm_count) * 8;  // 8 blocks an SM
  const unsigned int blocks =
      static_cast<unsigned int>(need < most ? (need > 0 ? need : 1) : most);
  copy_block_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(frames), static_cast<const int*>(start),
      static_cast<uint4*>(out), T, n, frame_vecs);
  return static_cast<int>(cudaGetLastError());
}

const char* copy_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
