// E1/E3/E4: square float32 patches of an image at per-patch origins.
//
// Replaces three TPU kernels that compute one function:
//   - experiments/pallas_patch.py:100 _extract_pallas (body _make_kernel),
//     double-buffered DMA of an aligned superset, then two rolls;
//   - experiments/mb_extract.py:164 make_pallas, a burst of one DMA per
//     patch into VMEM, then a VMEM slice;
//   - experiments/mb_extract2.py:93 make_pallas, the same with an
//     nbuf-deep DMA ring.
// Each copies a tile-aligned superset region because a Mosaic DMA must
// start on the (8, 128) tiling; the callers clamp the origins so that
// region stays in the image. The card has no such rule, so this kernel
// reads the patch itself; the clamps stay in the callers.
//
//   out[n, r, c] = float(img[oy[n] + r, ox[n] + c]),  r, c in [0, S)
//
// for an (H, W) image in uint8, bfloat16 or float32 (one template) with
// a row pitch in elements, origins (N, 2) int32 xy on the card, and out
// (N, S, S) float32. Every output is an exact copy of one pixel (u8 and
// bf16 convert to float32 exactly, bf16 through __bfloat162float), so
// the kernel is bit-equal to its plain version.
//
// The kernel reads the origins itself, so the caller never synchronizes
// to learn them. Each must satisfy 0 <= x <= W - S and 0 <= y <= H - S;
// the kernel checks that and traps on one that does not, which surfaces
// as a CUDA error at the caller's next synchronization; it never reads
// outside the image.
//
// What bounds it on the card: bytes, N * S^2 * (itemsize + 4) plus the
// origins (1.04 MB at E3's 130 patches of 40 x 40 from a u8 image,
// ~0.31 us at 3.35 TB/s). At that size launch latency, not bytes, sets
// the time. Design, simple first: one block of 256 threads walks
// `per_block` patches (the counterpart of E4's nbuf, the patch loads a
// block keeps in flight); it loads and checks their origins into shared
// memory, then walks their S * S * per_block outputs flat, neighbouring
// threads on neighbouring output floats, with one load per output
// (a u8 patch row may start at any byte, so no vector loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__global__ void extract_patches_kernel(const T* __restrict__ img,
                                       const int* __restrict__ origins,
                                       float* __restrict__ out, int N, int H,
                                       int W, long long pitch, int S,
                                       int per_block) {
  extern __shared__ int2 corner[];  // (x, y) of this block's patches
  const int first = blockIdx.x * per_block;
  const int count = min(per_block, N - first);
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int x = origins[2 * (first + j)];
    const int y = origins[2 * (first + j) + 1];
    if (x < 0 || x > W - S || y < 0 || y > H - S) {
      __trap();
    }
    corner[j] = make_int2(x, y);
  }
  __syncthreads();
  const int area = S * S;
  const int total = count * area;
  float* dst = out + static_cast<size_t>(first) * area;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / area;
    const int k = i - j * area;
    const int r = k / S;
    const int c = k - r * S;
    const int2 o = corner[j];
    dst[i] = to_float(img[static_cast<size_t>(o.y + r) * pitch + o.x + c]);
  }
}

template <typename T>
void launch(const void* img, const void* origins, void* out, int N, int H, int W,
            long long pitch, int S, int per_block, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((N + per_block - 1) / per_block);
  const size_t smem = static_cast<size_t>(per_block) * sizeof(int2);
  extract_patches_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const int*>(origins),
      static_cast<float*>(out), N, H, W, pitch, S, per_block);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). itemsize selects the image type: 1 uint8, 2 bfloat16, 4
// float32. N >= 1, 1 <= S <= min(H, W), per_block * S * S < 2^31.
// Allocates nothing; the caller owns every buffer.
int extract_patches_launch(const void* img, const void* origins, void* out, int N,
                           int H, int W, long long pitch, int S, int itemsize,
                           int per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1:
      launch<uint8_t>(img, origins, out, N, H, W, pitch, S, per_block, s);
      break;
    case 2:
      launch<__nv_bfloat16>(img, origins, out, N, H, W, pitch, S, per_block, s);
      break;
    case 4:
      launch<float>(img, origins, out, N, H, W, pitch, S, per_block, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* extract_patches_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
