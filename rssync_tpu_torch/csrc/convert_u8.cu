// E5/E6: the u8 -> bf16 frame conversion pass.
//
// Replaces the TPU kernels experiments/r4_u8pass.py pallas_convert (body
// _conv_kernel: u8 -> bf16 over the whole clip) and
// experiments/r4_u8pass2.py pallas_convert (body _conv_kernel: u8 -> i32
// -> bf16, the same values, per 17-frame chunk). One CUDA kernel serves
// both, as one kernel serves K1 and K2.
//
//   out[i] = bf16(in[i]) for every i < n
//
// Every u8 value is an integer below 2^8 and so exact in bf16 (8
// significant bits): the bf16 bits are the top half of the float32 bits
// and the result is bit-equal to the plain version x.to(torch.bfloat16).
//
// The TPU kernels run a grid of Hp // 256 row blocks, so at the stored
// height 2056 rows 2048-2055 of each frame are never written. This
// kernel is flat over all n elements and converts every row.
//
// What bounds it on the card: bytes, 1 read + 2 written per pixel (3
// bytes); no arithmetic to speak of. Design: grid-stride over 16-pixel
// vectors, each thread one 16-byte u8 load and two 16-byte bf16 stores,
// neighbouring threads on neighbouring vectors, so every warp reads 512
// and writes 1024 contiguous bytes. A tensor whose pointers are not
// 16-byte aligned, and the n % 16 tail, take a scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// bf16 bits of a u8 value: the top half of its (exact) float32 bits
__device__ __forceinline__ uint32_t bf16_bits(uint32_t u) {
  return __float_as_uint(static_cast<float>(u)) >> 16;
}

// two bf16 values packed low-first, as they lie in memory
__device__ __forceinline__ uint32_t pack2(uint32_t word, int byte) {
  return bf16_bits((word >> (8 * byte)) & 0xffu)
         | (bf16_bits((word >> (8 * byte + 8)) & 0xffu) << 16);
}

__global__ void convert_u8_bf16_vec_kernel(const uint4* __restrict__ in,
                                           uint4* __restrict__ out,
                                           size_t n_vec) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const uint4 w = in[i];
    uint4 lo, hi;
    lo.x = pack2(w.x, 0); lo.y = pack2(w.x, 2);
    lo.z = pack2(w.y, 0); lo.w = pack2(w.y, 2);
    hi.x = pack2(w.z, 0); hi.y = pack2(w.z, 2);
    hi.z = pack2(w.w, 0); hi.w = pack2(w.w, 2);
    out[2 * i] = lo;
    out[2 * i + 1] = hi;
  }
}

__global__ void convert_u8_bf16_scalar_kernel(const uint8_t* __restrict__ in,
                                              uint16_t* __restrict__ out,
                                              size_t first, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = first + static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<uint16_t>(bf16_bits(in[i]));
  }
}

unsigned int blocks_for(size_t items, int sm_count) {
  const size_t need = (items + kThreads - 1) / kThreads;
  const size_t most = static_cast<size_t>(sm_count) * 8;  // 8 blocks an SM
  return static_cast<unsigned int>(need < most ? (need > 0 ? need : 1) : most);
}

}  // namespace

extern "C" {

// Converts n u8 values at `in` to bf16 at `out` on `stream` and returns
// cudaGetLastError() (0 on success). Allocates nothing.
int convert_u8_bf16_launch(const void* in, void* out, long long n, int sm_count,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t n_vec = aligned ? count / 16 : 0;
  if (n_vec > 0) {
    convert_u8_bf16_vec_kernel<<<blocks_for(n_vec, sm_count), kThreads, 0, s>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n_vec);
  }
  const size_t first = 16 * n_vec;
  if (first < count) {
    convert_u8_bf16_scalar_kernel<<<blocks_for(count - first, sm_count), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<uint16_t*>(out), first, count);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* convert_u8_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
