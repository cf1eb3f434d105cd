// Helpers of the kernels that stream data through a shared-memory ring
// of mbarrier-guarded stages filled by Hopper's bulk-copy engine
// (gather_strips.cu, copy_block.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rssync {

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// spins until the mbarrier at shared address `bar` completes its phase
// of parity `parity`
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on `device`
// where that is above the default 48 KiB, asking the runtime once a
// device: allowed[device] (64 devices) holds what the kernel was last
// allowed there.
inline cudaError_t allow_smem(const void* kernel, int device, int smem, int* allowed) {
  if (smem <= 48 * 1024 || (device < 64 && allowed[device] >= smem)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) allowed[device] = smem;
  return err;
}

}  // namespace rssync
