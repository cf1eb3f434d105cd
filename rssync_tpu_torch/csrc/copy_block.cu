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
// and traps on a start that does not, before it copies anything, which
// surfaces as a CUDA error at the caller's next synchronization; it
// never reads outside the clip.
//
// Layouts (contiguous): frames (T, frame_bytes) of any dtype, viewed as
// bytes, frame_bytes % 16 == 0, 16-byte aligned; out (n, frame_bytes),
// 16-byte aligned.
//
// What bounds it on the card: bytes, each byte of the block read once
// and written once (197 MB for 17 frames of 2056 x 2816 u8). In practice
// the copy rate HBM reaches, about 2.9 TB/s of reads and writes
// together behind a clean L2, where index_select and the register copy
// also end (PERF.md §6).
//
// Design: Hopper's bulk-copy engine moves the block, as the TPU's DMA
// engine did, with no registers in between. The block is contiguous in
// both tensors, so it is one byte range of n * frame_bytes, cut into
// chunks of kStageBytes (the last may be shorter; every size and
// offset is a multiple of 16). Chunk i goes to CTA i % ctas, with
// `ctas` from the caller's plan (ops/blockcopy.py::copy_plan: one CTA
// an SM, no more than there are chunks), so at any moment the grid's
// loads fall in one window of the block; one contiguous range a CTA ran
// 9 % slower (PERF.md §6).
// - One thread a CTA issues every copy: a 1D bulk load
//   (cp.async.bulk.shared::cluster.global, no tensor map) of a chunk
//   into a stage of a ring of kStages shared-memory stages completes on
//   that stage's mbarrier; the landed chunk leaves in one bulk store
//   (cp.async.bulk.global.shared::cta); a stage is refilled once its
//   store has read it (bulk wait_group.read 1), so kStages - 1 loads
//   are in flight while a chunk stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using rssync::bar_wait;
using rssync::smem_addr;

// ring stages a CTA; a stage holds one chunk
constexpr int kStages = 4;
// one warp a CTA; its lane 0 issues every copy
constexpr int kThreads = 32;
// a chunk and a stage (ops/blockcopy.py's STAGE_BYTES repeats it): the
// ring of kStages fits the 227 KB a block may use, and expect_tx counts
// far fewer than 2^20 bytes
constexpr uint32_t kStageBytes = 48 * 1024;
constexpr int kSmem = kStages * kStageBytes + kStages * 8;

__global__ void __launch_bounds__(kThreads) copy_block_bulk_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ start_ptr,
    uint8_t* __restrict__ out, int T, int n, long long frame_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const int start = *start_ptr;
  if (start < 0 || start > T - n) {
    __trap();
  }
  const uint8_t* src = frames + static_cast<long long>(start) * frame_bytes;
  const long long total = static_cast<long long>(n) * frame_bytes;
  // this CTA's chunks: blockIdx.x + k * gridDim.x for k < chunks
  const long long all = (total + kStageBytes - 1) / kStageBytes;
  const long long chunks = (all - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (chunks <= 0) return;
  const uint32_t buf0 = smem_addr(smem);
  const uint32_t bar0 = smem_addr(smem + kStages * kStageBytes);
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0 + 8 * s) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto offset = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * static_cast<long long>(kStageBytes);
  };
  auto size = [&](long long o) {
    return static_cast<uint32_t>(min(static_cast<long long>(kStageBytes), total - o));
  };
  auto load = [&](long long k) {
    const long long o = offset(k);
    const uint32_t bytes = size(o);
    const uint32_t bar = bar0 + 8 * static_cast<uint32_t>(k % kStages);
    const uint32_t dst = buf0 + static_cast<uint32_t>(k % kStages) * kStageBytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src + o), "r"(bytes), "r"(bar) : "memory");
  };
  for (long long k = 0; k < min(static_cast<long long>(kStages), chunks); ++k) load(k);
  for (long long k = 0; k < chunks; ++k) {
    const int s = static_cast<int>(k % kStages);
    bar_wait(bar0 + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
    const long long o = offset(k);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(out + o), "r"(buf0 + s * kStageBytes), "r"(size(o)) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // refill the stage the previous chunk left once its store has read it
    if (k >= 1 && k - 1 + kStages < chunks) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k - 1 + kStages);
    }
  }
  // the stages are read before the CTA ends; the global writes complete
  // on their own (the grid's end orders them)
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the dynamic shared memory the kernel was last allowed, per device
int g_smem_allowed[64] = {};

}  // namespace

extern "C" {

// Launches the copy on `stream` (of the current device) on `ctas` CTAs
// (ops/blockcopy.py::copy_plan). Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take (no CTA, frames not a positive multiple of 16 bytes). Allocates
// nothing.
int copy_block_launch(const void* frames, const void* start, void* out, int T, int n,
                      long long frame_bytes, int ctas, void* stream) {
  if (ctas < 1 || n < 1 || frame_bytes < 16 || frame_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = rssync::allow_smem(reinterpret_cast<const void*>(copy_block_bulk_kernel), device,
                             kSmem, g_smem_allowed);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_block_bulk_kernel<<<ctas, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int*>(start),
      static_cast<uint8_t*>(out), T, n, frame_bytes);
  return static_cast<int>(cudaGetLastError());
}

const char* copy_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
