// K3: the LK tracker's search-strip fetch.
//
// Replaces the TPU kernel rssync_tpu/frontend/tracking.py
// _gather_strips_pallas (body _dma_strips_kernel), which keeps DMA_SLOTS
// = 2 async copies of whole strips in flight from the HBM-resident
// level image into a VMEM block.
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
// Layouts (contiguous): img (T, Hp, Wp) with Wp % 128 == 0, 16-byte
// aligned, T * Hp < 2^31; oyq, obx (B, N) int32; fidx (B,) int32, or
// null where pair b reads frame b; out (B, N, 40, 256), 16-byte aligned.
//
// What bounds it on the card: bytes. It is a gather-copy with no
// arithmetic; at the tracker's full-width launch (B = 16 pairs, N = 130
// points, uint8) it writes 21.3 MB, ~6.4 us at 3.35 TB/s, and reads
// what the strips cover.
//
// Design: Hopper's Tensor Memory Accelerator (TMA) moves whole strips,
// as the TPU's DMA engine did, with no registers in between.
// - A tensor map over the image viewed as (T * Hp) rows x Wp columns,
//   box 40 x 256, no swizzle, is encoded on the host
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//   the library needs no -lcuda; the last four a host thread encoded
//   are kept, since encoding costs more host time than the launch) and
//   passed as a __grid_constant__ parameter.
// - A persistent grid of kCtasPerSm CTAs an SM (fewer where there are
//   fewer strips), computed by the launch: CTA c takes the run of
//   strips [c * per_cta, (c + 1) * per_cta). Its 128 threads read and
//   check the indices of up to 128 strips at once and stage their TMA
//   coordinates in shared memory; an index out of range traps.
// - One thread then streams the run through a ring of kStages shared
//   buffers of one strip each (10 KiB u8, 40 KiB f32): a 2D TMA load
//   per strip completes on its stage's mbarrier; a landed strip, which
//   is contiguous in `out`, leaves in one bulk store
//   (cp.async.bulk.global.shared::cta); a stage is refilled once its
//   store has read it (bulk wait_group.read 1), so one load is in
//   flight while a strip stores. A refill waits, in order on one
//   thread, for the store before it, so deeper rings bought nothing
//   (PERF.md). At the tracker's shapes (2080 strips on 132 SMs) a
//   CTA's run is 2 strips: both loads are issued at once, and the time
//   is HBM's write stream and its ramp.

#include <cuda.h>  // CUtensorMap and the driver's enums; no driver call is linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "bulk_ring.cuh"

namespace {

using rssync::bar_wait;
using rssync::smem_addr;

constexpr int kStripRows = 40;
constexpr int kLane = 128;
constexpr int kStripCols = 2 * kLane;
// threads a CTA, and strips whose indices it stages at once
constexpr int kThreads = 128;
// ring stages a CTA (one strip each), and CTAs launched for each SM:
// uint8's eight rings of 20 KiB are resident together, float32's run
// two at a time
constexpr int kStages = 2;
constexpr int kCtasPerSm = 8;

// error codes of the launch below 0 (CUDA runtime errors are above)
constexpr int kNoEncoder = -1000000;
constexpr int kBadArgs = -1000001;

__global__ void __launch_bounds__(kThreads) gather_strips_tma_kernel(
    const __grid_constant__ CUtensorMap img_map, const int* __restrict__ oyq,
    const int* __restrict__ obx, const int* __restrict__ fidx, uint8_t* __restrict__ out,
    int strips, int N, int T, int Hp, int max_oyq, int max_obx, int per_cta,
    uint32_t strip_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * strip_bytes);
  int2* coord = reinterpret_cast<int2*>(bars + kStages);  // (column, row) of each strip
  const int t = threadIdx.x;
  const int first = blockIdx.x * per_cta;
  const int last = min(strips, first + per_cta);
  const uint32_t buf0 = smem_addr(smem);
  const uint32_t bar0 = smem_addr(bars);
  const uint64_t map = reinterpret_cast<uint64_t>(&img_map);
  if (t == 0) {
    asm volatile("prefetch.tensormap [%0];" :: "l"(map) : "memory");
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0 + 8 * s) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int q0 = 0;  // strips loaded so far: the q-th goes to stage q % kStages, parity (q / kStages) & 1
  for (int base = first; base < last; base += kThreads) {
    const int n = min(kThreads, last - base);
    __syncthreads();  // the last chunk's coordinates are consumed
    if (t < n) {
      const int strip = base + t;
      const int f = fidx != nullptr ? fidx[strip / N] : strip / N;
      const int qy = oyq[strip];
      const int bx = obx[strip];
      if (f < 0 || f >= T || qy < 0 || qy > max_oyq || bx < 0 || bx > max_obx) {
        __trap();
      }
      coord[t] = make_int2(kLane * bx, f * Hp + 8 * qy);
    }
    __syncthreads();
    if (t != 0) continue;
    auto load = [&](int j) {
      const int q = q0 + j;
      const int s = q % kStages;
      const uint32_t bar = bar0 + 8 * s;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(strip_bytes) : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];"
          :: "r"(buf0 + s * strip_bytes), "l"(map), "r"(coord[j].x), "r"(coord[j].y),
             "r"(bar)
          : "memory");
    };
    for (int j = 0; j < min(kStages, n); ++j) load(j);
    for (int j = 0; j < n; ++j) {
      const int q = q0 + j;
      const int s = q % kStages;
      bar_wait(bar0 + 8 * s, (q / kStages) & 1);
      uint8_t* dst = out + static_cast<size_t>(base + j) * strip_bytes;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(dst), "r"(buf0 + s * strip_bytes), "r"(strip_bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // refill the stage the previous strip left once its store has read it
      if (j >= 1 && j - 1 + kStages < n) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(j - 1 + kStages);
      }
    }
    // the stages are read before the next chunk reuses them; the global
    // writes complete on their own (the grid's end orders them)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    q0 += n;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// the dynamic shared memory the kernel was last allowed, and the SM
// count (0: not read yet), per device
int g_smem_allowed[64] = {};
int g_sms[64] = {};

// CUDA_SUCCESS and device's SM count in *sms, or the runtime's error
int sm_count(int device, int* sms) {
  if (device < 64 && g_sms[device] > 0) {
    *sms = g_sms[device];
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) g_sms[device] = *sms;
  return static_cast<int>(err);
}

// The last few tensor maps this host thread encoded, by image: a map
// holds only the address, sizes and pitch, so a hit is the same map, and
// a caller that fetches from one level image again (r3_dma's loop, the
// hybrid tracker's whole clip) skips cuTensorMapEncodeTiled.
struct MapEntry {
  CUtensorMap map;
  const void* img;
  int T, Hp, Wp, itemsize;
};
constexpr int kMapCache = 4;
thread_local MapEntry g_maps[kMapCache];
thread_local int g_maps_used = 0;
thread_local int g_maps_next = 0;

// The tensor map of img viewed as (T * Hp) rows x Wp columns, box 40 x
// 256, from the cache or encoded; CUDA_SUCCESS or the encoder's error.
int image_map(const void* img, int T, int Hp, int Wp, int itemsize, const CUtensorMap** map) {
  for (int i = 0; i < g_maps_used; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.img == img && e.T == T && e.Hp == Hp && e.Wp == Wp && e.itemsize == itemsize) {
      *map = &e.map;
      return CUDA_SUCCESS;
    }
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  MapEntry& e = g_maps[g_maps_next];
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(T) * static_cast<cuuint64_t>(Hp)};
  const cuuint64_t row_pitch[1] = {static_cast<cuuint64_t>(Wp) * itemsize};
  const cuuint32_t box[2] = {kStripCols, kStripRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult enc = encode(
      &e.map, itemsize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
      const_cast<void*>(img), dims, row_pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) {
    e.img = nullptr;  // a half-written entry never matches
    return -static_cast<int>(enc);
  }
  e.img = img;
  e.T = T;
  e.Hp = Hp;
  e.Wp = Wp;
  e.itemsize = itemsize;
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  *map = &e.map;
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of CUDA device `device` (made current
// for the launch, then restored) and returns cudaGetLastError() (0 on
// success), or a negative code for a tensor map that could not be
// encoded or arguments the kernel does not take (see
// gather_strips_error_string). itemsize is the pixel size in bytes (1
// or 4); fidx may be null (pair b reads frame b). B * N >= 1 strips
// go to at most kCtasPerSm CTAs an SM, each a run of per_cta
// consecutive strips, every run but the last full. Allocates nothing;
// the caller owns every buffer.
int gather_strips_launch(const void* img, const void* oyq, const void* obx,
                         const void* fidx, void* out, int B, int N, int T, int Hp, int Wp,
                         int itemsize, int device, void* stream) {
  const long long strips = static_cast<long long>(B) * N;
  if ((itemsize != 1 && itemsize != 4) || strips < 1 || strips >= (1LL << 31) ||
      static_cast<long long>(T) * Hp >= (1LL << 31) || (fidx == nullptr && B != T)) {
    return kBadArgs;
  }
  const CUtensorMap* map = nullptr;
  int rc = image_map(img, T, Hp, Wp, itemsize, &map);
  if (rc != CUDA_SUCCESS) return rc;
  int sms = 0;
  rc = sm_count(device, &sms);
  if (rc != cudaSuccess) return rc;
  const long long ctas = std::min(strips, static_cast<long long>(sms) * kCtasPerSm);
  const int per_cta = static_cast<int>((strips + ctas - 1) / ctas);
  const int grid = static_cast<int>((strips + per_cta - 1) / per_cta);
  int current = 0;
  cudaGetDevice(&current);
  if (current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const uint32_t strip_bytes = kStripRows * kStripCols * itemsize;
  const int smem = kStages * strip_bytes + kStages * 8 + kThreads * sizeof(int2);
  cudaError_t err = rssync::allow_smem(reinterpret_cast<const void*>(gather_strips_tma_kernel),
                                       device, smem, g_smem_allowed);
  if (err == cudaSuccess) {
    gather_strips_tma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        *map, static_cast<const int*>(oyq), static_cast<const int*>(obx),
        static_cast<const int*>(fidx), static_cast<uint8_t*>(out), static_cast<int>(strips),
        N, T, Hp, (Hp - kStripRows) / 8, Wp / kLane - 2, per_cta, strip_bytes);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

const char* gather_strips_error_string(int code) {
  if (code >= 0) return cudaGetErrorString(static_cast<cudaError_t>(code));
  if (code == kNoEncoder) return "cuTensorMapEncodeTiled is not available from the driver";
  if (code == kBadArgs) {
    return "gather_strips_launch: bad itemsize, strip count, image size or frame indices";
  }
  static thread_local char msg[96];
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
  return msg;
}

}  // extern "C"
