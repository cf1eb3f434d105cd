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
// for an (H, W) image in uint8, bfloat16 or float32 with a row pitch in
// elements, origins (N, 2) int32 xy on the card, and out (N, S, S)
// float32. Every output is an exact copy of one pixel (u8 and bf16
// convert to float32 exactly, bf16 through __bfloat162float), so the
// kernel is bit-equal to its plain version.
//
// The kernel reads the origins itself, so the caller never synchronizes
// to learn them. Each must satisfy 0 <= x <= W - S and 0 <= y <= H - S;
// the kernel checks that and traps on one that does not, which surfaces
// as a CUDA error at the caller's next synchronization. It never reads a
// byte outside the patch it is filling, so never outside the image.
//
// What bounds it on the card: bytes, N * S^2 * (itemsize + 4) plus the
// origins (1.04 MB at E3's 130 patches of 40 x 40 from a u8 image,
// ~0.31 us at 3.35 TB/s). At that size launch latency and how many loads
// are in flight, not bytes, set the time: nothing is multiplied and
// ~1 MB moves once, so wgmma, TMA and shared-memory staging have no
// place here. Design:
//   - The output is cut into 16-byte vectors (four floats). Every block
//     writes kVectors = 256 of them (4 KB), so the grid is
//     ceil(N S^2 / 1024) blocks whatever the caller asks (204 at E3's
//     shape, on 132 SMs).
//   - `per_block` (E4's nbuf, the depth of its DMA ring) becomes the
//     depth of each thread's own ring: the vectors a thread loads before
//     its first store, rounded down to 1, 2, 4 or 8 (a template
//     parameter, so the loads sit in registers). A block then runs
//     256 / depth threads; vector j of thread t is blockIdx * 256 +
//     j * threads + t, so neighbouring threads store neighbouring
//     vectors.
//   - Each thread reads its vectors' origins straight from global
//     memory (one line, broadcast through L1), checks them and starts
//     its pixel loads: no shared memory, no __syncthreads.
//   - S = 40, the size every harness launches, is a template instance
//     whose vector is 4 pixels of one patch row: patch, row and column
//     come from divisions by constants. Its pixel loads are as wide as
//     the row's alignment allows and never leave the patch: float32
//     one float4 where the address is 16-byte aligned; u8 and bf16
//     aligned 32-bit words, unpacked with __funnelshift_r / __byte_perm,
//     where those words lie inside the patch row (4 pixels at an aligned
//     address, or a misaligned vector that is neither the first nor the
//     last of its row, whose covering words then reach at most into the
//     row's neighbouring vectors); scalar loads otherwise. The image's
//     base need not be aligned: the test is on each address.
//   - Any other S takes the generic instance: its vector is four
//     consecutive output floats, row and column computed once per vector
//     (two divisions) and stepped within it, one scalar load a pixel,
//     scalar stores for a ragged tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kVectors = 256;  // output vectors a block writes
constexpr int kMaxDepth = 8;   // vectors a thread loads before its first store
constexpr int kRowSize = 40;   // the S with a row-vector instance

__device__ __forceinline__ float to_float(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ uint32_t load_word(const void* p) {
  return __ldg(static_cast<const unsigned int*>(p));
}

__host__ __device__ __forceinline__ uintptr_t address(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

// Four pixels p[0..3] of one patch row as floats. `edge`: the vector is
// the first or last of its row, so a word covering a misaligned vector
// would reach outside the patch.
__device__ __forceinline__ float4 load4(const float* p, bool /*edge*/) {
  if ((address(p) & 15) == 0) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float4 load4(const uint8_t* p, bool edge) {
  const unsigned m = address(p) & 3;
  uint32_t w;
  if (m == 0) {
    w = load_word(p);
  } else if (!edge) {  // the two aligned words around p lie in the row
    w = __funnelshift_r(load_word(p - m), load_word(p - m + 4), 8 * m);
  } else {
    w = __ldg(p) | (__ldg(p + 1) << 8) | (__ldg(p + 2) << 16) |
        (static_cast<uint32_t>(__ldg(p + 3)) << 24);
  }
  return make_float4(static_cast<float>(__byte_perm(w, 0, 0x4440)),
                     static_cast<float>(__byte_perm(w, 0, 0x4441)),
                     static_cast<float>(__byte_perm(w, 0, 0x4442)),
                     static_cast<float>(__byte_perm(w, 0, 0x4443)));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool edge) {
  const unsigned m = address(p) & 3;  // 0 or 2
  uint32_t lo, hi;  // pixels (0, 1) and (2, 3), the first in the low half
  if (m == 0) {
    lo = load_word(p);
    hi = load_word(p + 2);
  } else if (!edge) {  // three aligned words from pixel -1 to pixel 4
    const uint32_t a = load_word(p - 1), b = load_word(p + 1), c = load_word(p + 3);
    lo = __byte_perm(a, b, 0x5432);
    hi = __byte_perm(b, c, 0x5432);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    lo = __ldg(h) | (static_cast<uint32_t>(__ldg(h + 1)) << 16);
    hi = __ldg(h + 2) | (static_cast<uint32_t>(__ldg(h + 3)) << 16);
  }
  return make_float4(bf16_bits_to_float(lo), bf16_bits_to_float(lo >> 16),
                     bf16_bits_to_float(hi), bf16_bits_to_float(hi >> 16));
}

// The origin of patch n, checked: traps on one outside the image.
__device__ __forceinline__ int2 origin(const int* __restrict__ origins, unsigned n, int H,
                                       int W, int S) {
  const int x = __ldg(origins + 2 * n);
  const int y = __ldg(origins + 2 * n + 1);
  if (x < 0 || x > W - S || y < 0 || y > H - S) {
    __trap();
  }
  return make_int2(x, y);
}

// The two kernels share one signature: the row-vector one takes S from
// its template and `count` in vectors, the generic one S and `count` in
// floats.
template <typename T>
using KernelFn = void (*)(const T*, const int*, float*, int, int, long long, int, unsigned);

// S = kS (a multiple of 4): a vector is 4 pixels of one patch row.
template <typename T, int kS, int kDepth>
__global__ void __launch_bounds__(kVectors / kDepth)
    patch_rows_kernel(const T* __restrict__ img, const int* __restrict__ origins,
                      float* __restrict__ out, int H, int W, long long pitch, int /*S*/,
                      unsigned vectors) {
  static_assert(kS % 4 == 0, "a row-vector instance needs S % 4 == 0");
  constexpr unsigned kThreads = kVectors / kDepth;
  constexpr unsigned kRowVectors = kS / 4;
  constexpr unsigned kPatchVectors = kS * kRowVectors;
  const unsigned first = blockIdx.x * kVectors + threadIdx.x;
  float4 val[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const unsigned v = first + j * kThreads;
    if (v < vectors) {
      const unsigned n = v / kPatchVectors;
      const unsigned k = v - n * kPatchVectors;
      const unsigned r = k / kRowVectors;
      const unsigned seg = k - r * kRowVectors;
      const int2 o = origin(origins, n, H, W, kS);
      const T* p = img + static_cast<long long>(o.y + r) * pitch + o.x + 4 * seg;
      val[j] = load4(p, seg == 0 || seg == kRowVectors - 1);
    }
  }
  float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const unsigned v = first + j * kThreads;
    if (v < vectors) {
      out4[v] = val[j];
    }
  }
}

// Any S: a vector is four consecutive output floats (the last may be
// ragged), its first element's patch, row and column found once.
template <typename T, int kDepth>
__global__ void __launch_bounds__(kVectors / kDepth)
    patch_flat_kernel(const T* __restrict__ img, const int* __restrict__ origins,
                      float* __restrict__ out, int H, int W, long long pitch, int S,
                      unsigned total) {
  constexpr unsigned kThreads = kVectors / kDepth;
  const unsigned size = static_cast<unsigned>(S);
  const unsigned area = size * size;
  const unsigned first = blockIdx.x * kVectors + threadIdx.x;
  float val[kDepth][4];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const unsigned e = 4 * (first + j * kThreads);
    if (e < total) {
      unsigned n = e / area;
      const unsigned k = e - n * area;
      unsigned r = k / size;
      unsigned c = k - r * size;
      int2 o = origin(origins, n, H, W, S);
      const T* row = img + static_cast<long long>(o.y + r) * pitch + o.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        val[j][i] = 0.0f;
        if (e + i < total) {
          val[j][i] = to_float(__ldg(row + c));
          if (++c == size && e + i + 1 < total) {  // the next float starts a row
            c = 0;
            if (++r == size) {
              r = 0;
              o = origin(origins, ++n, H, W, S);
            }
            row = img + static_cast<long long>(o.y + r) * pitch + o.x;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const unsigned e = 4 * (first + j * kThreads);
    if (e + 3 < total) {
      reinterpret_cast<float4*>(out)[e / 4] =
          make_float4(val[j][0], val[j][1], val[j][2], val[j][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (e + i < total) {
          out[e + i] = val[j][i];
        }
      }
    }
  }
}

// Calls f(kernel, threads) with the instance for (T, S, depth): the
// row-vector kernel at S = kRowSize, the generic one otherwise.
template <typename T, int kDepth, typename F>
void with_size(int S, F&& f) {
  if (S == kRowSize) {
    f(KernelFn<T>(patch_rows_kernel<T, kRowSize, kDepth>), kVectors / kDepth);
  } else {
    f(KernelFn<T>(patch_flat_kernel<T, kDepth>), kVectors / kDepth);
  }
}

// The depth a per_block asks for: 1, 2, 4 or 8 (rounded down).
template <typename T, typename F>
void with_depth(int S, int per_block, F&& f) {
  if (per_block >= 8) {
    with_size<T, 8>(S, f);
  } else if (per_block >= 4) {
    with_size<T, 4>(S, f);
  } else if (per_block >= 2) {
    with_size<T, 2>(S, f);
  } else {
    with_size<T, 1>(S, f);
  }
}

// f(kernel, threads) for the instance of (itemsize, S, per_block);
// false for an itemsize other than 1, 2 or 4.
template <typename F>
bool with_instance(int itemsize, int S, int per_block, F&& f) {
  switch (itemsize) {
    case 1:
      with_depth<uint8_t>(S, per_block, f);
      return true;
    case 2:
      with_depth<__nv_bfloat16>(S, per_block, f);
      return true;
    case 4:
      with_depth<float>(S, per_block, f);
      return true;
    default:
      return false;
  }
}

template <typename T>
void launch(KernelFn<T> kernel, unsigned blocks, int threads, cudaStream_t s, const void* img,
            const int* origins, float* out, int H, int W, long long pitch, int S,
            unsigned count) {
  kernel<<<blocks, threads, 0, s>>>(static_cast<const T*>(img), origins, out, H, W, pitch, S,
                                    count);
}

static_assert(kVectors % (32 * kMaxDepth) == 0, "every instance runs whole warps");

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). itemsize selects the image type: 1 uint8, 2 bfloat16, 4
// float32. Needs N >= 1, 1 <= S <= min(H, W), N * S * S <= INT_MAX,
// per_block >= 1 and `out` 16-byte aligned (else cudaErrorInvalidValue).
// per_block sets each thread's depth (1, 2, 4 or 8 vectors, rounded
// down); the grid is ceil(N * S * S / 1024) blocks whatever it is.
// Allocates nothing; the caller owns every buffer.
int extract_patches_launch(const void* img, const void* origins, void* out, int N,
                           int H, int W, long long pitch, int S, int itemsize,
                           int per_block, void* stream) {
  const long long total = static_cast<long long>(N) * S * S;
  if (N < 1 || S < 1 || per_block < 1 || total > INT_MAX || (address(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((total + 4 * kVectors - 1) / (4 * kVectors));
  const unsigned count = S == kRowSize ? static_cast<unsigned>(total / 4)
                                       : static_cast<unsigned>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = with_instance(itemsize, S, per_block, [&](auto kernel, int threads) {
    launch(kernel, blocks, threads, s, img, static_cast<const int*>(origins),
           static_cast<float*>(out), H, W, pitch, S, count);
  });
  if (!known) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local-memory bytes a thread of the instance a launch
// with these arguments takes (cudaFuncGetAttributes); returns its error.
int extract_patches_kernel_attrs(int itemsize, int S, int per_block, int* regs,
                                 int* local_bytes) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaErrorInvalidValue;
  with_instance(itemsize, S, per_block,
                [&](auto kernel, int) { err = cudaFuncGetAttributes(&attr, kernel); });
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

const char* extract_patches_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
