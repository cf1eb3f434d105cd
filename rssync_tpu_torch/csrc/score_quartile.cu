// RANSAC hypothesis scoring: the quartile bracket of squared residuals.
//
// Replaces the TPU kernels rssync_tpu/ops/pallas_score.py
// score_quartile_pallas (body _score_kernel) and
// score_quartile_pallas_batched (body _score_kernel_batched): one CUDA
// kernel serves both, over a grid of B * F rows (B = 1 for the
// unbatched form).
//
// For row (b, f) and hypothesis i:
//   s_n  = (v . nP_n)^2 over the valid features n < counts[b, f]
//   k    = max(count, 1) / 4
//   hi   = min(max_n s_n, MARKOV_C * mean_n s_n), lo = 0
//   12 bisection rounds: mid = (lo + hi) / 2; the round counts the n
//   with bf16(s_n) <= bf16(mid) and keeps [lo, mid] if that count is
//   >= k + 1, else [mid, hi].
//   out[b, f, i] = hi
//
// E8 (kI16 = true) replaces experiments/r4_i16score.py score_i16 (body
// _kernel_i16): the same bracket with the compare buffer held as the
// 16-bit bf16 bit patterns of the quantized residuals, N shorts a warp
// where K1/K2 keep N floats, compared as int16. For +0, positive finite
// values and +inf the bf16 bits viewed as int16 are non-negative and
// ordered like the values, and here every compared value is one of
// those: s^2 >= +0, invalid slots are +inf (0x7f80) and mid >= 0. So on
// finite inputs E8 is bit-equal to K1/K2. A NaN would order differently
// from K1/K2's float compare. The count reads two int16 slots per
// 32-bit word and compares both at once (SWAR): with both halves of w
// and m in [0, 0x7fff], bit 15 of each half of
// ((m | 0x80008000) - w) is set iff that half of w <= that half of m,
// and no borrow crosses halves. An odd N gets one pad slot 0x7fff,
// above every compared mid.
//
// Layouts (contiguous, float32 unless noted):
//   nP (B, 3, F, N), v (B, 3, F, I), counts (B, F) int32, out (B, F, I).
//
// What bounds it on the card: arithmetic on data held in shared memory.
// At the PreSync operating point (6000 (delay, window) problems x 60
// frames x 20 hypotheses x 130 features) that is ~0.94 G squared
// residuals, each compared in 12 rounds; device memory traffic is only
// the 3 x N row once per block plus the hypotheses. Design: one block
// per (b, f) row stages that row's nP in shared memory (3 x N floats,
// 1.5 KB at N = 130), each warp takes hypotheses i in turn, lanes
// stride over n. The residuals of the current hypothesis live in a
// per-warp shared buffer, so nothing of size I x N is ever stored.
//
// Numerics, bit for bit with the plain PyTorch version
// (rssync_tpu_torch/ops/score.py::score_quartile_batched_ref):
// - s is (v0*n0 + v1*n1) + v2*n2, then squared, with explicitly
//   rounded, never fused, multiplies and adds (__fmul_rn/__fadd_rn);
//   an FMA would move s by an ulp and can flip a bf16 compare.
// - the sum behind the mean is a fixed pairwise halving tree over the
//   features zero-padded to a power of two (x[j] += x[j + h] for
//   h = P/2, ..., 1), the same order the plain version uses; the max
//   is order-free; the division and the Markov product are IEEE.
// - both sides of every compare are rounded to bf16 with
//   round-to-nearest-even and compared in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBisectRounds = 12;
constexpr float kMarkovC = 2.03125f;
constexpr int kWarp = 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 bits of x (round to nearest even)
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16-bit slots of the E8 compare buffer: N rounded up to even
__host__ __device__ __forceinline__ int i16_slots(int N) { return N + (N & 1); }

template <bool kI16>
__global__ void score_quartile_kernel(
    const float* __restrict__ nP, const float* __restrict__ v,
    const int* __restrict__ counts, float* __restrict__ out,
    int F, int N, int I, int P) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;  // = b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  float* n0 = smem;
  float* n1 = n0 + N;
  float* n2 = n1 + N;
  // K1/K2: per warp P tree slots, then N quantized floats. E8: every
  // warp's P tree slots, then every warp's i16_slots(N) bf16 patterns.
  float* buf = n2 + N + warp * (kI16 ? P : P + N);
  float* q = buf + P;
  const int Nq = i16_slots(N);
  unsigned short* q16 =
      reinterpret_cast<unsigned short*>(n2 + N + warps * P) + warp * Nq;

  const size_t stride_c = static_cast<size_t>(F) * N;
  const float* src = nP + static_cast<size_t>(b) * 3 * stride_c
                     + static_cast<size_t>(f) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    n0[n] = src[n];
    n1[n] = src[stride_c + n];
    n2[n] = src[2 * stride_c + n];
  }
  __syncthreads();

  const int cnt = counts[row];
  const int valid_n = cnt < N ? cnt : N;
  const int k1 = (cnt > 1 ? cnt : 1) / 4 + 1;
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  const size_t stride_v = static_cast<size_t>(F) * I;
  const float* vrow = v + static_cast<size_t>(b) * 3 * stride_v
                      + static_cast<size_t>(f) * I;

  for (int i = warp; i < I; i += warps) {
    const float v0 = vrow[i];
    const float v1 = vrow[stride_v + i];
    const float v2 = vrow[2 * stride_v + i];

    float mx = 0.0f;
    for (int n = lane; n < P; n += kWarp) {
      float s2 = 0.0f;
      if (n < valid_n) {
        const float s = __fadd_rn(
            __fadd_rn(__fmul_rn(v0, n0[n]), __fmul_rn(v1, n1[n])),
            __fmul_rn(v2, n2[n]));
        s2 = __fmul_rn(s, s);
      }
      buf[n] = s2;
      if constexpr (kI16) {
        if (n < Nq) q16[n] = n < valid_n ? bf16_bits(s2) : (n < N ? 0x7f80u : 0x7fffu);
      } else {
        if (n < N) q[n] = n < valid_n ? bf16_round(s2) : __int_as_float(0x7f800000);
      }
      mx = fmaxf(mx, s2);
    }
    for (int o = kWarp / 2; o > 0; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    __syncwarp();
    // pairwise halving tree, the plain version's summation order
    for (int h = P / 2; h > 0; h /= 2) {
      for (int j = lane; j < h; j += kWarp) buf[j] = __fadd_rn(buf[j], buf[j + h]);
      __syncwarp();
    }
    const float mu = __fdiv_rn(buf[0], denom);
    float lo = 0.0f;
    float hi = fminf(mx, __fmul_rn(kMarkovC, mu));

    for (int r = 0; r < kBisectRounds; ++r) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int c = 0;
      if constexpr (kI16) {
        const unsigned int* w = reinterpret_cast<const unsigned int*>(q16);
        const unsigned int m = bf16_bits(mid) * 0x10001u | 0x80008000u;
        for (int k = lane; k < Nq / 2; k += kWarp) c += __popc((m - w[k]) & 0x80008000u);
      } else {
        const float midq = bf16_round(mid);
        for (int n = lane; n < N; n += kWarp) c += q[n] <= midq ? 1 : 0;
      }
      for (int o = kWarp / 2; o > 0; o /= 2)
        c += __shfl_xor_sync(0xffffffffu, c, o);
      if (c >= k1) hi = mid; else lo = mid;
    }
    if (lane == 0) out[static_cast<size_t>(row) * I + i] = hi;
    __syncwarp();  // buf/q are rewritten by the next hypothesis
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

}  // namespace

extern "C" {

// Shared memory the launch needs for a given shape and warp count.
size_t score_quartile_smem_bytes(int N, int warps) {
  const int P = next_pow2(N > kWarp ? N : kWarp);
  return sizeof(float) * (3 * static_cast<size_t>(N)
                          + static_cast<size_t>(warps) * (P + N));
}

// The same for E8: N 16-bit slots (rounded up to even) a warp in place
// of N floats.
size_t score_quartile_i16_smem_bytes(int N, int warps) {
  const int P = next_pow2(N > kWarp ? N : kWarp);
  return sizeof(float) * (3 * static_cast<size_t>(N) + static_cast<size_t>(warps) * P)
         + sizeof(unsigned short) * static_cast<size_t>(warps) * i16_slots(N);
}

}  // extern "C"

namespace {

template <bool kI16>
int launch(const void* nP, const void* v, const void* counts, void* out, int B,
           int F, int N, int I, int warps, void* stream) {
  const int P = next_pow2(N > kWarp ? N : kWarp);
  const size_t smem = kI16 ? score_quartile_i16_smem_bytes(N, warps)
                           : score_quartile_smem_bytes(N, warps);
  cudaError_t err = cudaFuncSetAttribute(
      score_quartile_kernel<kI16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int rows = static_cast<unsigned int>(B) * F;
  score_quartile_kernel<kI16><<<rows, warps * kWarp, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nP), static_cast<const float*>(v),
      static_cast<const int*>(counts), static_cast<float*>(out), F, N, I, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K1/K2 on `stream` and returns cudaGetLastError() (0 on
// success). Allocates nothing; the caller owns every buffer.
int score_quartile_launch(const void* nP, const void* v, const void* counts,
                          void* out, int B, int F, int N, int I, int warps,
                          void* stream) {
  return launch<false>(nP, v, counts, out, B, F, N, I, warps, stream);
}

// Launches E8 the same way.
int score_quartile_i16_launch(const void* nP, const void* v, const void* counts,
                              void* out, int B, int F, int N, int I, int warps,
                              void* stream) {
  return launch<true>(nP, v, counts, out, B, F, N, I, warps, stream);
}

const char* score_quartile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
