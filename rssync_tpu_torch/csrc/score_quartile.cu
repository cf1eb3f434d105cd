// RANSAC hypothesis scoring: the quartile bracket of squared residuals.
//
// Replaces the TPU kernels rssync_tpu/ops/pallas_score.py
// score_quartile_pallas (body _score_kernel, K1) and
// score_quartile_pallas_batched (body _score_kernel_batched, K2), and
// experiments/r4_i16score.py score_i16 (body _kernel_i16, E8): one
// kernel template serves all three over B * F rows (B = 1 for K1).
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
// E8 (kI16 = true) holds the same bf16 bit patterns and compares them as
// int16. For +0, positive finite values and +inf the bf16 bits viewed as
// int16 are non-negative and ordered like the values, and every compared
// value here is one of those (s^2 >= +0, mid >= 0), so on finite inputs
// E8 is bit-equal to K1/K2; a NaN would order differently.
//
// Layouts (contiguous, float32 unless noted):
//   nP (B, 3, F, N), v (B, 3, F, I), counts (B, F) int32, out (B, F, I).
//
// What bounds it on the card: operations, the compare-and-count. At the
// PreSync operating point (6000 (delay, window) problems x 60 frames x
// 20 hypotheses x 130 features) that is 7.2 M (row, hypothesis) tasks,
// each comparing its 130 quantized residuals in 12 dependent rounds;
// nP is read once a row (~0.56 GB, ~0.17 ms of HBM time).
//
// Design: one thread per (row, hypothesis) task, t = row * I + i, with
// no cross-lane work at all. A block of consecutive tasks first stages
// the nP rows its tasks touch in shared memory (planes n0 | n1 | n2, so
// threads of one row read one address, a broadcast), with the features
// past the row's count stored as 0 (a table of each row's offset and
// count, made first, keeps divisions out of the copy). The thread then
// - computes its residuals two features at a time and packs the pair's
//   bf16 values into one 32-bit word (cvt.rn.bf16x2.f32): the compare
//   buffer is 2W slots in W registers (W = ceil(N/2) rounded up to 8,
//   a template parameter, so every index is a compile-time constant);
// - runs each bisection round over the W words with one packed compare
//   and one packed add a word and no shuffle: K1/K2 `set.le.bf16x2`
//   (1.0 or 0.0 in each half, NaN compares false) summed by
//   `add.rn.bf16x2` into four accumulators (counts <= 256 are exact in
//   bf16); E8 the SWAR compare ((m | 0x80008000) - w) & 0x80008000, bit
//   15 of a half set iff that half of w <= that half of m, summed as
//   (x >> 15) into the halves of four integer accumulators;
// - never tests a slot's validity: slots from the count up to 2W hold
//   s = v . 0 = 0 (v is finite), every round counts them (0 <= mid), so
//   the round compares its count with k + 1 + (2W - valid) in place of
//   k + 1. The padded slots add +0 to the max and the sum, which is
//   exact. (A NaN mid makes K1/K2 count no slot, padded or valid: the
//   decision is the one without the padding.)
// - sums the mean in the plain version's order with no padded tree:
//   tree_sum's halving tree over P = 2^k slots (x[j] += x[j + h], h =
//   P/2 ... 1) splits slot n by its lowest bit first, so its even slots
//   and its odd slots each form the same tree over words m = n / 2. The
//   template recursion `walk` builds those two trees over the W words at
//   compile time, pruning every subtree whose words are all >= W (zero,
//   and +0 added to a non-negative float is exact), then adds the two
//   roots: bit-equal to tree_sum for any padding.
// cuobjdump -sass of the sm_90a build (CUDA 12.8) shows the packed
// forms: K1/K2's compare is one HSET2.BF16_V2.BF.LE a word and its add a
// HADD2.BF16_V2 or HFMA2.MMA.BF16_V2 (x * 1 + acc); E8's is IADD3, LOP3
// and LEA.HI (acc + (x >> 15)) a word; no float expansion.
// Rows wider than kRegSlots (the wide route) keep the compare buffer in
// shared memory, column-major by thread ([word][thread], conflict-free),
// read nP through the read-only path, and sum the mean by a stack walk
// over the slots in bit-reversed order (one stack of partial sums,
// merged as a binary counter carries): the same tree, at run time.
//
// Numerics, bit for bit with the plain PyTorch version
// (rssync_tpu_torch/ops/score.py::score_quartile_batched_ref):
// - s is (v0*n0 + v1*n1) + v2*n2, then squared, with explicitly
//   rounded, never fused, multiplies and adds (__fmul_rn/__fadd_rn);
//   an FMA would move s by an ulp and can flip a bf16 compare (which is
//   also why tensor cores cannot take the residual);
// - the mean's sum in tree_sum's order (above); the max is order-free;
//   the division and the Markov product are IEEE (__fdiv_rn, __fmul_rn);
// - both sides of every compare are rounded to bf16 with
//   round-to-nearest-even.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <utility>

namespace {

constexpr int kBisectRounds = 12;
constexpr float kMarkovC = 2.03125f;
// compare-buffer words (two slots each) the register route holds at
// most, and the step between its instances. The paths launch W = 24
// (N = 40) and W = 72 (N = 130); from N = 160 to 256 the register route
// was the faster of the two by far in a timed comparison on the H100.
constexpr int kRegWords = 128;
constexpr int kRegStep = 8;
constexpr int kRegSlots = 2 * kRegWords;
// accumulators a round sums into; the wide route's word count is a
// multiple of it. A bf16 count is exact up to 256, so a round adds at
// most kRegWords words (<= 256 slots) into one set of accumulators.
constexpr int kAcc = 4;
// tasks (threads) a block takes at most
constexpr int kMaxThreads = 128;

// Blocks of kMaxThreads an SM should hold. A register-route thread needs
// about W + 30 registers (its W words, the stack of partial sums, the
// row's scalars); where that fits five blocks (20 warps) in the SM's
// 65536 registers, the compiler is held to it: left alone it took 100 at
// W = 72, which allocates four. Above that W, one.
__host__ __device__ constexpr int min_blocks(int W) {
  return W + 30 <= 65536 / (5 * kMaxThreads) ? 5 : 1;
}

// {bf16(hi), bf16(lo)} in the upper and lower half, round to nearest even
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  unsigned int r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// per half: 1.0 if a <= b (ordered: false for NaN), else 0.0
__device__ __forceinline__ unsigned int le_bf16x2(unsigned int a, unsigned int b) {
  unsigned int r;
  asm("set.le.bf16x2.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned int add_bf16x2(unsigned int a, unsigned int b) {
  unsigned int r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// What one bisection round compares each word with.
template <bool kI16>
__device__ __forceinline__ unsigned int round_key(float mid) {
  const unsigned int m = pack_bf16x2(mid, mid);
  return kI16 ? (m | 0x80008000u) : m;
}

// Adds the number of the word's two slots <= the key to one accumulator.
template <bool kI16>
__device__ __forceinline__ unsigned int count_word(unsigned int acc, unsigned int w,
                                                   unsigned int key) {
  if constexpr (kI16) return acc + (((key - w) & 0x80008000u) >> 15);
  else return add_bf16x2(acc, le_bf16x2(w, key));
}

template <bool kI16>
__device__ __forceinline__ int count_total(const unsigned int (&acc)[kAcc]) {
  if constexpr (kI16) {
    const unsigned int a = acc[0] + acc[1] + acc[2] + acc[3];
    return static_cast<int>((a & 0xffffu) + (a >> 16));
  } else {
    const unsigned int a = add_bf16x2(add_bf16x2(acc[0], acc[1]), add_bf16x2(acc[2], acc[3]));
    return static_cast<int>(__uint_as_float(a << 16) + __uint_as_float(a & 0xffff0000u));
  }
}

// (s_n)^2 of one staged feature, every operation separately rounded
__device__ __forceinline__ float sq_residual(float v0, float v1, float v2, float n0, float n1,
                                             float n2) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(v0, n0), __fmul_rn(v1, n1)), __fmul_rn(v2, n2));
  return __fmul_rn(s, s);
}

// the row (b, f) of task t
struct Task {
  int row, b, f;
};

__device__ __forceinline__ Task task_of(long long t, int F, int I) {
  Task k;
  k.row = static_cast<int>(t / I);
  k.b = k.row / F;
  k.f = k.row - k.b * F;
  return k;
}

// The row's scalars: valid features, the count threshold before the
// padding correction, and the mean's denominator.
struct RowCount {
  int valid, k1;
  float denom;
};

__device__ __forceinline__ RowCount row_count(const int* counts, int row, int N) {
  const int cnt = counts[row];
  RowCount c;
  c.valid = cnt < 0 ? 0 : (cnt < N ? cnt : N);
  c.k1 = (cnt > 1 ? cnt : 1) / 4 + 1;
  c.denom = static_cast<float>(cnt > 1 ? cnt : 1);
  return c;
}

// ---- the register route --------------------------------------------------

// The staged row: planes x (n0), x + 2W (n1), x + 4W (n2). at<M>() visits
// word M: both residuals, their packed bf16 word, the max; returns the
// pair.
template <int W>
struct Leaves {
  const float* x;
  float v0, v1, v2;
  unsigned int (&w)[W];
  float& mx;

  template <int M>
  __device__ __forceinline__ float2 at() const {
    const float2 a = *reinterpret_cast<const float2*>(x + 2 * M);
    const float2 b = *reinterpret_cast<const float2*>(x + 2 * W + 2 * M);
    const float2 c = *reinterpret_cast<const float2*>(x + 4 * W + 2 * M);
    const float e = sq_residual(v0, v1, v2, a.x, b.x, c.x);
    const float o = sq_residual(v0, v1, v2, a.y, b.y, c.y);
    w[M] = pack_bf16x2(e, o);
    mx = fmaxf(mx, fmaxf(e, o));
    return make_float2(e, o);
  }
};

// Sums over the words m = R (mod S) of (even slot, odd slot) in
// tree_sum's order: the class splits into m = R and m = R + S (mod 2S),
// down to single words at S = WP (the words' power of two). A class
// whose least word R + S is >= W holds only zeros and is pruned.
template <int W, int WP, int R, int S>
__device__ __forceinline__ float2 walk(const Leaves<W>& leaves) {
  if constexpr (S == WP) {
    return leaves.template at<R>();
  } else {
    const float2 a = walk<W, WP, R, 2 * S>(leaves);
    if constexpr (R + S >= W) {
      return a;
    } else {
      const float2 b = walk<W, WP, R + S, 2 * S>(leaves);
      return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

template <int W, bool kI16>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(W)) score_regs_kernel(
    const float* __restrict__ nP, const float* __restrict__ v,
    const int* __restrict__ counts, float* __restrict__ out,
    int F, int N, int I, long long tasks) {
  constexpr int kSlots = 2 * W;
  // floats a staged row takes: three planes, then 2 so that the rows of
  // one warp start in other banks
  constexpr int kRow = 3 * kSlots + 2;
  extern __shared__ float2 staged2[];
  float* staged = reinterpret_cast<float*>(staged2);

  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long t_end = t0 + blockDim.x < tasks ? t0 + blockDim.x : tasks;
  const int row0 = static_cast<int>(t0 / I);
  const int nrows = static_cast<int>((t_end - 1) / I) - row0 + 1;
  const size_t plane = static_cast<size_t>(F) * N;
  // each staged row's offset in nP and valid features, behind the rows
  // (nrows * kRow is even: 8-byte aligned)
  long long* row_base = reinterpret_cast<long long*>(staged + nrows * kRow);
  int* row_valid = reinterpret_cast<int*>(row_base + nrows);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int row = row0 + r;
    const int b = row / F;
    const int f = row - b * F;
    row_base[r] = static_cast<long long>(b) * 3 * plane + static_cast<long long>(f) * N;
    row_valid[r] = row_count(counts, row, N).valid;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * kSlots; e += blockDim.x) {
    const int r = e / kSlots;
    const int n = e - r * kSlots;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
    if (n < row_valid[r]) {
      const float* src = nP + row_base[r] + n;
      x0 = __ldg(src);
      x1 = __ldg(src + plane);
      x2 = __ldg(src + 2 * plane);
    }
    float* dst = staged + r * kRow + n;
    dst[0] = x0;
    dst[kSlots] = x1;
    dst[2 * kSlots] = x2;
  }
  __syncthreads();

  const long long t = t0 + threadIdx.x;
  if (t >= tasks) return;
  const Task k = task_of(t, F, I);
  const RowCount c = row_count(counts, k.row, N);
  const size_t stride_v = static_cast<size_t>(F) * I;
  // v[b, 0, f, i] sits at t + 2 b F I
  const float* vt = v + t + 2 * static_cast<size_t>(k.b) * stride_v;
  const float v0 = __ldg(vt), v1 = __ldg(vt + stride_v), v2 = __ldg(vt + 2 * stride_v);

  unsigned int w[W];
  float mx = 0.0f;
  const Leaves<W> leaves{staged + (k.row - row0) * kRow, v0, v1, v2, w, mx};
  const float2 eo = walk<W, pow2_at_least(W), 0, 1>(leaves);
  const float mu = __fdiv_rn(__fadd_rn(eo.x, eo.y), c.denom);
  float lo = 0.0f;
  float hi = fminf(mx, __fmul_rn(kMarkovC, mu));
  const int need = c.k1 + (kSlots - c.valid);

#pragma unroll 1
  for (int r = 0; r < kBisectRounds; ++r) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const unsigned int key = round_key<kI16>(mid);
    unsigned int acc[kAcc] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j % kAcc] = count_word<kI16>(acc[j % kAcc], w[j], key);
    if (count_total<kI16>(acc) >= need) hi = mid; else lo = mid;
  }
  out[t] = hi;
}

// ---- the wide route --------------------------------------------------------

// W words (a multiple of kAcc) a thread in shared memory, [word][thread];
// P = 2^logP >= N slots walked in bit-reversed order.
template <bool kI16>
__global__ void __launch_bounds__(kMaxThreads) score_wide_kernel(
    const float* __restrict__ nP, const float* __restrict__ v,
    const int* __restrict__ counts, float* __restrict__ out,
    int F, int N, int I, long long tasks, int W, int logP) {
  extern __shared__ unsigned int words[];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= tasks) return;
  const int T = blockDim.x;
  const Task k = task_of(t, F, I);
  const RowCount c = row_count(counts, k.row, N);
  const size_t plane = static_cast<size_t>(F) * N;
  const float* x = nP + static_cast<size_t>(k.b) * 3 * plane + static_cast<size_t>(k.f) * N;
  const size_t stride_v = static_cast<size_t>(F) * I;
  const float* vt = v + t + 2 * static_cast<size_t>(k.b) * stride_v;
  const float v0 = __ldg(vt), v1 = __ldg(vt + stride_v), v2 = __ldg(vt + 2 * stride_v);
  unsigned short* halves = reinterpret_cast<unsigned short*>(words);

  float stack[32];
  int depth = 0;
  float mx = 0.0f;
  const int P = 1 << logP;
  for (int q = 0; q < P; ++q) {
    const int n = static_cast<int>(__brev(static_cast<unsigned int>(q)) >> (32 - logP));
    float s2 = 0.0f;
    if (n < c.valid) s2 = sq_residual(v0, v1, v2, __ldg(x + n), __ldg(x + plane + n),
                                      __ldg(x + 2 * plane + n));
    if (n < 2 * W) halves[2 * ((n >> 1) * T + threadIdx.x) + (n & 1)] =
        static_cast<unsigned short>(pack_bf16x2(s2, 0.0f));
    mx = fmaxf(mx, s2);
    // a leaf closes one subtree for each trailing one of q
    for (int m = q + 1; (m & 1) == 0; m >>= 1) s2 = __fadd_rn(stack[--depth], s2);
    stack[depth++] = s2;
  }
  const float mu = __fdiv_rn(stack[0], c.denom);
  float lo = 0.0f;
  float hi = fminf(mx, __fmul_rn(kMarkovC, mu));
  const int need = c.k1 + (2 * W - c.valid);
  const unsigned int* mine = words + threadIdx.x;

  for (int r = 0; r < kBisectRounds; ++r) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const unsigned int key = round_key<kI16>(mid);
    int count = 0;
    for (int j0 = 0; j0 < W; j0 += kRegWords) {  // kRegWords words keep a bf16 count exact
      const int j1 = j0 + kRegWords < W ? j0 + kRegWords : W;
      unsigned int acc[kAcc] = {0u, 0u, 0u, 0u};
      for (int j = j0; j < j1; j += kAcc) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a) acc[a] = count_word<kI16>(acc[a], mine[(j + a) * T], key);
      }
      count += count_total<kI16>(acc);
    }
    if (count >= need) hi = mid; else lo = mid;
  }
  out[t] = hi;
}

// ---- route selection -------------------------------------------------------

using RegKernel = void (*)(const float*, const float*, const int*, float*, int, int, int,
                           long long);

template <bool kI16, int... Steps>
RegKernel reg_kernel_at(int step, std::integer_sequence<int, Steps...>) {
  static const RegKernel table[] = {&score_regs_kernel<kRegStep * (Steps + 1), kI16>...};
  return table[step];
}

// the register route's instance for N: ceil(N / 2) words rounded up
int reg_words(int N) { return ((N + 1) / 2 + kRegStep - 1) / kRegStep * kRegStep; }

template <bool kI16>
RegKernel reg_kernel(int N) {
  return reg_kernel_at<kI16>(reg_words(N) / kRegStep - 1,
                             std::make_integer_sequence<int, kRegWords / kRegStep>{});
}

int wide_words(int N) { return ((N + 1) / 2 + kAcc - 1) / kAcc * kAcc; }

int log2_at_least(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

const void* kernel_for(int N, bool i16) {
  if (N <= kRegSlots) {
    return reinterpret_cast<const void*>(i16 ? reg_kernel<true>(N) : reg_kernel<false>(N));
  }
  return reinterpret_cast<const void*>(i16 ? score_wide_kernel<true> : score_wide_kernel<false>);
}

// Dynamic shared memory a block of `threads` tasks needs: the register
// route stages the rows those tasks touch, with each row's offset and
// valid count; the wide route holds each thread's compare buffer.
size_t smem_bytes(int N, int I, int threads) {
  if (N <= kRegSlots) {
    const size_t rows = 1 + (static_cast<size_t>(threads) - 1 + I - 1) / I;
    return rows * (sizeof(float) * (6 * static_cast<size_t>(reg_words(N)) + 2)
                   + sizeof(long long) + sizeof(int));
  }
  return sizeof(unsigned int) * static_cast<size_t>(wide_words(N)) * threads;
}

// Tasks a block takes: kMaxThreads, halved while the block's shared
// memory would exceed `max_smem`; 0 if one task does not fit.
int block_threads(int N, int I, size_t max_smem) {
  for (int threads = kMaxThreads; threads >= 1; threads /= 2) {
    if (smem_bytes(N, I, threads) <= max_smem) return threads;
  }
  return 0;
}

}  // namespace

extern "C" {

// The kernel a launch at N takes (i16: E8's): its registers a thread and
// local-memory bytes a thread (spills show there). Returns
// cudaFuncGetAttributes' code.
int score_quartile_kernel_attrs(int N, int i16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel_for(N, i16 != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // extern "C"

namespace {

template <bool kI16>
int launch(const void* nP, const void* v, const void* counts, void* out, int B, int F, int N,
           int I, void* stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(N, I, static_cast<size_t>(max_smem));
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tasks = static_cast<long long>(B) * F * I;
  const size_t smem = smem_bytes(N, I, threads);
  const void* fn = kernel_for(N, kI16);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((tasks + threads - 1) / threads);
  const auto* p = static_cast<const float*>(nP);
  const auto* q = static_cast<const float*>(v);
  const auto* cnt = static_cast<const int*>(counts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  int W = wide_words(N), logP = log2_at_least(N);
  void* args[] = {&p, &q, &cnt, &o, &F, &N, &I, const_cast<long long*>(&tasks), &W, &logP};
  // the register route's kernels take the arguments before W
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, s);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Launches K1/K2 on `stream` on the current device and returns the
// launch's CUDA error code (0 on success; cudaErrorInvalidValue where
// one task's shared memory exceeds the device's). The kernel's route
// and the tasks a block takes follow from N and I. Allocates nothing;
// the caller owns every buffer.
int score_quartile_launch(const void* nP, const void* v, const void* counts, void* out, int B,
                          int F, int N, int I, void* stream) {
  return launch<false>(nP, v, counts, out, B, F, N, I, stream);
}

// Launches E8 the same way.
int score_quartile_i16_launch(const void* nP, const void* v, const void* counts, void* out,
                              int B, int F, int N, int I, void* stream) {
  return launch<true>(nP, v, counts, out, B, F, N, I, stream);
}

const char* score_quartile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
