// Emission's undistort and ray lift: pixels -> unit rays, one thread a point.
//
// Replaces no TPU kernel: the JAX package undistorts in plain jnp, which
// XLA fuses into one program. The port's plain version,
// rays_from_normalized(undistort_points(...)) in ops/lens.py, runs as
// separate PyTorch kernels: 9 Newton iterations, each unrolling the
// safeguard's `while` into 40 halving steps, about 2300 launches a call for
// a few thousand points, each finished by the card before the host issues
// the next. Two calls a tracked block made them most of emission's time.
//
// What bounds it on this card: neither bytes (20 or 40 a point) nor
// operations (~270 a point); a call is one launch, and its time is the
// launch and the latency of one point's dependent chain (9 Newton steps,
// each with a division). Design: one thread a point, everything in
// registers, one launch a call.
//
// Bit-equal to the plain version on the card. Every operation is the
// plain version's, in its order and its dtype, each rounded once (built
// with -fmad=false, so no product is fused into a sum):
//   x = (px - cx) * inv_fx, y = (py - cy) * inv_fy   (PyTorch on CUDA divides
//       by a Python scalar as a product with its reciprocal, rounded once in
//       the dtype; the wrapper passes the constants so rounded)
//   theta_d = sqrt(x x + y y); theta = pi/4, 9 Newton steps on
//       theta (1 + t2 (k1 + t2 (k2 + t2 (k3 + t2 k4)))) = theta_d with the
//       derivative 1 + d3 t2 + d5 t4 + d7 t6 + d9 t8 (d = 3 k1, ..., 9 k4
//       rounded once), each step halved back toward the previous iterate
//       while outside (0, pi/2), at most 40 times: the plain version's
//       torch.where leaves an iterate in range alone, and it stays in range,
//       so stopping early gives the same bits;
//   s = 1 / cos(theta) where theta_d < 1e-9, else tan(theta) / max(theta_d,
//       1e-30); (x s, y s), or (0, 0) where the raw pixel's norm < 1e-8;
//   the ray normalize([x, y, 1]), its norm summed as torch.linalg.vector_norm
//       sums a row of 3 on the card: two lanes, the first holding x^2 + 1,
//       the second y^2, then the lanes added (on an H100 with PyTorch
//       2.11, no other order of the three gave the same bits).
// Python scalars meet a tensor rounded to its dtype; tanf / cosf are the
// accurate (non-fast-math) ones, divisions and square roots IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct LensConsts {
  T cx, cy, inv_fx, inv_fy;
  T k1, k2, k3, k4;
  T d3, d5, d7, d9;
  T half_pi, quarter_pi;
};

__device__ __forceinline__ float tan_of(float x) { return tanf(x); }
__device__ __forceinline__ double tan_of(double x) { return tan(x); }
__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

template <typename T>
__global__ void lift_rays_kernel(const T* __restrict__ pts, T* __restrict__ rays, long long n,
                                 LensConsts<T> c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T px = pts[2 * i], py = pts[2 * i + 1];
  const T x = (px - c.cx) * c.inv_fx;
  const T y = (py - c.cy) * c.inv_fy;
  const T theta_d = sqrt_of(x * x + y * y);

  T theta = c.quarter_pi;
#pragma unroll 1
  for (int it = 0; it < 9; ++it) {
    const T t2 = theta * theta;
    const T t4 = t2 * t2;
    const T t6 = t4 * t2;
    const T t8 = t4 * t4;
    const T cur = theta * (T(1) + t2 * (c.k1 + t2 * (c.k2 + t2 * (c.k3 + t2 * c.k4))));
    const T dcur = (((T(1) + c.d3 * t2) + c.d5 * t4) + c.d7 * t6) + c.d9 * t8;
    T next = theta - (cur - theta_d) / dcur;
    for (int h = 0; h < 40 && (next >= c.half_pi || next <= T(0)); ++h) {
      next = T(0.5) * (next + theta);
    }
    theta = next;
  }

  // torch.clamp(theta_d, min=1e-30) keeps a NaN
  const T den = theta_d < T(1e-30) ? T(1e-30) : theta_d;
  const T s = theta_d < T(1e-9) ? T(1) / cos_of(theta) : tan_of(theta) / den;
  T ux = x * s, uy = y * s;
  if (sqrt_of(px * px + py * py) < T(1e-8)) {
    ux = T(0);
    uy = T(0);
  }
  const T norm = sqrt_of((ux * ux + T(1)) + uy * uy);
  rays[3 * i] = ux / norm;
  rays[3 * i + 1] = uy / norm;
  rays[3 * i + 2] = T(1) / norm;
}

template <typename T>
int launch(const void* points, void* rays, long long n, const double* k, cudaStream_t stream) {
  LensConsts<T> c;
  T* fields[] = {&c.cx, &c.cy, &c.inv_fx, &c.inv_fy, &c.k1, &c.k2, &c.k3, &c.k4,
                 &c.d3, &c.d5, &c.d7, &c.d9, &c.half_pi, &c.quarter_pi};
  for (int j = 0; j < 14; ++j) *fields[j] = static_cast<T>(k[j]);  // exact: rounded already
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  lift_rays_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(points), static_cast<T*>(rays), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lifts n >= 1 points (n x 2, contiguous, float32 or, with f64, float64) at
// `points` to unit rays (n x 3) at `rays`, on `stream`. `consts` (host
// memory) holds the 14 lens constants in LensConsts' order, each already
// rounded to the points' dtype. Returns cudaGetLastError() (0 on success).
// Allocates nothing.
int lift_rays_launch(const void* points, void* rays, long long n, int f64, const double* consts,
                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(points, rays, n, consts, s)
             : launch<float>(points, rays, n, consts, s);
}

const char* lift_rays_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
