// Exact all-pairs passes of the direct N-body model, for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package's models/direct_nbody.py,
// which has no Pallas kernel:
//   direct_forces_kernel<T>: _pair_forces (:36-80), the exact all-pairs
//     gravity with the periodic minimum image, over receiver chunks of N x
//     jchunk matrices;
//   direct_collisions_kernel<T>: the collision block of make_step
//     (:105-117), the global EPSILON first-pair search over N x N matrices
//     of ranks i * (n + 1) + j.
// T is float or double.
//
// What bounds them on an H100: both do O(N^2) pair arithmetic on O(N) data
// (at N = 1e5, 1e10 pairs a pass on 2 MB of inputs), so bytes cost nothing
// and the instruction rate sets the time. The function needs ~22 f32
// operations a pair for the force and ~14 for the hit test, and one rsqrt
// (on the special-function unit, 16 an SM and clock) for the force only:
// for |dx| < side, rint(dx / side) is 0 or +-1, and +-1 exactly where |dx|
// reaches one threshold, so the minimum image needs no division. This
// kernel still divides and rounds, as JAX's code does: two IEEE divisions
// (a reciprocal on the special-function unit plus Newton steps and range
// checks) and two roundings a pair, which the bound does not count.
//
// Design, simple first: 256 threads a block, kSplit = 4 threads a receiver
// (part p of a receiver takes the p-th contiguous slice of every tile). The
// block stages partner tiles of 256 (x, y, m) or (x, y, alive) in shared
// memory and each thread loops over its slice in ascending j. Splitting a
// receiver multiplies the warps in flight: at N = 1e5 one receiver a thread
// gives only ~24 warps an SM for chains of dependent divisions, roundings
// and rsqrts (measured once at N = 1e5 on an H100: forces 22.12, 21.09 and
// 20.38 device ms at 1, 2 and 4 threads a receiver; PERF.md). The parts'
// sums are added in part order in shared memory, and the parts' first hits
// reduce by minimum. No atomics, no padding (the tail tile is cut by
// bounds), and a fixed order, so two runs give the same bits.
//
// Arithmetic as JAX's, term by term: dx = x[j] - x[i], dx -= side *
// rint(dx / side) (rint rounds half to even, as jnp.round; the division is
// a true IEEE one, so a partner near side / 2 takes JAX's image), d2 = dx*dx
// + dy*dy, computed with the _rn intrinsics so that no multiply-add is
// contracted: the hit test d2 < eps2 then sees JAX's d2 exactly. The force
// term is s = ((G m_i) m_j)((inv inv) inv) with inv = rsqrt(d2) for d2 > 0
// and 0 for d2 = 0 (coincident particles exert no force).
//
// Collisions: JAX ranks a pair (i, j), i < j, by i * (n + 1) + j in int32,
// which wraps for n >= 46341; the ranks order the pairs as (min, max)
// lexicographically. Among the pairs of slot i, that order is the order of
// the partner index j (every pair (j, i) with j < i comes before every pair
// (i, j) with j > i). So slot i's first pair is its smallest hitting j, and
// the kernel writes that partner, or -1 for none: no rank, no wrap. The
// count of pairs first for both ends and the deaths follow in O(N) outside.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Threads a receiver; kRecv receivers a block.
constexpr int kSplit = 4;
constexpr int kRecv = kThreads / kSplit;

// Correctly rounded arithmetic, never contracted into a multiply-add.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float round_even(float a) { return rintf(a); }
__device__ __forceinline__ double round_even(double a) { return rint(a); }
__device__ __forceinline__ float rsqrt_of(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_of(double a) { return rsqrt(a); }

// The minimum-image displacement b - a on a torus of period side.
template <typename T>
__device__ __forceinline__ T min_image(T b, T a, T side) {
  const T d = sub_rn(b, a);
  return sub_rn(d, mul_rn(side, round_even(div_rn(d, side))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    direct_forces_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ m, T* __restrict__ fx,
                         T* __restrict__ fy, int n, T side, T g) {
  // Part p takes partners [p kRecv, (p+1) kRecv) of each tile.
  __shared__ T sx[kThreads], sy[kThreads], sm[kThreads];
  const int r = threadIdx.x % kRecv, part = threadIdx.x / kRecv;
  const int i = blockIdx.x * kRecv + r;
  const bool live = i < n;
  const T xi = live ? x[i] : T(0);
  const T yi = live ? y[i] : T(0);
  const T gmi = live ? g * m[i] : T(0);
  T ax = 0, ay = 0;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      sx[threadIdx.x] = x[j];
      sy[threadIdx.x] = y[j];
      sm[threadIdx.x] = m[j];
    }
    __syncthreads();
    const int lo = part * kRecv, hi = min(lo + kRecv, n - j0);
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      const T dx = min_image(sx[k], xi, side);
      const T dy = min_image(sy[k], yi, side);
      const T d2 = add_rn(mul_rn(dx, dx), mul_rn(dy, dy));
      const T inv = d2 > T(0) ? rsqrt_of(d2) : T(0);
      const T s = (gmi * sm[k]) * ((inv * inv) * inv);
      ax += s * dx;
      ay += s * dy;
    }
    __syncthreads();
  }
  sx[threadIdx.x] = ax;  // the tiles are done with: reuse for the parts
  sy[threadIdx.x] = ay;
  __syncthreads();
  if (part != 0) return;
  for (int p = 1; p < kSplit; ++p) {
    ax += sx[p * kRecv + r];
    ay += sy[p * kRecv + r];
  }
  if (live) {
    fx[i] = ax;
    fy[i] = ay;
  }
}

// Partners a collision test takes in one group.
constexpr int kGroup = 4;

// d^2 < eps2 for the minimum-image displacement of (bx, by) from (ax, ay).
template <typename T>
__device__ __forceinline__ bool collides(T bx, T by, T ax, T ay, T side,
                                         T eps2) {
  const T dx = min_image(bx, ax, side);
  const T dy = min_image(by, ay, side);
  return add_rn(mul_rn(dx, dx), mul_rn(dy, dy)) < eps2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    direct_collisions_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             const bool* __restrict__ alive,
                             int* __restrict__ first, int n, T side, T eps2) {
  __shared__ T sx[kThreads], sy[kThreads];
  __shared__ bool sa[kThreads];
  __shared__ int sfound[kThreads];
  const int r = threadIdx.x % kRecv, part = threadIdx.x / kRecv;
  const int i = blockIdx.x * kRecv + r;
  const bool live = i < n && alive[i];
  const T xi = live ? x[i] : T(0);
  const T yi = live ? y[i] : T(0);
  int found = -1;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      sx[threadIdx.x] = x[j];
      sy[threadIdx.x] = y[j];
      sa[threadIdx.x] = alive[j];
    }
    __syncthreads();
    if (live && found < 0) {
      // Ascending j within the part, so the part's first hit is its
      // smallest. Partners go in groups of kGroup with no branch inside a
      // group, so that their dependent chains (division, rounding, d^2)
      // overlap.
      const int lo = part * kRecv, hi = min(lo + kRecv, n - j0);
      int k = lo;
      for (; k + kGroup <= hi && found < 0; k += kGroup) {
        bool hit[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          hit[u] = collides(sx[k + u], sy[k + u], xi, yi, side, eps2) &&
                   sa[k + u] && j0 + k + u != i;
#pragma unroll
        for (int u = kGroup - 1; u >= 0; --u)
          if (hit[u]) found = j0 + k + u;
      }
      for (; k < hi && found < 0; ++k)
        if (collides(sx[k], sy[k], xi, yi, side, eps2) && sa[k] &&
            j0 + k != i)
          found = j0 + k;
    }
    __syncthreads();
  }
  // The smallest of the parts' first hits.
  sfound[threadIdx.x] = found;
  __syncthreads();
  if (part != 0) return;
  for (int p = 1; p < kSplit; ++p) {
    const int f = sfound[p * kRecv + r];
    if (f >= 0 && (found < 0 || f < found)) found = f;
  }
  if (i < n) first[i] = found;
}

template <typename T>
void launch_forces(const void* x, const void* y, const void* m, void* fx,
                   void* fy, int n, double side, double g, cudaStream_t s) {
  direct_forces_kernel<T><<<(n + kRecv - 1) / kRecv, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(m), static_cast<T*>(fx), static_cast<T*>(fy), n,
      (T)side, (T)g);
}

template <typename T>
void launch_collisions(const void* x, const void* y, const bool* alive,
                       int* first, int n, double side, double eps2,
                       cudaStream_t s) {
  direct_collisions_kernel<T><<<(n + kRecv - 1) / kRecv, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), alive, first, n,
      (T)side, (T)eps2);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for n < 1).
// f64 selects double arrays, else float; side, g and eps2 are cast to the
// arrays' type (the caller computes eps2 in that type).
extern "C" int psim_direct_forces(const void* x, const void* y, const void* m,
                                  void* fx, void* fy, int n, double side,
                                  double g, int f64, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    launch_forces<double>(x, y, m, fx, fy, n, side, g, s);
  else
    launch_forces<float>(x, y, m, fx, fy, n, side, g, s);
  return (int)cudaGetLastError();
}

// alive: one byte a slot (torch.bool); first: int32, the partner or -1.
extern "C" int psim_direct_collisions(const void* x, const void* y,
                                      const bool* alive, int* first, int n,
                                      double side, double eps2, int f64,
                                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    launch_collisions<double>(x, y, alive, first, n, side, eps2, s);
  else
    launch_collisions<float>(x, y, alive, first, n, side, eps2, s);
  return (int)cudaGetLastError();
}
