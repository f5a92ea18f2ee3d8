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
// (at N = 1e5, 1e10 pairs a pass on 2 MB of inputs, which stay in L2), so
// bytes cost nothing and the instruction issue rate sets the time: four
// warp instructions an SM and clock, of which the special-function unit
// (rsqrt) takes at most one in eight. What the design does about it:
//
// * The minimum image by threshold, not by division. JAX computes d - side
//   * rint(d / side): two IEEE divisions (a reciprocal on the
//   special-function unit, Newton steps, a range check) and two roundings a
//   pair. For |d| < side, fl(|d| / side) is at most 1, so rint gives 0 or
//   +-1, and +-1 exactly where |d| reaches the threshold t, the smallest
//   float with fl(t / side) > 0.5 (not side / 2: at side / 2 the quotient
//   is 0.5 and rounds half to even, to 0). The host finds t by bisection
//   with the same IEEE division (min_image_threshold in
//   ops/cuda/direct_nbody.py) and passes it in. Then the image is d -
//   copysign(side, d) for |d| >= t, and d below, with the bits of JAX's
//   form; d - copysign(0, d) would also turn a -0 into JAX's +0, and the
//   kernels instead add +0 to every position as it is loaded, so that no
//   difference is -0. A block takes this path (no test of |d| against side
//   a pair) for a tile of partners and receivers all in [0, side), where
//   every |d| < side; for any other tile each pair takes it where |d| <
//   side and JAX's division elsewhere, so the bits hold on every input.
//   Nothing of the image or of d^2 is contracted into a multiply-add (the
//   _rn intrinsics): the hit test d^2 < eps2 sees JAX's d^2 exactly.
//
// * Forces: register tiles. A pair needs ~20 instructions (two images of 4
//   each, d^2 3, rsqrt 1, the cube 2, the scale 2, two multiply-adds), so
//   loads and loop control must not add per pair. Each partner is staged
//   once in shared memory as (x, y, m, 0) and read with one 16-byte
//   broadcast load (two in float64) that serves the kForceRecv receivers a
//   thread holds in registers; kForceSplit threads share a receiver (part p
//   takes the p-th contiguous slice of every tile), so that N = 1e5 still
//   gives enough warps. rsqrtf's own form tests for a subnormal input a
//   pair; here one MUFU.RSQ (rsqrt.approx.ftz, the same bits on a normal
//   input) serves each pair, and a step of kForceGroup partners whose d^2
//   is 0 or not a normal float (a particle's own slot, or coincident ones)
//   is redone with rsqrtf and the test d^2 > 0 before anything is summed.
//   A receiver's terms are summed in partner order, and the parts in part
//   order: two runs give the same bits, with no atomics. wgmma does not
//   serve: each term needs d^2 of the minimum-image difference (the exact
//   hit test, and the force's rsqrt), so no step is a matrix product; and
//   TMA buys little, since the inputs stay in L2 and a tile is one 16-byte
//   load a partner.
//
// * Collisions: a test on x alone first. fl(dx^2) >= eps2 implies fl(fl(dx^2)
//   + fl(dy^2)) >= eps2, so a pair whose x image is too long cannot hit; on
//   an in-box tile that is, for the raw difference d, |fl(|d| - c)| <= h for
//   the host's (c, h) (collision_window), which keeps every hitting pair
//   out. Each pair costs two adds and one compare, folded into one
//   predicate for kCollideGroup partners of all kCollideRecv receivers of a
//   thread (partners' x read four at a time); only a group with a candidate
//   (rare: a pair in ~1e5 at side 1000) takes the exact test: both images,
//   d^2 < eps2, partner != self. A dead partner's x is staged as NaN, which
//   passes no test, so the alive flags cost nothing a pair.
//
// Collisions: JAX ranks a pair (i, j), i < j, by i * (n + 1) + j in int32,
// which wraps for n >= 46341; the ranks order the pairs as (min, max)
// lexicographically. Among the pairs of slot i, that order is the order of
// the partner index j (every pair (j, i) with j < i comes before every pair
// (i, j) with j > i). So slot i's first pair is its smallest hitting j, and
// the kernel writes that partner, or -1 for none: no rank, no wrap. Each
// part scans its slices in ascending j, so its first hit is its smallest,
// and the parts' first hits reduce by minimum. The count of pairs first for
// both ends and the deaths follow in O(N) outside.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Partners staged in shared memory a tile; each of a receiver's parts
// takes kTile / split of them.
constexpr int kTile = 1024;
// Threads a receiver and receivers a thread, of each pass (chosen by the
// sweep of ops/cuda/direct_sweep.py; PERF.md).
constexpr int kForceSplit = 4;
constexpr int kForceRecv = 4;
constexpr int kCollideSplit = 4;
constexpr int kCollideRecv = 4;
// Partners a step of the force loop, and of the collision prefilter.
constexpr int kForceGroup = 2;
constexpr int kCollideGroup = 4;

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
__device__ __forceinline__ float nan_of(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7fffffffffffffffLL);
}

// A position as loaded: -0 becomes +0 (nothing else changes), so that no
// difference of two positions is -0.
template <typename T>
__device__ __forceinline__ T load_pos(const T* p, int i) {
  return add_rn(p[i], T(0));
}

template <typename T>
__device__ __forceinline__ bool in_box(T x, T y, T side) {
  return x >= T(0) && x < side && y >= T(0) && y < side;
}

// The minimum image of the difference d (never -0) on a torus of period
// side, JAX's d - side * rint(d / side) bit for bit: by the threshold t
// where |d| < side (always, kAnyD false: positions in [0, side)), else by
// JAX's division.
template <bool kAnyD, typename T>
__device__ __forceinline__ T image(T d, T side, T t) {
  if (kAnyD && !(fabs(d) < side))
    return sub_rn(d, mul_rn(side, round_even(div_rn(d, side))));
  return fabs(d) >= t ? sub_rn(d, copysign(side, d)) : d;
}

template <typename T>
struct alignas(4 * sizeof(T)) Partner {
  T x, y, m, pad;
};

// 1 / sqrt(d2) as rsqrt_of gives it, for a d2 that is a normal float: in
// float32 one MUFU.RSQ (rsqrt.approx.ftz; rsqrtf differs only on
// subnormal inputs). ok turns false for any other d2 (0, subnormal, NaN),
// which the caller redoes with inv_exact. In float64, inv_exact itself.
__device__ __forceinline__ float inv_fast(float d2, bool& ok) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d2));
  ok &= d2 >= FLT_MIN;
  return r;
}
__device__ __forceinline__ double inv_fast(double d2, bool&) {
  return d2 > 0.0 ? rsqrt(d2) : 0.0;
}
// JAX's where(d2 > 0, rsqrt(d2), 0): coincident particles exert no force.
template <typename T>
__device__ __forceinline__ T inv_exact(T d2) {
  return d2 > T(0) ? rsqrt_of(d2) : T(0);
}

// G partners p[0..G) on the thread's kForceRecv receivers: each receiver
// adds the G terms s * d, s = ((G m_i) m_j)((inv inv) inv), in partner
// order.
template <int G, bool kAnyD, typename T>
__device__ __forceinline__ void force_step(const Partner<T>* p,
                                           const T (&xi)[kForceRecv],
                                           const T (&yi)[kForceRecv],
                                           const T (&gmi)[kForceRecv],
                                           T (&ax)[kForceRecv],
                                           T (&ay)[kForceRecv], T side, T t) {
  T dx[G][kForceRecv], dy[G][kForceRecv], inv[G][kForceRecv], mj[G];
  bool ok = true;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const Partner<T> q = p[u];
    mj[u] = q.m;
#pragma unroll
    for (int r = 0; r < kForceRecv; ++r) {
      dx[u][r] = image<kAnyD>(sub_rn(q.x, xi[r]), side, t);
      dy[u][r] = image<kAnyD>(sub_rn(q.y, yi[r]), side, t);
      inv[u][r] = inv_fast(
          add_rn(mul_rn(dx[u][r], dx[u][r]), mul_rn(dy[u][r], dy[u][r])), ok);
    }
  }
  if (__builtin_expect(!ok, 0)) {
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int r = 0; r < kForceRecv; ++r)
        inv[u][r] = inv_exact(add_rn(mul_rn(dx[u][r], dx[u][r]),
                                     mul_rn(dy[u][r], dy[u][r])));
  }
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int r = 0; r < kForceRecv; ++r) {
      const T s = (gmi[r] * mj[u]) * ((inv[u][r] * inv[u][r]) * inv[u][r]);
      ax[r] += s * dx[u][r];
      ay[r] += s * dy[u][r];
    }
}

template <bool kAnyD, typename T>
__device__ __forceinline__ void force_scan(const Partner<T>* tile, int lo,
                                           int hi, const T (&xi)[kForceRecv],
                                           const T (&yi)[kForceRecv],
                                           const T (&gmi)[kForceRecv],
                                           T (&ax)[kForceRecv],
                                           T (&ay)[kForceRecv], T side, T t) {
  int k = lo;
  for (; k + kForceGroup <= hi; k += kForceGroup)
    force_step<kForceGroup, kAnyD>(tile + k, xi, yi, gmi, ax, ay, side, t);
  for (; k < hi; ++k)
    force_step<1, kAnyD>(tile + k, xi, yi, gmi, ax, ay, side, t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    direct_forces_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ m, T* __restrict__ fx,
                         T* __restrict__ fy, int n, T side, T g, T t) {
  constexpr int kLanes = kThreads / kForceSplit;  // threads a part
  constexpr int kSlice = kTile / kForceSplit;     // partners a part a tile
  static_assert(kLanes % 32 == 0, "a part must be whole warps (broadcast)");
  static_assert(kSlice % kForceGroup == 0, "slices of whole steps");
  static_assert(2 * kThreads * kForceRecv * sizeof(T) <=
                    kTile * sizeof(Partner<T>),
                "the parts' sums reuse the tile");
  __shared__ Partner<T> tile[kTile];
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  // Receiver r of the thread is i0 + r kLanes.
  const int i0 = blockIdx.x * kLanes * kForceRecv + lane;
  T xi[kForceRecv], yi[kForceRecv], gmi[kForceRecv];
  T ax[kForceRecv], ay[kForceRecv];
  bool recv_in_box = true;
#pragma unroll
  for (int r = 0; r < kForceRecv; ++r) {
    const int i = i0 + r * kLanes;
    const bool live = i < n;
    xi[r] = live ? load_pos(x, i) : T(0);
    yi[r] = live ? load_pos(y, i) : T(0);
    gmi[r] = live ? g * m[i] : T(0);
    ax[r] = ay[r] = T(0);
    recv_in_box &= in_box(xi[r], yi[r], side);
  }
  for (int j0 = 0; j0 < n; j0 += kTile) {
    bool tile_in_box = true;
    for (int e = threadIdx.x; e < kTile && j0 + e < n; e += kThreads) {
      const Partner<T> q = {load_pos(x, j0 + e), load_pos(y, j0 + e),
                            m[j0 + e], T(0)};
      tile_in_box &= in_box(q.x, q.y, side);
      tile[e] = q;
    }
    const bool fast = __syncthreads_and(tile_in_box) && recv_in_box;
    const int lo = part * kSlice, hi = min(lo + kSlice, n - j0);
    if (fast)
      force_scan<false>(tile, lo, hi, xi, yi, gmi, ax, ay, side, t);
    else
      force_scan<true>(tile, lo, hi, xi, yi, gmi, ax, ay, side, t);
    __syncthreads();
  }
  // The parts' sums, added in part order by part 0.
  T* sums = reinterpret_cast<T*>(tile);
#pragma unroll
  for (int r = 0; r < kForceRecv; ++r) {
    sums[(r * 2) * kThreads + threadIdx.x] = ax[r];
    sums[(r * 2 + 1) * kThreads + threadIdx.x] = ay[r];
  }
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int r = 0; r < kForceRecv; ++r) {
    for (int p = 1; p < kForceSplit; ++p) {
      ax[r] += sums[(r * 2) * kThreads + p * kLanes + lane];
      ay[r] += sums[(r * 2 + 1) * kThreads + p * kLanes + lane];
    }
    const int i = i0 + r * kLanes;
    if (i < n) {
      fx[i] = ax[r];
      fy[i] = ay[r];
    }
  }
}

// The exact hit test of G partners k.. of the tile on the thread's
// receivers that have no partner yet, in ascending partner order.
template <int G, bool kAnyD, typename T>
__device__ __forceinline__ void collide_test(
    const T* sx, const T* sy, int k, int j0, int i0, int lanes,
    const T (&xi)[kCollideRecv], const T (&yi)[kCollideRecv],
    int (&found)[kCollideRecv], T side, T t, T eps2) {
#pragma unroll
  for (int r = 0; r < kCollideRecv; ++r)
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const T dx = image<kAnyD>(sub_rn(sx[k + u], xi[r]), side, t);
      const T dy = image<kAnyD>(sub_rn(sy[k + u], yi[r]), side, t);
      const int j = j0 + k + u;
      if (found[r] < 0 && add_rn(mul_rn(dx, dx), mul_rn(dy, dy)) < eps2 &&
          j != i0 + r * lanes)
        found[r] = j;
    }
}

// Four partners' x from shared memory: one 16-byte load in float32, two
// in float64.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    direct_collisions_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             const bool* __restrict__ alive,
                             int* __restrict__ first, int n, T side, T eps2,
                             T t, T wc, T wh) {
  constexpr int kLanes = kThreads / kCollideSplit;
  constexpr int kSlice = kTile / kCollideSplit;
  static_assert(kLanes % 32 == 0, "a part must be whole warps (broadcast)");
  static_assert(kCollideGroup == 4 && kSlice % kCollideGroup == 0,
                "slices of whole 4-partner loads");
  __shared__ __align__(16) T sx[kTile];
  __shared__ T sy[kTile];
  __shared__ int sfound[kCollideRecv * kThreads];
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  const int i0 = blockIdx.x * kLanes * kCollideRecv + lane;
  T xi[kCollideRecv], yi[kCollideRecv];
  int found[kCollideRecv];
  bool live[kCollideRecv], recv_in_box = true;
#pragma unroll
  for (int r = 0; r < kCollideRecv; ++r) {
    const int i = i0 + r * kLanes;
    live[r] = i < n && alive[i];
    // A dead receiver's NaN passes no test.
    xi[r] = live[r] ? load_pos(x, i) : nan_of(T(0));
    yi[r] = live[r] ? load_pos(y, i) : nan_of(T(0));
    found[r] = -1;
    if (live[r]) recv_in_box &= in_box(xi[r], yi[r], side);
  }
  for (int j0 = 0; j0 < n; j0 += kTile) {
    bool tile_in_box = true;
    for (int e = threadIdx.x; e < kTile && j0 + e < n; e += kThreads) {
      const T xj = load_pos(x, j0 + e), yj = load_pos(y, j0 + e);
      const bool a = alive[j0 + e];
      if (a) tile_in_box &= in_box(xj, yj, side);
      sx[e] = a ? xj : nan_of(T(0));
      sy[e] = yj;
    }
    const bool fast = __syncthreads_and(tile_in_box) && recv_in_box;
    bool pending = false;
#pragma unroll
    for (int r = 0; r < kCollideRecv; ++r) pending |= live[r] && found[r] < 0;
    const int lo = part * kSlice, hi = min(lo + kSlice, n - j0);
    int k = lo;
    if (pending && fast) {
      for (; k + kCollideGroup <= hi; k += kCollideGroup) {
        // One predicate for the group (a chain of compares: a tree of
        // maxima measured slower, PERF.md).
        T xs[kCollideGroup];
        load4(sx + k, xs);
        bool cand = false;
#pragma unroll
        for (int u = 0; u < kCollideGroup; ++u)
#pragma unroll
          for (int r = 0; r < kCollideRecv; ++r)
            cand |= fabs(sub_rn(fabs(sub_rn(xs[u], xi[r])), wc)) > wh;
        if (__builtin_expect(cand, 0))
          collide_test<kCollideGroup, false>(sx, sy, k, j0, i0, kLanes, xi,
                                             yi, found, side, t, eps2);
      }
      for (; k < hi; ++k)
        collide_test<1, false>(sx, sy, k, j0, i0, kLanes, xi, yi, found,
                               side, t, eps2);
    } else if (pending) {
      for (; k < hi; ++k)
        collide_test<1, true>(sx, sy, k, j0, i0, kLanes, xi, yi, found, side,
                              t, eps2);
    }
    __syncthreads();
  }
  // The smallest of the parts' first hits.
#pragma unroll
  for (int r = 0; r < kCollideRecv; ++r)
    sfound[r * kThreads + threadIdx.x] = found[r];
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int r = 0; r < kCollideRecv; ++r) {
    for (int p = 1; p < kCollideSplit; ++p) {
      const int f = sfound[r * kThreads + p * kLanes + lane];
      if (f >= 0 && (found[r] < 0 || f < found[r])) found[r] = f;
    }
    const int i = i0 + r * kLanes;
    if (i < n) first[i] = found[r];
  }
}

template <typename T>
void launch_forces(const void* x, const void* y, const void* m, void* fx,
                   void* fy, int n, double side, double g, double t,
                   cudaStream_t s) {
  constexpr int per_block = kThreads / kForceSplit * kForceRecv;
  direct_forces_kernel<T><<<(n + per_block - 1) / per_block, kThreads, 0,
                            s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(m), static_cast<T*>(fx), static_cast<T*>(fy), n,
      (T)side, (T)g, (T)t);
}

template <typename T>
void launch_collisions(const void* x, const void* y, const bool* alive,
                       int* first, int n, double side, double eps2, double t,
                       double wc, double wh, cudaStream_t s) {
  constexpr int per_block = kThreads / kCollideSplit * kCollideRecv;
  direct_collisions_kernel<T><<<(n + per_block - 1) / per_block, kThreads, 0,
                                s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), alive, first, n,
      (T)side, (T)eps2, (T)t, (T)wc, (T)wh);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for n < 1).
// f64 selects double arrays, else float; side, g, eps2 and the host's
// values below are cast to the arrays' type, in which each is exact:
// t = min_image_threshold(side, dtype), (wc, wh) = collision_window(side,
// dtype), eps2 = eps2_of(dtype) (ops/cuda/direct_nbody.py).
extern "C" int psim_direct_forces(const void* x, const void* y, const void* m,
                                  void* fx, void* fy, int n, double side,
                                  double g, double t, int f64, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    launch_forces<double>(x, y, m, fx, fy, n, side, g, t, s);
  else
    launch_forces<float>(x, y, m, fx, fy, n, side, g, t, s);
  return (int)cudaGetLastError();
}

// alive: one byte a slot (torch.bool); first: int32, the partner or -1.
extern "C" int psim_direct_collisions(const void* x, const void* y,
                                      const bool* alive, int* first, int n,
                                      double side, double eps2, double t,
                                      double wc, double wh, int f64,
                                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    launch_collisions<double>(x, y, alive, first, n, side, eps2, t, wc, wh,
                              s);
  else
    launch_collisions<float>(x, y, alive, first, n, side, eps2, t, wc, wh,
                             s);
  return (int)cudaGetLastError();
}
