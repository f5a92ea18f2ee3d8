// The sweep engine's three passes over sorted particle lanes, for Hopper
// (sm_90a): per-cell centre of mass, the forces (same-cell pairs, then the
// 8 stencil monopole terms) and the collision pass.
//
// The sweep engine keeps its particles in flat arrays sorted so that each
// cell's lanes are contiguous (by cell key and particle id on one device;
// on the mesh, each shard's slab sorted by its local cell, the shards'
// out-of-range lanes between them). Each lane carries its cell key and its
// position in the cell (pos): the cell starts at lane - pos, and its length
// is counts[key], the per-key count that binning.occupancy builds on the
// device (an index_add_ of ones). A key at or above ncells is a sentinel:
// an out-of-range particle or an empty mesh slot, in no cell.
//
// They replace XLA programs of the JAX package (no Pallas kernel there):
//   sweep_com_kernel<T, kParity>: ops/com.py com_parity (a lax.scan over
//     the lanes, :33) and com_fast (segment sums, :71);
//   sweep_forces_kernel<T, kParity>: ops/forces.py
//     pairwise_forces_parity_blocked (:127) or pairwise_forces_fast (:243),
//     fori_loops over neighbour offsets, followed by monopole_forces (:289);
//   sweep_collisions_kernel<T> + sweep_collision_count_kernel: ops/
//     collisions.py detect_collisions_blocked (:110), fori_loops of the
//     pair ranks' minimum and the mutual-first count.
// The port ran them as eager torch, one launch per operation per offset
// (~9600 launches a step at the parity flagship).
//
// Design: one thread a lane, partners read through L1. In the parity
// passes every thread of a warp walks its cell's lanes in the same order,
// so a warp inside one cell reads each partner once, as a broadcast; the
// f32 force pass walks outward from its lane (i + o, then i - o), so a
// warp's partner reads are consecutive. The COM pass is one thread a cell
// (the lane with pos 0), since the parity mean is a sequential recurrence.
// The collision pass stops at a lane's first hit. Staging a cell in shared
// memory, and splitting MEDIUM's 2500-lane cells over several threads a
// lane, are later work.
//
// What bounds them on an H100: the forces are bound by operations: ~17
// f64 operations an unordered same-cell pair of alive lanes in parity (the
// IEEE division and square root counted as one each; on the card each is a
// sequence of ~10 DFMA), ~14 f32 and one rsqrt in fast precision; this
// kernel computes each pair's term twice, once from each end, since a
// lane sums its own terms in its own order. The collision pass: ~6
// operations a pair tested, the square root only near EPSILON. The COM
// pass is bound by bytes (each lane's x, y, m once, 3 values a cell out).
//
// Bits. Each kernel reproduces its plain version's per-lane order
// (particlesimulation_tpu_torch/ops/com.py, forces.py, collisions.py), so
// the card's results equal the plain versions' bit for bit:
//   * parity COM: per cell, the reference's running weighted mean in
//     position order, quirks included (a zero-mass cell adopts the next
//     lane's position; a massless lane added to a massive cell still
//     computes (mx*m + 0*x)/(m + 0));
//   * fast COM: sum m, sum m*x, sum m*y in position order, then the
//     quotients. The plain version sums (ncells, kmax) rows with
//     torch.sum, in another order: equal within (c * 2^-24) * sum|terms|
//     for a cell of c lanes, and the same bits in every run (no atomics);
//   * parity forces, lane i of a cell of lanes s .. e-1: the reaction terms
//     fx -= t(j, i) for j = s .. i-1 ascending, its own terms fx += t(i, j)
//     for j = i+1 .. e-1 ascending, then the 8 stencil terms in stencil
//     order; t(lo, hi) = ((G*m_lo)*m_hi)/d2 * (dx/dist), dx = x_hi - x_lo;
//   * fast forces: for o = 1, 2, ...: fx += t(i, i+o), then fx -= t(i-o, i),
//     t = (G*m_lo*m_hi) * ((inv*inv)*inv) * dx with inv = rsqrtf(d2), the
//     association of the plain version; rsqrtf is the instruction
//     torch.rsqrt runs on a float CUDA tensor;
//   * collisions: a lane's first colliding pair, lexicographically by
//     (pos_lo, pos_hi), is its lowest partner that hits when the partners
//     are walked in ascending order; a pair counts when it is first for
//     both ends. The count and the dead set are exact.
// The library is built with -fmad=false: dx*dx + dy*dy and every other
// product and sum rounds on its own, as eager torch's do. Division and
// square root are the IEEE ones (no fast math).
//
// Hazards, and what the kernels do about them:
//   * Masked terms. The plain sweeps add a literal +-0.0 for a masked pair
//     (a dead partner, another cell, dist 0). x - 0.0 is exact for every
//     x, and x + 0.0 differs from x only for x = -0.0. A lane's sum starts
//     at x*0, which is +0.0 for x >= 0, and from +0.0 RN addition never
//     reaches -0.0 (ops/forces.py:34-40). The parity kernel still adds the
//     literal +0.0 where the plain version adds it within the cell (a
//     masked own term, and a dead lane's first own offset), so that a lane
//     at x < 0 or x = -0.0 (cell_of puts x in (-w, 0) in column 0) matches
//     too; what it cannot see is the plain sweep's masked visits beyond the
//     cell, which depend on the lane order of binning.occupancy: there a
//     zero force of a lane at x < 0 may differ in the sign of the zero.
//     The fast kernel skips every masked term, with the same caveat.
//   * Sentinel lanes (key >= ncells) get no pair term, even when two of them
//     are alive: the plain sweeps never reach them (they lie outside every
//     prefix of the occupancy's lane order). Their monopole terms are
//     masked (+0.0 added eight times, as in the plain version).
//   * Dead lanes get no term; their sums are x*0 plus the literal zeros.
//   * Coincident lanes (dist 0; d2 0 in fast precision) get no pair term.
//   * Distances: no FMA in dx*dx + dy*dy, in either precision (-fmad=false).
//   * A collision test skips the square root where d2 >= 4*eps*eps: there
//     RN(sqrt(d2)) >= RN(sqrt(4*eps*eps)) ~ 2*eps > eps (the square root is
//     monotonic), so the skip changes no outcome.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) { return rsqrt(v); }

// The lane's cell: its first lane and one past its last; false for a
// sentinel lane.
__device__ __forceinline__ bool cell_of_lane(int i, const int* key,
                                             const int64_t* pos,
                                             const int64_t* counts,
                                             int ncells, int* s, int* e) {
  const int k = key[i];
  if ((unsigned)k >= (unsigned)ncells) return false;
  *s = i - (int)pos[i];
  *e = *s + (int)counts[k];
  return true;
}

// Per cell: M, MX, MY (ops/com.py com_parity or com_fast). One thread a
// cell: the lane at pos 0 walks its cell. Thread t also writes the zeros of
// cell t where that cell holds no lane (the launch covers max(n, ncells)).
template <typename T, bool kParity>
__global__ void sweep_com_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ m,
                                 const int* __restrict__ key,
                                 const int64_t* __restrict__ pos,
                                 const int64_t* __restrict__ counts, int n,
                                 int ncells, T* M, T* MX, T* MY) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ncells && counts[i] == 0) {
    M[i] = T(0);
    MX[i] = T(0);
    MY[i] = T(0);
  }
  if (i >= n || pos[i] != 0) return;
  int s, e;
  if (!cell_of_lane(i, key, pos, counts, ncells, &s, &e)) return;
  T m0 = T(0), a = T(0), b = T(0);
  for (int j = s; j < e; ++j) {
    const T xj = x[j], yj = y[j], mj = m[j];
    if (kParity) {
      // The running weighted mean; an empty (zero-mass) cell adopts xj.
      if (m0 == T(0)) {
        a = xj;
        b = yj;
      } else {
        const T d = m0 + mj;
        a = (a * m0 + mj * xj) / d;
        b = (b * m0 + mj * yj) / d;
      }
      m0 = m0 + mj;
    } else {
      m0 = m0 + mj;
      a = a + mj * xj;
      b = b + mj * yj;
    }
  }
  const int k = key[i];
  M[k] = m0;
  if (kParity) {
    MX[k] = a;
    MY[k] = b;
  } else {
    MX[k] = m0 > T(0) ? a / m0 : T(0);
    MY[k] = m0 > T(0) ? b / m0 : T(0);
  }
}

// Same-cell pair forces then the 8 stencil monopole terms, each lane its
// own sum (ops/forces.py pairwise_forces_parity_blocked or
// pairwise_forces_fast, then monopole_forces). ml, mxl, myl: (8, ncells +
// 1) rows, the last column a zero sentinel.
template <typename T, bool kParity>
__global__ void sweep_forces_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const T* __restrict__ m, const bool* __restrict__ alive,
    const int* __restrict__ key, const int64_t* __restrict__ pos,
    const int64_t* __restrict__ counts, int n, int ncells,
    const T* __restrict__ ml, const T* __restrict__ mxl,
    const T* __restrict__ myl, T g, T* fx, T* fy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T xi = x[i], yi = y[i], mi = m[i];
  const bool ai = alive[i];
  // The plain version's accumulators start at x * 0, both of them.
  T ax = xi * T(0), ay = xi * T(0);
  int s, e;
  const bool real = cell_of_lane(i, key, pos, counts, ncells, &s, &e);
  if (real && !ai) {
    // A dead lane: the parity upper sweep's first offset adds a literal 0.
    if (kParity && i < e - 1) {
      ax = ax + T(0);
      ay = ay + T(0);
    }
  } else if (real && kParity) {
    for (int j = s; j < e; ++j) {
      if (j == i) continue;
      const bool below = j < i;
      if (!alive[j]) {
        if (!below) {
          ax = ax + T(0);
          ay = ay + T(0);
        }
        continue;
      }
      const T xj = x[j], yj = y[j], mj = m[j];
      // The term from the lower lane's side: t(lo, hi).
      const T xl = below ? xj : xi, yl = below ? yj : yi,
              mlo = below ? mj : mi;
      const T xh = below ? xi : xj, yh = below ? yi : yj,
              mhi = below ? mi : mj;
      const T dx = xh - xl, dy = yh - yl;
      const T d2 = dx * dx + dy * dy;
      const T dist = sqrt(d2);
      if (dist == T(0)) {
        if (!below) {
          ax = ax + T(0);
          ay = ay + T(0);
        }
        continue;
      }
      const T fm = ((g * mlo) * mhi) / d2;
      const T tx = fm * (dx / dist), ty = fm * (dy / dist);
      if (below) {
        ax = ax - tx;
        ay = ay - ty;
      } else {
        ax = ax + tx;
        ay = ay + ty;
      }
    }
  } else if (real) {
    const T gmi = g * mi;
    const int up = e - 1 - i, down = i - s;
    const int omax = up > down ? up : down;
    for (int o = 1; o <= omax; ++o) {
      if (o <= up && alive[i + o]) {
        const int j = i + o;
        const T dx = x[j] - xi, dy = y[j] - yi;
        const T d2 = dx * dx + dy * dy;
        if (d2 > T(0)) {
          const T inv = rsqrt_of(d2);
          const T sc = (gmi * m[j]) * ((inv * inv) * inv);
          ax = ax + sc * dx;
          ay = ay + sc * dy;
        }
      }
      if (o <= down && alive[i - o]) {
        const int j = i - o;
        const T dx = xi - x[j], dy = yi - y[j];
        const T d2 = dx * dx + dy * dy;
        if (d2 > T(0)) {
          const T inv = rsqrt_of(d2);
          const T sc = ((g * m[j]) * mi) * ((inv * inv) * inv);
          ax = ax - sc * dx;
          ay = ay - sc * dy;
        }
      }
    }
  }
  // The 8 stencil terms, in stencil order, each as the plain version
  // computes it (its guards on d2 and dist included); masked: + 0.
  const int ld = ncells + 1;
  const int kc = real ? key[i] : ncells;
  for (int l = 0; l < 8; ++l) {
    const T cm = ml[l * ld + kc], cmx = mxl[l * ld + kc],
            cmy = myl[l * ld + kc];
    const T dx = cmx - xi, dy = cmy - yi;
    const T d2 = dx * dx + dy * dy;
    const T dist = sqrt(d2);
    if (!(ai && real && dist != T(0))) {
      ax = ax + T(0);
      ay = ay + T(0);
      continue;
    }
    const T fm = ((g * mi) * cm) / (d2 > T(0) ? d2 : T(1));
    const T safe = dist > T(0) ? dist : T(1);
    ax = ax + fm * (dx / safe);
    ay = ay + fm * (dy / safe);
  }
  fx[i] = ax;
  fy[i] = ay;
}

// Each lane's first colliding pair (ops/collisions.py
// detect_collisions_blocked): first[i] is the position in the cell of the
// partner of lane i's lexicographically first pair within eps, -1 if none;
// died[i] whether it has one.
template <typename T>
__global__ void sweep_collisions_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const bool* __restrict__ alive, const int* __restrict__ key,
    const int64_t* __restrict__ pos, const int64_t* __restrict__ counts,
    int n, int ncells, T eps, int* first, bool* died,
    unsigned long long* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *count = 0;  // the count pass runs after this one
  if (i >= n) return;
  int f = -1;
  int s, e;
  if (alive[i] && cell_of_lane(i, key, pos, counts, ncells, &s, &e)) {
    const T far2 = T(4) * eps * eps;
    const T xi = x[i], yi = y[i];
    // Ascending partners: a hit below i, (j, i), ranks before every (i, k).
    for (int j = s; j < e; ++j) {
      if (j == i || !alive[j]) continue;
      const T dx = j < i ? x[j] - xi : xi - x[j];
      const T dy = j < i ? y[j] - yi : yi - y[j];
      const T d2 = dx * dx + dy * dy;
      if (d2 < far2 && sqrt(d2) < eps) {
        f = j - s;
        break;
      }
    }
  }
  first[i] = f;
  died[i] = f >= 0;
}

// The pairs that are first for both ends, counted at their lower end.
__global__ void sweep_collision_count_kernel(const int* __restrict__ first,
                                             const int64_t* __restrict__ pos,
                                             int n,
                                             unsigned long long* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < n) {
    const int f = first[i], p = (int)pos[i];
    hit = f > p && first[i - p + f] == p;
  }
  const int c = __syncthreads_count(hit);
  if (threadIdx.x == 0 && c > 0) atomicAdd(count, (unsigned long long)c);
}

template <typename T, bool kParity>
int com(const T* x, const T* y, const T* m, const int* key,
        const int64_t* pos, const int64_t* counts, int n, int ncells, T* M,
        T* MX, T* MY, void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  sweep_com_kernel<T, kParity>
      <<<blocks_for(n > ncells ? n : ncells), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          x, y, m, key, pos, counts, n, ncells, M, MX, MY);
  return (int)cudaGetLastError();
}

template <typename T, bool kParity>
int forces(const T* x, const T* y, const T* m, const bool* alive,
           const int* key, const int64_t* pos, const int64_t* counts, int n,
           int ncells, const T* ml, const T* mxl, const T* myl, double g,
           T* fx, T* fy, void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  sweep_forces_kernel<T, kParity>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, y, m, alive, key, pos, counts, n, ncells, ml, mxl, myl, (T)g,
          fx, fy);
  return (int)cudaGetLastError();
}

template <typename T>
int collisions(const T* x, const T* y, const bool* alive, const int* key,
               const int64_t* pos, const int64_t* counts, int n, int ncells,
               double eps, int* first, bool* died, long long* count,
               void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* total = reinterpret_cast<unsigned long long*>(count);
  sweep_collisions_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
      x, y, alive, key, pos, counts, n, ncells, (T)eps, first, died, total);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sweep_collision_count_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      first, pos, n, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y, m: n values each; key (int32), pos (int64): n each; counts
// (int64): ncells + 1 (the sentinel's last). Outputs M, MX, MY: ncells
// each (empty cells 0). _f64 is the parity COM, _f32 the fast one.
extern "C" int psim_sweep_com_f64(const double* x, const double* y,
                                  const double* m, const int* key,
                                  const int64_t* pos, const int64_t* counts,
                                  int n, int ncells, double* M, double* MX,
                                  double* MY, void* stream) {
  return com<double, true>(x, y, m, key, pos, counts, n, ncells, M, MX, MY,
                           stream);
}

extern "C" int psim_sweep_com_f32(const float* x, const float* y,
                                  const float* m, const int* key,
                                  const int64_t* pos, const int64_t* counts,
                                  int n, int ncells, float* M, float* MX,
                                  float* MY, void* stream) {
  return com<float, false>(x, y, m, key, pos, counts, n, ncells, M, MX, MY,
                           stream);
}

// alive: n bytes (0/1); ml, mxl, myl: (8, ncells + 1) each; g = G, cast to
// the type. Outputs fx, fy: n each. _f64 parity, _f32 fast.
extern "C" int psim_sweep_forces_f64(const double* x, const double* y,
                                     const double* m, const bool* alive,
                                     const int* key, const int64_t* pos,
                                     const int64_t* counts, int n, int ncells,
                                     const double* ml, const double* mxl,
                                     const double* myl, double g, double* fx,
                                     double* fy, void* stream) {
  return forces<double, true>(x, y, m, alive, key, pos, counts, n, ncells,
                              ml, mxl, myl, g, fx, fy, stream);
}

extern "C" int psim_sweep_forces_f32(const float* x, const float* y,
                                     const float* m, const bool* alive,
                                     const int* key, const int64_t* pos,
                                     const int64_t* counts, int n, int ncells,
                                     const float* ml, const float* mxl,
                                     const float* myl, double g, float* fx,
                                     float* fy, void* stream) {
  return forces<float, false>(x, y, m, alive, key, pos, counts, n, ncells,
                              ml, mxl, myl, g, fx, fy, stream);
}

// eps = EPSILON, cast to the type. Outputs: first (n ints, scratch),
// died (n bytes); count (one int64): the pairs first for both ends. Two
// launches: the first pairs (which zero the count), then the count.
extern "C" int psim_sweep_collisions_f64(const double* x, const double* y,
                                         const bool* alive, const int* key,
                                         const int64_t* pos,
                                         const int64_t* counts, int n,
                                         int ncells, double eps, int* first,
                                         bool* died, long long* count,
                                         void* stream) {
  return collisions<double>(x, y, alive, key, pos, counts, n, ncells, eps,
                            first, died, count, stream);
}

extern "C" int psim_sweep_collisions_f32(const float* x, const float* y,
                                         const bool* alive, const int* key,
                                         const int64_t* pos,
                                         const int64_t* counts, int n,
                                         int ncells, double eps, int* first,
                                         bool* died, long long* count,
                                         void* stream) {
  return collisions<float>(x, y, alive, key, pos, counts, n, ncells, eps,
                           first, died, count, stream);
}
