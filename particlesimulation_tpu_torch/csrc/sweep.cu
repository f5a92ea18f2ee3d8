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
//   sweep_forces_parity_kernel (f64) and sweep_forces_fast_kernel (f32):
//     ops/forces.py pairwise_forces_parity_blocked (:127) or
//     pairwise_forces_fast (:243), fori_loops over neighbour offsets,
//     followed by monopole_forces (:289);
//   sweep_collisions_kernel<T> + sweep_collision_count_kernel: ops/
//     collisions.py detect_collisions_blocked (:110), fori_loops of the
//     pair ranks' minimum and the mutual-first count.
// The port ran them as eager torch, one launch per operation per offset
// (~9600 launches a step at the parity flagship).
//
// Design. The COM pass is one thread a cell (the lane with pos 0), since
// the parity mean is a sequential recurrence. The parity force pass
// computes each pair's term once in a large cell (more than kLarge lanes,
// MEDIUM's ~2500) where there are enough of them to fill the card: a warp
// a row tile of 32 lanes, a team of 16 warps a cell, the column lanes'
// sums handed on from one row tile to the next through fx/fy (the
// section's note below). Otherwise a lane computes its own terms: in a
// small cell (the flagship's ~100) a warp-sized tile leaves most of its
// term slots empty, and a few large cells' teams would mostly wait. The
// f32 force pass is one thread a lane walking outward from its lane (i +
// o, then i - o), so a warp's partner reads are consecutive; each term is
// computed at both ends, as a term computed once cost more shared-memory
// traffic than it saved (PERF.md section 6). The collision pass sorts each
// chunk of a cell (up to kChunk lanes) by x in shared memory; each alive
// lane walks outward from its own x while fl(dx²) < 4 eps² and tests only
// those partners.
//
// What bounds them on an H100: the forces are bound by operations: ~17
// f64 operations an unordered same-cell pair of alive lanes in parity (the
// IEEE division and square root counted as one each; on the card each is a
// sequence of ~10 DFMA), ~14 f32 and one rsqrt in fast precision. The
// collision pass: ~6 operations a pair near in x (the window's
// candidates), the square root only near EPSILON, and the lanes' bytes.
// The COM pass is bound by bytes (each lane's x, y, m once, 3 values a
// cell out).
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
//     (pos_lo, pos_hi), is its lowest partner that hits; a pair counts
//     when it is first for both ends. The count and the dead set are
//     exact. The x window finds every hit: d2 = fl(fl(dx²) + fl(dy²)) >=
//     fl(dx²), so a hit needs fl(dx²) < 4 eps²; fl(x_j - x_i) is monotone
//     in x_j and odd under round-to-nearest, so the partners that pass
//     form one run of the cell's lanes sorted by x, around the receiver's
//     own x. Ties in x do not matter to a minimum.
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // the collision pass's chunk of a cell
constexpr int kTile = 32;     // parity forces: a row tile, a column tile
constexpr int kGroup = 8;     // parity forces: row lanes a buffer round
constexpr int kWarps = 8;     // parity forces: warps a block
constexpr int kLarge = 512;   // parity forces: the most lanes a small cell

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

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

// The 8 stencil terms of a lane, in stencil order, each as the plain
// version computes it (its guards on d2 and dist included); masked (a dead
// or sentinel lane, or dist 0): + 0.
template <typename T>
__device__ __forceinline__ void add_stencil(T xi, T yi, T mi, bool live,
                                            int kc, int ld, const T* ml,
                                            const T* mxl, const T* myl, T g,
                                            T* ax, T* ay) {
  for (int l = 0; l < 8; ++l) {
    const T cm = ml[l * ld + kc], cmx = mxl[l * ld + kc],
            cmy = myl[l * ld + kc];
    const T dx = cmx - xi, dy = cmy - yi;
    const T d2 = dx * dx + dy * dy;
    const T dist = sqrt(d2);
    if (!(live && dist != T(0))) {
      *ax = *ax + T(0);
      *ay = *ay + T(0);
      continue;
    }
    const T fm = ((g * mi) * cm) / (d2 > T(0) ? d2 : T(1));
    const T safe = dist > T(0) ? dist : T(1);
    *ax = *ax + fm * (dx / safe);
    *ay = *ay + fm * (dy / safe);
  }
}

// ---- Parity forces (f64): in a large cell each pair's term once, a warp a
// row tile; in a small one each lane by itself.
//
// A warp takes the next kTile lanes from a work counter. A lane of a small
// cell (kLarge lanes or fewer) computes its own sum (parity_lane: every
// term from the lower lane's side, so each pair's term twice). A large
// cell's row tiles (kTile lanes from a position that is a multiple of
// kTile; column tiles likewise) go to a team of warps (the host's `team`,
// 16 where the large cells' teams fill the card, else 0: every cell a lane
// a thread), each taking every team-th: the warp that took a lane of row
// tile r < team runs row tiles r, r + team, ... of the cell. In a row
// tile, thread u holds row lane u's sum. The warp computes the triangle of
// pairs inside the row tile, then each column tile above it, ascending:
// thread v computes t(u, v) for the row lanes u in ascending order and
// subtracts each from column lane v's sum; the terms go through the warp's
// buffer, kGroup rows at a time, to their row lanes, which add them in
// ascending v. A column lane's sum lives
// in fx/fy between row tiles: row tile k - 1 of the cell hands column tile
// a on (its progress word) before row tile k reads and adds to it, so a
// team's rows are in flight together, each about a column tile behind the
// one before. Each lane receives its lower partners' terms (rows 0 .. k-1,
// then its own tile's lower lanes) in ascending order, then its upper
// partners' (its own tile's, then the column tiles') in ascending order:
// the plain order. A row tile waits only on the cell's previous one, held
// by a warp of its team; the counter hands a team's first row tiles out in
// lane order, so only the cell at the counter's front can have a team
// member not yet started. A team is no larger than the cell's row tiles
// (so than the warps launched) nor than the card holds at once, so every
// other cell's warps run to their end and free the warps that start it:
// every wait ends.

// t(lo, hi) = ((G*m_lo)*m_hi)/d2 * (d/dist), d = hi - lo; gml = G*m_lo, or
// negative for a dead lo. +0 where the pair is masked (a dead end, or dist
// 0), as the plain sweeps add it.
__device__ __forceinline__ void parity_term(double xl, double yl, double gml,
                                            double xh, double yh, double mh,
                                            bool ah, double* tx,
                                            double* ty) {
  *tx = 0.0;
  *ty = 0.0;
  if (!(gml >= 0.0 && ah)) return;
  const double dx = xh - xl, dy = yh - yl;
  const double d2 = dx * dx + dy * dy;
  const double dist = sqrt(d2);
  if (dist == 0.0) return;
  const double fm = (gml * mh) / d2;
  *tx = fm * (dx / dist);
  *ty = fm * (dy / dist);
}

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The warps that take a cell of `lanes` lanes' row tiles: 0 for a small
// cell or with no teams (team 0), else `team` or its row tiles if fewer.
__device__ __forceinline__ int team_of(int lanes, int team) {
  const int rows = (lanes + kTile - 1) / kTile;
  return lanes <= kLarge ? 0 : (rows < team ? rows : team);
}

// A warp's shared memory: its row tile's lanes (x, y, G*m or -1 for a
// dead lane) and the term buffer (kGroup rows of kTile + 1, the pad
// keeping a row walk off one bank).
struct RowShared {
  double rx[kTile], ry[kTile], rg[kTile];
  double bx[kGroup * (kTile + 1)], by[kGroup * (kTile + 1)];
};

// Wait until the cell's previous row tile (progress word `prev`) has handed
// on column tile `a`; then the sums it wrote are read from L2 (__ldcg).
__device__ __forceinline__ void wait_for(const volatile int* prev, int a) {
  if ((threadIdx.x & 31) == 0) {
    while (*prev <= a) __nanosleep(64);
  }
  __syncwarp();
  __threadfence();
}

// The terms of row tile rs (row lanes' data in `sh`) with column lanes
// (cx, cy, cm, ca) of this thread: thread v subtracts t(u, v) for the
// valid u (u < tk, and u < v in the diagonal) from (sx, sy), in ascending
// u; row lane u adds the t(u, v) of the valid v (v < ncol, and v > u in the
// diagonal) to (ax, ay), in ascending v. In the diagonal the column sum
// is the row sum (the caller passes the same variables).
template <bool kDiagonal>
__device__ __forceinline__ void row_tile_terms(RowShared& sh, int tk,
                                               int ncol, double cx,
                                               double cy, double cm, bool ca,
                                               double* sx, double* sy,
                                               double* ax, double* ay) {
  const int lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < tk; g0 += kGroup) {
    for (int q = 0; q < kGroup && g0 + q < tk; ++q) {
      const int u = g0 + q;
      double tx = 0.0, ty = 0.0;
      if (u < tk && lane < ncol && (!kDiagonal || u < lane)) {
        parity_term(sh.rx[u], sh.ry[u], sh.rg[u], cx, cy, cm, ca, &tx, &ty);
        *sx = *sx - tx;
        *sy = *sy - ty;
      }
      sh.bx[q * (kTile + 1) + lane] = tx;
      sh.by[q * (kTile + 1) + lane] = ty;
    }
    __syncwarp();
    if (lane >= g0 && lane < g0 + kGroup && lane < tk) {
      const int q = lane - g0;
      for (int v = kDiagonal ? lane + 1 : 0; v < ncol; ++v) {
        *ax = *ax + sh.bx[q * (kTile + 1) + v];
        *ay = *ay + sh.by[q * (kTile + 1) + v];
      }
    }
    __syncwarp();
  }
}

// Row tile starting at lane i0 (the whole warp), then its lanes' stencil
// terms; progress[i0] counts the column tiles it has handed on.
__device__ void parity_row(const double* x, const double* y, const double* m,
                           const bool* alive, const int* key,
                           const int64_t* pos, const int64_t* counts,
                           int ncells, const double* ml, const double* mxl,
                           const double* myl, double g, double* fx,
                           double* fy, volatile int* progress, RowShared& sh,
                           int i0) {
  const int lane = threadIdx.x & 31;
  const int kc = key[i0];
  const int s = i0 - (int)pos[i0], e = s + (int)counts[kc];
  const int k = (i0 - s) / kTile;
  const int tk = e - i0 < kTile ? e - i0 : kTile;
  const int lo = i0 + lane;
  const bool row = lane < tk;
  const double xi = row ? x[lo] : 0.0, yi = row ? y[lo] : 0.0,
               mi = row ? m[lo] : 0.0;
  const bool ai = row && alive[lo];
  sh.rx[lane] = xi;
  sh.ry[lane] = yi;
  sh.rg[lane] = ai ? g * mi : -1.0;
  // The row lanes' sums: x * 0 (both) in the first row tile, else what
  // the tiles below handed on.
  if (k > 0) wait_for(progress + i0 - kTile, k);
  double ax = xi * 0.0, ay = xi * 0.0;
  if (k > 0 && row) {
    ax = __ldcg(fx + lo);
    ay = __ldcg(fy + lo);
  }
  __syncwarp();
  row_tile_terms<true>(sh, tk, tk, xi, yi, mi, ai, &ax, &ay, &ax, &ay);
  for (int a = k + 1, h0 = i0 + kTile; h0 < e; ++a, h0 += kTile) {
    const int ncol = e - h0 < kTile ? e - h0 : kTile;
    const int hi = h0 + lane;
    const bool col = lane < ncol;
    if (k > 0) wait_for(progress + i0 - kTile, a);
    const double cx = col ? x[hi] : 0.0, cy = col ? y[hi] : 0.0,
                 cm = col ? m[hi] : 0.0;
    const bool ca = col && alive[hi];
    double sx = cx * 0.0, sy = cx * 0.0;
    if (k > 0 && col) {
      sx = __ldcg(fx + hi);
      sy = __ldcg(fy + hi);
    }
    row_tile_terms<false>(sh, tk, ncol, cx, cy, cm, ca, &sx, &sy, &ax, &ay);
    if (col) {
      fx[hi] = sx;
      fy[hi] = sy;
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) progress[i0] = a + 1;
  }
  if (row) {
    add_stencil<double>(xi, yi, mi, ai, kc, ncells + 1, ml, mxl, myl, g, &ax,
                        &ay);
    fx[lo] = ax;
    fy[lo] = ay;
  }
  __syncwarp();
}

// Lane i of a small cell [s, e) (key k), by itself: each partner's term
// from the lower lane's side, in ascending order (the reaction terms
// -t(j, i), j < i, then its own +t(i, j), j > i), adding the literal +0
// where the plain upper sweep adds it; then the stencil terms.
__device__ void parity_lane(const double* x, const double* y, const double* m,
                            const bool* alive, int k, int ncells,
                            const double* ml, const double* mxl,
                            const double* myl, double g, double* fx,
                            double* fy, int i, int s, int e) {
  const double xi = x[i], yi = y[i], mi = m[i];
  const bool ai = alive[i];
  double ax = xi * 0.0, ay = xi * 0.0;
  if (!ai) {
    // A dead lane: the plain upper sweep's first offset adds a literal 0.
    if (i < e - 1) {
      ax = ax + 0.0;
      ay = ay + 0.0;
    }
  } else {
    for (int j = s; j < e; ++j) {
      if (j == i) continue;
      const bool below = j < i;
      if (!alive[j]) {
        if (!below) {
          ax = ax + 0.0;
          ay = ay + 0.0;
        }
        continue;
      }
      const double xj = x[j], yj = y[j], mj = m[j];
      // The term from the lower lane's side: t(lo, hi).
      const double xl = below ? xj : xi, yl = below ? yj : yi,
                   mlo = below ? mj : mi;
      const double xh = below ? xi : xj, yh = below ? yi : yj,
                   mhi = below ? mi : mj;
      const double dx = xh - xl, dy = yh - yl;
      const double d2 = dx * dx + dy * dy;
      const double dist = sqrt(d2);
      if (dist == 0.0) {
        if (!below) {
          ax = ax + 0.0;
          ay = ay + 0.0;
        }
        continue;
      }
      const double fm = ((g * mlo) * mhi) / d2;
      const double tx = fm * (dx / dist), ty = fm * (dy / dist);
      if (below) {
        ax = ax - tx;
        ay = ay - ty;
      } else {
        ax = ax + tx;
        ay = ay + ty;
      }
    }
  }
  add_stencil<double>(xi, yi, mi, ai, k, ncells + 1, ml, mxl, myl, g, &ax,
                      &ay);
  fx[i] = ax;
  fy[i] = ay;
}

// Same-cell pair forces then the 8 stencil monopole terms, each lane its
// own sum (ops/forces.py pairwise_forces_parity_blocked, then
// monopole_forces). ml, mxl, myl: (8, ncells + 1) rows, the last column a
// zero sentinel. sync: n + 1 zeros (each row tile's progress by its first
// lane; the work counter).
__global__ void __launch_bounds__(kWarps * 32, 4) sweep_forces_parity_kernel(
    const double* __restrict__ x, const double* __restrict__ y,
    const double* __restrict__ m, const bool* __restrict__ alive,
    const int* __restrict__ key, const int64_t* __restrict__ pos,
    const int64_t* __restrict__ counts, int n, int ncells,
    const double* __restrict__ ml, const double* __restrict__ mxl,
    const double* __restrict__ myl, double g, double* fx, double* fy,
    int team, int* sync) {
  __shared__ RowShared shared[kWarps];
  RowShared& sh = shared[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int items = (n + kTile - 1) / kTile;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(sync + n, 1);
    t = __shfl_sync(kFullMask, t, 0);
    if (t >= items) break;
    const int i = t * kTile + lane;
    bool start = false;
    if (i < n) {
      const int k = key[i];
      if ((unsigned)k >= (unsigned)ncells) {
        // A sentinel lane: x * 0, then the 8 masked stencil terms.
        const double xi = x[i];
        double ax = xi * 0.0, ay = xi * 0.0;
        add_stencil<double>(xi, y[i], m[i], false, ncells, ncells + 1, ml,
                            mxl, myl, g, &ax, &ay);
        fx[i] = ax;
        fy[i] = ay;
      } else {
        const int p = (int)pos[i], c = (int)counts[k];
        if (team_of(c, team) > 0) {
          start = p % kTile == 0 && p / kTile < team_of(c, team);
        } else {
          parity_lane(x, y, m, alive, k, ncells, ml, mxl, myl, g, fx, fy, i,
                      i - p, i - p + c);
        }
      }
    }
    for (unsigned starts = __ballot_sync(kFullMask, start); starts;
         starts &= starts - 1) {
      // This warp's row tiles of the cell: this one, then every team-th.
      const int i0 = t * kTile + __ffs(starts) - 1;
      const int c = (int)counts[key[i0]];
      const int e = i0 - (int)pos[i0] + c;
      for (int r = i0; r < e; r += team_of(c, team) * kTile) {
        parity_row(x, y, m, alive, key, pos, counts, ncells, ml, mxl, myl,
                   g, fx, fy, sync, sh, r);
      }
    }
  }
}

// ---- Fast forces (f32): a thread a lane, partners through L1.

// Same-cell pair forces then the 8 stencil monopole terms, each lane its
// own sum (ops/forces.py pairwise_forces_fast, then monopole_forces): for
// o = 1, 2, ...: +t(i, i+o), then -t(i-o, i), each term from its own end.
__global__ void __launch_bounds__(kThreads) sweep_forces_fast_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ m, const bool* __restrict__ alive,
    const int* __restrict__ key, const int64_t* __restrict__ pos,
    const int64_t* __restrict__ counts, int n, int ncells,
    const float* __restrict__ ml, const float* __restrict__ mxl,
    const float* __restrict__ myl, float g, float* fx, float* fy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i], yi = y[i], mi = m[i];
  const bool ai = alive[i];
  // The plain version's accumulators start at x * 0, both of them.
  float ax = xi * 0.0f, ay = xi * 0.0f;
  int s, e;
  const bool real = cell_of_lane(i, key, pos, counts, ncells, &s, &e);
  if (real && ai) {
    const float gmi = g * mi;
    const int up = e - 1 - i, down = i - s;
    const int omax = up > down ? up : down;
    // Branch-free partners (a masked term is computed and not added), so
    // that the unrolled loop's loads issue ahead of the arithmetic.
#pragma unroll 2
    for (int o = 1; o <= omax; ++o) {
      if (o <= up) {
        const int j = i + o;
        const float dx = x[j] - xi, dy = y[j] - yi;
        const float d2 = dx * dx + dy * dy;
        const float inv = rsqrtf(d2);
        const float sc = (gmi * m[j]) * ((inv * inv) * inv);
        const bool add = alive[j] && d2 > 0.0f;
        ax = add ? ax + sc * dx : ax;
        ay = add ? ay + sc * dy : ay;
      }
      if (o <= down) {
        const int j = i - o;
        const float dx = xi - x[j], dy = yi - y[j];
        const float d2 = dx * dx + dy * dy;
        const float inv = rsqrtf(d2);
        const float sc = ((g * m[j]) * mi) * ((inv * inv) * inv);
        const bool sub = alive[j] && d2 > 0.0f;
        ax = sub ? ax - sc * dx : ax;
        ay = sub ? ay - sc * dy : ay;
      }
    }
  }
  add_stencil<float>(xi, yi, mi, ai && real, real ? key[i] : ncells,
                     ncells + 1, ml, mxl, myl, g, &ax, &ay);
  fx[i] = ax;
  fy[i] = ay;
}

// ---- Collisions.

// A block a range of kThreads lanes. The block runs the chunks that start
// in its range: a chunk is up to `chunk` (the host's min(kmax, kChunk))
// consecutive lanes of one cell, starting at a lane whose position is a
// multiple of `chunk`, so every lane of a cell lies in exactly one chunk
// and a cell of kmax lanes or fewer is one chunk. The block also writes
// its range's sentinel lanes.

// The chunk starts of this block's range, into starts[0 .. *nstarts); the
// sentinel lanes of the range are handed to `sentinel(i)`.
template <typename Sentinel>
__device__ __forceinline__ void chunk_starts(const int* key,
                                             const int64_t* pos, int n,
                                             int ncells, int chunk,
                                             int* starts, int* nstarts,
                                             Sentinel sentinel) {
  if (threadIdx.x == 0) *nstarts = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int k = key[i];
    if ((unsigned)k >= (unsigned)ncells) {
      sentinel(i);
    } else if (pos[i] % chunk == 0) {
      starts[atomicAdd(nstarts, 1)] = i;
    }
  }
  __syncthreads();
}

// The cell [*s, *e) of the chunk that starts at lane c0, and the chunk's
// end *c1.
__device__ __forceinline__ void chunk_of(int c0, const int* key,
                                         const int64_t* pos,
                                         const int64_t* counts, int chunk,
                                         int* s, int* e, int* c1) {
  *s = c0 - (int)pos[c0];
  *e = *s + (int)counts[key[c0]];
  *c1 = c0 + chunk < *e ? c0 + chunk : *e;
}


// Sort keys: the float's bits made to order as unsigned integers as the
// values do (-0 just below +0); a NaN gets the largest key, kNone, which
// also marks a dead lane.
__device__ __forceinline__ uint32_t sort_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long sort_key(double v) {
  if (v != v) return ~0ull;
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

template <typename T>
struct SortKey;
template <>
struct SortKey<float> {
  using type = uint32_t;
  static constexpr uint32_t kNone = 0xFFFFFFFFu;
};
template <>
struct SortKey<double> {
  using type = unsigned long long;
  static constexpr unsigned long long kNone = ~0ull;
};

// keys[0 .. np) ascending (np a power of two), idx alongside.
template <typename K>
__device__ void bitonic_sort(K* keys, unsigned short* idx, int np) {
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < np; t += kThreads) {
        const int p = t ^ j;
        if (p > t) {
          const K a = keys[t], b = keys[p];
          if ((a > b) == ((t & k) == 0)) {
            keys[t] = b;
            keys[p] = a;
            const unsigned short it = idx[t];
            idx[t] = idx[p];
            idx[p] = it;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
size_t collision_shared_bytes(int chunk, int span) {
  return (size_t)span * (sizeof(typename SortKey<T>::type) + 2) +
         (size_t)chunk * sizeof(int);
}

// Each lane's first colliding pair (ops/collisions.py
// detect_collisions_blocked): first[i] is the position in the cell of the
// partner of lane i's lexicographically first pair within eps, -1 if none;
// died[i] whether it has one. For each chunk of receivers, each chunk of
// the cell (the whole cell where it is one chunk) is sorted by x in shared
// memory, and each alive receiver walks outward from its own x, up then
// down, while fl(dx²) < 4 eps², testing each alive partner as the plain
// version does and keeping the lowest position that hits. `span`: a power
// of two at least `chunk`.
template <typename T>
__global__ void __launch_bounds__(kThreads) sweep_collisions_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const bool* __restrict__ alive, const int* __restrict__ key,
    const int64_t* __restrict__ pos, const int64_t* __restrict__ counts,
    int n, int ncells, int chunk, int span, T eps, int* first, bool* died,
    unsigned long long* count) {
  using K = typename SortKey<T>::type;
  constexpr K kNone = SortKey<T>::kNone;
  extern __shared__ __align__(16) unsigned char shared[];
  K* keys = reinterpret_cast<K*>(shared);
  unsigned short* idx = reinterpret_cast<unsigned short*>(keys + span);
  int* best = reinterpret_cast<int*>(idx + span);
  __shared__ int starts[kThreads];
  __shared__ int nstarts;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;  // the count pass
                                                        // runs after this
  chunk_starts(key, pos, n, ncells, chunk, starts, &nstarts, [&](int i) {
    first[i] = -1;
    died[i] = false;
  });
  const T far2 = T(4) * eps * eps;
  for (int c = 0; c < nstarts; ++c) {
    const int c0 = starts[c];
    int cs, ce, c1;
    chunk_of(c0, key, pos, counts, chunk, &cs, &ce, &c1);
    const int rc = c1 - c0;
    for (int r = threadIdx.x; r < rc; r += kThreads) best[r] = INT_MAX;
    for (int d0 = cs; d0 < ce; d0 += chunk) {
      const int rd = ce - d0 < chunk ? ce - d0 : chunk;
      int np = 1;
      while (np < rd) np <<= 1;
      __syncthreads();
      for (int q = threadIdx.x; q < np; q += kThreads) {
        keys[q] = q < rd && alive[d0 + q] ? sort_key(x[d0 + q]) : kNone;
        idx[q] = (unsigned short)q;
      }
      __syncthreads();
      bitonic_sort(keys, idx, np);
      for (int r = threadIdx.x; r < rc; r += kThreads) {
        const int i = c0 + r;
        if (!alive[i]) continue;
        const T xi = x[i], yi = y[i];
        const K kx = sort_key(xi);
        if (kx == kNone) continue;
        int lo = 0, hi = np;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (keys[mid] < kx) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        int f = best[r];
        // Today's test on each candidate, with its dx, dy and d2.
        auto test = [&](int j) {
          const T dx = j < i ? x[j] - xi : xi - x[j];
          const T dy = j < i ? y[j] - yi : yi - y[j];
          const T d2 = dx * dx + dy * dy;
          if (d2 < far2 && sqrt(d2) < eps && j - cs < f) f = j - cs;
        };
        for (int q = lo; q < np && keys[q] != kNone; ++q) {
          const int j = d0 + idx[q];
          const T w = x[j] - xi;
          if (!(w * w < far2)) break;
          if (j != i) test(j);
        }
        for (int q = lo - 1; q >= 0; --q) {
          const int j = d0 + idx[q];
          const T w = x[j] - xi;
          if (!(w * w < far2)) break;
          if (j != i) test(j);
        }
        best[r] = f;
      }
    }
    for (int r = threadIdx.x; r < rc; r += kThreads) {
      const int f = best[r] == INT_MAX ? -1 : best[r];
      first[c0 + r] = f;
      died[c0 + r] = f >= 0;
    }
  }
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

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that is
// over the 48 KB a block may take without asking; once for each kernel and
// size larger than any before (`opted`: the kernel's own record).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted) {
  if (smem <= 48 * 1024 || smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) opted = smem;
  return err;
}

// The chunk length: the largest cell's lane count, up to kChunk.
inline int chunk_for(int kmax) {
  return kmax < 1 ? 1 : (kmax < kChunk ? kmax : kChunk);
}

int forces_parity(const double* x, const double* y, const double* m,
                  const bool* alive, const int* key, const int64_t* pos,
                  const int64_t* counts, int n, int ncells, const double* ml,
                  const double* mxl, const double* myl, double g, double* fx,
                  double* fy, int team, int* sync, void* stream) {
  if (n < 1 || ncells < 1 || team < 0) return (int)cudaErrorInvalidValue;
  const int items = (n + kTile - 1) / kTile;
  sweep_forces_parity_kernel<<<(items + kWarps - 1) / kWarps, kWarps * 32,
                               0, static_cast<cudaStream_t>(stream)>>>(
      x, y, m, alive, key, pos, counts, n, ncells, ml, mxl, myl, g, fx, fy,
      team, sync);
  return (int)cudaGetLastError();
}

int forces_fast(const float* x, const float* y, const float* m,
                const bool* alive, const int* key, const int64_t* pos,
                const int64_t* counts, int n, int ncells, const float* ml,
                const float* mxl, const float* myl, double g, float* fx,
                float* fy, void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  sweep_forces_fast_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, y, m, alive, key, pos, counts, n, ncells, ml, mxl, myl, (float)g,
      fx, fy);
  return (int)cudaGetLastError();
}

template <typename T>
int collisions(const T* x, const T* y, const bool* alive, const int* key,
               const int64_t* pos, const int64_t* counts, int n, int ncells,
               int kmax, double eps, int* first, bool* died, long long* count,
               void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* total = reinterpret_cast<unsigned long long*>(count);
  const int chunk = chunk_for(kmax);
  int span = 2;
  while (span < chunk) span <<= 1;
  const size_t smem = collision_shared_bytes<T>(chunk, span);
  auto kernel = sweep_collisions_kernel<T>;
  static size_t opted = 0;
  const cudaError_t oerr = opt_in(kernel, smem, opted);
  if (oerr != cudaSuccess) return (int)oerr;
  kernel<<<blocks_for(n), kThreads, smem, s>>>(x, y, alive, key, pos, counts,
                                               n, ncells, chunk, span, (T)eps,
                                               first, died, total);
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
// the type. Outputs fx, fy: n each. _f64 parity (team: the warps a large
// cell takes, 0 for none, at most what the card holds at once; sync: n + 1
// int32 zeros, the kernel's scratch), _f32 fast.
extern "C" int psim_sweep_forces_f64(const double* x, const double* y,
                                     const double* m, const bool* alive,
                                     const int* key, const int64_t* pos,
                                     const int64_t* counts, int n, int ncells,
                                     const double* ml, const double* mxl,
                                     const double* myl, double g, double* fx,
                                     double* fy, int team, int* sync,
                                     void* stream) {
  return forces_parity(x, y, m, alive, key, pos, counts, n, ncells, ml, mxl,
                       myl, g, fx, fy, team, sync, stream);
}

extern "C" int psim_sweep_forces_f32(const float* x, const float* y,
                                     const float* m, const bool* alive,
                                     const int* key, const int64_t* pos,
                                     const int64_t* counts, int n, int ncells,
                                     const float* ml, const float* mxl,
                                     const float* myl, double g, float* fx,
                                     float* fy, void* stream) {
  return forces_fast(x, y, m, alive, key, pos, counts, n, ncells, ml, mxl,
                     myl, g, fx, fy, stream);
}

// kmax: the most lanes in one cell (plan.kmax); eps = EPSILON, cast to the
// type. Outputs: first (n ints, scratch), died (n bytes); count (one
// int64): the pairs first for both ends. Two launches: the first pairs
// (which zero the count), then the count.
extern "C" int psim_sweep_collisions_f64(const double* x, const double* y,
                                         const bool* alive, const int* key,
                                         const int64_t* pos,
                                         const int64_t* counts, int n,
                                         int ncells, int kmax, double eps,
                                         int* first, bool* died,
                                         long long* count, void* stream) {
  return collisions<double>(x, y, alive, key, pos, counts, n, ncells, kmax,
                            eps, first, died, count, stream);
}

extern "C" int psim_sweep_collisions_f32(const float* x, const float* y,
                                         const bool* alive, const int* key,
                                         const int64_t* pos,
                                         const int64_t* counts, int n,
                                         int ncells, int kmax, double eps,
                                         int* first, bool* died,
                                         long long* count, void* stream) {
  return collisions<float>(x, y, alive, key, pos, counts, n, ncells, kmax,
                           eps, first, died, count, stream);
}
