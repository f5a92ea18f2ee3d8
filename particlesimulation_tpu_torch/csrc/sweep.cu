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
// Design. The COM pass is a serial chain a cell (the parity mean is a
// recurrence, and the fast sums keep position order): a warp takes 32
// cells at once, a chain a lane, every cell's chain in flight together;
// the whole warp stages the cells' lanes into shared memory 32 a round
// and computes there what does not wait on the chain (products, the parity
// divisors' reciprocals), so that a chain step is the dependent arithmetic
// alone (its section's note below). The parity force pass
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
// The COM pass moves few bytes (each lane's x, y, m once, 3 values a cell
// out) and is bound by its chain: the longest cell's lanes times one lane's
// dependent latency (the chain floor).
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
constexpr unsigned kFullMask = 0xFFFFFFFFu;

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

// ---- The COM pass: per cell M, MX, MY (ops/com.py com_parity or com_fast).
//
// A block is eight warps, and the grid at most the blocks the card holds at
// once (the launcher's occupancy query), so every cell's chain is in flight
// together. Block b owns the cells whose first lane lies in its stretch of
// lanes [b * stretch, (b + 1) * stretch): its warps read the stretch's pos
// kComScan words of 32 lanes each at a time and __ballot_sync the pos-0
// lanes; from the ballots' counts each start knows its place among the
// block's starts, and the cells go out in lane order, 32 a group (a
// sentinel lane at pos 0 takes a slot and no lanes). A group of
// `have` cells gives each cell K = 32 / g columns of 32 rows of shared
// memory (g: `have` rounded up to a power of two), so a round holds K * 32
// lanes of every cell: 32 at the flagship's ~100 lanes a cell, 1024 at
// MEDIUM's one cell a block. A round:
//   1. staged: the helper warps (1 to 7) copy each cell's lanes of x, y, m
//      into its columns (cp.async, 32 consecutive lanes a column);
//   2. (parity) warp 1, a cell a lane, runs its cell's prefix masses, one
//      serial add a lane, the plain version's m0 + mi, into one of two
//      buffers;
//   3. the whole block computes, a lane of a cell a thread, what does not
//      depend on the running mean: m*x and m*y (x and y where the prefix
//      mass is 0: the adoption), and (parity) the divisor's reciprocal
//      __drcp_rn(m0 + mi);
//   4. warp 0, a cell a lane, walks its cell's lanes of the round: the
//      chain, carried across rounds in registers. Meanwhile the helpers
//      stage the next round and warp 1 runs its prefix masses (1 and 2).
// Empty cells are zeroed by the same launch (a grid-stride loop).
//
// The parity division. The running mean's step is a = (a*m0 + mi*xi) / d,
// d = m0 + mi, and only a*m0, the add and the quotient wait on the previous
// a. With r = RN(1/d) computed ahead (step 3), the quotient is
//   q0 = RN(n*r);  e0 = RN(n - d*q0);  q1 = RN(q0 + e0*r);
//   e1 = RN(n - d*q1) (exact);  q2 = RN(q1 + e1*r) = RN(n/d),
// each RN(u + v*w) one fma. q0 lies within 1.5 ulps of n/d, so q1, its
// error cut by r's (2^-53), is faithful; then e1 is exact and q2 is the
// IEEE quotient (Markstein's theorem: a faithful quotient and a reciprocal
// within half an ulp; Muller et al., Handbook of Floating-Point
// Arithmetic, division with an FMA). It holds while no step under- or
// overflows: d of binary exponent in [-510, 510] (div_range), n too or +0
// (rcp_ok; a numerator of -0 would come out +0, and subnormals, infinities
// and NaNs lie outside). A cell whose lanes so far each hold x, y and m at
// +0 or in [2^-200, 2^200] (com_plain, checked in step 3) keeps every
// numerator there, so its chain takes the sequence at every step without a
// test or a branch; any other cell walks the round step by step as the
// plain version does, with the sequence where rcp_ok and div_range allow
// it and __ddiv_rn elsewhere. a*m0 and the add stay two roundings
// (-fmad=false, and no fma is written there).
//
// What bounds it: not the bytes (each lane's x, y, m once) but the chain: a
// cell's lanes are one serial recurrence, so the pass takes at least the
// longest cell's lanes times one lane's dependent latency (parity: a
// product, a sum, a product and four fmas; fast: one add),
// which chip_smoke measures with sweep_com_chain_kernel below (the chain
// floor).

constexpr int kComLanes = 32;               // rows: a column's lanes
constexpr int kComPitch = 33;               // a row: 32 columns + 1
constexpr int kComTile = kComLanes * kComPitch;
constexpr int kComWarps = 8;                // a block
constexpr int kComThreads = 32 * kComWarps;
constexpr int kComScan = 12;                // pos words a warp a scan step
constexpr unsigned kDivLo = 1023 - 510;     // div_range's biased exponents
constexpr unsigned kDivHi = 1023 + 510;

// The COM kernel's shared memory: x, y, m as staged; the per-lane work
// (parity: m*x, m*y and the reciprocal; fast: (m*x, m*y, m) a float4);
// (parity) two buffers of prefix masses, a row longer (row 0 of a column:
// the mass carried into it).
template <typename T, bool kParity>
constexpr size_t com_shared_bytes() {
  return sizeof(T) * (kParity ? 8 * kComTile + 2 * kComPitch : 7 * kComTile);
}

// Whether v's binary exponent lies in [-510, 510].
__device__ __forceinline__ bool div_range(double v) {
  const unsigned e = ((unsigned)__double2hiint(v) >> 20) & 0x7ffu;
  return e - kDivLo <= kDivHi - kDivLo;
}

// Whether a numerator may take the reciprocal division: in div_range, or
// +0 (the sequence below keeps +0; a numerator of -0 would come out +0).
__device__ __forceinline__ bool rcp_ok(double n) {
  return div_range(n) || __double_as_longlong(n) == 0;
}

// RN(n / d) from r = RN(1/d), for d in div_range and rcp_ok(n) (see
// above).
__device__ __forceinline__ double div_by_rcp(double n, double d, double r) {
  double q = __dmul_rn(n, r);
  double e = __fma_rn(-d, q, n);
  q = __fma_rn(e, r, q);
  e = __fma_rn(-d, q, n);
  return __fma_rn(e, r, q);
}

// One lane of the parity chain as the plain version computes it: (a, b)
// takes the lane whose prefix masses are prev (before it) and d (with it),
// whose products are (px, py) (its x, y where prev is 0) and whose
// divisor's reciprocal is r (0 where prev is 0 or d lies outside
// div_range).
__device__ __forceinline__ void parity_com_step(double prev, double d,
                                                double px, double py,
                                                double r, double& a,
                                                double& b) {
  const double na = __dadd_rn(__dmul_rn(a, prev), px);
  const double nb = __dadd_rn(__dmul_rn(b, prev), py);
  double qa = div_by_rcp(na, d, r), qb = div_by_rcp(nb, d, r);
  if (prev != 0.0 && !(r != 0.0 && rcp_ok(na) && rcp_ok(nb))) {
    qa = __ddiv_rn(na, d);
    qb = __ddiv_rn(nb, d);
  }
  a = prev == 0.0 ? px : qa;
  b = prev == 0.0 ? py : qb;
}

// Whether a lane keeps its cell's parity chain in the reciprocal
// division's range: x, y and m each +0 or in [2^-200, 2^200]. While every
// lane of a cell so far does, the masses are sums of such (prev, d in
// [2^-200, 2^232] once not 0), the mean stays within the positions' range,
// and each numerator a*m0 + mi*xi is a sum of two terms of one sign: +0, or
// in [2^-400, 2^432]; so every step may take the reciprocal division.
__device__ __forceinline__ bool com_plain(double v) {
  return __double_as_longlong(v) == 0 ||
         (v >= 0x1p-200 && v <= 0x1p200);
}

// One lane of the parity chain at staged element i, without a branch: the
// reciprocal division (its cell within range: see com_chain). kCareful:
// rows t >= rows leave (a, b) as they are, and a prefix mass of 0 adopts
// the lane's x, y (in PX, PY there), both by a select.
template <bool kCareful>
__device__ __forceinline__ void parity_fast_step(const double* Dp,
                                                 const double* PX,
                                                 const double* PY,
                                                 const double* W, int i,
                                                 bool live, double& a,
                                                 double& b) {
  const double prev = Dp[i], d = Dp[i + kComPitch], r = W[i], px = PX[i],
               py = PY[i];
  const double qa = div_by_rcp(__dadd_rn(__dmul_rn(a, prev), px), d, r);
  const double qb = div_by_rcp(__dadd_rn(__dmul_rn(b, prev), py), d, r);
  if constexpr (kCareful) {
    a = !live ? a : prev == 0.0 ? px : qa;
    b = !live ? b : prev == 0.0 ? py : qb;
  } else {
    a = qa;
    b = qb;
  }
}

// Step 4 (parity) for one column (col) of a cell in range: rows 0 ..
// rows-1, all 32 unrolled, so that their operands are read ahead of the
// chain. A full column whose carried-in mass is not 0 holds no adoption
// (the prefix masses of a cell in range, once not 0, stay so) and takes
// the steps bare; another column takes them with kCareful's selects.
__device__ __forceinline__ void parity_fast_column(const double* Dp,
                                                   const double* PX,
                                                   const double* PY,
                                                   const double* W, int col,
                                                   int rows, double& a,
                                                   double& b) {
  if (rows == kComLanes && Dp[col] != 0.0) {
#pragma unroll 8
    for (int t = 0; t < kComLanes; ++t)
      parity_fast_step<false>(Dp, PX, PY, W, t * kComPitch + col, true, a,
                              b);
  } else {
#pragma unroll 8
    for (int t = 0; t < kComLanes; ++t)
      parity_fast_step<true>(Dp, PX, PY, W, t * kComPitch + col, t < rows,
                             a, b);
  }
}

// Step 4: the chain over lanes 0 .. cnt-1 of a round, 32 rows of each of
// the cell's columns from col0 in turn. Parity: a cell whose lanes so far
// all keep it in range (`plain`) by parity_fast_column; another cell as
// the plain version does (parity_com_step), a step at a time. Fast: the
// three sums, a lane's (m*x, m*y, m) read at once.
template <typename T, bool kParity>
__device__ __forceinline__ void com_chain(const T* Dp, const T* PX,
                                          const T* PY, const T* W, int col0,
                                          int cnt, bool plain, T& m0, T& a,
                                          T& b) {
  if constexpr (kParity) {
    for (int e = 0; e < cnt; e += kComLanes) {
      const int col = col0 + (e >> 5), rows = min(kComLanes, cnt - e);
      if (plain) {
        parity_fast_column(Dp, PX, PY, W, col, rows, a, b);
      } else {
        for (int t = 0; t < rows; ++t) {
          const int i = t * kComPitch + col;
          parity_com_step(Dp[i], Dp[i + kComPitch], PX[i], PY[i], W[i], a,
                          b);
        }
      }
    }
  } else {
    const float4* V = reinterpret_cast<const float4*>(PX);
    for (int e = 0; e < cnt; e += kComLanes) {
      const int col = col0 + (e >> 5), rows = min(kComLanes, cnt - e);
      if (rows == kComLanes) {
#pragma unroll 8
        for (int t = 0; t < kComLanes; ++t) {
          const float4 v = V[t * kComPitch + col];
          m0 = m0 + v.z;
          a = a + v.x;
          b = b + v.y;
        }
      } else {
        for (int t = 0; t < rows; ++t) {
          const float4 v = V[t * kComPitch + col];
          m0 = m0 + v.z;
          a = a + v.x;
          b = b + v.y;
        }
      }
    }
  }
}

// Step 2 (parity): the prefix masses of lanes 0 .. cnt-1 of a round, by
// column; row 0 of a column holds the mass carried into it.
template <typename T>
__device__ __forceinline__ void com_prefix(const T* Mr, T* Dp, int col0,
                                           int cnt, T& m0) {
  for (int o = 0; o < cnt; o += kComLanes) {
    const int col = col0 + (o >> 5);
    Dp[col] = m0;
    if (cnt - o >= kComLanes) {
#pragma unroll 8
      for (int t = 0; t < kComLanes; ++t) {
        m0 = m0 + Mr[t * kComPitch + col];
        Dp[(t + 1) * kComPitch + col] = m0;
      }
    } else {
      for (int t = 0; t < cnt - o; ++t) {
        m0 = m0 + Mr[t * kComPitch + col];
        Dp[(t + 1) * kComPitch + col] = m0;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A group's cells: first lanes, lengths; columns a cell (K = 1 << lk);
// (parity) whether a lane so far took the cell out of range (com_plain).
struct ComGroup {
  int have, lk;
  const int* start;
  const int* len;
  int* wild;
};

// Step 1: the helper warps (1 ..) copy lanes o .. o + K*32 - 1 of each cell
// into its columns of X, Y, Mr.
template <typename T>
__device__ __forceinline__ void com_stage(const T* x, const T* y,
                                          const T* m, ComGroup g, int o,
                                          T* X, T* Y, T* Mr) {
  for (int f = threadIdx.x - 32; f < (g.have << g.lk) * 32;
       f += kComThreads - 32) {
    const int t = f & 31, col = f >> 5, c = col >> g.lk;
    const int idx = o + ((col & ((1 << g.lk) - 1)) << 5) + t;
    if (idx < g.len[c]) {
      const int i = t * kComPitch + col, j = g.start[c] + idx;
      cp_async(X + i, x + j);
      cp_async(Y + i, y + j);
      cp_async(Mr + i, m + j);
    }
  }
  cp_async_commit();
}

// The helper warps' barrier (named barrier 1): their staged copies, waited
// for by each, are then visible to all of them.
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kComThreads - 32) : "memory");
}

// A group of g.have cells, walked by the whole block (see above). Every
// thread calls it. Warp 0 runs the chains, lane c cell c's; the helper
// warps stage each round, and (parity) warp 1 runs the prefix masses, lane
// c cell c's, into one of two buffers: round r+1's while warp 0 walks round
// r's chain.
template <typename T, bool kParity>
__device__ void com_cells(ComGroup g, const T* x, const T* y, const T* m,
                          const int* key, int ncells, T* sh, T* M, T* MX,
                          T* MY) {
  const int tid = threadIdx.x, c1 = tid - 32;
  const bool chain = tid < g.have, helper = tid >= 32;
  const bool prefixer = kParity && c1 >= 0 && c1 < g.have;
  T *X = sh, *Y = X + kComTile, *Mr = Y + kComTile, *PX = Mr + kComTile,
    *PY = PX + kComTile, *W = PY + kComTile;
  T* const Dp0 = W + kComTile;  // two prefix buffers, rounds alternating
  constexpr int kDpStride = kComTile + kComPitch;
  if (chain) g.wild[tid] = 0;
  int most = 0;
  for (int c = 0; c < g.have; ++c) most = max(most, g.len[c]);
  const int span = kComLanes << g.lk;
  const int len = chain ? g.len[tid] : prefixer ? g.len[c1] : 0;
  T m0 = T(0), a = T(0), b = T(0);
  if (helper) {
    com_stage(x, y, m, g, 0, X, Y, Mr);
    cp_async_wait_all();
    helpers_sync();
    if (prefixer) com_prefix(Mr, Dp0, c1 << g.lk, min(len, span), m0);
  }
  __syncthreads();
  for (int o = 0, r = 0; o < most; o += span, ++r) {
    const T* Dp = Dp0 + (r & 1) * kDpStride;
    for (int f = tid; f < (g.have << g.lk) * 32; f += kComThreads) {
      const int t = f & 31, col = f >> 5, c = col >> g.lk;
      const int idx = o + ((col & ((1 << g.lk) - 1)) << 5) + t;
      if (idx < g.len[c]) {
        const int i = t * kComPitch + col;
        const T xv = X[i], yv = Y[i], mv = Mr[i];
        if constexpr (kParity) {
          const T prev = Dp[i], d = Dp[i + kComPitch];
          PX[i] = prev == T(0) ? xv : mv * xv;
          PY[i] = prev == T(0) ? yv : mv * yv;
          W[i] = prev != T(0) && div_range(d) ? __drcp_rn(d) : T(0);
          if (!(com_plain(xv) && com_plain(yv) && com_plain(mv)))
            g.wild[c] = 1;
        } else {
          reinterpret_cast<float4*>(PX)[i] =
              make_float4(mv * xv, mv * yv, mv, 0.0f);
        }
      }
    }
    __syncthreads();
    if (helper) {
      if (o + span < most) {
        com_stage(x, y, m, g, o + span, X, Y, Mr);
        cp_async_wait_all();
        helpers_sync();
        if (prefixer)
          com_prefix(Mr, Dp0 + ((r + 1) & 1) * kDpStride, c1 << g.lk,
                     min(max(len - o - span, 0), span), m0);
      }
    } else if (chain) {
      com_chain<T, kParity>(Dp, PX, PY, W, tid << g.lk,
                            min(max(len - o, 0), span), g.wild[tid] == 0,
                            m0, a, b);
    }
    __syncthreads();
  }
  if (len > 0) {
    if (prefixer) {
      M[key[g.start[c1]]] = m0;
    } else if (chain) {
      const int k = key[g.start[tid]];
      if constexpr (kParity) {
        MX[k] = a;
        MY[k] = b;
      } else {
        M[k] = m0;
        MX[k] = m0 > T(0) ? a / m0 : T(0);
        MY[k] = m0 > T(0) ? b / m0 : T(0);
      }
    }
  }
}

template <typename T, bool kParity>
__global__ void __launch_bounds__(kComThreads)
    sweep_com_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const T* __restrict__ m, const int* __restrict__ key,
                     const int64_t* __restrict__ pos,
                     const int64_t* __restrict__ counts, int n, int ncells,
                     int stretch, T* M, T* MX, T* MY) {
  extern __shared__ __align__(16) unsigned char com_shared[];
  __shared__ int starts[32], lens[32], wild[32], found[kComWarps];
  __shared__ unsigned words[kComWarps * kComScan];
  T* sh = reinterpret_cast<T*>(com_shared);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = blockIdx.x * kComThreads + tid; c < ncells;
       c += gridDim.x * kComThreads) {
    if (counts[c] == 0) {
      M[c] = T(0);
      MX[c] = T(0);
      MY[c] = T(0);
    }
  }
  // The group's cells: first lanes and lengths, then the block walks them.
  auto run = [&](int have) {
    __syncthreads();
    if (tid < have) {
      const int k = key[starts[tid]];
      lens[tid] = (unsigned)k < (unsigned)ncells ? (int)counts[k] : 0;
    }
    __syncthreads();
    int lk = 5;
    while ((1 << (5 - lk)) < have) --lk;
    com_cells<T, kParity>(ComGroup{have, lk, starts, lens, wild}, x, y, m,
                          key, ncells, sh, M, MX, MY);
    __syncthreads();
  };
  const int s0 = blockIdx.x * stretch;
  const int s1 = min(n, s0 + stretch);
  int have = 0;  // starts already in starts[] (carried from a step)
  for (int base = s0; base < s1; base += kComThreads * kComScan) {
    // Word warp * kComScan + u: lanes base + word * 32 + (0 .. 31).
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kComScan; ++u) {
      const int i = base + (warp * kComScan + u) * 32 + lane;
      const unsigned f = __ballot_sync(
          kFullMask, (pos[min(i, s1 - 1)] == 0) & (i < s1));
      if (lane == 0) words[warp * kComScan + u] = f;
      mine += __popc(f);
    }
    if (lane == 0) found[warp] = mine;
    __syncthreads();
    // Each start's place in the block's sequence: the starts before it
    // (the carried ones, earlier warps' words, its warp's earlier words,
    // the lanes before it in its word).
    int before = have, total = have;
    for (int w = 0; w < kComWarps; ++w) {
      before += w < warp ? found[w] : 0;
      total += found[w];
    }
    // Groups of 32 in sequence; the last, if not full, waits for the next
    // step's starts.
    for (int g0 = 0; g0 < total; g0 += 32) {
      int j = before - g0;
      for (int u = 0; u < kComScan; ++u) {
        const unsigned f = words[warp * kComScan + u];
        const int at = j + __popc(f & ((1u << lane) - 1u));
        if (((f >> lane) & 1u) && at >= 0 && at < 32)
          starts[at] = base + (warp * kComScan + u) * 32 + lane;
        j += __popc(f);
      }
      if (total - g0 < 32) {
        have = total - g0;
        break;
      }
      run(32);
      have = 0;
    }
    __syncthreads();
  }
  if (have > 0) run(have);
}

// The chain floor's yardstick: one thread walks `steps` lanes of the COM
// chain (step 4, the same code) over a round of unit-scale operands staged
// in shared memory (no adoption, no fallback), so that a launch's time over
// `steps` is one lane's dependent latency on the chain.
template <typename T, bool kParity>
__global__ void sweep_com_chain_kernel(int steps, T* out) {
  // fast: PX holds float4 elements
  __shared__ __align__(16) T PX[kParity ? kComTile : 4 * kComTile];
  __shared__ T Dp[kComTile + kComPitch], PY[kComTile], W[kComTile];
  for (int t = 0; t <= kComLanes; ++t) Dp[t * kComPitch] = T(t + 1);
  for (int t = 0; t < kComLanes; ++t) {
    const int at = t * kComPitch;
    const T px = T(0.5) + T(t) / T(64), py = T(0.25) + T(t) / T(128);
    if constexpr (kParity) {
      PX[at] = px;
      PY[at] = py;
      W[at] = T(1) / Dp[at + kComPitch];
    } else {
      reinterpret_cast<float4*>(PX)[at] = make_float4(px, py, 1.0f, 0.0f);
    }
  }
  T m0 = T(0), a = T(0.5), b = T(0.25);
  for (int s = 0; s < steps; s += kComLanes)
    com_chain<T, kParity>(Dp, PX, PY, W, 0, kComLanes, true, m0, a, b);
  out[0] = m0;
  out[1] = a;
  out[2] = b;
}

// The reciprocal division against __ddiv_rn: pair i is (n, d) = (u[i],
// v[i]), or with `midpoint` (v[i], d * (u[i] + ulp(u[i])/2) rounded), whose
// quotient lies next to the midpoint after u[i], the hardest case to round.
// Each pair takes the COM chain's path (div_by_rcp in div_range, else
// __ddiv_rn); out[0] counts the quotients whose bits differ from
// __ddiv_rn's, out[1] the pairs that took div_by_rcp.
__global__ void sweep_div_check_kernel(const double* __restrict__ u,
                                       const double* __restrict__ v,
                                       int count, int midpoint,
                                       unsigned long long* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false, fast = false;
  if (i < count) {
    const double d = v[i];
    double nu = u[i];
    if (midpoint) {
      const double half = ldexp(1.0, ilogb(nu) - 53);
      nu = __fma_rn(d, nu, __dmul_rn(d, half));
    }
    const double r = div_range(d) ? __drcp_rn(d) : 0.0;
    fast = r != 0.0 && rcp_ok(nu);
    const double q = fast ? div_by_rcp(nu, d, r) : __ddiv_rn(nu, d);
    bad = __double_as_longlong(q) != __double_as_longlong(__ddiv_rn(nu, d));
  }
  const int nbad = __syncthreads_count(bad), nfast = __syncthreads_count(fast);
  if (threadIdx.x == 0) {
    if (nbad) atomicAdd(out, (unsigned long long)nbad);
    if (nfast) atomicAdd(out + 1, (unsigned long long)nfast);
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

template <typename T, bool kParity>
int com(const T* x, const T* y, const T* m, const int* key,
        const int64_t* pos, const int64_t* counts, int n, int ncells, T* M,
        T* MX, T* MY, void* stream) {
  if (n < 1 || ncells < 1) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_com_kernel<T, kParity>;
  const size_t smem = com_shared_bytes<T, kParity>();
  static size_t opted = 0;
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  // The blocks the card holds at once: the stretches are sized so that the
  // grid is no larger, every cell's chain in flight together.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kernel, kComThreads, smem)) != cudaSuccess)
      return (int)err;
    resident = sms * per > 0 ? sms * per : 1;
  }
  const long long per_block = ((long long)n + resident - 1) / resident;
  const int stretch = (int)((per_block + 31) / 32 * 32);
  const unsigned blocks = (unsigned)((n + stretch - 1) / stretch);
  kernel<<<blocks, kComThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, m, key, pos, counts, n, ncells, stretch, M, MX, MY);
  return (int)cudaGetLastError();
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

// The chain floor's yardstick (sweep_com_chain_kernel): one thread, `steps`
// lanes of the COM chain; out: 3 values (the chain's result, kept so that
// the loop is not optimised away).
extern "C" int psim_sweep_com_chain_f64(int steps, double* out,
                                        void* stream) {
  sweep_com_chain_kernel<double, true>
      <<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(steps, out);
  return (int)cudaGetLastError();
}

extern "C" int psim_sweep_com_chain_f32(int steps, float* out, void* stream) {
  sweep_com_chain_kernel<float, false>
      <<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(steps, out);
  return (int)cudaGetLastError();
}

// u, v: count values each; out: two zeroed counters (sweep_div_check_kernel:
// the mismatches against __ddiv_rn, the pairs that took the reciprocal).
extern "C" int psim_sweep_div_check(const double* u, const double* v,
                                    int count, int midpoint,
                                    unsigned long long* out, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  sweep_div_check_kernel<<<blocks_for(count), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      u, v, count, midpoint, out);
  return (int)cudaGetLastError();
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
