// The tile step's kernels around its pair pass on a pool of slot rows, for
// Hopper (sm_90a).
//
// A slot-resident engine keeps its particles in rows of slots, one row per
// cell of the grid; row r holds the slots row_start[r] to row_start[r + 1]
// of flat per-field arrays (rows of one width K in the resident engine, of
// each band's K in the banded engine's pool). A step runs, in order:
//
//   monopole_integrate_kernel: in place, each live slot's 8 stencil
//     monopole terms from its cell's neighbours' sums, the pair force
//     carried from the last pair pass added, the explicit integrator with
//     the periodic wrap; and every slot's destination row and moving flag;
//   deliver_count_kernel, deliver_stage_kernel, deliver_place_kernel (and
//     deliver_expand_kernel for a delivery limited to given slots): in
//     place, every mover lands in its destination row's rank-th free slot,
//     and only the movers' slots are written;
//   pair_masks_kernel: every slot's masks for the pair pass (binned:
//     occupied and in the box by the C truncation of x / w; mf, its mass
//     where binned; alive, binned with m > 0);
//   (the fused pair pass, csrc/cell_pairs.cu)
//   settle_sums_kernel: the step's tail after its pair pass (the slots it
//     killed get m 0 in place; the collision, limbo and overflow counters)
//     and the next step's row sums: each row's M, sum m x and sum m y over
//     its binned slots.
//
// The mesh engines and the super-cell engines take the monopole and the
// integrator in one pass too (step_mf's arithmetic), and leave the
// destinations to the engine. The resident and band meshes' tables come
// from a halo exchange, a row's 8 terms at its row's index:
// monopole_pool_kernel (a thread a slot); the super-cell engines' terms are
// built from the cell sums in place, a slot's at its own cell:
// monopole_supercell_kernel (a block a super-cell row, its neighbourhood
// staged in shared memory), which replaced the tables kernel and a
// per-slot table read on those routes.
//
// Between the delivery of step t and the sums of step t + 1 only the m of
// the slots that died in pair pass t changes, so the masks the pair pass
// needs and the sums the next monopole pass needs are the same function of
// the tiles split where its inputs are ready: two passes, each taking in
// the plain passes around it.
//
// They replace XLA code of the JAX package, which has no Pallas kernel for
// this phase (its Pallas rebin was retired, since a TPU punishes scatters):
// engine.py's physics_mass and the pair pass's alive mask, the row sums of
// its mono_tables and the step's tail (deaths and counters), ops/stencil.py
// stencil_tables, ops/dense_xla.py monopole_tile_forces, ops/integrate.py
// integrate, and ops/resident.py rebin (the port's one-pass form of it,
// deliver).
//
// What bounds them on an H100: bytes, and for the monopole pass the issue
// of ~300 f32 instructions a live slot. The masks read 13 bytes a slot and
// write 8; the settle pass reads 17 a slot (x, y, m, occ and the pair
// pass's first-pair rank ft), writes 12 a row and 4 a death.
// The monopole pass needs 50 bytes a live slot (occupied with m != 0: the
// physics, its x, y, vx, vy written back) and 18 bytes a slot that is not
// live (x, y, occ and m read, dest and moving written): an empty or dead
// slot is frozen in the plain version, so it is not written and does no
// arithmetic but its destination. The delivery needs occ and moving a slot
// and ~100 bytes a mover: the count pass reads 2 bytes a slot, the stage
// pass copies each mover's fields into a staging record at its place in
// its destination row's bucket, and the place pass, a warp a row and only
// on rows that an arrival or a departure touches, writes the arrivals from
// staging into the free slots and clears the departures. Staging before any
// tile is written lets the tiles be updated in place: a vacated slot may
// take an arrival while the mover that left it is being read elsewhere.
// The byte scans take 4 slots a lane (one 32-bit load of occ or moving).
//
// The same bits as the plain torch versions, where the contract asks for
// them:
//   * monopole_integrate_kernel gives, from the same per-row sums, the bits
//     of the eager composition com_from_sums -> stencil tables ->
//     monopole_tile_forces -> fxd + fxm -> integrate -> cell_of. Eager torch
//     rounds every operation to f32, so each one here is a separate
//     correctly rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn; the
//     library is also built with -fmad=false), IEEE division (torch divides
//     by a tensor on the device with '/', not by a reciprocal), the wrap's
//     fmod (exact: taken as a - side where that is exact, see wrap), and
//     rsqrtf: torch's CUDA rsqrt of a float is ::rsqrtf
//     (c10/cuda/CUDAMathCompat.h, rsqrt(float)), not 1 / sqrtf;
//   * the delivery places every mover where the plain deliver does, and
//     leaves every other slot as it was: slot order decides the fused pair
//     kernel's summation order, so a placement in the order of arrival
//     would change the forces' low bits from run to run;
//   * the masks, the deaths and the counters are exact;
//   * the row sums add in a fixed order (a warp a row, lane l the slots
//     l, l + 32, ... in turn, then a butterfly of shuffles), so two runs
//     give the same bits; the order is not torch.sum's, which they match
//     within (K 2^-24) of the sum of the terms' magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;  // rows (warps) a block, at most

// (dx, dy) of the 8 neighbours in the reference's loop order (dx outer,
// dy inner, (0, 0) skipped): ops/stencil.py STENCIL.
__constant__ int kStencil[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                   {0, 1},   {1, -1}, {1, 0},  {1, 1}};

__device__ __forceinline__ int warp_row(int nrows) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  return r < nrows ? r : -1;
}

// The cell (cy * nc + cx) of a position by C truncation of x / w, as
// ops/binning.cell_of computes it (IEEE division, a conversion toward
// zero that saturates); true if it lies on the grid.
__device__ __forceinline__ bool cell_of(float x, float y, float w, int nc,
                                        int* cell) {
  const int cx = (int)__fdiv_rn(x, w);
  const int cy = (int)__fdiv_rn(y, w);
  *cell = cy * nc + cx;
  return cx >= 0 && cx < nc && cy >= 0 && cy < nc;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A butterfly of shuffles: every lane ends with the same sum (a + b and
// b + a round alike), in an order that does not depend on the run.
__device__ __forceinline__ float warp_fsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The inclusive prefix sum of v over the warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// ---------------------------------------------------------------------------
// Monopole + integrate, in place.

// The pool's fields as the monopole pass takes them: x, y, vx, vy updated
// in place, dest and moving written for every slot.
struct Pool {
  float* x;
  float* y;
  float* vx;
  float* vy;
  const float* m;
  const uint8_t* occ;
  const float* fxd;
  const float* fyd;
  int* dest;
  uint8_t* moving;
};

struct Grid {
  float w, side, side2, dt, g;
  int nc;
};

// A row's 8 temp cells: neighbour mass, and COM (offset at the mirrored
// edges), in stencil order.
struct Temps {
  float cm[8], mx[8], my[8];
};

// A slot's inputs, and its state after the step.
struct Slot {
  float x, y, vx, vy, m, fx, fy;
  bool o;
};

struct Next {
  float x, y, vx, vy;
};

// fmodf(nx + side, side), as torch.fmod gives it. fmod is exact, and for
// a = nx + side in [0, 2 side) it is a (below side) or a - side, which is
// exact there (Sterbenz); -0.0 stays -0.0 as in fmodf. Elsewhere (a < 0,
// a >= 2 side, where fmod of 2 side is 0, NaN, infinities) fmodf itself.
__device__ __forceinline__ float wrap(float nx, const Grid& p) {
  const float a = __fadd_rn(nx, p.side);
  if (a >= 0.0f && a < p.side2)
    return a >= p.side ? __fsub_rn(a, p.side) : a;
  return fmodf(a, p.side);
}

// The temp cell of direction l for row r (the cell r; ops/stencil.py:
// neighbour (cy + dy, cx + dx) wrapped, as torch.roll wraps; its COM, 0
// where it holds no mass; +-side at the mirrored edges, added as offset +
// COM).
__device__ __forceinline__ void temp_cell(int r, int l, const Grid& p,
                                          const float* __restrict__ M,
                                          const float* __restrict__ SX,
                                          const float* __restrict__ SY,
                                          float* cm, float* tmx, float* tmy) {
  const int nc = p.nc;
  const int cx = r % nc, cy = r / nc;
  const int dx = kStencil[l][0], dy = kStencil[l][1];
  int nx = cx + dx, ny = cy + dy;
  nx = nx < 0 ? nx + nc : (nx >= nc ? nx - nc : nx);
  ny = ny < 0 ? ny + nc : (ny >= nc ? ny - nc : ny);
  const int nb = ny * nc + nx;
  const float mn = M[nb];
  const bool has = mn > 0.0f;
  const float safe = has ? mn : 1.0f;
  const float mx = has ? __fdiv_rn(SX[nb], safe) : 0.0f;
  const float my = has ? __fdiv_rn(SY[nb], safe) : 0.0f;
  const float offx = dx == 1    ? (cx == nc - 1 ? p.side : 0.0f)
                     : dx == -1 ? (cx == 0 ? -p.side : 0.0f)
                                : 0.0f;
  const float offy = dy == 1    ? (cy == nc - 1 ? p.side : 0.0f)
                     : dy == -1 ? (cy == 0 ? -p.side : 0.0f)
                                : 0.0f;
  *cm = mn;
  *tmx = __fadd_rn(offx, mx);
  *tmy = __fadd_rn(offy, my);
}

// Slot s's inputs; returns whether it is live (m != 0). vx, vy and the
// pair force are read only for a live slot.
__device__ __forceinline__ bool load_slot(int64_t s, const Pool& f,
                                          Slot* in) {
  in->m = f.m[s];
  in->x = f.x[s];
  in->y = f.y[s];
  in->o = f.occ[s] != 0;
  const bool live = !(in->m == 0.0f);
  in->vx = live ? f.vx[s] : 0.0f;
  in->vy = live ? f.vy[s] : 0.0f;
  in->fx = live ? f.fxd[s] : 0.0f;
  in->fy = live ? f.fyd[s] : 0.0f;
  return live;
}

// One slot's step under the monopole mass mf: the 8 stencil terms of
// ops/dense.py monopole_tile_forces (kGathered false) or monopole_gathered
// (true: a term whose neighbour mass cm is 0 is dropped, as there; not the
// same as a zero term where d2 is subnormal and 0 * inv^3 is NaN) from the
// temp cells t, added in stencil order to 0; the pair force added; the
// explicit step of ops/integrate.py (m == 0 slots frozen: their state comes
// out as it went in). Every operation is one correctly rounded f32
// operation in the plain version's order and association.
//
// step_terms takes the temp cells from term(l) (a Triple: cm, mx, my), one
// direction at a time, so that a caller that builds them in place holds
// none of them in registers beyond its own direction; step_mf takes them
// from a Temps.
template <bool kGathered, typename Term>
__device__ __forceinline__ Next step_terms(const Slot& in, float mf,
                                           Term term, const Grid& p) {
  const float gm = __fmul_rn(p.g, mf);
  float fx = 0.0f, fy = 0.0f;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const Triple<float> t = term(l);
    const float dxl = __fsub_rn(t.x, in.x);
    const float dyl = __fsub_rn(t.y, in.y);
    const float d2 = __fadd_rn(__fmul_rn(dxl, dxl), __fmul_rn(dyl, dyl));
    const bool nz = d2 > 0.0f && (!kGathered || t.m != 0.0f);
    const float inv = nz ? rsqrtf(d2) : 0.0f;
    const float sl = __fmul_rn(__fmul_rn(gm, t.m),
                               __fmul_rn(__fmul_rn(inv, inv), inv));
    fx = __fadd_rn(fx, __fmul_rn(sl, dxl));
    fy = __fadd_rn(fy, __fmul_rn(sl, dyl));
  }
  const float tfx = __fadd_rn(in.fx, fx);
  const float tfy = __fadd_rn(in.fy, fy);
  // x += vx*dt + 0.5*ax*dt*dt as ((vx*dt) + (((0.5*ax)*dt)*dt)).
  const bool frozen = in.m == 0.0f;
  const float safe_m = frozen ? 1.0f : in.m;
  const float ax = __fdiv_rn(tfx, safe_m);
  const float ay = __fdiv_rn(tfy, safe_m);
  const float dt = p.dt;
  const float nx = __fadd_rn(
      in.x, __fadd_rn(__fmul_rn(in.vx, dt),
                      __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ax), dt), dt)));
  const float ny = __fadd_rn(
      in.y, __fadd_rn(__fmul_rn(in.vy, dt),
                      __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ay), dt), dt)));
  Next out;
  out.x = frozen ? in.x : wrap(nx, p);
  out.y = frozen ? in.y : wrap(ny, p);
  out.vx = frozen ? in.vx : __fadd_rn(in.vx, __fmul_rn(ax, dt));
  out.vy = frozen ? in.vy : __fadd_rn(in.vy, __fmul_rn(ay, dt));
  return out;
}

template <bool kGathered>
__device__ __forceinline__ Next step_mf(const Slot& in, float mf,
                                        const Temps& t, const Grid& p) {
  return step_terms<kGathered>(
      in, mf,
      [&](int l) { return Triple<float>{t.cm[l], t.mx[l], t.my[l]}; }, p);
}

// The resident step's form: the monopole mass is m where the slot is
// binned (occupied, in the box), else 0.
__device__ __forceinline__ Next step(const Slot& in, const Temps& t,
                                     const Grid& p) {
  int cell;
  const bool binned = in.o && cell_of(in.x, in.y, p.w, p.nc, &cell);
  return step_mf<false>(in, binned ? in.m : 0.0f, t, p);
}

// A slot's outputs: a live slot's new state written back, and every
// slot's destination row (the cell of its position) and moving flag
// (occupied, in the box and not row r).
__device__ __forceinline__ void finish(int64_t s, int r, bool live,
                                       const Slot& in, const Next& nx,
                                       const Pool& f, const Grid& p) {
  if (live) {
    f.x[s] = nx.x;
    f.y[s] = nx.y;
    f.vx[s] = nx.vx;
    f.vy[s] = nx.vy;
  }
  int to;
  const bool in_box = cell_of(nx.x, nx.y, p.w, p.nc, &to);
  f.dest[s] = to;
  f.moving[s] = in.o && in_box && to != r;
}

// A warp a row (cell). Lanes 0-7 first build the row's 8 temp cells (the
// neighbours' sums loaded and their COM divided), shared by shuffles; then
// a lane a slot. A slot that is not live (m == 0: empty or dead, frozen in
// the plain version) does no physics and keeps its x, y, vx, vy; its lane
// branches to the destination alone (the warp's live lanes run the physics
// meanwhile).
__global__ void monopole_integrate_kernel(Pool f, const float* __restrict__ M,
                                          const float* __restrict__ SX,
                                          const float* __restrict__ SY,
                                          const int64_t* __restrict__ row_start,
                                          int nrows, Grid p) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;

  float cm = 0.0f, tmx = 0.0f, tmy = 0.0f;
  if (lane < 8) temp_cell(r, lane, p, M, SX, SY, &cm, &tmx, &tmy);
  Temps t;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    t.cm[l] = __shfl_sync(kFull, cm, l);
    t.mx[l] = __shfl_sync(kFull, tmx, l);
    t.my[l] = __shfl_sync(kFull, tmy, l);
  }
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  for (int64_t s = s0 + lane; s < s1; s += 32) {
    Slot in;
    if (load_slot(s, f, &in))
      finish(s, r, true, in, step(in, t, p), f, p);
    else
      finish(s, r, false, in, Next{in.x, in.y, 0.0f, 0.0f}, f, p);
  }
}

// ---------------------------------------------------------------------------
// The mesh and super-cell engines' monopole + integrate, in place.

// Stencil tables: term l of table index i at i * sidx + l * sdir of each
// of ml (neighbour mass), mx, my (mirrored COM): (nidx, 8) row tables
// (sidx 8, sdir 1) or (8, nidx) gathered tables (sidx 1, sdir nidx); an
// index outside [0, nidx) reads the zero sentinel index.
struct Tables {
  const float* ml;
  const float* mx;
  const float* my;
  int64_t sidx, sdir, nidx, sentinel;
};

// The fields the pass takes: x, y, vx, vy updated in place; m (frozen
// where 0), the monopole mass mf, the pair force.
struct MeshPool {
  float* x;
  float* y;
  float* vx;
  float* vy;
  const float* m;
  const float* mf;
  const float* fxd;
  const float* fyd;
};

__device__ __forceinline__ int64_t table_index(int64_t i, const Tables& tb) {
  return i >= 0 && i < tb.nidx ? i : tb.sentinel;
}

__device__ __forceinline__ void load_term(const Tables& tb, int64_t i, int l,
                                          float* cm, float* mx, float* my) {
  const int64_t o = i * tb.sidx + (int64_t)l * tb.sdir;
  *cm = tb.ml[o];
  *mx = tb.mx[o];
  *my = tb.my[o];
}

// Slot s's step under temp cells t: a live slot (m != 0) does the physics
// and writes x, y, vx, vy; a frozen one writes nothing (the plain
// version's where gives its bits back).
template <bool kGathered>
__device__ __forceinline__ void mesh_slot(int64_t s, const MeshPool& f,
                                          const Temps& t, const Grid& p) {
  Slot in;
  in.m = f.m[s];
  if (in.m == 0.0f) return;
  in.x = f.x[s];
  in.y = f.y[s];
  in.vx = f.vx[s];
  in.vy = f.vy[s];
  in.fx = f.fxd[s];
  in.fy = f.fyd[s];
  in.o = true;
  const Next out = step_mf<kGathered>(in, f.mf[s], t, p);
  f.x[s] = out.x;
  f.y[s] = out.y;
  f.vx[s] = out.vx;
  f.vy[s] = out.vy;
}

// A thread a slot over the pool, where all of a row's slots read one table
// index: the row itself (row_idx null: the resident meshes' row-aligned
// tables) or row_idx[r] (the band meshes' cell of each pool row); a slot
// where binned is given and 0 takes the sentinel's terms, as the plain
// version's where does. The slot's row comes by arithmetic from a table of
// runs of rows of one width passed by value (the resident meshes' tiles
// are one run, a band pool a run a band): slot s of the launch's runs lies
// in run j, row row0[j] + (s - slot0[j]) / K[j]. A live slot reads its
// row's index and the 24 words of its terms, which its row's other slots
// read too (through L1), then does step_mf's physics; a frozen slot reads
// m alone. Every live slot of the pool is in flight at once, where a warp
// a row (the first design) walked its row in serial rounds of 32 with one
// round's loads in flight: latency-bound, the more so on wide and sparse
// band rows.
//
// Replaces XLA code of the JAX package (no Pallas kernel): the mesh
// engines' monopole_tile_forces or monopole_gathered over their halo
// tables, then integrate (parallel/sharded_resident.py:345-349,
// sharded2d_resident.py:391-395, sharded_banded_cols.py:557-561,
// sharded_banded.py:463-466). Bound: bytes, 48 a live slot (m, mf, the pair
// force and x, y, vx, vy read, x, y, vx, vy written back), 4 a frozen one
// (m), and each row's index and 24 table words.
constexpr int kMaxRuns = 32;
constexpr int kSlotThreads = 256;

struct Runs {
  int n;                        // runs of this launch
  int64_t slot0[kMaxRuns + 1];  // each run's first slot, and the end
  int64_t row0[kMaxRuns];       // each run's first row
  int K[kMaxRuns];              // its rows' width (>= 1)
};

template <bool kGathered>
__global__ void __launch_bounds__(kSlotThreads)
    monopole_pool_kernel(MeshPool f, Tables tb, const __grid_constant__ Runs rn,
                         const int64_t* __restrict__ row_idx,
                         const uint8_t* __restrict__ binned, Grid p) {
  const int64_t s =
      rn.slot0[0] + (int64_t)blockIdx.x * kSlotThreads + threadIdx.x;
  if (s >= rn.slot0[rn.n] || f.m[s] == 0.0f) return;
  int j = 0;
  while (j + 1 < rn.n && s >= rn.slot0[j + 1]) ++j;
  // A 32-bit division where the slot's offset in its run allows it (an
  // int64 one is emulated in ~70 instructions).
  const int64_t u = s - rn.slot0[j];
  const int64_t r = rn.row0[j] + (u <= INT32_MAX ? (int64_t)((uint32_t)u /
                                                            (uint32_t)rn.K[j])
                                                 : u / rn.K[j]);
  const int64_t idx =
      binned != nullptr && binned[s] == 0
          ? tb.sentinel
          : table_index(row_idx == nullptr ? r : row_idx[r], tb);
  Temps t;
#pragma unroll
  for (int l = 0; l < 8; ++l)
    load_term(tb, idx, l, &t.cm[l], &t.mx[l], &t.my[l]);
  mesh_slot<kGathered>(s, f, t, p);
}

// ---------------------------------------------------------------------------
// The super-cell engines' monopole + integrate from the cell sums, in place.
//
// A super-cell pool and the grid its cells lie on. One device (row0 null):
// the whole (nc, nc) grid, rows and columns wrapping; pool row scy * nsc +
// scx is the super-cell (scy, scx) of S x S cells (fewer at the far edges
// where S does not divide nc). A mesh: L shards' (R, nc) blocks of local
// cell rows, columns wrapping, rows taking the received top and bottom
// lines (halo.cuh; the 1D form's y mirror); shard l's pool rows are l *
// rows_t to (l + 1) * rows_t - 1, and of those row (1 + q) * nsc + scx is
// its owned super-row q (rows[l] / S of them; the others are halo rows).
// A slot's cell index is cy * nc + cx on one device, l * R * nc + r * nc +
// c on the mesh; outside [0, ncells), the zero sentinel's terms.
struct Super {
  const float* M;
  const float* SX;
  const float* SY;
  int64_t ncells;
  int nc, S, nsc;
  int L, R, rows_t;
  const int64_t* row0;  // (L,) each block's first global cell row
  const int64_t* rows;  // (L,) its owned cell rows
  const float* top;     // (L, 1, 3, nc) received lines of sums
  const float* bot;
  float side, zero;
};

// Temp cell (dx, dy) of the cell (l, r, c): the neighbour's sums (wrapped,
// or from the halo lines), their COM, the mirror offsets of the cell's
// edges added; stencil_grid_kernel's and stencil_halo_kernel's table
// entry, bit for bit.
__device__ __forceinline__ Triple<float> super_term(const Super& g, int l,
                                                    int r, int c, int dx,
                                                    int dy) {
  int nx = c + dx;
  nx = nx < 0 ? g.nc - 1 : (nx >= g.nc ? 0 : nx);
  Triple<float> v;
  float offy;
  if (g.row0 == nullptr) {
    int ny = r + dy;
    ny = ny < 0 ? g.nc - 1 : (ny >= g.nc ? 0 : ny);
    const int64_t at = (int64_t)ny * g.nc + nx;
    v = {g.M[at], g.SX[at], g.SY[at]};
    offy = mirror_y(dy, r, g.nc, false, g.side, g.zero);
  } else {
    const int pr = r + 1 + dy;
    switch (halo_row(pr, g.rows[l], g.R)) {
      case kHaloBot:
        v = raw<float>(g.bot, line_at(l, 1, 0, g.nc, nx), g.nc);
        break;
      case kHaloTop:
        v = raw<float>(g.top, line_at(l, 1, 0, g.nc, nx), g.nc);
        break;
      case kHaloGrid: {
        const int64_t at = ((int64_t)l * g.R + pr - 1) * g.nc + nx;
        v = {g.M[at], g.SX[at], g.SY[at]};
        break;
      }
      default:
        v = {g.zero, g.zero, g.zero};
    }
    offy = mirror_y(dy, g.row0[l] + r, g.nc, true, g.side, g.zero);
  }
  const Triple<float> t = com<float, true>(v.m, v.x, v.y, g.zero);
  const float offx = mirror(dx, c == g.nc - 1, c == 0, g.side, g.zero);
  return {t.m, offx + t.x, offy + t.y};
}

// A pool row's box of cells: shard l's cell rows y0 to y0 + h - 1 and
// columns x0 to x0 + w - 1; staged: whether its neighbourhood is in
// shared memory.
struct Box {
  int l, y0, x0, h, w;
  bool staged;
};

__device__ __forceinline__ Box super_box(const Super& g, int t, bool stage) {
  Box b;
  if (g.row0 == nullptr) {
    const int scy = t / g.nsc, scx = t % g.nsc;
    b.l = 0;
    b.y0 = scy * g.S;
    b.x0 = scx * g.S;
    b.h = min(g.S, g.nc - b.y0);
    b.w = min(g.S, g.nc - b.x0);
    b.staged = stage && b.h > 0 && b.w > 0;
  } else {
    b.l = t / g.rows_t;
    const int u = t % g.rows_t, q = u / g.nsc - 1, scx = u % g.nsc;
    b.y0 = q * g.S;
    b.x0 = scx * g.S;
    b.h = g.S;
    b.w = min(g.S, g.nc - b.x0);
    b.staged = stage && q >= 0 && b.w > 0 &&
               (int64_t)(q + 1) * g.S <= g.rows[b.l];
  }
  return b;
}

// Slot s's inputs where it is live (m != 0): false for a frozen slot,
// which does nothing.
template <typename I>
__device__ __forceinline__ bool super_load(int64_t s, const MeshPool& f,
                                           const I* __restrict__ cell,
                                           Slot* in, float* mf, int64_t* i) {
  in->m = f.m[s];
  if (in->m == 0.0f) return false;
  in->x = f.x[s];
  in->y = f.y[s];
  in->vx = f.vx[s];
  in->vy = f.vy[s];
  in->fx = f.fxd[s];
  in->fy = f.fyd[s];
  in->o = true;
  *mf = f.mf[s];
  *i = (int64_t)cell[s];
  return true;
}

// A live slot's step: its 8 terms from the staged box where its cell lies
// in it, else from the sums (super_term; a slot outside its row's box,
// which an undelivered mover can be), or the sentinel's zeros, a direction
// at a time (step_terms); then x, y, vx, vy written back.
__device__ __forceinline__ void super_step(int64_t s, const Slot& in,
                                           float mf, int64_t i,
                                           const MeshPool& f, const Super& g,
                                           const Box& b, const float* box,
                                           const Grid& p) {
  // The cell's (shard, row, column) in 32-bit arithmetic (the host keeps
  // ncells below 2^31).
  const bool ok = i >= 0 && i < g.ncells;
  const int ncl = g.R * g.nc;
  const int ii = ok ? (int)i : 0;
  const int li = ii / ncl, rem = ii - li * ncl;
  const int r = rem / g.nc, c = rem - r * g.nc;
  const int bi = r - b.y0, bj = c - b.x0;
  const bool inbox = ok && b.staged && li == b.l && bi >= 0 && bi < b.h &&
                     bj >= 0 && bj < b.w;
  Next out;
  if (inbox) {
    const int bw = b.w + 2, nbox = (b.h + 2) * bw;
    const float* at = box + (bi + 1) * bw + bj + 1;
    out = step_terms<true>(
        in, mf,
        [&](int l) -> Triple<float> {
          const float* q = at + kStencil[l][1] * bw + kStencil[l][0];
          return {q[0], q[nbox], q[2 * nbox]};
        },
        p);
  } else if (ok) {
    out = step_terms<true>(
        in, mf,
        [&](int l) {
          return super_term(g, li, r, c, kStencil[l][0], kStencil[l][1]);
        },
        p);
  } else {
    out = step_terms<true>(
        in, mf,
        [&](int) { return Triple<float>{g.zero, g.zero, g.zero}; }, p);
  }
  f.x[s] = out.x;
  f.y[s] = out.y;
  f.vx[s] = out.vx;
  f.vy[s] = out.vy;
}

// A block a pool row of kcap slots (a thread a slot, at most kSuperThreads
// threads; the registers capped at 32, so that a full SM's worth of
// threads is resident: SMALL's rows of 64 give 32 blocks an SM). The block
// stages its row's (h + 2) x (w + 2) neighbourhood of temp cells in shared
// memory (stage: the box fits kStageBytes, the 48 KB a block has without
// opting in, which holds a full box for S <= 62): each
// position's sums read once in runs of a cell row, its COM divided once
// and its mirror offset added once, as the temp cell of the box's one
// cell and direction that reads it (interior positions: their own cell,
// offset zero). Each thread then loads its first slot (in flight across
// the barrier), and every live slot reads its 8 terms in the box by its
// cell's place there, a direction at a time (super_step's three paths
// keep the box's lean: a slot outside the box and the sentinel take their
// own). Blocks of several rows, a higher register cap and an unrolled
// staging loop were each no faster on the card.
//
// Replaces XLA code of the JAX package: ops/supercell.py's
// monopole_forces_general (:209) and integrate (:404-407), and the mesh
// super-cells' (parallel/sharded_supercell.py:200-260, :428-431), with the
// stencil tables they read (ops/stencil.py stencil_tables, the halo form
// of parallel/sharded.py). Bound: bytes, 48 a live slot (m, mf, the pair
// force and x, y, vx, vy read, x, y, vx, vy written), 4 a frozen one, the
// live slot's cell index, and 12 a cell of the sums (and the halo lines):
// no table is written or read.
constexpr int kSuperThreads = 256;
constexpr int64_t kStageBytes = 48 * 1024;

template <typename I>
__global__ void __launch_bounds__(kSuperThreads, 8)
    monopole_supercell_kernel(MeshPool f, const I* __restrict__ cell,
                              int kcap, Super g, bool stage, Grid p) {
  extern __shared__ float box[];
  const int t = blockIdx.x;
  const Box b = super_box(g, t, stage);
  if (b.staged) {
    const int bw = b.w + 2, nbox = (b.h + 2) * bw;
    for (int k = threadIdx.x; k < nbox; k += blockDim.x) {
      const int bi = k / bw, bj = k - bi * bw;
      const int dy = bi == 0 ? -1 : (bi == b.h + 1 ? 1 : 0);
      const int dx = bj == 0 ? -1 : (bj == b.w + 1 ? 1 : 0);
      const Triple<float> v = super_term(g, b.l, b.y0 + bi - 1 - dy,
                                         b.x0 + bj - 1 - dx, dx, dy);
      box[k] = v.m;
      box[nbox + k] = v.x;
      box[2 * nbox + k] = v.y;
    }
  }
  const int64_t base = (int64_t)t * kcap;
  Slot in;
  float mf = 0.0f;
  int64_t i = -1;
  const bool live =
      (int)threadIdx.x < kcap &&
      super_load(base + threadIdx.x, f, cell, &in, &mf, &i);
  __syncthreads();
  if (live) super_step(base + threadIdx.x, in, mf, i, f, g, b, box, p);
  for (int k = threadIdx.x + blockDim.x; k < kcap; k += blockDim.x)
    if (super_load(base + k, f, cell, &in, &mf, &i))
      super_step(base + k, in, mf, i, f, g, b, box, p);
}

// ---------------------------------------------------------------------------
// Delivery, in place.

// Whether the rows' byte flags can be read 4 slots a lane: the row's ends
// and both arrays 4-byte aligned.
__device__ __forceinline__ bool words(const uint8_t* a, const uint8_t* b,
                                      int64_t s0, int64_t s1) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           (uintptr_t)s0 | (uintptr_t)s1) & 3u) == 0;
}

// The flags (0 or 1 a byte, as bool tensors hold them) of slots s to s + 3
// as one word, byte b for slot s + b; slots at or past s1 read 0.
__device__ __forceinline__ uint32_t flags4(const uint8_t* a, int64_t s,
                                           int64_t s1, bool word) {
  if (word) return *reinterpret_cast<const uint32_t*>(a + s) & 0x01010101u;
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (s + b < s1) v |= (uint32_t)(a[s + b] != 0) << (8 * b);
  return v;
}

// Staging: a mover's record at its place in its destination row's bucket,
// 8 words (two 16-byte stores): source slot, x, y, vx, vy, m, pid, 0.
__device__ __forceinline__ void stage_mover(int* stage, int64_t b, int64_t s,
                                            const float* x, const float* y,
                                            const float* vx, const float* vy,
                                            const float* m, const int* pid) {
  int4* rec = reinterpret_cast<int4*>(stage) + 2 * b;
  rec[0] = make_int4((int)s, __float_as_int(x[s]), __float_as_int(y[s]),
                     __float_as_int(vx[s]));
  rec[1] = make_int4(__float_as_int(vy[s]), __float_as_int(m[s]), pid[s], 0);
}

// A delivery limited to the slots at[0..n) (ascending): their moving flags
// and destinations scattered into pool-wide arrays (moving_pool zeroed
// first), so that the same passes deliver them.
__global__ void deliver_expand_kernel(const int64_t* __restrict__ at, int n,
                                      const uint8_t* __restrict__ moving,
                                      const int* __restrict__ dest,
                                      uint8_t* __restrict__ moving_pool,
                                      int* __restrict__ dest_pool) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = at[i];
  moving_pool[s] = moving[i];
  dest_pool[s] = dest[i];
}

// Delivery, pass 1 (a warp a row, 4 slots a lane): the row's free slots
// after this step's departures (empty, or a mover's) and its departures;
// its arrival cursor and the undelivered count zeroed for pass 2.
//
// Bound: bytes, occ and moving read a slot, 16 written a row.
__global__ void deliver_count_kernel(const uint8_t* __restrict__ occ,
                                     const uint8_t* __restrict__ moving,
                                     const int64_t* __restrict__ row_start,
                                     int nrows, int* __restrict__ nfree,
                                     int* __restrict__ ndep,
                                     int* __restrict__ cursor,
                                     int* __restrict__ undelivered) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  const bool word = words(occ, moving, s0, s1);
  int nf = 0, nd = 0;
  for (int64_t s = s0 + 4 * lane; s < s1; s += 128) {
    const uint32_t o = flags4(occ, s, s1, word);
    const uint32_t mv = flags4(moving, s, s1, word);
    // A slot past s1 reads o = 0, mv = 0: not free. Count only slots < s1.
    const uint32_t in = s1 - s >= 4 ? 0x01010101u
                                    : (1u << (8 * (int)(s1 - s))) - 1u;
    nf += __popc(((o ^ 0x01010101u) | mv) & in & 0x01010101u);
    nd += __popc(mv);
  }
  nf = warp_sum(nf);
  nd = warp_sum(nd);
  if (lane == 0) {
    nfree[r] = nf;
    ndep[r] = nd;
    cursor[r] = 0;
    if (r == 0) *undelivered = 0;
  }
}

// Delivery, pass 2 (a warp a row, 4 slots a lane; a row with no departure
// returns at once): each mover of the row takes the next place of its
// destination row's bucket (an integer atomic; pass 3 ranks the bucket by
// source slot); a mover within the row's free slots is staged there, with
// its six fields, before any tile is written; one beyond them adds to
// undelivered.
//
// Bound: bytes, a row's departures read, moving read a slot of a row with
// departures; a mover's destination, its six fields read and its 32-byte
// record written.
__global__ void deliver_stage_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ m, const int* __restrict__ pid,
    const uint8_t* __restrict__ moving, const int* __restrict__ dest,
    const int64_t* __restrict__ row_start, int nrows,
    const int* __restrict__ nfree, const int* __restrict__ ndep,
    int* __restrict__ cursor, int* __restrict__ stage,
    int* __restrict__ undelivered) {
  const int r = warp_row(nrows);
  if (r < 0 || ndep[r] == 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  const bool word = words(moving, moving, s0, s1);
  for (int64_t s = s0 + 4 * lane; s < s1; s += 128) {
    const uint32_t mv = flags4(moving, s, s1, word);
    if (!mv) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (!((mv >> (8 * b)) & 1u)) continue;
      const int64_t src = s + b;
      const int d = dest[src];
      if (d < 0 || d >= nrows) continue;
      const int pos = atomicAdd(&cursor[d], 1);
      if (pos < nfree[d])
        stage_mover(stage, row_start[d] + pos, src, x, y, vx, vy, m, pid);
      else
        atomicAdd(undelivered, 1);
    }
  }
}

// Delivery, pass 3 (a warp a row), in place: when no mover is undelivered,
// on a row with arrivals or departures only, the row's c staged movers are
// ranked by source slot (rank = the count of smaller sources in the
// bucket, by shuffles), and the one of rank q lands in the row's q-th free
// slot in slot order (a warp scan of the free slots, 4 a lane, gives each
// its rank; that slot takes its mover's record: x, y, vx, vy, m, pid and
// occ); a departed slot that takes no arrival is cleared (occ 0, m 0; its
// other fields stay as they were). The warp reads and writes only its own
// row's slots, and stops once every arrival is placed and every departure
// seen. No slot is written when a mover is undelivered (all or nothing).
__global__ void deliver_place_kernel(
    float* __restrict__ x, float* __restrict__ y, float* __restrict__ vx,
    float* __restrict__ vy, float* __restrict__ m, int* __restrict__ pid,
    uint8_t* __restrict__ occ, const uint8_t* __restrict__ moving,
    const int64_t* __restrict__ row_start, int nrows,
    const int* __restrict__ ndep, const int* __restrict__ cursor,
    const int* __restrict__ stage, int* __restrict__ perm,
    const int* __restrict__ undelivered) {
  const int r = warp_row(nrows);
  if (r < 0 || *undelivered != 0) return;
  const int c = cursor[r];  // <= the row's free slots: none undelivered
  const int nd = ndep[r];
  if (c == 0 && nd == 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];

  for (int i0 = 0; i0 < c; i0 += 32) {
    const int i = i0 + lane;
    const int src = i < c ? stage[8 * (s0 + i)] : 0x7fffffff;
    int rank = 0;
    for (int j0 = 0; j0 < c; j0 += 32) {
      const int j = j0 + lane;
      const int other = j < c ? stage[8 * (s0 + j)] : 0x7fffffff;
#pragma unroll 8
      for (int k = 0; k < 32; ++k)
        rank += __shfl_sync(kFull, other, k) < src;
    }
    if (i < c) perm[s0 + rank] = i;
  }
  __syncwarp();

  const bool word = words(occ, moving, s0, s1);
  const int4* rec = reinterpret_cast<const int4*>(stage);
  int base = 0, seen = 0;  // free slots and departures before this chunk
  for (int64_t c0 = s0; c0 < s1; c0 += 128) {
    const int64_t s = c0 + 4 * lane;
    uint32_t o = 0, mv = 0;
    if (s < s1) {
      o = flags4(occ, s, s1, word);
      mv = flags4(moving, s, s1, word);
    }
    const uint32_t in = s >= s1 ? 0u
                        : s1 - s >= 4 ? 0x01010101u
                                      : (1u << (8 * (int)(s1 - s))) - 1u;
    const uint32_t fr = ((o ^ 0x01010101u) | mv) & in & 0x01010101u;
    const int nf = __popc(fr);
    const int incl = warp_scan(nf, lane);
    int q = base + incl - nf;
    base += __shfl_sync(kFull, incl, 31);
    seen += warp_sum(__popc(mv));
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (!((fr >> (8 * b)) & 1u)) continue;
      const int64_t t = s + b;
      if (q < c) {
        const int64_t e = s0 + perm[s0 + q];
        const int4 a = rec[2 * e], d = rec[2 * e + 1];
        x[t] = __int_as_float(a.y);
        y[t] = __int_as_float(a.z);
        vx[t] = __int_as_float(a.w);
        vy[t] = __int_as_float(d.x);
        m[t] = __int_as_float(d.y);
        pid[t] = d.z;
        occ[t] = 1;
      } else if ((mv >> (8 * b)) & 1u) {
        occ[t] = 0;
        m[t] = 0.0f;
      }
      ++q;
    }
    if (base >= c && seen >= nd) break;
  }
}

// ---------------------------------------------------------------------------
// The pair pass's masks, before it.

constexpr int kInf = 0x7fffffff;  // a first-pair rank: no partner
constexpr int kMaskThreads = 256;

// A slot's masks: mf = m where it is binned (occupied, in the box), else
// +0; alive = binned with m > 0 (1 or 0).
__device__ __forceinline__ void slot_masks(float x, float y, float m, bool o,
                                           float w, int nc, float* mf,
                                           int* alive) {
  int cell;
  const bool binned = o && cell_of(x, y, w, nc, &cell);
  *mf = binned ? m : 0.0f;
  *alive = binned && m > 0.0f;
}

// Replaces engine.py's physics_mass (the binned mask and mf) and the pair
// pass's alive mask (XLA, fused before the Pallas call there; some twenty
// plain torch passes in the port before). Elementwise: a thread takes the
// 4 slots 4 i to 4 i + 3, with one 16-byte load of each of x, y and m, one
// 4-byte load of the occ bytes and one 16-byte store each of mf and alive
// where every array is aligned for it (vec), else one slot at a time.
//
// Bound: bytes, 13 a slot read (x, y, m, occ) and 8 written (mf, alive).
__global__ void pair_masks_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  const float* __restrict__ m,
                                  const uint8_t* __restrict__ occ, int64_t n,
                                  float w, int nc, bool vec,
                                  float* __restrict__ mf,
                                  int* __restrict__ alive) {
  const int64_t s = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (s >= n) return;
  if (vec && n - s >= 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + s);
    const float4 yv = *reinterpret_cast<const float4*>(y + s);
    const float4 mv = *reinterpret_cast<const float4*>(m + s);
    const uint32_t o = *reinterpret_cast<const uint32_t*>(occ + s);
    float4 f;
    int4 a;
    slot_masks(xv.x, yv.x, mv.x, (o & 0xffu) != 0, w, nc, &f.x, &a.x);
    slot_masks(xv.y, yv.y, mv.y, (o & 0xff00u) != 0, w, nc, &f.y, &a.y);
    slot_masks(xv.z, yv.z, mv.z, (o & 0xff0000u) != 0, w, nc, &f.z, &a.z);
    slot_masks(xv.w, yv.w, mv.w, (o & 0xff000000u) != 0, w, nc, &f.w, &a.w);
    *reinterpret_cast<float4*>(mf + s) = f;
    *reinterpret_cast<int4*>(alive + s) = a;
    return;
  }
  for (int64_t t = s; t < s + 4 && t < n; ++t)
    slot_masks(x[t], y[t], m[t], occ[t] != 0, w, nc, &mf[t], &alive[t]);
}

// ---------------------------------------------------------------------------
// The step's tail and the next step's row sums, after the pair pass.

// Whether cell_of puts (x, y) on the grid, from the box's edges, without
// its divisions: its cell coordinate trunc(RN(x / w)) lies in [0, nc)
// exactly where RN(x / w) lies in (-1, nc), and RN(x / w) grows with x, so
// exactly where lo < x < hi for the float32 edges lo (the largest x with
// RN(x / w) <= -1) and hi (the smallest with RN(x / w) >= nc), which the
// host finds (ops/cuda/advance.py box_edges). A NaN converts to cell 0, on
// the grid, as in cell_of.
__device__ __forceinline__ bool in_box_edges(float x, float y, float lo,
                                             float hi) {
  return ((x > lo && x < hi) || x != x) && ((y > lo && y < hi) || y != y);
}

// The counters the tail updates, each given or null: collisions += count;
// overflow = max(overflow, undelivered > 0 ? ovf : 0); panics += the
// limbo slots (with the sums only).
struct Counters {
  long long* collisions;
  const int* count;
  int* overflow;
  const int* undelivered;
  int ovf;
  int* panics;
};

// Replaces the row sums of engine.py's mono_tables and the step's tail
// (m zeroed on the pass's deaths, the collision, panic and overflow
// counters; XLA there, a torch.where, a cast and three counter updates in
// the port before). A warp a row. Each slot: died = ft != INF; a dying
// slot's m becomes 0 in place; mf' = m' where the slot is binned; the row's
// M, sum m' x, sum m' y added in the order the port's row sums have
// always taken: lane l takes the slots l, l + 32, ... in turn, each product
// rounded to f32 before its add, then the fixed butterfly of warp_fsum. So
// the sums keep their bits, and with them every later bit of a run.
// Without sums (M null: a run's last step) only the deaths; without ft (a
// run's first pass, collide off) none. The counters are integers, summed in
// any order: a warp adds its row's limbo count to panics by an atomic, and
// one thread updates collisions and overflow, reading count and undelivered
// on the device (no host synchronisation).
//
// Design: the in-box test takes two compares an axis against the box's
// edges (in_box_edges) in place of cell_of's two IEEE divisions, the
// larger part of a slot's instructions. Loading a lane's next slots ahead
// of its adds (4 or 8 in flight), 4 to 16 rows a block, and the divisions
// were each measured slower (PERF.md section 6).
//
// Bound: bytes, 17 a slot read (x, y, m, ft: 4; occ: 1), 12 a row written
// and 4 a death.
__global__ void settle_sums_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   float* __restrict__ m,
                                   const uint8_t* __restrict__ occ,
                                   const int* __restrict__ ft,
                                   const int64_t* __restrict__ row_start,
                                   int nrows, float lo, float hi,
                                   float* __restrict__ M,
                                   float* __restrict__ SX,
                                   float* __restrict__ SY, Counters k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (k.count != nullptr) *k.collisions += *k.count;
    if (k.undelivered != nullptr) {
      const int v = *k.undelivered > 0 ? k.ovf : 0;
      if (v > *k.overflow) *k.overflow = v;
    }
  }
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  if (M == nullptr) {
    if (ft != nullptr)
      for (int64_t s = s0 + lane; s < s1; s += 32)
        if (ft[s] != kInf) m[s] = 0.0f;
    return;
  }
  float a = 0.0f, b = 0.0f, c = 0.0f;
  int lost = 0;
  for (int64_t s = s0 + lane; s < s1; s += 32) {
    const float xs = x[s], ys = y[s];
    float ms = m[s];
    const bool o = occ[s] != 0;
    if (ft != nullptr && ft[s] != kInf) {
      ms = 0.0f;
      m[s] = 0.0f;
    }
    const bool in_box = in_box_edges(xs, ys, lo, hi);
    const float mf = (o && in_box) ? ms : 0.0f;
    lost += o && !in_box;
    a = __fadd_rn(a, mf);
    b = __fadd_rn(b, __fmul_rn(mf, xs));
    c = __fadd_rn(c, __fmul_rn(mf, ys));
  }
  a = warp_fsum(a);
  b = warp_fsum(b);
  c = warp_fsum(c);
  lost = warp_sum(lost);
  if (lane == 0) {
    M[r] = a;
    SX[r] = b;
    SY[r] = c;
    if (lost && k.panics != nullptr) atomicAdd(k.panics, lost);
  }
}

bool whole_warps(int warps) { return warps >= 1 && warps <= kMaxWarps; }

unsigned row_blocks(int nrows, int warps) {
  return (unsigned)((nrows + warps - 1) / warps);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after its launches (cudaErrorInvalidValue, without a launch, for a shape
// it does not take). warps: warps a block, 1 to 32. Pool arrays are flat;
// row_start holds nrows + 1 int64 slot offsets.

// mf (floats) and alive (ints) of the n slots: the pair pass's masks.
extern "C" int psim_pair_masks(const float* x, const float* y, const float* m,
                               const uint8_t* occ, int64_t n, float w, int nc,
                               float* mf, int* alive, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(mf) |
                     reinterpret_cast<uintptr_t>(alive)) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(occ) & 3u) == 0;
  const int64_t quads = (n + 3) / 4;
  pair_masks_kernel<<<(unsigned)((quads + kMaskThreads - 1) / kMaskThreads),
                      kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, m, occ, n, w, nc, vec, mf, alive);
  return (int)cudaGetLastError();
}

// In place: m of the slots with ft != INF (ft null: none) set to 0;
// collisions (one int64) += *count and overflow (one int) = max(overflow,
// *undelivered > 0 ? ovf : 0), each where its pointers are given. With
// sums ((3, nrows) floats, M, sum m x, sum m y, after the deaths), panics
// (one int) += the limbo slots; without (null), neither. lo, hi: the box's
// edges (in_box_edges). The rows must cover the pool.
extern "C" int psim_settle_sums(const float* x, const float* y, float* m,
                                const uint8_t* occ, const int* ft,
                                const int64_t* row_start, int nrows, float lo,
                                float hi, float* sums, int* panics,
                                long long* collisions, const int* count,
                                int* overflow, const int* undelivered,
                                int ovf, int warps, void* stream) {
  if (!whole_warps(warps) || nrows < 1 ||
      (count != nullptr && collisions == nullptr) ||
      (undelivered != nullptr && overflow == nullptr))
    return (int)cudaErrorInvalidValue;
  float* M = sums;
  float* SX = sums == nullptr ? nullptr : sums + nrows;
  float* SY = sums == nullptr ? nullptr : sums + 2 * (size_t)nrows;
  const Counters k{collisions, count, overflow, undelivered, ovf,
                   sums == nullptr ? nullptr : panics};
  settle_sums_kernel<<<row_blocks(nrows, warps), 32 * warps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, m, occ, ft, row_start, nrows, lo, hi, M, SX, SY, k);
  return (int)cudaGetLastError();
}

// In place: x, y, vx, vy of the live slots (m != 0); dest (ints) and
// moving (bytes) written for every slot. sums: (3, nrows) floats as
// psim_settle_sums writes them; nrows must be nc * nc (row r is cell r).
extern "C" int psim_monopole_integrate(
    float* x, float* y, float* vx, float* vy, const float* m,
    const uint8_t* occ, const float* fxd, const float* fyd, const float* sums,
    const int64_t* row_start, int nrows, float w, int nc, float side,
    float dt, float g, int* dest, uint8_t* moving, int warps, void* stream) {
  if (!whole_warps(warps) || nc < 1 || nrows != nc * nc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pool f{x, y, vx, vy, m, occ, fxd, fyd, dest, moving};
  const Grid p{w, side, 2.0f * side, dt, g, nc};
  monopole_integrate_kernel<<<row_blocks(nrows, warps), 32 * warps, 0, s>>>(
      f, sums, sums + nrows, sums + 2 * (size_t)nrows, row_start, nrows, p);
  return (int)cudaGetLastError();
}

// In place: x, y, vx, vy of the live slots (m != 0) of the pool's rows,
// given as nruns runs of run_rows[j] rows of run_k[j] slots (host arrays,
// covering the pool; a launch for each kMaxRuns runs), under the monopole
// mass mf, the pair force (fxd, fyd) and the 8 stencil terms of each row's
// table index in (ml, mxl, myl) (sidx, sdir, nidx, sentinel: the Tables
// above): row_idx[r] (int64), or r where row_idx is null; gathered:
// monopole_gathered's form (a term with neighbour mass 0 dropped), else
// monopole_tile_forces'. binned (bytes, or null): a slot where it is 0
// takes the sentinel. *launched: the launches made.
extern "C" int psim_monopole_rows(
    float* x, float* y, float* vx, float* vy, const float* m, const float* mf,
    const float* fxd, const float* fyd, const float* ml, const float* mxl,
    const float* myl, int64_t sidx, int64_t sdir, int64_t nidx,
    int64_t sentinel, const int64_t* row_idx, const uint8_t* binned,
    int nruns, const int64_t* run_rows, const int* run_k, int gathered,
    float side, float dt, float g, int* launched, void* stream) {
  *launched = 0;
  if (nidx < 1 || sentinel < 0 || sentinel >= nidx || nruns < 1 ||
      run_rows == nullptr || run_k == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nruns; ++j)
    if (run_rows[j] < 0 || run_k[j] < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MeshPool f{x, y, vx, vy, m, mf, fxd, fyd};
  const Tables tb{ml, mxl, myl, sidx, sdir, nidx, sentinel};
  const Grid p{0.0f, side, 2.0f * side, dt, g, 0};
  int64_t slot = 0, row = 0;
  for (int j0 = 0; j0 < nruns; j0 += kMaxRuns) {
    Runs rn;
    rn.n = 0;
    for (int j = j0; j < nruns && j < j0 + kMaxRuns; ++j) {
      rn.slot0[rn.n] = slot;
      rn.row0[rn.n] = row;
      rn.K[rn.n] = run_k[j];
      slot += run_rows[j] * run_k[j];
      row += run_rows[j];
      ++rn.n;
    }
    rn.slot0[rn.n] = slot;
    const int64_t n = slot - rn.slot0[0];
    if (n < 1) continue;
    const unsigned blocks = (unsigned)((n + kSlotThreads - 1) / kSlotThreads);
    if (gathered)
      monopole_pool_kernel<true><<<blocks, kSlotThreads, 0, s>>>(
          f, tb, rn, row_idx, binned, p);
    else
      monopole_pool_kernel<false><<<blocks, kSlotThreads, 0, s>>>(
          f, tb, rn, row_idx, binned, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

// In place: x, y, vx, vy of the live slots (m != 0) of a super-cell pool
// of nrows rows of kcap slots, under the monopole mass mf, the pair force
// (fxd, fyd) and the 8 stencil terms of each slot's cell (cell: int64
// where cell64, else int32; outside [0, ncells) the zero sentinel), built
// from the cell sums (M, SX, SY: ncells floats each) as the Super above
// says: row0 null for one device's (nc, nc) grid (nrows = nsc * nsc, nsc
// = ceil(nc / S), ncells = nc * nc); else a mesh of L blocks of R cell
// rows (ncells = L * R * nc), each shard's rows_t pool rows, its first
// global row and owned rows (row0, rows: L int64 each), its received
// lines (top, bot: (L, 1, 3, nc) floats). zero: a 0 the offsets add.
// A block stages its box where it fits in kStageBytes (S <= 62); past
// that every slot builds its terms from the sums.
extern "C" int psim_monopole_supercell(
    float* x, float* y, float* vx, float* vy, const float* m, const float* mf,
    const float* fxd, const float* fyd, const void* cell, int cell64,
    int nrows, int kcap, const float* M, const float* SX, const float* SY,
    int64_t ncells, int nc, int S, int L, int R, int rows_t,
    const int64_t* row0, const int64_t* rows, const float* top,
    const float* bot, float side, float zero, float dt, float g,
    void* stream) {
  if (nrows < 1 || kcap < 1 || nc < 1 || S < 1 || ncells < 1 ||
      ncells > INT32_MAX ||
      (row0 != nullptr && (L < 1 || R < 1 || rows_t < 1 || rows == nullptr ||
                           top == nullptr || bot == nullptr ||
                           nrows != L * rows_t || ncells != (int64_t)L * R * nc)))
    return (int)cudaErrorInvalidValue;
  const int nsc = (nc + S - 1) / S;
  if (row0 == nullptr && (nrows != nsc * nsc || ncells != (int64_t)nc * nc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MeshPool f{x, y, vx, vy, m, mf, fxd, fyd};
  Super sg;
  sg.M = M;
  sg.SX = SX;
  sg.SY = SY;
  sg.ncells = ncells;
  sg.nc = nc;
  sg.S = S;
  sg.nsc = nsc;
  sg.L = row0 != nullptr ? L : 1;
  sg.R = row0 != nullptr ? R : nc;
  sg.rows_t = row0 != nullptr ? rows_t : nrows;
  sg.row0 = row0;
  sg.rows = rows;
  sg.top = top;
  sg.bot = bot;
  sg.side = side;
  sg.zero = zero;
  const Grid p{0.0f, side, 2.0f * side, dt, g, 0};
  // The box of a full super-cell.
  const int64_t box = 3 * (int64_t)(S + 2) * (S + 2) * sizeof(float);
  const bool stage = box <= kStageBytes;
  const size_t smem = stage ? (size_t)box : 0;
  const int threads =
      kcap >= kSuperThreads ? kSuperThreads : (kcap + 31) / 32 * 32;
  if (cell64)
    monopole_supercell_kernel<int64_t><<<nrows, threads, smem, s>>>(
        f, static_cast<const int64_t*>(cell), kcap, sg, stage, p);
  else
    monopole_supercell_kernel<int><<<nrows, threads, smem, s>>>(
        f, static_cast<const int*>(cell), kcap, sg, stage, p);
  return (int)cudaGetLastError();
}

// In place: x, y, vx, vy, m, pid (4 bytes) and occ (1) of the pool.
// dest: the movers' destination rows (int32). With at (n_at slots,
// ascending), moving and dest are given for those slots alone and are
// first scattered into moving_pool (nslots bytes) and dest_pool (nslots
// ints); else they are pool-wide and moving_pool, dest_pool go unused.
// scratch: 3 nrows + 1 ints (free slots, departures, cursors, undelivered);
// stage: 8 nslots ints (16-byte aligned); perm: nslots ints.
// undelivered (scratch[3 nrows]) counts the movers beyond their rows' free
// slots; when it is not 0 no slot is written.
extern "C" int psim_deliver(
    float* x, float* y, float* vx, float* vy, float* m, int* pid,
    uint8_t* occ, const uint8_t* moving, const int* dest,
    const int64_t* row_start, int nrows, int64_t nslots, const int64_t* at,
    int n_at, uint8_t* moving_pool, int* dest_pool, int* scratch, int* stage,
    int* perm, int warps, void* stream) {
  if (!whole_warps(warps) || nrows < 1 || nslots >= (int64_t)1 << 31 ||
      n_at < 0 || (reinterpret_cast<uintptr_t>(stage) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* nfree = scratch;
  int* ndep = scratch + nrows;
  int* cursor = scratch + 2 * (size_t)nrows;
  int* undelivered = scratch + 3 * (size_t)nrows;
  if (at != nullptr) {
    cudaMemsetAsync(moving_pool, 0, (size_t)nslots, s);
    if (n_at > 0)
      deliver_expand_kernel<<<(unsigned)((n_at + 255) / 256), 256, 0, s>>>(
          at, n_at, moving, dest, moving_pool, dest_pool);
    moving = moving_pool;
    dest = dest_pool;
  }
  const unsigned blocks = row_blocks(nrows, warps);
  const unsigned threads = 32u * warps;
  deliver_count_kernel<<<blocks, threads, 0, s>>>(occ, moving, row_start,
                                                  nrows, nfree, ndep, cursor,
                                                  undelivered);
  deliver_stage_kernel<<<blocks, threads, 0, s>>>(
      x, y, vx, vy, m, pid, moving, dest, row_start, nrows, nfree, ndep,
      cursor, stage, undelivered);
  deliver_place_kernel<<<blocks, threads, 0, s>>>(
      x, y, vx, vy, m, pid, occ, moving, row_start, nrows, ndep, cursor,
      stage, perm, undelivered);
  return (int)cudaGetLastError();
}
