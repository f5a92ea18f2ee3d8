// The tile step's advance phase on a pool of slot rows, for Hopper (sm_90a).
//
// A slot-resident engine keeps its particles in rows of slots, one row per
// cell of the grid; row r holds the slots row_start[r] to row_start[r + 1]
// of flat per-field arrays (rows of one width K in the resident engine, of
// each band's K in the banded engine's pool). Between two fused pair passes
// a step runs its advance phase:
//
//   cell_sums_rows_kernel: each row's M, sum m x and sum m y over its binned
//     slots (occupied, and in the box by the C truncation of x / w), and the
//     count of the occupied slots out of the box (limbo);
//   monopole_integrate_kernel: in place, each live slot's 8 stencil
//     monopole terms from its cell's neighbours' sums, the pair force
//     carried from the last pair pass added, the explicit integrator with
//     the periodic wrap; and every slot's destination row and moving flag;
//   deliver_count_kernel, deliver_stage_kernel, deliver_place_kernel (and
//     deliver_expand_kernel for a delivery limited to given slots): in
//     place, every mover lands in its destination row's rank-th free slot,
//     and only the movers' slots are written.
//
// They replace XLA code of the JAX package, which has no Pallas kernel for
// this phase (its Pallas rebin was retired, since a TPU punishes scatters):
// the row sums of engine.py's mono_tables, ops/stencil.py stencil_tables,
// ops/dense_xla.py monopole_tile_forces, ops/integrate.py integrate, and
// ops/resident.py rebin (the port's one-pass form of it, deliver).
//
// What bounds them on an H100: bytes, and for the monopole pass the issue
// of ~300 f32 instructions a live slot. The cell sums read 13 bytes a slot.
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
//   * the row sums add in a fixed order (a warp a row, lane l the slots
//     l, l + 32, ... in turn, then a butterfly of shuffles), so two runs
//     give the same bits; the order is not torch.sum's, which they match
//     within (K 2^-24) of the sum of the terms' magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Each row's M, sum m x, sum m y over its binned slots (m x and m y rounded
// to f32 first, as torch.mul does), into M[r], SX[r], SY[r]; the occupied
// slots out of the box add to *limbo. A warp a row: lane l adds the slots
// l, l + 32, ... of the row in turn, then the warp adds the 32 partial sums
// in a fixed butterfly.
//
// Bound: bytes, 13 a slot read (x, y, m, occ) and 12 a row written.
__global__ void cell_sums_rows_kernel(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ m,
                                      const uint8_t* __restrict__ occ,
                                      const int64_t* __restrict__ row_start,
                                      int nrows, float w, int nc,
                                      float* __restrict__ M,
                                      float* __restrict__ SX,
                                      float* __restrict__ SY,
                                      int* __restrict__ limbo) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s1 = row_start[r + 1];
  float a = 0.0f, b = 0.0f, c = 0.0f;
  int lost = 0;
  for (int64_t s = row_start[r] + lane; s < s1; s += 32) {
    const float xs = x[s], ys = y[s];
    const bool o = occ[s] != 0;
    int cell;
    const bool in_box = cell_of(xs, ys, w, nc, &cell);
    const float mf = (o && in_box) ? m[s] : 0.0f;
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
    if (lost) atomicAdd(limbo, lost);
  }
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

// One slot's step: the 8 stencil terms of ops/dense.py
// monopole_tile_forces from the row's temp cells, added in stencil order
// to 0; the pair force added; the explicit step of ops/integrate.py (m == 0
// slots frozen: their state comes out as it went in). Every operation is
// one correctly rounded f32 operation in the plain version's order and
// association.
__device__ __forceinline__ Next step(const Slot& in, const Temps& t,
                                     const Grid& p) {
  int cell;
  const bool binned = in.o && cell_of(in.x, in.y, p.w, p.nc, &cell);
  const float gm = __fmul_rn(p.g, binned ? in.m : 0.0f);
  float fx = 0.0f, fy = 0.0f;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const float dxl = __fsub_rn(t.mx[l], in.x);
    const float dyl = __fsub_rn(t.my[l], in.y);
    const float d2 = __fadd_rn(__fmul_rn(dxl, dxl), __fmul_rn(dyl, dyl));
    const float inv = d2 > 0.0f ? rsqrtf(d2) : 0.0f;
    const float sl = __fmul_rn(__fmul_rn(gm, t.cm[l]),
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

// out: (3, nrows) floats, M, sum m x, sum m y; limbo: one int.
extern "C" int psim_cell_sums_rows(const float* x, const float* y,
                                   const float* m, const uint8_t* occ,
                                   const int64_t* row_start, int nrows,
                                   float w, int nc, float* out, int* limbo,
                                   int warps, void* stream) {
  if (!whole_warps(warps) || nrows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(limbo, 0, sizeof(int), s);
  cell_sums_rows_kernel<<<row_blocks(nrows, warps), 32 * warps, 0, s>>>(
      x, y, m, occ, row_start, nrows, w, nc, out, out + nrows,
      out + 2 * (size_t)nrows, limbo);
  return (int)cudaGetLastError();
}

// In place: x, y, vx, vy of the live slots (m != 0); dest (ints) and
// moving (bytes) written for every slot. sums: (3, nrows) floats as
// psim_cell_sums_rows writes them; nrows must be nc * nc (row r is cell r).
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
