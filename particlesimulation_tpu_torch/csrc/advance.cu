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
//   monopole_integrate_kernel: each slot's 8 stencil monopole terms from
//     its cell's neighbours' sums, the pair force carried from the last pair
//     pass added, the explicit integrator with the periodic wrap, and the
//     slot's destination row and moving flag;
//   deliver_count_kernel, deliver_bucket_kernel, deliver_place_kernel (and
//     deliver_expand_kernel for a delivery limited to given slots): every
//     mover lands in its destination row's rank-th free slot, in one pass.
//
// They replace XLA code of the JAX package, which has no Pallas kernel for
// this phase (its Pallas rebin was retired, since a TPU punishes scatters):
// the row sums of engine.py's mono_tables, ops/stencil.py stencil_tables,
// ops/dense_xla.py monopole_tile_forces, ops/integrate.py integrate, and
// ops/resident.py rebin (the port's one-pass form of it, deliver).
//
// What bounds them on an H100: bytes. Each slot's fields are read once and
// the outputs written once (about 13 bytes a slot for the sums, 50 for the
// monopole and integrate pass); the arithmetic (8 terms of ~14 flops and an
// rsqrt a slot) is far below the f32 rate. The delivery needs only occ and
// the moving flag a slot and ~58 bytes a mover, but this first form writes
// new tiles (51 bytes a slot); moving only the movers in place is the next
// step. A warp works on one row at a time, its lanes on neighbouring
// slots, so every load is coalesced.
//
// The same bits as the plain torch versions, where the contract asks for
// them:
//   * monopole_integrate_kernel gives, from the same per-row sums, the bits
//     of the eager composition com_from_sums -> stencil tables ->
//     monopole_tile_forces -> fxd + fxm -> integrate -> cell_of. Eager torch
//     rounds every operation to f32, so each one here is a separate
//     correctly rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn; the
//     library is also built with -fmad=false), IEEE division (torch divides
//     by a tensor on the device with '/', not by a reciprocal), fmodf, and
//     rsqrtf: torch's CUDA rsqrt of a float is ::rsqrtf
//     (c10/cuda/CUDAMathCompat.h, rsqrt(float)), not 1 / sqrtf;
//   * the delivery places every mover where the plain deliver does, and
//     writes every field of every slot as it does, holes included: slot
//     order decides the fused pair kernel's summation order, so a placement
//     in the order of arrival would change the forces' low bits from run to
//     run;
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

// Per slot of row r (the cell r of an nc x nc grid): the 8 stencil monopole
// terms of ops/dense.py monopole_tile_forces from the neighbours' (M, SX,
// SY), added in stencil order to 0; the pair force fxd, fyd added; the
// explicit step of ops/integrate.py (m == 0 slots frozen); then the new
// position's cell: dest = cy * nc + cx, and moving = occupied, in the box
// and dest != r. A warp a row: lanes 0-7 build the row's 8 temp cells (the
// neighbour's COM by IEEE division, offset + neighbour COM at the mirrored
// edges, as ops/stencil.py stencil_tables does with rolls), and the warp
// shares them by shuffles.
//
// Every operation is one correctly rounded f32 operation in the plain
// version's order and association, so the outputs are its bits.
//
// Bound: bytes, 29 a slot read (x, y, vx, vy, m, fxd, fyd, occ) and 21
// written (x, y, vx, vy, dest, moving); the rows' sums are read from L2.
__global__ void monopole_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ m, const uint8_t* __restrict__ occ,
    const float* __restrict__ fxd, const float* __restrict__ fyd,
    const float* __restrict__ M, const float* __restrict__ SX,
    const float* __restrict__ SY, const int64_t* __restrict__ row_start,
    int nrows, float w, int nc, float side, float dt, float g,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, int* __restrict__ dest,
    uint8_t* __restrict__ moving) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int cx = r % nc, cy = r / nc;

  // The temp cell of direction l on lane l (ops/stencil.py: neighbour
  // (cy + dy, cx + dx) wrapped, as torch.roll wraps; its COM, 0 where it
  // holds no mass; +-side at the mirrored edges, added as offset + COM).
  float cm = 0.0f, tmx = 0.0f, tmy = 0.0f;
  if (lane < 8) {
    const int dx = kStencil[lane][0], dy = kStencil[lane][1];
    int nx = cx + dx, ny = cy + dy;
    nx = nx < 0 ? nx + nc : (nx >= nc ? nx - nc : nx);
    ny = ny < 0 ? ny + nc : (ny >= nc ? ny - nc : ny);
    const int nb = ny * nc + nx;
    const float mn = M[nb];
    const bool has = mn > 0.0f;
    const float safe = has ? mn : 1.0f;
    const float mx = has ? __fdiv_rn(SX[nb], safe) : 0.0f;
    const float my = has ? __fdiv_rn(SY[nb], safe) : 0.0f;
    const float offx = dx == 1    ? (cx == nc - 1 ? side : 0.0f)
                       : dx == -1 ? (cx == 0 ? -side : 0.0f)
                                  : 0.0f;
    const float offy = dy == 1    ? (cy == nc - 1 ? side : 0.0f)
                       : dy == -1 ? (cy == 0 ? -side : 0.0f)
                                  : 0.0f;
    cm = mn;
    tmx = __fadd_rn(offx, mx);
    tmy = __fadd_rn(offy, my);
  }
  float cml[8], mxl[8], myl[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    cml[l] = __shfl_sync(kFull, cm, l);
    mxl[l] = __shfl_sync(kFull, tmx, l);
    myl[l] = __shfl_sync(kFull, tmy, l);
  }

  const int64_t s1 = row_start[r + 1];
  for (int64_t s = row_start[r] + lane; s < s1; s += 32) {
    const float xs = x[s], ys = y[s], vxs = vx[s], vys = vy[s], ms = m[s];
    const bool o = occ[s] != 0;
    int cell;
    const bool binned = o && cell_of(xs, ys, w, nc, &cell);
    const float gm = __fmul_rn(g, binned ? ms : 0.0f);
    float fx = 0.0f, fy = 0.0f;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float dxl = __fsub_rn(mxl[l], xs);
      const float dyl = __fsub_rn(myl[l], ys);
      const float d2 = __fadd_rn(__fmul_rn(dxl, dxl), __fmul_rn(dyl, dyl));
      const float inv = d2 > 0.0f ? rsqrtf(d2) : 0.0f;
      const float sl = __fmul_rn(__fmul_rn(gm, cml[l]),
                                 __fmul_rn(__fmul_rn(inv, inv), inv));
      fx = __fadd_rn(fx, __fmul_rn(sl, dxl));
      fy = __fadd_rn(fy, __fmul_rn(sl, dyl));
    }
    const float tfx = __fadd_rn(fxd[s], fx);
    const float tfy = __fadd_rn(fyd[s], fy);
    // x += vx*dt + 0.5*ax*dt*dt as ((vx*dt) + (((0.5*ax)*dt)*dt)).
    const bool frozen = ms == 0.0f;
    const float safe_m = frozen ? 1.0f : ms;
    const float ax = __fdiv_rn(tfx, safe_m);
    const float ay = __fdiv_rn(tfy, safe_m);
    float nx = __fadd_rn(xs, __fadd_rn(__fmul_rn(vxs, dt),
                                       __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ax),
                                                           dt), dt)));
    float ny = __fadd_rn(ys, __fadd_rn(__fmul_rn(vys, dt),
                                       __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ay),
                                                           dt), dt)));
    const float nvx = __fadd_rn(vxs, __fmul_rn(ax, dt));
    const float nvy = __fadd_rn(vys, __fmul_rn(ay, dt));
    nx = fmodf(__fadd_rn(nx, side), side);
    ny = fmodf(__fadd_rn(ny, side), side);
    if (frozen) {
      nx = xs;
      ny = ys;
    }
    ox[s] = nx;
    oy[s] = ny;
    ovx[s] = frozen ? vxs : nvx;
    ovy[s] = frozen ? vys : nvy;
    int to;
    const bool in_box = cell_of(nx, ny, w, nc, &to);
    dest[s] = to;
    moving[s] = o && in_box && to != r;
  }
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

// Delivery, pass 1 (a warp a row): the row's free slots after this step's
// departures (empty, or a mover's), and one count for each mover on its
// destination row (integer atomics: the counts do not depend on the order).
__global__ void deliver_count_kernel(const uint8_t* __restrict__ occ,
                                     const uint8_t* __restrict__ moving,
                                     const int* __restrict__ dest,
                                     const int64_t* __restrict__ row_start,
                                     int nrows, int* __restrict__ nfree,
                                     int* __restrict__ cnt) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s1 = row_start[r + 1];
  int nf = 0;
  for (int64_t s = row_start[r] + lane; s < s1; s += 32) {
    const bool mv = moving[s] != 0;
    nf += !occ[s] || mv;
    if (mv) {
      const int d = dest[s];
      if (d >= 0 && d < nrows) atomicAdd(&cnt[d], 1);
    }
  }
  nf = warp_sum(nf);
  if (lane == 0) nfree[r] = nf;
}

// Delivery, pass 2 (a warp a row): each mover of the row written into its
// destination row's bucket (the bucket array's slots of that row, in the
// order of the atomics; pass 3 sorts them), at most as many as the row has
// slots; and the movers beyond the row's free slots added to undelivered.
__global__ void deliver_bucket_kernel(const uint8_t* __restrict__ moving,
                                      const int* __restrict__ dest,
                                      const int64_t* __restrict__ row_start,
                                      int nrows,
                                      const int* __restrict__ nfree,
                                      const int* __restrict__ cnt,
                                      int* __restrict__ cursor,
                                      int* __restrict__ bucket,
                                      int* __restrict__ undelivered) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t s1 = row_start[r + 1];
  for (int64_t s = row_start[r] + lane; s < s1; s += 32) {
    if (!moving[s]) continue;
    const int d = dest[s];
    if (d < 0 || d >= nrows) continue;
    const int pos = atomicAdd(&cursor[d], 1);
    const int64_t b0 = row_start[d];
    if (pos < row_start[d + 1] - b0) bucket[b0 + pos] = (int)s;
  }
  if (lane == 0) {
    const int over = cnt[r] - nfree[r];
    if (over > 0) atomicAdd(undelivered, over);
  }
}

// Delivery, pass 3 (a warp a row), into new tiles: when no mover is
// undelivered, the row's c movers are ranked by source slot (rank = the
// count of smaller sources in the bucket) and the one of rank q lands in
// the row's q-th free slot, in slot order (a ballot a 32 slots gives each
// free slot its rank, and that slot pulls its mover's fields). Every slot
// of the row is written: an arrival's fields (occupied); a departed mover's
// own stale fields (empty, m 0); else its own fields (m 0 where empty).
// When a mover is undelivered nothing moves (all or nothing). The inputs
// are only read, so a slot that a mover leaves in this step can take an
// arrival with no staging.
__global__ void deliver_place_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ m, const int* __restrict__ pid,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ moving,
    const int64_t* __restrict__ row_start, int nrows,
    const int* __restrict__ cnt, const int* __restrict__ bucket,
    int* __restrict__ sorted, const int* __restrict__ undelivered,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, float* __restrict__ om, int* __restrict__ opid,
    uint8_t* __restrict__ oocc) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const bool act = *undelivered == 0;
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  const int c = act ? cnt[r] : 0;  // <= the row's free slots when act
  for (int i = lane; i < c; i += 32) {
    const int b = bucket[s0 + i];
    int rank = 0;
    for (int j = 0; j < c; ++j) rank += bucket[s0 + j] < b;
    sorted[s0 + rank] = b;
  }
  __syncwarp();
  int base = 0;  // free slots of the row before this chunk
  for (int64_t c0 = s0; c0 < s1; c0 += 32) {
    const int64_t s = c0 + lane;
    const bool in = s < s1;
    const bool o = in && occ[s] != 0;
    const bool mv = in && moving[s] != 0;
    const bool free = in && (!o || mv);
    const unsigned mask = __ballot_sync(kFull, free);
    const int q = base + __popc(mask & ((1u << lane) - 1u));
    base += __popc(mask);
    if (!in) continue;
    int64_t src = s;
    bool now = o;
    if (free && q < c) {
      src = sorted[s0 + q];
      now = true;
    } else if (act && mv) {
      now = false;
    }
    ox[s] = x[src];
    oy[s] = y[src];
    ovx[s] = vx[src];
    ovy[s] = vy[src];
    opid[s] = pid[src];
    om[s] = now ? m[src] : 0.0f;
    oocc[s] = now;
  }
}

bool whole_warps(int warps) { return warps >= 1 && warps <= kMaxWarps; }

unsigned row_blocks(int nrows, int warps) {
  return (unsigned)((nrows + warps - 1) / warps);
}

cudaError_t deliver_passes(const float* x, const float* y, const float* vx,
                           const float* vy, const float* m, const int* pid,
                           const uint8_t* occ, const uint8_t* moving,
                           const int* dest, const int64_t* row_start,
                           int nrows, int* nfree, int* cnt, int* cursor,
                           int* bucket, int* sorted, int* undelivered,
                           float* ox, float* oy, float* ovx, float* ovy,
                           float* om, int* opid, uint8_t* oocc, int warps,
                           cudaStream_t s) {
  const unsigned blocks = row_blocks(nrows, warps);
  const unsigned threads = 32u * warps;
  deliver_count_kernel<<<blocks, threads, 0, s>>>(occ, moving, dest,
                                                  row_start, nrows, nfree,
                                                  cnt);
  deliver_bucket_kernel<<<blocks, threads, 0, s>>>(
      moving, dest, row_start, nrows, nfree, cnt, cursor, bucket,
      undelivered);
  deliver_place_kernel<<<blocks, threads, 0, s>>>(
      x, y, vx, vy, m, pid, occ, moving, row_start, nrows, cnt, bucket,
      sorted, undelivered, ox, oy, ovx, ovy, om, opid, oocc);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after its launches (cudaErrorInvalidValue, without a launch, for a shape
// it does not take). warps: rows (warps) a block, 1 to 32. Pool arrays are
// flat; row_start holds nrows + 1 int64 slot offsets.

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

// sums: (3, nrows) floats as psim_cell_sums_rows writes them; nrows must be
// nc * nc (row r is cell r).
extern "C" int psim_monopole_integrate(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* m, const uint8_t* occ, const float* fxd, const float* fyd,
    const float* sums, const int64_t* row_start, int nrows, float w, int nc,
    float side, float dt, float g, float* ox, float* oy, float* ovx,
    float* ovy, int* dest, uint8_t* moving, int warps, void* stream) {
  if (!whole_warps(warps) || nc < 1 || nrows != nc * nc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  monopole_integrate_kernel<<<row_blocks(nrows, warps), 32 * warps, 0, s>>>(
      x, y, vx, vy, m, occ, fxd, fyd, sums, sums + nrows,
      sums + 2 * (size_t)nrows, row_start, nrows, w, nc, side, dt, g, ox, oy,
      ovx, ovy, dest, moving);
  return (int)cudaGetLastError();
}

// dest: the movers' destination rows (int32).
// With at (n_at slots, ascending), moving and dest are given for those
// slots alone and are first scattered into moving_pool (nslots bytes) and
// dest_pool (nslots ints); else they are pool-wide and moving_pool,
// dest_pool go unused. scratch: 3 nrows + 1 ints (counts, cursors,
// undelivered, free counts); bucket, sorted: nslots ints each.
// undelivered (scratch[2 nrows]) counts the movers beyond their rows' free
// slots; when it is not 0 the output tiles are the input tiles (m 0 where
// empty).
extern "C" int psim_deliver(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* m, const int* pid, const uint8_t* occ,
    const uint8_t* moving, const int* dest, const int64_t* row_start,
    int nrows, int64_t nslots, const int64_t* at, int n_at,
    uint8_t* moving_pool, int* dest_pool, int* scratch, int* bucket,
    int* sorted, float* ox, float* oy, float* ovx, float* ovy, float* om,
    int* opid, uint8_t* oocc, int warps, void* stream) {
  if (!whole_warps(warps) || nrows < 1 || nslots >= (int64_t)1 << 31 ||
      n_at < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt = scratch;
  int* cursor = scratch + nrows;
  int* undelivered = scratch + 2 * (size_t)nrows;
  int* nfree = undelivered + 1;
  cudaMemsetAsync(scratch, 0, (2 * (size_t)nrows + 1) * sizeof(int), s);
  if (at != nullptr) {
    cudaMemsetAsync(moving_pool, 0, (size_t)nslots, s);
    if (n_at > 0)
      deliver_expand_kernel<<<(unsigned)((n_at + 255) / 256), 256, 0, s>>>(
          at, n_at, moving, dest, moving_pool, dest_pool);
    moving = moving_pool;
    dest = dest_pool;
  }
  return (int)deliver_passes(x, y, vx, vy, m, pid, occ, moving, dest,
                             row_start, nrows, nfree, cnt, cursor, bucket,
                             sorted, undelivered, ox, oy, ovx, ovy, om, opid,
                             oocc, warps, s);
}
