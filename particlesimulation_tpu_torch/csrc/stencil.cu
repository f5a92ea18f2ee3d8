// The monopole stencil tables for Hopper (sm_90a): from per-cell grids
// (the COM, or the mass sums it comes from) to the eight temp cells of
// every cell, each neighbour's mass and COM with its mirror offset added
// (reference serial/parsim.cpp:301-354).
//
// Two kernels:
//
//   stencil_grid_kernel<T, kFromSums, kAligned>: one device's whole grid;
//     a cell's neighbour (dx, dy) is (cy + dy) % nc * nc + (cx + dx) % nc,
//     the mirrors at the grid's edges. It writes the (8, ncells + 1) rows
//     with a zero sentinel column (the sweep's force kernel and the
//     super-cell monopole read them), or (ncells, 8) rows a cell
//     (kAligned: the dense and tiered tile kernels read them);
//   stencil_halo_kernel<T, kFromSums>: a mesh's local grids, each shard's
//     (R, C) block of every band, with the received halo lines where they
//     lie: each axis wraps locally or takes halos. Rows: row 0 of the
//     padded block is the top halo line, row rows[l] + 1 the bottom one
//     (over a tail row where the shard owns fewer than R), rows 1..R the
//     owned rows, any other row 0. Columns likewise with the left and right
//     lines; on the 2D mesh those are columns of the row-padded block, so
//     the corners ride along. The block-cyclic bands take each band's
//     lines at its own index, shard 0's top line from the band above and
//     the last shard's bottom line from the band below. It writes the
//     (8, cells + 1) rows, band after band, a zero sentinel column last,
//     or rows a cell with a zero ring around each shard's block (the
//     resident meshes' tiles). A launch takes at most kMaxBands bands:
//     psim_stencil_halo launches once for each kMaxBands bands and returns
//     how many launches it made.
//
// They replace XLA code of the JAX package, which has no Pallas kernel for
// it: ops/stencil.py stencil_tables (the eight rolls), parallel/sharded.py
// stencil_tables_halo with its halo pad (:155-182), sharded2d.py
// stencil_tables_halo2d with two_phase_com_halo, sharded_banded_cols.py
// stencil_tables_halo_cols, and the block-cyclic chunk halos of
// sharded_banded.py; and the COM from the sums (M > 0 ? S / M : 0).
//
// Bits: the plain versions' (ops/stencil.py and ops/cuda/stencil.py). The
// COM is an IEEE division (no fast math); the mirror offset is added to
// every mx and my entry, 0 where no mirror applies (so -0.0 becomes +0.0),
// from a zero the host passes, which the compiler cannot fold away; the
// mass row takes no add. Each halo form keeps its own y-mirror predicate
// on rows past the grid (the 1D form gy + 1 >= nc and gy - 1 < 0, the 2D
// form gy == nc - 1 and gy == 0), and ncside < 3, where neighbours alias,
// gives the gather's tables. The COM, the mirrors and the padded rows'
// addressing are halo.cuh's, which the super-cell monopole pass of
// advance.cu shares.
//
// Since the super-cell routes build their terms from the sums in place
// (advance.cu), stencil_grid serves the sweep, dense and tiered engines and
// stencil_halo every mesh route but the super-cells.
//
// What bounds them on an H100: bytes. A cell reads its three values (the
// neighbours' come from L1 and L2) and writes 24; the division of the sums
// is done once a neighbour read, 16 a cell, far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halo.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBands = 32;
// (dx, dy) in the reference's loop order: dx outer, dy inner, no (0, 0).
__constant__ int kDx[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDy[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

template <typename T, bool kFromSums, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    stencil_grid_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const T* __restrict__ c, int nc, T side, T zero,
                        T* __restrict__ ml, T* __restrict__ mxl,
                        T* __restrict__ myl, int64_t ld) {
  const int64_t ncells = (int64_t)nc * nc;
  const int64_t cell = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!kAligned && cell == 0) {
    for (int k = 0; k < 8; ++k)
      ml[k * ld + ncells] = mxl[k * ld + ncells] = myl[k * ld + ncells] =
          T(0);
  }
  if (cell >= ncells) return;
  const int cy = (int)(cell / nc), cx = (int)(cell - (int64_t)cy * nc);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = kDx[k], dy = kDy[k];
    int nx = cx + dx, ny = cy + dy;
    nx = nx < 0 ? nc - 1 : (nx >= nc ? 0 : nx);
    ny = ny < 0 ? nc - 1 : (ny >= nc ? 0 : ny);
    const int64_t src = (int64_t)ny * nc + nx;
    const Triple<T> v = com<T, kFromSums>(a[src], b[src], c[src], zero);
    const T offx = mirror(dx, cx == nc - 1, cx == 0, side, zero);
    const T offy = mirror(dy, cy == nc - 1, cy == 0, side, zero);
    const int64_t at = kAligned ? cell * 8 + k : k * ld + cell;
    ml[at] = v.m;
    mxl[at] = offx + v.x;
    myl[at] = offy + v.y;
  }
}

// One band of a mesh's local grids: each field's (L, R, C) block at
// g[f] + l * sL + r * sR + c.
struct Band {
  const void* g[3];
  int64_t sL, sR;
  int R;
  int64_t first;          // the launch's cells before this band
  int64_t base;           // its first output column (rows layout)
  const int64_t* row0;    // (L,) first global row, rows halo
  const int64_t* rows;    // (L,) owned rows, rows halo
};

struct Halo {
  int nb, band0, nbands;  // bands of this launch, the first's index, all
  Band b[kMaxBands];
  int L, C, nc;
  int rows_halo, cols_halo, y_ge;
  const int64_t* col0;    // (L,) first global column, cols halo
  const int64_t* cols;    // (L,) owned columns, cols halo
  const void* top;        // (L, nbands, 3, C) received rows
  const void* bot;
  const void* left;       // (L, 1, 3, nside) received columns
  const void* right;
  int nside;              // R (rows wrap) or R + 2 (2D)
  const uint8_t* top_shift;  // (L,) take the band above's top line
  const uint8_t* bot_shift;  // (L,) take the band below's bottom line
  int aligned, pr, pc;    // rows a cell with a zero ring of pr rows, pc cols
  int64_t total;          // the launch's cells (threads)
  int64_t ld;             // rows layout: the output rows' length
  int sentinel;           // this launch writes the sentinel column
};

template <typename T>
__device__ __forceinline__ Triple<T> grid_at(const Band& bd, int l, int r,
                                             int c) {
  const int64_t at = l * bd.sL + r * bd.sR + c;
  return {static_cast<const T*>(bd.g[0])[at],
          static_cast<const T*>(bd.g[1])[at],
          static_cast<const T*>(bd.g[2])[at]};
}

// Row pr of the row-padded block at column x: the halo rows, the owned
// rows, or 0 (halo.cuh's halo_row).
template <typename T>
__device__ __forceinline__ Triple<T> padded_row(const Halo& h, int j, int l,
                                                int pr, int x, T zero) {
  const Band& bd = h.b[j];
  const int bi = h.band0 + j;
  switch (halo_row(pr, bd.rows[l], bd.R)) {
    case kHaloBot: {
      int bs = bi;
      if (h.bot_shift != nullptr && h.bot_shift[l]) bs = (bi + 1) % h.nbands;
      return raw<T>(h.bot, line_at(l, h.nbands, bs, h.C, x), h.C);
    }
    case kHaloTop: {
      int bs = bi;
      if (h.top_shift != nullptr && h.top_shift[l])
        bs = (bi + h.nbands - 1) % h.nbands;
      return raw<T>(h.top, line_at(l, h.nbands, bs, h.C, x), h.C);
    }
    case kHaloGrid:
      return grid_at<T>(bd, l, pr - 1, x);
    default:
      return {zero, zero, zero};
  }
}

template <typename T>
__device__ __forceinline__ Triple<T> neighbour(const Halo& h, int j, int l,
                                               int r, int c, int dx, int dy,
                                               T zero) {
  const Band& bd = h.b[j];
  if (!h.cols_halo) {  // rows take halos, columns wrap
    int nx = c + dx;
    nx = nx < 0 ? h.C - 1 : (nx >= h.C ? 0 : nx);
    return padded_row<T>(h, j, l, r + 1 + dy, nx, zero);
  }
  const int pc = c + 1 + dx;
  // rows wrap (the column bands) or take halos (2D): the padded row index
  const int y = h.rows_halo ? r + 1 + dy
                            : (r + dy < 0 ? bd.R - 1
                                          : (r + dy >= bd.R ? 0 : r + dy));
  if (pc == (int)h.cols[l] + 1)
    return raw<T>(h.right, (int64_t)l * 3 * h.nside + y, h.nside);
  if (pc == 0) return raw<T>(h.left, (int64_t)l * 3 * h.nside + y, h.nside);
  if (pc > h.C) return {zero, zero, zero};
  if (h.rows_halo) return padded_row<T>(h, j, l, y, pc - 1, zero);
  return grid_at<T>(bd, l, y, pc - 1);
}

template <typename T, bool kFromSums>
__global__ void __launch_bounds__(kThreads)
    stencil_halo_kernel(const __grid_constant__ Halo h, T side, T zero, T* __restrict__ ml,
                        T* __restrict__ mxl, T* __restrict__ myl) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (h.sentinel && t == 0) {
    for (int k = 0; k < 8; ++k)
      ml[k * h.ld + h.ld - 1] = mxl[k * h.ld + h.ld - 1] =
          myl[k * h.ld + h.ld - 1] = T(0);
  }
  if (t >= h.total) return;
  int j = 0;
  while (j + 1 < h.nb && t >= h.b[j + 1].first) ++j;
  const Band& bd = h.b[j];
  int l, r, c;
  int64_t at;  // the output cell (rows layout: its column)
  if (h.aligned) {
    const int rp = bd.R + 2 * h.pr, cp = h.C + 2 * h.pc;
    l = (int)(t / ((int64_t)rp * cp));
    const int rr = (int)(t / cp % rp), cc = (int)(t % cp);
    at = t;
    r = rr - h.pr;
    c = cc - h.pc;
    if (r < 0 || r >= bd.R || c < 0 || c >= h.C) {
      for (int k = 0; k < 8; ++k)
        ml[at * 8 + k] = mxl[at * 8 + k] = myl[at * 8 + k] = T(0);
      return;
    }
  } else {
    const int64_t u = t - bd.first;
    l = (int)(u / ((int64_t)bd.R * h.C));
    r = (int)(u / h.C % bd.R);
    c = (int)(u % h.C);
    at = bd.base + u;
  }
  const int64_t gx = h.cols_halo ? h.col0[l] + c : c;
  const int64_t gy = h.rows_halo ? bd.row0[l] + r : r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = kDx[k], dy = kDy[k];
    const Triple<T> n = neighbour<T>(h, j, l, r, c, dx, dy, zero);
    const Triple<T> v = com<T, kFromSums>(n.m, n.x, n.y, zero);
    const T offx = mirror(dx, gx == h.nc - 1, gx == 0, side, zero);
    const T offy = mirror_y(dy, gy, h.nc, h.y_ge, side, zero);
    const int64_t o = h.aligned ? at * 8 + k : k * h.ld + at;
    ml[o] = v.m;
    mxl[o] = offx + v.x;
    myl[o] = offy + v.y;
  }
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// The bands [j0, j0 + nb) of the caller's arrays into b.
int fill_bands(Band* b, int j0, int nb, const void* const* g,
               const int64_t* sL, const int64_t* sR, const int* R,
               const int64_t* const* row0, const int64_t* const* rows, int L,
               int C, const int64_t* base) {
  int64_t first = 0;
  for (int j = 0; j < nb; ++j) {
    const int k = j0 + j;
    if (R[k] < 1) return 0;
    for (int f = 0; f < 3; ++f) b[j].g[f] = g[3 * k + f];
    b[j].sL = sL[k];
    b[j].sR = sR[k];
    b[j].R = R[k];
    b[j].first = first;
    b[j].base = base == nullptr ? 0 : base[k];
    b[j].row0 = row0 == nullptr ? nullptr : row0[k];
    b[j].rows = rows == nullptr ? nullptr : rows[k];
    first += (int64_t)L * R[k] * C;
  }
  return 1;
}

template <typename T>
cudaError_t launch_grid(const void* a, const void* b, const void* c, int nc,
                        int from_sums, int aligned, double side, double zero,
                        void* ml, void* mxl, void* myl, int64_t ld,
                        cudaStream_t s) {
  const int64_t ncells = (int64_t)nc * nc;
  const unsigned nblk = blocks(ncells);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const T* C = static_cast<const T*>(c);
  T* o0 = static_cast<T*>(ml);
  T* o1 = static_cast<T*>(mxl);
  T* o2 = static_cast<T*>(myl);
  const T sd = (T)side, z = (T)zero;
  if (from_sums && aligned)
    stencil_grid_kernel<T, true, true><<<nblk, kThreads, 0, s>>>(
        A, B, C, nc, sd, z, o0, o1, o2, ld);
  else if (from_sums)
    stencil_grid_kernel<T, true, false><<<nblk, kThreads, 0, s>>>(
        A, B, C, nc, sd, z, o0, o1, o2, ld);
  else if (aligned)
    stencil_grid_kernel<T, false, true><<<nblk, kThreads, 0, s>>>(
        A, B, C, nc, sd, z, o0, o1, o2, ld);
  else
    stencil_grid_kernel<T, false, false><<<nblk, kThreads, 0, s>>>(
        A, B, C, nc, sd, z, o0, o1, o2, ld);
  return cudaGetLastError();
}

}  // namespace

// The one-device tables of the (nc * nc,) grids a, b, c (the COM, or the
// sums with from_sums), dtype 0 float, 1 double: rows of ld = ncells + 1
// with the sentinel, or (ncells, 8) with aligned.
extern "C" int psim_stencil_grid(int dtype, const void* a, const void* b,
                                 const void* c, int nc, int from_sums,
                                 int aligned, double side, double zero,
                                 void* ml, void* mxl, void* myl, int64_t ld,
                                 void* stream) {
  if (nc < 1 || (dtype != 0 && dtype != 1) ||
      (!aligned && ld != (int64_t)nc * nc + 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_grid<float>(a, b, c, nc, from_sums,
                                               aligned, side, zero, ml, mxl,
                                               myl, ld, s)
                          : launch_grid<double>(a, b, c, nc, from_sums,
                                                aligned, side, zero, ml, mxl,
                                                myl, ld, s));
}

// The mesh tables of nbands bands (g: 3 pointers a band; per band its
// strides, rows R, per-shard row0 and owned rows, output base column),
// over groups of at most kMaxBands bands a launch; *launched the launches
// made.
extern "C" int psim_stencil_halo(
    int dtype, int from_sums, int nbands, const void* const* g,
    const int64_t* sL, const int64_t* sR, const int* R,
    const int64_t* const* row0, const int64_t* const* rows,
    const int64_t* base, int L, int C, int nc, int rows_halo, int cols_halo,
    int y_ge, const int64_t* col0, const int64_t* cols, const void* top,
    const void* bot, const void* left, const void* right, int nside,
    const uint8_t* top_shift, const uint8_t* bot_shift, int aligned, int pr,
    int pc, double side, double zero, void* ml, void* mxl, void* myl,
    int64_t ld, int* launched, void* stream) {
  *launched = 0;
  if (nbands < 1 || L < 1 || C < 1 || nc < 1 || (dtype != 0 && dtype != 1) ||
      (rows_halo && (top == nullptr || bot == nullptr)) ||
      (cols_halo && (left == nullptr || right == nullptr || cols == nullptr ||
                     col0 == nullptr)) ||
      (aligned && nbands != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < nbands; j0 += kMaxBands) {
    Halo h;
    h.nb = nbands - j0 < kMaxBands ? nbands - j0 : kMaxBands;
    h.band0 = j0;
    h.nbands = nbands;
    if (!fill_bands(h.b, j0, h.nb, g, sL, sR, R, row0, rows, L, C, base))
      return (int)cudaErrorInvalidValue;
    h.L = L;
    h.C = C;
    h.nc = nc;
    h.rows_halo = rows_halo;
    h.cols_halo = cols_halo;
    h.y_ge = y_ge;
    h.col0 = col0;
    h.cols = cols;
    h.top = top;
    h.bot = bot;
    h.left = left;
    h.right = right;
    h.nside = nside;
    h.top_shift = top_shift;
    h.bot_shift = bot_shift;
    h.aligned = aligned;
    h.pr = pr;
    h.pc = pc;
    const Band& last = h.b[h.nb - 1];
    h.total = aligned ? (int64_t)L * (R[0] + 2 * pr) * (C + 2 * pc)
                      : last.first + (int64_t)L * last.R * C;
    h.ld = ld;
    h.sentinel = !aligned && j0 == 0;
    const unsigned nblk = blocks(h.total);
    if (dtype == 0) {
      float* o0 = static_cast<float*>(ml);
      float* o1 = static_cast<float*>(mxl);
      float* o2 = static_cast<float*>(myl);
      if (from_sums)
        stencil_halo_kernel<float, true><<<nblk, kThreads, 0, s>>>(
            h, (float)side, (float)zero, o0, o1, o2);
      else
        stencil_halo_kernel<float, false><<<nblk, kThreads, 0, s>>>(
            h, (float)side, (float)zero, o0, o1, o2);
    } else {
      double* o0 = static_cast<double*>(ml);
      double* o1 = static_cast<double*>(mxl);
      double* o2 = static_cast<double*>(myl);
      if (from_sums)
        stencil_halo_kernel<double, true><<<nblk, kThreads, 0, s>>>(
            h, side, zero, o0, o1, o2);
      else
        stencil_halo_kernel<double, false><<<nblk, kThreads, 0, s>>>(
            h, side, zero, o0, o1, o2);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}
