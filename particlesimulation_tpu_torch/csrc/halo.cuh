// The temp cells' arithmetic and the 1D row halo's addressing, shared by
// the stencil tables (stencil.cu: stencil_halo_kernel) and the super-cell
// monopole pass that builds its terms from the sums in place (advance.cu:
// monopole_supercell_kernel), so that both read a shard's padded rows and
// mirror its edges through one copy of the rules.
//
// A mesh's local grid is a shard's (R, C) block of cell rows. Its
// row-padded block puts the received top line at padded row 0, the owned
// rows at 1..R, and the received bottom line at padded row rows_mine + 1:
// over a tail row where the shard owns fewer than R rows, which then reads
// no grid row. Any other padded row reads 0. The lines are (L, nbands, 3,
// C): shard l's band b, field f (m, x, y) at ((l * nbands + b) * 3 + f) *
// C.
//
// Bits: the COM of the sums is an IEEE division (M > 0 ? S / M : 0, the
// 0 a zero the host passes); a mirror offset is that zero where no mirror
// applies, added all the same (so -0.0 becomes +0.0).

#pragma once

#include <stdint.h>

template <typename T>
struct Triple {
  T m, x, y;
};

// The COM of raw values: the sums' (M > 0 ? S / M : 0) or the COM itself.
template <typename T, bool kFromSums>
__device__ __forceinline__ Triple<T> com(T m, T x, T y, T zero) {
  if (kFromSums) {
    const bool has = m > T(0);
    return {m, has ? x / m : zero, has ? y / m : zero};
  }
  return {m, x, y};
}

// The mirror offset of direction d: +side past the high edge (hi), -side
// past the low one (lo), else zero.
template <typename T>
__device__ __forceinline__ T mirror(int d, bool hi, bool lo, T side, T zero) {
  return d == 1 ? (hi ? side : zero) : (d == -1 ? (lo ? -side : zero) : zero);
}

// The y mirror of a cell of global row gy in direction dy: the 1D mesh's
// form (y_ge: gy + 1 >= nc, gy - 1 < 0, which a tail row past the grid
// meets too) or the 2D mesh's and one device's (gy == nc - 1, gy == 0).
template <typename T>
__device__ __forceinline__ T mirror_y(int dy, int64_t gy, int nc, bool y_ge,
                                      T side, T zero) {
  return y_ge ? mirror(dy, gy + 1 >= nc, gy - 1 < 0, side, zero)
              : mirror(dy, gy == nc - 1, gy == 0, side, zero);
}

// Where padded row pr of a shard's row-padded block lies.
enum HaloRow { kHaloTop, kHaloBot, kHaloGrid, kHaloZero };

__device__ __forceinline__ HaloRow halo_row(int pr, int64_t rows_mine,
                                            int R) {
  if (pr == (int)rows_mine + 1) return kHaloBot;
  if (pr == 0) return kHaloTop;
  if (pr <= R) return kHaloGrid;
  return kHaloZero;
}

// Entry x of shard l's line of band b, field m (the others at + C, + 2 C).
__device__ __forceinline__ int64_t line_at(int l, int nbands, int b, int C,
                                           int x) {
  return (((int64_t)l * nbands + b) * 3) * C + x;
}

template <typename T>
__device__ __forceinline__ Triple<T> raw(const void* base, int64_t at,
                                         int64_t fstride) {
  const T* p = static_cast<const T*>(base) + at;
  return {p[0], p[fstride], p[2 * fstride]};
}
