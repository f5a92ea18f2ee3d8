// Per-cell pair kernels on (ncells, K) slot tiles, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of particlesimulation_tpu/ops/pallas/cell_pairs.py:
//   fused_pairs_kernel<kV4, kCollide, kGate = true>: _fused_kernel_v2, with
//     both of its force forms ("v2" and "v4") and collide on and off. Its
//     _fused_kernel_v2_kt variant computes the same function in another
//     block layout, so this kernel covers it too;
//   fused_pairs_kernel<false, kCollide, kGate = false>: _fused_kernel (v1),
//     v2's function with no hit gating: the collision machinery runs in
//     every cell;
//   dense_forces_kernel: _force_kernel, the dense engine's force pass (all
//     same-cell pairs plus 8 monopole terms from the cell's stencil row);
//   dense_collisions_kernel: _collision_kernel, the dense engine's collision
//     pass (no force).
//
// What bounds them: each cell does K^2 pair arithmetic (a d^2 sweep for the
// hit test, and the force loop with one rsqrt per pair) on data that is read
// once from device memory (at most 5 loads and 3 stores of 4 bytes per slot
// against some 20*K flops per slot). So the kernels are bound by pair
// arithmetic, and by the rsqrt unit in particular, not by bytes.
//
// Design: one thread block per cell, in the engines' (ncells, K) row-major
// layout. The block loads its cell into shared memory once and keeps it
// resident for every phase; receivers are strided over the threads, and each
// thread walks all partners j of its receivers from shared memory (every
// thread of a warp reads the same j: a broadcast, free of bank conflicts).
//
// Collision phases (cell_has_hit, cell_collisions; shared by the fused and
// the collision kernel):
//   1. any alive pair with d^2 < eps^2 (__syncthreads_or); the gated kernels
//      run phase 2 only in a cell with a hit, which does not change the
//      result: with no hit every ft is INF and the count 0;
//   2. pid ranks among alive slots; per slot the min first-pair rank ft over
//      all partners; the count of pairs that are first for both ends.
// The fused kernel then takes post-death masses m_post (0 where ft != INF),
// in the v4 form recentres the coordinates on the mean of used slots
// (m_post > 0), and runs the force loop.
//
// Collision decisions must match the plain version bit for bit, so the hit
// test computes d^2 from raw x, y without FMA contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7FFFFFFF;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float dist2(float xi, float yi, float xj,
                                       float yj) {
  const float dx = __fsub_rn(xj, xi);
  const float dy = __fsub_rn(yj, yi);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Sum over the block; blockDim.x is a multiple of 32. Every thread gets the
// total. scratch holds 32 entries.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? scratch[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// Phase 1: whether any alive pair of the cell lies within eps (the same
// answer in every thread of the block).
__device__ bool cell_has_hit(const float* sx, const float* sy, const int* sa,
                             int kcap, float eps2) {
  int hit = 0;
  for (int i = threadIdx.x; i < kcap && !hit; i += blockDim.x) {
    const float xi = sx[i], yi = sy[i];
    const int ai = sa[i];
    for (int j = i + 1; j < kcap; ++j) {
      if (ai * sa[j] > 0 && dist2(xi, yi, sx[j], sy[j]) < eps2) {
        hit = 1;
        break;
      }
    }
  }
  return __syncthreads_or(hit) != 0;
}

// Phase 2: pid ranks among alive slots into sr, each slot's min first-pair
// rank into sft, and the count of pairs first for both ends (returned to
// every thread). sp holds the pids.
__device__ int cell_collisions(const float* sx, const float* sy, const int* sa,
                               const int* sp, int* sr, int* sft, int kcap,
                               float eps2, int* iscratch) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < kcap; i += nt) {
    const int pi = sp[i];
    int r = 0;
    for (int j = 0; j < kcap; ++j) r += (sa[j] > 0 && sp[j] < pi) ? 1 : 0;
    sr[i] = r;
  }
  __syncthreads();
  const int kb = kcap + 1;
  // Slot i as either end of a pair: one pass over all partners j != i.
  for (int i = tid; i < kcap; i += nt) {
    const float xi = sx[i], yi = sy[i];
    const int ai = sa[i], ri = sr[i];
    int best = kInf;
    for (int j = 0; j < kcap; ++j) {
      if (j != i && ai * sa[j] > 0 && dist2(xi, yi, sx[j], sy[j]) < eps2) {
        const int rj = sr[j];
        best = min(best, min(ri, rj) * kb + max(ri, rj));
      }
    }
    sft[i] = best;
  }
  __syncthreads();
  int local = 0;
  for (int i = tid; i < kcap; i += nt) {
    const int fi = sft[i];
    if (fi == kInf) continue;
    const float xi = sx[i], yi = sy[i];
    const int ai = sa[i], ri = sr[i];
    for (int j = i + 1; j < kcap; ++j) {
      if (ai * sa[j] > 0 && dist2(xi, yi, sx[j], sy[j]) < eps2) {
        const int rj = sr[j];
        const int rank = min(ri, rj) * kb + max(ri, rj);
        local += (rank == fi && rank == sft[j]) ? 1 : 0;
      }
    }
  }
  return block_sum(local, iscratch);
}

// Same-cell pair gravity on receiver (xi, yi) with gmi = G * m_i, the v2
// form: sum over j of (G m_i m_j) d / |d|^3, skipping d^2 == 0.
__device__ __forceinline__ void pair_force_v2(const float* sx, const float* sy,
                                              const float* sm, int kcap,
                                              float xi, float yi, float gmi,
                                              float* ax, float* ay) {
  float fx = 0.0f, fy = 0.0f;
  for (int j = 0; j < kcap; ++j) {
    const float dx = sx[j] - xi;
    const float dy = sy[j] - yi;
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float inv = d2 > 0.0f ? rsqrtf(d2) : 0.0f;
    const float s = (gmi * sm[j]) * (inv * inv * inv);
    fx += s * dx;
    fy += s * dy;
  }
  *ax = fx;
  *ay = fy;
}

template <bool kV4, bool kCollide, bool kGate>
__global__ void __launch_bounds__(kMaxThreads) fused_pairs_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ mf, const int* __restrict__ alive,
    const int* __restrict__ pid, float* __restrict__ fx,
    float* __restrict__ fy, int* __restrict__ ft,
    int* __restrict__ cell_count, int kcap, float eps2, float g) {
  // Nine (K,) arrays of 4 bytes: 36 KB at K = 1024, under the 48 KB a block
  // may take without opting in.
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + kcap;
  float* sm = sy + kcap;   // mf, then m_post
  float* sxl = sm + kcap;  // recentred coordinates (v4)
  float* syl = sxl + kcap;
  int* sa = reinterpret_cast<int*>(syl + kcap);
  int* sp = sa + kcap;     // pid
  int* sr = sp + kcap;     // pid rank among alive slots
  int* sft = sr + kcap;    // first-pair rank
  __shared__ float fscratch[32];
  __shared__ int iscratch[32];

  const int64_t base = (int64_t)blockIdx.x * kcap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < kcap; i += nt) {
    sx[i] = x[base + i];
    sy[i] = y[base + i];
    sm[i] = mf[base + i];
    sa[i] = alive[base + i];
    sp[i] = pid[base + i];
    sft[i] = kInf;
  }
  __syncthreads();

  int count = 0;
  if (kCollide && (!kGate || cell_has_hit(sx, sy, sa, kcap, eps2)))
    count = cell_collisions(sx, sy, sa, sp, sr, sft, kcap, eps2, iscratch);
  if (tid == 0) cell_count[blockIdx.x] = count;

  for (int i = tid; i < kcap; i += nt) {
    ft[base + i] = sft[i];
    if (kCollide && sft[i] != kInf) sm[i] = 0.0f;
  }
  __syncthreads();

  if (kV4) {
    float nused = 0.0f, sumx = 0.0f, sumy = 0.0f;
    for (int i = tid; i < kcap; i += nt) {
      if (sm[i] > 0.0f) {
        nused += 1.0f;
        sumx += sx[i];
        sumy += sy[i];
      }
    }
    const float nrow = fmaxf(block_sum(nused, fscratch), 1.0f);
    const float cx = block_sum(sumx, fscratch) / nrow;
    const float cy = block_sum(sumy, fscratch) / nrow;
    for (int i = tid; i < kcap; i += nt) {
      sxl[i] = sx[i] - cx;
      syl[i] = sy[i] - cy;
    }
    __syncthreads();
    for (int i = tid; i < kcap; i += nt) {
      const float xi = sxl[i], yi = syl[i];
      const float gmi = g * sm[i];
      float ax = 0.0f, ay = 0.0f, aw = 0.0f;
      for (int j = 0; j < kcap; ++j) {
        const float xj = sxl[j], yj = syl[j];
        const float d2 = dist2(xi, yi, xj, yj);
        const float inv = d2 > 0.0f ? rsqrtf(d2) : 0.0f;
        const float w = sm[j] * (inv * inv * inv);
        ax += w * xj;
        ay += w * yj;
        aw += w;
      }
      fx[base + i] = gmi * (ax - xi * aw);
      fy[base + i] = gmi * (ay - yi * aw);
    }
  } else {
    for (int i = tid; i < kcap; i += nt) {
      float ax, ay;
      pair_force_v2(sx, sy, sm, kcap, sx[i], sy[i], g * sm[i], &ax, &ay);
      fx[base + i] = ax;
      fy[base + i] = ay;
    }
  }
}

// Total gravity per slot: the v2 same-cell pair sum, then the 8 monopole
// terms of the cell's stencil row (ml, mxl, myl: (ncells, 8)) in stencil
// order, added one by one as _force_kernel adds them.
__global__ void __launch_bounds__(kMaxThreads) dense_forces_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ m, const float* __restrict__ ml,
    const float* __restrict__ mxl, const float* __restrict__ myl,
    float* __restrict__ fx, float* __restrict__ fy, int kcap, float g) {
  extern __shared__ float smem[];  // three (K,) arrays: 12 KB at K = 1024
  float* sx = smem;
  float* sy = sx + kcap;
  float* sm = sy + kcap;
  __shared__ float stencil[3][8];

  const int64_t base = (int64_t)blockIdx.x * kcap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < kcap; i += nt) {
    sx[i] = x[base + i];
    sy[i] = y[base + i];
    sm[i] = m[base + i];
  }
  if (tid < 8) {
    const int64_t s = (int64_t)blockIdx.x * 8 + tid;
    stencil[0][tid] = ml[s];
    stencil[1][tid] = mxl[s];
    stencil[2][tid] = myl[s];
  }
  __syncthreads();

  for (int i = tid; i < kcap; i += nt) {
    const float xi = sx[i], yi = sy[i];
    const float gmi = g * sm[i];
    float ax, ay;
    pair_force_v2(sx, sy, sm, kcap, xi, yi, gmi, &ax, &ay);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float dxl = stencil[1][l] - xi;
      const float dyl = stencil[2][l] - yi;
      const float d2l = dxl * dxl + dyl * dyl;
      const float invl = d2l > 0.0f ? rsqrtf(d2l) : 0.0f;
      const float sl = (gmi * stencil[0][l]) * (invl * invl * invl);
      ax += sl * dxl;
      ay += sl * dyl;
    }
    fx[base + i] = ax;
    fy[base + i] = ay;
  }
}

// Per-slot first-pair ranks and the per-cell count, no force. With no pid
// (pid == nullptr) the slot index stands for it, so a slot's rank is the
// number of alive slots before it (_slot_iota_pid in the Pallas module).
__global__ void __launch_bounds__(kMaxThreads) dense_collisions_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ alive, const int* __restrict__ pid,
    int* __restrict__ ft, int* __restrict__ cell_count, int kcap,
    float eps2) {
  extern __shared__ float smem[];  // six (K,) arrays: 24 KB at K = 1024
  float* sx = smem;
  float* sy = sx + kcap;
  int* sa = reinterpret_cast<int*>(sy + kcap);
  int* sp = sa + kcap;
  int* sr = sp + kcap;
  int* sft = sr + kcap;
  __shared__ int iscratch[32];

  const int64_t base = (int64_t)blockIdx.x * kcap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < kcap; i += nt) {
    sx[i] = x[base + i];
    sy[i] = y[base + i];
    sa[i] = alive[base + i];
    sp[i] = pid != nullptr ? pid[base + i] : i;
    sft[i] = kInf;
  }
  __syncthreads();

  int count = 0;
  if (cell_has_hit(sx, sy, sa, kcap, eps2))
    count = cell_collisions(sx, sy, sa, sp, sr, sft, kcap, eps2, iscratch);
  if (tid == 0) cell_count[blockIdx.x] = count;
  for (int i = tid; i < kcap; i += nt) ft[base + i] = sft[i];
}

int threads_for(int kcap) {
  const int rounded = (kcap + 31) / 32 * 32;  // whole warps
  return rounded < kMaxThreads ? rounded : kMaxThreads;
}

template <bool kV4, bool kCollide, bool kGate>
void launch_fused(const float* x, const float* y, const float* mf,
                  const int* alive, const int* pid, float* fx, float* fy,
                  int* ft, int* cell_count, int ncells, int kcap, float eps2,
                  float g, cudaStream_t stream) {
  const size_t smem = (size_t)9 * kcap * sizeof(float);
  fused_pairs_kernel<kV4, kCollide, kGate>
      <<<ncells, threads_for(kcap), smem, stream>>>(
          x, y, mf, alive, pid, fx, fy, ft, cell_count, kcap, eps2, g);
}

template <bool kV4>
void dispatch_fused(const float* x, const float* y, const float* mf,
                    const int* alive, const int* pid, float* fx, float* fy,
                    int* ft, int* cell_count, int ncells, int kcap,
                    float eps2, float g, int collide, int gate,
                    cudaStream_t s) {
  if (!collide)
    launch_fused<kV4, false, true>(x, y, mf, alive, pid, fx, fy, ft,
                                   cell_count, ncells, kcap, eps2, g, s);
  else if (gate)
    launch_fused<kV4, true, true>(x, y, mf, alive, pid, fx, fy, ft,
                                  cell_count, ncells, kcap, eps2, g, s);
  else
    launch_fused<kV4, true, false>(x, y, mf, alive, pid, fx, fy, ft,
                                   cell_count, ncells, kcap, eps2, g, s);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch.
extern "C" int psim_fused_pairs(const float* x, const float* y, const float* mf,
                                const int* alive, const int* pid, float* fx,
                                float* fy, int* ft, int* cell_count, int ncells,
                                int kcap, float eps2, float g, int collide,
                                int v4, int gate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v4)
    dispatch_fused<true>(x, y, mf, alive, pid, fx, fy, ft, cell_count, ncells,
                         kcap, eps2, g, collide, gate, s);
  else
    dispatch_fused<false>(x, y, mf, alive, pid, fx, fy, ft, cell_count,
                          ncells, kcap, eps2, g, collide, gate, s);
  return (int)cudaGetLastError();
}

extern "C" int psim_dense_forces(const float* x, const float* y, const float* m,
                                 const float* ml, const float* mxl,
                                 const float* myl, float* fx, float* fy,
                                 int ncells, int kcap, float g, void* stream) {
  const size_t smem = (size_t)3 * kcap * sizeof(float);
  dense_forces_kernel<<<ncells, threads_for(kcap), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y, m, ml, mxl, myl, fx, fy, kcap, g);
  return (int)cudaGetLastError();
}

extern "C" int psim_dense_collisions(const float* x, const float* y,
                                     const int* alive, const int* pid, int* ft,
                                     int* cell_count, int ncells, int kcap,
                                     float eps2, void* stream) {
  const size_t smem = (size_t)6 * kcap * sizeof(float);
  dense_collisions_kernel<<<ncells, threads_for(kcap), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, y, alive, pid, ft, cell_count, kcap, eps2);
  return (int)cudaGetLastError();
}
