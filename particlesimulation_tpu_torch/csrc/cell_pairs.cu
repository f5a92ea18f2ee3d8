// Fused per-cell collision(t) + pair-force(t+1) pass for Hopper (sm_90a).
//
// Replaces particlesimulation_tpu/ops/pallas/cell_pairs.py:_fused_kernel_v2
// with both of its force forms ("v2" and "v4") and collide on and off. Its
// _fused_kernel_v2_kt variant computes the same function in another block
// layout, so this kernel covers it too.
//
// What bounds it: each cell does K^2 pair arithmetic (a d^2 sweep for the
// hit test, then the force loop with one rsqrt per pair) on data that is read
// once from device memory (5 loads and 3 stores of 4 bytes per slot against
// some 20*K flops per slot). So the kernel is bound by pair arithmetic, and
// by the rsqrt unit in particular, not by bytes.
//
// Design: one thread block per cell, in the engine's (ncells, K) row-major
// layout. The block loads its cell into shared memory once and keeps it
// resident for every phase; receivers are strided over the threads, and each
// thread walks all partners j of its receivers from shared memory (every
// thread of a warp reads the same j: a broadcast, free of bank conflicts).
//
// Phases (the collision machinery runs only in a cell with a hit):
//   1. any alive pair with d^2 < eps^2 (__syncthreads_or);
//   2. pid ranks among alive slots; per slot the min first-pair rank ft over
//      all partners; the count of pairs that are first for both ends;
//   3. post-death masses m_post (0 where ft != INF);
//   4. v4 only: coordinates recentred on the mean of used slots (m_post > 0);
//   5. the force loop.
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

template <bool kV4, bool kCollide>
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
  if (kCollide) {
    int hit = 0;
    for (int i = tid; i < kcap && !hit; i += nt) {
      const float xi = sx[i], yi = sy[i];
      const int ai = sa[i];
      for (int j = i + 1; j < kcap; ++j) {
        if (ai * sa[j] > 0 && dist2(xi, yi, sx[j], sy[j]) < eps2) {
          hit = 1;
          break;
        }
      }
    }
    if (__syncthreads_or(hit)) {
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
      count = block_sum(local, iscratch);
    }
  }
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
      const float xi = sx[i], yi = sy[i];
      const float gmi = g * sm[i];
      float ax = 0.0f, ay = 0.0f;
      for (int j = 0; j < kcap; ++j) {
        const float dx = sx[j] - xi;
        const float dy = sy[j] - yi;
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float inv = d2 > 0.0f ? rsqrtf(d2) : 0.0f;
        const float s = (gmi * sm[j]) * (inv * inv * inv);
        ax += s * dx;
        ay += s * dy;
      }
      fx[base + i] = ax;
      fy[base + i] = ay;
    }
  }
}

template <bool kV4, bool kCollide>
void launch(const float* x, const float* y, const float* mf, const int* alive,
            const int* pid, float* fx, float* fy, int* ft, int* cell_count,
            int ncells, int kcap, float eps2, float g, cudaStream_t stream) {
  const int rounded = (kcap + 31) / 32 * 32;  // whole warps
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const size_t smem = (size_t)9 * kcap * sizeof(float);
  fused_pairs_kernel<kV4, kCollide><<<ncells, threads, smem, stream>>>(
      x, y, mf, alive, pid, fx, fy, ft, cell_count, kcap, eps2, g);
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch.
extern "C" int psim_fused_pairs(const float* x, const float* y, const float* mf,
                                const int* alive, const int* pid, float* fx,
                                float* fy, int* ft, int* cell_count, int ncells,
                                int kcap, float eps2, float g, int collide,
                                int v4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v4) {
    if (collide)
      launch<true, true>(x, y, mf, alive, pid, fx, fy, ft, cell_count, ncells,
                         kcap, eps2, g, s);
    else
      launch<true, false>(x, y, mf, alive, pid, fx, fy, ft, cell_count,
                          ncells, kcap, eps2, g, s);
  } else {
    if (collide)
      launch<false, true>(x, y, mf, alive, pid, fx, fy, ft, cell_count,
                          ncells, kcap, eps2, g, s);
    else
      launch<false, false>(x, y, mf, alive, pid, fx, fy, ft, cell_count,
                           ncells, kcap, eps2, g, s);
  }
  return (int)cudaGetLastError();
}
