// Per-cell kernels on (ncells, K) slot tiles, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of particlesimulation_tpu/ops/pallas/cell_pairs.py:
//   fused_pairs_kernel<kV4, kCollide, kGate = true, kRows, false>:
//     _fused_kernel_v2, with both of its force forms ("v2" and "v4") and
//     collide on and off. Its _fused_kernel_v2_kt variant computes the same
//     function in another block layout, so this kernel covers it too;
//   fused_pairs_kernel<false, true, kGate = false, kRows, false>:
//     _fused_kernel (v1), v2's function with no hit gating: the collision
//     machinery runs in every cell;
//   dense_forces_kernel: _force_kernel, the dense engine's force pass (all
//     same-cell pairs plus 8 monopole terms from the cell's stencil row);
//   dense_collisions_kernel: _collision_kernel, the dense engine's collision
//     pass (no force).
// and two XLA programs of the JAX package's supercell engine, which has no
// Pallas kernel:
//   fused_pairs_kernel<kV4, kCollide, true, kRows, kSub = true>: the `sub`
//     argument of ops/dense_xla.py fused_pairs_v2 / fused_pairs_v4, a
//     same-cell label per slot (pairs of unequal labels neither interact nor
//     collide);
//   cell_sums_kernel: the per-cell mass and moment sums of
//     ops/supercell.py (one-hot contractions on the TPU's matrix unit).
//
// What bounds them on an H100: each cell does pair arithmetic over its used
// slots (the force loop: one rsqrt and ~12 f32 instructions per ordered
// pair; the hit test: a d^2 per candidate pair) on data read once from
// device memory. The force kernels are bound by that arithmetic (the f32
// instruction rate and the rsqrt unit), the collision kernel by the bytes of
// the row and by its short serial phases. Tiles are padded to the tile cap
// K: at the flagship about 100 of K = 160 slots are used, in the dense
// engine's clustered tiles 600 of 864 or far fewer, and the resident
// engine's rows have holes; a loop over all K slots pays for the padding
// squared.
//
// Design: each block stages one cell row in shared memory, and compacts the
// slots it needs (alive ones for collisions, used ones, m > 0, for the
// forces) in slot order with one block scan (block_compact), so that every
// loop runs over those slots only. Both force loops share one pair-sum
// helper (pair_sums): float4 partners, kRows receivers a thread.
//
// Collision machinery (shared by the fused and the collision kernel):
//   * the alive slots are put in x buckets at least 2 eps wide
//     (bucket_by_x: a count, a scan and a scatter), and each slot is tested
//     against the slots after it in its bucket and the next one
//     (sweep_near): every pair within eps, and few others. A hit does
//     atomicMin on both ends' first-pair rank in shared memory; the minimum
//     is taken over integers, so the result does not depend on the order of
//     the atomics;
//   * ranks: with no pid (the dense engines) a slot's rank is its compacted
//     index, the count of alive slots before it; with a pid, the count of
//     alive slots with a smaller pid, computed only where the rank is needed
//     (in a cell with a hit, or in every cell for the ungated v1 kernel);
//   * the count in O(n): ranks are distinct among alive slots (pids are
//     distinct), so a finite ft names exactly one pair; the pair is first for
//     both ends iff the partner's ft equals it. The partner comes from the
//     rank decoded from ft through an inverse rank table.
// The gated kernels test for a hit first and run the rest only in a cell
// with one; with no pid the first-pair sweep is itself the hit test. With no
// hit every ft is INF and the count 0, so gating does not change the result.
//
// Collision decisions must match the plain version bit for bit, so the hit
// test computes d^2 from raw x, y without FMA contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7FFFFFFF;
constexpr int kMaxThreads = 256;       // fused and force kernels
constexpr int kMaxCollThreads = 1024;  // collision kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float xi, float yi, float xj,
                                       float yj) {
  const float dx = __fsub_rn(xj, xi);
  const float dy = __fsub_rn(yj, yi);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// 1/sqrt(x) on the rsqrt unit alone: rsqrtf's subnormal-input fix-up
// costs three more instructions a pair, and the two agree on normal inputs.
// A subnormal x gives +inf, which a subnormal d^2 overflows to in d^-3 too.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Sum over the block; blockDim.x is a multiple of 32. Every thread gets the
// total. scratch holds 32 entries.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? scratch[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// One slot of a row as a kernel loads it; `set` marks the slots to keep.
struct Slot {
  bool set;
  float x, y, m;
  int pid;
};

// Compaction of one row in slot order: visit(i, c, v) runs once for every
// slot i < kcap with v = load(i), c its index among the slots whose v.set
// holds, or -1 if it does not hold. load(i) must give set = false for
// i >= kcap. Returns the number of kept slots to every thread; what visit
// wrote to shared memory is visible on return. One ballot and one warp scan
// of the per-warp counts per round of blockDim.x slots; each round starts
// the next round's loads before its barriers, so that they overlap its scan.
// blockDim.x is a multiple of 32; scratch holds 32 entries.
template <typename Load, typename Visit>
__device__ int block_compact(int kcap, Load load, Visit visit, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int total = 0;
  Slot v = load(threadIdx.x);
  for (int i0 = 0; i0 < kcap; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const Slot next = load(i + blockDim.x);
    const unsigned ballot = __ballot_sync(kFull, v.set);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    int w = lane < nwarps ? scratch[lane] : 0;  // inclusive scan over warps
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    const int before = __shfl_sync(kFull, w, (warp + 31) & 31);
    if (i < kcap)
      visit(i,
            v.set ? total + (warp > 0 ? before : 0) +
                        __popc(ballot & ((1u << lane) - 1u))
                  : -1,
            v);
    total += __shfl_sync(kFull, w, 31);
    __syncthreads();  // readers of scratch are done; visits are visible
    v = next;
  }
  return total;
}

// Exclusive prefix sum of v[0, len) in place, over the block; returns the
// total to every thread. blockDim.x is a multiple of 32; scratch holds 32.
__device__ int block_scan(int* v, int len, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int carry = 0;
  for (int i0 = 0; i0 < len; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int x = i < len ? v[i] : 0;
    int w = x;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    if (lane == 31) scratch[warp] = w;
    __syncthreads();
    int t = lane < nwarps ? scratch[lane] : 0;  // ... and over the warps
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    const int before = __shfl_sync(kFull, t, (warp + 31) & 31);
    if (i < len) v[i] = carry + (warp > 0 ? before : 0) + w - x;
    carry += __shfl_sync(kFull, t, 31);
    __syncthreads();
  }
  return carry;
}

// A cell's alive slots in shared memory, compacted in slot order, and their
// order by x bucket (bucket_by_x).
struct AliveSlots {
  float2* xy;  // (x, y)
  int* slot;   // compacted index -> slot
  int* ft;     // first-pair rank, INF on entry
  int* order;  // compacted indices, bucket by bucket
  int* bend;   // per bucket: 0 on entry, its end in order on return
  int* rank;   // pid rank among alive slots (ranked cells only)
  int* inv;    // pid on entry, then rank -> compacted index (ranked only)
  int* lab;    // same-cell label (labelled kernels only)
  int n;       // alive slots
  int nb;      // buckets
  float xmin, rh;  // bucket of x: (x - xmin) * rh, rounded down

  __device__ int bucket(float x) const {
    const float u = (x - xmin) * rh;
    return u >= 1.0f ? min(nb - 1, (int)u) : 0;  // NaN and -0 go to 0
  }
};

// Orders the alive slots by x bucket: n buckets over the row's x range, each
// at least 2 eps wide, so two slots less than eps apart in x lie in one
// bucket or in neighbouring ones (the bucket arithmetic rounds by < 2e-4 of
// a bucket at n <= 1024). A count, a scan and a scatter: five barriers, where
// a sorting network of n = 100 needs 28 and a comparison sort n^2 compares.
// c.bend must hold zeros for the first n buckets. fscratch and iscratch hold
// 32 entries each.
__device__ void bucket_by_x(AliveSlots& c, float eps2, float* fscratch,
                            int* iscratch) {
  float lo = __int_as_float(0x7F800000), hi = -lo;  // +inf, -inf
  for (int a = threadIdx.x; a < c.n; a += blockDim.x) {
    lo = fminf(lo, c.xy[a].x);
    hi = fmaxf(hi, c.xy[a].x);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    fscratch[threadIdx.x >> 5] = lo;
    iscratch[threadIdx.x >> 5] = __float_as_int(hi);
  }
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    lo = fminf(lo, fscratch[w]);
    hi = fmaxf(hi, __int_as_float(iscratch[w]));
  }
  c.nb = max(c.n, 1);
  c.xmin = lo;
  c.rh = 1.0f / fmaxf(2.0f * sqrtf(eps2), (hi - lo) / c.nb);
  for (int a = threadIdx.x; a < c.n; a += blockDim.x)
    atomicAdd(&c.bend[c.bucket(c.xy[a].x)], 1);
  __syncthreads();  // also: every thread has read the scratch
  block_scan(c.bend, c.nb, iscratch);
  for (int a = threadIdx.x; a < c.n; a += blockDim.x)
    c.order[atomicAdd(&c.bend[c.bucket(c.xy[a].x)], 1)] = a;
  __syncthreads();
}

// Calls hit(a, b) (compacted indices, a < b) for every pair of alive slots
// within eps (d^2 < eps2, d^2 computed as the plain version computes it),
// and with kSub of equal labels.
// Each thread takes slots in bucket order and checks the slots after it in
// its own bucket and in the next one. A pair with d^2 < eps2 is less than eps
// apart in x (fl(dx^2) <= d^2, and rounding is monotone), so it lies in one
// bucket or in neighbouring ones and is checked once. Buckets hold about one
// slot each where the row is spread over its cell (50 wide, eps = 0.005, at
// the flagship), so the sweep costs O(n), not O(n^2).
template <bool kSub, typename Hit>
__device__ __forceinline__ void sweep_near(const AliveSlots& c, float eps2,
                                           Hit hit) {
  for (int p = threadIdx.x; p < c.n; p += blockDim.x) {
    const int a = c.order[p];
    const float2 pa = c.xy[a];
    const int la = kSub ? c.lab[a] : 0;
    const int end = c.bend[min(c.bucket(pa.x) + 1, c.nb - 1)];
    for (int q = p + 1; q < end; ++q) {
      const int b = c.order[q];
      const float2 pb = c.xy[b];
      if (dist2(pa.x, pa.y, pb.x, pb.y) < eps2 && (!kSub || c.lab[b] == la))
        hit(min(a, b), max(a, b));
    }
  }
}

// Whether any two alive slots (of one label, with kSub) lie within eps (the
// same answer in every thread of the block). The slots are in bucket order.
template <bool kSub>
__device__ bool cell_has_hit(const AliveSlots& c, float eps2) {
  int found = 0;
  sweep_near<kSub>(c, eps2, [&](int, int) { found = 1; });
  return __syncthreads_or(found) != 0;
}

// Collision outputs of one cell whose alive slots are in bucket order: each
// slot's min first-pair rank into c.ft, and the count of pairs first for
// both ends (returned to every thread). With `ranked`, the pid ranks go to
// c.rank and c.inv becomes the inverse; without it, the rank is the
// compacted index (slot order stands for pid order). With kSub only pairs
// of equal labels hit; the ranks stay the row's.
template <bool kSub>
__device__ int cell_collisions(const AliveSlots& c, bool ranked, int kcap,
                               float eps2, int* iscratch) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (ranked) {
    for (int a = tid; a < c.n; a += nt) {
      const int p = c.inv[a];
      int r = 0;
      for (int b = 0; b < c.n; ++b) r += c.inv[b] < p ? 1 : 0;
      c.rank[a] = r;
    }
    __syncthreads();
    for (int a = tid; a < c.n; a += nt) c.inv[c.rank[a]] = a;
  }
  const int kb = kcap + 1;
  int found = 0;
  sweep_near<kSub>(c, eps2, [&](int a, int b) {
    const int ra = ranked ? c.rank[a] : a;
    const int rb = ranked ? c.rank[b] : b;
    const int rank = min(ra, rb) * kb + max(ra, rb);
    atomicMin(&c.ft[a], rank);
    atomicMin(&c.ft[b], rank);
    found = 1;
  });
  if (!__syncthreads_or(found)) return 0;  // no hit: every ft is INF
  int local = 0;
  for (int a = tid; a < c.n; a += nt) {
    const int f = c.ft[a];
    if (f == kInf) continue;
    const int lo = f / kb;
    const int hi = f - lo * kb;
    const int partner = (ranked ? c.rank[a] : a) == lo ? hi : lo;
    const int b = ranked ? c.inv[partner] : partner;
    local += (b > a && c.ft[b] == f) ? 1 : 0;
  }
  return block_sum(local, iscratch);
}

// The pair sums of the used slots q0 .. q0 + kRows - 1 (receivers past n
// take a copy of the last one) of a row compacted into sp as float4
// (x, y, m, 0), or with kSub (x, y, m, label bits), over its n used
// partners in compacted order; n >= 1.
// Per pair: w = m_j / |d|^3 (0 where d^2 == 0, and with kSub where the
// labels differ), d^2 with one FMA and 1/|d| on the rsqrt unit alone, then
//   v2 (kV4 = false): ax += w dx, ay += w dy            (12 instructions);
//   v4 (kV4 = true):  ax += w x_j, ay += w y_j, aw += w  (13).
// A masked pair adds fmaf(0, v, a) == a: exactly nothing. One partner load
// feeds kRows receivers held in registers. The caller multiplies the sums
// by gmi = G m_i once. A receiver's sum runs over the same partners in the
// same order for any kRows and block size.
template <int kRows, bool kV4, bool kSub = false>
__device__ __forceinline__ void pair_sums(const float4* sp, int n, int q0,
                                          float g, float (&xi)[kRows],
                                          float (&yi)[kRows],
                                          float (&gmi)[kRows],
                                          float (&ax)[kRows],
                                          float (&ay)[kRows],
                                          float (&aw)[kRows]) {
  int li[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 p = sp[min(q0 + r, n - 1)];  // a copy past the row's end
    xi[r] = p.x;
    yi[r] = p.y;
    li[r] = __float_as_int(p.w);
    gmi[r] = g * p.z;
    ax[r] = 0.0f;
    ay[r] = 0.0f;
    aw[r] = 0.0f;
  }
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const float4 pj = sp[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dx = pj.x - xi[r];
      const float dy = pj.y - yi[r];
      const float d2 = fmaf(dx, dx, dy * dy);
      const float inv = d2 > 0.0f ? rsqrt_ftz(d2) : 0.0f;
      float w = pj.z * (inv * inv * inv);
      if (kSub && __float_as_int(pj.w) != li[r]) w = 0.0f;
      if (kV4) {
        ax[r] = fmaf(w, pj.x, ax[r]);
        ay[r] = fmaf(w, pj.y, ay[r]);
        aw[r] += w;
      } else {
        ax[r] = fmaf(w, dx, ax[r]);
        ay[r] = fmaf(w, dy, ay[r]);
      }
    }
  }
}

// The resident engine's pass: collisions(t) through the shared machinery
// above, then the pair forces(t+1) over the slots with m_post > 0.
//
// Bound: the force loop's arithmetic, as in dense_forces_kernel (one rsqrt
// and 12-13 f32 instructions per ordered pair of used slots), plus the
// collision phase's short serial phases. After the collision phase writes
// ft and zeroes m_post for its deaths, the used slots (m_post > 0, alive
// or not) are compacted in slot order into float4 (x, y, m, 0), and
// receivers and partners loop over those n slots only (pair_sums, shared
// with the dense force kernel); a slot with m_post = 0 is written 0. v4
// recentres the used slots in place on their mean, summed in compacted
// order (lane l takes slots l, l + 32, ..., then a fixed xor tree), so
// that the forces are the same bits for every launch shape. kRows
// receivers a thread; one block per cell.
//
// Shared memory, eleven (K,) words (44 KB at K = 1024, under the 48 KB a
// block may take without opting in): the row's x, y, m (3K), and the
// collision arrays (8K), which the used slots' float4 and slot indices
// (5K) reuse once ft is written. -Xptxas -v on sm_90a: 31-40 registers, at
// most 256 bytes of static shared memory, no spills.
//
// The labelled form (kSub, the supercell engine's rows of S x S cells):
// `sub` holds each slot's cell within the row, -1 for an unbinned slot. The
// alive slots' labels take a twelfth (K,) array (48 KB at K = 1024, which
// with the static scratch is over 48 KB: the launch opts in), and the hit
// test of sweep_near passes only pairs of equal labels, so the gate and the
// count see only same-cell pairs; ranks stay the row's pid ranks. The
// partners carry their label's bits in the float4's fourth word, and a
// mismatched pair gets w = 0 (pair_sums). The v4 centre stays the mean of
// the whole row's used slots, as in the XLA form. The force loop still
// visits all n^2 used pairs of the row, where the function needs only the
// sum of c^2 over its cells: a receiver looping over its own cell alone
// needs the slots sorted by label first.
template <bool kV4, bool kCollide, bool kGate, int kRows, bool kSub>
__global__ void __launch_bounds__(kMaxThreads) fused_pairs_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ mf, const int* __restrict__ alive,
    const int* __restrict__ pid, const int* __restrict__ sub,
    float* __restrict__ fx, float* __restrict__ fy, int* __restrict__ ft,
    int* __restrict__ total, int kcap, float eps2, float g) {
  extern __shared__ __align__(16) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  AliveSlots c;
  c.xy = reinterpret_cast<float2*>(smem);
  c.slot = reinterpret_cast<int*>(smem + 2 * kcap);
  c.rank = c.slot + kcap;
  c.inv = c.rank + kcap;
  c.ft = c.inv + kcap;
  c.order = c.ft + kcap;
  c.bend = c.order + kcap;
  float4* sp = smem4;                                     // used slots
  int* sslot = reinterpret_cast<int*>(smem + 4 * kcap);  // compacted -> slot
  float* sx = smem + 8 * kcap;
  float* sy = sx + kcap;
  float* sm = sy + kcap;  // mf, then m_post
  c.lab = reinterpret_cast<int*>(sm + kcap);  // labelled form only
  __shared__ float fscratch[32];
  __shared__ int iscratch[32];

  const int64_t base = (int64_t)blockIdx.x * kcap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (kCollide) {
    c.n = block_compact(
        kcap,
        [&](int i) {
          Slot v = {false, 0.0f, 0.0f, 0.0f, 0};
          if (i < kcap) {
            v = {alive[base + i] > 0, x[base + i], y[base + i], mf[base + i],
                 pid[base + i]};
          }
          return v;
        },
        [&](int i, int a, const Slot& v) {
          sx[i] = v.x;
          sy[i] = v.y;
          sm[i] = v.m;
          c.bend[i] = 0;
          if (a < 0) {
            ft[base + i] = kInf;
            return;
          }
          c.xy[a] = make_float2(v.x, v.y);
          c.slot[a] = i;
          c.inv[a] = v.pid;
          c.ft[a] = kInf;
          if (kSub) c.lab[a] = sub[base + i];
        },
        iscratch);
    bucket_by_x(c, eps2, fscratch, iscratch);
    int count = 0;
    if (!kGate || cell_has_hit<kSub>(c, eps2))
      count = cell_collisions<kSub>(c, true, kcap, eps2, iscratch);
    if (tid == 0 && count > 0) atomicAdd(total, count);
    for (int a = tid; a < c.n; a += nt) {
      const int i = c.slot[a];
      ft[base + i] = c.ft[a];
      if (c.ft[a] != kInf) sm[i] = 0.0f;
    }
    __syncthreads();  // m_post is in sm; the collision arrays are dead
  } else {
    for (int i = tid; i < kcap; i += nt) ft[base + i] = kInf;
  }

  const int n = block_compact(
      kcap,
      [&](int i) {
        Slot v = {false, 0.0f, 0.0f, 0.0f, 0};
        if (i < kcap) {
          const float mi = kCollide ? sm[i] : mf[base + i];
          v = {mi > 0.0f, kCollide ? sx[i] : x[base + i],
               kCollide ? sy[i] : y[base + i], mi, kSub ? sub[base + i] : 0};
        }
        return v;
      },
      [&](int i, int q, const Slot& v) {
        if (q >= 0) {
          sp[q] = make_float4(v.x, v.y, v.m,
                              kSub ? __int_as_float(v.pid) : 0.0f);
          sslot[q] = i;
        } else {
          fx[base + i] = 0.0f;
          fy[base + i] = 0.0f;
        }
      },
      iscratch);

  if (kV4) {
    // Every warp sums the same slots in the same order: one result.
    const int lane = tid & 31;
    float sumx = 0.0f, sumy = 0.0f;
    for (int q = lane; q < n; q += 32) {
      sumx += sp[q].x;
      sumy += sp[q].y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      sumx += __shfl_xor_sync(kFull, sumx, o);
      sumy += __shfl_xor_sync(kFull, sumy, o);
    }
    const float nrow = fmaxf((float)n, 1.0f);
    const float cx = sumx / nrow;
    const float cy = sumy / nrow;
    __syncthreads();  // every warp has read sp
    for (int q = tid; q < n; q += nt) {
      sp[q].x -= cx;
      sp[q].y -= cy;
    }
    __syncthreads();
  }

  for (int q0 = tid * kRows; q0 < n; q0 += nt * kRows) {
    float xi[kRows], yi[kRows], gmi[kRows], ax[kRows], ay[kRows], aw[kRows];
    pair_sums<kRows, kV4, kSub>(sp, n, q0, g, xi, yi, gmi, ax, ay, aw);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (q0 + r >= n) break;
      const int i = sslot[q0 + r];
      if (kV4) {  // G m_i (sum w xl_j - xl_i sum w)
        fx[base + i] = gmi[r] * fmaf(-xi[r], aw[r], ax[r]);
        fy[base + i] = gmi[r] * fmaf(-yi[r], aw[r], ay[r]);
      } else {
        fx[base + i] = ax[r] * gmi[r];
        fy[base + i] = ay[r] * gmi[r];
      }
    }
  }
}

// Total gravity on the used slots q0 .. q0 + kRows - 1 (those below n) of a
// row compacted into sp: the v2 pair sums, then the 8 monopole terms.
template <int kRows>
__device__ __forceinline__ void force_rows(const float4* sp, const int* sslot,
                                           int n, int q0,
                                           const float (*stencil)[8], float g,
                                           float* fx, float* fy) {
  float xi[kRows], yi[kRows], gmi[kRows], ax[kRows], ay[kRows], aw[kRows];
  pair_sums<kRows, false>(sp, n, q0, g, xi, yi, gmi, ax, ay, aw);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + r >= n) break;
    ax[r] *= gmi[r];
    ay[r] *= gmi[r];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float dxl = stencil[1][l] - xi[r];
      const float dyl = stencil[2][l] - yi[r];
      const float d2l = dxl * dxl + dyl * dyl;
      const float invl = d2l > 0.0f ? rsqrtf(d2l) : 0.0f;
      const float sl = (gmi[r] * stencil[0][l]) * (invl * invl * invl);
      ax[r] += sl * dxl;
      ay[r] += sl * dyl;
    }
    fx[sslot[q0 + r]] = ax[r];
    fy[sslot[q0 + r]] = ay[r];
  }
}

// Total gravity per slot: the v2 same-cell pair sum, then the 8 monopole
// terms of the cell's stencil row (ml, mxl, myl: (ncells, 8)) in stencil
// order, added one by one as _force_kernel adds them.
//
// Bound: one rsqrt and ~14 flops per ordered pair of used slots. The used
// slots (m > 0) are compacted in slot order into float4 (x, y, m, 0), so a
// partner is one 16-byte broadcast load from shared memory, and only used
// partners and receivers are visited: an m = 0 partner adds a term that is
// exactly 0, and an m = 0 receiver gets 0 (gmi = 0). Each thread holds
// kRows consecutive receivers in registers, so one partner load feeds kRows
// independent pairs. The grid is (cells x chunks): a class with few rows
// splits each row's receivers over `chunks` blocks, each staging the whole
// row (at most 20 KB of shared memory at K = 1024). One block per cell and
// chunk, not a grid-stride loop: rows differ in work by n^2, and the
// hardware hands a freed SM the next block (a grid-stride loop measured
// slower on an H100). -Xptxas -v on sm_90a: 48 (kRows = 1) or 64
// registers, 224 bytes of static shared memory, no spills; 20 K bytes of
// dynamic shared memory.
template <int kRows>
__global__ void __launch_bounds__(kMaxThreads) dense_forces_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ m, const float* __restrict__ ml,
    const float* __restrict__ mxl, const float* __restrict__ myl,
    float* __restrict__ fx, float* __restrict__ fy, int kcap, int chunks,
    float g) {
  extern __shared__ __align__(16) float4 sp[];  // used slots: (x, y, m, 0)
  int* sslot = reinterpret_cast<int*>(sp + kcap);  // compacted -> slot
  __shared__ float stencil[3][8];
  __shared__ int iscratch[32];

  const int cell = blockIdx.x / chunks;
  const int chunk = blockIdx.x - cell * chunks;
  const int64_t base = (int64_t)cell * kcap;
  if (threadIdx.x < 8) {
    const int64_t s = (int64_t)cell * 8 + threadIdx.x;
    stencil[0][threadIdx.x] = ml[s];
    stencil[1][threadIdx.x] = mxl[s];
    stencil[2][threadIdx.x] = myl[s];
  }
  const int n = block_compact(
      kcap,
      [&](int i) {
        Slot v = {false, 0.0f, 0.0f, 0.0f, 0};
        if (i < kcap) {
          const float mi = m[base + i];
          v = {mi > 0.0f, x[base + i], y[base + i], mi, 0};
        }
        return v;
      },
      [&](int i, int c, const Slot& v) {
        if (c >= 0) {
          sp[c] = make_float4(v.x, v.y, v.m, 0.0f);
          sslot[c] = i;
        } else if (chunk == 0) {
          fx[base + i] = 0.0f;
          fy[base + i] = 0.0f;
        }
      },
      iscratch);

  const int stride = chunks * blockDim.x * kRows;
  for (int q0 = (chunk * blockDim.x + threadIdx.x) * kRows; q0 < n;
       q0 += stride)
    force_rows<kRows>(sp, sslot, n, q0, stencil, g, fx + base, fy + base);
}

// Per-slot first-pair ranks and the per-cell count, no force. With no pid
// (pid == nullptr) the slot index stands for it, so a slot's rank is the
// number of alive slots before it (_slot_iota_pid in the Pallas module).
//
// Bound: the bytes of the row (alive and ft of every slot, x and y of the
// alive ones); the hit test's arithmetic on near pairs is small beside
// them. The alive slots are compacted once and put in x buckets, so the hit
// sweep visits only pairs in one bucket or neighbouring ones; the ranks and
// count cost O(na) beyond that, except the pid ranks (O(na^2) over the
// block, in hit cells only). The cells' counts are added into one total,
// zeroed before the launch (integer atomics: exact in any order). -Xptxas -v on
// sm_90a: 32 registers, 256 bytes of static shared memory, no spills; 24 K
// bytes of dynamic shared memory (32 K with a pid).
__global__ void __launch_bounds__(kMaxCollThreads) dense_collisions_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ alive, const int* __restrict__ pid,
    int* __restrict__ ft, int* __restrict__ total, int kcap, float eps2) {
  // (x, y) pairs, then four (K,) int arrays (six with a pid).
  extern __shared__ __align__(16) float2 sxy[];
  const bool ranked = pid != nullptr;
  AliveSlots c;
  c.xy = sxy;
  c.slot = reinterpret_cast<int*>(sxy + kcap);
  c.ft = c.slot + kcap;
  c.order = c.ft + kcap;
  c.bend = c.order + kcap;
  c.rank = c.bend + kcap;
  c.inv = c.rank + kcap;
  __shared__ float fscratch[32];
  __shared__ int iscratch[32];

  const int64_t base = (int64_t)blockIdx.x * kcap;
  c.n = block_compact(
      kcap,
      [&](int i) {
        Slot v = {false, 0.0f, 0.0f, 0.0f, 0};
        if (i < kcap) {
          v = {alive[base + i] > 0, x[base + i], y[base + i], 0.0f,
               ranked ? pid[base + i] : 0};
        }
        return v;
      },
      [&](int i, int a, const Slot& v) {
        c.bend[i] = 0;
        if (a < 0) {
          ft[base + i] = kInf;
          return;
        }
        c.xy[a] = make_float2(v.x, v.y);
        c.slot[a] = i;
        c.ft[a] = kInf;
        if (ranked) c.inv[a] = v.pid;
      },
      iscratch);

  bucket_by_x(c, eps2, fscratch, iscratch);
  int count = 0;
  if (!ranked || cell_has_hit<false>(c, eps2))
    count = cell_collisions<false>(c, ranked, kcap, eps2, iscratch);
  if (threadIdx.x == 0 && count > 0) atomicAdd(total, count);
  for (int a = threadIdx.x; a < c.n; a += blockDim.x)
    ft[base + c.slot[a]] = c.ft[a];
}

// The supercell engine's per-cell sums (the one-hot contractions
// einsum("rk,rks->rs") of ops/supercell.py): M, sum m x and sum m y of every
// true cell, from the (rows, K) tiles of mf, mf x and mf y and each slot's
// true cell (-1 for a slot that is not binned; an index outside [0, ncells)
// counts in no cell). Each true cell's slots lie
// in one row, so one block per row writes its cells' sums with no atomics;
// each cell's leader (its first slot in the row) adds the cell's slots in
// slot order, so the result is the same bits in every run (and equals a
// sequential index_add in slot order). The caller zeroes the outputs.
//
// Bound: the bytes, 16 a slot read and 12 a true cell written; the adds
// are few. Leader test and sum scan the staged labels, O(K) a leader.
__global__ void __launch_bounds__(kMaxThreads) cell_sums_kernel(
    const float* __restrict__ mf, const float* __restrict__ mfx,
    const float* __restrict__ mfy, const int* __restrict__ cell,
    float* __restrict__ M, float* __restrict__ SX, float* __restrict__ SY,
    int kcap, int ncells) {
  extern __shared__ int scell[];
  const int64_t base = (int64_t)blockIdx.x * kcap;
  for (int i = threadIdx.x; i < kcap; i += blockDim.x)
    scell[i] = cell[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < kcap; i += blockDim.x) {
    const int c = scell[i];
    if (c < 0 || c >= ncells) continue;
    bool lead = true;
    for (int j = 0; j < i && lead; ++j) lead = scell[j] != c;
    if (!lead) continue;
    float m = 0.0f, sx = 0.0f, sy = 0.0f;
    for (int j = i; j < kcap; ++j) {
      if (scell[j] != c) continue;
      m += mf[base + j];
      sx += mfx[base + j];
      sy += mfy[base + j];
    }
    M[c] = m;
    SX[c] = sx;
    SY[c] = sy;
  }
}

struct FusedArgs {
  const float *x, *y, *mf;
  const int *alive, *pid, *sub;
  float *fx, *fy;
  int *ft, *total;
  int ncells, kcap;
  float eps2, g;
};

template <bool kV4, bool kCollide, bool kGate, int kRows, bool kSub>
cudaError_t launch_fused(const FusedArgs& a, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(kSub ? 12 : 11) * a.kcap * sizeof(float);
  auto kernel = fused_pairs_kernel<kV4, kCollide, kGate, kRows, kSub>;
  if constexpr (kSub) {
    // Over 48 KB at K = 1024 with the static scratch: opt in, once for each
    // instantiation and size larger than any before.
    static size_t opted = 0;
    if (smem > opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      opted = smem;
    }
  }
  kernel<<<a.ncells, threads, smem, stream>>>(a.x, a.y, a.mf, a.alive, a.pid,
                                              a.sub, a.fx, a.fy, a.ft,
                                              a.total, a.kcap, a.eps2, a.g);
  return cudaGetLastError();
}

template <bool kV4, int kRows>
cudaError_t dispatch_fused(const FusedArgs& a, int collide, int gate,
                           int threads, cudaStream_t s) {
  if (a.sub != nullptr && collide)  // labelled: hit-gated only
    return launch_fused<kV4, true, true, kRows, true>(a, threads, s);
  if (a.sub != nullptr)
    return launch_fused<kV4, false, true, kRows, true>(a, threads, s);
  if (!collide)
    return launch_fused<kV4, false, true, kRows, false>(a, threads, s);
  if (gate)
    return launch_fused<kV4, true, true, kRows, false>(a, threads, s);
  return launch_fused<kV4, true, false, kRows, false>(a, threads, s);
}

bool whole_warps(int threads, int most) {
  return threads >= 32 && threads <= most && threads % 32 == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for a launch
// shape it does not take).
//
// total: one int, the count summed over the cells (0 with collide off);
// sub: the same-cell labels, or null for the unlabelled kernels (the
// labelled form is hit-gated only); rows: receivers per thread (1 or 2);
// threads per block.
extern "C" int psim_fused_pairs(const float* x, const float* y, const float* mf,
                                const int* alive, const int* pid,
                                const int* sub, float* fx, float* fy, int* ft,
                                int* total, int ncells, int kcap, float eps2,
                                float g, int collide, int v4, int gate,
                                int rows, int threads, void* stream) {
  if (!whole_warps(threads, kMaxThreads) || (rows != 1 && rows != 2) ||
      (sub != nullptr && !gate))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(total, 0, sizeof(int), s);
  const FusedArgs a = {x, y, mf, alive, pid, sub, fx, fy, ft, total,
                       ncells, kcap, eps2, g};
  if (v4 && rows == 1)
    return (int)dispatch_fused<true, 1>(a, collide, gate, threads, s);
  if (v4) return (int)dispatch_fused<true, 2>(a, collide, gate, threads, s);
  if (rows == 1)
    return (int)dispatch_fused<false, 1>(a, collide, gate, threads, s);
  return (int)dispatch_fused<false, 2>(a, collide, gate, threads, s);
}

// rows, threads: as for psim_fused_pairs; chunks: blocks per cell.
extern "C" int psim_dense_forces(const float* x, const float* y, const float* m,
                                 const float* ml, const float* mxl,
                                 const float* myl, float* fx, float* fy,
                                 int ncells, int kcap, float g, int rows,
                                 int threads, int chunks, void* stream) {
  if (!whole_warps(threads, kMaxThreads) || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kcap * (sizeof(float4) + sizeof(int));
  const dim3 grid((unsigned)ncells * (unsigned)chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1)
    dense_forces_kernel<1><<<grid, threads, smem, s>>>(
        x, y, m, ml, mxl, myl, fx, fy, kcap, chunks, g);
  else if (rows == 2)
    dense_forces_kernel<2><<<grid, threads, smem, s>>>(
        x, y, m, ml, mxl, myl, fx, fy, kcap, chunks, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// total: one int, the count summed over the cells.
extern "C" int psim_dense_collisions(const float* x, const float* y,
                                     const int* alive, const int* pid, int* ft,
                                     int* total, int ncells, int kcap,
                                     float eps2, int threads, void* stream) {
  if (!whole_warps(threads, kMaxCollThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(total, 0, sizeof(int), s);
  const size_t smem = (size_t)kcap * (pid != nullptr ? 8 : 6) * sizeof(int);
  dense_collisions_kernel<<<ncells, threads, smem, s>>>(x, y, alive, pid, ft,
                                                         total, kcap, eps2);
  return (int)cudaGetLastError();
}

// out: (3, ncells) floats, M, sum m x, sum m y; zeroed here, then each row's
// cells written by one block of a warp per 32 slots (at most 256 threads).
extern "C" int psim_cell_sums(const float* mf, const float* mfx,
                              const float* mfy, const int* cell, float* out,
                              int rows, int kcap, int ncells, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, (size_t)3 * ncells * sizeof(float), s);
  const int warps = (kcap + 31) / 32;
  const int threads = warps < kMaxThreads / 32 ? warps * 32 : kMaxThreads;
  cell_sums_kernel<<<rows, threads, (size_t)kcap * sizeof(int), s>>>(
      mf, mfx, mfy, cell, out, out + ncells, out + 2 * (size_t)ncells, kcap,
      ncells);
  return (int)cudaGetLastError();
}
