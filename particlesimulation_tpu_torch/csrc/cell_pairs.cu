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
//   labelled_warp_kernel (rows of K <= 64, a warp a row) and
//     fused_pairs_kernel<kV4, kCollide, true, kRows, kSub = true> (wider
//     rows): the `sub` argument of ops/dense_xla.py fused_pairs_v2 /
//     fused_pairs_v4, a same-cell label per slot (pairs of unequal labels
//     neither interact nor collide); both loop each receiver over its own
//     label's slots only;
//   cell_sums_kernel: the per-cell mass and moment sums of
//     ops/supercell.py (one-hot contractions on the TPU's matrix unit), a
//     warp a row.
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
// Design: each block stages one cell row in shared memory (the labelled
// kernel's rows of K <= 64: each warp one row), and compacts the slots it
// needs (alive ones for collisions, used ones, m > 0, for the forces) in
// slot order with one block scan (block_compact; ballots in a warp), so
// that every loop runs over those slots only. Every force loop goes through
// one pair term (pair_term): float4 partners, kRows receivers a thread.
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
//
// Every kernel takes rows of K <= kMaxK = 4096 slots, the JAX package's
// MAX_XLA_KCAP (the widest tile its XLA kernels run; its Pallas kernels stop
// at 1024, which the port's engines keep as the cap of JAX's "pallas"
// route). A kernel that stages a row in shared memory takes K-sized arrays
// there, more than the 48 KB a block may use without asking once K passes
// ~1000; each launch asks for what its K needs (opt_in), up to the 227 KB a
// block may have on an H100, and fails (no launch) where the request does.
// At K <= 1024 the launches are the ones they were before wider rows came:
// the same shapes and shared memory, and so the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7FFFFFFF;
constexpr int kMaxThreads = 256;       // fused and force kernels
constexpr int kMaxCollThreads = 1024;  // collision kernel
constexpr int kMaxK = 4096;            // widest row (tile capacity K)
constexpr int kSlotBits = 12;          // bits of a slot index below kMaxK
static_assert((1 << kSlotBits) >= kMaxK, "slot indices must fit kSlotBits");
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

// The threads that work on one cell row together: the whole block, or one
// warp of it (the labelled kernel's rows of K <= 64, several rows a block).
// The collision helpers below take either; with BlockGroup they are the
// block-wide code they were written as.
struct BlockGroup {
  __device__ static int rank() { return threadIdx.x; }
  __device__ static int size() { return blockDim.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static bool any(int p) { return __syncthreads_or(p) != 0; }
};

struct WarpGroup {
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static int size() { return 32; }
  __device__ static void sync() { __syncwarp(); }
  __device__ static bool any(int p) {
    __syncwarp();  // a barrier for shared memory, as __syncthreads_or is
    return __any_sync(kFull, p) != 0;
  }
};

// Sum over the group; its size is a multiple of 32. Every thread gets the
// total. scratch holds 32 entries (the group's own).
template <class G, typename T>
__device__ T group_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = G::rank() & 31;
  const int warp = G::rank() >> 5;
  G::sync();  // earlier readers of scratch are done
  if (lane == 0) scratch[warp] = v;
  G::sync();
  if (warp == 0) {
    v = (lane < (G::size() >> 5)) ? scratch[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) scratch[0] = v;
  }
  G::sync();
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

// Exclusive prefix sum of v[0, len) in place, over the group; returns the
// total to every thread. The group's size is a multiple of 32; scratch holds
// 32.
template <class G>
__device__ int group_scan(int* v, int len, int* scratch) {
  const int lane = G::rank() & 31;
  const int warp = G::rank() >> 5;
  const int nwarps = G::size() >> 5;
  int carry = 0;
  for (int i0 = 0; i0 < len; i0 += G::size()) {
    const int i = i0 + G::rank();
    const int x = i < len ? v[i] : 0;
    int w = x;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    if (lane == 31) scratch[warp] = w;
    G::sync();
    int t = lane < nwarps ? scratch[lane] : 0;  // ... and over the warps
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    const int before = __shfl_sync(kFull, t, (warp + 31) & 31);
    if (i < len) v[i] = carry + (warp > 0 ? before : 0) + w - x;
    carry += __shfl_sync(kFull, t, 31);
    G::sync();
  }
  return carry;
}

// group_scan over the block, for the kernels' own use: nvcc 12.9's front
// end fails (an internal error) on group_scan<BlockGroup> called directly
// in a kernel template.
__device__ int block_scan(int* v, int len, int* scratch) {
  return group_scan<BlockGroup>(v, len, scratch);
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
// bucket or in neighbouring ones. The rounding, at n <= kMaxK = 4096: a
// slot's u = fl(fl(x - xmin) * rh) is within 2 u_r of (x - xmin) rh, u_r =
// 2^-24, and u <= nb (1 + 2 u_r), so within 2^-23 nb < 5e-4 of a bucket
// (2e-4 at n <= 1024); rh is one value for every slot, so it scales the
// whole row alike, by a factor within 3 u_r of 1 / width. Two slots less
// than eps <= width / 2 apart then have u's less than 0.5 (1 + 3 u_r) +
// 1e-3 < 1 apart, and buckets (int)u at most one apart. A count, a scan
// and a scatter: five barriers, where a sorting network of n = 100 needs
// 28 and a comparison sort n^2 compares.
// c.bend must hold zeros for the first n buckets. fscratch and iscratch hold
// 32 entries each.
template <class G>
__device__ void bucket_by_x(AliveSlots& c, float eps2, float* fscratch,
                            int* iscratch) {
  float lo = __int_as_float(0x7F800000), hi = -lo;  // +inf, -inf
  for (int a = G::rank(); a < c.n; a += G::size()) {
    lo = fminf(lo, c.xy[a].x);
    hi = fmaxf(hi, c.xy[a].x);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const int lane = G::rank() & 31;
  if (lane == 0) {
    fscratch[G::rank() >> 5] = lo;
    iscratch[G::rank() >> 5] = __float_as_int(hi);
  }
  G::sync();
  for (int w = 0; w < (G::size() >> 5); ++w) {
    lo = fminf(lo, fscratch[w]);
    hi = fmaxf(hi, __int_as_float(iscratch[w]));
  }
  c.nb = max(c.n, 1);
  c.xmin = lo;
  c.rh = 1.0f / fmaxf(2.0f * sqrtf(eps2), (hi - lo) / c.nb);
  for (int a = G::rank(); a < c.n; a += G::size())
    atomicAdd(&c.bend[c.bucket(c.xy[a].x)], 1);
  G::sync();  // also: every thread has read the scratch
  group_scan<G>(c.bend, c.nb, iscratch);
  for (int a = G::rank(); a < c.n; a += G::size())
    c.order[atomicAdd(&c.bend[c.bucket(c.xy[a].x)], 1)] = a;
  G::sync();
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
template <class G, bool kSub, typename Hit>
__device__ __forceinline__ void sweep_near(const AliveSlots& c, float eps2,
                                           Hit hit) {
  for (int p = G::rank(); p < c.n; p += G::size()) {
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

// The x-bucket sweep as a near-pair search: near(hit) calls sweep_near.
template <class G, bool kSub>
struct BucketSearch {
  const AliveSlots* c;
  float eps2;
  template <typename Hit>
  __device__ void operator()(Hit hit) const {
    sweep_near<G, kSub>(*c, eps2, hit);
  }
};

// Whether near(hit) finds any pair within eps (the same answer in every
// thread of the group). near is a near-pair search: it calls hit(a, b) for
// every pair of alive slots that may collide (BucketSearch, or RunSearch:
// the labelled warp kernel's search within label runs).
template <class G, typename Near>
__device__ bool cell_has_hit(Near near) {
  int found = 0;
  near([&](int, int) { found = 1; });
  return G::any(found);
}

// Collision outputs of one cell, its near pairs found by near(hit): each
// slot's min first-pair rank into c.ft, and the count of pairs first for
// both ends (returned to every thread). With `ranked`, the pid ranks go to
// c.rank and c.inv becomes the inverse; without it, the rank is the
// compacted index (slot order stands for pid order). In the labelled
// kernels only pairs of equal labels hit; the ranks stay the row's.
template <class G, typename Near>
__device__ int cell_collisions(const AliveSlots& c, bool ranked, int kcap,
                               Near near, int* iscratch) {
  const int tid = G::rank();
  const int nt = G::size();
  if (ranked) {
    for (int a = tid; a < c.n; a += nt) {
      const int p = c.inv[a];
      int r = 0;
      for (int b = 0; b < c.n; ++b) r += c.inv[b] < p ? 1 : 0;
      c.rank[a] = r;
    }
    G::sync();
    for (int a = tid; a < c.n; a += nt) c.inv[c.rank[a]] = a;
  }
  const int kb = kcap + 1;
  int found = 0;
  near([&](int a, int b) {
    const int ra = ranked ? c.rank[a] : a;
    const int rb = ranked ? c.rank[b] : b;
    const int rank = min(ra, rb) * kb + max(ra, rb);
    atomicMin(&c.ft[a], rank);
    atomicMin(&c.ft[b], rank);
    found = 1;
  });
  if (!G::any(found)) return 0;  // no hit: every ft is INF
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
  return group_sum<G>(local, iscratch);
}

// One partner's term on one receiver (x_i, y_i, label l_i) of the pair
// sums below: w = m_j / |d|^3 (0 where d^2 == 0, and with kSub where the
// labels differ), d^2 with one FMA and 1/|d| on the rsqrt unit alone, then
//   v2 (kV4 = false): ax += w dx, ay += w dy            (12 instructions);
//   v4 (kV4 = true):  ax += w x_j, ay += w y_j, aw += w  (13).
// A masked pair adds fmaf(0, v, a) == a: exactly nothing, since a sum that
// starts at +0 never becomes -0. Every pair loop of this file goes through
// this one body, so all of them round alike.
template <bool kV4, bool kSub>
__device__ __forceinline__ void pair_term(const float4 pj, float xi, float yi,
                                          int li, float& ax, float& ay,
                                          float& aw) {
  const float dx = pj.x - xi;
  const float dy = pj.y - yi;
  const float d2 = fmaf(dx, dx, dy * dy);
  const float inv = d2 > 0.0f ? rsqrt_ftz(d2) : 0.0f;
  float w = pj.z * (inv * inv * inv);
  if (kSub && __float_as_int(pj.w) != li) w = 0.0f;
  if (kV4) {
    ax = fmaf(w, pj.x, ax);
    ay = fmaf(w, pj.y, ay);
    aw += w;
  } else {
    ax = fmaf(w, dx, ax);
    ay = fmaf(w, dy, ay);
  }
}

// The pair sums of the used slots q0 .. q0 + kRows - 1 (receivers past n
// take a copy of the last one) of a row compacted into sp as float4
// (x, y, m, 0), or with kSub (x, y, m, label bits), over the np partners
// pp[0, np) in order (sp itself, or with kSub the run of sp that holds the
// receivers' labels); n >= 1.
// One partner load feeds kRows receivers held in registers. The caller
// multiplies the sums by gmi = G m_i once. A receiver's sum runs over the
// same partners in the same order for any kRows and block size.
template <int kRows, bool kV4, bool kSub = false>
__device__ __forceinline__ void pair_sums(const float4* sp, int n, int q0,
                                          const float4* pp, int np, float g,
                                          float (&xi)[kRows],
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
  for (int j = 0; j < np; ++j) {
    const float4 pj = pp[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      pair_term<kV4, kSub>(pj, xi[r], yi[r], li[r], ax[r], ay[r], aw[r]);
  }
}

// Sorts keys[0, n) ascending over the block: a bitonic network whose
// comparators all point up (each merge starts with a reflection), so it
// needs no padding to a power of two: a comparator whose upper end lies past
// n would meet +inf there and is skipped. log2(n)(log2(n) + 1) / 2 steps of
// n / 2 comparators, a barrier each (55 at n = 1024, 78 at n = 4096).
__device__ void block_sort(unsigned long long* keys, int n) {
  for (int k = 2; k < 2 * n; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      const int m = d == (k >> 1) ? k - 1 : d;  // reflect, then half-clean
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ m;
        if (j > i && j < n) {
          const unsigned long long a = keys[i], b = keys[j];
          if (a > b) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
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
// block may take without opting in; 176 KB at K = 4096, opted in, one
// block an SM): the row's x, y, m (3K), and the collision arrays (8K),
// which the used slots' float4 and slot indices (5K) reuse once ft is
// written. The pair ranks a (K + 1) + b stay below 4097^2 < 2^31.
// -Xptxas -v on sm_90a: 31-40 registers, at most 256 bytes of static
// shared memory, no spills.
//
// The labelled form (kSub, the supercell engine's rows of S x S cells) on
// rows of K > 64 (labelled_warp_kernel takes the others): `sub` holds each
// slot's cell within the row, -1 for an unbinned slot. The alive slots'
// labels take a twelfth (K,) array (48 KB at K = 1024, which with the
// static scratch is over 48 KB: the launch opts in; 192 KB at K = 4096),
// and the hit test of sweep_near passes only pairs of equal labels, so the
// gate and the count see only same-cell pairs; ranks stay the row's pid
// ranks. The x-bucket
// sweep stays: it costs O(n) whatever the labels, where grouping the alive
// slots by label first would cost a sort. The v4 centre stays the mean of
// the whole row's used slots, as in the XLA form. Then, unless every used
// slot has one label, the used slots are sorted by (label, compacted index)
// (block_sort over keys that also carry the slot and the compacted index,
// kSlotBits each), and receivers take the sorted order: a thread's kRows
// receivers loop over the runs of their
// labels only, each run in compacted order. A partner of another label (in
// the other receiver's run) adds exactly nothing (pair_term), so every
// receiver sums the same terms in the same order as over the whole row: the
// same bits, with sum(c^2) pairs where the row has n^2. The sorted copy and
// the runs reuse the dead collision and staging arrays: the twelve (K,)
// words still hold it.
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
    bucket_by_x<BlockGroup>(c, eps2, fscratch, iscratch);
    const BucketSearch<BlockGroup, kSub> near = {&c, eps2};
    int count = 0;
    if (!kGate || cell_has_hit<BlockGroup>(near))
      count = cell_collisions<BlockGroup>(c, true, kcap, near, iscratch);
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

  // Receivers and partners in loop order: the compacted slots, or (labelled
  // rows of more than one label) sorted by label, with each sorted
  // position's run and the runs' bounds.
  const float4* psp = sp;
  // label, slot << kSlotBits | index
  const unsigned long long* key = nullptr;
  int* runi = nullptr;                      // sorted position -> run
  int* rs = nullptr;                        // run -> first position
  int* re = nullptr;                        // run -> one past its last
  if (kSub) {
    int differ = 0;
    for (int q = tid; q < n; q += nt)
      differ |= __float_as_int(sp[q].w) != __float_as_int(sp[0].w);
    if (__syncthreads_or(differ)) {
      unsigned long long* keys = reinterpret_cast<unsigned long long*>(
          smem + ((5 * kcap + 1) & ~1));  // over the dead collision arrays
      for (int q = tid; q < n; q += nt)
        keys[q] = (unsigned long long)(unsigned)__float_as_int(sp[q].w) << 32 |
                  (unsigned)sslot[q] << kSlotBits | (unsigned)q;
      __syncthreads();
      block_sort(keys, n);
      float4* ssp = smem4 + 2 * kcap;  // over the dead staging arrays
      for (int p = tid; p < n; p += nt)
        ssp[p] = sp[keys[p] & ((1u << kSlotBits) - 1u)];
      __syncthreads();  // sp and sslot are dead
      runi = reinterpret_cast<int*>(smem);
      rs = runi + kcap;
      re = rs + kcap;
      // p heads a run where its label (bits) differs from p - 1's.
      for (int p = tid; p < n; p += nt)
        runi[p] = p == 0 || __float_as_int(ssp[p].w) !=
                                __float_as_int(ssp[p - 1].w);
      block_scan(runi, n, iscratch);  // heads before p
      for (int p = tid; p < n; p += nt) {
        const bool head =
            p == 0 || __float_as_int(ssp[p].w) != __float_as_int(ssp[p - 1].w);
        const bool tail = p == n - 1 ||
                          __float_as_int(ssp[p + 1].w) != __float_as_int(ssp[p].w);
        const int r = runi[p] - (head ? 0 : 1);
        runi[p] = r;
        if (head) rs[r] = p;
        if (tail) re[r] = p + 1;
      }
      __syncthreads();
      psp = ssp;
      key = keys;
    }
  }

  for (int q0 = tid * kRows; q0 < n; q0 += nt * kRows) {
    float xi[kRows], yi[kRows], gmi[kRows], ax[kRows], ay[kRows], aw[kRows];
    if (kSub && key != nullptr) {  // the receivers' runs
      const int j0 = rs[runi[q0]];
      const int j1 = re[runi[min(q0 + kRows - 1, n - 1)]];
      pair_sums<kRows, kV4, kSub>(psp, n, q0, psp + j0, j1 - j0, g, xi, yi,
                                  gmi, ax, ay, aw);
    } else {  // every partner
      pair_sums<kRows, kV4, kSub>(sp, n, q0, sp, n, g, xi, yi, gmi, ax, ay,
                                  aw);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (q0 + r >= n) break;
      const int i = kSub && key != nullptr
                        ? (int)(key[q0 + r] >> kSlotBits) &
                              ((1 << kSlotBits) - 1)
                        : sslot[q0 + r];
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
  pair_sums<kRows, false>(sp, n, q0, sp, n, g, xi, yi, gmi, ax, ay, aw);
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
// row (20 KB of shared memory at K = 1024; 80 KB at K = 4096, opted in,
// two blocks an SM). One block per cell and chunk, not a grid-stride loop: rows differ in work by n^2, and the
// hardware hands a freed SM the next block (a grid-stride loop measured
// slower on an H100). -Xptxas -v on sm_90a: 48 (kRows = 1) or 64
// registers, 224 bytes of static shared memory, no spills; 20 K bytes of
// dynamic shared memory at K = 1024.
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
// bytes of dynamic shared memory at K = 1024 (32 K with a pid; 96 K and
// 128 K at K = 4096, opted in). At most kMaxCollThreads threads over up to
// kMaxK slots: every loop strides by the block.
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

  bucket_by_x<BlockGroup>(c, eps2, fscratch, iscratch);
  const BucketSearch<BlockGroup, false> near = {&c, eps2};
  int count = 0;
  if (!ranked || cell_has_hit<BlockGroup>(near))
    count = cell_collisions<BlockGroup>(c, ranked, kcap, near, iscratch);
  if (threadIdx.x == 0 && count > 0) atomicAdd(total, count);
  for (int a = threadIdx.x; a < c.n; a += blockDim.x)
    ft[base + c.slot[a]] = c.ft[a];
}

// ---- The labelled pass on rows of K <= 64: a warp a row --------------------
//
// fused_pairs_kernel<..., kSub = true>'s function (the same bits) on the
// supercell engine's own rows: at SMALL, K = 64 and ~30 slots a row are used
// in S^2 = 100 cells, so a block a row would be one warp waiting on ten
// barriers, and the row's pairs of equal labels (sum c^2, ~9) are few beside
// its n^2 (~900). One warp takes a row, several rows a block, and nothing
// waits on the block:
//   * every lane loads its slots l and l + 32 of all six inputs first;
//     ballots and popc compact the alive and the used slots;
//   * a table in shared memory keyed by label (open addressing, 2K slots,
//     so no array is sized by S^2) gives each slot the 64-bit mask of the
//     compacted slots of its label: its run, in compacted (slot) order;
//   * collisions: with runs of at most kShortRun alive slots (the usual
//     case) each alive slot tests the later slots of its run; a row with a
//     longer run (one label for every slot) takes the x-bucket sweep of the
//     block kernel at warp scale. Either finds every pair of one label
//     within eps, so the gate, the ranks, ft and the count are the block
//     kernel's integers (cell_collisions, shared);
//   * the v4 centre is summed as in the block kernel (lane l takes used
//     slots l and l + 32, then the xor tree): the same bits;
//   * forces: lane l is the receiver of its own slots and loops over the
//     union of their runs in compacted order through pair_term, a partner of
//     the other receiver's label adding exactly nothing. Each receiver sums
//     the block kernel's terms in its order, over sum c^2 pairs, not the
//     row's n^2; the lanes write their slots' fx, fy, ft in slot order.
//   * a row of one label takes no table (same_key_masks' vote) and its
//     partners, one span, a counted loop: such rows cost what a loop over
//     the whole row costs.
// Bound: the bytes (six (K,) inputs read, three written); the pair work
// that is left, ~9 pairs and ~30 compactions a row at SMALL, is small beside
// them. -Xptxas -v on sm_90a: 28-52 registers, no spills; 4.1 KB of shared
// memory a warp (WarpRow).
constexpr int kWarpK = 64;        // widest row of the warp kernel
constexpr int kTabLog = 7;
constexpr int kTab = 1 << kTabLog;  // label table slots: 2 kWarpK
constexpr int kShortRun = 8;      // longest run tested within runs
constexpr int kMaxWarpRows = 16;  // rows (warps) a block
constexpr int kEmpty = (int)0x80000000;  // a free table slot

// One warp's shared memory: the collision arrays, which the force phase's
// used slots reuse, and the label table.
struct WarpRow {
  union {
    struct {
      float2 xy[kWarpK];
      int slot[kWarpK], rank[kWarpK], inv[kWarpK], ft[kWarpK],
          order[kWarpK], bend[kWarpK], lab[kWarpK];
    } c;
    struct {
      float4 sp[kWarpK];   // used slots: (x, y, m_post, label bits)
      float2 cxy[kWarpK];  // used slots' raw x, y: the v4 centre's order
    } f;
  };
  unsigned long long mask[kTab + 1];
  int key[kTab + 1];
  int iscratch[32];
  float fscratch[32];
};

// The slot of key k in a warp's label table, claimed for k if it is free
// (linear probing; at most kWarpK keys in kTab slots). kEmpty, which marks a
// free slot, has the extra last slot to itself.
__device__ int table_slot(int* tkey, int k) {
  if (k == kEmpty) return kTab;
  unsigned h = ((unsigned)k * 0x9E3779B1u) >> (32 - kTabLog);
  for (;;) {
    const int old = atomicCAS(&tkey[h], kEmpty, k);
    if (old == kEmpty || old == k) return (int)h;
    h = (h + 1) & (kTab - 1);
  }
}

// For each of a lane's kP slots with index idx[p] >= 0 (< 64), the mask of
// the indices whose key equals its key[p] (0 where idx[p] < 0), through a
// warp's table of kTab + 1 keys tkey and masks tmask, cleared first.
template <int kP>
__device__ void same_key_masks(int* tkey, unsigned long long* tmask,
                               const int (&key)[kP], const int (&idx)[kP],
                               unsigned long long (&out)[kP]) {
  // Where every index has lane 0's first key (a row of one label) the mask
  // is the indices' own, without the table: two votes, where the table would
  // serialise every lane's atomics on one slot.
  const int k0 = __shfl_sync(kFull, key[0], 0);
  unsigned long long mine = 0ull;
  bool one = true;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (idx[p] >= 0) mine |= 1ull << idx[p];
    one = one && (idx[p] < 0 || key[p] == k0);
  }
  if (__all_sync(kFull, one)) {
    const unsigned long long all =
        (unsigned long long)__reduce_or_sync(kFull, (unsigned)(mine >> 32))
            << 32 |
        __reduce_or_sync(kFull, (unsigned)mine);
#pragma unroll
    for (int p = 0; p < kP; ++p) out[p] = idx[p] >= 0 ? all : 0ull;
    __syncwarp();  // as the table's path: earlier shared writes are visible
    return;
  }
  for (int e = threadIdx.x & 31; e <= kTab; e += 32) {
    tkey[e] = kEmpty;
    tmask[e] = 0ull;
  }
  __syncwarp();
  int ent[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    ent[p] = idx[p] >= 0 ? table_slot(tkey, key[p]) : -1;
    if (ent[p] >= 0) atomicOr(&tmask[ent[p]], 1ull << idx[p]);
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kP; ++p) out[p] = ent[p] >= 0 ? tmask[ent[p]] : 0ull;
  __syncwarp();  // the table may be cleared again
}

// The warp kernel's near-pair search within label runs: each of a lane's
// alive slots (alive index ai[p], position xv[p], yv[p], its run's alive
// slots am[p]) tests the later slots of its run.
template <int kP>
struct RunSearch {
  const float2* xy;
  const int* ai;
  const unsigned long long* am;
  const float* xv;
  const float* yv;
  float eps2;
  template <typename Hit>
  __device__ void operator()(Hit hit) const {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (ai[p] < 0) continue;
      unsigned long long m = am[p] & ~((2ull << ai[p]) - 1ull);
      while (m) {
        const int b = __ffsll((long long)m) - 1;
        m &= m - 1;
        const float2 pb = xy[b];
        if (dist2(xv[p], yv[p], pb.x, pb.y) < eps2) hit(ai[p], b);
      }
    }
  }
};

// kP = ceil(K / 32) slots a lane; a block of 32 x (rows a block) threads.
template <bool kV4, bool kCollide, int kP>
__global__ void __launch_bounds__(kMaxWarpRows * 32) labelled_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ mf, const int* __restrict__ alive,
    const int* __restrict__ pid, const int* __restrict__ sub,
    float* __restrict__ fx, float* __restrict__ fy, int* __restrict__ ft,
    int* __restrict__ total, int ncells, int kcap, float eps2, float g) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= ncells) return;  // a whole warp; nothing waits on the block
  WarpRow& s = reinterpret_cast<WarpRow*>(wsmem)[threadIdx.x >> 5];
  const int64_t base = (int64_t)row * kcap;
  const unsigned below = (1u << lane) - 1u;

  float xv[kP], yv[kP], mv[kP];
  int av[kP], pv[kP], lv[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {  // every load first
    const int i = lane + 32 * p;
    xv[p] = yv[p] = mv[p] = 0.0f;
    av[p] = pv[p] = lv[p] = 0;
    if (i < kcap) {
      xv[p] = x[base + i];
      yv[p] = y[base + i];
      mv[p] = mf[base + i];
      lv[p] = sub[base + i];
      if (kCollide) {
        av[p] = alive[base + i];
        pv[p] = pid[base + i];
      }
    }
  }

  int ai[kP];                 // alive index, or -1
  unsigned ab[kP];            // the alive ballots
  unsigned long long am[kP];  // the alive slots of each one's label
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    ab[p] = 0u;
    am[p] = 0ull;
  }
  if (kCollide) {
    AliveSlots c;
    c.xy = s.c.xy;
    c.slot = s.c.slot;
    c.rank = s.c.rank;
    c.inv = s.c.inv;
    c.ft = s.c.ft;
    c.order = s.c.order;
    c.bend = s.c.bend;
    c.lab = s.c.lab;
    c.n = 0;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const bool al = av[p] > 0;
      ab[p] = __ballot_sync(kFull, al);
      ai[p] = al ? c.n + __popc(ab[p] & below) : -1;
      c.n += __popc(ab[p]);
      if (al) {
        c.xy[ai[p]] = make_float2(xv[p], yv[p]);
        c.inv[ai[p]] = pv[p];
        c.ft[ai[p]] = kInf;
        c.lab[ai[p]] = lv[p];
      }
    }
    same_key_masks<kP>(s.key, s.mask, lv, ai, am);
    int run = 0;
#pragma unroll
    for (int p = 0; p < kP; ++p) run = max(run, __popcll(am[p]));
    run = __reduce_max_sync(kFull, run);
    int count = 0;
    if (run <= kShortRun) {
      const RunSearch<kP> near = {c.xy, ai, am, xv, yv, eps2};
      if (cell_has_hit<WarpGroup>(near))
        count = cell_collisions<WarpGroup>(c, true, kcap, near, s.iscratch);
    } else {
      for (int b = lane; b < kWarpK; b += 32) c.bend[b] = 0;
      __syncwarp();
      bucket_by_x<WarpGroup>(c, eps2, s.fscratch, s.iscratch);
      const BucketSearch<WarpGroup, true> near = {&c, eps2};
      if (cell_has_hit<WarpGroup>(near))
        count = cell_collisions<WarpGroup>(c, true, kcap, near, s.iscratch);
    }
    if (lane == 0 && count > 0) atomicAdd(total, count);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int i = lane + 32 * p;
      const int f = ai[p] >= 0 ? c.ft[ai[p]] : kInf;
      if (i < kcap) ft[base + i] = f;
      if (f != kInf) mv[p] = 0.0f;  // m_post
    }
    __syncwarp();  // the collision arrays are dead
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (lane + 32 * p < kcap) ft[base + lane + 32 * p] = kInf;
  }

  // The used slots (m_post > 0), compacted in slot order.
  int qi[kP];
  unsigned ub[kP];
  int n = 0;
  bool same = kCollide;  // the used slots are the alive ones
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const bool used = mv[p] > 0.0f;
    ub[p] = __ballot_sync(kFull, used);
    qi[p] = used ? n + __popc(ub[p] & below) : -1;
    n += __popc(ub[p]);
    if (used) s.f.cxy[qi[p]] = make_float2(xv[p], yv[p]);
    if (kCollide) same = same && ub[p] == ab[p];
  }
  __syncwarp();
  float cx = 0.0f, cy = 0.0f;
  if (kV4) {  // the block kernel's centre, in its order
    float sumx = 0.0f, sumy = 0.0f;
    for (int q = lane; q < n; q += 32) {
      sumx += s.f.cxy[q].x;
      sumy += s.f.cxy[q].y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      sumx += __shfl_xor_sync(kFull, sumx, o);
      sumy += __shfl_xor_sync(kFull, sumy, o);
    }
    const float nrow = fmaxf((float)n, 1.0f);
    cx = sumx / nrow;
    cy = sumy / nrow;
  }
  float xi[kP], yi[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    xi[p] = kV4 ? xv[p] - cx : xv[p];
    yi[p] = kV4 ? yv[p] - cy : yv[p];
    if (qi[p] >= 0)
      s.f.sp[qi[p]] = make_float4(xi[p], yi[p], mv[p], __int_as_float(lv[p]));
  }
  unsigned long long um[kP];  // the used slots of each one's label
  if (same) {
#pragma unroll
    for (int p = 0; p < kP; ++p) um[p] = am[p];
    __syncwarp();
  } else {
    same_key_masks<kP>(s.key, s.mask, lv, qi, um);
  }

  float gmi[kP], ax[kP], ay[kP], aw[kP];
  unsigned long long runs = 0ull;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    gmi[p] = g * mv[p];
    ax[p] = ay[p] = aw[p] = 0.0f;
    runs |= um[p];
  }
  const int lo = runs ? __ffsll((long long)runs) - 1 : 0;
  const int hi = runs ? 64 - __clzll((long long)runs) : 0;
  if (__popcll(runs) == hi - lo) {
    // The partners make one span (a row of one label, say): a counted loop.
#pragma unroll 2
    for (int j = lo; j < hi; ++j) {
      const float4 pj = s.f.sp[j];
#pragma unroll
      for (int p = 0; p < kP; ++p)
        pair_term<kV4, true>(pj, xi[p], yi[p], lv[p], ax[p], ay[p], aw[p]);
    }
  } else {
    while (runs) {
      const int j = __ffsll((long long)runs) - 1;
      runs &= runs - 1;
      const float4 pj = s.f.sp[j];
#pragma unroll
      for (int p = 0; p < kP; ++p)
        pair_term<kV4, true>(pj, xi[p], yi[p], lv[p], ax[p], ay[p], aw[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int i = lane + 32 * p;
    if (i >= kcap) continue;
    float ox = 0.0f, oy = 0.0f;
    if (qi[p] >= 0) {
      if (kV4) {  // G m_i (sum w xl_j - xl_i sum w)
        ox = gmi[p] * fmaf(-xi[p], aw[p], ax[p]);
        oy = gmi[p] * fmaf(-yi[p], aw[p], ay[p]);
      } else {
        ox = ax[p] * gmi[p];
        oy = ay[p] * gmi[p];
      }
    }
    fx[base + i] = ox;
    fy[base + i] = oy;
  }
}

// ---- The supercell engine's per-cell sums ---------------------------------
//
// The one-hot contractions einsum("rk,rks->rs") of ops/supercell.py: M,
// sum m x and sum m y of every true cell, from the (rows, K) tiles of mf,
// mf x and mf y and each slot's true cell (-1 for a slot that is not
// binned; an index outside [0, ncells) counts in no cell). Each true cell's
// slots lie in one row, so each row's cells are written by one warp with no
// atomics on the output, and each cell's sums are its slots' values added in
// slot order from 0.0f: the same bits in every run, equal to a sequential
// index_add in slot order (the CPU plain version).
//
// Bound: the bytes, 16 a slot read and 12 a true cell written (the caller's
// zeroing included). Design: one warp a row, several rows a block, each
// lane loading its slots once, coalesced; no slot scans the others.
// Rows of K <= 64 (cell_sums_warp_kernel, SMALL's): the labelled kernel's
// table keyed by cell gives each slot the 64-bit mask of its cell's slots;
// the first of them sums them in slot order and writes the cell. Wider rows
// (cell_sums_kernel): the warp reads its row 32 slots a round, the next
// round's loads issued before this round's work; within a round
// __match_any_sync groups the lanes by cell, and the group's first lane adds
// the group's values, in lane order, onto its cell's entry of a table in
// shared memory (open addressing on the cell id, at least 2K slots), which
// carries the sums of earlier rounds; then the warp writes its row's cells
// from the table. (__match_any_sync on SMALL's rows took 0.029 device ms
// where the bytes need 0.005; the mask table takes the rows of K <= 64.)
struct SumEntry {
  int key;  // true cell, -1 for a free slot
  float m, sx, sy;
};

// One warp's shared memory in cell_sums_warp_kernel.
struct SumsRow {
  unsigned long long mask[kTab + 1];
  int key[kTab + 1];
  float4 sv[kWarpK];  // each slot's (m, m x, m y)
};

// The cell sums on rows of K <= 64 (kP = ceil(K / 32) slots a lane): the
// label table of the labelled warp kernel (same_key_masks) gives each slot
// the mask of its row's slots in its cell, so no slot scans the others and
// no warp-wide match runs; the cell's first slot adds the masked slots'
// values in slot order and writes its cell.
template <int kP>
__global__ void __launch_bounds__(kMaxThreads) cell_sums_warp_kernel(
    const float* __restrict__ mf, const float* __restrict__ mfx,
    const float* __restrict__ mfy, const int* __restrict__ cell,
    float* __restrict__ M, float* __restrict__ SX, float* __restrict__ SY,
    int rows, int kcap, int ncells) {
  extern __shared__ __align__(16) unsigned char csmem[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp; nothing waits on the block
  SumsRow& s = reinterpret_cast<SumsRow*>(csmem)[threadIdx.x >> 5];
  const int64_t base = (int64_t)row * kcap;
  int cv[kP], idx[kP];
  float4 v[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int i = lane + 32 * p;
    cv[p] = -1;
    v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < kcap) {
      cv[p] = cell[base + i];
      v[p] = make_float4(mf[base + i], mfx[base + i], mfy[base + i], 0.0f);
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    idx[p] = cv[p] >= 0 && cv[p] < ncells ? lane + 32 * p : -1;
    s.sv[lane + 32 * p] = v[p];
  }
  unsigned long long mates[kP];
  same_key_masks<kP>(s.key, s.mask, cv, idx, mates);  // syncs the stage too
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (idx[p] < 0 || (mates[p] & ((1ull << idx[p]) - 1ull))) continue;
    float m = 0.0f, sx = 0.0f, sy = 0.0f;
    for (unsigned long long g = mates[p]; g; g &= g - 1) {
      const float4 u = s.sv[__ffsll((long long)g) - 1];
      m += u.x;
      sx += u.y;
      sy += u.z;
    }
    M[cv[p]] = m;
    SX[cv[p]] = sx;
    SY[cv[p]] = sy;
  }
}

__global__ void __launch_bounds__(kMaxThreads) cell_sums_kernel(
    const float* __restrict__ mf, const float* __restrict__ mfx,
    const float* __restrict__ mfy, const int* __restrict__ cell,
    float* __restrict__ M, float* __restrict__ SX, float* __restrict__ SY,
    int rows, int kcap, int ncells, int tlog) {
  extern __shared__ __align__(16) SumEntry stab[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp; nothing waits on the block
  const int tsize = 1 << tlog;
  SumEntry* tab = stab + (size_t)(threadIdx.x >> 5) * (tsize + 32);
  float4* stage = reinterpret_cast<float4*>(tab + tsize);  // a round's values
  for (int e = lane; e < tsize; e += 32) {
    tab[e].key = -1;
    tab[e].m = tab[e].sx = tab[e].sy = 0.0f;
  }
  const int64_t base = (int64_t)row * kcap;
  const unsigned below = (1u << lane) - 1u;
  int c = -1;
  float m = 0.0f, sx = 0.0f, sy = 0.0f;
  if (lane < kcap) {
    c = cell[base + lane];
    m = mf[base + lane];
    sx = mfx[base + lane];
    sy = mfy[base + lane];
  }
  __syncwarp();
  for (int i0 = 0; i0 < kcap; i0 += 32) {
    const int inext = i0 + 32 + lane;
    int cn = -1;
    float mn = 0.0f, sxn = 0.0f, syn = 0.0f;
    if (inext < kcap) {
      cn = cell[base + inext];
      mn = mf[base + inext];
      sxn = mfx[base + inext];
      syn = mfy[base + inext];
    }
    const bool valid = c >= 0 && c < ncells;
    stage[lane] = make_float4(m, sx, sy, 0.0f);
    __syncwarp();
    const unsigned grp = __match_any_sync(kFull, valid ? c : -1 - lane);
    if (valid && (grp & below) == 0) {  // the first slot of its cell here
      unsigned h = ((unsigned)c * 0x9E3779B1u) >> (32 - tlog);
      for (;;) {
        const int old = atomicCAS(&tab[h].key, -1, c);
        if (old == -1 || old == c) break;
        h = (h + 1) & (tsize - 1);
      }
      float am = tab[h].m, asx = tab[h].sx, asy = tab[h].sy;
      for (unsigned gm = grp; gm; gm &= gm - 1) {
        const float4 v = stage[__ffs(gm) - 1];
        am += v.x;
        asx += v.y;
        asy += v.z;
      }
      tab[h].m = am;
      tab[h].sx = asx;
      tab[h].sy = asy;
    }
    __syncwarp();  // the stage is free, the table up to date
    c = cn;
    m = mn;
    sx = sxn;
    sy = syn;
  }
  for (int e = lane; e < tsize; e += 32) {
    const SumEntry t = tab[e];
    if (t.key >= 0) {
      M[t.key] = t.m;
      SX[t.key] = t.sx;
      SY[t.key] = t.sy;
    }
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

template <bool kV4, bool kCollide, bool kGate, int kRows, bool kSub>
cudaError_t launch_fused(const FusedArgs& a, int threads, cudaStream_t stream) {
  // The labelled form's twelve (K,) arrays and the static scratch are over
  // 48 KB at K = 1024, the unlabelled form's eleven from K = 1112 on.
  const size_t smem = (size_t)(kSub ? 12 : 11) * a.kcap * sizeof(float);
  auto kernel = fused_pairs_kernel<kV4, kCollide, kGate, kRows, kSub>;
  static size_t opted = 0;
  const cudaError_t err = opt_in(kernel, smem + 256, opted);
  if (err != cudaSuccess) return err;
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

template <bool kV4, bool kCollide, int kP>
cudaError_t launch_labelled_warp(const FusedArgs& a, int warps,
                                 cudaStream_t s) {
  const size_t smem = (size_t)warps * sizeof(WarpRow);
  auto kernel = labelled_warp_kernel<kV4, kCollide, kP>;
  static size_t opted = 0;
  const cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<(a.ncells + warps - 1) / warps, warps * 32, smem, s>>>(
      a.x, a.y, a.mf, a.alive, a.pid, a.sub, a.fx, a.fy, a.ft, a.total,
      a.ncells, a.kcap, a.eps2, a.g);
  return cudaGetLastError();
}

template <bool kV4, bool kCollide>
cudaError_t dispatch_labelled_warp(const FusedArgs& a, int warps,
                                   cudaStream_t s) {
  if (a.kcap <= 32) return launch_labelled_warp<kV4, kCollide, 1>(a, warps, s);
  return launch_labelled_warp<kV4, kCollide, 2>(a, warps, s);
}

bool whole_warps(int threads, int most) {
  return threads >= 32 && threads <= most && threads % 32 == 0;
}

bool row_width(int kcap) { return kcap >= 1 && kcap <= kMaxK; }

template <int kRows>
cudaError_t launch_dense_forces(const float* x, const float* y,
                                const float* m, const float* ml,
                                const float* mxl, const float* myl, float* fx,
                                float* fy, int ncells, int kcap, float g,
                                int threads, int chunks, cudaStream_t s) {
  // With the static scratch over 48 KB from K = 2447 on.
  const size_t smem = (size_t)kcap * (sizeof(float4) + sizeof(int));
  auto kernel = dense_forces_kernel<kRows>;
  static size_t opted = 0;
  const cudaError_t err = opt_in(kernel, smem + 256, opted);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)ncells * (unsigned)chunks), threads, smem, s>>>(
      x, y, m, ml, mxl, myl, fx, fy, kcap, chunks, g);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for a launch
// shape it does not take or a kcap outside [1, kMaxK]; the error of
// cudaFuncSetAttribute, without a launch, where the shared memory the
// launch needs cannot be had).
//
// total: one int, the count summed over the cells (0 with collide off);
// rows: receivers per thread (1 or 2); threads per block.
extern "C" int psim_fused_pairs(const float* x, const float* y, const float* mf,
                                const int* alive, const int* pid, float* fx,
                                float* fy, int* ft, int* total, int ncells,
                                int kcap, float eps2, float g, int collide,
                                int v4, int gate, int rows, int threads,
                                void* stream) {
  if (!whole_warps(threads, kMaxThreads) || (rows != 1 && rows != 2) ||
      !row_width(kcap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(total, 0, sizeof(int), s);
  const FusedArgs a = {x, y, mf, alive, pid, nullptr, fx, fy, ft, total,
                       ncells, kcap, eps2, g};
  if (v4 && rows == 1)
    return (int)dispatch_fused<true, 1>(a, collide, gate, threads, s);
  if (v4) return (int)dispatch_fused<true, 2>(a, collide, gate, threads, s);
  if (rows == 1)
    return (int)dispatch_fused<false, 1>(a, collide, gate, threads, s);
  return (int)dispatch_fused<false, 2>(a, collide, gate, threads, s);
}

// The labelled pass (hit-gated): sub holds the same-cell labels. With
// row_warps > 0 the warp kernel (kcap <= 64), row_warps rows (warps) a
// block; then rows must be ceil(kcap / 32) (a lane's slots) and threads 32
// row_warps.
// With row_warps == 0 the block kernel, a block a row, rows and threads as
// for psim_fused_pairs.
extern "C" int psim_labelled_pairs(const float* x, const float* y,
                                   const float* mf, const int* alive,
                                   const int* pid, const int* sub, float* fx,
                                   float* fy, int* ft, int* total, int ncells,
                                   int kcap, float eps2, float g, int collide,
                                   int v4, int row_warps, int rows,
                                   int threads, void* stream) {
  if (sub == nullptr || !row_width(kcap)) return (int)cudaErrorInvalidValue;
  if (row_warps > 0 ? (kcap > kWarpK || row_warps > kMaxWarpRows ||
                       rows != (kcap + 31) / 32 || threads != 32 * row_warps)
                    : (!whole_warps(threads, kMaxThreads) ||
                       (rows != 1 && rows != 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(total, 0, sizeof(int), s);
  const FusedArgs a = {x, y, mf, alive, pid, sub, fx, fy, ft, total,
                       ncells, kcap, eps2, g};
  if (row_warps > 0) {
    if (v4 && collide)
      return (int)dispatch_labelled_warp<true, true>(a, row_warps, s);
    if (v4) return (int)dispatch_labelled_warp<true, false>(a, row_warps, s);
    if (collide)
      return (int)dispatch_labelled_warp<false, true>(a, row_warps, s);
    return (int)dispatch_labelled_warp<false, false>(a, row_warps, s);
  }
  if (v4 && rows == 1)
    return (int)dispatch_fused<true, 1>(a, collide, 1, threads, s);
  if (v4) return (int)dispatch_fused<true, 2>(a, collide, 1, threads, s);
  if (rows == 1)
    return (int)dispatch_fused<false, 1>(a, collide, 1, threads, s);
  return (int)dispatch_fused<false, 2>(a, collide, 1, threads, s);
}

// rows, threads: as for psim_fused_pairs; chunks: blocks per cell.
extern "C" int psim_dense_forces(const float* x, const float* y, const float* m,
                                 const float* ml, const float* mxl,
                                 const float* myl, float* fx, float* fy,
                                 int ncells, int kcap, float g, int rows,
                                 int threads, int chunks, void* stream) {
  if (!whole_warps(threads, kMaxThreads) || chunks < 1 || !row_width(kcap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1)
    return (int)launch_dense_forces<1>(x, y, m, ml, mxl, myl, fx, fy, ncells,
                                       kcap, g, threads, chunks, s);
  if (rows == 2)
    return (int)launch_dense_forces<2>(x, y, m, ml, mxl, myl, fx, fy, ncells,
                                       kcap, g, threads, chunks, s);
  return (int)cudaErrorInvalidValue;
}

// total: one int, the count summed over the cells.
extern "C" int psim_dense_collisions(const float* x, const float* y,
                                     const int* alive, const int* pid, int* ft,
                                     int* total, int ncells, int kcap,
                                     float eps2, int threads, void* stream) {
  if (!whole_warps(threads, kMaxCollThreads) || !row_width(kcap))
    return (int)cudaErrorInvalidValue;
  // With the static scratch over 48 KB from K = 1529 on with a pid,
  // 2038 without.
  const size_t smem = (size_t)kcap * (pid != nullptr ? 8 : 6) * sizeof(int);
  static size_t opted = 0;
  const cudaError_t err = opt_in(dense_collisions_kernel, smem + 256, opted);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(total, 0, sizeof(int), s);
  dense_collisions_kernel<<<ncells, threads, smem, s>>>(x, y, alive, pid, ft,
                                                         total, kcap, eps2);
  return (int)cudaGetLastError();
}

// out: (3, ncells) floats, M, sum m x, sum m y. parts: 1 zeroes out, 2 runs
// the kernel (which writes only the cells of its rows), 3 both, as the
// wrapper calls it; the two alone serve to time them apart. warps: rows
// (warps) a block, 1 to 8. rounds: 0 takes the mask table up to K = 64, 1
// the round kernel at any K (to time the two on the same rows).
extern "C" int psim_cell_sums(const float* mf, const float* mfx,
                              const float* mfy, const int* cell, float* out,
                              int rows, int kcap, int ncells, int warps,
                              int parts, int rounds, void* stream) {
  if (warps < 1 || warps > kMaxThreads / 32 || parts < 1 || parts > 3 ||
      !row_width(kcap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts & 1) cudaMemsetAsync(out, 0, (size_t)3 * ncells * sizeof(float), s);
  if (!(parts & 2)) return (int)cudaGetLastError();
  const int blocks = (rows + warps - 1) / warps;
  float* M = out;
  float* SX = out + ncells;
  float* SY = out + 2 * (size_t)ncells;
  if (kcap <= kWarpK && !rounds) {
    const size_t smem = (size_t)warps * sizeof(SumsRow);
    auto kernel =
        kcap <= 32 ? cell_sums_warp_kernel<1> : cell_sums_warp_kernel<2>;
    kernel<<<blocks, warps * 32, smem, s>>>(mf, mfx, mfy, cell, M, SX, SY,
                                            rows, kcap, ncells);
    return (int)cudaGetLastError();
  }
  // A table of at least 2 kcap slots, 64 at least: 16 bytes a slot, 131 KB
  // a warp at K = 4096 (one warp a block, opted in; cell_sums_launch).
  int tlog = 6;
  while ((1 << tlog) < 2 * kcap) ++tlog;
  const size_t smem = (size_t)warps * ((1u << tlog) + 32) * sizeof(SumEntry);
  static size_t opted = 0;
  const cudaError_t err = opt_in(cell_sums_kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  cell_sums_kernel<<<blocks, warps * 32, smem, s>>>(mf, mfx, mfy, cell, M, SX,
                                                    SY, rows, kcap, ncells,
                                                    tlog);
  return (int)cudaGetLastError();
}
