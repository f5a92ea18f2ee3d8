// Two other designs of the mesh rows' monopole + integrate, beside the one
// the port runs (csrc/advance.cu monopole_pool_kernel: a thread a slot, its
// row found from the runs passed by value), built on the same slot physics
// (advance.cu's mesh_slot, step_mf) so that all three give the same bits:
//
// * design_warp_rows_kernel: a warp a row (the first design): lanes 0-7
//   load the row's 8 terms, lanes 8-15 the sentinel's, shared by shuffles;
//   then the warp walks the row in rounds of 32 slots, a lane a slot;
// * design_ballot_rows_kernel: a block a row: the row's and the sentinel's
//   terms staged in shared memory, the row's live slots (m != 0) compacted
//   into a list by warp ballots and a block-wide offset, then a thread a
//   live slot of the list.
//
// Only monopole_row_designs.py builds this file, to time the three designs
// on the same inputs; the port does not link it.
#include "../csrc/advance.cu"

namespace {

template <bool kGathered>
__global__ void design_warp_rows_kernel(MeshPool f, Tables tb,
                                        const int64_t* __restrict__ row_start,
                                        int nrows,
                                        const int64_t* __restrict__ row_idx,
                                        const uint8_t* __restrict__ binned,
                                        Grid p) {
  const int r = warp_row(nrows);
  if (r < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t idx = table_index(row_idx == nullptr ? r : row_idx[r], tb);
  float cm = 0.0f, tmx = 0.0f, tmy = 0.0f;
  if (lane < 8)
    load_term(tb, idx, lane, &cm, &tmx, &tmy);
  else if (lane < 16 && binned != nullptr)
    load_term(tb, tb.sentinel, lane - 8, &cm, &tmx, &tmy);
  Temps t, ts;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    t.cm[l] = __shfl_sync(kFull, cm, l);
    t.mx[l] = __shfl_sync(kFull, tmx, l);
    t.my[l] = __shfl_sync(kFull, tmy, l);
    ts.cm[l] = __shfl_sync(kFull, cm, 8 + l);
    ts.mx[l] = __shfl_sync(kFull, tmx, 8 + l);
    ts.my[l] = __shfl_sync(kFull, tmy, 8 + l);
  }
  const int64_t s0 = row_start[r], s1 = row_start[r + 1];
  for (int64_t s = s0 + lane; s < s1; s += 32) {
    if (binned == nullptr || binned[s] != 0)
      mesh_slot<kGathered>(s, f, t, p);
    else
      mesh_slot<kGathered>(s, f, ts, p);
  }
}

constexpr int kBallotThreads = 256;

// Rows row0 .. row0 + gridDim.x - 1 of K slots each, from slot slot0; the
// live list in K ints of dynamic shared memory.
template <bool kGathered>
__global__ void __launch_bounds__(kBallotThreads)
    design_ballot_rows_kernel(MeshPool f, Tables tb, int64_t slot0,
                              int64_t row0, int K,
                              const int64_t* __restrict__ row_idx,
                              const uint8_t* __restrict__ binned, Grid p) {
  extern __shared__ int live[];
  __shared__ Temps t, ts;
  __shared__ int warp_n[kBallotThreads / 32];
  __shared__ int total;
  const int64_t r = row0 + blockIdx.x;
  const int64_t base = slot0 + (int64_t)blockIdx.x * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (threadIdx.x < 8) {
    const int64_t idx =
        table_index(row_idx == nullptr ? r : row_idx[r], tb);
    load_term(tb, idx, threadIdx.x, &t.cm[threadIdx.x], &t.mx[threadIdx.x],
              &t.my[threadIdx.x]);
  } else if (threadIdx.x < 16) {
    const int l = threadIdx.x - 8;
    load_term(tb, tb.sentinel, l, &ts.cm[l], &ts.mx[l], &ts.my[l]);
  }
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  for (int c0 = 0; c0 < K; c0 += blockDim.x) {
    const int k = c0 + threadIdx.x;
    const bool on = k < K && f.m[base + k] != 0.0f;
    const unsigned b = __ballot_sync(kFull, on);
    if (lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();
    int off = total;
    for (int w = 0; w < warp; ++w) off += warp_n[w];
    if (on) live[off + __popc(b & ((1u << lane) - 1u))] = k;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < warps; ++w) total += warp_n[w];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int64_t s = base + live[i];
    if (binned == nullptr || binned[s] != 0)
      mesh_slot<kGathered>(s, f, t, p);
    else
      mesh_slot<kGathered>(s, f, ts, p);
  }
}

}  // namespace

// As psim_monopole_rows, a warp a row (rows of any widths: row_start, nrows
// + 1 int64 slot offsets). warps: warps a block.
extern "C" int psim_design_warp_rows(
    float* x, float* y, float* vx, float* vy, const float* m, const float* mf,
    const float* fxd, const float* fyd, const float* ml, const float* mxl,
    const float* myl, int64_t sidx, int64_t sdir, int64_t nidx,
    int64_t sentinel, const int64_t* row_start, int nrows,
    const int64_t* row_idx, const uint8_t* binned, int gathered, float side,
    float dt, float g, int warps, void* stream) {
  if (!whole_warps(warps) || nidx < 1 || sentinel < 0 || sentinel >= nidx ||
      row_start == nullptr || nrows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MeshPool f{x, y, vx, vy, m, mf, fxd, fyd};
  const Tables tb{ml, mxl, myl, sidx, sdir, nidx, sentinel};
  const Grid p{0.0f, side, 2.0f * side, dt, g, 0};
  if (gathered)
    design_warp_rows_kernel<true><<<row_blocks(nrows, warps), 32 * warps, 0,
                                    s>>>(f, tb, row_start, nrows, row_idx,
                                         binned, p);
  else
    design_warp_rows_kernel<false><<<row_blocks(nrows, warps), 32 * warps,
                                     0, s>>>(f, tb, row_start, nrows, row_idx,
                                             binned, p);
  return (int)cudaGetLastError();
}

// As psim_monopole_rows (the same runs, host arrays), a block a row: a
// launch a run, min(K rounded up to a warp, 256) threads a block.
extern "C" int psim_design_ballot_rows(
    float* x, float* y, float* vx, float* vy, const float* m, const float* mf,
    const float* fxd, const float* fyd, const float* ml, const float* mxl,
    const float* myl, int64_t sidx, int64_t sdir, int64_t nidx,
    int64_t sentinel, const int64_t* row_idx, const uint8_t* binned,
    int nruns, const int64_t* run_rows, const int* run_k, int gathered,
    float side, float dt, float g, void* stream) {
  if (nidx < 1 || sentinel < 0 || sentinel >= nidx || nruns < 1 ||
      run_rows == nullptr || run_k == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MeshPool f{x, y, vx, vy, m, mf, fxd, fyd};
  const Tables tb{ml, mxl, myl, sidx, sdir, nidx, sentinel};
  const Grid p{0.0f, side, 2.0f * side, dt, g, 0};
  int64_t slot = 0, row = 0;
  for (int j = 0; j < nruns; ++j) {
    const int K = run_k[j];
    if (run_rows[j] < 0 || K < 1 || K > 8192)
      return (int)cudaErrorInvalidValue;
    const int threads =
        K >= kBallotThreads ? kBallotThreads : (K + 31) / 32 * 32;
    const size_t smem = (size_t)K * sizeof(int);
    if (run_rows[j] > 0) {
      if (gathered)
        design_ballot_rows_kernel<true>
            <<<(unsigned)run_rows[j], threads, smem, s>>>(
                f, tb, slot, row, K, row_idx, binned, p);
      else
        design_ballot_rows_kernel<false>
            <<<(unsigned)run_rows[j], threads, smem, s>>>(
                f, tb, slot, row, K, row_idx, binned, p);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    slot += run_rows[j] * K;
    row += run_rows[j];
  }
  return (int)cudaSuccess;
}
