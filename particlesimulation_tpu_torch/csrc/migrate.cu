// The parity meshes' migration pack for Hopper (sm_90a): stable
// compactions of each shard row of a slab or a ring buffer, without a sort.
//
// A mesh shard holds its particles in a slab of C slots (a row of (L, C)
// field tensors, one row per local shard); emigrants ride a ring buffer of
// B entries ((L, B) tensors) from shard to shard. Two functions move them:
//
//   compact (the emigrant buffer): each row's entries under `emig`, in slab
//     order, fill the first of its B buffer entries (a stable compaction,
//     cut to B), each field copied, and the buffer's valid flag set where
//     an emigrant landed and cleared past them; the (L,) count of
//     emigrants past B. The fields of the entries past the emigrants are
//     not written: no caller reads an entry that is not valid;
//   pack (the landing): each row's buffer entries under `take`, in buffer
//     order, land in the row's free slab slots (valid false), in slot
//     order, each field copied and valid set, in place; only the landed
//     slots are written; the (L,) count of arrivals past the free slots.
//
// They replace XLA code of the JAX package, which has no Pallas kernel
// for it: parallel/sharded.py's emigrant pack (an argsort of ~emig, stable,
// and a gather a field, :212-221) and accept (:223-240: arrivals first by a
// stable argsort, a cumsum of the free slots, a gather a field into them),
// and their 2D twins in parallel/sharded2d.py (_pack_into :227-244, the
// emigrant pack :313-320).
//
// Design: a slab row is hundreds of thousands of slots at the flagship, so
// a row's scan runs over many blocks. Each launch sequence splits it into
// chunks of 4096 entries a block, taken in 16 rounds of 256 neighbouring
// entries (a warp's loads and stores of a round touch neighbouring
// addresses; a thread loads its 16 flags together first, and an entry's
// fields all before it stores them, so latencies overlap): a count launch
// writes each chunk's count of flags; every later block sums the counts
// of the chunks before its own (a few hundred integers, read from L2) for
// its offset, and a ballot scan of each round gives each thread its place.
// A block with nothing to move returns after its offset. So a pack is three launches (count, the
// arrivals' list, the placement), and a compact two (count, placement),
// each over every field at once (up to 12 fields of 1, 4 or 8 bytes).
// Nothing is read back to the host.
//
// What bounds them on an H100: bytes. A pack reads the valid and take
// flags (twice: count and place, the second from L2 where it fits), writes
// 4 bytes an arrival to its list, and copies the landed entries' fields; a
// compact reads the emig flags (twice, as the pack), copies the emigrants'
// fields and writes the B valid flags.
//
// Bits: every field is copied as bytes, so the results are the plain
// versions' (ops/cuda/migrate.py pack_ref, compact_ref): a pack's slot for
// slot, a compact's valid flags and its valid entries' fields (the plain
// version's argsort fills the entries past the emigrants with the slab's
// other entries, which no caller reads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 12;
constexpr unsigned kFull = 0xffffffffu;

// The fields a launch moves: per field its source and destination (the
// (L, len) tensors' first bytes) and its element size (1, 4 or 8).
struct Fields {
  int n;
  const char* src[kMaxFields];
  char* dst[kMaxFields];
  int size[kMaxFields];
};

// Element si of every source field to element di of its destination:
// every load issued before the first store, so that the entry's scattered
// reads overlap.
__device__ __forceinline__ void copy_entry(const Fields& f, int64_t si,
                                           int64_t di) {
  long long v[kMaxFields];
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k >= f.n) break;
    switch (f.size[k]) {
      case 8:
        v[k] = reinterpret_cast<const long long*>(f.src[k])[si];
        break;
      case 4:
        v[k] = reinterpret_cast<const int*>(f.src[k])[si];
        break;
      default:
        v[k] = f.src[k][si];
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k >= f.n) break;
    switch (f.size[k]) {
      case 8:
        reinterpret_cast<long long*>(f.dst[k])[di] = v[k];
        break;
      case 4:
        reinterpret_cast<int*>(f.dst[k])[di] = static_cast<int>(v[k]);
        break;
      default:
        f.dst[k][di] = static_cast<char>(v[k]);
    }
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's sum of v (every thread gets it).
__device__ int block_sum(int v, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += smem[w];
  return t;
}

// One round of a block's scan of flags: this thread's flag e; returns the
// flags of the threads before it in the round (by ballots, warp order)
// and sets *total to the round's.
__device__ int round_scan(bool e, int* smem, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFull, e);
  __syncthreads();  // the last round's reads of smem are done
  if (lane == 0) smem[warp] = __popc(b);
  __syncthreads();
  int before = __popc(b & ((1u << lane) - 1u)), t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = smem[w];
    before += w < warp ? c : 0;
    t += c;
  }
  *total = t;
  return before;
}

// The sum of counts[0..n) (every thread gets it).
__device__ int sum_counts(const int* counts, int n, int* smem) {
  int v = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) v += counts[i];
  return block_sum(v, smem);
}

// Flag i of a byte array: true where the byte is not 0.
__device__ __forceinline__ bool flag(const uint8_t* a, int64_t i) {
  return a[i] != 0;
}

// A block takes the chunk of entries [x kChunk, (x + 1) kChunk) of its row
// in kPerThread rounds of kThreads neighbouring entries (a thread's entry
// of round r: x kChunk + r kThreads + threadIdx.x), so that a warp's loads
// and stores of a round touch neighbouring addresses.
__device__ __forceinline__ int64_t entry(int r) {
  return (int64_t)blockIdx.x * kChunk + (int64_t)r * kThreads + threadIdx.x;
}

// This thread's flags of the block's chunk of a row (base: the row's
// first byte), bit r its entry of round r (of zero bytes with invert;
// entries at or past len 0): the 16 loads issued together, ahead of the
// rounds' scans.
__device__ __forceinline__ unsigned chunk_flags(const uint8_t* a,
                                                int64_t base, int64_t len,
                                                bool invert) {
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = entry(r);
    if (i < len && flag(a, base + i) != invert) bits |= 1u << r;
  }
  return bits;
}

// Pass 1 of both: each chunk's count of flags (of zero bytes with invert),
// block x of row l into counts[l * stride + x]: blocks below nchunks_a
// count chunks of a, the others chunks of the second array (b, len_b,
// invert_b). Bound: bytes, the flags read once.
__global__ void migrate_count_kernel(const uint8_t* __restrict__ a,
                                     int64_t len_a, bool invert_a,
                                     int nchunks_a,
                                     const uint8_t* __restrict__ b,
                                     int64_t len_b, bool invert_b, int stride,
                                     int* __restrict__ counts) {
  __shared__ int smem[kWarps];
  const int l = blockIdx.y;
  const bool second = (int)blockIdx.x >= nchunks_a;
  const uint8_t* f = second ? b : a;
  const int64_t len = second ? len_b : len_a;
  const bool invert = second ? invert_b : invert_a;
  const int64_t shift = second ? (int64_t)nchunks_a * kChunk : 0;
  const int64_t base = (int64_t)l * len;
  int v = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t i = entry(r) - shift;
    if (i < len) v += flag(f, base + i) != invert;
  }
  v = block_sum(v, smem);
  if (threadIdx.x == 0) counts[(int64_t)l * stride + blockIdx.x] = v;
}

// Pack, pass 2 (a block a chunk of the buffer row): the arrivals' list,
// each arrival's buffer index at its rank among the row's arrivals:
// arr_at[l * len_b + rank] = j. Bound: bytes, take read, 4 written an
// arrival.
__global__ void pack_arrivals_kernel(const uint8_t* __restrict__ take,
                                     int64_t len_b, int nchunks_c,
                                     int stride,
                                     const int* __restrict__ counts,
                                     int* __restrict__ arr_at) {
  __shared__ int smem[kWarps];
  const int l = blockIdx.y;
  const int* row_counts = counts + (int64_t)l * stride + nchunks_c;
  int q = sum_counts(row_counts, blockIdx.x, smem);
  if (row_counts[blockIdx.x] == 0) return;  // block-uniform
  const int64_t base = (int64_t)l * len_b;
  const unsigned bits = chunk_flags(take, base, len_b, false);
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t j = entry(r);
    const bool e = (bits >> r) & 1u;
    int total;
    const int before = round_scan(e, smem, &total);
    if (e) arr_at[base + q + before] = (int)j;
    q += total;
  }
}

// Pack, pass 3 (a block a chunk of the slab row), in place: the row's
// free slot of rank q (free slots in slot order) takes arrival q of the
// list while q < the row's arrivals: every field copied, valid set. Block
// 0 of the row writes its overflow, max(arrivals - free slots, 0).
// Bound: bytes, valid read, the landed entries' fields copied.
__global__ void pack_place_kernel(uint8_t* __restrict__ valid, int64_t len_c,
                                  int64_t len_b, int nchunks_c, int nchunks_b,
                                  int stride, const int* __restrict__ counts,
                                  const int* __restrict__ arr_at, Fields f,
                                  int* __restrict__ overflow) {
  __shared__ int smem[kWarps];
  const int l = blockIdx.y;
  const int* row_counts = counts + (int64_t)l * stride;
  const int n_arr = sum_counts(row_counts + nchunks_c, nchunks_b, smem);
  if (blockIdx.x == 0) {
    const int n_free = sum_counts(row_counts, nchunks_c, smem);
    if (threadIdx.x == 0)
      overflow[l] = n_arr > n_free ? n_arr - n_free : 0;
  }
  int q = sum_counts(row_counts, blockIdx.x, smem);
  // q is the block's: every thread returns, or leaves the loop, together.
  if (q >= n_arr) return;
  const int64_t base = (int64_t)l * len_c;
  const int64_t bbase = (int64_t)l * len_b;
  const unsigned free_bits = chunk_flags(valid, base, len_c, true);
  for (int r = 0; r < kPerThread && q < n_arr; ++r) {
    const int64_t s = entry(r);
    const bool fr = (free_bits >> r) & 1u;
    int total;
    const int mine = q + round_scan(fr, smem, &total);
    if (fr && mine < n_arr) {
      copy_entry(f, bbase + arr_at[bbase + mine], base + s);
      valid[base + s] = 1;
    }
    q += total;
  }
}

// Compact, pass 2 (a block a chunk of the slab row): the buffer's valid
// flags of the chunk's range of entries (entry p valid where p < the
// row's emigrants), and each emigrant of the chunk to the buffer entry of
// its rank among the row's emigrants where that is below B: every field
// copied. Entries past the emigrants keep whatever they held. Block 0 of
// the row writes its overflow, max(emigrants - bcap, 0). A chunk with no
// emigrant, or whose first rank is past the buffer, moves nothing.
// Bound: bytes, emig read, the emigrants' fields copied, B valid bytes.
__global__ void compact_place_kernel(const uint8_t* __restrict__ emig,
                                     int64_t len_c, int64_t len_b,
                                     int64_t bcap, int nchunks_c, int stride,
                                     const int* __restrict__ counts, Fields f,
                                     uint8_t* __restrict__ bvalid,
                                     int* __restrict__ overflow) {
  __shared__ int smem[kWarps];
  const int l = blockIdx.y;
  const int* row_counts = counts + (int64_t)l * stride;
  const int n_emig = sum_counts(row_counts, nchunks_c, smem);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    overflow[l] = n_emig > bcap ? (int)(n_emig - bcap) : 0;
  const int64_t bbase = (int64_t)l * len_b;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t p = entry(r);
    if (p < len_b) bvalid[bbase + p] = p < n_emig;
  }
  int64_t rank = sum_counts(row_counts, blockIdx.x, smem);
  // Both block-uniform.
  if (row_counts[blockIdx.x] == 0 || rank >= len_b) return;
  const int64_t base = (int64_t)l * len_c;
  const unsigned bits = chunk_flags(emig, base, len_c, false);
  for (int r = 0; r < kPerThread && rank < len_b; ++r) {
    const int64_t s = entry(r);
    const bool e = (bits >> r) & 1u;
    int total;
    const int64_t pos = rank + round_scan(e, smem, &total);
    if (e && pos < len_b) copy_entry(f, base + s, bbase + pos);
    rank += total;
  }
}

int nchunks(int64_t len) { return (int)((len + kChunk - 1) / kChunk); }

// The Fields of n (src, dst, size) triples; false where one does not fit.
bool make_fields(int n, const void* const* src, void* const* dst,
                 const int* sizes, Fields* f) {
  if (n < 0 || n > kMaxFields) return false;
  f->n = n;
  for (int k = 0; k < n; ++k) {
    if (sizes[k] != 1 && sizes[k] != 4 && sizes[k] != 8) return false;
    f->src[k] = static_cast<const char*>(src[k]);
    f->dst[k] = static_cast<char*>(dst[k]);
    f->size[k] = sizes[k];
  }
  return true;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue, without a
// launch, for a shape it does not take). Arrays are (L, len) row-major;
// flags are bytes (0 or not). Fields: n pointers each of the sources and
// destinations and their element sizes (1, 4 or 8 bytes), at most 12.

// The scratch ints a call needs: counts (L * (chunks of C + chunks of B))
// and, for pack, the arrivals' list (L * B).
extern "C" int64_t psim_migrate_scratch(int L, int64_t len_c, int64_t len_b,
                                        int with_list) {
  return (int64_t)L * (nchunks(len_c) + nchunks(len_b)) +
         (with_list ? (int64_t)L * len_b : 0);
}

// Pack, in place: dst fields (L, len_c) and valid, from src fields
// (L, len_b) under take; overflow: L ints.
extern "C" int psim_pack(int L, int64_t len_c, int64_t len_b, uint8_t* valid,
                         const uint8_t* take, int n, const void* const* src,
                         void* const* dst, const int* sizes, int* overflow,
                         int* scratch, void* stream) {
  Fields f;
  if (L < 1 || L > 65535 || len_c < 1 || len_b < 1 ||
      len_c >= ((int64_t)1 << 31) || len_b >= ((int64_t)1 << 31) ||
      !make_fields(n, src, dst, sizes, &f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncc = nchunks(len_c), ncb = nchunks(len_b);
  const int stride = ncc + ncb;
  int* counts = scratch;
  int* arr_at = scratch + (int64_t)L * stride;
  migrate_count_kernel<<<dim3(stride, L), kThreads, 0, s>>>(
      valid, len_c, true, ncc, take, len_b, false, stride, counts);
  pack_arrivals_kernel<<<dim3(ncb, L), kThreads, 0, s>>>(
      take, len_b, ncc, stride, counts, arr_at);
  pack_place_kernel<<<dim3(ncc, L), kThreads, 0, s>>>(
      valid, len_c, len_b, ncc, ncb, stride, counts, arr_at, f, overflow);
  return (int)cudaGetLastError();
}

// Compact: src fields (L, len_c) under emig into dst fields (L, len_b)
// (the emigrants' entries alone) and bvalid (every entry), len_b <= len_c;
// overflow: L ints, max(emigrants - bcap, 0).
extern "C" int psim_compact(int L, int64_t len_c, int64_t len_b, int64_t bcap,
                            const uint8_t* emig, int n,
                            const void* const* src, void* const* dst,
                            const int* sizes, uint8_t* bvalid, int* overflow,
                            int* scratch, void* stream) {
  Fields f;
  if (L < 1 || L > 65535 || len_c < 1 || len_b < 1 || len_b > len_c ||
      len_c >= ((int64_t)1 << 31) || !make_fields(n, src, dst, sizes, &f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncc = nchunks(len_c);
  migrate_count_kernel<<<dim3(ncc, L), kThreads, 0, s>>>(
      emig, len_c, false, ncc, emig, 0, false, ncc, scratch);
  compact_place_kernel<<<dim3(ncc, L), kThreads, 0, s>>>(
      emig, len_c, len_b, bcap, ncc, ncc, scratch, f, bvalid, overflow);
  return (int)cudaGetLastError();
}
