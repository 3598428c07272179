// Compaction victim mask for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernel of kubebrain_tpu/ops/compact_pallas.py:
//   K3 victim_mask_pallas (:122, body _kernel :42-118), batched over the
//   partitions by victim_mask_batch_cached (:173).
//
// Per valid row i of partition p (rows sorted by key, then revision; no
// partition splits a key's version chain):
//   le[i]        = rev[i] <= compact_rev
//   same_next[i] = i + 1 < n_valid[p] && key[i] == key[i+1]
//   superseded   = le[i] && same_next[i] && le[i+1]
//   dead_tomb    = le[i] && !(same_next[i] && le[i+1]) && tomb[i]
//   ttl_expired  = ttl[i] && rev[last row of i's group] <= ttl_cutoff
//   victim       = (superseded || dead_tomb || ttl_expired)
//                  && start <= key[i] && (unbounded || key[i] < end)
// ttl_cutoff <= 0 skips the TTL verdict (the Pallas kernel's with_ttl=False).
//
// Layout, as for the visibility kernels (scan_visibility.cu):
//   keys int32[P, C, N] chunk-major, sign-flipped; revs int64[P, N];
//   tomb, ttl int8[P, N]; n_valid int32[P]; start, end int32[C] flipped.
// Output: mask uint8[P, N] (0/1, read as torch.bool), every row written.
//
// Design. The TPU kernel walked tiles in reverse and carried the next tile's
// first key, its <= compact_rev flag and its group's TTL verdict from one
// grid step to the next. Blocks here run in no order, so:
// - Row i+1 is read directly. Each block owns 256 consecutive rows, one
//   thread per row; thread t reads row i+1's key chunks and revision from
//   global memory (the neighbouring thread loaded them: L1 hits). Tiles stay
//   aligned to 256 rows so that pass 2 can index them.
// - The TTL verdict of a group lives at its last row, and a chain can span
//   any number of blocks. Pass 1 writes, per row, whether it ends its group
//   and that group's verdict, plus whether it is a TTL candidate (one byte,
//   `gend`), and per tile the verdict of the tile's first group end
//   (`summary`). Pass 2 hands each TTL candidate the verdict of the first
//   group end at or after it: inside its warp by ballot and __ffs, in a
//   later warp of its tile through shared memory, and past the tile by one
//   walk per block over the following tiles' summaries. A chain of L rows
//   costs O(L / 256) summary reads per tile it covers, never a per-row walk.
// Pass 2 runs only when ttl_cutoff > 0.
//
// Bound: memory. The function reads 4·C + 8 + 1 + 1 bytes per valid row
// (keys, revision, tombstone, TTL flag) and writes one mask byte per row;
// the bound is those bytes over 3.35 TB/s. Compare work is 3·C integer
// compares per row (next key, start, end), far below the bytes. What the
// design does about it: every input byte comes from device memory once
// (row i+1's are L1 hits), chunk loads are coalesced across the warp
// (chunk-major layout), rows past n_valid are never read, and the TTL pass
// adds only one scratch byte per row written and read back plus one
// summary byte per tile; with ttl_cutoff <= 0 it does not run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // rows per tile, one thread per row
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// gend byte of a row: bits 0-1 are 0 (not the last row of its group), 1 (last
// row, group not expired) or 2 (last row, revision <= ttl_cutoff); bit 2 marks
// a TTL candidate (valid, TTL flag set, inside [start, end)).
constexpr uint8_t kEndMask = 3;
constexpr uint8_t kExpired = 2;
constexpr uint8_t kTtlCandidate = 4;

// Each warp's first group-end verdict into warp_first[warp] (0 if none).
__device__ __forceinline__ unsigned warp_ends(uint8_t g, uint8_t* warp_first) {
  const unsigned ends = __ballot_sync(kFull, (g & kEndMask) != 0);
  const int first = ends ? __ffs(ends) - 1 : 0;
  const uint8_t code = (uint8_t)__shfl_sync(kFull, g & kEndMask, first);
  if ((threadIdx.x & 31) == 0) warp_first[threadIdx.x >> 5] = ends ? code : 0;
  return ends;
}

__global__ void __launch_bounds__(kThreads) victim_mark_kernel(
    const int32_t* __restrict__ keys, const int64_t* __restrict__ revs,
    const int8_t* __restrict__ tomb, const int8_t* __restrict__ ttl,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ start,
    const int32_t* __restrict__ end, int unbounded, int64_t compact_rev,
    int64_t ttl_cutoff, int C, int N, int T, uint8_t* __restrict__ mask,
    uint8_t* __restrict__ gend, uint8_t* __restrict__ summary) {
  __shared__ uint8_t warp_first[kWarps];
  const int p = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nv = n_valid[p];
  const int32_t* kp = keys + (int64_t)p * C * N;
  const int64_t* rp = revs + (int64_t)p * N;
  const int64_t row = (int64_t)p * N + i;

  uint8_t g = 0;
  if (i < nv) {
    bool same_next = i + 1 < nv;
    bool dec_s = false, lt_s = false, dec_e = false, lt_e = false;
    for (int c = 0; c < C; ++c) {
      const int32_t k = kp[(int64_t)c * N + i];
      if (same_next) same_next = (k == kp[(int64_t)c * N + i + 1]);
      const int32_t s = start[c], e = end[c];
      if (!dec_s && k != s) {
        dec_s = true;
        lt_s = k < s;
      }
      if (!dec_e && k != e) {
        dec_e = true;
        lt_e = k < e;
      }
    }
    const int64_t rev = rp[i];
    const bool le = rev <= compact_rev;
    const bool newer_le = same_next && rp[i + 1] <= compact_rev;
    const bool in_range = !lt_s && (unbounded != 0 || lt_e);
    mask[row] = (uint8_t)(in_range && le && (newer_le || tomb[row] != 0));
    if (!same_next) g = rev <= ttl_cutoff ? kExpired : 1;
    if (in_range && ttl[row] != 0) g |= kTtlCandidate;
  } else if (i < N) {
    mask[row] = 0;
  }
  if (ttl_cutoff <= 0) return;  // uniform over the launch
  if (i < N) gend[row] = g;
  warp_ends(g, warp_first);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint8_t s = 0;
    for (int w = 0; w < kWarps && !s; ++w) s = warp_first[w];
    summary[(int64_t)p * T + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads) victim_ttl_kernel(
    const int32_t* __restrict__ n_valid, int N, int T,
    const uint8_t* __restrict__ gend, const uint8_t* __restrict__ summary,
    uint8_t* __restrict__ mask) {
  __shared__ uint8_t warp_first[kWarps];
  __shared__ uint8_t tail;
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = (int64_t)p * N + i;
  const uint8_t g = i < N ? gend[row] : 0;
  const unsigned ends = warp_ends(g, warp_first);
  // the first group end at or after this lane, inside the warp
  const unsigned ahead = ends & (kFull << lane);
  const int at = ahead ? __ffs(ahead) - 1 : lane;
  const uint8_t in_warp = (uint8_t)__shfl_sync(kFull, g & kEndMask, at);
  if (threadIdx.x == 0) {
    // a group still open at the tile's last valid row ends in a later tile:
    // the first group end found there is its verdict
    uint8_t v = 0;
    const int64_t last = (int64_t)blockIdx.x * kThreads + kThreads - 1;
    if (last < n_valid[p] && (gend[(int64_t)p * N + last] & kEndMask) == 0) {
      const uint8_t* sp = summary + (int64_t)p * T;
      for (int b = blockIdx.x + 1; b < T && !v; ++b) v = sp[b];
    }
    tail = v;
  }
  __syncthreads();
  if (!(g & kTtlCandidate)) return;
  uint8_t v = ahead ? in_warp : 0;
  for (int w = warp + 1; w < kWarps && !v; ++w) v = warp_first[w];
  if (!v) v = tail;
  if (v == kExpired) mask[row] = 1;
}

}  // namespace

// K3 over every partition. mask uint8[P, N]; gend uint8[P, N] and summary
// uint8[P, ceil(N / 256)] are scratch, used only when ttl_cutoff > 0.
extern "C" int kb_victim_mask(const void* keys, const void* revs,
                              const void* tomb, const void* ttl,
                              const void* n_valid, const void* start,
                              const void* end, int unbounded,
                              long long compact_rev, long long ttl_cutoff,
                              int P, int C, int N, void* mask, void* gend,
                              void* summary, void* stream) {
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  const int T = (N + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)T, (unsigned)P);
  const cudaStream_t s = (cudaStream_t)stream;
  victim_mark_kernel<<<grid, kThreads, 0, s>>>(
      (const int32_t*)keys, (const int64_t*)revs, (const int8_t*)tomb,
      (const int8_t*)ttl, (const int32_t*)n_valid, (const int32_t*)start,
      (const int32_t*)end, unbounded, (int64_t)compact_rev,
      (int64_t)ttl_cutoff, C, N, T, (uint8_t*)mask, (uint8_t*)gend,
      (uint8_t*)summary);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ttl_cutoff <= 0) return (int)err;
  victim_ttl_kernel<<<grid, kThreads, 0, s>>>(
      (const int32_t*)n_valid, N, T, (const uint8_t*)gend,
      (const uint8_t*)summary, (uint8_t*)mask);
  return (int)cudaGetLastError();
}
