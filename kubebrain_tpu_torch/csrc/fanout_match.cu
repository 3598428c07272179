// Watch fan-out for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces two XLA programs of the JAX package (it has no Pallas kernel for
// fan-out; on a TPU, XLA fuses the compare with the compaction):
//   K4 kb_fanout_dispatch: fanout_dispatch + _compact over
//      fanout_mask_range_wmajor (kubebrain_tpu/fanout/dispatch.py:68-125,
//      kubebrain_tpu/ops/fanout.py:65-87): one drain block of events against
//      every watcher slot -> per-slot match counts and the ascending flat
//      positions w*E + e of the matches, truncated at `size`, then W*E.
//   K5 kb_fanout_mask: fanout_mask_range (kubebrain_tpu/ops/fanout.py:46),
//      the legacy matcher's E-major mask bool[E, W].
//
// Match rule, per watcher slot w and event e < n_ev:
//   start[w] <= key[e] && (unbounded[w] || key[e] < end[w])
//   && rev[e] >= min_rev[w]
// Events e >= n_ev are the padding of the E bucket (empty key, revision 0)
// and match nothing: unmasked, they would match every unbounded min_rev = 0
// watcher. The flat index uses the padded E.
//
// Layout (ops/fanout_kernels.py checks it):
//   ev_keys int32[E, C], w_start/w_end int32[W, C]: big-endian uint32 key
//     chunks with the sign bit flipped, so a signed compare is unsigned byte
//     order. A never-match slot (free, or table padding) is a bounded empty
//     range: end = INT_MIN in every chunk, and no key is below it.
//   ev_revs, w_min_rev int64 (Hopper has native 64-bit integers: the TPU's
//     hi/lo split is gone); w_unb uint8 (torch.bool). C <= 256.
//
// K4 design. The [W, E] mask is never written to global memory; a pair is
// compared twice, once to count and once to write, in three launches on one
// stream:
//   1. count pass: a block of 8 warps takes 32 consecutive watcher slots, 4
//      per warp. It stages the events in shared memory, tile by tile (up to
//      8,192 key chunks and 48 KB: 512 events at C = 16), chunk-major with
//      a stride of tile + 1 so that both the staging writes and the lanes'
//      reads are (nearly) free of bank conflicts. For each of its slots a
//      warp loads the slot's bounds into registers (C <= 32: compile-time
//      variants 8, 16, 32, the loop unrolled and masked by the run-time C,
//      as K1 does; larger C reads them from L1 in a run-time loop), then
//      takes the tile's events 32 at a time, one per lane in order, and adds
//      __popc(__ballot_sync(hit)). It writes counts[w] and its block's sum.
//   2. offsets: one block scans the block sums exclusively in place and
//      writes the total after them (W / 32 values: 3,136 at 100k slots).
//   3. write pass: the count pass again, each warp starting from its slots'
//      offsets (block offset + an in-warp scan of the block's 32 counts).
//      A lane's hit goes to offset + the hits of the earlier ballots + the
//      hits of the lanes below it, __popc(ballot & lanemask_lt), and only
//      while that is below `size`. The ranks are exactly the row-major
//      order of the mask, so idx equals the JAX _compact's without a sort
//      and without atomics; any race would show as a permutation, which the
//      demux (diff + split, no sort) would turn into events out of revision
//      order. The same launch fills [min(total, size), size) with W*E.
// Bound: operations. About W*E*(2C+1) integer compares (two lexicographic
// compares of C chunks and one revision compare per pair) against bytes of
// W*(8C + 9) + E*(4C + 8) + 4W + 4*size; at 10k slots x 512 events x C = 16
// the compares are 4x the bytes' time. The simple design compares every
// pair twice and folds every chunk (no early exit, so a warp does not
// diverge); fusing the passes with a look-back, as K3 does, is left for a
// later change.
//
// K5 design. One thread per (e, w): a block of 256 watcher slots x 32
// events, the events' keys staged row-major in shared memory (every thread
// reads the same chunk: a broadcast), the slot's bounds in registers; mask
// bytes written by consecutive threads to consecutive slots of one row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerWarp = 4;
constexpr int kSlotsPerBlock = kWarps * kSlotsPerWarp;  // 32: warp 0's lanes
constexpr int kTileWords = 8192;  // key chunks of one staged event tile
constexpr int kMaxChunks = 256;   // a tile holds at least 32 events
// shared memory a K4 block may take without opting in: 48 KB, less its
// static slot_s[kSlotsPerBlock]
constexpr int kSmemBytes = 48 * 1024 - 128;
constexpr int kScanThreads = 1024;
constexpr int kMaskEvents = 32;   // events per K5 block

static_assert(kSlotsPerBlock == 32, "warp 0 scans the block's slot counts");

// key < b over C chunks, the key's chunk c at key[c * stride], the bound in
// global memory: the first differing chunk decides.
__device__ __forceinline__ bool lex_less(const int32_t* key, int stride,
                                         const int32_t* __restrict__ b,
                                         int C) {
  for (int c = 0; c < C; ++c) {
    const int32_t k = key[c * stride], v = b[c];
    if (k != v) return k < v;
  }
  return false;
}

// The bounds of one watcher slot, for a compile-time chunk count CMAX >= C:
// in registers, compared by a branchless fold from the last chunk to the
// first (chunks c >= C are masked out).
template <int CMAX>
struct Row {
  int32_t s[CMAX], e[CMAX];

  __device__ __forceinline__ void load(const int32_t* __restrict__ sr,
                                       const int32_t* __restrict__ er, int C) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      s[c] = c < C ? sr[c] : 0;
      e[c] = c < C ? er[c] : 0;
    }
  }

  // (key < start, key < end)
  __device__ __forceinline__ void less(const int32_t* key, int stride, int C,
                                       bool& lt_s, bool& lt_e) const {
    lt_s = false;
    lt_e = false;
#pragma unroll
    for (int c = CMAX - 1; c >= 0; --c)
      if (c < C) {
        const int32_t k = key[c * stride];
        lt_s = k < s[c] || (k == s[c] && lt_s);
        lt_e = k < e[c] || (k == e[c] && lt_e);
      }
  }
};

// Any other C: the bounds stay in global memory (L1 hits after the first
// event), compared with an early exit.
template <>
struct Row<0> {
  const int32_t* s;
  const int32_t* e;

  __device__ __forceinline__ void load(const int32_t* sr, const int32_t* er,
                                       int) {
    s = sr;
    e = er;
  }

  __device__ __forceinline__ void less(const int32_t* key, int stride, int C,
                                       bool& lt_s, bool& lt_e) const {
    lt_s = lex_less(key, stride, s, C);
    lt_e = lex_less(key, stride, e, C);
  }
};

// K4 passes 1 (WRITE = false) and 3 (WRITE = true). Grid: one block per 32
// watcher slots. `sums`: pass 1 writes each block's count sum; pass 3 reads
// the scanned offsets and, at sums[n_blocks], the total.
template <int CMAX, bool WRITE>
__global__ void __launch_bounds__(kThreads)
fanout_pass_kernel(const int32_t* __restrict__ ev_keys,
                   const int64_t* __restrict__ ev_revs, int n_ev, int E,
                   const int32_t* __restrict__ w_start,
                   const int32_t* __restrict__ w_end,
                   const uint8_t* __restrict__ w_unb,
                   const int64_t* __restrict__ w_min_rev, int W, int C,
                   int tile, int size, int32_t* __restrict__ counts,
                   int32_t* __restrict__ sums, int n_blocks,
                   int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* rev_s = reinterpret_cast<int64_t*>(smem);
  int32_t* key_s = reinterpret_cast<int32_t*>(rev_s + tile);
  __shared__ int32_t slot_s[kSlotsPerBlock];
  const int stride = tile + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot0 = blockIdx.x * kSlotsPerBlock + warp * kSlotsPerWarp;

  int run[kSlotsPerWarp];  // matches of each slot so far (+ its offset)
  if (WRITE) {
    const int total = sums[n_blocks];
    const int fill = W * E;  // the wrapper keeps W * E below 2^31
    for (int64_t i = (int64_t)min(total, size) +
                     (int64_t)blockIdx.x * kThreads + threadIdx.x;
         i < size; i += (int64_t)gridDim.x * kThreads)
      idx[i] = fill;
    if (warp == 0) {  // exclusive offsets of the block's 32 slots
      const int w = blockIdx.x * kSlotsPerBlock + lane;
      const int c = w < W ? counts[w] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      slot_s[lane] = sums[blockIdx.x] + incl - c;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlotsPerWarp; ++k)
      run[k] = slot_s[warp * kSlotsPerWarp + k];
  } else {
#pragma unroll
    for (int k = 0; k < kSlotsPerWarp; ++k) run[k] = 0;
  }

  for (int e0 = 0; e0 < n_ev; e0 += tile) {
    const int tn = min(tile, n_ev - e0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < tn * C; j += kThreads) {
      const int e = j / C, c = j - e * C;
      key_s[c * stride + e] = ev_keys[(int64_t)e0 * C + j];
    }
    for (int j = threadIdx.x; j < tn; j += kThreads) rev_s[j] = ev_revs[e0 + j];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlotsPerWarp; ++k) {
      const int w = slot0 + k;  // the same in every lane: no divergence
      if (w < W) {
        Row<CMAX> row;
        row.load(w_start + (int64_t)w * C, w_end + (int64_t)w * C, C);
        const bool unb = w_unb[w] != 0;
        const int64_t min_rev = w_min_rev[w];
        for (int b = 0; b < tn; b += 32) {
          const int e = b + lane;
          bool hit = false;
          if (e < tn && rev_s[e] >= min_rev) {
            bool lt_s, lt_e;
            row.less(key_s + e, stride, C, lt_s, lt_e);
            hit = !lt_s && (unb || lt_e);
          }
          const unsigned ballot = __ballot_sync(kFull, hit);
          if (WRITE && hit) {
            const int pos = run[k] + __popc(ballot & ((1u << lane) - 1u));
            if (pos < size) idx[pos] = w * E + e0 + e;
          }
          run[k] += __popc(ballot);
        }
      }
    }
  }

  if (!WRITE) {
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kSlotsPerWarp; ++k) {
      const int w = slot0 + k;
      if (w < W) {
        if (lane == 0) counts[w] = run[k];
        mine += run[k];
      }
    }
    if (lane == 0) slot_s[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int i = 0; i < kWarps; ++i) s += slot_s[i];
      sums[blockIdx.x] = s;
    }
  }
}

// K4 pass 2: one block scans sums[0, n) exclusively in place, 1,024 values
// at a time with a carry, and writes the total to sums[n].
__global__ void __launch_bounds__(kScanThreads)
fanout_offsets_kernel(int32_t* __restrict__ sums, int n) {
  __shared__ int32_t warp_s[kScanThreads / 32];
  __shared__ int32_t carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? sums[i] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_s[warp] = x;
    __syncthreads();  // also orders carry_s's last write before its reads
    if (warp == 0) {  // inclusive scan of the warp totals
      int t = warp_s[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      warp_s[lane] = t;
    }
    __syncthreads();
    const int excl = carry_s + (warp ? warp_s[warp - 1] : 0) + x - v;
    if (i < n) sums[i] = excl;
    __syncthreads();  // every thread has read carry_s and warp_s
    if (threadIdx.x == kScanThreads - 1) carry_s = excl + v;
  }
  __syncthreads();
  if (threadIdx.x == 0) sums[n] = carry_s;
}

// K5: grid (ceil(W / 256), ceil(E / 32)).
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
fanout_mask_kernel(const int32_t* __restrict__ ev_keys,
                   const int64_t* __restrict__ ev_revs, int n_ev, int E,
                   const int32_t* __restrict__ w_start,
                   const int32_t* __restrict__ w_end,
                   const uint8_t* __restrict__ w_unb,
                   const int64_t* __restrict__ w_min_rev, int W, int C,
                   uint8_t* __restrict__ mask) {
  __shared__ int32_t key_s[kMaskEvents * kMaxChunks];
  __shared__ int64_t rev_s[kMaskEvents];
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int e0 = blockIdx.y * kMaskEvents;
  const int en = min(kMaskEvents, E - e0);
  const int live = max(0, min(en, n_ev - e0));  // events below n_ev
  for (int j = threadIdx.x; j < live * C; j += kThreads)
    key_s[j] = ev_keys[(int64_t)e0 * C + j];
  for (int j = threadIdx.x; j < live; j += kThreads) rev_s[j] = ev_revs[e0 + j];
  __syncthreads();
  if (w >= W) return;
  Row<CMAX> row;
  row.load(w_start + (int64_t)w * C, w_end + (int64_t)w * C, C);
  const bool unb = w_unb[w] != 0;
  const int64_t min_rev = w_min_rev[w];
  for (int i = 0; i < en; ++i) {
    bool hit = false;
    if (i < live && rev_s[i] >= min_rev) {
      bool lt_s, lt_e;
      row.less(key_s + i * C, 1, C, lt_s, lt_e);
      hit = !lt_s && (unb || lt_e);
    }
    mask[(int64_t)(e0 + i) * W + w] = hit ? 1 : 0;
  }
}

// Events per staged K4 tile: a multiple of 32 that keeps the tile's key
// chunks within kTileWords and its dynamic shared memory, tile * 8 +
// C * (tile + 1) * 4 bytes, within kSmemBytes (at C <= 4 the words alone
// would pass it: 2,048 events at C = 4 take 49,168 bytes), and no more than
// the block needs. At C = 256 a tile of 32 events takes 34,048 bytes.
int tile_events(int C, int n_ev) {
  int tile = (kTileWords / C) / 32 * 32;
  const int by_bytes = (kSmemBytes - 4 * C) / (8 + 4 * C) / 32 * 32;
  if (by_bytes < tile) tile = by_bytes;
  if (tile < 32) tile = 32;
  const int need = (n_ev + 31) / 32 * 32;
  if (need < tile) tile = need < 32 ? 32 : need;
  return tile;
}

template <int CMAX>
int dispatch(const int32_t* ev_keys, const int64_t* ev_revs, int n_ev, int E,
             const int32_t* w_start, const int32_t* w_end, const uint8_t* w_unb,
             const int64_t* w_min_rev, int W, int C, int size, int32_t* counts,
             int32_t* idx, int32_t* sums, int n_blocks, cudaStream_t stream) {
  const int tile = tile_events(C, n_ev);
  const size_t smem = (size_t)tile * sizeof(int64_t) +
                      (size_t)C * (tile + 1) * sizeof(int32_t);
  fanout_pass_kernel<CMAX, false><<<n_blocks, kThreads, smem, stream>>>(
      ev_keys, ev_revs, n_ev, E, w_start, w_end, w_unb, w_min_rev, W, C, tile,
      size, counts, sums, n_blocks, idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fanout_offsets_kernel<<<1, kScanThreads, 0, stream>>>(sums, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fanout_pass_kernel<CMAX, true><<<n_blocks, kThreads, smem, stream>>>(
      ev_keys, ev_revs, n_ev, E, w_start, w_end, w_unb, w_min_rev, W, C, tile,
      size, counts, sums, n_blocks, idx);
  return (int)cudaGetLastError();
}

template <int CMAX>
int mask(const int32_t* ev_keys, const int64_t* ev_revs, int n_ev, int E,
         const int32_t* w_start, const int32_t* w_end, const uint8_t* w_unb,
         const int64_t* w_min_rev, int W, int C, uint8_t* out,
         cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kThreads - 1) / kThreads),
                  (unsigned)((E + kMaskEvents - 1) / kMaskEvents));
  fanout_mask_kernel<CMAX><<<grid, kThreads, 0, stream>>>(
      ev_keys, ev_revs, n_ev, E, w_start, w_end, w_unb, w_min_rev, W, C, out);
  return (int)cudaGetLastError();
}

bool bad_shape(int n_ev, int E, int W, int C) {
  return C <= 0 || C > kMaxChunks || E < 0 || W < 0 || n_ev < 0 || n_ev > E ||
         (int64_t)W * E > INT32_MAX;
}

}  // namespace

// K4: counts int32[W]; idx int32[size]; sums int32[n_blocks + 1] scratch,
// n_blocks = ceil(W / 32).
extern "C" int kb_fanout_dispatch(const void* ev_keys, const void* ev_revs,
                                  int n_ev, int E, const void* w_start,
                                  const void* w_end, const void* w_unb,
                                  const void* w_min_rev, int W, int C,
                                  int size, void* counts, void* idx,
                                  void* sums, int n_blocks, void* stream) {
  if (bad_shape(n_ev, E, W, C) || size < 0 ||
      n_blocks != (W + kSlotsPerBlock - 1) / kSlotsPerBlock)
    return (int)cudaErrorInvalidValue;
  if (W == 0) return (int)cudaSuccess;
  const auto* k = (const int32_t*)ev_keys;
  const auto* r = (const int64_t*)ev_revs;
  const auto* s = (const int32_t*)w_start;
  const auto* e = (const int32_t*)w_end;
  const auto* u = (const uint8_t*)w_unb;
  const auto* m = (const int64_t*)w_min_rev;
  auto* c = (int32_t*)counts;
  auto* x = (int32_t*)idx;
  auto* q = (int32_t*)sums;
  auto st = (cudaStream_t)stream;
  if (C <= 8)
    return dispatch<8>(k, r, n_ev, E, s, e, u, m, W, C, size, c, x, q,
                       n_blocks, st);
  if (C <= 16)
    return dispatch<16>(k, r, n_ev, E, s, e, u, m, W, C, size, c, x, q,
                        n_blocks, st);
  if (C <= 32)
    return dispatch<32>(k, r, n_ev, E, s, e, u, m, W, C, size, c, x, q,
                        n_blocks, st);
  return dispatch<0>(k, r, n_ev, E, s, e, u, m, W, C, size, c, x, q,
                     n_blocks, st);
}

// K5: mask uint8[E, W] (read as torch.bool), rows e >= n_ev all 0.
extern "C" int kb_fanout_mask(const void* ev_keys, const void* ev_revs,
                              int n_ev, int E, const void* w_start,
                              const void* w_end, const void* w_unb,
                              const void* w_min_rev, int W, int C, void* out,
                              void* stream) {
  if (bad_shape(n_ev, E, W, C) ||
      (E + kMaskEvents - 1) / kMaskEvents > 65535)
    return (int)cudaErrorInvalidValue;
  if (W == 0 || E == 0) return (int)cudaSuccess;
  const auto* k = (const int32_t*)ev_keys;
  const auto* r = (const int64_t*)ev_revs;
  const auto* s = (const int32_t*)w_start;
  const auto* e = (const int32_t*)w_end;
  const auto* u = (const uint8_t*)w_unb;
  const auto* m = (const int64_t*)w_min_rev;
  auto* o = (uint8_t*)out;
  auto st = (cudaStream_t)stream;
  if (C <= 8) return mask<8>(k, r, n_ev, E, s, e, u, m, W, C, o, st);
  if (C <= 16) return mask<16>(k, r, n_ev, E, s, e, u, m, W, C, o, st);
  if (C <= 32) return mask<32>(k, r, n_ev, E, s, e, u, m, W, C, o, st);
  return mask<0>(k, r, n_ev, E, s, e, u, m, W, C, o, st);
}
