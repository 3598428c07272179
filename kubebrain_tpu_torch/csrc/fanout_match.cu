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
// Events e >= n_ev are the padding of the E bucket and match nothing. The
// flat index uses the padded E.
//
// Rank space. The bound rows change only with the watcher set, the events
// with every block. The wrapper passes the table's rank index
// (ops/fanout.py RankIndex): U int32[n_u, C], the distinct bound rows sorted
// (sign-flipped chunks, so signed order is key order), and each slot's
// rs[w], re[w], the indices of its start and end in U. With r(k) = the
// number of rows of U that are <= k:
//   start <= k  <=>  rs < r(k)        k < end  <=>  r(k) <= re
// so a pair costs three integer compares instead of two lexicographic
// compares of C chunks, and the answer is exact. Free slots (start = end =
// the empty key) and legacy pad rows (start the largest key, end the empty
// key) are ordinary rows of U and never match.
//
// Layout (ops/fanout_kernels.py checks it): ev_keys int32[E, C]; U
// int32[n_u, C]; ranks, rs, re int32; ev_revs, w_min_rev int64; w_unb
// uint8 (torch.bool). C <= 256.
//
// Rank kernel (fanout_rank_kernel): one warp per live event, the key in
// shared memory. A 33-ary upper-bound search over U: each step, lane l
// compares the row at the l-th of 32 evenly spaced pivots with the key
// (one cache miss, the row's other chunks then hit L1), and the ballot's
// popcount narrows the interval 33-fold; at 32 rows or fewer each lane
// takes one. log33(n_u) dependent round trips (2 at 710 rows, 3 at 35,000)
// instead of a binary search's log2(n_u). Padding events get rank 0, which
// no slot's rs is below.
//
// K4 design (fanout_match_kernel), one launch after the rank kernel (one
// entry, kb_fanout_dispatch, launches both):
//   - a block of 8 warps takes kBlockSlots = 32 consecutive watcher slots
//     (kWarpSlots = 4 per warp), each slot's rs, re (INT_MAX when
//     unbounded; a slot past W gets rs = INT_MAX and matches nothing) and
//     min_rev in registers. The block stages the events' ranks and
//     revisions in shared memory, tile by tile (2,048 events, 24 KB).
//   - phase A: a warp takes the events 32 at a time, one per lane, and for
//     each of its slots a lane counts its hits (summed over the warp once,
//     at the end): one shared load of a rank and a revision per lane serves
//     all 4 slots. (64 and 128 slots per block were measured slower on the
//     H100 at 100,000 slots; PERF.md.)
//   - the block's sum finds its offset by a decoupled look-back: the block
//     publishes its aggregate in its status word, then warp 0 reads the
//     status words of the 32 nearest earlier blocks at once, adds the
//     values up to the nearest inclusive prefix (or all 32 aggregates, and
//     moves back 32), and publishes its own inclusive prefix. Blocks run in
//     no order, so the block index comes from an atomicAdd ticket: every
//     block a look-back waits on has taken an earlier ticket, has started,
//     and publishes without waiting on a later one. No residency limit can
//     deadlock it. A status word is flag and value in 64 bits (release
//     store, acquire load); the zero fill is "unpublished".
//   - phase B: the same ballots again, for the slots that matched anything
//     and are not past `size` yet; a lane's hit goes to the slot's offset
//     (block prefix + an exclusive scan of the block's slot counts) + the
//     hits of the earlier ballots + __popc(ballot & lanemask_lt), while that
//     is below `size`. The ranks are exactly the row-major order of the
//     mask, so idx equals the JAX _compact's without a sort and without
//     atomics. Recomputing the compares is cheap in rank space, so no
//     ballot buffer is kept, at any E.
//   - the block with the last ticket writes the total. The launch has a few
//     more blocks than slot blocks: a block whose ticket is past the last
//     slot block waits for the total (published by a block that started
//     before it) and fills its share of [min(total, size), size) with W*E.
// Bound: operations where E is large (3 compares per pair), else the bytes
// of the index, the events and the idx writes; the rank search is
// E * log2(n_u) * C compares.
//
// K5 design (fanout_mask_kernel, after the rank kernel; one entry,
// kb_fanout_mask, launches both): one thread per 4 consecutive slots and a
// block per 32 events; ranks and revisions of the block's events staged in
// shared memory (every thread reads the same: a broadcast); a thread
// writes its 4 mask bytes of each event row as one 32-bit store, so a
// warp writes 128 consecutive bytes. The mask write is the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 256;
constexpr int kWarpSlots = 4;       // K4 watcher slots per warp
constexpr int kBlockSlots = kWarps * kWarpSlots;
constexpr int kTileEvents = 2048;   // events of one staged K4 tile: 24 KB
constexpr int kMaskEvents = 32;     // events per K5 block
constexpr int kMaskSlots = 4;       // slots per K5 thread: one 32-bit store
constexpr int kFillSize = 16384;    // idx entries per K4 fill block, at most
constexpr int kMaxFillBlocks = 256;

// status words: flag in bits 32-33, value in the low 32 bits
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kValue = 0xffffffffull;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// row <= key over C chunks (the key in shared memory): the first differing
// chunk decides. The row's first load misses; its other chunks share the
// cache line.
__device__ __forceinline__ bool row_le(const int32_t* __restrict__ row,
                                      const int32_t* key, int C) {
  for (int c = 0; c < C; ++c) {
    const int32_t v = __ldg(row + c), k = key[c];
    if (v != k) return v < k;
  }
  return true;
}

// The rank kernel: grid ceil(E / 8), a warp per event. It also zeroes
// `n_zero` words at `zero` (K4's ticket and status words), so that K4 needs
// no fill launch of its own.
__global__ void __launch_bounds__(kThreads)
fanout_rank_kernel(const int32_t* __restrict__ ev_keys, int n_ev, int E,
                   const int32_t* __restrict__ rows, int n_u, int C,
                   int32_t* __restrict__ ranks,
                   unsigned long long* __restrict__ zero, int n_zero) {
  __shared__ int32_t key_s[kWarps][kMaxChunks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_zero;
       i += gridDim.x * kThreads)
    zero[i] = 0;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= E) return;  // a whole warp; no block barrier below
  if (e >= n_ev) {
    if (lane == 0) ranks[e] = 0;
    return;
  }
  int32_t* key = key_s[warp];
  for (int c = lane; c < C; c += 32) key[c] = ev_keys[(int64_t)e * C + c];
  __syncwarp();
  // rows [0, lo) are <= key, rows [hi, n_u) are > key: the rank is in
  // [lo, hi]. Each step compares 32 pivots at once, one per lane, and keeps
  // the gap between the last pivot <= key and the first one above it.
  int lo = 0, hi = n_u;
  while (lo < hi) {  // the same bounds in every lane: no divergence
    const int n = hi - lo;
    const bool last = n <= 32;
    const int p = last ? lo + lane
                       : lo + (int)((int64_t)(lane + 1) * n / 33);
    const bool le = (!last || lane < n) && row_le(rows + (int64_t)p * C, key, C);
    const int cnt = __popc(__ballot_sync(kFull, le));  // pivots are sorted
    if (last) {
      lo += cnt;
      break;
    }
    const int p_le = __shfl_sync(kFull, p, cnt > 0 ? cnt - 1 : 0);
    const int p_gt = __shfl_sync(kFull, p, cnt < 32 ? cnt : 31);
    if (cnt > 0) lo = p_le + 1;
    if (cnt < 32) hi = p_gt;
  }
  if (lane == 0) ranks[e] = lo;
}

// One slot's rank-space match parameters.
struct Slot {
  int32_t rs, re;
  int64_t min_rev;

  __device__ __forceinline__ void load(int w, int W,
                                       const int32_t* __restrict__ rs_,
                                       const int32_t* __restrict__ re_,
                                       const uint8_t* __restrict__ unb,
                                       const int64_t* __restrict__ mr) {
    if (w < W) {
      rs = rs_[w];
      re = unb[w] ? INT32_MAX : re_[w];
      min_rev = mr[w];
    } else {  // past the table: no rank is above INT32_MAX
      rs = INT32_MAX;
      re = 0;
      min_rev = 0;
    }
  }

  __device__ __forceinline__ bool hit(int32_t r, int64_t rev) const {
    return (rs < r) & (r <= re) & (rev >= min_rev);
  }
};

// Stage events [e0, e0 + tn) of the ranks and revisions, zero ranks up to
// tpad (a multiple of 32): the padding lanes of the last ballot match
// nothing.
__device__ __forceinline__ void stage(const int32_t* __restrict__ ranks,
                                      const int64_t* __restrict__ ev_revs,
                                      int e0, int tn, int tpad,
                                      int32_t* rank_s, int64_t* rev_s) {
  for (int j = threadIdx.x; j < tpad; j += kThreads) {
    const bool live = j < tn;
    rank_s[j] = live ? ranks[e0 + j] : 0;
    rev_s[j] = live ? ev_revs[e0 + j] : 0;
  }
}

// K4's fused launch. Grid: n_blocks slot blocks + n_fill fill blocks, in
// ticket order. scratch (uint64, zeroed): ticket, total word (kPrefix | the
// total), status[n_blocks].
__global__ void __launch_bounds__(kThreads)
fanout_match_kernel(const int32_t* __restrict__ ranks,
                    const int64_t* __restrict__ ev_revs, int n_ev, int E,
                    const int32_t* __restrict__ rs,
                    const int32_t* __restrict__ re,
                    const uint8_t* __restrict__ w_unb,
                    const int64_t* __restrict__ w_min_rev, int W, int size,
                    int tile, int n_blocks, int32_t* __restrict__ counts,
                    int32_t* __restrict__ idx,
                    unsigned long long* __restrict__ scratch) {
  constexpr int SPW = kWarpSlots, SPB = kBlockSlots;
  constexpr int PER = SPB / 32;  // slots of one lane in the block's scan
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* rev_s = reinterpret_cast<int64_t*>(smem);
  int32_t* rank_s = reinterpret_cast<int32_t*>(rev_s + tile);
  __shared__ int32_t slot_s[SPB];  // slot counts, then exclusive offsets
  __shared__ int32_t ticket_s, total_s;

  unsigned long long* ticket = scratch;
  unsigned long long* total_word = scratch + 1;
  unsigned long long* status = scratch + 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) ticket_s = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  const int b = ticket_s;

  if (b >= n_blocks) {
    // a fill block: every slot block took an earlier ticket and is running
    if (t == 0) {
      unsigned long long s;
      while (!((s = load_acquire(total_word)) & kPrefix)) __nanosleep(64);
      total_s = (int)(s & kValue);
    }
    __syncthreads();
    const int fill = W * E;  // the wrapper keeps W * E below 2^31
    const int f = b - n_blocks, nf = (int)gridDim.x - n_blocks;
    for (int64_t i = (int64_t)min(total_s, size) + (int64_t)f * kThreads + t;
         i < size; i += (int64_t)nf * kThreads)
      idx[i] = fill;
    return;
  }

  const int slot0 = b * SPB + warp * SPW;
  Slot slot[SPW];
#pragma unroll
  for (int k = 0; k < SPW; ++k)
    slot[k].load(slot0 + k, W, rs, re, w_unb, w_min_rev);

  // phase A: count, each lane its own events, summed over the warp after
  int run[SPW];
#pragma unroll
  for (int k = 0; k < SPW; ++k) run[k] = 0;
  const bool one_tile = n_ev <= tile;
  for (int e0 = 0; e0 < n_ev; e0 += tile) {
    const int tn = min(tile, n_ev - e0), tpad = (tn + 31) & ~31;
    __syncthreads();  // the previous tile is consumed
    stage(ranks, ev_revs, e0, tn, tpad, rank_s, rev_s);
    __syncthreads();
    for (int c0 = 0; c0 < tpad; c0 += 32) {
      const int32_t r = rank_s[c0 + lane];
      const int64_t v = rev_s[c0 + lane];
#pragma unroll
      for (int k = 0; k < SPW; ++k) run[k] += slot[k].hit(r, v);
    }
  }
#pragma unroll
  for (int k = 0; k < SPW; ++k) run[k] = __reduce_add_sync(kFull, run[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < SPW; ++k) {
      if (slot0 + k < W) counts[slot0 + k] = run[k];
      slot_s[warp * SPW + k] = run[k];
    }
  }
  __syncthreads();

  // the block's offset: decoupled look-back, then the slots' offsets
  if (warp == 0) {
    int loc[PER], sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      loc[i] = slot_s[lane * PER + i];
      sum += loc[i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int block_sum = __shfl_sync(kFull, incl, 31);
    int prefix = 0;
    if (b == 0) {
      if (lane == 0) store_release(status, kPrefix | (unsigned)block_sum);
    } else {
      if (lane == 0) store_release(status + b, kAggregate | (unsigned)block_sum);
      for (int j = b - 1;;) {
        const int i = j - lane;
        const unsigned long long s = i >= 0 ? load_acquire(status + i) : kPrefix;
        if (__any_sync(kFull, (s >> 32) == 0)) {  // a window lane unpublished
          __nanosleep(32);
          continue;
        }
        const unsigned pre = __ballot_sync(kFull, (s & kPrefix) != 0);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        prefix += __reduce_add_sync(kFull, lane <= stop ? (int)(s & kValue) : 0);
        if (pre) break;
        j -= 32;
      }
      if (lane == 0)
        store_release(status + b, kPrefix | (unsigned)(prefix + block_sum));
    }
    if (b == n_blocks - 1 && lane == 0)  // the total: the word's low half
      store_release(total_word, kPrefix | (unsigned)(prefix + block_sum));
    int off = prefix + incl - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      slot_s[lane * PER + i] = off;
      off += loc[i];
    }
  }
  __syncthreads();

  // phase B: the same ballots, each hit written at its rank
  int pos[SPW];
  bool need = false;
#pragma unroll
  for (int k = 0; k < SPW; ++k) {
    pos[k] = slot_s[warp * SPW + k];
    need |= run[k] > 0 && pos[k] < size;  // the same in every lane
  }
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = 0; e0 < n_ev; e0 += tile) {
    const int tn = min(tile, n_ev - e0), tpad = (tn + 31) & ~31;
    if (!one_tile) {
      __syncthreads();
      stage(ranks, ev_revs, e0, tn, tpad, rank_s, rev_s);
      __syncthreads();
    }
    if (!need) continue;
    for (int c0 = 0; c0 < tpad; c0 += 32) {
      const int32_t r = rank_s[c0 + lane];
      const int64_t v = rev_s[c0 + lane];
#pragma unroll
      for (int k = 0; k < SPW; ++k) {
        if (run[k] == 0 || pos[k] >= size) continue;  // warp-uniform
        const bool hit = slot[k].hit(r, v);
        const unsigned ballot = __ballot_sync(kFull, hit);
        if (ballot) {  // warp-uniform: most ballots of a slot are empty
          if (hit) {
            const int p = pos[k] + __popc(ballot & below);
            if (p < size) idx[p] = (slot0 + k) * E + e0 + c0 + lane;
          }
          pos[k] += __popc(ballot);
        }
      }
    }
  }
}

// K5: grid (ceil(W / 1024), ceil(E / 32)).
__global__ void __launch_bounds__(kThreads)
fanout_mask_kernel(const int32_t* __restrict__ ranks,
                   const int64_t* __restrict__ ev_revs, int n_ev, int E,
                   const int32_t* __restrict__ rs,
                   const int32_t* __restrict__ re,
                   const uint8_t* __restrict__ w_unb,
                   const int64_t* __restrict__ w_min_rev, int W,
                   uint8_t* __restrict__ mask) {
  __shared__ int32_t rank_s[kMaskEvents];
  __shared__ int64_t rev_s[kMaskEvents];
  const int e0 = blockIdx.y * kMaskEvents;
  const int en = min(kMaskEvents, E - e0);
  for (int j = threadIdx.x; j < en; j += kThreads) {
    const bool live = e0 + j < n_ev;
    rank_s[j] = live ? ranks[e0 + j] : 0;
    rev_s[j] = live ? ev_revs[e0 + j] : 0;
  }
  __syncthreads();
  const int w0 = (blockIdx.x * kThreads + threadIdx.x) * kMaskSlots;
  if (w0 >= W) return;
  Slot slot[kMaskSlots];
#pragma unroll
  for (int q = 0; q < kMaskSlots; ++q)
    slot[q].load(w0 + q, W, rs, re, w_unb, w_min_rev);
  const bool whole = (W % kMaskSlots) == 0;  // 4-byte aligned rows
  for (int i = 0; i < en; ++i) {
    const int32_t r = rank_s[i];
    const int64_t v = rev_s[i];
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < kMaskSlots; ++q)
      word |= (uint32_t)slot[q].hit(r, v) << (8 * q);
    uint8_t* row = mask + (int64_t)(e0 + i) * W + w0;
    if (whole) {
      *reinterpret_cast<uint32_t*>(row) = word;
    } else {
      for (int q = 0; q < kMaskSlots && w0 + q < W; ++q)
        row[q] = (uint8_t)(word >> (8 * q));
    }
  }
}

// Events per staged K4 tile: no more than the block needs.
int tile_events(int n_ev) {
  const int need = (n_ev + 31) / 32 * 32;
  return need < 32 ? 32 : (need < kTileEvents ? need : kTileEvents);
}

bool bad_shape(int n_ev, int E, int W) {
  return E < 0 || W < 0 || n_ev < 0 || n_ev > E ||
         (int64_t)W * E > INT32_MAX;
}

}  // namespace

// K4: the rank kernel (which zeroes the scratch), then the fused launch.
// ranks int32[E] (work space); counts int32[W]; idx int32[size]; scratch
// uint64[ceil(W / 32) + 2], the total in the low 32 bits of scratch[1]
// afterwards. W > 0.
extern "C" int kb_fanout_dispatch(const void* ev_keys, const void* ev_revs,
                                  int n_ev, int E, int C, const void* rows,
                                  int n_u, const void* rs, const void* re,
                                  const void* w_unb, const void* w_min_rev,
                                  int W, int size, void* ranks, void* counts,
                                  void* idx, void* scratch, void* stream) {
  if (bad_shape(n_ev, E, W) || W == 0 || size < 0 || C <= 0 ||
      C > kMaxChunks || n_u < 0)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const int n_blocks = (W + kBlockSlots - 1) / kBlockSlots;
  auto* q = (unsigned long long*)scratch;
  if (E > 0) {
    fanout_rank_kernel<<<(E + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        (const int32_t*)ev_keys, n_ev, E, (const int32_t*)rows, n_u, C,
        (int32_t*)ranks, q, n_blocks + 2);
  } else {
    const cudaError_t err =
        cudaMemsetAsync(q, 0, (size_t)(n_blocks + 2) * sizeof(*q), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int tile = tile_events(n_ev);
  const size_t smem = (size_t)tile * (sizeof(int64_t) + sizeof(int32_t));
  int n_fill = size > 0 ? (size + kFillSize - 1) / kFillSize : 0;
  if (n_fill > kMaxFillBlocks) n_fill = kMaxFillBlocks;
  fanout_match_kernel<<<n_blocks + n_fill, kThreads, smem, st>>>(
      (const int32_t*)ranks, (const int64_t*)ev_revs, n_ev, E,
      (const int32_t*)rs, (const int32_t*)re, (const uint8_t*)w_unb,
      (const int64_t*)w_min_rev, W, size, tile, n_blocks, (int32_t*)counts,
      (int32_t*)idx, q);
  return (int)cudaGetLastError();
}

// K5: the rank kernel, then the mask kernel. ranks int32[E] (work space);
// mask uint8[E, W] (read as torch.bool), rows e >= n_ev all 0. E, W > 0.
extern "C" int kb_fanout_mask(const void* ev_keys, const void* ev_revs,
                              int n_ev, int E, int C, const void* rows,
                              int n_u, const void* rs, const void* re,
                              const void* w_unb, const void* w_min_rev, int W,
                              void* ranks, void* out, void* stream) {
  if (bad_shape(n_ev, E, W) || W == 0 || E == 0 || C <= 0 ||
      C > kMaxChunks || n_u < 0 ||
      (E + kMaskEvents - 1) / kMaskEvents > 65535)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  fanout_rank_kernel<<<(E + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const int32_t*)ev_keys, n_ev, E, (const int32_t*)rows, n_u, C,
      (int32_t*)ranks, nullptr, 0);
  const int per_block = kThreads * kMaskSlots;
  const dim3 grid((unsigned)((W + per_block - 1) / per_block),
                  (unsigned)((E + kMaskEvents - 1) / kMaskEvents));
  fanout_mask_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)ranks, (const int64_t*)ev_revs, n_ev, E,
      (const int32_t*)rs, (const int32_t*)re, (const uint8_t*)w_unb,
      (const int64_t*)w_min_rev, W, (uint8_t*)out);
  return (int)cudaGetLastError();
}
