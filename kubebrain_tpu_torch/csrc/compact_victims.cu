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
// A TTL group expires whole however long its chain is (the Pallas
// semantics; the jnp kernel caps the chain at 64 rows).
//
// Layout, as for the visibility kernels (scan_visibility.cu):
//   keys int32[P, C, N] chunk-major, sign-flipped, C <= 32; revs int64[P, N];
//   tomb, ttl int8[P, N]; n_valid int32[P]; start, end int32[C] flipped.
// Outputs: mask uint8[P, N] (0/1, read as torch.bool), every row written,
// zero at and past n_valid; the victims of each partition in the first P
// words of `scratch`, int32 words zeroed by the caller:
//   scratch = counts[P], ticket, status[P * T]   (T tiles per partition).
//
// Bound: memory. The function reads 4·C + 8 + 1 + 1 bytes per valid row
// inside [start, end) (keys, revision, tombstone, TTL flag) and writes one
// mask byte per row of [P, N]; 3.35 TB/s over those bytes is the bound.
// Compares are C per row (the next row's key), far below the bytes.
//
// Design: one launch, each valid row read once.
// 1. Tiles of R = 8 rows per thread and 256 threads, so a block owns a
//    tile of 2,048 consecutive rows (measured faster on an H100 than R = 4
//    on the encoded shapes and at 20M raw rows). Chunk c of a
//    thread's rows is one 16-byte load per 4 rows (chunk-major layout), the
//    revisions 16-byte loads, tombstone and TTL flags one R-byte load each,
//    the mask one R-byte store. Row i+1's key chunk and revision come from
//    the next lane (__shfl_down_sync); lane 31 loads them (the next warp's
//    first row, or the next tile's: the look-ahead row). The revisions and
//    flags are loaded first, then the key chunks (chunk_batch below), in a
//    loop unrolled to a compile-time CMAX (8 or 32) with the run-time C
//    masked by predicates. Per row a thread keeps one "differs from the
//    next row" bit and the running start/end compares, never the key.
//    Where the rows are not 16-byte aligned or run past N (an N that is not
//    a multiple of R), the same code takes scalar loads.
// 2. Tile classes, as K1/K2 classify blocks (scan_visibility.cu): warps 0
//    and 1 load the keys of the tile's first row and of its last valid row
//    (chunk c in lane c) in the same round trip as n_valid, and compare them
//    with the bounds by warp ballot. Rows are sorted, so the tile is outside
//    (past n_valid, last key < start, or first key >= a bounded end: writes
//    its zero mask bytes, reads no other column), inside (no row compares a
//    bound) or straddling (rows compare their chunks with the bounds, held
//    in shared memory). A key's version chain is all in range or all out,
//    so a TTL group never straddles a range edge.
// 3. The TTL verdict of a group lives at its last row, and a chain can span
//    any number of tiles. Each thread resolves its rows by a backward pass,
//    then across lanes by ballot, __ffs and shuffle, across warps through
//    shared memory. The tile publishes one status word: the verdict of its
//    first group end, or kNoEnd. Only a tile with an in-range TTL row whose
//    group is still open at its last row looks back: thread 0 reads the
//    status of tiles b+1, b+2, ... of its partition until one holds a
//    verdict (it never runs past the partition: the last valid row always
//    ends a group), and a kNoEnd tile then publishes the verdict it found,
//    so later look-backs stop there. Tiles publish before they look back,
//    and take their index from an atomicAdd ticket in reverse order, so a
//    tile waited upon has started already and publishes without waiting:
//    no residency limit can deadlock the look-back. The status word is the
//    whole message (release store, acquire load); the zero fill makes every
//    word "unpublished" at launch, so no earlier launch's value is read.
//    With ttl_cutoff <= 0 there is no ticket, status or look-back.
// 4. The counts come from the same launch: per warp __popc and a warp sum,
//    per block one shared sum, per tile one integer atomicAdd — exact and
//    independent of order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int R = 8;  // rows per thread (a multiple of 4)
constexpr int kTile = kThreads * R;
constexpr int kMaxChunks = 32;
constexpr unsigned kFull = 0xffffffffu;

// A tile's status word; kKept and kExpired are also a group end's verdict.
constexpr int kUnpublished = 0;  // the zero fill
constexpr int kNoEnd = 1;        // no group end in the tile
constexpr int kKept = 2;         // the group's last revision > ttl_cutoff
constexpr int kExpired = 3;      // the group's last revision <= ttl_cutoff

constexpr int kOutside = 0, kInside = 1, kStraddle = 2;

__device__ __forceinline__ void store_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int32_t load_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// R consecutive values from p, of which the first n (<= R) exist: 16-byte
// loads where all R exist and p is 16-byte aligned, else scalar loads (the
// rest are 0).
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ p, int n,
                                          int32_t (&v)[R]) {
  if (n == R && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p + j));
      v[j] = x.x;
      v[j + 1] = x.y;
      v[j + 2] = x.z;
      v[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = j < n ? __ldg(p + j) : 0;
  }
}

__device__ __forceinline__ void load_rows(const long long* __restrict__ p,
                                          int n, long long (&v)[R]) {
  if (n == R && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 2) {
      const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p + j));
      v[j] = x.x;
      v[j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = j < n ? __ldg(p + j) : 0;
  }
}

// Bit j set where byte j of the R consecutive int8 flags at p is nonzero
// (the first n exist).
__device__ __forceinline__ uint32_t load_flags(const int8_t* __restrict__ p,
                                               int n) {
  uint32_t bits = 0;
  if (n == R && (reinterpret_cast<uintptr_t>(p) & (R - 1)) == 0) {
    const unsigned long long w =
        __ldg(reinterpret_cast<const unsigned long long*>(p));
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((w >> (8 * j)) & 0xff) bits |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n && __ldg(p + j) != 0) bits |= 1u << j;
  }
  return bits;
}

// Byte j of the R mask bytes at p is bit j of `bits` (the first n exist).
__device__ __forceinline__ void store_mask(uint8_t* __restrict__ p, int n,
                                           uint32_t bits) {
  if (n == R && (reinterpret_cast<uintptr_t>(p) & (R - 1)) == 0) {
    unsigned long long w = 0;
#pragma unroll
    for (int j = 0; j < R; ++j)
      w |= (unsigned long long)((bits >> j) & 1u) << (8 * j);
    *reinterpret_cast<unsigned long long*>(p) = w;
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n) p[j] = (uint8_t)((bits >> j) & 1u);
  }
}

// key < bound, lexicographically, with chunk c of the key and of the bound
// in lane c (lanes >= C hold nothing): the first differing chunk decides.
__device__ __forceinline__ bool warp_lex_less(int32_t k, int32_t bound,
                                              bool lane_has_chunk) {
  const unsigned ne = __ballot_sync(kFull, lane_has_chunk && k != bound);
  const unsigned lt = __ballot_sync(kFull, lane_has_chunk && k < bound);
  return ne != 0 && ((lt >> (__ffs(ne) - 1)) & 1u);
}

// Key chunks a thread loads together: at C <= 8 one at a time (fewer
// registers, so more resident blocks hide the latency), at C = 32 32 / R of
// them (32 key words in flight), which a launch of few tiles needs (each
// measured faster on an H100 than the other choice).
template <int CMAX>
__host__ __device__ constexpr int chunk_batch() {
  return CMAX <= 8 ? 1 : 32 / R;
}

// Resident blocks per SM the register budget must allow: at C <= 8, 5 (48
// registers) hide the latency of a tile's dependent steps best; at C = 32
// the compiler's own choice measured best.
template <int CMAX>
constexpr int min_blocks() { return CMAX <= 8 ? 5 : 1; }

template <int CMAX>
__global__ void __launch_bounds__(kThreads, min_blocks<CMAX>())
victim_kernel(
    const int32_t* __restrict__ keys, const long long* __restrict__ revs,
    const int8_t* __restrict__ tomb, const int8_t* __restrict__ ttl,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ start,
    const int32_t* __restrict__ end, int unbounded, long long compact_rev,
    long long ttl_cutoff, int P, int C, int N, int T,
    uint8_t* __restrict__ mask, int32_t* __restrict__ scratch) {
  __shared__ int32_t start_s[CMAX], end_s[CMAX];
  __shared__ int32_t warp_first_s[kWarps];  // a warp's first group end verdict
  __shared__ int32_t warp_pending_s[kWarps];  // a TTL row waits past the warp
  // first key < start, first < end, last valid key < start, last < end
  __shared__ int32_t less_s[4];
  __shared__ int32_t tile_s, tail_s, count_s;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int32_t* counts = scratch;
  int32_t* ticket = scratch + P;
  int32_t* status = scratch + P + 1;
  const bool with_ttl = ttl_cutoff > 0;  // uniform over the launch

  // 1. The tile: by ticket in reverse order where a look-back may wait.
  int g = blockIdx.x;
  if (with_ttl) {
    if (t == 0) tile_s = (int)gridDim.x - 1 - atomicAdd(ticket, 1);
    __syncthreads();
    g = tile_s;
  }
  const int p = g / T;
  const int b = g - p * T;
  const long long b0 = (long long)b * kTile;
  const int32_t* kp = keys + (long long)p * C * N;
  const long long nv = n_valid[p];

  // 2. Classify the tile from the keys of its first and last valid row,
  // loaded (the last one speculatively, at the tile's last row below N) in
  // the same round trip as n_valid.
  if (warp < 2) {
    const bool has = lane < C;
    const long long spec = min(b0 + kTile, (long long)N) - 1;
    const long long last = min(b0 + kTile, nv) - 1;
    int32_t k = 0, s = 0, e = 0;
    if (has) {
      k = kp[(long long)lane * N + (warp == 0 ? b0 : spec)];
      s = start[lane];
      e = end[lane];
    }
    if (warp == 1 && has && last != spec && last >= b0)
      k = kp[(long long)lane * N + last];
    const bool lt_s = warp_lex_less(k, s, has);
    const bool lt_e = warp_lex_less(k, e, has);
    if (lane == 0) {
      less_s[2 * warp] = lt_s;
      less_s[2 * warp + 1] = lt_e;
    }
    if (warp == 0 && has) {
      start_s[lane] = s;
      end_s[lane] = e;
    }
  }
  if (t == 0) count_s = 0;
  __syncthreads();
  const bool unb = unbounded != 0;
  int cls = kStraddle;
  if (b0 >= nv || less_s[2] || (!unb && !less_s[1]))
    cls = kOutside;
  else if (!less_s[0] && (unb || less_s[3]))
    cls = kInside;

  const long long i0 = b0 + (long long)t * R;
  const int nrow = (int)max(0LL, min((long long)R, (long long)N - i0));
  uint8_t* mrow = mask + (long long)p * N + i0;
  if (cls == kOutside) {  // uniform over the block
    if (nrow > 0) store_mask(mrow, nrow, 0);
    if (with_ttl && t == 0) store_release(status + g, kNoEnd);
    return;
  }

  // 3. The thread's rows i0 .. i0 + R - 1.
  const long long rem = nv - i0;  // valid rows from i0 on
  const int nval = (int)max(0LL, min((long long)R, rem));
  const int nload = nval > 0 ? nrow : 0;
  const bool next_valid = rem > R;  // row i0 + R is valid
  const bool straddle = cls == kStraddle;
  // revisions and flags first, so that their loads overlap the keys'
  const long long* rp = revs + (long long)p * N + i0;
  long long rv[R];
  load_rows(rp, nload, rv);
  long long rnext = lane == 31 && next_valid ? __ldg(rp + R) : 0;
  const uint32_t dead = load_flags(tomb + (long long)p * N + i0, nload);
  const uint32_t ttl_rows =
      with_ttl ? load_flags(ttl + (long long)p * N + i0, nload) : 0u;
  // key chunks in batches of kBatch, whose loads are in flight together
  constexpr int kBatch = chunk_batch<CMAX>();
  uint32_t differs = 0;  // bit r: row r's key differs from row r + 1's
  uint32_t lt_start = 0, dec_start = 0, lt_end = 0, dec_end = 0;
#pragma unroll
  for (int c0 = 0; c0 < CMAX; c0 += kBatch) {
    if (c0 >= C) break;
    int32_t k[kBatch][R], nx[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int32_t* kc = kp + (long long)(c0 + j) * N + i0;
      const bool has = c0 + j < C;
      load_rows(kc, has ? nload : 0, k[j]);
      nx[j] = has && lane == 31 && next_valid ? __ldg(kc + R) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j >= C) break;
      const int32_t down = __shfl_down_sync(kFull, k[j][0], 1);
      if (lane != 31) nx[j] = down;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k[j][r] != (r + 1 < R ? k[j][r + 1] : nx[j])) differs |= 1u << r;
      if (straddle) {
        const int32_t s = start_s[c0 + j], e = end_s[c0 + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t bit = 1u << r;
          if (!(dec_start & bit) && k[j][r] < s) lt_start |= bit;
          if (k[j][r] != s) dec_start |= bit;
          if (!(dec_end & bit) && k[j][r] < e) lt_end |= bit;
          if (k[j][r] != e) dec_end |= bit;
        }
      }
    }
  }
  const long long down = __shfl_down_sync(kFull, rv[0], 1);
  if (lane != 31) rnext = down;

  // Backward over the rows: `tv` is the verdict of the first group end at
  // or after row r; a TTL row without one is pending.
  uint32_t victims = 0, pending = 0;
  int tv = 0;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if (r >= nval) continue;
    const uint32_t bit = 1u << r;
    const bool same_next = r + 1 < rem && !(differs & bit);
    const long long newer = r + 1 < R ? rv[r + 1] : rnext;
    const bool in_range =
        !straddle || (!(lt_start & bit) && (unb || (lt_end & bit)));
    if (in_range && rv[r] <= compact_rev &&
        ((same_next && newer <= compact_rev) || (dead & bit)))
      victims |= bit;
    if (!same_next) tv = rv[r] <= ttl_cutoff ? kExpired : kKept;
    if (in_range && (ttl_rows & bit)) {
      if (tv == kExpired)
        victims |= bit;
      else if (tv == 0)
        pending |= bit;
    }
  }

  if (with_ttl) {
    // across lanes: the first later lane of the warp with a group end
    const unsigned ends = __ballot_sync(kFull, tv != 0);
    const unsigned later = lane == 31 ? 0u : ends & (kFull << (lane + 1));
    const int from_lane =
        __shfl_sync(kFull, tv, later ? __ffs(later) - 1 : lane);
    if (later) {
      if (from_lane == kExpired) victims |= pending;
      pending = 0;
    }
    const int first = __shfl_sync(kFull, tv, ends ? __ffs(ends) - 1 : 0);
    const bool warp_pending = __any_sync(kFull, pending != 0);
    if (lane == 0) {
      warp_first_s[warp] = ends ? first : 0;
      warp_pending_s[warp] = warp_pending;
    }
    __syncthreads();
    // across warps; the tile's first verdict; whether a TTL row waits past
    // the tile's last group end
    int tile_first = 0, after = 0;
    bool need = false;
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      if (w == warp) after = tile_first;
      if (warp_pending_s[w] && !tile_first) need = true;
      if (warp_first_s[w]) tile_first = warp_first_s[w];
    }
    if (t == 0) {
      store_release(status + g, tile_first ? tile_first : kNoEnd);
      if (need) {
        // the first group end in a later tile of the partition; the last
        // valid row always ends a group, so the walk stops inside it
        int v = kKept;
        for (int j = g + 1; j < (p + 1) * T; ++j) {
          int s;
          while ((s = load_acquire(status + j)) == kUnpublished)
            __nanosleep(20);
          if (s != kNoEnd) {
            v = s;
            break;
          }
        }
        tail_s = v;
        if (!tile_first) store_release(status + g, v);
      }
    }
    if (need) {
      __syncthreads();
      if (pending && (after ? after : tail_s) == kExpired) victims |= pending;
    } else if (pending && after == kExpired) {
      victims |= pending;
    }
  }

  if (nrow > 0) store_mask(mrow, nrow, victims);
  // 4. counts: one shared sum per block, one atomicAdd per tile
  const int n = __reduce_add_sync(kFull, __popc(victims));
  if (lane == 0 && n) atomicAdd(&count_s, n);
  __syncthreads();
  if (t == 0 && count_s) atomicAdd(counts + p, count_s);
}

template <int CMAX>
void start_kernel(int grid, cudaStream_t stream, const void* keys,
                  const void* revs, const void* tomb, const void* ttl,
                  const void* n_valid, const void* start, const void* end,
                  int unbounded, long long compact_rev, long long ttl_cutoff,
                  int P, int C, int N, int T, void* mask, void* scratch) {
  victim_kernel<CMAX><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)keys, (const long long*)revs, (const int8_t*)tomb,
      (const int8_t*)ttl, (const int32_t*)n_valid, (const int32_t*)start,
      (const int32_t*)end, unbounded, compact_rev, ttl_cutoff, P, C, N, T,
      (uint8_t*)mask, (int32_t*)scratch);
}

}  // namespace

// Rows of a K3 tile: the wrapper sizes the scratch with it.
extern "C" int kb_victim_tile_rows() { return kTile; }

// K3 over every partition in one launch. mask uint8[P, N]; scratch int32
// [P + 1 + P * ceil(N / kb_victim_tile_rows())], zeroed by the caller: the
// victims of partition p are scratch[p] afterwards.
extern "C" int kb_victim_mask(const void* keys, const void* revs,
                              const void* tomb, const void* ttl,
                              const void* n_valid, const void* start,
                              const void* end, int unbounded,
                              long long compact_rev, long long ttl_cutoff,
                              int P, int C, int N, void* mask, void* scratch,
                              void* stream) {
  if (C < 0 || C > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  const long long T = ((long long)N + kTile - 1) / kTile;
  if ((long long)P * T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(P * T);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C <= 8)
    start_kernel<8>(grid, s, keys, revs, tomb, ttl, n_valid, start, end,
                    unbounded, compact_rev, ttl_cutoff, P, C, N, (int)T, mask,
                    scratch);
  else
    start_kernel<kMaxChunks>(grid, s, keys, revs, tomb, ttl, n_valid, start,
                             end, unbounded, compact_rev, ttl_cutoff, P, C, N,
                             (int)T, mask, scratch);
  return (int)cudaGetLastError();
}
