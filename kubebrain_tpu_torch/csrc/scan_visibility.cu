// MVCC visibility scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernels of kubebrain_tpu/ops/scan_pallas.py:
//   K1 scan_mask_pallas   (:175, body _kernel :134 / _tile_visibility :82)
//   K2 scan_mask_pallas_q (:222, body _kernel_q :150)
// Both run one body here, visibility_kernel<CMAX>, which packs up to 32
// queries per block in the bits of one register; K1 is its launch for one.
//
// Per query q and row i of partition p:
//   cand[i]    = i < n_valid[p] && start_q <= key[i]
//                && (unbounded_q || key[i] < end_q) && rev[i] <= read_rev_q
//   visible[i] = cand[i] && !(key[i] == key[i+1] && cand[i+1]) && !tomb[i]
//
// Precondition: the valid rows of each partition are non-decreasing in the
// sign-flipped chunk order (sorted by key, then revision; no partition splits
// a key's version chain). Every mirror the engine publishes holds it: build,
// delta merge, capacity grow and compaction all keep rows sorted. The
// superseded test needs it, and so does the block classification below.
//
// Layout (built once per mirror publish):
//   keys  int32[P, C, N]  chunk-major; big-endian uint32 chunks with the
//                         sign bit flipped, so a signed compare is unsigned
//                         byte order. C <= 32 (KEY_WIDTH = 128 bytes); 6 for
//                         encoded kube keys, 32 for raw keys.
//   revs  int64[P, N]     one column: Hopper has native 64-bit integers, so
//                         the TPU's 31-bit hi/lo split is gone.
//   tomb  int8[P, N];  n_valid int32[P]
// Outputs: mask uint8[Q, P, N] (0/1, read as torch.bool); counts int32[Q, P],
// zeroed by the caller.
//
// Design. Grid (ceil(N / 255), P, ceil(Q / 32)), one thread per row. The
// TPU kernel swept every tile in a fixed reverse order and carried the next
// tile's first key across grid steps; blocks here run in no order, so each
// block of 256 threads reads 256 consecutive rows b0 .. b0+255 but owns only
// the first 255: row i reads row i+1's candidate bits from shared memory, and
// row i+1's key chunks straight from global memory (an L1 hit).
//
// Because rows are sorted, the rows of [start, end) are one contiguous run of
// each partition. So before it touches a row, a block loads the keys of the
// first and the last row it reads below n_valid (the look-ahead row
// included) and classifies itself for each query of its slice:
//   outside   last key < start, or first key >= end (end bounded), or the
//             block lies past n_valid: no row it reads is in range;
//   inside    first key >= start and (end unbounded or last key < end):
//             every row it reads is in range;
//   straddle  anything else (at most two blocks per query and partition).
// A block outside for every query writes its zero mask bytes and exits,
// having read 2·C key chunks and no revision, tombstone or key column. Only
// straddling (query, block) pairs compare keys with bounds (their chunks
// re-read from L1); an inside pair takes in_range = true. The queries'
// bounds, flags and read revisions are staged in shared memory once per
// block, and the chunk loop is unrolled to a compile-time CMAX (8 or 32; the
// run-time C is masked by predicates), so a row's chunk loads and its
// neighbour's are in flight together.
// Latency, not bandwidth, is what a block of 255 rows fights: it waits for
// its edge keys (loaded in one round trip with n_valid, the look-ahead row's
// before n_valid is known), for its bounds, and for its rows. No key is held
// in registers, and at C <= 8 the launch bounds ask for 8 resident blocks per
// SM, so that other blocks' loads fill those waits. (Measured on an H100:
// classifying in every warp instead of warp 0, holding the bounds in
// registers across the n_valid test, or a register budget of 4 blocks at
// C = 32 each made some shape slower.)
// Counts come from the same launch: a warp ballot per live query, __popc,
// one integer atomicAdd per warp — exact and independent of order.
//
// Bound: memory. What a launch must move is the keys, revision and tombstone
// of the rows inside the queries' ranges (4·C + 8 + 1 bytes each) and the Q
// mask bytes of every row of [P, N]; the design reads rows outside every
// range only as the 2·C chunks of each block's edge keys. A namespace query
// over a large mirror is thus bound by its mask write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads - 1;
constexpr int kMaxChunks = 32;
constexpr int kQueries = 32;  // queries per block: the bits of one register

// a < b over the first C chunks, both in shared memory: the first differing
// chunk decides.
__device__ __forceinline__ bool lex_less_shared(const int32_t* a,
                                                const int32_t* b, int C) {
  for (int c = 0; c < C; ++c)
    if (a[c] != b[c]) return a[c] < b[c];
  return false;
}

// key < b over the first C <= CMAX chunks, the key's chunks read from global
// memory N apart (L1 hits: the same thread has just read them): folded from
// the last chunk to the first, without branches.
template <int CMAX>
__device__ __forceinline__ bool lex_less_row(const int32_t* __restrict__ key,
                                             int64_t N, const int32_t* b,
                                             int C) {
  bool less = false;
#pragma unroll
  for (int c = CMAX - 1; c >= 0; --c)
    if (c < C) {
      const int32_t k = key[c * N];
      less = (k < b[c]) || (k == b[c] && less);
    }
  return less;
}

// Resident blocks per SM the register budget must allow. A block's time is
// mostly the latency of its two dependent steps (edge keys, then rows),
// which only other resident blocks hide; at C <= 8 the rows are narrow and
// 8 blocks (32 registers) hide it best. At C = 32 the compiler's own choice
// measured best.
template <int CMAX>
constexpr int min_blocks() { return CMAX <= 8 ? 8 : 1; }

template <int CMAX>
__global__ void __launch_bounds__(kThreads, min_blocks<CMAX>())
visibility_kernel(
    const int32_t* __restrict__ keys, const int64_t* __restrict__ revs,
    const int8_t* __restrict__ tomb, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ unbounded, const int64_t* __restrict__ read_revs,
    int P, int C, int N, int Q, uint8_t* __restrict__ mask,
    int32_t* __restrict__ counts) {
  // one bound row per query, padded by a chunk so that the lanes of a warp
  // (one query each) read distinct banks
  constexpr int kStride = CMAX + 1;
  __shared__ int32_t start_s[kQueries * kStride];
  __shared__ int32_t end_s[kQueries * kStride];
  __shared__ int64_t read_rev_s[kQueries];
  __shared__ int32_t unbounded_s[kQueries];
  __shared__ int32_t edge_s[2][CMAX];  // first and last row read below n_valid
  __shared__ uint32_t inside_s, straddle_s;
  __shared__ uint32_t cand_s[kThreads];

  const int t = threadIdx.x;
  const int p = blockIdx.y;
  const int q0 = blockIdx.z * kQueries;
  const int nq = min(kQueries, Q - q0);
  const int64_t b0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int64_t i = b0 + t;
  const int32_t* kp = keys + (int64_t)p * C * N;
  const bool owns = t < kRowsPerBlock && i < N;
  // row i's mask byte for query q0; query q0 + qq lies qq·P·N further on
  uint8_t* mrow = mask + ((int64_t)q0 * P + p) * N + i;
  const int64_t q_stride = (int64_t)P * N;

  // The keys of the block's first row and of its look-ahead row are loaded
  // in the same round trip as n_valid, before n_valid is known.
  const int64_t ahead = b0 + kThreads - 1 < N ? b0 + kThreads - 1 : N - 1;
  int32_t edge = 0;
  if (t < C)
    edge = kp[(int64_t)t * N + b0];
  else if (t >= 32 && t < 32 + C)
    edge = kp[(int64_t)(t - 32) * N + ahead];
  const int64_t nv = n_valid[p];
  if (b0 >= nv) {  // padding only: outside for every query
    if (owns)
      for (int qq = 0; qq < nq; ++qq) mrow[qq * q_stride] = 0;
    return;
  }
  for (int j = t; j < nq * C; j += kThreads) {
    const int qq = j / C, c = j - qq * C;
    start_s[qq * kStride + c] = starts[(int64_t)q0 * C + j];
    end_s[qq * kStride + c] = ends[(int64_t)q0 * C + j];
  }
  if (t < nq) {
    read_rev_s[t] = read_revs[q0 + t];
    unbounded_s[t] = unbounded[q0 + t];
  }
  // the valid rows end inside the block: its last row read is nv - 1
  if (t >= 32 && t < 32 + C && ahead >= nv)
    edge = kp[(int64_t)(t - 32) * N + nv - 1];
  if (t < C)
    edge_s[0][t] = edge;
  else if (t >= 32 && t < 32 + C)
    edge_s[1][t - 32] = edge;
  __syncthreads();

  if (t < 32) {  // warp 0 classifies the block, lane qq for query q0 + qq
    bool in_q = false, st_q = false;
    if (t < nq) {
      const int32_t* s = start_s + t * kStride;
      const int32_t* e = end_s + t * kStride;
      const bool unb = unbounded_s[t] != 0;
      const bool outside = lex_less_shared(edge_s[1], s, C) ||
                           (!unb && !lex_less_shared(edge_s[0], e, C));
      in_q = !outside && !lex_less_shared(edge_s[0], s, C) &&
             (unb || lex_less_shared(edge_s[1], e, C));
      st_q = !outside && !in_q;
    }
    const uint32_t in_bits = __ballot_sync(0xffffffffu, in_q);
    const uint32_t st_bits = __ballot_sync(0xffffffffu, st_q);
    if (t == 0) {
      inside_s = in_bits;
      straddle_s = st_bits;
    }
  }
  __syncthreads();
  const uint32_t inside = inside_s, straddle = straddle_s;
  const uint32_t live = inside | straddle;
  if (live == 0) {  // outside for every query: no row column is read
    if (owns)
      for (int qq = 0; qq < nq; ++qq) mrow[qq * q_stride] = 0;
    return;
  }

  uint32_t cand = 0;       // bit qq: row i is a candidate for query q0 + qq
  bool same_next = false;  // row i + 1 is valid and holds the same key
  bool dead = false;       // row i is a tombstone
  if (i < nv) {
    const int32_t* key = kp + i;
    const int64_t rev = revs[(int64_t)p * N + i];
    dead = tomb[(int64_t)p * N + i] != 0;
    if (t < kRowsPerBlock && i + 1 < nv) {
      int32_t diff = 0;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) diff |= key[(int64_t)c * N] ^ key[(int64_t)c * N + 1];
      same_next = diff == 0;
    }
    uint32_t in_range = inside;
    for (uint32_t m = straddle; m; m &= m - 1) {
      const int qq = __ffs(m) - 1;
      if (!lex_less_row<CMAX>(key, N, start_s + qq * kStride, C) &&
          (unbounded_s[qq] != 0 ||
           lex_less_row<CMAX>(key, N, end_s + qq * kStride, C)))
        in_range |= 1u << qq;
    }
    for (uint32_t m = in_range; m; m &= m - 1) {
      const int qq = __ffs(m) - 1;
      if (rev <= read_rev_s[qq]) cand |= 1u << qq;
    }
  }
  cand_s[t] = cand;
  __syncthreads();

  uint32_t vis = 0;
  if (owns) {
    const uint32_t next = cand_s[t + 1];
    vis = dead ? 0u : (cand & ~(same_next ? next : 0u));
    for (int qq = 0; qq < nq; ++qq)
      mrow[qq * q_stride] = (uint8_t)((vis >> qq) & 1u);
  }
  const int lane = t & 31;
  for (uint32_t m = live; m; m &= m - 1) {
    const int qq = __ffs(m) - 1;
    const unsigned b = __ballot_sync(0xffffffffu, (vis >> qq) & 1u);
    if (lane == 0 && b) atomicAdd(&counts[(int64_t)(q0 + qq) * P + p], __popc(b));
  }
}

template <int CMAX>
void start_kernel(dim3 grid, cudaStream_t stream, const void* keys,
                  const void* revs, const void* tomb, const void* n_valid,
                  const void* starts, const void* ends, const void* unbounded,
                  const void* read_revs, int P, int C, int N, int Q, void* mask,
                  void* counts) {
  visibility_kernel<CMAX><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)keys, (const int64_t*)revs, (const int8_t*)tomb,
      (const int32_t*)n_valid, (const int32_t*)starts, (const int32_t*)ends,
      (const int32_t*)unbounded, (const int64_t*)read_revs, P, C, N, Q,
      (uint8_t*)mask, (int32_t*)counts);
}

int launch(const void* keys, const void* revs, const void* tomb,
           const void* n_valid, const void* starts, const void* ends,
           const void* unbounded, const void* read_revs, int P, int C, int N,
           int Q, void* mask, void* counts, void* stream) {
  if (C < 0 || C > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (P <= 0 || N <= 0 || Q <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((N + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)P, (unsigned)((Q + kQueries - 1) / kQueries));
  if (C <= 8)
    start_kernel<8>(grid, (cudaStream_t)stream, keys, revs, tomb, n_valid,
                    starts, ends, unbounded, read_revs, P, C, N, Q, mask,
                    counts);
  else
    start_kernel<kMaxChunks>(grid, (cudaStream_t)stream, keys, revs, tomb,
                             n_valid, starts, ends, unbounded, read_revs, P, C,
                             N, Q, mask, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: one query. mask uint8[P, N], counts int32[P].
extern "C" int kb_scan_mask(const void* keys, const void* revs,
                            const void* tomb, const void* n_valid,
                            const void* start, const void* end,
                            const void* unbounded, const void* read_rev, int P,
                            int C, int N, void* mask, void* counts,
                            void* stream) {
  return launch(keys, revs, tomb, n_valid, start, end, unbounded, read_rev, P,
                C, N, 1, mask, counts, stream);
}

// K2: Q queries in one launch. mask uint8[Q, P, N], counts int32[Q, P].
extern "C" int kb_scan_mask_q(const void* keys, const void* revs,
                              const void* tomb, const void* n_valid,
                              const void* starts, const void* ends,
                              const void* unbounded, const void* read_revs,
                              int P, int C, int N, int Q, void* mask,
                              void* counts, void* stream) {
  return launch(keys, revs, tomb, n_valid, starts, ends, unbounded, read_revs,
                P, C, N, Q, mask, counts, stream);
}
