// MVCC visibility scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas kernels of kubebrain_tpu/ops/scan_pallas.py:
//   K1 scan_mask_pallas   (:175, body _kernel :134 / _tile_visibility :82)
//   K2 scan_mask_pallas_q (:222, body _kernel_q :150)
// Both run one body here, visibility_kernel<QMAX>: K1 is QMAX = 1, K2 packs
// up to 32 queries per block in the bits of one register.
//
// Per query q and row i of partition p (rows sorted by key, then revision;
// no partition splits a key's version chain):
//   cand[i]    = i < n_valid[p] && start_q <= key[i]
//                && (unbounded_q || key[i] < end_q) && rev[i] <= read_rev_q
//   visible[i] = cand[i] && !(key[i] == key[i+1] && cand[i+1]) && !tomb[i]
//
// Layout (built once per mirror publish):
//   keys  int32[P, C, N]  chunk-major; big-endian uint32 chunks with the
//                         sign bit flipped, so a signed compare is unsigned
//                         byte order. C is a run-time value (6 for encoded
//                         kube keys, 32 for raw 128-byte keys).
//   revs  int64[P, N]     one column: Hopper has native 64-bit integers, so
//                         the TPU's 31-bit hi/lo split is gone.
//   tomb  int8[P, N];  n_valid int32[P]
// Outputs: mask uint8[Q, P, N] (0/1, read as torch.bool); counts int32[Q, P],
// zeroed by the caller.
//
// Design. One thread per row, grid (ceil(N / 255), P, ceil(Q / QMAX)). The
// TPU kernel walked tiles in reverse and carried the next tile's first key
// and candidate flag across grid steps; blocks here run in no order, so
// instead each block of 256 threads covers 256 consecutive rows but owns only
// the first 255: the last thread computes the candidate bits of the next
// block's first row, and row i reads row i+1's bits from shared memory.
// Row i+1's key chunks are read straight from global memory (an L1 hit: the
// neighbouring thread loaded them). Rows at or past n_valid[p] are never
// candidates, so the last valid row never sees a neighbour.
// Each key chunk is read once per row and compared against every query's
// bounds before the next chunk is loaded; per-query compare state lives in
// four 32-bit registers (decided / less-than, for start and end).
// Counts come from the same launch: a warp ballot per query, __popc, one
// integer atomicAdd per warp — exact and independent of order.
//
// Bound: memory. Each launch reads 4·C + 8 + 1 bytes per row (keys,
// revision, tombstone) and writes Q mask bytes per row; the bound is those
// bytes over 3.35 TB/s. Compare work is 2·Q·C integer compares per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads - 1;

template <int QMAX>
__global__ void __launch_bounds__(kThreads) visibility_kernel(
    const int32_t* __restrict__ keys, const int64_t* __restrict__ revs,
    const int8_t* __restrict__ tomb, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ unbounded, const int64_t* __restrict__ read_revs,
    int P, int C, int N, int Q, uint8_t* __restrict__ mask,
    int32_t* __restrict__ counts) {
  __shared__ uint32_t cand_s[kThreads];
  const int t = threadIdx.x;
  const int p = blockIdx.y;
  const int q0 = blockIdx.z * QMAX;
  const int nq = min(QMAX, Q - q0);
  const int64_t i = (int64_t)blockIdx.x * kRowsPerBlock + t;
  const int64_t nv = n_valid[p];
  const int32_t* kp = keys + (int64_t)p * C * N;

  uint32_t cand = 0;      // bit qq: row i is a candidate for query q0 + qq
  bool same_next = false; // row i + 1 is valid and holds the same key
  bool dead = false;      // row i is a tombstone
  if (i < nv) {
    uint32_t dec_s = 0, lt_s = 0, dec_e = 0, lt_e = 0;
    same_next = i + 1 < nv;
    for (int c = 0; c < C; ++c) {
      const int32_t k = kp[(int64_t)c * N + i];
      if (same_next) same_next = (k == kp[(int64_t)c * N + i + 1]);
      for (int qq = 0; qq < nq; ++qq) {
        const uint32_t bit = 1u << qq;
        const int32_t s = starts[(int64_t)(q0 + qq) * C + c];
        const int32_t e = ends[(int64_t)(q0 + qq) * C + c];
        if (!(dec_s & bit) && k != s) {
          dec_s |= bit;
          if (k < s) lt_s |= bit;
        }
        if (!(dec_e & bit) && k != e) {
          dec_e |= bit;
          if (k < e) lt_e |= bit;
        }
      }
    }
    const int64_t rev = revs[(int64_t)p * N + i];
    for (int qq = 0; qq < nq; ++qq) {
      const uint32_t bit = 1u << qq;
      const bool in_range =
          !(lt_s & bit) && (unbounded[q0 + qq] != 0 || (lt_e & bit));
      if (in_range && rev <= read_revs[q0 + qq]) cand |= bit;
    }
    dead = tomb[(int64_t)p * N + i] != 0;
  }
  cand_s[t] = cand;
  __syncthreads();

  uint32_t vis = 0;
  if (t < kRowsPerBlock && i < N) {
    const uint32_t next = cand_s[t + 1];
    vis = dead ? 0u : (cand & ~(same_next ? next : 0u));
    for (int qq = 0; qq < nq; ++qq)
      mask[((int64_t)(q0 + qq) * P + p) * N + i] = (uint8_t)((vis >> qq) & 1u);
  }
  const int lane = t & 31;
  for (int qq = 0; qq < nq; ++qq) {
    const unsigned b = __ballot_sync(0xffffffffu, (vis >> qq) & 1u);
    if (lane == 0 && b) atomicAdd(&counts[(int64_t)(q0 + qq) * P + p], __popc(b));
  }
}

template <int QMAX>
int launch(const void* keys, const void* revs, const void* tomb,
           const void* n_valid, const void* starts, const void* ends,
           const void* unbounded, const void* read_revs, int P, int C, int N,
           int Q, void* mask, void* counts, void* stream) {
  if (P <= 0 || N <= 0 || Q <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((N + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)P, (unsigned)((Q + QMAX - 1) / QMAX));
  visibility_kernel<QMAX><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int64_t*)revs, (const int8_t*)tomb,
      (const int32_t*)n_valid, (const int32_t*)starts, (const int32_t*)ends,
      (const int32_t*)unbounded, (const int64_t*)read_revs, P, C, N, Q,
      (uint8_t*)mask, (int32_t*)counts);
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
  return launch<1>(keys, revs, tomb, n_valid, start, end, unbounded, read_rev,
                   P, C, N, 1, mask, counts, stream);
}

// K2: Q queries in one launch. mask uint8[Q, P, N], counts int32[Q, P].
extern "C" int kb_scan_mask_q(const void* keys, const void* revs,
                              const void* tomb, const void* n_valid,
                              const void* starts, const void* ends,
                              const void* unbounded, const void* read_revs,
                              int P, int C, int N, int Q, void* mask,
                              void* counts, void* stream) {
  return launch<32>(keys, revs, tomb, n_valid, starts, ends, unbounded,
                    read_revs, P, C, N, Q, mask, counts, stream);
}
