// P9 block_topk: the exact top k of a long score lane, and the rows of
// the clustered aggregation's packed result.
//
// Replaces tidb_tpu/parallel/mpp.py:2008-2045 (_block_topk) and the tail
// of clustered_agg_stage (:1914-1929). The order is the reference's: score
// descending, equal scores by position ascending; every NaN counts as the
// largest score (jnp.argmax takes the first NaN) and -0.0 ties +0.0. Each
// score becomes a 64-bit key u whose unsigned order is that order
// (NaN → 2^64 - 1; a float's sign-magnitude bits folded to an unsigned
// order after -0.0 → +0.0; an int64 with its sign bit flipped), and an
// entry is (u, position); "better" is u larger, then position smaller.
//
//   select_kernel  one CUDA block per source block of 1024 positions (all
//                  of them, or those holding the positions a previous
//                  step picked): bitonic sort of its 1024 entries in
//                  shared memory, the first kk written out
//   merge_kernel   one CUDA block per 1024 entries of a candidate list:
//                  the same sort, the first kk out; the last call (one
//                  block) also writes the result rows
//
// The host runs: block maxima (select, kk = 1) → top kk blocks (merges) →
// top kk of each of those blocks (select) → top kk overall (merges). The
// k best entries lie in the k blocks with the best maxima, so this is
// exact. The last merge writes, for pick t at position ti:
//   idx[t] = ti, vals[t] = score[ti],
//   tvalid = valid[ti] & score[ti] > floor   (floor: INT64_MIN or -inf;
//                                            a NaN pick is not valid)
//   row 0: tvalid ? gpos[ti] : -1, row 1: tvalid, row 2 + j: lane_j[ti]
// straight into the rows of the packed result.
//
// Bound: bytes (the score lane read once); the sorts are shared-memory
// work, 55 compare-exchange steps a 1024-entry block.
//
// Plain C interface (nvcc + ctypes): kernels/block_topk.py drives the
// launches; each entry point launches on the given stream, never
// synchronizes and returns the cudaError_t of the launch (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLK = 1024;
constexpr int MAXLANES = 32;
constexpr ll NONE = 0x7fffffffffffffffLL;  // position of an empty entry

struct Emit {
  int nlanes;
  const uint8_t* valid;
  const ll* gpos;
  const ull* lanes[MAXLANES];
  ll* rows[2 + MAXLANES];
  ll* idx;
  ull* vals;
};

__device__ __forceinline__ ull order_key(const void* score, int is_float, ll i) {
  const ull b = ((const ull*)score)[i];
  if (!is_float) return b ^ 0x8000000000000000ULL;
  const double x = __longlong_as_double((ll)b);
  if (x != x) return ~0ULL;
  const ull c = x == 0.0 ? 0ULL : b;  // -0.0 ties +0.0
  return (c >> 63) ? ~c : (c | 0x8000000000000000ULL);
}

__device__ __forceinline__ bool before(ull ua, ll pa, ull ub, ll pb) {
  return ua > ub || (ua == ub && pa < pb);
}

// bitonic sort of BLK entries, best first; one entry per thread
__device__ void sort_block(ull* su, ll* sp) {
  const int t = threadIdx.x;
  for (int k = 2; k <= BLK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = t ^ j;
      if (o > t) {
        const bool up = (t & k) == 0;
        const bool swap = up ? before(su[o], sp[o], su[t], sp[t]) : before(su[t], sp[t], su[o], sp[o]);
        if (swap) {
          const ull u = su[t];
          su[t] = su[o];
          su[o] = u;
          const ll q = sp[t];
          sp[t] = sp[o];
          sp[o] = q;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void select_kernel(const void* score, int is_float, ll n, const ll* picked, int kk,
                              ull* out_u, ll* out_p) {
  __shared__ ull su[BLK];
  __shared__ ll sp[BLK];
  ll blk = blockIdx.x;
  if (picked != nullptr) {
    const ll q = picked[blockIdx.x];
    blk = q == NONE ? -1 : q / BLK;
  }
  const ll i = blk * BLK + threadIdx.x;
  if (blk >= 0 && i < n) {
    su[threadIdx.x] = order_key(score, is_float, i);
    sp[threadIdx.x] = i;
  } else {
    su[threadIdx.x] = 0;
    sp[threadIdx.x] = NONE;
  }
  __syncthreads();
  sort_block(su, sp);
  if (threadIdx.x < kk) {
    out_u[(ll)blockIdx.x * kk + threadIdx.x] = su[threadIdx.x];
    out_p[(ll)blockIdx.x * kk + threadIdx.x] = sp[threadIdx.x];
  }
}

__global__ void merge_kernel(const ull* in_u, const ll* in_p, ll m, int kk, ull* out_u, ll* out_p,
                             const void* score, int is_float, ll n, const Emit e, int emit) {
  __shared__ ull su[BLK];
  __shared__ ll sp[BLK];
  const ll i = (ll)blockIdx.x * BLK + threadIdx.x;
  if (i < m) {
    su[threadIdx.x] = in_u[i];
    sp[threadIdx.x] = in_p[i];
  } else {
    su[threadIdx.x] = 0;
    sp[threadIdx.x] = NONE;
  }
  __syncthreads();
  sort_block(su, sp);
  const int t = threadIdx.x;
  if (t >= kk) return;
  if (!emit) {
    out_u[(ll)blockIdx.x * kk + t] = su[t];
    out_p[(ll)blockIdx.x * kk + t] = sp[t];
    return;
  }
  // kk <= n, so every pick names a real position
  const ll ti = sp[t] < 0 ? 0 : (sp[t] > n - 1 ? n - 1 : sp[t]);
  const ull sb = ((const ull*)score)[ti];
  bool above;
  if (is_float) {
    const double x = __longlong_as_double((ll)sb);
    above = x > -__longlong_as_double(0x7ff0000000000000LL);
  } else {
    above = (ll)sb != (ll)0x8000000000000000ULL;
  }
  const bool tvalid = e.valid[ti] != 0 && above;
  e.idx[t] = ti;
  e.vals[t] = sb;
  e.rows[0][t] = tvalid ? e.gpos[ti] : -1;
  e.rows[1][t] = tvalid ? 1 : 0;
  for (int j = 0; j < e.nlanes; ++j) e.rows[2 + j][t] = (ll)e.lanes[j][ti];
}

}  // namespace

extern "C" int tt_bt_select(const void* score, int is_float, int64_t n, const int64_t* picked, int nblocks,
                            int kk, void* out_u, void* out_p, void* stream) {
  if (n < 1 || nblocks < 1 || kk < 1 || kk > BLK) return -1;
  select_kernel<<<(unsigned)nblocks, BLK, 0, (cudaStream_t)stream>>>(score, is_float, n, (const ll*)picked, kk,
                                                                     (ull*)out_u, (ll*)out_p);
  return (int)cudaGetLastError();
}

// emit words (emit != 0): nlanes, valid, gpos, per lane (src), per row (dst,
// 2 + nlanes of them), idx, vals
extern "C" int tt_bt_merge(const void* in_u, const void* in_p, int64_t m, int kk, void* out_u, void* out_p,
                           const void* score, int is_float, int64_t n, const int64_t* emit_words, int nwords,
                           void* stream) {
  if (m < 1 || kk < 1 || kk > BLK) return -1;
  const ll blocks = (m + BLK - 1) / BLK;
  Emit e = {};
  int emit = 0;
  if (emit_words != nullptr) {
    if (blocks != 1 || nwords < 3) return -1;
    int at = 0;
    e.nlanes = (int)emit_words[at++];
    if (e.nlanes < 0 || e.nlanes > MAXLANES || nwords != 3 + e.nlanes + 2 + e.nlanes + 2) return -1;
    e.valid = (const uint8_t*)emit_words[at++];
    e.gpos = (const ll*)emit_words[at++];
    for (int j = 0; j < e.nlanes; ++j) e.lanes[j] = (const ull*)emit_words[at++];
    for (int j = 0; j < 2 + e.nlanes; ++j) e.rows[j] = (ll*)emit_words[at++];
    e.idx = (ll*)emit_words[at++];
    e.vals = (ull*)emit_words[at++];
    emit = 1;
  }
  merge_kernel<<<(unsigned)blocks, BLK, 0, (cudaStream_t)stream>>>(
      (const ull*)in_u, (const ll*)in_p, m, kk, (ull*)out_u, (ll*)out_p, score, is_float, n, e, emit);
  return (int)cudaGetLastError();
}
