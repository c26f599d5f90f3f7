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
// The reference's own argument: the kk best entries lie in the kk chunks
// of 1024 positions whose maxima are best, and every one of them is at
// least as good as the kk-th best chunk maximum T (the kk chunk maxima
// are kk entries no worse than T). Two launches, no host read:
//
//   maxima_kernel  each warp streams whole chunks with 16-byte loads and
//                  reduces each to its best (u, position) with shuffles —
//                  no sort — writing nb (u, position) pairs. The last
//                  block to finish (an atomic ticket after __threadfence)
//                  radix-selects the kq = min(kk, nb) best maxima, and
//                  writes their chunks in ascending order and T (no cut
//                  when nb < kk)
//   pick_kernel    one block per picked chunk (still in L2 from the first
//                  launch): its entries no worse than T, and of those its
//                  kk best by the same radix select, in position order.
//                  The last block merges the kq lists (position order,
//                  chunk after chunk), selects the kk best, sorts them in
//                  shared memory and writes, for pick t at position ti:
//   idx[t] = ti, vals[t] = score[ti],
//   tvalid = valid[ti] & score[ti] > floor   (floor: INT64_MIN or -inf;
//                                            a NaN pick is not valid)
//   row 0: tvalid ? gpos[ti] : -1, row 1: tvalid, row 2 + j: lane_j[ti]
// straight into the rows of the packed result.
//
// The radix select (8-bit digits from the top of u) keeps, at the digit
// that crosses kk, the first entries of that digit in list order; every
// list it runs over is in position order, so equal keys go by position.
// It stops once the entries sharing the chosen prefix are exactly those
// still needed.
//
// One int64 scratch buffer per call: the two tickets, T, the picked
// chunks, the candidate counts, the chunk maxima and the candidates. The
// kernels leave the tickets at zero (each last block resets its own), so
// the buffer is zeroed once, when it is allocated, and never by a memset
// launch before a call.
//
// Bound: bytes (the score lane read once, ≈ 10 µs for Q3's 4M scores);
// the selects are one block's work over nb maxima and kq * kk candidates.
//
// Plain C interface (nvcc + ctypes): kernels/block_topk.py calls
// tt_bt_run, which launches both kernels on the given stream, never
// synchronizes, and returns the cudaError_t of the launches (0 = success)
// or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int CHUNK = 1024;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 512;  // kk, and the bitonic sort of the final picks
constexpr int MAXLANES = 32;
constexpr ll NONE = 0x7fffffffffffffffLL;  // position of an empty entry

// scratch words (int64)
constexpr int W_TICKET1 = 0, W_TICKET2 = 1, W_TU = 2, W_TP = 3, W_HEAD = 4;

struct Layout {
  ll picked, counts, max_u, max_p, cand_u, cand_p, words;
  __host__ __device__ Layout(ll nb, int kk) {
    const ll kq = nb < kk ? nb : kk;
    picked = W_HEAD;
    counts = picked + kk;
    max_u = counts + kk;
    max_p = max_u + nb;
    cand_u = max_p + nb;
    cand_p = cand_u + kq * kk;
    words = cand_p + kq * kk;
  }
};

struct Emit {
  int nlanes;  // -1: no result rows
  const uint8_t* valid;
  const ll* gpos;
  const ull* lanes[MAXLANES];
  ll* rows[2 + MAXLANES];
  ll* idx;
  ull* vals;
};

__device__ __forceinline__ ull order_key(ull b, int is_float) {
  if (!is_float) return b ^ 0x8000000000000000ULL;
  const double x = __longlong_as_double((ll)b);
  if (x != x) return ~0ULL;
  const ull c = x == 0.0 ? 0ULL : b;  // -0.0 ties +0.0
  return (c >> 63) ? ~c : (c | 0x8000000000000000ULL);
}

__device__ __forceinline__ bool before(ull ua, ll pa, ull ub, ll pb) {
  return ua > ub || (ua == ub && pa < pb);
}

struct Entry {
  ull u;
  ll p;  // NONE: no entry
};

struct SelectSmem {
  typedef cub::BlockScan<int, THREADS> Scan;
  typename Scan::TempStorage scan;
  unsigned hist[256];
  int digit, above, eq;
};

// warp 0: the digit that crosses `need`, counting from the top bin down;
// writes s.digit, s.above (entries in higher bins) and s.eq (its count)
__device__ void crossing_digit(SelectSmem& s, int need) {
  const int lane = threadIdx.x;
  // lane l holds bins 255 - 8l down to 248 - 8l
  int c[8], sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = (int)s.hist[255 - 8 * lane - q];
    sum += c[q];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - sum;
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
  if (lane == __ffs(hit) - 1) {
    int acc = excl;
    for (int q = 0; q < 8; ++q) {
      if (acc + c[q] >= need) {
        s.digit = 255 - 8 * lane - q;
        s.above = acc;
        s.eq = c[q];
        break;
      }
      acc += c[q];
    }
  }
}

// The block's selection over a list of m entries (get(x) in position
// order; p == NONE or !keep(e) leaves an entry out): the k best of the
// kept entries (all of them when at most k are kept), compacted in list
// order into ou / op. Returns their number. Every thread calls it.
template <typename Get, typename Keep>
__device__ int block_select(Get get, Keep keep, ll m, int k, ull* ou, ll* op, SelectSmem& s) {
  const int t = threadIdx.x;
  // kept entries
  int mine = 0;
  for (ll x = t; x < m; x += THREADS) {
    const Entry e = get(x);
    mine += e.p != NONE && keep(e);
  }
  int agg;
  SelectSmem::Scan(s.scan).ExclusiveSum(mine, mine, agg);
  __syncthreads();
  ull prefix = 0, mask = 0;
  int need = agg < k ? agg : k;
  if (agg > k) {
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int d = t; d < 256; d += THREADS) s.hist[d] = 0u;
      __syncthreads();
      for (ll x = t; x < m; x += THREADS) {
        const Entry e = get(x);
        if (e.p != NONE && keep(e) && (e.u & mask) == prefix) atomicAdd(&s.hist[(e.u >> shift) & 0xFF], 1u);
      }
      __syncthreads();
      if (t < 32) crossing_digit(s, need);
      __syncthreads();
      need -= s.above;
      prefix |= (ull)s.digit << shift;
      mask |= 0xFFULL << shift;
      const bool done = s.eq == need;  // every entry of the prefix is taken
      __syncthreads();                  // s is rewritten by the next round
      if (done) break;
    }
  }
  // ordered compaction: entries above the prefix, and the first `need` of
  // those on it
  int taken = 0, eq_seen = 0;
  for (ll x0 = 0; x0 < m; x0 += THREADS) {
    const ll x = x0 + t;
    Entry e = {0ULL, NONE};
    if (x < m) e = get(x);
    const bool in = e.p != NONE && keep(e);
    const ull mu = e.u & mask;
    const int is_eq = in && mu == prefix;
    const int is_gt = in && mu > prefix;
    int eq_rank, eq_tot;
    SelectSmem::Scan(s.scan).ExclusiveSum(is_eq, eq_rank, eq_tot);
    __syncthreads();
    const int take = is_gt || (is_eq && eq_seen + eq_rank < need);
    int slot, tot;
    SelectSmem::Scan(s.scan).ExclusiveSum(take, slot, tot);
    __syncthreads();
    if (take) {
      ou[taken + slot] = e.u;
      op[taken + slot] = e.p;
    }
    taken += tot;
    eq_seen += eq_tot;
  }
  __syncthreads();
  return taken;
}

__device__ __forceinline__ ull ldu(const ll* p) { return (ull)__ldcg(p); }

__global__ void __launch_bounds__(THREADS) maxima_kernel(const ull* __restrict__ score, int is_float, ll n, ll nb,
                                                         int kk, ll* ws) {
  __shared__ SelectSmem s;
  __shared__ ull su[MAX_K];
  __shared__ ll sp[MAX_K];
  __shared__ int s_last;
  const Layout lay(nb, kk);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool vec = ((uintptr_t)score & 15) == 0;
  for (ll c = (ll)blockIdx.x * WARPS + w; c < nb; c += (ll)gridDim.x * WARPS) {
    ull bu = 0;
    ll bp = NONE;
    const ll base = c * CHUNK;
#pragma unroll 4
    for (int r = 0; r < CHUNK / 64; ++r) {  // 64 entries a round, two a lane
      const ll i = base + r * 64 + 2 * lane;
      ull b0 = 0, b1 = 0;
      if (vec && i + 1 < n) {
        const ulonglong2 x = __ldg((const ulonglong2*)(score + i));
        b0 = x.x;
        b1 = x.y;
      } else {
        if (i < n) b0 = score[i];
        if (i + 1 < n) b1 = score[i + 1];
      }
      if (i < n) {
        const ull u = order_key(b0, is_float);
        if (before(u, i, bu, bp)) bu = u, bp = i;
      }
      if (i + 1 < n) {
        const ull u = order_key(b1, is_float);
        if (before(u, i + 1, bu, bp)) bu = u, bp = i + 1;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const ull ou = __shfl_xor_sync(0xffffffffu, bu, o);
      const ll op = __shfl_xor_sync(0xffffffffu, bp, o);
      if (before(ou, op, bu, bp)) bu = ou, bp = op;
    }
    if (lane == 0) {
      ws[lay.max_u + c] = (ll)bu;
      ws[lay.max_p + c] = bp;
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd((unsigned*)&ws[W_TICKET1], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: the kq best chunk maxima, in chunk order
  const ll* mu = ws + lay.max_u;
  const ll* mp = ws + lay.max_p;
  auto get = [&](ll x) { return Entry{ldu(mu + x), __ldcg(mp + x)}; };
  auto all = [](const Entry&) { return true; };
  const int kq = (int)(nb < kk ? nb : kk);
  const int got = block_select(get, all, nb, kq, su, sp, s);
  for (int j = t; j < got; j += THREADS) ws[lay.picked + j] = sp[j] / CHUNK;
  if (t < 32) {  // T: the worst of them, when there are kk (else no cut)
    ull tu = ~0ULL;
    ll tp = -1;
    for (int j = t; j < got; j += 32) {
      if (before(tu, tp, su[j], sp[j])) tu = su[j], tp = sp[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const ull ou = __shfl_xor_sync(0xffffffffu, tu, o);
      const ll op = __shfl_xor_sync(0xffffffffu, tp, o);
      if (before(tu, tp, ou, op)) tu = ou, tp = op;
    }
    if (t == 0) {
      const bool cut = nb >= kk;
      ws[W_TU] = cut ? (ll)tu : 0;
      ws[W_TP] = cut ? tp : NONE;
      ws[W_TICKET1] = 0;
    }
  }
}

// bitonic sort of the first MAX_K entries of (su, sp), best first; one
// entry a thread of the first MAX_K threads
__device__ void sort_picks(ull* su, ll* sp) {
  const int t = threadIdx.x;
  for (int k = 2; k <= MAX_K; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = t ^ j;
      if (t < MAX_K && o > t) {
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

__global__ void __launch_bounds__(THREADS) pick_kernel(const ull* __restrict__ score, int is_float, ll n, ll nb,
                                                       int kk, ll* ws, const Emit e) {
  __shared__ SelectSmem s;
  __shared__ ull cu[CHUNK];
  __shared__ ull su[MAX_K];
  __shared__ ll sp[MAX_K];
  __shared__ int offs[MAX_K + 1];
  __shared__ int s_last;
  const Layout lay(nb, kk);
  const int t = threadIdx.x;
  const int kq = (int)(nb < kk ? nb : kk);
  const ull tu = (ull)ws[W_TU];
  const ll tp = ws[W_TP];
  // this block's chunk: its entries no worse than T, the kk best of them
  const ll base = ws[lay.picked + blockIdx.x] * CHUNK;
  for (int j = t; j < CHUNK; j += THREADS) {
    const ll i = base + j;
    cu[j] = i < n ? order_key(score[i], is_float) : 0ULL;
  }
  __syncthreads();
  auto get = [&](ll x) { return Entry{cu[x], base + x < n ? base + x : NONE}; };
  auto keep = [&](const Entry& x) { return !before(tu, tp, x.u, x.p); };
  const int got = block_select(get, keep, CHUNK, kk, su, sp, s);
  ll* out_u = ws + lay.cand_u + (ll)blockIdx.x * kk;
  ll* out_p = ws + lay.cand_p + (ll)blockIdx.x * kk;
  for (int j = t; j < got; j += THREADS) {
    out_u[j] = (ll)su[j];
    out_p[j] = sp[j];
  }
  if (t == 0) ws[lay.counts + blockIdx.x] = got;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd((unsigned*)&ws[W_TICKET2], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: the kq lists, chunk after chunk (ascending chunks, each
  // in position order), merged by one more select of the kk best
  int c = t < kq ? (int)__ldcg(ws + lay.counts + t) : 0, excl, total;
  SelectSmem::Scan(s.scan).ExclusiveSum(c, excl, total);
  if (t < kq) offs[t] = excl;
  if (t == 0) offs[kq] = total;
  __syncthreads();
  const ll* cand_u = ws + lay.cand_u;
  const ll* cand_p = ws + lay.cand_p;
  auto list = [&](ll x) {
    int lo = 0, hi = kq;  // the list b with offs[b] <= x < offs[b + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offs[mid] <= x) lo = mid;
      else hi = mid;
    }
    const ll at = (ll)lo * kk + (x - offs[lo]);
    return Entry{ldu(cand_u + at), __ldcg(cand_p + at)};
  };
  auto all = [](const Entry&) { return true; };
  const int picks = block_select(list, all, total, kk, su, sp, s);  // == kk: total >= kk <= n
  for (int j = picks + t; j < MAX_K; j += THREADS) {
    su[j] = 0ULL;
    sp[j] = NONE;
  }
  __syncthreads();
  sort_picks(su, sp);
  if (t == 0) ws[W_TICKET2] = 0;
  if (t >= kk) return;
  // every pick names a real position; clipped all the same
  const ll ti = sp[t] < 0 ? 0 : (sp[t] > n - 1 ? n - 1 : sp[t]);
  const ull sb = score[ti];
  e.idx[t] = ti;
  e.vals[t] = sb;
  if (e.nlanes < 0) return;
  bool above;
  if (is_float) {
    const double x = __longlong_as_double((ll)sb);
    above = x > -__longlong_as_double(0x7ff0000000000000LL);
  } else {
    above = (ll)sb != (ll)0x8000000000000000ULL;
  }
  const bool tvalid = e.valid[ti] != 0 && above;
  e.rows[0][t] = tvalid ? e.gpos[ti] : -1;
  e.rows[1][t] = tvalid ? 1 : 0;
  for (int j = 0; j < e.nlanes; ++j) e.rows[2 + j][t] = (ll)e.lanes[j][ti];
}

}  // namespace

// int64 words of the scratch buffer for n scores and kk picks
extern "C" int64_t tt_bt_scratch_words(int64_t n, int kk) {
  const ll nb = (n + CHUNK - 1) / CHUNK;
  return Layout(nb, kk).words;
}

// idx int64 [kk], vals [kk] (the score's 8-byte type). emit words (null:
// no result rows): nlanes, valid, gpos, per lane (src), per row (dst, 2 +
// nlanes of them). ws: tt_bt_scratch_words(n, kk) int64 words, its first
// two zero (as every call leaves them).
extern "C" int tt_bt_run(const void* score, int is_float, int64_t n, int kk, int64_t* ws, int64_t* idx, void* vals,
                         const int64_t* emit_words, int nwords, int n_sms, void* stream) {
  if (n < 1 || kk < 1 || kk > MAX_K || kk > n || ws == nullptr || idx == nullptr || vals == nullptr) return -1;
  Emit e = {};
  e.nlanes = -1;
  e.idx = (ll*)idx;
  e.vals = (ull*)vals;
  if (emit_words != nullptr) {
    int at = 0;
    e.nlanes = nwords > 0 ? (int)emit_words[at++] : -1;
    if (e.nlanes < 0 || e.nlanes > MAXLANES || nwords != 3 + e.nlanes + 2 + e.nlanes) return -1;
    e.valid = (const uint8_t*)emit_words[at++];
    e.gpos = (const ll*)emit_words[at++];
    for (int j = 0; j < e.nlanes; ++j) e.lanes[j] = (const ull*)emit_words[at++];
    for (int j = 0; j < 2 + e.nlanes; ++j) e.rows[j] = (ll*)emit_words[at++];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const ll nb = (n + CHUNK - 1) / CHUNK;
  ll grid = (nb + WARPS - 1) / WARPS;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 4;
  if (grid > cap) grid = cap;
  maxima_kernel<<<(unsigned)grid, THREADS, 0, s>>>((const ull*)score, is_float, n, nb, kk, (ll*)ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ll kq = nb < kk ? nb : kk;
  pick_kernel<<<(unsigned)kq, THREADS, 0, s>>>((const ull*)score, is_float, n, nb, kk, (ll*)ws, e);
  return (int)cudaGetLastError();
}
