// P4 sort_join: one sort-probe join level of an MPP chain, unique or
// duplicate build keys.
//
// Replaces the non-LUT level of tidb_tpu/parallel/mpp.py:1546-1653
// (join_stage inside MPPEngine._build_program) with pack_keys :1451-1463.
// At n_dev 1 the reference's hash exchange (:1465) is the identity, so
// the level is:
//
//   tt_sj_pack    each side's packed key: sum over the key columns of
//                 (d - lo) * stride in int64 wrap, truncated to int32 (and
//                 sign-extended back) where the level says key_i32; the key
//                 validity; on the build side also bvalid = bmask & kv and
//                 the sort operand where(bvalid, key, key_max)
//   (K8)          kernels/lex_sort orders the operand, stable as
//                 jnp.argsort: equal keys keep their row order, which
//                 decides the order of a duplicate key's output slots
//   tt_sj_sorted  sk = operand[order], sv = bvalid[order]
//
// unique build keys (mult 1), one thread per probe row i:
//   tt_sj_probe1  pos = clip(search_lo(sk, pkey), 0, B - 1)
//                 match = pmask & pkv & sv[pos] & (sk[pos] == pkey)
//                 bsel = order[pos]; build lanes (d[bsel], v[bsel] & match);
//                 rowid = match ? brow[bsel] : -1; mask = match (a left
//                 join: pmask); the probe side's row ids copied beside them
//                 when the level writes rows of the packed result
//
// duplicate build keys (mult > 1), the compact cumsum-offset layout:
//   tt_sj_count   left = search_lo(sk, pkey); hit = left < B &
//                 sk[left] == pkey; cnt = pvalid & hit ? run length :
//                 0 (a left join: at least pmask); the run length is
//                 the upper bound - left, the run at `left` (the reference
//                 takes it from cummax run bounds)
//   tt_sj_scan    opos = exclusive scan of cnt (tile sums, one block
//                 scanning them, then each tile's CUB BlockScan), total,
//                 and dropped = max(total - cap, 0)
//   tt_sj_expand  a probe row writes its own cnt slots j = opos + s
//                 (s < cnt, j < cap): bpos = clip(left + s, 0, B - 1),
//                 match = matched & pvalid & sv[bpos] & sk[bpos] == pkey,
//                 the probe lanes and row ids of the row, the build lanes
//                 of order[bpos]; no search over opos is needed. A slot at
//                 or past `total` is owned by no row: there the reference's
//                 searchsorted names the last probe row, so the slot takes
//                 that row's lanes and order[clip(left + j - opos, ...)]'s
//                 build lanes, every validity false, mask 0, row ids -1
//
// Bound: bytes. Each probe row and build row is read a few times (the
// pack, the sort, the searches: log2(B) dependent loads of sk per probe
// row, from L2 for the build sides of TPC-H at 4M lineitem rows); every
// output slot is written once. A skewed key (one probe row owning many
// slots) serialises on its thread: load balance is left for a later
// change.
//
// Plain C interface (nvcc + ctypes): kernels/sort_join.py packs each
// call's arguments into one int64 word array; every launch goes on the
// given stream, never synchronizes, and the function returns the
// cudaError_t of its launches (0 = success) or -1 for an argument it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int MAXK = 4;   // key columns of one level
constexpr int MAXG = 32;  // lanes of one side
constexpr int MAXR = 8;   // row-id lanes
constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;

struct Words {
  const int64_t* w;
  int n;
  int at;
  int64_t operator()() { return at < n ? w[at++] : (at++, 0); }
  bool done() const { return at == n; }
};

unsigned grid_for(ll n, int n_sms) {
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ ll search_lo(const ll* __restrict__ sk, ll B, ll key) {
  ll lo = 0, hi = B;
  while (lo < hi) {
    const ll mid = lo + ((hi - lo) >> 1);
    if (sk[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ ll search_hi(const ll* __restrict__ sk, ll B, ll key) {
  ll lo = 0, hi = B;
  while (lo < hi) {
    const ll mid = lo + ((hi - lo) >> 1);
    if (sk[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------- pack

struct PackP {
  ll n;
  int nk, key_i32;
  ll key_max;
  const ll* d[MAXK];
  const uint8_t* v[MAXK];
  ll lo[MAXK], st[MAXK];
  const uint8_t* mask;  // build side: bmask; probe side: null
  ll* key;
  uint8_t* kv;
  ll* sop;  // build side: the sort operand; probe side: null
};

__global__ void pack_kernel(const PackP p) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += (ll)gridDim.x * blockDim.x) {
    ull acc = 0;
    bool ok = true;
    for (int k = 0; k < p.nk; ++k) {
      acc += ((ull)p.d[k][i] - (ull)p.lo[k]) * (ull)p.st[k];
      ok = ok && p.v[k][i] != 0;
    }
    const ll key = p.key_i32 ? (ll)(int32_t)(uint32_t)acc : (ll)acc;
    if (p.mask != nullptr) ok = ok && p.mask[i] != 0;
    p.key[i] = key;
    p.kv[i] = (uint8_t)ok;
    if (p.sop != nullptr) p.sop[i] = ok ? key : p.key_max;
  }
}

__global__ void sorted_kernel(ll B, const ll* __restrict__ sop, const uint8_t* __restrict__ bvalid,
                              const int* __restrict__ order, ll* sk, uint8_t* sv) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < B; i += (ll)gridDim.x * blockDim.x) {
    const ll o = order[i];
    sk[i] = sop[o];
    sv[i] = bvalid[o];
  }
}

// ----------------------------------------------------- the level's probe

struct Head {
  ll n, B;
  int ng, left, match_i64;
  const ll* pkey;
  const uint8_t* pkv;
  const uint8_t* pmask;
  const ll* sk;
  const uint8_t* sv;
  const int* order;
  const ll* brow;
};

struct Lanes {
  const ll* d[MAXG];
  const uint8_t* v[MAXG];
  ll* od[MAXG];
  uint8_t* ov[MAXG];
};

struct Probe1P {
  Head h;
  int nc;
  Lanes g;
  void* mask_out;
  ll* rowid_out;
  const ll* cs[MAXR];
  ll* cd[MAXR];
};

__device__ __forceinline__ void put_mask(void* out, int i64, ll j, bool m) {
  if (i64) ((ll*)out)[j] = m ? 1 : 0;
  else ((uint8_t*)out)[j] = (uint8_t)m;
}

__global__ void probe1_kernel(const Probe1P p) {
  const Head& h = p.h;
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < h.n; i += (ll)gridDim.x * blockDim.x) {
    const ll key = h.pkey[i];
    ll pos = search_lo(h.sk, h.B, key);
    if (pos > h.B - 1) pos = h.B - 1;
    const bool match = h.pmask[i] != 0 && h.pkv[i] != 0 && h.sv[pos] != 0 && h.sk[pos] == key;
    const ll bsel = h.order[pos];
    for (int g = 0; g < h.ng; ++g) {
      p.g.od[g][i] = p.g.d[g][bsel];
      p.g.ov[g][i] = (uint8_t)(match && p.g.v[g][bsel] != 0);
    }
    p.rowid_out[i] = match ? h.brow[bsel] : -1;
    put_mask(p.mask_out, h.match_i64, i, h.left ? h.pmask[i] != 0 : match);
    for (int c = 0; c < p.nc; ++c) p.cd[c][i] = p.cs[c][i];
  }
}

__global__ void count_kernel(ll n, ll B, int left, const ll* __restrict__ pkey, const uint8_t* __restrict__ pkv,
                             const uint8_t* __restrict__ pmask, const ll* __restrict__ sk, int* cnt, ll* lft,
                             uint8_t* hit) {
  for (ll r = (ll)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += (ll)gridDim.x * blockDim.x) {
    const ll key = pkey[r];
    const ll lb = search_lo(sk, B, key);
    const ll lc = lb < B - 1 ? lb : B - 1;
    const bool h = lb < B && sk[lc] == key;
    const bool pvalid = pmask[r] != 0 && pkv[r] != 0;
    int c = (pvalid && h) ? (int)(search_hi(sk, B, key) - lb) : 0;
    if (left && pmask[r] != 0 && c < 1) c = 1;
    cnt[r] = c;
    lft[r] = lb;
    hit[r] = (uint8_t)(pvalid && h);
  }
}

// ------------------------------------------------------------------ scan

__global__ void tile_sum_kernel(ll n, const int* __restrict__ cnt, ll* tsum) {
  typedef cub::BlockReduce<ll, BLOCK> R;
  __shared__ typename R::TempStorage tmp;
  const ll t0 = (ll)blockIdx.x * TILE;
  ll s = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    if (i < n) s += cnt[i];
  }
  const ll tot = R(tmp).Sum(s);
  if (threadIdx.x == 0) tsum[blockIdx.x] = tot;
}

// one block: exclusive offsets of the tiles, then total and dropped
__global__ void tile_scan_kernel(ll ntiles, ll cap, const ll* __restrict__ tsum, ll* toff, ll* scal) {
  typedef cub::BlockScan<ll, BLOCK> S;
  __shared__ typename S::TempStorage tmp;
  __shared__ ll carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (ll base = 0; base < ntiles; base += TILE) {
    ll items[ITEMS];
    for (int j = 0; j < ITEMS; ++j) {
      const ll t = base + threadIdx.x * ITEMS + j;
      items[j] = t < ntiles ? tsum[t] : 0;
    }
    ll agg;
    S(tmp).ExclusiveSum(items, items, agg);
    const ll c = carry;
    for (int j = 0; j < ITEMS; ++j) {
      const ll t = base + threadIdx.x * ITEMS + j;
      if (t < ntiles) toff[t] = c + items[j];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry = c + agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    scal[0] = carry;
    scal[1] = carry > cap ? carry - cap : 0;
  }
}

__global__ void tile_offsets_kernel(ll n, const int* __restrict__ cnt, const ll* __restrict__ toff, ll* opos) {
  typedef cub::BlockScan<ll, BLOCK> S;
  __shared__ typename S::TempStorage tmp;
  const ll t0 = (ll)blockIdx.x * TILE;
  ll items[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    items[j] = i < n ? cnt[i] : 0;
  }
  S(tmp).ExclusiveSum(items, items);
  const ll off = toff[blockIdx.x];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    if (i < n) opos[i] = off + items[j];
  }
}

// ---------------------------------------------------------------- expand

struct ExpandP {
  Head h;
  int np, nr;
  ll cap;
  const int* cnt;
  const ll* opos;
  const ll* lft;
  const uint8_t* hit;
  const ll* scal;  // total, dropped
  Lanes g;         // build lanes, by order[bpos]
  Lanes pl;        // probe lanes, by the slot's probe row
  const ll* rs[MAXR];
  ll* rd[MAXR];
  void* mask_out;
  ll* rowid_out;
};

__global__ void expand_kernel(const ExpandP p) {
  const Head& h = p.h;
  const ll stride = (ll)gridDim.x * blockDim.x;
  const ll tid = (ll)blockIdx.x * blockDim.x + threadIdx.x;
  for (ll r = tid; r < h.n; r += stride) {
    const int c = p.cnt[r];
    if (c == 0) continue;
    const ll o = p.opos[r];
    const bool pvalid = h.pmask[r] != 0 && h.pkv[r] != 0;
    const bool matched = h.left ? p.hit[r] != 0 : true;
    const ll key = h.pkey[r];
    for (int s = 0; s < c; ++s) {
      const ll j = o + s;
      if (j >= p.cap) break;
      ll bpos = p.lft[r] + s;
      bpos = bpos < 0 ? 0 : (bpos > h.B - 1 ? h.B - 1 : bpos);
      const bool match = matched && pvalid && h.sv[bpos] != 0 && h.sk[bpos] == key;
      const ll bsel = h.order[bpos];
      for (int g = 0; g < h.ng; ++g) {
        p.g.od[g][j] = p.g.d[g][bsel];
        p.g.ov[g][j] = (uint8_t)(match && p.g.v[g][bsel] != 0);
      }
      for (int q = 0; q < p.np; ++q) {
        p.pl.od[q][j] = p.pl.d[q][r];
        p.pl.ov[q][j] = p.pl.v[q][r];
      }
      for (int q = 0; q < p.nr; ++q) p.rd[q][j] = p.rs[q][r];
      p.rowid_out[j] = match ? h.brow[bsel] : -1;
      put_mask(p.mask_out, h.match_i64, j, h.left ? h.pmask[r] != 0 : match);
    }
  }
  // the slots past `total`: the last probe row as the reference's source
  const ll total = p.scal[0];
  const ll last = h.n - 1;
  for (ll j = (total > 0 ? total : 0) + tid; j < p.cap; j += stride) {
    ll bpos = p.lft[last] + (j - p.opos[last]);
    bpos = bpos < 0 ? 0 : (bpos > h.B - 1 ? h.B - 1 : bpos);
    const ll bsel = h.order[bpos];
    for (int g = 0; g < h.ng; ++g) {
      p.g.od[g][j] = p.g.d[g][bsel];
      p.g.ov[g][j] = 0;
    }
    for (int q = 0; q < p.np; ++q) {
      p.pl.od[q][j] = p.pl.d[q][last];
      p.pl.ov[q][j] = 0;
    }
    for (int q = 0; q < p.nr; ++q) p.rd[q][j] = -1;
    p.rowid_out[j] = -1;
    put_mask(p.mask_out, h.match_i64, j, false);
  }
}

void take_head(Words& t, Head& h) {
  h.n = t();
  h.B = t();
  h.ng = (int)t();
  h.left = (int)t();
  h.match_i64 = (int)t();
  h.pkey = (const ll*)t();
  h.pkv = (const uint8_t*)t();
  h.pmask = (const uint8_t*)t();
  h.sk = (const ll*)t();
  h.sv = (const uint8_t*)t();
  h.order = (const int*)t();
  h.brow = (const ll*)t();
}

bool head_ok(const Head& h) { return h.n >= 1 && h.B >= 1 && h.ng >= 0 && h.ng <= MAXG; }

void take_lanes(Words& t, Lanes& L, int k) {
  for (int g = 0; g < k; ++g) {
    L.d[g] = (const ll*)t();
    L.v[g] = (const uint8_t*)t();
    L.od[g] = (ll*)t();
    L.ov[g] = (uint8_t*)t();
  }
}

}  // namespace

// words: m, nkeys, key_i32, key_max, per key (d, v, lo, stride), mask, key, kv, sop
extern "C" int tt_sj_pack(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  PackP p;
  p.n = t();
  p.nk = (int)t();
  p.key_i32 = (int)t();
  p.key_max = t();
  if (p.n < 1 || p.nk < 1 || p.nk > MAXK) return -1;
  for (int k = 0; k < p.nk; ++k) {
    p.d[k] = (const ll*)t();
    p.v[k] = (const uint8_t*)t();
    p.lo[k] = t();
    p.st[k] = t();
  }
  p.mask = (const uint8_t*)t();
  p.key = (ll*)t();
  p.kv = (uint8_t*)t();
  p.sop = (ll*)t();
  if (!t.done()) return -1;
  pack_kernel<<<grid_for(p.n, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// words: B, sop, bvalid, order, sk, sv
extern "C" int tt_sj_sorted(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 6 || w[0] < 1) return -1;
  sorted_kernel<<<grid_for(w[0], n_sms), BLOCK, 0, (cudaStream_t)stream>>>(
      w[0], (const ll*)w[1], (const uint8_t*)w[2], (const int*)w[3], (ll*)w[4], (uint8_t*)w[5]);
  return (int)cudaGetLastError();
}

// words: head, ncopies, per build lane (d, v, od, ov), mask_out, rowid_out, per copy (src, dst)
extern "C" int tt_sj_probe1(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  Probe1P p;
  take_head(t, p.h);
  p.nc = (int)t();
  if (!head_ok(p.h) || p.nc < 0 || p.nc > MAXR) return -1;
  take_lanes(t, p.g, p.h.ng);
  p.mask_out = (void*)t();
  p.rowid_out = (ll*)t();
  for (int c = 0; c < p.nc; ++c) {
    p.cs[c] = (const ll*)t();
    p.cd[c] = (ll*)t();
  }
  if (!t.done()) return -1;
  probe1_kernel<<<grid_for(p.h.n, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// words: n, B, left, pkey, pkv, pmask, sk, cnt, lft, hit
extern "C" int tt_sj_count(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 10 || w[0] < 1 || w[1] < 1) return -1;
  count_kernel<<<grid_for(w[0], n_sms), BLOCK, 0, (cudaStream_t)stream>>>(
      w[0], w[1], (int)w[2], (const ll*)w[3], (const uint8_t*)w[4], (const uint8_t*)w[5], (const ll*)w[6],
      (int*)w[7], (ll*)w[8], (uint8_t*)w[9]);
  return (int)cudaGetLastError();
}

extern "C" int64_t tt_sj_scan_scratch(int64_t n) { return 2 * ((n + TILE - 1) / TILE) + 1; }

// words: n, cap, cnt, opos, scal (total, dropped), scratch
extern "C" int tt_sj_scan(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  if (nwords != 6 || w[0] < 1) return -1;
  const ll n = w[0], cap = w[1];
  const int* cnt = (const int*)w[2];
  ll* opos = (ll*)w[3];
  ll* scal = (ll*)w[4];
  ll* scratch = (ll*)w[5];
  const ll nt = (n + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  tile_sum_kernel<<<(unsigned)nt, BLOCK, 0, s>>>(n, cnt, scratch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  tile_scan_kernel<<<1, BLOCK, 0, s>>>(nt, cap, scratch, scratch + nt, scal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  tile_offsets_kernel<<<(unsigned)nt, BLOCK, 0, s>>>(n, cnt, scratch + nt, opos);
  return (int)cudaGetLastError();
}

// words: head, np, nr, cap, cnt, opos, lft, hit, scal,
//        per build lane (d, v, od, ov), per probe lane (d, v, od, ov),
//        per row-id lane (src, dst), mask_out, rowid_out
extern "C" int tt_sj_expand(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  ExpandP p;
  take_head(t, p.h);
  p.np = (int)t();
  p.nr = (int)t();
  p.cap = t();
  if (!head_ok(p.h) || p.np < 0 || p.np > MAXG || p.nr < 0 || p.nr > MAXR || p.cap < 1) return -1;
  p.cnt = (const int*)t();
  p.opos = (const ll*)t();
  p.lft = (const ll*)t();
  p.hit = (const uint8_t*)t();
  p.scal = (const ll*)t();
  take_lanes(t, p.g, p.h.ng);
  take_lanes(t, p.pl, p.np);
  for (int q = 0; q < p.nr; ++q) {
    p.rs[q] = (const ll*)t();
    p.rd[q] = (ll*)t();
  }
  p.mask_out = (void*)t();
  p.rowid_out = (ll*)t();
  if (!t.done()) return -1;
  const ll work = p.h.n > p.cap ? p.h.n : p.cap;
  expand_kernel<<<grid_for(work, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
