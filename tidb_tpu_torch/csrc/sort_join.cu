// P4 sort_join: one sort-probe join level of an MPP chain, unique or
// duplicate build keys.
//
// Replaces the non-LUT level of tidb_tpu/parallel/mpp.py:1546-1653
// (join_stage inside MPPEngine._build_program) with pack_keys :1451-1463.
// At n_dev 1 the reference's hash exchange (:1465) is the identity, so
// the level is:
//
//   tt_sj_pack    the build side's packed key: sum over the key columns of
//                 (d - lo) * stride in int64 wrap, truncated to int32 (and
//                 sign-extended back) where the level says key_i32;
//                 bvalid = bmask & key validity; the sort operand
//                 where(bvalid, key, key_max), fused with compact.cuh's
//                 compaction: the M rows whose operand is not key_max go to
//                 (comp, crow), the others' ids to tail, in row order; M
//                 and the OR/AND come up to the host in the call's one read
//   (K8)          kernels/lex_sort sorts comp[:M], stable as jnp.argsort:
//                 equal keys keep their row order, which decides the order
//                 of a duplicate key's output slots. The reference's sort
//                 of all B operands is that order followed by the tail
//   tt_sj_sorted  sk / sv / order over all B positions, STILE a block with
//                 its keys staged in shared memory (position i < M: comp,
//                 1 and crow at perm[i]; i >= M: key_max, bvalid and the
//                 tail's row), the directory (2^bits buckets of the
//                 range [sk[0], sk[M-1]], each holding the first position
//                 of its bucket, then M) and, at each run start of a
//                 duplicate level, the run's length (the next 8 positions
//                 at once, then a galloping search from the start; the
//                 tail's run at M is B - M)
//
// The probe key is packed inside the probe kernels. Its lower bound among
// the sorted keys (searchsorted left over all B positions) is 0 at or
// below sk[0], M above sk[M-1] (the tail holds key_max, which no packed
// key exceeds), and otherwise the first position at or above the key in
// its bucket's range [dir[b], dir[b + 1]): a short search.
//
// unique build keys (mult 1), one thread per probe row i:
//   tt_sj_probe1  pos = clip(lower bound, 0, B - 1)
//                 match = pmask & pkv & sv[pos] & (sk[pos] == pkey)
//                 bsel = order[pos]; build lanes (d[bsel], v[bsel] & match);
//                 rowid = match ? brow[bsel] : -1; mask = match (a left
//                 join: pmask); the probe side's row ids copied beside them
//                 when the level writes rows of the packed result
//
// duplicate build keys (mult > 1), the compact cumsum-offset layout:
//   tt_sj_count   per probe row (CITEMS a thread, their searches in
//                 flight together): left = lower bound; hit = left < B &
//                 sk[left] == pkey; cnt = pvalid & hit ? the run length at
//                 left (one load) : 0 (a left join: at least pmask); then
//                 an exclusive scan of cnt with decoupled look-back gives
//                 each row's first slot opos; the rows with cnt > 0 go, in
//                 row order, to a list of (opos, row, left, cnt, hit), and
//                 every expansion tile's first slot records the list entry
//                 that covers it. The last row's (left, opos), total,
//                 dropped = max(total - cap, 0) and the list's length go
//                 to a small result array
//   tt_sj_expand  slot-parallel: a block owns ETILE output slots, loads
//                 the list entries that cover them into shared memory and
//                 writes every output lane coalesced; slot j's entry is
//                 the last with opos <= j (a search in shared memory: the
//                 reference's searchsorted(opos, j, right) - 1 over the
//                 rows), bpos = left + j - opos, match = hit & sv[bpos]
//                 (inside a hit run sk[bpos] == pkey), the probe lanes and
//                 row ids of the entry's row, the build lanes of
//                 order[bpos]. A row owning more than a tile's slots
//                 spreads over several blocks. A slot at or past `total`
//                 is owned by no row: there the reference's searchsorted
//                 names the last probe row, so the slot takes that row's
//                 lanes and order[clip(left + j - opos, 0, B - 1)]'s build
//                 lanes, every validity false, mask 0, row ids -1
//
// Bound: bytes. Each probe row's key columns and mask are read once,
// each build row's keys, mask and lanes once, every output slot written
// once. What holds it back on an H100: at Q18's duplicate level (1M
// orders probing 4M lineitem rows) K8 (0.18 ms of 0.49 on the card: no
// build row sits at the sentinel there), the latency-bound compaction in
// the pack (0.07), the count's searches (0.08) and the sorted layout's
// gathers (0.06); the expansion is near its bytes (0.08). At a unique
// level the probe's output writes (0.11 of 0.20 for 4M probes into 1M
// orders). A call past ≈ 0.2 ms of device time is host-bound: the one
// read and the launches after it.
//
// Plain C interface (nvcc + ctypes): kernels/sort_join.py packs each
// call's arguments into one int64 word array; every launch goes on the
// given stream, never synchronizes, and the function returns the
// cudaError_t of its launches (0 = success) or -1 for an argument it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

typedef long long ll;
typedef unsigned long long ull;
using compact::LookBack;
using compact::P2;

constexpr int MAXK = 4;   // key columns of one level
constexpr int MAXG = 32;  // lanes of one side
constexpr int MAXR = 8;   // row-id lanes
constexpr int BLOCK = 256;
constexpr int CITEMS = 8;
constexpr int CTILE = BLOCK * CITEMS;  // probe rows a count tile
constexpr int ETILE = 1024;            // output slots an expansion block
constexpr int DIR_MAX_BITS = 20;       // the directory holds at most 2^20 + 1 positions
constexpr unsigned FULL = 0xffffffffu;

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

// ---------------------------------------------------------------- keys

struct Keys {
  int nk, key_i32;
  const ll* d[MAXK];
  const uint8_t* v[MAXK];
  ll lo[MAXK], st[MAXK];
};

__device__ __forceinline__ ll pack_key(const Keys& k, ll i, bool* ok) {
  ull acc = 0;
  bool good = true;
  for (int j = 0; j < k.nk; ++j) {
    acc += ((ull)k.d[j][i] - (ull)k.lo[j]) * (ull)k.st[j];
    good = good && k.v[j][i] != 0;
  }
  *ok = good;
  return k.key_i32 ? (ll)(int32_t)(uint32_t)acc : (ll)acc;
}

struct PackP {
  ll n;
  Keys k;
  ll key_max;
  const uint8_t* mask;
  uint8_t* bvalid;
};

// the packed keys of this thread's ITEMS rows, column by column, so that
// the rows' loads are in flight together
__global__ void __launch_bounds__(compact::BLOCK) pack_kernel(const PackP p, const LookBack lb,
                                                              const compact::Out out, ll ntiles) {
  constexpr int IT = compact::ITEMS;
  __shared__ compact::Temp tmp;
  __shared__ unsigned s_tile;
  const ll tile = compact::take_tile(lb, &s_tile);
  ll row[IT];
  bool ok[IT];
  ull acc[IT];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    row[j] = compact::row_of(tile, j);
    ok[j] = row[j] < p.n && p.mask[row[j]] != 0;
    acc[j] = 0ULL;
  }
  for (int k = 0; k < p.k.nk; ++k) {
    const ll* d = p.k.d[k];
    const uint8_t* v = p.k.v[k];
    const ull lo = (ull)p.k.lo[k], st = (ull)p.k.st[k];
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      if (row[j] >= p.n) continue;
      acc[j] += ((ull)d[row[j]] - lo) * st;
      ok[j] = ok[j] && v[row[j]] != 0;
    }
  }
  ll x[IT];
  bool keep[IT];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const ll key = p.k.key_i32 ? (ll)(int32_t)(uint32_t)acc[j] : (ll)acc[j];
    if (row[j] < p.n) p.bvalid[row[j]] = (uint8_t)ok[j];  // bmask & key validity
    x[j] = ok[j] ? key : p.key_max;
    keep[j] = x[j] != p.key_max;
  }
  compact::compact_tile(lb, tile, ntiles, p.n, x, keep, out, tmp);
}

// ---------------------------------------------------- sorted + directory

struct Dir {
  ll m;
  int bits;
  const ll* sk;
  const int32_t* dir;
};

__device__ __forceinline__ int dir_shift(ll kmin, ll kmax, int bits) {
  const ull range = (ull)kmax - (ull)kmin;
  const int bl = range == 0ULL ? 0 : 64 - __clzll((ll)range);
  return bl > bits ? bl - bits : 0;
}

// searchsorted(sk, key, side="left") over all B positions, for N keys at
// once: their directory loads, then each step of their searches, are
// independent loads in flight together
template <int N>
__device__ __forceinline__ void lower_bounds(const Dir& d, const ll (&key)[N], ll (&lo)[N]) {
  ll hi[N];
  const ll kmin = d.m > 0 ? d.sk[0] : 0, kmax = d.m > 0 ? d.sk[d.m - 1] : 0;
  const int shift = dir_shift(kmin, kmax, d.bits);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (d.m == 0 || key[j] <= kmin) {
      lo[j] = hi[j] = 0;
    } else if (key[j] > kmax) {
      lo[j] = hi[j] = d.m;
    } else {
      const ll b = (ll)(((ull)key[j] - (ull)kmin) >> shift);
      lo[j] = d.dir[b];
      hi[j] = d.dir[b + 1];
    }
  }
  for (bool more = true; more;) {
    more = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (lo[j] >= hi[j]) continue;
      const ll mid = lo[j] + ((hi[j] - lo[j]) >> 1);
      if (d.sk[mid] < key[j]) lo[j] = mid + 1; else hi[j] = mid;
      more = more || lo[j] < hi[j];
    }
  }
}

struct SortedP {
  ll B, m;
  int bits;
  ll key_max;
  const int32_t* perm;
  const ll* comp;
  const int32_t* crow;
  const int32_t* tail;
  const uint8_t* bvalid;
  ll* sk;
  uint8_t* sv;
  int32_t* order;
  int32_t* dir;
  int32_t* rlen;  // null: a unique level
};

__device__ __forceinline__ ll key_at(const SortedP& p, ll i) { return p.comp[p.perm[i]]; }

constexpr int STILE = 1024;  // sorted positions a block of the sorted kernel
constexpr int SW = 8;        // positions after a run start its block holds

// the length of the run of `key` that starts at sorted position i, whose
// next SW keys are s[1 .. SW] (s[0] is i's): those first (most runs end
// there), then a galloping search through the sorted keys
__device__ ll run_length(const SortedP& p, ll i, ll key, const ll* s) {
#pragma unroll
  for (int q = 1; q <= SW; ++q)
    if (i + q >= p.m || s[q] != key) return q;
  ll lo = i + SW, step = 1;  // lo: the last position known to hold key
  while (lo + step < p.m && key_at(p, lo + step) == key) {
    lo += step;
    step <<= 1;
  }
  ll hi = lo + step < p.m ? lo + step : p.m;  // the first known not to
  while (hi - lo > 1) {
    const ll mid = lo + ((hi - lo) >> 1);
    if (key_at(p, mid) == key) lo = mid; else hi = mid;
  }
  return hi - i;
}

__global__ void __launch_bounds__(BLOCK) sorted_kernel(const SortedP p) {
  __shared__ ll s_key[STILE + 1 + SW];  // sorted positions t0 - 1 .. t0 + STILE + SW - 1
  __shared__ int32_t s_row[STILE];
  const int lane = threadIdx.x & 31;
  const ll t0 = (ll)blockIdx.x * STILE;
  {  // the permutation's entries first, then the gathers through them: each level's loads in flight together
    constexpr int STAGE = (STILE + 1 + SW + BLOCK - 1) / BLOCK;
    int32_t q[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = threadIdx.x + u * BLOCK;
      const ll i = t0 - 1 + j;
      q[u] = j < STILE + 1 + SW && i >= 0 && i < p.m ? p.perm[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = threadIdx.x + u * BLOCK;
      if (j >= STILE + 1 + SW) continue;
      s_key[j] = q[u] >= 0 ? p.comp[q[u]] : 0;
      if (j >= 1 && j <= STILE && q[u] >= 0) s_row[j - 1] = p.crow[q[u]];
    }
  }
  __syncthreads();
  const ll kmin = p.m > 0 ? p.comp[p.perm[0]] : 0, kmax = p.m > 0 ? p.comp[p.perm[p.m - 1]] : 0;
  const int shift = dir_shift(kmin, kmax, p.bits);
  const ll nb = 1LL << p.bits;
  // STILE is a multiple of BLOCK: every lane of a warp takes part in each
  // round's warp votes
  for (int r = threadIdx.x; r < STILE; r += BLOCK) {
    const ll i = t0 + r;
    ll r0 = 0, r1 = 0;  // directory entries [r0, r1) take position val
    ll val = 0;
    if (i < p.m) {
      const ll key = s_key[r + 1], prev = s_key[r];
      p.sk[i] = key;
      p.sv[i] = 1;
      p.order[i] = s_row[r];
      r0 = i > 0 ? (ll)(((ull)prev - (ull)kmin) >> shift) + 1 : 0;
      r1 = (ll)(((ull)key - (ull)kmin) >> shift) + 1;
      val = i;
      if (p.rlen != nullptr && (i == 0 || prev != key)) p.rlen[i] = (int32_t)run_length(p, i, key, s_key + r + 1);
    } else if (i < p.B) {
      const int32_t o = p.tail[i - p.m];
      p.sk[i] = p.key_max;
      p.sv[i] = p.bvalid[o];
      p.order[i] = o;
      if (p.rlen != nullptr && i == p.m) p.rlen[i] = (int32_t)(p.B - p.m);
    }
    if (i == p.m) {  // the buckets after the last key's start at M
      r0 = p.m > 0 ? (ll)(((ull)kmax - (ull)kmin) >> shift) + 1 : 0;
      r1 = nb + 1;
      val = p.m;
    }
    // a short range by its thread, a long one by the whole warp
    const bool wide = r1 - r0 > 32;
    if (!wide)
      for (ll b = r0; b < r1; ++b) p.dir[b] = (int32_t)val;
    for (unsigned many = __ballot_sync(FULL, wide); many != 0u; many &= many - 1u) {
      const int src = __ffs(many) - 1;
      const ll a0 = __shfl_sync(FULL, r0, src), a1 = __shfl_sync(FULL, r1, src);
      const int32_t v = (int32_t)__shfl_sync(FULL, val, src);
      for (ll b = a0 + lane; b < a1; b += 32) p.dir[b] = v;
    }
  }
}

// ----------------------------------------------------- the level's probe

struct Head {
  ll n, B;
  int ng, left, match_i64;
  Keys k;  // the probe side's key columns
  const uint8_t* pmask;
  Dir d;
  const uint8_t* sv;
  const int32_t* order;
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
    bool kv;
    const ll key[1] = {pack_key(h.k, i, &kv)};
    ll lb0[1];
    lower_bounds<1>(h.d, key, lb0);
    const ll pos = lb0[0] < h.B - 1 ? lb0[0] : h.B - 1;
    const bool match = h.pmask[i] != 0 && kv && h.sv[pos] != 0 && h.d.sk[pos] == key[0];
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

// ----------------------------------------------------- count and scan

struct Entry {  // a probe row with cnt > 0
  ll opos;
  int32_t row, left, cnt, hit;
};

struct CountP {
  Head h;
  ll cap;
  const int32_t* rlen;
  Entry* list;
  int32_t* first;  // [ntiles_e + 1] the entry covering each expansion tile's first slot
  ll etiles;
  ll* scal;  // total, dropped, the last row's left, its opos, the list's length
  ll ntiles;
};

struct Cnt {
  ll nz, slots;
};

struct AddP2 {
  __device__ __forceinline__ P2 id() const { return P2{0, 0}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const { return P2{x.a + y.a, x.b + y.b}; }
};

__global__ void __launch_bounds__(BLOCK) count_kernel(const CountP p, const LookBack lb) {
  constexpr int WARPS = BLOCK / 32, PARTS = CITEMS * WARPS, PER = PARTS / 32;
  __shared__ ll s_slots[PARTS];  // each (round, warp) part's slots, then the slots of the tile before it
  __shared__ int s_nz[PARTS];    // likewise its rows with cnt > 0
  __shared__ Cnt s_base;
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  const Head& h = p.h;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const ll tile = compact::take_tile(lb, &s_tile);
  // rows tile * CTILE + j * BLOCK + threadIdx.x: a warp's loads are 32
  // consecutive rows
  int32_t cnt[CITEMS];
  bool hitv[CITEMS], pm[CITEMS];
  ll key[CITEMS], lb0[CITEMS], before[CITEMS];
  unsigned nzm[CITEMS];
#pragma unroll
  for (int j = 0; j < CITEMS; ++j) {
    const ll i = tile * CTILE + (ll)j * BLOCK + threadIdx.x;
    bool kv = false;
    key[j] = i < h.n ? pack_key(h.k, i, &kv) : 0;
    pm[j] = i < h.n && h.pmask[i] != 0;
    hitv[j] = pm[j] && kv;  // pvalid, until the search says hit
  }
  lower_bounds<CITEMS>(h.d, key, lb0);
#pragma unroll
  for (int j = 0; j < CITEMS; ++j) {
    hitv[j] = hitv[j] && lb0[j] < h.B && h.d.sk[lb0[j]] == key[j];
    int32_t c = hitv[j] ? p.rlen[lb0[j]] : 0;
    if (h.left && pm[j] && c < 1) c = 1;
    cnt[j] = c;
    nzm[j] = __ballot_sync(FULL, c > 0);
    ll inc = c;  // the warp's inclusive scan of cnt
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const ll y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    before[j] = inc - c;
    const ll tot = __shfl_sync(FULL, inc, 31);
    if (lane == 0) {
      s_slots[j * WARPS + w] = tot;
      s_nz[j * WARPS + w] = __popc(nzm[j]);
    }
  }
  __syncthreads();
  if (w == 0) {  // the parts' exclusive offsets, then the tile's by look-back
    ll cs[PER], ssum = 0;
    int cz[PER], zsum = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      cs[q] = s_slots[lane * PER + q];
      cz[q] = s_nz[lane * PER + q];
      ssum += cs[q];
      zsum += cz[q];
    }
    ll sinc = ssum;
    int zinc = zsum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const ll ys = __shfl_up_sync(FULL, sinc, off);
      const int yz = __shfl_up_sync(FULL, zinc, off);
      if (lane >= off) {
        sinc += ys;
        zinc += yz;
      }
    }
    const ll sagg = __shfl_sync(FULL, sinc, 31);
    const int zagg = __shfl_sync(FULL, zinc, 31);
    ll srun = sinc - ssum;
    int zrun = zinc - zsum;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      s_slots[lane * PER + q] = srun;
      s_nz[lane * PER + q] = zrun;
      srun += cs[q];
      zrun += cz[q];
    }
    P2 b{0, 0};
    if (tile == 0) {
      if (lane == 0) compact::put_desc(lb.desc(0), 2, P2{zagg, sagg});
    } else {
      if (lane == 0) compact::put_desc(lb.desc(tile), 1, P2{zagg, sagg});
      b = compact::look_back(lb, tile, 1, 0, AddP2());
      if (lane == 0) compact::put_desc(lb.desc(tile), 2, P2{b.a + zagg, b.b + sagg});
    }
    if (lane == 0) {
      s_base = Cnt{b.a, b.b};
      if (tile == p.ntiles - 1) {
        const ll total = b.b + sagg;
        p.scal[0] = total;
        p.scal[1] = total > p.cap ? total - p.cap : 0;
        p.scal[4] = b.a + zagg;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CITEMS; ++j) {
    const ll i = tile * CTILE + (ll)j * BLOCK + threadIdx.x;
    if (i >= h.n) break;
    const ll o = s_base.slots + s_slots[j * WARPS + w] + before[j];  // the row's first slot
    if (i == h.n - 1) {
      p.scal[2] = lb0[j];
      p.scal[3] = o;
    }
    if (cnt[j] == 0) continue;
    const ll k = s_base.nz + s_nz[j * WARPS + w] + __popc(nzm[j] & lt);
    p.list[k] = Entry{o, (int32_t)i, (int32_t)lb0[j], cnt[j], (int32_t)hitv[j]};
    // the expansion tiles whose first slot this row owns
    for (ll e = (o + ETILE - 1) / ETILE; e <= p.etiles && e * ETILE < o + cnt[j]; ++e) p.first[e] = (int32_t)k;
  }
  if (compact::last_block(lb, &s_last)) compact::reset(lb, p.ntiles);
}

// ---------------------------------------------------------------- expand

struct ExpandP {
  Head h;
  int np, nr;
  ll cap;
  const Entry* list;
  const int32_t* first;
  const ll* scal;
  Lanes g;   // build lanes, by order[bpos]
  Lanes pl;  // probe lanes, by the slot's probe row
  const ll* rs[MAXR];
  ll* rd[MAXR];
  void* mask_out;
  ll* rowid_out;
};

__device__ __forceinline__ ll clip_pos(ll b, ll B) { return b < 0 ? 0 : (b > B - 1 ? B - 1 : b); }

__global__ void __launch_bounds__(BLOCK) expand_kernel(const ExpandP p) {
  __shared__ Entry s_e[ETILE + 1];
  __shared__ int s_ne;
  const Head& h = p.h;
  const ll total = p.scal[0], nnz = p.scal[4];
  const ll b = blockIdx.x;
  const ll j0 = b * ETILE;
  const ll j1 = j0 + ETILE < p.cap ? j0 + ETILE : p.cap;
  if (threadIdx.x == 0) s_ne = 0;
  __syncthreads();
  if (j0 < total) {
    const ll k0 = p.first[b];
    ll k1 = (b + 1) * ETILE < total ? (ll)p.first[b + 1] + 1 : nnz;  // the entries up to slot j1 - 1's
    if (k1 - k0 > ETILE + 1) k1 = k0 + ETILE + 1;
    for (ll k = k0 + threadIdx.x; k < k1; k += BLOCK) s_e[k - k0] = p.list[k];
    if (threadIdx.x == 0) s_ne = (int)(k1 - k0);
  }
  __syncthreads();
  const int ne = s_ne;
  const ll last = h.n - 1;
  for (ll j = j0 + threadIdx.x; j < j1; j += BLOCK) {
    if (j < total) {
      int lo = 0, hi = ne - 1;  // the last entry with opos <= j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_e[mid].opos <= j) lo = mid; else hi = mid - 1;
      }
      const Entry e = s_e[lo];
      const ll r = e.row;
      const ll bpos = clip_pos((ll)e.left + (j - e.opos), h.B);
      const bool match = e.hit != 0 && h.sv[bpos] != 0;
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
      put_mask(p.mask_out, h.match_i64, j, h.left ? true : match);
    } else {  // past `total`: the last probe row as the reference's source
      const ll bsel = h.order[clip_pos(p.scal[2] + (j - p.scal[3]), h.B)];
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
}

// ----------------------------------------------------------- arguments

void take_keys(Words& t, Keys& k) {
  k.nk = (int)t();
  k.key_i32 = (int)t();
  for (int j = 0; j < k.nk && j < MAXK; ++j) {
    k.d[j] = (const ll*)t();
    k.v[j] = (const uint8_t*)t();
    k.lo[j] = t();
    k.st[j] = t();
  }
}

bool keys_ok(const Keys& k) { return k.nk >= 1 && k.nk <= MAXK; }

void take_head(Words& t, Head& h) {
  h.n = t();
  h.B = t();
  h.d.m = t();
  h.d.bits = (int)t();
  h.ng = (int)t();
  h.left = (int)t();
  h.match_i64 = (int)t();
  h.pmask = (const uint8_t*)t();
  h.d.sk = (const ll*)t();
  h.sv = (const uint8_t*)t();
  h.order = (const int32_t*)t();
  h.d.dir = (const int32_t*)t();
  h.brow = (const ll*)t();
  take_keys(t, h.k);
}

bool head_ok(const Head& h) {
  return h.n >= 1 && h.B >= 1 && h.d.m >= 0 && h.d.m <= h.B && h.d.bits >= 0 && h.d.bits <= DIR_MAX_BITS &&
         h.ng >= 0 && h.ng <= MAXG && keys_ok(h.k);
}

void take_lanes(Words& t, Lanes& L, int k) {
  for (int g = 0; g < k; ++g) {
    L.d[g] = (const ll*)t();
    L.v[g] = (const uint8_t*)t();
    L.od[g] = (ll*)t();
    L.ov[g] = (uint8_t*)t();
  }
}

}  // namespace

// scratch words of the look-back over n rows (the pack over the build rows,
// the count over the probe rows)
extern "C" int64_t tt_sj_scratch_words(int64_t n) {
  const ll a = compact::compact_words(compact::tiles(n)), b = compact::scratch_words((n + CTILE - 1) / CTILE);
  return a > b ? a : b;
}

// words: B, key_max, keys (nk, key_i32, per key (d, v, lo, stride)), bmask, bvalid,
//        comp, crow, tail, res, scratch
extern "C" int tt_sj_pack(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  PackP p;
  p.n = t();
  p.key_max = t();
  take_keys(t, p.k);
  if (p.n < 1 || p.n > 0x7fffffffLL || !keys_ok(p.k)) return -1;
  p.mask = (const uint8_t*)t();
  p.bvalid = (uint8_t*)t();
  compact::Out out;
  out.comp = (ll*)t();
  out.crow = (int32_t*)t();
  out.tail = (int32_t*)t();
  out.res = (ll*)t();
  LookBack lb;
  lb.ws = (ll*)t();
  if (!t.done() || out.tail == nullptr) return -1;
  const ll nt = compact::tiles(p.n);
  pack_kernel<<<(unsigned)nt, compact::BLOCK, 0, (cudaStream_t)stream>>>(p, lb, out, nt);
  return (int)cudaGetLastError();
}

// words: B, m, bits, key_max, perm, comp, crow, tail, bvalid, sk, sv, order, dir, rlen (0: unique)
extern "C" int tt_sj_sorted(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 14) return -1;
  SortedP p;
  p.B = w[0];
  p.m = w[1];
  p.bits = (int)w[2];
  p.key_max = w[3];
  p.perm = (const int32_t*)w[4];
  p.comp = (const ll*)w[5];
  p.crow = (const int32_t*)w[6];
  p.tail = (const int32_t*)w[7];
  p.bvalid = (const uint8_t*)w[8];
  p.sk = (ll*)w[9];
  p.sv = (uint8_t*)w[10];
  p.order = (int32_t*)w[11];
  p.dir = (int32_t*)w[12];
  p.rlen = (int32_t*)w[13];
  if (p.B < 1 || p.m < 0 || p.m > p.B || p.bits < 0 || p.bits > DIR_MAX_BITS) return -1;
  (void)n_sms;
  sorted_kernel<<<(unsigned)((p.B + STILE) / STILE), BLOCK, 0, (cudaStream_t)stream>>>(p);  // positions 0 .. B
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

// words: head, cap, rlen, list, first, scal, scratch
extern "C" int tt_sj_count(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  CountP p;
  take_head(t, p.h);
  p.cap = t();
  if (!head_ok(p.h) || p.h.n > 0x7fffffffLL || p.cap < 1) return -1;
  p.rlen = (const int32_t*)t();
  p.list = (Entry*)t();
  p.first = (int32_t*)t();
  p.scal = (ll*)t();
  LookBack lb;
  lb.ws = (ll*)t();
  if (!t.done()) return -1;
  p.etiles = (p.cap + ETILE - 1) / ETILE;
  p.ntiles = (p.h.n + CTILE - 1) / CTILE;
  count_kernel<<<(unsigned)p.ntiles, BLOCK, 0, (cudaStream_t)stream>>>(p, lb);
  return (int)cudaGetLastError();
}

// words: head, np, nr, cap, list, first, scal,
//        per build lane (d, v, od, ov), per probe lane (d, v, od, ov),
//        per row-id lane (src, dst), mask_out, rowid_out
extern "C" int tt_sj_expand(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  ExpandP p;
  take_head(t, p.h);
  p.np = (int)t();
  p.nr = (int)t();
  p.cap = t();
  if (!head_ok(p.h) || p.np < 0 || p.np > MAXG || p.nr < 0 || p.nr > MAXR || p.cap < 1) return -1;
  p.list = (const Entry*)t();
  p.first = (const int32_t*)t();
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
  expand_kernel<<<(unsigned)((p.cap + ETILE - 1) / ETILE), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
