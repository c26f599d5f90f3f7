// W1 window: every window function of one (PARTITION BY, ORDER BY) spec.
//
// Replaces tidb_tpu/executor/window_device.py:154-442 (_build_kernel's
// XLA program). kernels/window.py drives these kernels after K8
// (csrc/lex_sort.cu) has sorted the packed sort words into perm (int32):
//
//   tt_win_flags      partition / peer start flags over the sorted rows
//   tt_win_scan       inclusive device-wide scan, three phases: each tile
//                     of 2048 rows reduces, one block scans the tile
//                     totals, each tile scans again from its carry.
//                     Modes: a flag lane (→ pid + 1, peer_id + 1), a
//                     count of valid[perm], an int64 sum (two's
//                     complement wrap, as the reference's cumsum) or a
//                     float64 sum of where(valid, data, 0)[perm]
//   tt_win_bounds     each start's row scattered to start_pos[id]; then
//                     first = start_pos[id], last = start_pos[id+1] - 1
//                     (the host WindowExec's recipe, in place of the
//                     reference's cummax / flipped cummin)
//   tt_win_range_key  the single ORDER BY key in ascending search space,
//                     NULLs as sentinels at the partition's head (ASC) or
//                     tail (DESC)
//   tt_win_frame      (fs, fe, nonempty) per row, clipped to the partition;
//                     RANGE offsets binary-search the valid-key run of the
//                     row's own partition (the same positions as the
//                     reference's global search over pid*S + key, clipped)
//   tt_win_rank       row_number, rank, dense_rank, ntile, cume_dist,
//                     percent_rank
//   tt_win_shift      lead / lag
//   tt_win_value      first_value / last_value / nth_value
//   tt_win_agg        count / sum / avg from prefix differences
//   tt_win_mm_*       min / max: masked lane (±inf or the type's limits for
//                     masked rows; uint64 compared unsigned), a segmented
//                     prefix scan (growing frames, read at fe) or suffix
//                     scan (shrinking frames, read at fs), or a sparse
//                     table of L levels (both-bounded ROWS frames, read at
//                     floor(log2 w)); NaN propagates as jnp.maximum /
//                     jnp.minimum propagate it (no fmax / fmin)
//
// Every function kernel writes its outputs at perm[i]: the scatter back to
// input row order is fused into the final write.
//
// Bound: bytes. Every step streams its lanes once or gathers through perm;
// nothing is compute-heavy (a RANGE search is log2 of the partition size).
// The design keeps each step a simple pass; a later PR can fuse them.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int IPT = 8;
constexpr int64_t TILE = (int64_t)BLOCK * IPT;
constexpr int MID = 1024;
constexpr ll LL_MAX = 0x7fffffffffffffffLL;
constexpr ll LL_MIN = -LL_MAX - 1;

enum Bound : int { B_UP = 0, B_PRE = 1, B_CUR = 2, B_FOL = 3, B_UF = 4 };
enum ScanMode : int { SCAN_FLAG = 0, SCAN_COUNT = 1, SCAN_SUM_I64 = 2, SCAN_SUM_F64 = 3 };
enum MMType : int { MM_I64 = 0, MM_U64 = 1, MM_F64 = 2 };

inline unsigned blocks_for(int64_t n) {
  int64_t b = (n + BLOCK - 1) / BLOCK;
  if (b < 1) b = 1;
  if (b > 65536) b = 65536;
  return (unsigned)b;
}

#define GRID_LOOP(i, n) \
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (n); i += (int64_t)gridDim.x * blockDim.x)

#define CHECK_LAUNCH()                      \
  do {                                      \
    cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

// --- min / max values: fill and NaN-propagating pick ------------------------

template <typename V, bool MAX>
__device__ __forceinline__ V mm_fill();
template <> __device__ __forceinline__ ll mm_fill<ll, false>() { return LL_MAX; }
template <> __device__ __forceinline__ ll mm_fill<ll, true>() { return LL_MIN; }
template <> __device__ __forceinline__ ull mm_fill<ull, false>() { return ~0ULL; }
template <> __device__ __forceinline__ ull mm_fill<ull, true>() { return 0ULL; }
template <> __device__ __forceinline__ double mm_fill<double, false>() { return __longlong_as_double(0x7ff0000000000000LL); }
template <> __device__ __forceinline__ double mm_fill<double, true>() { return __longlong_as_double((ll)0xfff0000000000000ULL); }

template <typename V, bool MAX>
__device__ __forceinline__ V mm_pick(V a, V b) {
  return MAX ? (a > b ? a : b) : (a < b ? a : b);
}
template <>
__device__ __forceinline__ double mm_pick<double, true>(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <>
__device__ __forceinline__ double mm_pick<double, false>(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// --- scan operators ---------------------------------------------------------

struct SumI64 {
  typedef ll T;
  __device__ __forceinline__ T operator()(const T& a, const T& b) const { return (ll)((ull)a + (ull)b); }
  __device__ __forceinline__ T id() const { return 0; }
};

struct SumF64 {
  typedef double T;
  __device__ __forceinline__ T operator()(const T& a, const T& b) const { return a + b; }
  __device__ __forceinline__ T id() const { return 0.0; }
};

template <typename V>
struct Pair {
  int f;  // a segment starts at or after this element
  V v;
};

// the reference's associative_scan combiner over (start flag, value)
template <typename V, bool MAX>
struct SegMM {
  typedef Pair<V> T;
  __device__ __forceinline__ T operator()(const T& a, const T& b) const {
    T r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : mm_pick<V, MAX>(a.v, b.v);
    return r;
  }
  __device__ __forceinline__ T id() const {
    T r;
    r.f = 0;
    r.v = mm_fill<V, MAX>();
    return r;
  }
};

// --- scan loads and stores (j is the position in scan order) ---------------

struct LoadFlag {
  const uint8_t* f;
  __device__ __forceinline__ ll operator()(int64_t j) const { return f[j] ? 1 : 0; }
};
struct LoadCount {
  const int32_t* perm;
  const uint8_t* v;
  __device__ __forceinline__ ll operator()(int64_t j) const { return v[perm[j]] ? 1 : 0; }
};
struct LoadSumI64 {
  const int32_t* perm;
  const ll* d;
  const uint8_t* v;
  __device__ __forceinline__ ll operator()(int64_t j) const {
    const int32_t r = perm[j];
    return v[r] ? d[r] : 0;
  }
};
struct LoadSumF64 {
  const int32_t* perm;
  const double* d;
  const uint8_t* v;
  __device__ __forceinline__ double operator()(int64_t j) const {
    const int32_t r = perm[j];
    return v[r] ? d[r] : 0.0;
  }
};
// masked min/max lane, forward (a segment starts at a partition's first
// row) or reversed (scan position j is row P-1-j; a segment starts at a
// partition's last row)
template <typename V>
struct LoadSeg {
  const V* x;
  const uint8_t* pstart;
  int64_t P;
  int rev;
  __device__ __forceinline__ Pair<V> operator()(int64_t j) const {
    Pair<V> p;
    const int64_t i = rev ? P - 1 - j : j;
    p.v = x[i];
    p.f = rev ? (i == P - 1 || pstart[i + 1] != 0) : (pstart[i] != 0);
    return p;
  }
};

template <typename T>
struct Store {
  T* out;
  __device__ __forceinline__ void operator()(int64_t j, const T& x) const { out[j] = x; }
};
template <typename V>
struct StoreSeg {
  V* out;
  int64_t P;
  int rev;
  __device__ __forceinline__ void operator()(int64_t j, const Pair<V>& x) const { out[rev ? P - 1 - j : j] = x.v; }
};

// --- the three-phase scan -----------------------------------------------------

template <typename Op, typename Load>
__global__ void __launch_bounds__(BLOCK) scan_up(Load ld, Op op, int64_t n, typename Op::T* part) {
  typedef typename Op::T T;
  typedef cub::BlockScan<T, BLOCK> BS;
  __shared__ typename BS::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * IPT;
  T acc = op.id();
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    if (base + k < n) acc = op(acc, ld(base + k));
  }
  T incl, total;
  BS(tmp).InclusiveScan(acc, incl, op, total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// one block: the tile totals → their exclusive prefixes, in place
template <typename Op>
__global__ void __launch_bounds__(MID) scan_mid(Op op, typename Op::T* part, int64_t nb) {
  typedef typename Op::T T;
  typedef cub::BlockScan<T, MID> BS;
  __shared__ typename BS::TempStorage tmp;
  const int64_t per = (nb + MID - 1) / MID;
  const int64_t lo = (int64_t)threadIdx.x * per;
  const int64_t hi = lo + per < nb ? lo + per : nb;
  T acc = op.id();
  for (int64_t j = lo; j < hi; ++j) acc = op(acc, part[j]);
  T run;
  BS(tmp).ExclusiveScan(acc, run, op.id(), op);
  for (int64_t j = lo; j < hi; ++j) {
    const T x = part[j];
    part[j] = run;
    run = op(run, x);
  }
}

template <typename Op, typename Load, typename St>
__global__ void __launch_bounds__(BLOCK) scan_down(Load ld, St st, Op op, int64_t n,
                                                   const typename Op::T* part) {
  typedef typename Op::T T;
  typedef cub::BlockScan<T, BLOCK> BS;
  __shared__ typename BS::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * IPT;
  T items[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) items[k] = base + k < n ? ld(base + k) : op.id();
  BS(tmp).InclusiveScan(items, items, op);
  const T carry = part[blockIdx.x];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    if (base + k < n) st(base + k, op(carry, items[k]));
  }
}

template <typename Op, typename Load, typename St>
int run_scan(Load ld, St st, Op op, int64_t n, void* part, cudaStream_t s) {
  typedef typename Op::T T;
  const int64_t nb = (n + TILE - 1) / TILE;
  scan_up<Op, Load><<<(unsigned)nb, BLOCK, 0, s>>>(ld, op, n, (T*)part);
  CHECK_LAUNCH();
  scan_mid<Op><<<1, MID, 0, s>>>(op, (T*)part, nb);
  CHECK_LAUNCH();
  scan_down<Op, Load, St><<<(unsigned)nb, BLOCK, 0, s>>>(ld, st, op, n, (const T*)part);
  CHECK_LAUNCH();
  return 0;
}

// --- boundaries ---------------------------------------------------------------

struct WordDesc {  // kernels/window.py packs these as int64 pairs
  const void* p;
  int64_t kind;  // 0 int32, 1 int64
};

__global__ void flags_kernel(const WordDesc* __restrict__ w, int nw, int npw, int64_t P,
                             const int32_t* __restrict__ perm, uint8_t* pstart, uint8_t* ostart) {
  GRID_LOOP(i, P) {
    if (i == 0) {
      pstart[0] = 1;
      ostart[0] = 1;
      continue;
    }
    const int32_t a = perm[i], b = perm[i - 1];
    bool pc = false, oc = false;
    for (int k = 0; k < nw; ++k) {
      const bool c = w[k].kind == 0 ? ((const int32_t*)w[k].p)[a] != ((const int32_t*)w[k].p)[b]
                                    : ((const ll*)w[k].p)[a] != ((const ll*)w[k].p)[b];
      if (k < npw) pc |= c;
      oc |= c;
    }
    pstart[i] = pc;
    ostart[i] = oc;
  }
}

__global__ void starts_kernel(int64_t P, const uint8_t* __restrict__ start, const ll* __restrict__ cs,
                              ll* __restrict__ pos) {
  GRID_LOOP(i, P) {
    if (start[i]) pos[cs[i] - 1] = i;
    if (i == P - 1) pos[cs[i]] = P;
  }
}

__global__ void first_last_kernel(int64_t P, const ll* __restrict__ cs, const ll* __restrict__ pos,
                                  ll* __restrict__ first, ll* __restrict__ last) {
  GRID_LOOP(i, P) {
    const ll id = cs[i] - 1;
    first[i] = pos[id];
    last[i] = pos[id + 1] - 1;
  }
}

// --- frames -------------------------------------------------------------------

__global__ void range_key_kernel(int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ kd,
                                 const uint8_t* __restrict__ kv, ll gmin, ll gmax, int desc, ll* __restrict__ rk) {
  GRID_LOOP(i, P) {
    const int32_t r = perm[i];
    rk[i] = kv[r] ? (desc ? gmax - kd[r] : kd[r] - gmin) : (desc ? LL_MAX : -1);
  }
}

// first index in [lo, hi) whose value is >= t (upper: > t)
__device__ __forceinline__ ll lower_pos(const ll* a, ll lo, ll hi, ll t, bool upper) {
  while (lo < hi) {
    const ll mid = lo + ((hi - lo) >> 1);
    const bool go_right = upper ? a[mid] <= t : a[mid] < t;
    if (go_right) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ ll bound_pos(int kind, ll off, ll cur, ll i, ll pf, ll pl, bool rows) {
  switch (kind) {
    case B_UP: return pf;
    case B_UF: return pl;
    case B_CUR: return cur;
    default:
      if (!rows) return cur;  // RANGE offsets: the search below, or the peer block
      return kind == B_PRE ? i - off : i + off;
  }
}

__global__ void frame_kernel(int64_t P, int rows, int sk, ll so, int ek, ll eo, int use_range, int desc,
                             const ll* __restrict__ pfirst, const ll* __restrict__ plast,
                             const ll* __restrict__ peer_first, const ll* __restrict__ peer_last,
                             const ll* __restrict__ rk, ll* __restrict__ fs_out, ll* __restrict__ fe_out,
                             uint8_t* __restrict__ ne_out) {
  GRID_LOOP(i, P) {
    const ll pf = pfirst[i], pl = plast[i];
    const ll cs = rows ? i : peer_first[i];
    const ll ce = rows ? i : peer_last[i];
    ll fs = bound_pos(sk, so, cs, i, pf, pl, rows);
    ll fe = bound_pos(ek, eo, ce, i, pf, pl, rows);
    if (use_range) {
      const ll key = rk[i];
      if (desc ? key != LL_MAX : key >= 0) {  // NULL-key rows keep their peer block
        ll vf = pf, vl = pl;
        if (desc) vl = lower_pos(rk, pf, pl + 1, LL_MAX, false) - 1;
        else vf = lower_pos(rk, pf, pl + 1, 0, false);
        if (sk == B_PRE || sk == B_FOL) fs = lower_pos(rk, vf, vl + 1, sk == B_FOL ? key + so : key - so, false);
        if (ek == B_PRE || ek == B_FOL) fe = lower_pos(rk, vf, vl + 1, ek == B_FOL ? key + eo : key - eo, true) - 1;
      }
    }
    ne_out[i] = fs <= fe && fs <= pl && fe >= pf;
    fs_out[i] = fs < pf ? pf : (fs > pl ? pl : fs);
    fe_out[i] = fe < pf ? pf : (fe > pl ? pl : fe);
  }
}

// --- functions ----------------------------------------------------------------

__global__ void rank_kernel(int kind, int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ pfirst,
                            const ll* __restrict__ plast, const ll* __restrict__ peer_first,
                            const ll* __restrict__ peer_last, const ll* __restrict__ ocs, ll k,
                            ll* __restrict__ a, ll* __restrict__ b, uint8_t* __restrict__ ones) {
  GRID_LOOP(i, P) {
    const ll pf = pfirst[i], psize = plast[i] - pf + 1, rn = i - pf;
    ll x = 0, y = 0;
    switch (kind) {
      case 0: x = rn + 1; break;                       // row_number
      case 1: x = peer_first[i] - pf + 1; break;       // rank
      case 2: x = ocs[i] - ocs[pf] + 1; break;         // dense_rank
      case 3: {                                         // ntile (values >= 0: / is floor)
        const ll big = psize / k, rem = psize % k, cut = rem * (big + 1);
        x = (big > 0 ? (rn < cut ? rn / (big + 1) : rem + (rn - cut) / big) : rn) + 1;
        break;
      }
      case 4: x = peer_last[i] - pf + 1; y = psize; break;  // cume_dist num / den
      default: x = peer_first[i] - pf; y = psize - 1; break;  // percent_rank
    }
    const int32_t r = perm[i];
    a[r] = x;
    if (b) b[r] = y;
    if (ones) ones[r] = 1;
  }
}

__global__ void shift_kernel(int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ pcs, ll off,
                             const ll* __restrict__ d, const uint8_t* __restrict__ v, const ll* __restrict__ dd,
                             const uint8_t* __restrict__ dv, ll* __restrict__ od, uint8_t* __restrict__ ov) {
  GRID_LOOP(i, P) {
    const ll t = i + off;
    const ll tc = t < 0 ? 0 : (t > P - 1 ? P - 1 : t);
    const bool ok = t >= 0 && t < P && pcs[tc] == pcs[i];
    const int32_t r = perm[i];
    ll x = 0;
    uint8_t xv = 0;
    if (ok) {
      const int32_t s = perm[tc];
      x = d[s];
      xv = v[s];
    } else if (dd != nullptr) {
      x = dd[r];
      xv = dv[r];
    }
    od[r] = x;
    ov[r] = xv;
  }
}

__global__ void value_kernel(int kind, int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ fs,
                             const ll* __restrict__ fe, const uint8_t* __restrict__ ne, ll nth,
                             const ll* __restrict__ d, const uint8_t* __restrict__ v, ll* __restrict__ od,
                             uint8_t* __restrict__ ov) {
  GRID_LOOP(i, P) {
    const bool n_ = ne == nullptr || ne[i] != 0;
    ll pos;
    bool ok = n_;
    if (kind == 0) {
      pos = fs[i];
    } else if (kind == 1) {
      pos = fe[i];
    } else {
      pos = fs[i] + nth - 1;
      ok = n_ && pos <= fe[i];
      pos = pos < 0 ? 0 : (pos > P - 1 ? P - 1 : pos);
    }
    const int32_t s = perm[pos], r = perm[i];
    od[r] = d[s];
    ov[r] = v[s] && ok;
  }
}

__device__ __forceinline__ ll frame_count(const ll* cnt_cs, ll s, ll e, bool n_) {
  if (!n_) return 0;
  if (cnt_cs == nullptr) return e - s + 1;  // every row valid
  return cnt_cs[e] - (s > 0 ? cnt_cs[s - 1] : 0);
}

// kind: 0 count, 1 sum int64, 2 sum float64, 3 avg int64, 4 avg float64
__global__ void agg_kernel(int kind, int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ fs,
                           const ll* __restrict__ fe, const uint8_t* __restrict__ ne, const ll* __restrict__ cnt_cs,
                           const void* __restrict__ sum_cs, void* __restrict__ a, void* __restrict__ b) {
  GRID_LOOP(i, P) {
    const ll s = fs[i], e = fe[i];
    const bool n_ = ne == nullptr || ne[i] != 0;
    const ll cnt = frame_count(cnt_cs, s, e, n_);
    const int32_t r = perm[i];
    if (kind == 0) {
      ((ll*)a)[r] = cnt;
      ((uint8_t*)b)[r] = 1;
      continue;
    }
    if (kind == 1 || kind == 3) {
      const ll* c = (const ll*)sum_cs;
      ((ll*)a)[r] = n_ ? (ll)((ull)c[e] - (ull)(s > 0 ? c[s - 1] : 0)) : 0;
    } else {
      const double* c = (const double*)sum_cs;
      ((double*)a)[r] = n_ ? c[e] - (s > 0 ? c[s - 1] : 0.0) : 0.0;
    }
    if (kind <= 2) ((uint8_t*)b)[r] = cnt > 0;
    else ((ll*)b)[r] = cnt;
  }
}

template <typename V, bool MAX>
__global__ void mm_masked_kernel(int64_t P, const int32_t* __restrict__ perm, const V* __restrict__ d,
                                 const uint8_t* __restrict__ v, V* __restrict__ out) {
  GRID_LOOP(i, P) {
    const int32_t r = perm[i];
    out[i] = v[r] ? d[r] : mm_fill<V, MAX>();
  }
}

template <typename V, bool MAX>
__global__ void mm_level_kernel(int64_t P, const V* __restrict__ prev, int64_t h, V* __restrict__ out) {
  GRID_LOOP(i, P) out[i] = mm_pick<V, MAX>(prev[i], i + h < P ? prev[i + h] : mm_fill<V, MAX>());
}

// mode: 0 growing frame (prefix scan read at fe), 1 shrinking frame
// (suffix scan read at fs), 2 sparse table of L levels
template <typename V, bool MAX>
__global__ void mm_out_kernel(int mode, int64_t P, const int32_t* __restrict__ perm, const ll* __restrict__ fs,
                              const ll* __restrict__ fe, const uint8_t* __restrict__ ne,
                              const ll* __restrict__ cnt_cs, const V* __restrict__ acc, int L,
                              const ll* __restrict__ table, V* __restrict__ od, uint8_t* __restrict__ ov) {
  GRID_LOOP(i, P) {
    const ll s = fs[i], e = fe[i];
    const bool n_ = ne == nullptr || ne[i] != 0;
    V x;
    if (mode == 0) {
      x = acc[e];
    } else if (mode == 1) {
      x = acc[s];
    } else {
      const ll w = e - s + 1 > 1 ? e - s + 1 : 1;
      int lk = 63 - __clzll(w);  // floor(log2 w)
      if (lk > L - 1) lk = L - 1;
      const ll half = 1LL << lk;
      const V* lv = (const V*)table[lk];
      const ll e2 = e - half + 1 > 0 ? e - half + 1 : 0;
      x = mm_pick<V, MAX>(lv[s], lv[e2]);
    }
    const int32_t r = perm[i];
    od[r] = x;
    ov[r] = frame_count(cnt_cs, s, e, n_) > 0;
  }
}

template <typename V, bool MAX>
int mm_dispatch(int op, int mode, int64_t P, const int32_t* perm, const ll* fs, const ll* fe, const uint8_t* ne,
                const ll* cnt_cs, const void* a, const void* b, int L, const ll* table, void* out, uint8_t* ov,
                int64_t h, cudaStream_t s) {
  const unsigned g = blocks_for(P);
  if (op == 0) {  // masked lane: a = data, b = valid
    mm_masked_kernel<V, MAX><<<g, BLOCK, 0, s>>>(P, perm, (const V*)a, (const uint8_t*)b, (V*)out);
  } else if (op == 1) {  // segmented scan of the masked lane a; b = pstart; ov = partials
    LoadSeg<V> ld{(const V*)a, (const uint8_t*)b, P, mode};
    StoreSeg<V> st{(V*)out, P, mode};
    return run_scan(ld, st, SegMM<V, MAX>(), P, ov, s);
  } else if (op == 2) {  // one sparse-table level from the previous one
    mm_level_kernel<V, MAX><<<g, BLOCK, 0, s>>>(P, (const V*)a, h, (V*)out);
  } else {
    mm_out_kernel<V, MAX><<<g, BLOCK, 0, s>>>(mode, P, perm, fs, fe, ne, cnt_cs, (const V*)a, L, table, (V*)out, ov);
  }
  CHECK_LAUNCH();
  return 0;
}

int mm_call(int type, int is_max, int op, int mode, int64_t P, const int32_t* perm, const ll* fs, const ll* fe,
            const uint8_t* ne, const ll* cnt_cs, const void* a, const void* b, int L, const ll* table, void* out,
            uint8_t* ov, int64_t h, cudaStream_t s) {
#define MM_CASE(V, M) return mm_dispatch<V, M>(op, mode, P, perm, fs, fe, ne, cnt_cs, a, b, L, table, out, ov, h, s)
  if (type == MM_I64) {
    if (is_max) MM_CASE(ll, true);
    MM_CASE(ll, false);
  }
  if (type == MM_U64) {
    if (is_max) MM_CASE(ull, true);
    MM_CASE(ull, false);
  }
  if (type == MM_F64) {
    if (is_max) MM_CASE(double, true);
    MM_CASE(double, false);
  }
#undef MM_CASE
  return -1;
}

}  // namespace

extern "C" {

int64_t tt_win_tile() { return TILE; }

int tt_win_flags(const void* words, int nw, int npw, int64_t P, const int32_t* perm, uint8_t* pstart,
                 uint8_t* ostart, int n_sms, void* stream) {
  if (nw < 1 || npw < 1 || npw > nw || P < 1) return -1;
  (void)n_sms;
  flags_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>((const WordDesc*)words, nw, npw, P, perm,
                                                                   pstart, ostart);
  return (int)cudaGetLastError();
}

// mode SCAN_FLAG reads `data` as a u8 flag lane; the others read
// valid[perm[j]] (and data[perm[j]]). out: int64 (float64 for SUM_F64).
int tt_win_scan(int mode, int64_t P, const int32_t* perm, const void* data, const uint8_t* valid, void* out,
                void* partials, void* stream) {
  if (P < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SCAN_FLAG:
      return run_scan(LoadFlag{(const uint8_t*)data}, Store<ll>{(ll*)out}, SumI64(), P, partials, s);
    case SCAN_COUNT:
      return run_scan(LoadCount{perm, valid}, Store<ll>{(ll*)out}, SumI64(), P, partials, s);
    case SCAN_SUM_I64:
      return run_scan(LoadSumI64{perm, (const ll*)data, valid}, Store<ll>{(ll*)out}, SumI64(), P, partials, s);
    case SCAN_SUM_F64:
      return run_scan(LoadSumF64{perm, (const double*)data, valid}, Store<double>{(double*)out}, SumF64(), P,
                      partials, s);
    default:
      return -1;
  }
}

int tt_win_bounds(int64_t P, const uint8_t* start, const ll* cs, ll* start_pos, ll* first, ll* last,
                  void* stream) {
  if (P < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  starts_kernel<<<blocks_for(P), BLOCK, 0, s>>>(P, start, cs, start_pos);
  CHECK_LAUNCH();
  first_last_kernel<<<blocks_for(P), BLOCK, 0, s>>>(P, cs, start_pos, first, last);
  return (int)cudaGetLastError();
}

int tt_win_range_key(int64_t P, const int32_t* perm, const ll* kd, const uint8_t* kv, int64_t gmin, int64_t gmax,
                     int desc, ll* rk, void* stream) {
  if (P < 1) return -1;
  range_key_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(P, perm, kd, kv, gmin, gmax, desc, rk);
  return (int)cudaGetLastError();
}

int tt_win_frame(int64_t P, int rows, int sk, int64_t so, int ek, int64_t eo, int use_range, int desc,
                 const ll* pfirst, const ll* plast, const ll* peer_first, const ll* peer_last, const ll* rk,
                 ll* fs, ll* fe, uint8_t* ne, void* stream) {
  if (P < 1 || sk < 0 || sk > 4 || ek < 0 || ek > 4 || (use_range && rk == nullptr)) return -1;
  frame_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(P, rows, sk, so, ek, eo, use_range, desc, pfirst,
                                                                   plast, peer_first, peer_last, rk, fs, fe, ne);
  return (int)cudaGetLastError();
}

int tt_win_rank(int kind, int64_t P, const int32_t* perm, const ll* pfirst, const ll* plast, const ll* peer_first,
                const ll* peer_last, const ll* ocs, int64_t k, ll* a, ll* b, uint8_t* ones, void* stream) {
  if (P < 1 || kind < 0 || kind > 5 || k < 1) return -1;
  rank_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(kind, P, perm, pfirst, plast, peer_first,
                                                                  peer_last, ocs, k, a, b, ones);
  return (int)cudaGetLastError();
}

int tt_win_shift(int64_t P, const int32_t* perm, const ll* pcs, int64_t off, const ll* d, const uint8_t* v,
                 const ll* dd, const uint8_t* dv, ll* od, uint8_t* ov, void* stream) {
  if (P < 1 || (dd == nullptr) != (dv == nullptr)) return -1;
  shift_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(P, perm, pcs, off, d, v, dd, dv, od, ov);
  return (int)cudaGetLastError();
}

int tt_win_value(int kind, int64_t P, const int32_t* perm, const ll* fs, const ll* fe, const uint8_t* ne,
                 int64_t nth, const ll* d, const uint8_t* v, ll* od, uint8_t* ov, void* stream) {
  if (P < 1 || kind < 0 || kind > 2) return -1;
  value_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(kind, P, perm, fs, fe, ne, nth, d, v, od, ov);
  return (int)cudaGetLastError();
}

int tt_win_agg(int kind, int64_t P, const int32_t* perm, const ll* fs, const ll* fe, const uint8_t* ne,
               const ll* cnt_cs, const void* sum_cs, void* a, void* b, void* stream) {
  if (P < 1 || kind < 0 || kind > 4 || (kind > 0 && (cnt_cs == nullptr || sum_cs == nullptr))) return -1;
  agg_kernel<<<blocks_for(P), BLOCK, 0, (cudaStream_t)stream>>>(kind, P, perm, fs, fe, ne, cnt_cs, sum_cs, a, b);
  return (int)cudaGetLastError();
}

int tt_win_mm_masked(int type, int is_max, int64_t P, const int32_t* perm, const void* d, const uint8_t* v,
                     void* out, void* stream) {
  if (P < 1) return -1;
  return mm_call(type, is_max, 0, 0, P, perm, nullptr, nullptr, nullptr, nullptr, d, v, 0, nullptr, out, nullptr,
                 0, (cudaStream_t)stream);
}

// mode 0: prefix scan (segments start at a partition's first row);
// mode 1: suffix scan (segments end at a partition's last row)
int tt_win_mm_scan(int type, int is_max, int mode, int64_t P, const void* masked, const uint8_t* pstart, void* acc,
                   void* partials, void* stream) {
  if (P < 1 || mode < 0 || mode > 1) return -1;
  return mm_call(type, is_max, 1, mode, P, nullptr, nullptr, nullptr, nullptr, nullptr, masked, pstart, 0, nullptr,
                 acc, (uint8_t*)partials, 0, (cudaStream_t)stream);
}

int tt_win_mm_level(int type, int is_max, int64_t P, const void* prev, int64_t h, void* out, void* stream) {
  if (P < 1 || h < 1) return -1;
  return mm_call(type, is_max, 2, 0, P, nullptr, nullptr, nullptr, nullptr, nullptr, prev, nullptr, 0, nullptr, out,
                 nullptr, h, (cudaStream_t)stream);
}

int tt_win_mm_out(int type, int is_max, int mode, int64_t P, const int32_t* perm, const ll* fs, const ll* fe,
                  const uint8_t* ne, const ll* cnt_cs, const void* acc, int L, const ll* table, void* od,
                  uint8_t* ov, void* stream) {
  if (P < 1 || mode < 0 || mode > 2 || (mode == 2 && (table == nullptr || L < 1))) return -1;
  return mm_call(type, is_max, 3, mode, P, perm, fs, fe, ne, cnt_cs, acc, nullptr, L, table, od, ov, 0,
                 (cudaStream_t)stream);
}

}  // extern "C"
