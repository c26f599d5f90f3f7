// W1 window: every window function of one (PARTITION BY, ORDER BY) spec.
//
// Replaces tidb_tpu/executor/window_device.py:154-442 (_build_kernel's
// XLA program). kernels/window.py drives these kernels after K8
// (csrc/lex_sort.cu) has sorted the packed sort words into perm (int32).
// Every step after the first runs over the rows in sorted order, and every
// input lane is read through perm once:
//
//   gather_kernel  one sorted row a thread: the sort words and every
//                  argument lane (data, valid) and the RANGE key's search
//                  lane read at perm[i] — all of a row's random reads in
//                  flight before its coalesced stores into sorted order —
//                  and the inverse permutation (inv[perm[i]] = i)
//   bounds_kernel  one sweep over tiles of the sorted words with decoupled
//                  look-back: each row against the row before, the
//                  (partition start, peer start) counts scanned into pid
//                  and peer id (int32). Each start records its row in
//                  ppos[pid] / opos[peer id], the last row P after the last
//                  start, so a row's partition is [ppos[pid], ppos[pid + 1])
//                  and its peers [opos[id], opos[id + 1])
//   scan_kernel    one look-back sweep a prefix scan over a gathered lane:
//                  (count, sum) pairs (int64 sums wrap in two's complement
//                  as the reference's cumsum; float64 sums), a count alone,
//                  or the segmented min / max of a growing (prefix) or
//                  shrinking (suffix) frame; NaN propagates as jnp.maximum
//                  / jnp.minimum propagate it (no fmax / fmin)
//   level_kernel   a sparse-table level, only for a both-bounded ROWS min /
//                  max wider than LOOP_W rows
//   funcs_kernel   every function of the spec over the sorted rows, from
//                  the boundaries: rankings, lead / lag (the gathered lane
//                  at i ± offset), first / last / nth value, count / sum /
//                  avg (prefix differences), min / max (the scans, a direct
//                  pass over a ROWS frame of at most LOOP_W rows — its rows
//                  are neighbours in the gathered lane — or the sparse
//                  table); frames clipped to the partition, RANGE offsets
//                  by a binary search of the row's own partition (the same
//                  positions as the reference's global search over pid*S +
//                  key, clipped). Results go to one record a sorted row,
//                  written in whole words
//   out_kernel     one pass in input order: row j loads its record at
//                  inv[j] and writes every output lane of the spec,
//                  coalesced (random record reads replace random 1- and
//                  8-byte writes)
//
// The look-back scratch (two counters and a 16-byte descriptor a tile) is
// zeroed when it is allocated; the last block of each look-back launch (by
// a done-ticket) sets it back to zero, so no call zeroes it. Word, lane,
// function and output tables go to the kernels as parameters: no upload.
//
// Bound: bytes. A read through perm costs a 32-byte sector; everything
// else streams its lanes once.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_exchange.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int IPT = 8;
constexpr int TILE = BLOCK * IPT;
constexpr int MAXW = 64;   // sort words
constexpr int MAXG = 16;   // gathered lanes a launch
constexpr int MAXF = 8;    // functions a funcs launch: their valid bytes fill one record word
constexpr int MAXO = 24;   // output lanes an out launch
constexpr int MAXLV = 128;  // sparse-table levels a funcs launch: MAXF tables of 16 (the executor sends ROWS frames up to 2^16 wide)
constexpr int LOOP_W = 64;
constexpr ll LL_MAX = 0x7fffffffffffffffLL;
constexpr ll LL_MIN = -LL_MAX - 1;

enum Bound : int { B_UP = 0, B_PRE = 1, B_CUR = 2, B_FOL = 3, B_UF = 4 };
enum MMType : int { MM_I64 = 0, MM_U64 = 1, MM_F64 = 2 };
enum Code : int { F_RANK = 0, F_SHIFT = 1, F_VALUE = 2, F_COUNT = 3, F_SUM = 4, F_MINMAX = 5 };
enum Scan : int { S_PAIR_I64 = 0, S_PAIR_F64 = 1, S_COUNT = 2, S_SEG = 3 };
enum MMMode : int { MODE_PREFIX = 0, MODE_SUFFIX = 1, MODE_LOOP = 2, MODE_TABLE = 3 };

inline unsigned blocks_for(ll n) {
  ll b = (n + BLOCK - 1) / BLOCK;
  if (b < 1) b = 1;
  if (b > 65536) b = 65536;
  return (unsigned)b;
}

#define GRID_LOOP(i, n) \
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < (n); i += (ll)gridDim.x * blockDim.x)

#define CHECK_LAUNCH()                      \
  do {                                      \
    cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

// --- min / max values: fill, NaN-propagating pick, 8-byte bits -----------

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

template <typename V> __device__ __forceinline__ V from_bits(ll b);
template <> __device__ __forceinline__ ll from_bits<ll>(ll b) { return b; }
template <> __device__ __forceinline__ ull from_bits<ull>(ll b) { return (ull)b; }
template <> __device__ __forceinline__ double from_bits<double>(ll b) { return __longlong_as_double(b); }
__device__ __forceinline__ ll to_bits(ll v) { return v; }
__device__ __forceinline__ ll to_bits(ull v) { return (ll)v; }
__device__ __forceinline__ ll to_bits(double v) { return __double_as_longlong(v); }

// the masked min / max lane at x: the value, or the fill where NULL
template <typename V, bool MAX>
__device__ __forceinline__ V masked_at(const ll* gd, const uint8_t* gv, ll x) {
  return __ldg(gv + x) ? from_bits<V>(__ldg(gd + x)) : mm_fill<V, MAX>();
}

// --- decoupled look-back ----------------------------------------------------

struct P2 {  // every scan's element: a (a count or a flag, below 2^62) and b
  ll a, b;
};

// scratch (int64 words): [0] tile counter, [1] done counter, then one
// 16-byte descriptor a tile — word 0: status << 62 | a (status 0 none, 1
// aggregate, 2 inclusive prefix), word 1: b — stored and loaded as one
// 16-byte transaction (one thread's aligned vector access), so status and
// value arrive together and no fence stands between them. A descriptor
// sits at the same place whatever the call's tile count: the zero status a
// call leaves behind is zero for the next.
struct LookBack {
  ll* ws;
  ll nb;
  __device__ unsigned* tile_ctr() const { return (unsigned*)ws; }
  __device__ unsigned* done() const { return (unsigned*)(ws + 1); }
  __device__ ll* desc(ll j) const { return ws + 2 + 2 * j; }
};

constexpr ll A_MASK = (1LL << 62) - 1;

__device__ __forceinline__ void put_desc(ll* d, ll status, const P2& v) {
  asm volatile("st.volatile.global.v2.s64 [%0], {%1, %2};" ::"l"(d), "l"((status << 62) | v.a), "l"(v.b)
               : "memory");
}

__device__ __forceinline__ ll get_desc(const ll* d, P2* v) {  // → status
  ll w0, w1;
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];" : "=l"(w0), "=l"(w1) : "l"(d) : "memory");
  v->a = w0 & A_MASK;
  v->b = w1;
  return (ll)((ull)w0 >> 62);
}

// cub's block prefix callback, run by the 32 lanes of warp 0: lane 0
// publishes the tile's aggregate; then the warp reads the descriptors of
// the 32 tiles before the window's start at once (lane q on tile j - q),
// waits until each has published, folds them in order up to the nearest
// one holding an inclusive prefix (a shuffle tree: earlier tiles sit in
// higher lanes) and moves the window back until it meets one. Lane 0
// publishes the tile's inclusive prefix; the exclusive one is returned.
template <typename Op>
struct Prefix {
  LookBack lb;
  Op op;
  ll tile;
  __device__ P2 operator()(P2 agg) {
    const int lane = threadIdx.x & 31;
    P2 excl = op.id();
    if (tile == 0) {
      if (lane == 0) put_desc(lb.desc(0), 2, agg);
      return excl;
    }
    if (lane == 0) put_desc(lb.desc(tile), 1, agg);
    for (ll j = tile - 1;; j -= 32) {
      const ll q = j - lane;
      ll s = 2;  // past tile 0 (never folded: tile 0 is inclusive)
      P2 v = op.id();
      if (q >= 0) {
        while ((s = get_desc(lb.desc(q), &v)) == 0) {
        }
      }
      const unsigned incl = __ballot_sync(0xffffffffu, s == 2);
      if (incl && lane > __ffs(incl) - 1) v = op.id();
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        P2 o;
        o.a = __shfl_down_sync(0xffffffffu, v.a, off);
        o.b = __shfl_down_sync(0xffffffffu, v.b, off);
        if (lane + off < 32) v = op(o, v);
      }
      P2 w;
      w.a = __shfl_sync(0xffffffffu, v.a, 0);
      w.b = __shfl_sync(0xffffffffu, v.b, 0);
      excl = op(w, excl);
      if (incl) break;
    }
    if (lane == 0) put_desc(lb.desc(tile), 2, op(excl, agg));
    return excl;
  }
};

__device__ __forceinline__ ll take_tile(LookBack lb, unsigned* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(lb.tile_ctr(), 1u);
  __syncthreads();
  return (ll)*s_tile;
}

// the last block to finish sets the scratch back to zero
__device__ void finish(LookBack lb, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(lb.done(), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  for (ll j = threadIdx.x; j < lb.nb; j += blockDim.x) *lb.desc(j) = 0;
  if (threadIdx.x == 0) {
    *lb.tile_ctr() = 0u;
    *lb.done() = 0u;
  }
}

struct AddOp {  // (count, int64 sum), both wrapping
  __device__ __forceinline__ P2 id() const { return P2{0, 0}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const {
    return P2{(ll)((ull)x.a + (ull)y.a), (ll)((ull)x.b + (ull)y.b)};
  }
};

struct AddF64Op {  // (count, float64 sum)
  __device__ __forceinline__ P2 id() const { return P2{0, 0}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const {
    return P2{x.a + y.a, __double_as_longlong(__longlong_as_double(x.b) + __longlong_as_double(y.b))};
  }
};

// the reference's associative_scan combiner over (start flag, value)
template <typename V, bool MAX>
struct SegOp {
  __device__ __forceinline__ P2 id() const { return P2{0, to_bits(mm_fill<V, MAX>())}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const {
    return P2{x.a | y.a, y.a ? y.b : to_bits(mm_pick<V, MAX>(from_bits<V>(x.b), from_bits<V>(y.b)))};
  }
};

// --- the gather and the boundaries ---------------------------------------------

struct Word {
  const void* p;
  ll kind;  // 0 int32, 1 int64
};

// mode 0: data (8 bytes) and valid; 1: valid only; 2: the RANGE key's
// search lane (od int64: the key in ascending search space, NULLs as
// sentinels at the partition's head (ASC) or tail (DESC))
struct Gather {
  const void* d;
  const uint8_t* v;
  void* od;
  uint8_t* ov;
  ll gmin, gmax;
  int mode, desc;
};

struct GatherArgs {
  ll P;
  const int32_t* perm;
  int32_t* inv;  // null: not this launch's
  int nw, ng;
  int parts;  // of the lanes: 1 their data (and the RANGE key), 2 their valid bytes, 3 both
  Word w[MAXW];      // the sort words, and
  void* sw[MAXW];    // where their sorted rows go
  Gather g[MAXG];
};

// every lane W1 reads it reads through the read-only path (__ldg): no
// kernel writes what it reads, and the loads of a row need not wait for
// the stores before them
__device__ __forceinline__ ll word_at(const Word& w, ll r) {
  return w.kind == 0 ? (ll)__ldg((const int32_t*)w.p + r) : __ldg((const ll*)w.p + r);
}

// the gathered row of one lane: its data word and its valid byte
struct GRow {
  ll d;
  uint8_t v;
};

// what of lane g a pass with `parts` moves: bit 0 its data word, bit 1 its
// valid byte (the RANGE key's search lane needs both, and is data)
__device__ __forceinline__ int lane_parts(const Gather& g, int parts) {
  if (g.mode == 2) return parts & 1 ? 3 : 0;
  return (g.mode == 1 ? 2 : 3) & parts;
}

__device__ __forceinline__ GRow gather_load(const Gather& g, int parts, int32_t r) {
  GRow x;
  x.d = parts & 1 ? __ldg((const ll*)g.d + r) : 0;
  x.v = parts & 2 ? __ldg(g.v + r) : 0;
  return x;
}

__device__ __forceinline__ void gather_store(const Gather& g, int parts, const GRow& x, ll i) {
  if (g.mode == 2) {
    if (parts) ((ll*)g.od)[i] = x.v ? (g.desc ? g.gmax - x.d : x.d - g.gmin) : (g.desc ? LL_MAX : -1);
    return;
  }
  if (parts & 1) ((ll*)g.od)[i] = x.d;
  if (parts & 2) g.ov[i] = x.v;
}

// one sorted row a thread: the random reads of one pass (sort words, lane
// data or valid bytes at perm[i]) issued four at a time before their
// coalesced stores, and (in one pass) the inverse permutation. A call runs
// a few passes, each with a footprint L2 can serve (kernels/window.py)
constexpr int GB = 4;

__global__ void __launch_bounds__(BLOCK) gather_kernel(const GatherArgs a) {
  const ll i = (ll)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.P) return;
  const int32_t r = __ldg(a.perm + i);
  if (a.inv != nullptr) a.inv[r] = (int32_t)i;
  for (int q0 = 0; q0 < a.nw; q0 += GB) {
    ll x[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      if (q0 + u < a.nw) x[u] = word_at(a.w[q0 + u], r);
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      if (q0 + u >= a.nw) continue;
      if (a.w[q0 + u].kind == 0) ((int32_t*)a.sw[q0 + u])[i] = (int32_t)x[u];
      else ((ll*)a.sw[q0 + u])[i] = x[u];
    }
  }
  for (int g0 = 0; g0 < a.ng; g0 += GB) {
    GRow x[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      if (g0 + u < a.ng) x[u] = gather_load(a.g[g0 + u], lane_parts(a.g[g0 + u], a.parts), r);
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      if (g0 + u < a.ng) gather_store(a.g[g0 + u], lane_parts(a.g[g0 + u], a.parts), x[u], i);
    }
  }
}

struct BoundsArgs {
  ll P;
  int nw, npw;
  Word w[MAXW];  // the sorted words
  int32_t *pid, *oid, *ppos, *opos;
  ll* ws;
};

typedef cub::BlockScan<P2, BLOCK> BlockScanP2;
typedef cub::BlockExchange<P2, BLOCK, IPT> BlockExchangeP2;

// one tile's scan with decoupled look-back: items striped in (row base +
// k * BLOCK + t: coalesced loads and stores), blocked for the scan
template <typename Op>
__device__ __forceinline__ void tile_scan(P2 (&it)[IPT], const Op& op, LookBack lb, ll tile, void* smem) {
  BlockExchangeP2(*(typename BlockExchangeP2::TempStorage*)smem).StripedToBlocked(it);
  __syncthreads();
  Prefix<Op> pre{lb, op, tile};
  BlockScanP2(*(typename BlockScanP2::TempStorage*)smem).InclusiveScan(it, it, op, pre);
  __syncthreads();
  BlockExchangeP2(*(typename BlockExchangeP2::TempStorage*)smem).BlockedToStriped(it);
}

union ScanSmem {
  typename BlockScanP2::TempStorage scan;
  typename BlockExchangeP2::TempStorage ex;
};

// tiles of the sorted words with decoupled look-back: each row against the
// row before it, the (partition start, peer start) counts scanned into pid
// and peer id; each start's row at ppos[pid] / opos[peer id], P after the
// last
__global__ void __launch_bounds__(BLOCK) bounds_kernel(const BoundsArgs a) {
  __shared__ ScanSmem tmp;
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  const LookBack lb{a.ws, (a.P + TILE - 1) / TILE};
  const ll tile = take_tile(lb, &s_tile);
  const ll base = tile * TILE + threadIdx.x;
  uint32_t fl = 0;  // bit 2k: row k starts a partition; bit 2k + 1: a peer group
  for (int q = 0; q < a.nw; ++q) {
    const Word w = a.w[q];
    const uint32_t bits = q < a.npw ? 3u : 2u;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const ll i = base + k * BLOCK;
      if (i > 0 && i < a.P && word_at(w, i) != word_at(w, i - 1)) fl |= bits << (2 * k);
    }
  }
  if (base == 0) fl |= 3u;
  P2 it[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) it[k] = P2{(fl >> (2 * k)) & 1, (fl >> (2 * k + 1)) & 1};
  tile_scan(it, AddOp(), lb, tile, &tmp);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const ll i = base + k * BLOCK;
    if (i >= a.P) continue;
    const int32_t p = (int32_t)it[k].a - 1, o = (int32_t)it[k].b - 1;
    a.pid[i] = p;
    a.oid[i] = o;
    if ((fl >> (2 * k)) & 1) a.ppos[p] = (int32_t)i;
    if ((fl >> (2 * k + 1)) & 1) a.opos[o] = (int32_t)i;
    if (i == a.P - 1) {
      a.ppos[p + 1] = (int32_t)a.P;
      a.opos[o + 1] = (int32_t)a.P;
    }
  }
  finish(lb, &s_last);
}

// --- one-sweep scans over a gathered lane -----------------------------------

struct ScanArgs {
  ll P;
  const ll* gd;
  const uint8_t* gv;
  const int32_t* pid;
  int32_t* cnt;  // counts (int32: P < 2^31)
  ll* out;       // sums, or the min / max accumulator
  ll* ws;
};

struct LoadPair {
  __device__ __forceinline__ P2 operator()(const ScanArgs& a, ll j) const {
    const bool v = __ldg(a.gv + j) != 0;
    return P2{v ? 1 : 0, v ? __ldg(a.gd + j) : 0};  // a float64 0.0 is 0 in its bits
  }
};
struct LoadCount {
  __device__ __forceinline__ P2 operator()(const ScanArgs& a, ll j) const { return P2{__ldg(a.gv + j) ? 1 : 0, 0}; }
};
// scan position j is row j (prefix) or row P - 1 - j (suffix): a segment
// starts at a partition's first row, or (reversed) at its last row
template <typename V, bool MAX, bool REV>
struct LoadSeg {
  __device__ __forceinline__ P2 operator()(const ScanArgs& a, ll j) const {
    const ll i = REV ? a.P - 1 - j : j;
    const bool f = REV ? (i == a.P - 1 || __ldg(a.pid + i + 1) != __ldg(a.pid + i))
                       : (i == 0 || __ldg(a.pid + i) != __ldg(a.pid + i - 1));
    return P2{f ? 1 : 0, to_bits(masked_at<V, MAX>(a.gd, a.gv, i))};
  }
};

struct StorePair {
  __device__ __forceinline__ void operator()(const ScanArgs& a, ll j, const P2& x) const {
    a.cnt[j] = (int32_t)x.a;
    if (a.out != nullptr) a.out[j] = x.b;
  }
};
template <bool REV>
struct StoreSeg {
  __device__ __forceinline__ void operator()(const ScanArgs& a, ll j, const P2& x) const {
    a.out[REV ? a.P - 1 - j : j] = x.b;
  }
};

template <typename Op, typename Load, typename Store>
__global__ void __launch_bounds__(BLOCK) scan_kernel(const ScanArgs a) {
  __shared__ ScanSmem tmp;
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  const LookBack lb{a.ws, (a.P + TILE - 1) / TILE};
  const ll tile = take_tile(lb, &s_tile);
  const ll base = tile * TILE + threadIdx.x;
  const Op op{};
  P2 it[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) it[k] = base + k * BLOCK < a.P ? Load()(a, base + k * BLOCK) : op.id();
  tile_scan(it, op, lb, tile, &tmp);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    if (base + k * BLOCK < a.P) Store()(a, base + k * BLOCK, it[k]);
  }
  finish(lb, &s_last);
}

template <typename V, bool MAX>
__global__ void level_kernel(ll P, const ll* __restrict__ gd, const uint8_t* __restrict__ gv,
                             const ll* __restrict__ prev, ll h, ll* __restrict__ out) {
  GRID_LOOP(i, P) {
    const V x = prev ? from_bits<V>(__ldg(prev + i)) : masked_at<V, MAX>(gd, gv, i);
    const V y = i + h < P ? (prev ? from_bits<V>(__ldg(prev + i + h)) : masked_at<V, MAX>(gd, gv, i + h))
                          : mm_fill<V, MAX>();
    out[i] = to_bits(mm_pick<V, MAX>(x, y));
  }
}

// --- the functions -------------------------------------------------------------

struct Func {
  int code, sub;
  int has_frame, rows, sk, ek, use_range, desc;
  ll so, eo, k;  // frame offsets; NTILE buckets / signed lead-lag offset / nth
  const ll* gd;
  const uint8_t* gv;
  const ll* dd;  // lead / lag default, gathered (null: none)
  const uint8_t* dv;
  const int32_t* cnt;  // prefix counts of gv (null: every row counts)
  const ll* sum;       // prefix sums
  const ll* acc;       // min / max prefix or suffix accumulator
  int mm_type, is_max, mm_mode, L, lv0;
  int a_slot, b_kind, b_slot;  // record word of a; b: 0 none, 1 a byte of the launch's byte word, 2 a word
};

struct FuncArgs {
  ll P;
  const int32_t *pid, *oid, *ppos, *opos;
  const ll* rk;
  ll* rec;
  int stride;            // record words
  int bw_slot, pad_slot;  // this launch's byte word (byte q: function q's valid), the padding word (-1: none)
  int staged;            // the launch writes whole records: a block stages its rows' in shared memory
  int nf;
  Func f[MAXF];
  const ll* levels[MAXLV];
};

// first index in [lo, hi) whose value is >= t (upper: > t)
__device__ __forceinline__ ll lower_pos(const ll* a, ll lo, ll hi, ll t, bool upper) {
  while (lo < hi) {
    const ll mid = lo + ((hi - lo) >> 1);
    const ll am = __ldg(a + mid);
    const bool go_right = upper ? am <= t : am < t;
    if (go_right) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the same position as lower_pos over [lo, hi), found by galloping out
// from `from` (a row near the answer: the row itself, or its partition's
// end): a frame bound a few rows away costs a few steps
__device__ __forceinline__ ll search_from(const ll* a, ll lo, ll hi, ll t, bool upper, ll from) {
  auto before = [&](ll x) {  // x lies before the answer
    const ll v = __ldg(a + x);
    return upper ? v <= t : v < t;
  };
  const ll f = from < lo ? lo : (from > hi ? hi : from);
  if (f < hi && before(f)) {  // the answer lies in (f, hi]
    ll l = f + 1;
    for (ll step = 1;; step <<= 1) {
      const ll x = l + step - 1;
      if (x >= hi) return lower_pos(a, l, hi, t, upper);
      if (!before(x)) return lower_pos(a, l, x, t, upper);
      l = x + 1;
    }
  }
  ll r = f;  // the answer lies in [lo, r]
  for (ll step = 1;; step <<= 1) {
    const ll x = r - step;
    if (x < lo) return lower_pos(a, lo, r, t, upper);
    if (before(x)) return lower_pos(a, x + 1, r, t, upper);
    r = x;
  }
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

struct Row {
  ll i, pf, pl, qf, ql;  // the row, its partition's and its peers' first and last rows
};

struct Frame {
  ll s, e;
  bool ne;
};

// (fs, fe, nonempty) clipped to the partition; no frame: the default one
__device__ __forceinline__ Frame frame_of(const Func& f, const Row& w, const ll* rk) {
  if (!f.has_frame) return Frame{w.pf, w.ql, true};
  const bool rows = f.rows != 0;
  ll fs = bound_pos(f.sk, f.so, rows ? w.i : w.qf, w.i, w.pf, w.pl, rows);
  ll fe = bound_pos(f.ek, f.eo, rows ? w.i : w.ql, w.i, w.pf, w.pl, rows);
  if (f.use_range) {
    const ll key = __ldg(rk + w.i);
    if (f.desc ? key != LL_MAX : key >= 0) {  // NULL-key rows keep their peer block
      ll vf = w.pf, vl = w.pl;  // the partition's rows with a key (NULLs at the head ASC, the tail DESC)
      if (f.desc) vl = search_from(rk, w.pf, w.pl + 1, LL_MAX, false, w.pl + 1) - 1;
      else vf = search_from(rk, w.pf, w.pl + 1, 0, false, w.pf);
      if (f.sk == B_PRE || f.sk == B_FOL)
        fs = search_from(rk, vf, vl + 1, f.sk == B_FOL ? key + f.so : key - f.so, false, w.i);
      if (f.ek == B_PRE || f.ek == B_FOL)
        fe = search_from(rk, vf, vl + 1, f.ek == B_FOL ? key + f.eo : key - f.eo, true, w.i) - 1;
    }
  }
  Frame r;
  r.ne = fs <= fe && fs <= w.pl && fe >= w.pf;
  r.s = fs < w.pf ? w.pf : (fs > w.pl ? w.pl : fs);
  r.e = fe < w.pf ? w.pf : (fe > w.pl ? w.pl : fe);
  return r;
}

__device__ __forceinline__ ll frame_count(const int32_t* cnt, const Frame& fr) {
  if (!fr.ne) return 0;
  if (cnt == nullptr) return fr.e - fr.s + 1;  // every row valid
  return (ll)__ldg(cnt + fr.e) - (fr.s > 0 ? (ll)__ldg(cnt + fr.s - 1) : 0);
}

// min / max over the frame: (value bits, frame has a valid row)
template <typename V, bool MAX>
__device__ __forceinline__ void minmax(const Func& f, const Frame& fr, const ll* const* levels, ll* x, bool* ok) {
  V r;
  if (f.mm_mode == MODE_PREFIX) {
    r = from_bits<V>(__ldg(f.acc + fr.e));
  } else if (f.mm_mode == MODE_SUFFIX) {
    r = from_bits<V>(__ldg(f.acc + fr.s));
  } else if (f.mm_mode == MODE_LOOP) {
    r = masked_at<V, MAX>(f.gd, f.gv, fr.s);
    if (fr.e < fr.s) {
      r = mm_pick<V, MAX>(r, masked_at<V, MAX>(f.gd, f.gv, fr.e));
    } else {
      ll c = __ldg(f.gv + fr.s) != 0;
      for (ll y = fr.s + 1; y <= fr.e; ++y) {
        r = mm_pick<V, MAX>(r, masked_at<V, MAX>(f.gd, f.gv, y));
        c += __ldg(f.gv + y) != 0;
      }
      *ok = fr.ne && c > 0;
      *x = to_bits(r);
      return;
    }
  } else {  // the sparse table: level 0 is the masked lane itself
    const ll w = fr.e - fr.s + 1 > 1 ? fr.e - fr.s + 1 : 1;
    int lk = 63 - __clzll(w);  // floor(log2 w)
    if (lk > f.L - 1) lk = f.L - 1;
    const ll half = 1LL << lk;
    const ll e2 = fr.e - half + 1 > 0 ? fr.e - half + 1 : 0;
    if (lk == 0) {
      r = mm_pick<V, MAX>(masked_at<V, MAX>(f.gd, f.gv, fr.s), masked_at<V, MAX>(f.gd, f.gv, e2));
    } else {
      const ll* lv = levels[f.lv0 + lk - 1];
      r = mm_pick<V, MAX>(from_bits<V>(__ldg(lv + fr.s)), from_bits<V>(__ldg(lv + e2)));
    }
  }
  *ok = frame_count(f.cnt, fr) > 0;
  *x = to_bits(r);
}

constexpr int FBLOCK = 128;                 // funcs_kernel's block
constexpr int STAGE_WORDS = 48 * 1024 / 8 / FBLOCK;  // records this short are staged (48 KB a block)

__device__ __forceinline__ void funcs_row(const FuncArgs& a, ll i, ll* rec);

// one sorted row a thread; a staged block writes its rows' records out
// together, coalesced, once they are all in shared memory
__global__ void __launch_bounds__(FBLOCK) funcs_kernel(const FuncArgs a) {
  extern __shared__ ll s_rec[];
  for (ll base = (ll)blockIdx.x * FBLOCK; base < a.P; base += (ll)gridDim.x * FBLOCK) {
    const ll i = base + threadIdx.x;
    if (!a.staged) {
      if (i < a.P) funcs_row(a, i, a.rec + i * a.stride);
      continue;
    }
    if (i < a.P) funcs_row(a, i, s_rec + threadIdx.x * a.stride);
    __syncthreads();
    const ll rows = a.P - base < FBLOCK ? a.P - base : FBLOCK;
    const longlong2* src = (const longlong2*)s_rec;
    longlong2* dst = (longlong2*)(a.rec + base * a.stride);
    for (ll k = threadIdx.x; k < rows * a.stride / 2; k += FBLOCK) dst[k] = src[k];
    __syncthreads();
  }
}

__device__ __forceinline__ void funcs_row(const FuncArgs& a, ll i, ll* rec) {
  {
    const int32_t p = __ldg(a.pid + i), o = __ldg(a.oid + i);
    Row w;
    w.i = i;
    w.pf = __ldg(a.ppos + p);
    w.pl = (ll)__ldg(a.ppos + p + 1) - 1;
    w.qf = __ldg(a.opos + o);
    w.ql = (ll)__ldg(a.opos + o + 1) - 1;
    ll bw = 0;
    for (int q = 0; q < a.nf; ++q) {
      const Func f = a.f[q];
      ll x = 0, y = 0;  // a, and b when it is a word
      bool ok = true;   // b when it is a byte
      switch (f.code) {
        case F_RANK: {
          const ll psize = w.pl - w.pf + 1, rn = i - w.pf;
          switch (f.sub) {
            case 0: x = rn + 1; break;                   // row_number
            case 1: x = w.qf - w.pf + 1; break;          // rank
            case 2: x = (ll)o - __ldg(a.oid + w.pf) + 1; break;  // dense_rank
            case 3: {                                     // ntile (values >= 0: / is floor)
              const ll big = psize / f.k, rem = psize % f.k, cut = rem * (big + 1);
              x = (big > 0 ? (rn < cut ? rn / (big + 1) : rem + (rn - cut) / big) : rn) + 1;
              break;
            }
            case 4: x = w.ql - w.pf + 1; y = psize; break;  // cume_dist num / den
            default: x = w.qf - w.pf; y = psize - 1; break;  // percent_rank
          }
          break;
        }
        case F_SHIFT: {  // lead / lag: k is the signed offset
          const ll tg = i + f.k;
          const bool hit = tg >= 0 && tg < a.P && __ldg(a.pid + tg) == p;
          if (hit) {
            x = __ldg(f.gd + tg);
            ok = __ldg(f.gv + tg) != 0;
          } else if (f.dd != nullptr) {
            x = __ldg(f.dd + i);
            ok = __ldg(f.dv + i) != 0;
          } else {
            ok = false;
          }
          break;
        }
        case F_VALUE: {  // first / last / nth value
          const Frame fr = frame_of(f, w, a.rk);
          ll pos;
          bool in = fr.ne;
          if (f.sub == 0) {
            pos = fr.s;
          } else if (f.sub == 1) {
            pos = fr.e;
          } else {
            pos = fr.s + f.k - 1;
            in = fr.ne && pos <= fr.e;
            pos = pos < 0 ? 0 : (pos > a.P - 1 ? a.P - 1 : pos);
          }
          x = __ldg(f.gd + pos);
          ok = __ldg(f.gv + pos) != 0 && in;
          break;
        }
        case F_COUNT:
          x = frame_count(f.cnt, frame_of(f, w, a.rk));
          break;
        case F_SUM: {  // sub: 0 sum int64, 1 sum float64, 2 avg int64, 3 avg float64
          const Frame fr = frame_of(f, w, a.rk);
          const ll c = frame_count(f.cnt, fr);
          if (!fr.ne) {
            x = 0;
          } else if (f.sub & 1) {
            x = __double_as_longlong(__longlong_as_double(__ldg(f.sum + fr.e)) -
                                     (fr.s > 0 ? __longlong_as_double(__ldg(f.sum + fr.s - 1)) : 0.0));
          } else {
            x = (ll)((ull)__ldg(f.sum + fr.e) - (ull)(fr.s > 0 ? __ldg(f.sum + fr.s - 1) : 0));
          }
          ok = c > 0;
          y = c;
          break;
        }
        default: {  // F_MINMAX
          const Frame fr = frame_of(f, w, a.rk);
          if (f.mm_type == MM_I64) {
            if (f.is_max) minmax<ll, true>(f, fr, a.levels, &x, &ok);
            else minmax<ll, false>(f, fr, a.levels, &x, &ok);
          } else if (f.mm_type == MM_U64) {
            if (f.is_max) minmax<ull, true>(f, fr, a.levels, &x, &ok);
            else minmax<ull, false>(f, fr, a.levels, &x, &ok);
          } else {
            if (f.is_max) minmax<double, true>(f, fr, a.levels, &x, &ok);
            else minmax<double, false>(f, fr, a.levels, &x, &ok);
          }
          break;
        }
      }
      rec[f.a_slot] = x;
      if (f.b_kind == 1) bw |= (ll)(ok ? 1 : 0) << (8 * q);
      else if (f.b_kind == 2) rec[f.b_slot] = y;
    }
    // whole words only: a record's sectors are written in full
    rec[a.bw_slot] = bw;
    if (a.pad_slot >= 0) rec[a.pad_slot] = 0;
  }
}

// --- outputs in input order ----------------------------------------------------

struct Out {
  void* dst;
  int kind;  // 0 a record word, 1 a record byte, 2 the constant 1 (bool)
  int slot;
};

struct OutArgs {
  ll P;
  const int32_t* inv;
  const ll* rec;
  int stride;
  int no;
  Out o[MAXO];
};

constexpr int REC_REGS = 16;  // records this short are loaded whole, 16 bytes at a time, before the stores

__global__ void out_kernel(const OutArgs a) {
  GRID_LOOP(j, a.P) {
    const ll* rec = a.rec + (ll)__ldg(a.inv + j) * a.stride;
    if (a.stride <= REC_REGS) {
      ll v[REC_REGS];
#pragma unroll
      for (int k = 0; k < REC_REGS / 2; ++k) {
        if (2 * k < a.stride) {
          const longlong2 x = __ldg((const longlong2*)rec + k);
          v[2 * k] = x.x;
          v[2 * k + 1] = x.y;
        }
      }
      for (int q = 0; q < a.no; ++q) {
        const Out o = a.o[q];
        const int wslot = o.kind == 1 ? o.slot >> 3 : o.slot;
        ll x = 0;
#pragma unroll
        for (int k = 0; k < REC_REGS; ++k) x = k == wslot ? v[k] : x;
        if (o.kind == 0) ((ll*)o.dst)[j] = x;
        else if (o.kind == 1) ((uint8_t*)o.dst)[j] = (uint8_t)(x >> (8 * (o.slot & 7)));
        else ((uint8_t*)o.dst)[j] = 1;
      }
      continue;
    }
    for (int q = 0; q < a.no; ++q) {
      const Out o = a.o[q];
      if (o.kind == 0) ((ll*)o.dst)[j] = __ldg(rec + o.slot);
      else if (o.kind == 1) ((uint8_t*)o.dst)[j] = __ldg((const uint8_t*)rec + o.slot);
      else ((uint8_t*)o.dst)[j] = 1;
    }
  }
}

template <typename V, bool MAX>
int seg_scan(int rev, const ScanArgs& a, unsigned nb, cudaStream_t s) {
  if (rev) scan_kernel<SegOp<V, MAX>, LoadSeg<V, MAX, true>, StoreSeg<true>><<<nb, BLOCK, 0, s>>>(a);
  else scan_kernel<SegOp<V, MAX>, LoadSeg<V, MAX, false>, StoreSeg<false>><<<nb, BLOCK, 0, s>>>(a);
  CHECK_LAUNCH();
  return 0;
}

template <typename V, bool MAX>
int levels_of(ll P, const ll* gd, const uint8_t* gv, int L, const int64_t* lv, cudaStream_t s) {
  for (int k = 1; k < L; ++k) {
    level_kernel<V, MAX><<<blocks_for(P), BLOCK, 0, s>>>(P, gd, gv, k == 1 ? nullptr : (const ll*)lv[k - 2],
                                                         1LL << (k - 1), (ll*)lv[k - 1]);
    CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

extern "C" {

int64_t tt_win_loop_width() { return LOOP_W; }
int64_t tt_win_max_funcs() { return MAXF; }

// int64 words of the look-back scratch for P rows (zero when allocated)
int64_t tt_win_scratch_words(int64_t P) { return 2 + 2 * ((P + TILE - 1) / TILE); }

// One gather pass. words: nw rows of 3 words (address, kind 0 int32 / 1
// int64, address of its sorted rows); gathers: ng rows of 8 words (data,
// valid, out data, out valid, gmin, gmax, mode, desc), of which the pass
// moves `parts` (1 data, 2 valid bytes, 3 both); inv (null: not in this
// pass): the inverse permutation.
int tt_win_gather(int64_t P, const int32_t* perm, int nw, const int64_t* words, int ng, const int64_t* gathers,
                  int parts, int32_t* inv, void* stream) {
  if (P < 1 || P >= (1LL << 31) || nw < 0 || ng < 0 || parts < 0 || parts > 3) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  for (int w0 = 0, g0 = 0, first = 1; first || w0 < nw || g0 < ng; first = 0) {
    GatherArgs a = {};
    a.P = P;
    a.perm = perm;
    a.inv = first ? inv : nullptr;
    a.nw = nw - w0 < MAXW ? nw - w0 : MAXW;
    a.ng = ng - g0 < MAXG ? ng - g0 : MAXG;
    a.parts = parts;
    for (int q = 0; q < a.nw; ++q) {
      const int64_t* x = words + 3 * (w0 + q);
      a.w[q] = Word{(const void*)x[0], x[1]};
      a.sw[q] = (void*)x[2];
    }
    for (int g = 0; g < a.ng; ++g) {
      const int64_t* x = gathers + 8 * (g0 + g);
      if (x[6] < 0 || x[6] > 2) return -1;
      a.g[g] = Gather{(const void*)x[0], (const uint8_t*)x[1], (void*)x[2], (uint8_t*)x[3], x[4], x[5], (int)x[6],
                      (int)x[7]};
    }
    gather_kernel<<<(unsigned)((P + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(a);
    CHECK_LAUNCH();
    w0 += a.nw;
    g0 += a.ng;
  }
  return 0;
}

// sorted words: nw pairs (address, kind), partition words first
int tt_win_bounds(int64_t P, int nw, int npw, const int64_t* words, int32_t* pid, int32_t* oid, int32_t* ppos,
                  int32_t* opos, int64_t* ws, void* stream) {
  if (P < 1 || P >= (1LL << 31) || nw < 1 || nw > MAXW || npw < 1 || npw > nw || ws == nullptr) return -1;
  BoundsArgs a = {};
  a.P = P;
  a.nw = nw;
  a.npw = npw;
  for (int q = 0; q < nw; ++q) a.w[q] = Word{(const void*)words[2 * q], words[2 * q + 1]};
  a.pid = pid;
  a.oid = oid;
  a.ppos = ppos;
  a.opos = opos;
  a.ws = (ll*)ws;
  bounds_kernel<<<(unsigned)((P + TILE - 1) / TILE), BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// kind: S_PAIR_I64 / S_PAIR_F64 (cnt and sums), S_COUNT (cnt), S_SEG +
// (mm_type * 4 + is_max * 2 + rev) (the min / max accumulator in `out`)
int tt_win_scan(int kind, int64_t P, const int64_t* gd, const uint8_t* gv, const int32_t* pid, int32_t* cnt,
                int64_t* out, int64_t* ws, void* stream) {
  if (P < 1 || gv == nullptr || ws == nullptr) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const ScanArgs a{P, (const ll*)gd, gv, pid, cnt, (ll*)out, (ll*)ws};
  const unsigned nb = (unsigned)((P + TILE - 1) / TILE);
  switch (kind) {
    case S_PAIR_I64:
      if (gd == nullptr || cnt == nullptr || out == nullptr) return -1;
      scan_kernel<AddOp, LoadPair, StorePair><<<nb, BLOCK, 0, s>>>(a);
      break;
    case S_PAIR_F64:
      if (gd == nullptr || cnt == nullptr || out == nullptr) return -1;
      scan_kernel<AddF64Op, LoadPair, StorePair><<<nb, BLOCK, 0, s>>>(a);
      break;
    case S_COUNT: {
      if (cnt == nullptr) return -1;
      ScanArgs c = a;
      c.out = nullptr;
      scan_kernel<AddOp, LoadCount, StorePair><<<nb, BLOCK, 0, s>>>(c);
      break;
    }
    default: {
      const int m = kind - S_SEG;
      if (m < 0 || m >= 12 || gd == nullptr || pid == nullptr || out == nullptr) return -1;
      const int type = m >> 2, is_max = (m >> 1) & 1, rev = m & 1;
      if (type == MM_I64) return is_max ? seg_scan<ll, true>(rev, a, nb, s) : seg_scan<ll, false>(rev, a, nb, s);
      if (type == MM_U64) return is_max ? seg_scan<ull, true>(rev, a, nb, s) : seg_scan<ull, false>(rev, a, nb, s);
      return is_max ? seg_scan<double, true>(rev, a, nb, s) : seg_scan<double, false>(rev, a, nb, s);
    }
  }
  CHECK_LAUNCH();
  return 0;
}

// levels 1 .. L - 1 of a sparse table over the masked lane (gd, gv); lv:
// their L - 1 addresses
int tt_win_levels(int type, int is_max, int64_t P, const int64_t* gd, const uint8_t* gv, int L, const int64_t* lv,
                  void* stream) {
  if (P < 1 || L < 1 || L > MAXLV || type < 0 || type > 2) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const ll* d = (const ll*)gd;
  if (type == MM_I64) return is_max ? levels_of<ll, true>(P, d, gv, L, lv, s) : levels_of<ll, false>(P, d, gv, L, lv, s);
  if (type == MM_U64) return is_max ? levels_of<ull, true>(P, d, gv, L, lv, s) : levels_of<ull, false>(P, d, gv, L, lv, s);
  return is_max ? levels_of<double, true>(P, d, gv, L, lv, s) : levels_of<double, false>(P, d, gv, L, lv, s);
}

// funcs: nf rows of 26 words (code, sub, has_frame, rows, sk, so, ek, eo,
// use_range, desc, k, gd, gv, dd, dv, cnt, sum, acc, mm_type, is_max,
// mm_mode, L, lv0, a_slot, b_kind, b_slot); levels: nlv addresses. A
// record is n8 value words, then a byte word for each MAXF functions (the
// valid byte of function f at byte f % MAXF of word n8 + f / MAXF), then
// a padding word when that count is odd.
int tt_win_funcs(int64_t P, const int32_t* pid, const int32_t* oid, const int32_t* ppos, const int32_t* opos,
                 const int64_t* rk, int64_t* rec, int stride, int n8, int nf, const int64_t* funcs, int nlv,
                 const int64_t* levels, void* stream) {
  const int nbw = (nf + MAXF - 1) / MAXF;
  if (P < 1 || nf < 1 || n8 < 0 || stride < n8 + nbw || stride > n8 + nbw + 1 || nlv < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  for (int f0 = 0; f0 < nf; f0 += MAXF) {
    FuncArgs a = {};
    a.P = P;
    a.pid = pid;
    a.oid = oid;
    a.ppos = ppos;
    a.opos = opos;
    a.rk = (const ll*)rk;
    a.rec = (ll*)rec;
    a.stride = stride;
    a.bw_slot = n8 + f0 / MAXF;
    a.pad_slot = f0 == 0 && stride > n8 + nbw ? stride - 1 : -1;
    a.nf = nf - f0 < MAXF ? nf - f0 : MAXF;
    for (int q = 0; q < a.nf; ++q) {
      const int64_t* x = funcs + 26 * (f0 + q);
      Func& f = a.f[q];
      f.code = (int)x[0];
      f.sub = (int)x[1];
      f.has_frame = (int)x[2];
      f.rows = (int)x[3];
      f.sk = (int)x[4];
      f.so = x[5];
      f.ek = (int)x[6];
      f.eo = x[7];
      f.use_range = (int)x[8];
      f.desc = (int)x[9];
      f.k = x[10];
      f.gd = (const ll*)x[11];
      f.gv = (const uint8_t*)x[12];
      f.dd = (const ll*)x[13];
      f.dv = (const uint8_t*)x[14];
      f.cnt = (const int32_t*)x[15];
      f.sum = (const ll*)x[16];
      f.acc = (const ll*)x[17];
      f.mm_type = (int)x[18];
      f.is_max = (int)x[19];
      f.mm_mode = (int)x[20];
      f.L = (int)x[21];
      f.lv0 = (int)x[22];
      f.a_slot = (int)x[23];
      f.b_kind = (int)x[24];
      f.b_slot = (int)x[25];
      if (f.code < F_RANK || f.code > F_MINMAX || f.sk < 0 || f.sk > 4 || f.ek < 0 || f.ek > 4 ||
          (f.use_range && rk == nullptr) || (f.code == F_RANK && f.sub == 3 && f.k < 1))
        return -1;
    }
    // this launch's sparse-table levels, from the call's list (lv0 rebased)
    int lo = nlv, hi = 0;
    for (int q = 0; q < a.nf; ++q) {
      const Func& f = a.f[q];
      if (f.code != F_MINMAX || f.mm_mode != MODE_TABLE || f.L < 2) continue;
      lo = f.lv0 < lo ? f.lv0 : lo;
      hi = f.lv0 + f.L - 1 > hi ? f.lv0 + f.L - 1 : hi;
    }
    if (hi > nlv || hi - lo > MAXLV) return -1;
    for (int q = lo; q < hi; ++q) a.levels[q - lo] = (const ll*)levels[q];
    for (int q = 0; q < a.nf; ++q) a.f[q].lv0 -= lo < hi ? lo : 0;
    a.staged = nf <= MAXF && stride <= STAGE_WORDS && !(stride & 1);
    const size_t smem = a.staged ? (size_t)FBLOCK * stride * 8 : 0;
    ll grid = (P + FBLOCK - 1) / FBLOCK;
    if (grid > 1 << 20) grid = 1 << 20;
    funcs_kernel<<<(unsigned)grid, FBLOCK, smem, s>>>(a);
    CHECK_LAUNCH();
  }
  return 0;
}

// outs: no rows of 3 words (address, kind, slot)
int tt_win_out(int64_t P, const int32_t* inv, const int64_t* rec, int stride, int no, const int64_t* outs,
               void* stream) {
  if (P < 1 || no < 1 || stride < 2 || (stride & 1)) return -1;  // records of whole 16-byte units
  cudaStream_t s = (cudaStream_t)stream;
  for (int o0 = 0; o0 < no; o0 += MAXO) {
    OutArgs a = {};
    a.P = P;
    a.inv = inv;
    a.rec = (const ll*)rec;
    a.stride = stride;
    a.no = no - o0 < MAXO ? no - o0 : MAXO;
    for (int q = 0; q < a.no; ++q) {
      const int64_t* x = outs + 3 * (o0 + q);
      if (x[1] < 0 || x[1] > 2) return -1;
      a.o[q] = Out{(void*)x[0], (int)x[1], (int)x[2]};
    }
    out_kernel<<<blocks_for(P), BLOCK, 0, s>>>(a);
    CHECK_LAUNCH();
  }
  return 0;
}

}  // extern "C"
