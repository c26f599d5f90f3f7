// The segmented run scan of P7 (run_agg.cu): per value lane, the lane op's
// combine from every row to the end of its run, a run being a maximal
// stretch of rows with equal keys. P5 (seg_reduce.cu) shares the lane ops,
// their sentinels and combines only: its one sweep over the sorted rows
// scans every lane in one kernel with look-back carries, where this scan
// takes four launches (poison, heads, carries, the caller's suffix) and
// reads each lane twice. What holds P7 back is that: it is the next design
// to move onto one sweep.
//
// Lane l's value at row i is read at row o = order ? order[i] : i:
//
//   ok = mask[o] & valid_l[o]          (valid_l absent: ok = mask[o])
//   x  = count lane: ok ? 1 : 0; else ok ? data_l[o] : null_bits(op)
//
// null_bits is the reference's sentinel of a row without ok (0 for sums,
// where(ok, d, big)'s big for min / max). The scan, over tiles of TILE
// rows:
//
//   poison_kernel  per float-sum lane, the first row holding a NaN or an
//                  infinity (the reference's prefix differences are NaN
//                  past it; the caller decides what that row poisons)
//   heads_kernel   per tile: the combine of the tile's rows before its
//                  first run start (the tail of a run that began in an
//                  earlier tile), and whether the tile has a run start
//   carry_kernel   per tile: the combine of the following tiles' heads up
//                  to and including the first tile with a run start — the
//                  rest of the tile's last run — by a segmented scan over
//                  the tiles, last to first, one block per lane
//   run_suffix     inside a caller's kernel, one block per tile: a reverse
//                  segmented inclusive scan (CUB BlockScan; a segment ends
//                  where the key changes) seeded with the tile's carry
//
// The combines: count and integer sums add modulo 2^64 (the reference's
// differences of wrapped prefixes, bit for bit); float sums add in a
// fixed tree order (deterministic; they differ from prefix differences by
// rounding only); min / max compare signed, unsigned (uint64 bits) or as
// floats with a NaN winning (jnp.minimum / jnp.maximum propagate NaN).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {
namespace seg_scan {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;
constexpr int MAXL = 32;
constexpr ll I64_MAX = 0x7fffffffffffffffLL;
constexpr ull I64_MIN_BITS = 0x8000000000000000ULL;
constexpr ull INF_BITS = 0x7ff0000000000000ULL;
constexpr ull NINF_BITS = 0xfff0000000000000ULL;
constexpr ull QNAN_BITS = 0x7ff8000000000000ULL;

enum Op : int {
  OP_COUNT = 0, OP_SUM_I64 = 1, OP_SUM_U64 = 2, OP_SUM_F64 = 3, OP_MIN_I64 = 4, OP_MAX_I64 = 5,
  OP_MIN_U64 = 6, OP_MAX_U64 = 7, OP_MIN_F64 = 8, OP_MAX_F64 = 9,
};

__host__ __device__ __forceinline__ bool is_sum(int op) { return op <= OP_SUM_F64; }

__device__ __forceinline__ double f64(ull b) { return __longlong_as_double((ll)b); }
__device__ __forceinline__ ull bits(double x) { return (ull)__double_as_longlong(x); }

// the value a row with mask & ~valid folds (the reference's sentinel)
__device__ __forceinline__ ull null_bits(int op) {
  switch (op) {
    case OP_MIN_I64: case OP_MIN_U64: return (ull)I64_MAX;
    case OP_MAX_I64: case OP_MAX_U64: return I64_MIN_BITS;
    case OP_MIN_F64: return INF_BITS;
    case OP_MAX_F64: return NINF_BITS;
    default: return 0ULL;
  }
}

__device__ __forceinline__ ull identity(int op) {
  switch (op) {
    case OP_MIN_U64: return ~0ULL;
    case OP_MAX_U64: return 0ULL;
    default: return null_bits(op);
  }
}

__device__ __forceinline__ ull combine(int op, ull a, ull b) {
  switch (op) {
    case OP_SUM_F64: return bits(f64(a) + f64(b));
    case OP_MIN_I64: return (ll)a < (ll)b ? a : b;
    case OP_MAX_I64: return (ll)a > (ll)b ? a : b;
    case OP_MIN_U64: return a < b ? a : b;
    case OP_MAX_U64: return a > b ? a : b;
    case OP_MIN_F64: {
      const double x = f64(a), y = f64(b);
      if (x != x) return a;
      if (y != y) return b;
      return y < x ? b : a;
    }
    case OP_MAX_F64: {
      const double x = f64(a), y = f64(b);
      if (x != x) return a;
      if (y != y) return b;
      return y > x ? b : a;
    }
    default: return a + b;  // count and integer sums, modulo 2^64
  }
}

// the combine of one op, fixed at compile time: the per-tile reduce and
// scan instantiate one of these per op, with no switch inside CUB's loops
template <int OP>
struct Combine {
  __device__ __forceinline__ ull operator()(ull a, ull b) const { return combine(OP, a, b); }
};

struct MinOp {
  __device__ __forceinline__ ll operator()(ll a, ll b) const { return a < b ? a : b; }
};

// (segment starts here, value) under the lane's combine, a before b
struct Seg {
  int f;
  ull v;
};

template <int OP>
struct SegCombine {
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& b) const {
    Seg r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : combine(OP, a.v, b.v);
    return r;
  }
};

typedef cub::BlockScan<Seg, BLOCK> SegScan;
constexpr int CARRY_BLOCK = 512;
typedef cub::BlockScan<Seg, CARRY_BLOCK> CarryScan;
typedef cub::BlockReduce<ull, BLOCK> ValReduce;

// run CALL with the constexpr int O naming op's combine (count and the
// integer sums share one: addition modulo 2^64)
#define SEG_SCAN_BY_OP(op, CALL)                                \
  switch (op) {                                                 \
    case OP_SUM_F64: { constexpr int O = OP_SUM_F64; CALL; } break; \
    case OP_MIN_I64: { constexpr int O = OP_MIN_I64; CALL; } break; \
    case OP_MAX_I64: { constexpr int O = OP_MAX_I64; CALL; } break; \
    case OP_MIN_U64: { constexpr int O = OP_MIN_U64; CALL; } break; \
    case OP_MAX_U64: { constexpr int O = OP_MAX_U64; CALL; } break; \
    case OP_MIN_F64: { constexpr int O = OP_MIN_F64; CALL; } break; \
    case OP_MAX_F64: { constexpr int O = OP_MAX_F64; CALL; } break; \
    default: { constexpr int O = OP_SUM_I64; CALL; }              \
  }

struct Lanes {
  ll n;
  int nl;
  const ll* key;      // [n] the run key per row
  const int* order;   // [n] where row i's values are read, or null: at i
  const uint8_t* mask;
  int op[MAXL];
  const ull* data[MAXL];  // null for a count lane
  const uint8_t* valid[MAXL];  // null: ok = mask
  // scratch (layout below)
  ll* poison;
  ull* head;
  ull* carry;
  uint8_t* hasflag;
};

__device__ __forceinline__ bool is_first(const Lanes& s, ll i) { return i == 0 || s.key[i] != s.key[i - 1]; }
__device__ __forceinline__ bool is_last(const Lanes& s, ll i) { return i == s.n - 1 || s.key[i + 1] != s.key[i]; }

__device__ __forceinline__ ull value(const Lanes& s, int l, ll i) {
  const ll o = s.order != nullptr ? (ll)s.order[i] : i;
  const bool ok = s.mask[o] != 0 && (s.valid[l] == nullptr || s.valid[l][o] != 0);
  if (s.op[l] == OP_COUNT) return ok ? 1ULL : 0ULL;
  return ok ? s.data[l][o] : null_bits(s.op[l]);
}

// (poison starts at 0x7f7f... > n)
__global__ void poison_kernel(const Lanes s) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < s.n; i += (ll)gridDim.x * blockDim.x) {
    for (int l = 0; l < s.nl; ++l) {
      if (s.op[l] != OP_SUM_F64) continue;
      if (!isfinite(f64(value(s, l, i))) && i < s.poison[l])
        atomicMin(reinterpret_cast<long long*>(s.poison + l), (long long)i);
    }
  }
}

// the combine of lane l over this tile's rows [t0, stop), into head
template <int OP>
__device__ __forceinline__ void tile_head(const Lanes& s, int l, ll t0, ll stop, ValReduce::TempStorage& tmp) {
  ull acc = identity(OP);
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    if (i < stop) acc = combine(OP, acc, value(s, l, i));
  }
  const ull tot = ValReduce(tmp).Reduce(acc, Combine<OP>());
  if (threadIdx.x == 0) s.head[(ll)blockIdx.x * s.nl + l] = tot;
}

__global__ void heads_kernel(const Lanes s) {
  typedef cub::BlockReduce<ll, BLOCK> RMin;
  __shared__ union {
    typename RMin::TempStorage mn;
    ValReduce::TempStorage val;
  } tmp;
  __shared__ ll first_at;
  const ll t0 = (ll)blockIdx.x * TILE;
  const ll t1 = t0 + TILE < s.n ? t0 + TILE : s.n;
  ll mine = I64_MAX;
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    if (i < t1 && is_first(s, i) && i < mine) mine = i;
  }
  const ll m = RMin(tmp.mn).Reduce(mine, MinOp());
  if (threadIdx.x == 0) {
    first_at = m;
    s.hasflag[blockIdx.x] = (uint8_t)(m < t1);
  }
  __syncthreads();
  const ll stop = first_at < t1 ? first_at : t1;
  for (int l = 0; l < s.nl; ++l) {
    SEG_SCAN_BY_OP(s.op[l], tile_head<O>(s, l, t0, stop, tmp.val));
    __syncthreads();
  }
}

// the running prefix of carry_kernel's chunks (CUB calls it from the
// block's first warp; every lane of that warp keeps the same copy)
template <int OP>
struct CarryPrefix {
  Seg acc;
  __device__ __forceinline__ Seg operator()(const Seg& aggregate) {
    const Seg old = acc;
    acc = SegCombine<OP>()(acc, aggregate);
    return old;
  }
};

// carry[t] = R[t + 1], where R[u] = head[u] combined with R[u + 1] unless
// tile u has a run start: a segmented scan over the tiles from the last
// down, CARRY_BLOCK * ITEMS tiles a round
template <int OP>
__device__ __forceinline__ void tile_carries(const Lanes& s, int l, ll ntiles, CarryScan::TempStorage& tmp) {
  CarryPrefix<OP> prefix{{0, identity(OP)}};
  for (ll c = 0; c < ntiles; c += (ll)CARRY_BLOCK * ITEMS) {
    Seg items[ITEMS];
    for (int j = 0; j < ITEMS; ++j) {
      const ll r = c + threadIdx.x * ITEMS + j;
      const ll u = ntiles - 1 - r;
      items[j].f = r < ntiles ? s.hasflag[u] : 1;
      items[j].v = r < ntiles ? s.head[u * s.nl + l] : identity(OP);
    }
    CarryScan(tmp).InclusiveScan(items, items, SegCombine<OP>(), prefix);
    __syncthreads();
    for (int j = 0; j < ITEMS; ++j) {
      const ll r = c + threadIdx.x * ITEMS + j;
      const ll u = ntiles - 1 - r;
      if (r < ntiles && u >= 1) s.carry[(u - 1) * s.nl + l] = items[j].v;
    }
  }
  if (threadIdx.x == 0) s.carry[(ntiles - 1) * s.nl + l] = identity(OP);
}

// block l: lane l's carries, in time linear in the tiles (a walk per tile
// would be quadratic inside a run spanning many tiles, such as the masked
// tail of a padded stream)
__global__ void __launch_bounds__(CARRY_BLOCK) carry_kernel(const Lanes s, ll ntiles) {
  __shared__ CarryScan::TempStorage tmp;
  const int l = blockIdx.x;
  SEG_SCAN_BY_OP(s.op[l], tile_carries<O>(s, l, ntiles, tmp));
}

template <int OP>
__device__ __forceinline__ void tile_suffix(const Lanes& s, int l, ll tend_full, SegScan::TempStorage& tmp,
                                            ull (&v)[ITEMS]) {
  Seg items[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
    if (i >= s.n) {
      items[j].f = 1;
      items[j].v = identity(OP);
      continue;
    }
    const bool last = is_last(s, i);
    ull x = value(s, l, i);
    if (i == tend_full - 1 && !last) x = combine(OP, x, s.carry[(ll)blockIdx.x * s.nl + l]);
    items[j].f = last ? 1 : 0;
    items[j].v = x;
  }
  SegScan(tmp).InclusiveScan(items, items, SegCombine<OP>());
  for (int j = 0; j < ITEMS; ++j) v[j] = items[j].v;
}

// Lane l's combine from each of this block's tile rows to the end of its
// run: v[j] for row tend_full - 1 - (threadIdx.x * ITEMS + j), the
// identity past n. Called by every thread of a block of BLOCK threads,
// block b on tile b (tend_full = (b + 1) * TILE); it ends on a barrier, so
// tmp may be used again at once.
__device__ __forceinline__ void run_suffix(const Lanes& s, int l, ll tend_full, SegScan::TempStorage& tmp,
                                           ull (&v)[ITEMS]) {
  SEG_SCAN_BY_OP(s.op[l], tile_suffix<O>(s, l, tend_full, tmp, v));
  __syncthreads();
}

inline ll tiles(ll n) { return (n + TILE - 1) / TILE; }

// scratch words: poison (nl), head and carry (tiles * nl each), hasflag bytes
inline int64_t scratch_words(ll n, int nl) {
  const ll nt = tiles(n);
  return nl + 2 * nt * nl + (nt + 7) / 8;
}

inline void layout(Lanes& s, ull* scratch) {
  const ll nt = tiles(s.n);
  s.poison = (ll*)scratch;
  s.head = scratch + s.nl;
  s.carry = s.head + nt * s.nl;
  s.hasflag = (uint8_t*)(s.carry + nt * s.nl);
}

// poison, heads and carries on the stream; the caller's kernel then runs
// one block of BLOCK threads per tile (tiles(n) blocks) over run_suffix
inline int prepare(const Lanes& s, int n_sms, cudaStream_t st) {
  int rc = (int)cudaMemsetAsync(s.poison, 0x7f, sizeof(ll) * s.nl, st);
  if (rc) return rc;
  ll pb = (s.n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (pb > cap) pb = cap;
  poison_kernel<<<(unsigned)(pb < 1 ? 1 : pb), BLOCK, 0, st>>>(s);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const ll nt = tiles(s.n);
  heads_kernel<<<(unsigned)nt, BLOCK, 0, st>>>(s);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  carry_kernel<<<(unsigned)s.nl, CARRY_BLOCK, 0, st>>>(s, nt);
  return (int)cudaGetLastError();
}

}  // namespace seg_scan
}  // namespace
