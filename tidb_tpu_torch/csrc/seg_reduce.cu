// P5 seg_reduce: the sorted MPP aggregation — per-run totals over the
// rows sorted by a wide group code, validity and top-k score, and the
// result rows at the k picks.
//
// Replaces sorted_agg_stage of tidb_tpu/parallel/mpp.py:1655-1786: the
// group code (:1665-1673), seg_reduce (:1707-1750) and the rows of
// finish_topk (:1752-1759). At n_dev 1 one reduce is the final state. Over
// n_dev ranks (:1765-1786) the same entries run twice: a local reduce of
// the rank's rows (tt_sr_reduce without a score), then, after P2's
// exchange of the valid groups (csrc/exchange.cu), a final reduce of the
// fragments received: tt_sr_code_raw keys them (the exchanged key where
// the moved mask is set, INT64_MAX elsewhere), a count lane adds its
// counts, and the runs hold at most n_dev fragments. The steps:
//
//   tt_sr_code    code = sum over the keys of kd * stride (int64 wrap),
//                 kd = ((d - lo) floordiv step + 1) * v for an int key,
//                 (d + 1) * v for a dict-coded one; masked rows INT64_MAX
//                 (their keys are not read). Fused with compact.cuh's
//                 compaction: the M rows whose code is not INT64_MAX go to
//                 (comp, crow) in row order, and M with their OR/AND comes
//                 up to the host in one copy
//   (K8)          kernels/lex_sort sorts comp[:M] in the bits it varies in
//                 (a stable sort of the code puts the INT64_MAX rows last,
//                 in row order: they are sorted positions M .. N-1)
//   tt_sr_reduce  one sweep over the M sorted rows, tiles of RTILE rows: a
//                 block stages its keys (sorted position i: comp[perm[i]],
//                 with a row of halo each side) and row ids (crow[perm[i]])
//                 in shared memory; phase 1 folds every lane's rows into
//                 the tile's segmented aggregate (warp shuffles, one
//                 barrier for all lanes) and publishes it; the decoupled
//                 look-back gives each lane's carry (the run open at the
//                 tile's start), the last run start before the tile and
//                 each float-sum lane's first non-finite sorted position;
//                 phase 2 scans each lane again from that carry (no
//                 barrier) and the last row of every run writes the run's
//                 total at the run's first row. Each lane is gathered
//                 through the permutation once, in phase 1, which stores
//                 the values in sorted order for phase 2 to read back
//                 (each thread its own positions). Positions M .. N-1
//                 hold what tt_sr_fill wrote at every position (fkey
//                 INT64_MAX, fvalid 0, the floor score), launched behind
//                 the copy of M and the OR/AND, so that it runs while the
//                 host plans K8
//   (K6)          kernels/topk picks the min(kk, M) best of the first M
//                 scores, lax.top_k's order
//   tt_sr_emit    the picks over all N: K6's picks that rank at or above
//                 the floor, then the tail positions M, M+1, ... (floor
//                 scores, after every prefix row in position), then K6's
//                 picks below the floor (a negative NaN, INT64_MIN, an
//                 unsigned 0); and [fkey, fvalid, lanes...] at them into
//                 the rows of the packed result
//
// At sorted position i (row o) lane l's value is valid_l[o] ? data[o] :
// the sentinel (0 for sums, the reference's where(ok, d, big) value for
// min / max); a count lane: valid_l[o]. mask[o] holds at every position
// below M (a masked row's code is INT64_MAX). The combines are
// seg_scan.cuh's: integer sums modulo 2^64 (the reference's prefix
// differences, bit for bit, overflow or not), float sums in scan order
// (they differ from the reference's prefix differences by rounding only),
// min / max signed, unsigned (uint64) or as floats with NaN winning. A
// float-sum run that starts after the first non-finite sorted row totals
// the positive quiet NaN (the reference's prefix difference is NaN
// there), and one that sums to -0.0 totals +0.0 (as a sum started from
// +0.0, and the reference's difference of two prefixes, do: the score's
// order tells the two apart). The reference's distance doubling over runs
// of at most max_run rows (N for a local reduce, n_dev for the final one)
// folds its neutral once more into a uint64 min / max total unless row
// s + span - 1 lies in the run (span the least power of two >= max_run, s
// the run's first row). fvalid = run start & code != INT64_MAX, fkey = fvalid ? code :
// INT64_MAX, score = fvalid ? (desc ? s : -s) : floor at every position.
// The totals are written at the run starts below M only: every other
// position of a totals lane is left as the caller allocated it.
//
// Bound: bytes. The mask, the keys and lanes of the M kept rows and the
// picks' rows (fkey / fvalid / score are this module's own outputs). What
// holds it back, unfused Q3 at 4M rows (M 198,042) on an H100: the code
// kernel's compaction is latency-bound (a block's ticket, loads,
// look-back and done ticket one after another, about 4 waves of blocks:
// 0.06-0.08 ms wherever the rows' bytes would take 0.005), K6 over M
// (0.046), K8 over M (0.056), the sweep (0.034) and the fill of every
// position (0.021, behind the host read); and, a whole call, the host:
// the one read and K8's and K6's launches after it.
//
// Plain C interface (nvcc + ctypes): kernels/seg_reduce.py packs each
// call's arguments into one int64 word array; launches on the given
// stream, never synchronizes, returns the cudaError_t of the launches (0
// = success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "seg_scan.cuh"

namespace {

using namespace seg_scan;
using compact::LookBack;
using compact::P2;

constexpr int MAXK = 8;
constexpr int RBLOCK = 256;
constexpr int RITEMS = 4;
constexpr int RTILE = RBLOCK * RITEMS;  // sorted rows a reduce tile
constexpr int RWARPS = RBLOCK / 32;
constexpr int MAXS = MAXL + 1;  // look-back slots: the run starts, then one a lane
constexpr int FILL_PER_SM = 4;  // fill blocks an SM
constexpr ll FLAG = 1LL << 32;  // a lane slot's a: flag << 32 | first non-finite position
constexpr ll NONE = 0xffffffffLL;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ group code

struct CodeP {
  ll n;
  int nk;
  const uint8_t* mask;
  const ll* raw;  // the final reduce: code = mask ? raw : INT64_MAX (nk = 0)
  const ll* d[MAXK];
  const uint8_t* v[MAXK];
  ll lo[MAXK], step[MAXK], stride[MAXK];
  int is_int[MAXK];
};

// the codes of this thread's ITEMS rows, key by key, so that the rows'
// loads are in flight together; a masked row keeps INT64_MAX (its keys are
// not read). Latency-bound: 8 blocks an SM (a few spilled registers) ran
// faster than the 4 its registers allow
__global__ void __launch_bounds__(compact::BLOCK, 8) code_kernel(const CodeP p, const LookBack lb,
                                                              const compact::Out out, ll ntiles) {
  constexpr int IT = compact::ITEMS;
  __shared__ compact::Temp tmp;
  __shared__ unsigned s_tile;
  const ll tile = compact::take_tile(lb, &s_tile);
  ll row[IT];
  bool in[IT];
  ull code[IT];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    row[j] = compact::row_of(tile, j);
    in[j] = row[j] < p.n && p.mask[row[j]] != 0;
    code[j] = 0ULL;
  }
  if (p.raw != nullptr) {
#pragma unroll
    for (int j = 0; j < IT; ++j)
      if (in[j]) code[j] = (ull)p.raw[row[j]];
  }
  for (int k = 0; k < p.nk; ++k) {
    const ll* d = p.d[k];
    const uint8_t* v = p.v[k];
    const ll lo = p.lo[k], s = p.step[k];
    const ull stride = (ull)p.stride[k];
    const bool is_int = p.is_int[k] != 0;
#pragma unroll
    for (int j = 0; j < IT; ++j) {
      if (!in[j] || !v[row[j]]) continue;  // kd * v with v = 0
      ll kd;
      if (is_int) {
        const ll x = (ll)((ull)d[row[j]] - (ull)lo);
        ll q = s == 1 ? x : x / s;
        if (s != 1 && (x % s != 0) && ((x < 0) != (s < 0))) --q;  // floor division
        kd = (ll)((ull)q + 1ULL);
      } else {
        kd = (ll)((ull)d[row[j]] + 1ULL);
      }
      code[j] += (ull)kd * stride;
    }
  }
  ll x[IT];
  bool keep[IT];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    x[j] = in[j] ? (ll)code[j] : I64_MAX;
    keep[j] = x[j] != I64_MAX;
  }
  compact::compact_tile(lb, tile, ntiles, p.n, x, keep, out, tmp);
}

// ---------------------------------------------------------------- reduce

struct RedP {
  ll n, m;  // all rows; the kept ones (sorted positions below m)
  int nl, score_lane, desc;
  ll span;
  const int32_t* perm;  // K8's permutation of comp[:m]
  const int32_t* crow;
  const ll* ccode;
  int op[MAXL];
  const ull* data[MAXL];  // null for a count lane
  const uint8_t* valid[MAXL];  // null: every row valid
  ull* out[MAXL];
  ll* fkey;
  uint8_t* fvalid;
  ull* score;  // null: a local reduce
  ull* stage;  // [nl][m]: each lane's value at each sorted position, as phase 1 gathered it
  ll ntiles;   // scan tiles over [0, m)
};

struct Seg2 {
  bool f;
  ull v;
};

__device__ __forceinline__ Seg2 seg(int op, const Seg2& a, const Seg2& b) {
  return Seg2{a.f || b.f, b.f ? b.v : combine(op, a.v, b.v)};
}

__device__ __forceinline__ Seg2 shfl_down(const Seg2& x, int off) {
  return Seg2{__shfl_down_sync(FULL, (int)x.f, off) != 0, __shfl_down_sync(FULL, x.v, off)};
}

__device__ __forceinline__ Seg2 shfl_up(const Seg2& x, int off) {
  return Seg2{__shfl_up_sync(FULL, (int)x.f, off) != 0, __shfl_up_sync(FULL, x.v, off)};
}

// a look-back slot's combine: slot 0 the last run start (b, the max
// position; a its flag), a lane slot (flag << 32 | first non-finite
// position, value) under the lane's segmented combine
struct SlotOp {
  int op;  // -1: slot 0
  __device__ __forceinline__ P2 id() const { return op < 0 ? P2{0, -1} : P2{NONE, (ll)identity(op)}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const {
    if (op < 0) return P2{x.a | y.a, x.b > y.b ? x.b : y.b};
    const ll fx = x.a & NONE, fy = y.a & NONE;
    const ll f = (x.a | y.a) & FLAG;
    return P2{f | (fx < fy ? fx : fy), (y.a & FLAG) ? y.b : (ll)combine(op, (ull)x.b, (ull)y.b)};
  }
};

__device__ __forceinline__ ull lane_value(const RedP& p, int l, int32_t o) {
  const bool ok = p.valid[l] == nullptr || p.valid[l][o] != 0;
  if (p.op[l] == OP_COUNT) return ok ? 1ULL : 0ULL;
  return ok ? p.data[l][o] : null_bits(p.op[l]);
}

__host__ __device__ __forceinline__ ull floor_bits(int sop) {
  if (sop == OP_SUM_F64) return NINF_BITS;
  const ull v = (ull)(-I64_MAX);
  return sop == OP_SUM_U64 ? v ^ I64_MIN_BITS : v;
}

__device__ __forceinline__ ull score_bits(int sop, int desc, ull v) {
  if (sop == OP_SUM_F64) {
    const double x = f64(v);
    return bits(desc ? x : -x);
  }
  const ull s = desc ? v : 0ULL - v;
  return sop == OP_SUM_U64 ? s ^ I64_MIN_BITS : s;  // the unsigned order as int64
}

// every position as the tail holds it (fkey INT64_MAX, fvalid 0, the
// floor score): launched before M is known, the sweep then rewrites the
// first M
__global__ void fill_kernel(ll n, ll* fkey, uint8_t* fvalid, ull* score, ull fl) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    fkey[i] = I64_MAX;
    fvalid[i] = 0;
    if (score != nullptr) score[i] = fl;
  }
}

__global__ void __launch_bounds__(RBLOCK) reduce_kernel(const RedP p, const LookBack lb) {
  __shared__ ll s_key[RTILE + 2];  // sorted positions t0 - 1 .. t0 + RTILE
  __shared__ int32_t s_row[RTILE];
  __shared__ P2 s_warp[MAXS][RWARPS];  // each warp's aggregate per slot
  __shared__ P2 s_agg[MAXS];           // the tile's
  __shared__ P2 s_carry[MAXS];         // the look-back's exclusive prefix
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  const int S = p.nl + 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ll tile = compact::take_tile(lb, &s_tile);
  const ll t0 = tile * RTILE;
  {  // the permutation's entries first, then the gathers through them: each level's loads in flight together
    constexpr int STAGE = (RTILE + 2 + RBLOCK - 1) / RBLOCK;
    int32_t q[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = threadIdx.x + u * RBLOCK;
      const ll i = t0 - 1 + j;
      q[u] = j < RTILE + 2 && i >= 0 && i < p.m ? p.perm[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int j = threadIdx.x + u * RBLOCK;
      if (j >= RTILE + 2) continue;
      s_key[j] = q[u] >= 0 ? p.ccode[q[u]] : 0;
      if (j >= 1 && j <= RTILE && q[u] >= 0) s_row[j - 1] = p.crow[q[u]];
    }
  }
  __syncthreads();
  // this thread's sorted rows: i = t0 + r, r = threadIdx.x * RITEMS + jj
  const int r0 = threadIdx.x * RITEMS;
  bool ok[RITEMS], first[RITEMS], last[RITEMS];
  ll tpos = -1;  // the thread's last run start
#pragma unroll
  for (int jj = 0; jj < RITEMS; ++jj) {
    const ll i = t0 + r0 + jj;
    const ll key = s_key[r0 + jj + 1];
    ok[jj] = i < p.m;
    first[jj] = ok[jj] && (i == 0 || s_key[r0 + jj] != key);
    last[jj] = ok[jj] && (i == p.m - 1 || s_key[r0 + jj + 2] != key);
    if (!ok[jj]) continue;
    if (first[jj]) tpos = i;
    p.fvalid[i] = (uint8_t)first[jj];
    p.fkey[i] = first[jj] ? key : I64_MAX;
    if (p.score != nullptr && !first[jj]) p.score[i] = floor_bits(p.op[p.score_lane]);
  }
  // phase 1: each slot's warp aggregates, one barrier for all of them
  {
    ll wpos = tpos;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const ll o = __shfl_xor_sync(FULL, wpos, off);
      wpos = o > wpos ? o : wpos;
    }
    if (lane == 0) s_warp[0][w] = P2{wpos >= 0 ? 1 : 0, wpos};
  }
  for (int l = 0; l < p.nl; ++l) {
    const int op = p.op[l];
    Seg2 acc{false, identity(op)};
    unsigned fb = (unsigned)NONE;
#pragma unroll
    for (int jj = 0; jj < RITEMS; ++jj) {
      if (!ok[jj]) continue;
      const ull x = lane_value(p, l, s_row[r0 + jj]);
      p.stage[(ll)l * p.m + t0 + r0 + jj] = x;  // phase 2 reads it back here (this thread's own store)
      acc = first[jj] ? Seg2{true, x} : Seg2{acc.f, combine(op, acc.v, x)};
      if (op == OP_SUM_F64 && fb == (unsigned)NONE && !isfinite(f64(x))) fb = (unsigned)(t0 + r0 + jj);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // in order: lane i folds lane i + off after it
      const Seg2 o = shfl_down(acc, off);
      if (lane + off < 32) acc = seg(op, acc, o);
    }
    fb = __reduce_min_sync(FULL, fb);
    if (lane == 0) s_warp[1 + l][w] = P2{(acc.f ? FLAG : 0) | (ll)fb, (ll)acc.v};
  }
  __syncthreads();
  // the tile's aggregate per slot, published at once (tile 0: inclusive)
  for (int s = threadIdx.x; s < S; s += RBLOCK) {
    const SlotOp so{s == 0 ? -1 : p.op[s - 1]};
    P2 a = s_warp[s][0];
    for (int q = 1; q < RWARPS; ++q) a = so(a, s_warp[s][q]);
    s_agg[s] = a;
    compact::put_desc(lb.desc(tile * S + s), tile == 0 ? 2 : 1, a);
  }
  __syncthreads();
  for (int s = w; s < S; s += RWARPS) {  // warp w: slots w, w + RWARPS, ...
    const SlotOp so{s == 0 ? -1 : p.op[s - 1]};
    P2 c = so.id();
    if (tile > 0) {
      c = compact::look_back(lb, tile, S, s, so);
      if (lane == 0) compact::put_desc(lb.desc(tile * S + s), 2, so(c, s_agg[s]));
    }
    if (lane == 0) s_carry[s] = c;
  }
  __syncthreads();
  // each row's run start: the carry's, the warps' before this one, the
  // lanes' before this one, then the thread's own
  ll st[RITEMS];
  {
    ll pre = s_carry[0].b;
    for (int q = 0; q < w; ++q) pre = s_warp[0][q].b > pre ? s_warp[0][q].b : pre;
    ll inc = tpos;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const ll o = __shfl_up_sync(FULL, inc, off);
      if (lane >= off && o > inc) inc = o;
    }
    ll before = __shfl_up_sync(FULL, inc, 1);
    if (lane > 0 && before > pre) pre = before;
#pragma unroll
    for (int jj = 0; jj < RITEMS; ++jj) {
      if (first[jj]) pre = t0 + r0 + jj;
      st[jj] = pre;
    }
  }
  // phase 2: each lane scanned from its carry; a run's last row writes
  // the run's total at its first row
  for (int l = 0; l < p.nl; ++l) {
    const int op = p.op[l];
    const P2 c = s_carry[1 + l];
    Seg2 pre{(c.a & FLAG) != 0, (ull)c.b};
    ll fb = c.a & NONE;
    for (int q = 0; q < RWARPS; ++q) {
      const P2 a = s_warp[1 + l][q];
      if (q < w) pre = seg(op, pre, Seg2{(a.a & FLAG) != 0, (ull)a.b});
      if ((a.a & NONE) < fb) fb = a.a & NONE;  // the first non-finite position up to the tile's end
    }
    ull x[RITEMS];
    Seg2 t{false, identity(op)};
#pragma unroll
    for (int jj = 0; jj < RITEMS; ++jj) {
      x[jj] = ok[jj] ? p.stage[(ll)l * p.m + t0 + r0 + jj] : identity(op);
      t = first[jj] ? Seg2{true, x[jj]} : Seg2{t.f, combine(op, t.v, x[jj])};
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // inclusive, then shifted: the lanes before this one
      const Seg2 o = shfl_up(t, off);
      if (lane >= off) t = seg(op, o, t);
    }
    const Seg2 before = shfl_up(t, 1);
    if (lane > 0) pre = seg(op, pre, before);
    Seg2 acc = pre;
#pragma unroll
    for (int jj = 0; jj < RITEMS; ++jj) {
      if (!ok[jj]) continue;
      acc = first[jj] ? Seg2{true, x[jj]} : Seg2{acc.f, combine(op, acc.v, x[jj])};
      if (!last[jj]) continue;
      const ll e = t0 + r0 + jj, s = st[jj];
      ull v = acc.v;
      if (op == OP_SUM_F64 && fb < s) v = QNAN_BITS;  // a non-finite row sorts before the run
      if (op == OP_SUM_F64 && v == I64_MIN_BITS) v = 0ULL;  // -0.0: a sum from +0.0 (and a prefix difference) is +0.0
      if ((op == OP_MIN_U64 || op == OP_MAX_U64) && !(s + p.span - 1 <= e)) v = combine(op, v, null_bits(op));
      p.out[l][s] = v;
      if (l == p.score_lane && p.score != nullptr) p.score[s] = score_bits(op, p.desc, v);
    }
  }
  if (compact::last_block(lb, &s_last)) compact::reset(lb, p.ntiles * S);
}

// ------------------------------------------------------------------ emit

struct EmitP {
  ll kk, kp, m, n;  // picks; K6's picks over the first m; kept rows; all rows
  int nl, sop;
  const int32_t* pidx;  // [kp] K6's picks
  const ull* score;
  int32_t* idx;  // [kk] the picks over all n
  const ll* fkey;
  const uint8_t* fvalid;
  ll* rows;  // null: no rows
  ll row_stride;
  const ull* tot[MAXL];
};

// top_k's order of a score as a signed int64 (floats: IEEE total order)
__device__ __forceinline__ ll rank_of(int sop, ull v) {
  if (sop != OP_SUM_F64) return (ll)v;
  return (ll)v < 0 ? (ll)(v ^ (ull)I64_MAX) : (ll)v;
}

__global__ void emit_kernel(const EmitP p) {
  const ll floor_rank = rank_of(p.sop, floor_bits(p.sop));
  // K6's picks at or above the floor come first in its order: c of them
  ll lo = 0, hi = p.kp;
  while (lo < hi) {
    const ll mid = (lo + hi) >> 1;
    if (rank_of(p.sop, p.score[p.pidx[mid]]) >= floor_rank) lo = mid + 1; else hi = mid;
  }
  const ll c = lo;
  const ll tail = p.kk - c < p.n - p.m ? p.kk - c : p.n - p.m;
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < p.kk; t += (ll)gridDim.x * blockDim.x) {
    const ll i = t < c ? p.pidx[t] : (t < c + tail ? p.m + (t - c) : p.pidx[t - tail]);
    p.idx[t] = (int32_t)i;
    if (p.rows == nullptr) continue;
    p.rows[t] = p.fkey[i];
    p.rows[p.row_stride + t] = p.fvalid[i] ? 1 : 0;
    for (int l = 0; l < p.nl; ++l) p.rows[(2 + l) * p.row_stride + t] = (ll)p.tot[l][i];
  }
}

struct Words {
  const int64_t* w;
  int n;
  int at;
  int64_t operator()() { return at < n ? w[at++] : (at++, 0); }
  bool done() const { return at == n; }
};

unsigned grid_for(ll n, int n_sms, int per_sm) {
  ll blocks = (n + RBLOCK - 1) / RBLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * per_sm;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

int take_out(Words& t, compact::Out& out, LookBack& lb) {
  out.comp = (ll*)t();
  out.crow = (int32_t*)t();
  out.tail = nullptr;
  out.res = (ll*)t();
  lb.ws = (ll*)t();
  return out.comp && out.crow && out.res && lb.ws ? 0 : -1;
}

int launch_code(const CodeP& p, const compact::Out& out, const LookBack& lb, cudaStream_t st) {
  const ll nt = compact::tiles(p.n);
  code_kernel<<<(unsigned)nt, compact::BLOCK, 0, st>>>(p, lb, out, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch words of the compaction over n rows, and of the reduce over m
// sorted rows with nl lanes
extern "C" int64_t tt_sr_code_scratch(int64_t n) { return compact::compact_words(compact::tiles(n)); }
extern "C" int64_t tt_sr_reduce_scratch(int64_t m, int nl) {
  return compact::scratch_words(((m + RTILE - 1) / RTILE) * (nl + 1));
}

// words: n, nkeys, mask, per key (d, v, lo, step, stride, is_int), comp, crow, res, scratch
extern "C" int tt_sr_code(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  CodeP p;
  p.n = t();
  p.nk = (int)t();
  if (p.n < 1 || p.n > 0x7fffffffLL || p.nk < 1 || p.nk > MAXK) return -1;
  p.mask = (const uint8_t*)t();
  p.raw = nullptr;
  for (int k = 0; k < p.nk; ++k) {
    p.d[k] = (const ll*)t();
    p.v[k] = (const uint8_t*)t();
    p.lo[k] = t();
    p.step[k] = t();
    p.stride[k] = t();
    p.is_int[k] = (int)t();
    if (p.step[k] < 1) return -1;
  }
  compact::Out out;
  LookBack lb;
  if (take_out(t, out, lb) != 0 || !t.done()) return -1;
  return launch_code(p, out, lb, (cudaStream_t)stream);
}

// words: n, mask, key, comp, crow, res, scratch
extern "C" int tt_sr_code_raw(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  CodeP p;
  p.n = t();
  if (p.n < 1 || p.n > 0x7fffffffLL) return -1;
  p.nk = 0;
  p.mask = (const uint8_t*)t();
  p.raw = (const ll*)t();
  compact::Out out;
  LookBack lb;
  if (p.raw == nullptr || take_out(t, out, lb) != 0 || !t.done()) return -1;
  return launch_code(p, out, lb, (cudaStream_t)stream);
}

// words: n, m, nl, score_lane, desc, span, perm, crow, comp, per lane (op, data, valid, out),
//        fkey, fvalid, score (0: none), stage (nl * m words), scratch
extern "C" int tt_sr_reduce(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  RedP p;
  p.n = t();
  p.m = t();
  p.nl = (int)t();
  p.score_lane = (int)t();
  p.desc = (int)t();
  p.span = t();
  if (p.n < 1 || p.m < 0 || p.m > p.n || p.nl < 1 || p.nl > MAXL || p.score_lane < 0 || p.score_lane >= p.nl ||
      p.span < 1 || (p.span & (p.span - 1)) != 0)
    return -1;
  p.perm = (const int32_t*)t();
  p.crow = (const int32_t*)t();
  p.ccode = (const ll*)t();
  for (int l = 0; l < p.nl; ++l) {
    p.op[l] = (int)t();
    p.data[l] = (const ull*)t();
    p.valid[l] = (const uint8_t*)t();
    p.out[l] = (ull*)t();
    if (p.op[l] < OP_COUNT || p.op[l] > OP_MAX_F64 || (p.op[l] != OP_COUNT && p.data[l] == nullptr)) return -1;
  }
  if (!is_sum(p.op[p.score_lane])) return -1;
  p.fkey = (ll*)t();
  p.fvalid = (uint8_t*)t();
  p.score = (ull*)t();
  p.stage = (ull*)t();
  LookBack lb;
  lb.ws = (ll*)t();
  if (!t.done() || (p.m > 0 && p.stage == nullptr)) return -1;
  p.ntiles = (p.m + RTILE - 1) / RTILE;
  (void)n_sms;
  if (p.ntiles == 0) return 0;
  reduce_kernel<<<(unsigned)p.ntiles, RBLOCK, 0, (cudaStream_t)stream>>>(p, lb);
  return (int)cudaGetLastError();
}

// words: n, fkey, fvalid, score (0: none), score op
extern "C" int tt_sr_fill(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 5 || w[0] < 1) return -1;
  const int sop = (int)w[4];
  if (w[3] != 0 && !is_sum(sop)) return -1;
  fill_kernel<<<grid_for(w[0], n_sms, FILL_PER_SM), RBLOCK, 0, (cudaStream_t)stream>>>(
      w[0], (ll*)w[1], (uint8_t*)w[2], (ull*)w[3], w[3] != 0 ? floor_bits(sop) : 0ULL);
  return (int)cudaGetLastError();
}

// words: kk, kp, m, n, nl, score op, picks (K6's), score, idx, fkey, fvalid, rows (0: none),
//        row_stride, per lane the totals
extern "C" int tt_sr_emit(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  EmitP p;
  p.kk = t();
  p.kp = t();
  p.m = t();
  p.n = t();
  p.nl = (int)t();
  p.sop = (int)t();
  if (p.kk < 0 || p.kp < 0 || p.kp > p.m || p.kk > p.n || p.kp > p.kk || p.nl < 0 || p.nl > MAXL ||
      (p.kk > p.kp + (p.n - p.m)))
    return -1;
  p.pidx = (const int32_t*)t();
  p.score = (const ull*)t();
  p.idx = (int32_t*)t();
  p.fkey = (const ll*)t();
  p.fvalid = (const uint8_t*)t();
  p.rows = (ll*)t();
  p.row_stride = t();
  for (int l = 0; l < p.nl; ++l) p.tot[l] = (const ull*)t();
  if (!t.done()) return -1;
  if (p.kk == 0) return 0;
  emit_kernel<<<grid_for(p.kk, n_sms, 16), RBLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
