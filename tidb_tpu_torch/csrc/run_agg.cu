// P7 run_agg: per-run totals over a key-sorted stream, the clustered
// aggregation of a fused MPP chain.
//
// Replaces tidb_tpu/parallel/mpp.py:1850-1913 (clustered_agg_stage up to
// its top-k, with _topk_score :1984). The stream holds the group level's
// probe key kd (equal keys are contiguous runs), the chain's row mask and
// up to 16 value lanes; lane l's value at row i is
//
//   ok = mask[i] & valid_l[i]          (valid_l absent: ok = mask[i])
//   x  = ok ? (data_l absent ? 1 : data_l[i]) : 0
//
// The reference takes, at every row, c[rend] - c[i - 1] over the lane's
// prefix sum c: the sum of x from i to the end of i's run. This kernel
// computes the same suffix-in-run sums directly, and per row
//
//   gpos  = cnt > 0 ? rid_sum // cnt : -1
//   valid = run start & cnt > 0
//   score = valid ? (desc ? s : -s) : floor
//
// (cnt the match-count lane, rid_sum the row-id lane, s the ORDER BY
// lane; floor -INT64_MAX or -inf).
//
// Design: one reverse sweep, one launch. Tiles of TILE rows (ITEMS
// consecutive rows a thread) are taken by ticket from the last tile to the
// first (ticket v: tile ntiles - 1 - v), so that a tile's look-back runs
// over the tiles after it in the stream. A tile reads its keys (with one
// row each side: run starts and ends), its mask and every lane's valid
// bytes at once (4-byte loads, kept as one bit a lane and row), then lane
// by lane the data where ok. It scans each lane in reverse within the
// tile — per thread, a warp's shuffles, the warps' aggregates in shared
// memory (one barrier a lane) — and stages every row's sum in shared
// memory, from which the next lane's pass writes it out, 32 consecutive
// rows a warp store. The scan's value at the tile's first row is the
// tile's segmented aggregate (whether it holds a run end, and the lane's
// sum from its first row to its first run end), published in that lane's
// look-back slot (compact.cuh's descriptors, one slot a lane and tile) —
// as inclusive at once when the tile holds a run end, since nothing
// beyond that end can change it. The carry, the rest of the tile's last
// run beyond the tile, seeds each row's sum before it is staged: the last
// warp reads the AHEAD rows after the tile, and where the next run end
// lies among them (every tile of Q3's stream, whose runs are a few rows)
// the carry is their sum and no tile waits on another. Otherwise (a run
// longer than AHEAD rows past the tile) the tile's warps look back for the
// carries (compact::look_back, as P5's reduce_kernel does forward) and
// the rows after the tile's last run end take it then (a second write of
// those rows). The count, row-id and score lanes' sums stay in shared
// memory for gpos, valid and score, staged and written the same way. The
// adds are compiled for integer and float lanes apart. The sweep is
// latency-bound (a block's ticket, loads, one barrier a lane and its done
// ticket follow one another), so its time falls with the blocks in flight:
// five an SM (MIN_BLOCKS; 48 registers with 12 bytes spilled, 43 KB of
// shared memory; four, at 60 registers, ran slower on Q3's call).
//
// Integer lanes add in unsigned 64-bit arithmetic: a run sum equals the
// reference's difference of wrapped prefixes bit for bit, prefix overflow
// or not. Float lanes differ from the reference's prefix differences by
// rounding only; their order is fixed except where a run's carry comes by
// look-back, which folds whatever the tiles after it have published (a
// run longer than AHEAD rows past a tile may round differently from call
// to call). A -0.0 adds as +0.0 (a sum from +0.0, as the reference's
// direct run sums and prefix differences give). Where a NaN or an
// infinity lies before the row in the stream the reference's prefix
// difference is NaN, and so is the kernel's: a reverse sweep cannot see
// the rows before its tile, so a tile that meets a non-finite value of a
// float-sum lane raises the lane's poison word (atomicMax of n - row, 0
// meaning none) and the launch's last block (by the done ticket) writes
// the positive quiet NaN at every later row of that lane, and the score
// there — a fix-up that runs only when the data holds a non-finite value
// (one block: slow for a long poisoned tail, free otherwise). Q3's call
// has no float-sum lane (decimals are scaled int64); the card's batteries
// hold float lanes. The last block then sets the look-back scratch and the
// poison words back to zero (kernels/tables.stream_scratch allocates them
// zeroed).
//
// Bound: bytes. Every input is read once (data only where ok; the AHEAD
// rows after a tile a second time) and every output written once, but for
// the rows after a tile's last run end where the carry came by look-back.
//
// Plain C interface (nvcc + ctypes): kernels/run_agg.py packs the
// arguments into one int64 word array; launches on the given stream, never
// synchronizes, returns the cudaError_t of the launch (0 = success) or -1
// for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "compact.cuh"
#include "seg_scan.cuh"

namespace {

using namespace seg_scan;
using compact::LookBack;
using compact::P2;

constexpr int MAX_LANES = 16;
constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;  // rows a tile
constexpr int WARPS = BLOCK / 32;
constexpr int MIN_BLOCKS = 5;  // 48 registers (12 bytes spilled), 43 KB of shared memory: five blocks an SM
constexpr int AHEAD = 32;  // rows after a tile its last warp reads for the carry
constexpr int SROW = BLOCK + 32 / ITEMS;  // a staging row (8-byte words): no bank conflict either way
constexpr int POISON = MAX_LANES;  // scratch words before the look-back's: a poison word a lane
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  ll n, ntiles;
  int nl, cnt_lane, rid_lane, score_lane, desc;
  const ll* key;
  const uint8_t* mask;
  int op[MAX_LANES];
  const ull* data[MAX_LANES];      // null for a count lane
  const uint8_t* valid[MAX_LANES];  // null: ok = mask
  ull* out[MAX_LANES];
  ll* gpos;
  uint8_t* vout;
  ull* score;
  ull* poison;  // [MAX_LANES] n - a float-sum lane's first non-finite row; 0: none
};

// (a run end lies in the rows, their value): outer holds rows further
// from the row being summed than inner does
struct Seg2 {
  bool f;
  ull v;
};

// a lane's add: count and integer lanes modulo 2^64, float lanes as doubles
// (seg_scan.cuh's combines of P7's three ops, fixed at compile time)
template <bool F>
__device__ __forceinline__ ull add(ull a, ull b) {
  return F ? bits(f64(a) + f64(b)) : a + b;
}

template <bool F>
__device__ __forceinline__ Seg2 seg(const Seg2& outer, const Seg2& inner) {
  return Seg2{outer.f || inner.f, inner.f ? inner.v : add<F>(outer.v, inner.v)};
}

__device__ __forceinline__ Seg2 shfl_down(const Seg2& x, int off) {
  return Seg2{__shfl_down_sync(FULL, (int)x.f, off) != 0, __shfl_down_sync(FULL, x.v, off)};
}

// a look-back slot (a: the tiles hold a run end; b: the value) under the
// lane's segmented combine; x lies later in the stream than y (the tickets
// run from the last tile to the first)
struct RunOp {
  int op;
  __device__ __forceinline__ P2 id() const { return P2{0, (ll)identity(op)}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const {
    return P2{x.a | y.a, y.a ? y.b : (ll)combine(op, (ull)x.b, (ull)y.b)};
  }
};

__device__ __forceinline__ ll floor_div(ll a, ll c) {
  if (a >= 0 && a <= 0xffffffffLL && c <= 0xffffffffLL) return (ll)((unsigned)a / (unsigned)c);
  ll g = a / c;
  if ((a % c != 0) && ((a < 0) != (c < 0))) --g;
  return g;
}

static_assert(MAX_LANES * ITEMS <= 64, "a thread's valid bits fit one word");
static_assert(AHEAD <= 32, "the look-ahead is one warp's rows");

// bit j: byte r0 + j of b is not 0 (0 past n), from one 4-byte load where
// the bytes are aligned
__device__ __forceinline__ unsigned byte_bits(const uint8_t* b, ll r0, ll n) {
  unsigned r = 0;
  if (ITEMS == 4 && r0 + 3 < n && ((uintptr_t)(b + r0) & 3) == 0) {
    const unsigned w = *(const unsigned*)(b + r0);
#pragma unroll
    for (int j = 0; j < 4; ++j) r |= (unsigned)((w >> (8 * j)) & 0xFFu ? 1 : 0) << j;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) r |= (unsigned)(r0 + j < n && b[r0 + j] != 0) << j;
  }
  return r;
}

// lane l's data at the rows whose ok bit is set (a count lane: 1), 0 elsewhere
__device__ __forceinline__ void load_lane(const Params& p, int l, ll r0, unsigned ok, ull (&x)[ITEMS]) {
  const ull* d = p.data[l];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) x[j] = (ok >> j) & 1u ? (d == nullptr ? 1ULL : d[r0 + j]) : 0ULL;
}

// a float lane's -0.0 as +0.0 (a sum from +0.0); a non-finite row raises
// the lane's poison word
__device__ __forceinline__ void fix_floats(const Params& p, int l, ll r0, ull (&x)[ITEMS]) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (x[j] == I64_MIN_BITS) {
      x[j] = 0ULL;
    } else if (!isfinite(f64(x[j]))) {
      atomicMax(p.poison + l, (ull)(p.n - (r0 + j)));
    }
  }
}

// rows t0 .. t0 + TILE - 1 from a staging buffer (row t0 + q at (q % ITEMS)
// * SROW + q / ITEMS) to dst: a warp's stores are 32 consecutive rows
__device__ __forceinline__ void flush(const ull* buf, ull* dst, ll t0, ll n) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int q = threadIdx.x + BLOCK * k;
    if (t0 + q < n) dst[t0 + q] = buf[(q % ITEMS) * SROW + q / ITEMS];
  }
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) run_kernel(const Params p, const LookBack lb) {
  __shared__ ull s_y[2][ITEMS * SROW];  // a lane's row sums, staged for coalesced stores (lanes alternate)
  __shared__ Seg2 s_warp[2][WARPS];     // a lane's warp aggregates (lanes alternate buffers)
  __shared__ P2 s_agg[MAX_LANES];       // the tile's aggregate of each lane
  __shared__ P2 s_carry[MAX_LANES];     // each lane's carry: the rest of the tile's last run
  __shared__ int s_end[WARPS];          // each warp's last run end
  __shared__ int s_ahead;               // rows after the tile up to its next run end; -1: not within AHEAD
  __shared__ unsigned s_tile;
  __shared__ int s_last;
  __shared__ ull s_role[3][ITEMS * SROW];  // the count, row-id and score lanes' sums (registers would cost a block an SM)
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ll v = compact::take_tile(lb, &s_tile);
  const ll t0 = (p.ntiles - 1 - v) * TILE, t1 = t0 + TILE;
  const ll r0 = t0 + (ll)threadIdx.x * ITEMS;  // this thread's first row
  bool first[ITEMS], last[ITEMS];
  int tend = -1;  // this thread's last run end
  ull oks = 0;  // bit l * ITEMS + j: lane l's ok (mask & valid_l) at row r0 + j
  {
    ll k[ITEMS + 2];  // rows r0 - 1 .. r0 + ITEMS
#pragma unroll
    for (int q = 0; q < ITEMS + 2; ++q) {
      const ll i = r0 - 1 + q;
      k[q] = i >= 0 && i < p.n ? p.key[i] : 0;
    }
    const unsigned mbits = byte_bits(p.mask, r0, p.n);
#pragma unroll
    for (int l = 0; l < MAX_LANES; ++l)  // every lane's valid bytes now: a lane's data loads wait on nothing else
      if (l < p.nl) oks |= (ull)(p.valid[l] == nullptr ? mbits : byte_bits(p.valid[l], r0, p.n) & mbits) << (l * ITEMS);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const ll i = r0 + j;
      const bool in = i < p.n;
      first[j] = in && (i == 0 || k[j] != k[j + 1]);
      last[j] = in && (i == p.n - 1 || k[j + 2] != k[j + 1]);
      if (last[j]) tend = (int)i;
    }
  }
  const int wend = __reduce_max_sync(FULL, tend);
  if (lane == 0) s_end[w] = wend;
  // the last warp: how many rows after the tile its last run goes on (the
  // rows up to the next run end, when it lies within AHEAD rows)
  int ahead = 0;
  if (w == WARPS - 1) {
    if (t1 < p.n) {
      const ll i = t1 + lane;
      const bool end = lane < AHEAD && i < p.n && (i == p.n - 1 || p.key[i] != p.key[i + 1]);
      const unsigned e = __ballot_sync(FULL, end);
      ahead = e ? __ffs(e) : -1;
    }
    if (lane == 0) s_ahead = ahead;
  }
  int lend = -1;  // the tile's last run end
  bool known = true;  // the carries came with the rows after the tile
  // lane l: the in-tile reverse scan (per thread, the warp's shuffles, the
  // warps' aggregates), the carry from the rows after the tile, the tile's
  // aggregate, the rows' sums staged; lane l - 1's staged sums go out after
  // lane l's barrier
  auto pass = [&](auto fl, int l, ull (&x)[ITEMS]) {
    constexpr bool F = decltype(fl)::value;
    const int op = p.op[l];
    if (F) fix_floats(p, l, r0, x);
    if (w == WARPS - 1 && ahead >= 0) {  // the carry: the sum of the rows after the tile up to the run end
      ull y = 0ULL;
      if (lane < ahead) {
        const ll i = t1 + lane;
        const ull* d = p.data[l];
        const uint8_t* vl = p.valid[l];
        const ull dv = d == nullptr ? 1ULL : d[i];
        y = p.mask[i] != 0 && (vl == nullptr || vl[i] != 0) ? dv : 0ULL;
        if (F && y == I64_MIN_BITS) y = 0ULL;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) y = add<F>(y, __shfl_xor_sync(FULL, y, off));
      if (lane == 0) s_carry[l] = P2{ahead > 0 ? 1 : 0, (ll)y};
    }
    Seg2 t{false, 0ULL};  // this thread's rows, from its last up
#pragma unroll
    for (int j = ITEMS - 1; j >= 0; --j) t = seg<F>(t, Seg2{last[j], x[j]});
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // the lanes from this one to the warp's end
      const Seg2 o = shfl_down(t, off);
      if (lane + off < 32) t = seg<F>(o, t);
    }
    const Seg2 after = shfl_down(t, 1);  // the lanes after this one
    if (lane == 0) s_warp[l & 1][w] = t;
    __syncthreads();
    if (l == 0) {
      for (int q = 0; q < WARPS; ++q) lend = s_end[q] > lend ? s_end[q] : lend;
      known = s_ahead >= 0;
    } else {
      flush(s_y[(l - 1) & 1], p.out[l - 1], t0, p.n);
    }
    Seg2 c{false, 0ULL};  // the tile's rows after this thread's
    for (int q = WARPS - 1; q > w; --q) c = seg<F>(c, s_warp[l & 1][q]);
    if (threadIdx.x == 0) {  // the tile's aggregate, published at once; inclusive when it holds a run end or the carry is known
      const Seg2 a = seg<F>(c, t);
      s_agg[l] = P2{a.f ? 1 : 0, (ll)a.v};
      const P2 incl = known && !a.f ? RunOp{op}(s_carry[l], s_agg[l]) : s_agg[l];
      compact::put_desc(lb.desc(v * p.nl + l), v == 0 || a.f || known ? 2 : 1, incl);
    }
    if (lane < 31) c = seg<F>(c, after);
    if (known) c = seg<F>(Seg2{false, (ull)s_carry[l].b}, c);  // the rest of the run beyond the tile
#pragma unroll
    for (int j = ITEMS - 1; j >= 0; --j) {
      c = seg<F>(c, Seg2{last[j], x[j]});
      s_y[l & 1][j * SROW + threadIdx.x] = c.v;
      if (l == p.cnt_lane) s_role[0][j * SROW + threadIdx.x] = c.v;
      if (l == p.rid_lane) s_role[1][j * SROW + threadIdx.x] = c.v;
      if (l == p.score_lane) s_role[2][j * SROW + threadIdx.x] = c.v;
    }
  };
  for (int l = 0; l < p.nl; ++l) {
    ull x[ITEMS];
    load_lane(p, l, r0, (unsigned)(oks >> (l * ITEMS)) & ((1u << ITEMS) - 1u), x);
    if (p.op[l] == OP_SUM_F64) pass(std::true_type{}, l, x); else pass(std::false_type{}, l, x);
  }
  __syncthreads();
  flush(s_y[(p.nl - 1) & 1], p.out[p.nl - 1], t0, p.n);
  if (!known) {  // a run goes on past AHEAD rows after the tile: the carries by look-back
    for (int l = w; l < p.nl; l += WARPS) {  // warp w: lanes w, w + WARPS, ...
      const RunOp ro{p.op[l]};
      const P2 c = compact::look_back(lb, v, p.nl, l, ro);
      if (lane == 0) {
        if (s_agg[l].a == 0) compact::put_desc(lb.desc(v * p.nl + l), 2, ro(c, s_agg[l]));
        s_carry[l] = c;
      }
    }
  }
  __syncthreads();  // the carries; every staged sum is out
  // without the rows after the tile, the rows after the tile's last run end
  // take their carry now
  if (!known && r0 + ITEMS - 1 > lend) {
    for (int l = 0; l < p.nl; ++l) {
      const ull c = (ull)s_carry[l].b;
      const int op = p.op[l];
      if (c == identity(op)) continue;
      ull* out = p.out[l];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const ll i = r0 + j;
        if (i >= p.n || i <= lend) continue;
        const ull z = combine(op, c, __ldcg(out + i));  // stored by another thread of the block
        out[i] = z;
        if (l == p.cnt_lane) s_role[0][j * SROW + threadIdx.x] = z;
        if (l == p.rid_lane) s_role[1][j * SROW + threadIdx.x] = z;
        if (l == p.score_lane) s_role[2][j * SROW + threadIdx.x] = z;
      }
    }
  }
  const bool sf = p.op[p.score_lane] == OP_SUM_F64;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll cn = (ll)s_role[0][j * SROW + threadIdx.x];
    const ull rid = s_role[1][j * SROW + threadIdx.x], sc = s_role[2][j * SROW + threadIdx.x];
    s_y[0][j * SROW + threadIdx.x] = cn > 0 ? (ull)floor_div((ll)rid, cn) : ~0ULL;
    const bool ok = first[j] && cn > 0;
    if (r0 + j < p.n) p.vout[r0 + j] = (uint8_t)ok;
    ull s;
    if (sf) {
      const double x = f64(sc);
      s = ok ? bits(p.desc ? x : -x) : NINF_BITS;
    } else {
      s = ok ? (p.desc ? sc : 0ULL - sc) : (ull)(-I64_MAX);
    }
    s_y[1][j * SROW + threadIdx.x] = s;
  }
  __syncthreads();
  flush(s_y[0], (ull*)p.gpos, t0, p.n);
  flush(s_y[1], p.score, t0, p.n);
  if (compact::last_block(lb, &s_last)) {
    for (int l = 0; l < p.nl; ++l) {  // past a float-sum lane's first non-finite row: NaN
      if (p.op[l] != OP_SUM_F64) continue;
      const ull wd = __ldcg(p.poison + l);
      if (wd == 0ULL) continue;
      for (ll i = p.n - (ll)wd + 1 + threadIdx.x; i < p.n; i += BLOCK) {
        p.out[l][i] = QNAN_BITS;
        if (l == p.score_lane) p.score[i] = __ldcg(p.vout + i) ? (p.desc ? QNAN_BITS : QNAN_BITS ^ I64_MIN_BITS) : NINF_BITS;
      }
    }
    __syncthreads();  // every thread has read the poison words
    if (threadIdx.x < MAX_LANES) p.poison[threadIdx.x] = 0ULL;
    compact::reset(lb, p.ntiles * p.nl);
  }
}

ll tiles(ll n) { return (n + TILE - 1) / TILE; }

}  // namespace

// scratch words the host allocates: the poison words, then compact.cuh's
// look-back (one descriptor a lane and tile)
extern "C" int64_t tt_run_agg_scratch_words(int64_t L, int nl) {
  return POISON + compact::scratch_words(tiles(L) * nl);
}

// words: L, nl, cnt_lane, rid_lane, score_lane, desc, kd, mask,
//        per lane (data, valid, is_float, out), gpos, vout, score, scratch
extern "C" int tt_run_agg(const int64_t* w, int nwords, void* stream) {
  Params p;
  int at = 0;
  auto take = [&](void) -> int64_t { return at < nwords ? w[at++] : (at++, 0); };
  p.n = take();
  p.nl = (int)take();
  p.cnt_lane = (int)take();
  p.rid_lane = (int)take();
  p.score_lane = (int)take();
  p.desc = (int)take();
  if (p.n < 1 || p.n >= (1LL << 31) || p.nl < 1 || p.nl > MAX_LANES) return -1;
  if (p.cnt_lane < 0 || p.cnt_lane >= p.nl || p.rid_lane < 0 || p.rid_lane >= p.nl || p.score_lane < 0 ||
      p.score_lane >= p.nl)
    return -1;
  p.key = (const ll*)take();
  p.mask = (const uint8_t*)take();
  for (int l = 0; l < p.nl; ++l) {
    p.data[l] = (const ull*)take();
    p.valid[l] = (const uint8_t*)take();
    const int is_float = (int)take();
    p.op[l] = p.data[l] == nullptr ? OP_COUNT : (is_float ? OP_SUM_F64 : OP_SUM_I64);
    p.out[l] = (ull*)take();
  }
  p.gpos = (ll*)take();
  p.vout = (uint8_t*)take();
  p.score = (ull*)take();
  ll* scratch = (ll*)take();
  if (at != nwords || scratch == nullptr) return -1;
  p.ntiles = tiles(p.n);
  p.poison = (ull*)scratch;
  const LookBack lb{scratch + POISON};
  run_kernel<<<(unsigned)p.ntiles, BLOCK, 0, (cudaStream_t)stream>>>(p, lb);
  return (int)cudaGetLastError();
}
