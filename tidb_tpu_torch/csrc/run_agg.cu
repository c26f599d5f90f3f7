// P7 run_agg: per-run totals over a key-sorted stream, the clustered
// aggregation of a fused MPP chain.
//
// Replaces tidb_tpu/parallel/mpp.py:1850-1913 (clustered_agg_stage up to
// its top-k, with _topk_score :1984). The stream holds the group level's
// probe key kd (equal keys are contiguous runs), the chain's row mask and
// up to MAXL value lanes; lane l's value at row i is
//
//   ok = mask[i] & valid_l[i]          (valid_l absent: ok = mask[i])
//   x  = ok ? (data_l absent ? 1 : data_l[i]) : 0
//
// The reference takes, at every row, c[rend] - c[i - 1] over the lane's
// prefix sum c: the sum of x from i to the end of i's run. This kernel
// computes the same suffix-in-run sums directly:
//
//   heads_kernel   per tile of TILE rows: the sum of the tile's rows before
//                  its first run start (the tail of a run that began in an
//                  earlier tile) and whether the tile has a run start
//   carry_kernel   per tile: the sum of the following tiles' heads up to
//                  and including the first tile with a run start: the rest
//                  of the tile's last run
//   finish_kernel  per tile: a reverse segmented inclusive scan (CUB
//                  BlockScan; a segment ends where the key changes) seeded
//                  with the carry, then per row
//                    gpos  = cnt > 0 ? rid_sum // cnt : -1
//                    valid = run start & cnt > 0
//                    score = valid ? (desc ? s : -s) : floor
//                  (cnt the match-count lane, rid_sum the row-id lane, s
//                  the ORDER BY lane; floor -INT64_MAX or -inf)
//
// Integer lanes add in unsigned 64-bit arithmetic: a run sum equals the
// reference's difference of wrapped prefixes bit for bit, prefix overflow
// or not. Float lanes add in a fixed tree order (deterministic); they
// differ from the reference's prefix differences by rounding only.
//
// Bound: bytes. Every input lane is read twice (heads, finish) and every
// output written once; nothing is compute-heavy.
//
// Plain C interface (nvcc + ctypes): kernels/run_agg.py packs the
// arguments into one int64 word array; launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int TILE = BLOCK * ITEMS;
constexpr int MAXL = 16;
constexpr ll I64_MAX = 0x7fffffffffffffffLL;

struct MinOp {
  __device__ __forceinline__ ll operator()(ll a, ll b) const { return a < b ? a : b; }
};

struct Params {
  ll L;
  int nl, cnt_lane, rid_lane, score_lane, desc;
  const ll* kd;
  const uint8_t* mask;
  const void* data[MAXL];  // null: a count lane
  const uint8_t* valid[MAXL];  // null: ok = mask
  int is_float[MAXL];
  void* out[MAXL];
  ll* gpos;
  uint8_t* vout;
  void* score;
  // scratch: per tile and lane the head (bits), per tile the flag, the carry
  ull* head;
  uint8_t* hasflag;
  ull* carry;
};

__device__ __forceinline__ bool is_first(const Params& p, ll i) {
  return i == 0 || p.kd[i] != p.kd[i - 1];
}

__device__ __forceinline__ bool is_last(const Params& p, ll i) {
  return i == p.L - 1 || p.kd[i + 1] != p.kd[i];
}

// the lane's value at row i, as its 64-bit pattern
__device__ __forceinline__ ull value_bits(const Params& p, int l, ll i) {
  const bool ok = p.mask[i] != 0 && (p.valid[l] == nullptr || p.valid[l][i] != 0);
  if (p.data[l] == nullptr) return ok ? 1ULL : 0ULL;
  if (!ok) return 0ULL;  // +0.0 and integer 0 share the pattern
  return ((const ull*)p.data[l])[i];
}

__device__ __forceinline__ ull add_bits(ull a, ull b, int is_float) {
  if (is_float) return (ull)__double_as_longlong(__longlong_as_double((ll)a) + __longlong_as_double((ll)b));
  return a + b;
}

__global__ void heads_kernel(const Params p) {
  typedef cub::BlockReduce<ll, BLOCK> RMin;
  typedef cub::BlockReduce<ull, BLOCK> RSumU;
  typedef cub::BlockReduce<double, BLOCK> RSumF;
  __shared__ union {
    typename RMin::TempStorage mn;
    typename RSumU::TempStorage su;
    typename RSumF::TempStorage sf;
  } tmp;
  __shared__ ll first_at;
  const ll t0 = (ll)blockIdx.x * TILE;
  const ll t1 = t0 + TILE < p.L ? t0 + TILE : p.L;
  ll mine = I64_MAX;
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = t0 + threadIdx.x * ITEMS + j;
    if (i < t1 && is_first(p, i) && i < mine) mine = i;
  }
  const ll m = RMin(tmp.mn).Reduce(mine, MinOp());
  if (threadIdx.x == 0) {
    first_at = m;
    p.hasflag[blockIdx.x] = (uint8_t)(m < t1);
  }
  __syncthreads();
  const ll stop = first_at < t1 ? first_at : t1;
  for (int l = 0; l < p.nl; ++l) {
    if (p.is_float[l]) {
      double s = 0.0;
      for (int j = 0; j < ITEMS; ++j) {
        const ll i = t0 + threadIdx.x * ITEMS + j;
        if (i < stop) s += __longlong_as_double((ll)value_bits(p, l, i));
      }
      const double tot = RSumF(tmp.sf).Sum(s);
      if (threadIdx.x == 0) p.head[(ll)blockIdx.x * p.nl + l] = (ull)__double_as_longlong(tot);
    } else {
      ull s = 0;
      for (int j = 0; j < ITEMS; ++j) {
        const ll i = t0 + threadIdx.x * ITEMS + j;
        if (i < stop) s += value_bits(p, l, i);
      }
      const ull tot = RSumU(tmp.su).Sum(s);
      if (threadIdx.x == 0) p.head[(ll)blockIdx.x * p.nl + l] = tot;
    }
    __syncthreads();
  }
}

__global__ void carry_kernel(const Params p, ll ntiles) {
  const ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  ull acc[MAXL];
  for (int l = 0; l < p.nl; ++l) acc[l] = p.is_float[l] ? (ull)__double_as_longlong(0.0) : 0ULL;
  for (ll u = t + 1; u < ntiles; ++u) {
    for (int l = 0; l < p.nl; ++l) acc[l] = add_bits(acc[l], p.head[u * p.nl + l], p.is_float[l]);
    if (p.hasflag[u]) break;
  }
  for (int l = 0; l < p.nl; ++l) p.carry[t * p.nl + l] = acc[l];
}

// (segment starts here, value): the segmented-sum monoid, a before b
template <typename T>
struct Seg {
  int f;
  T v;
};

template <typename T>
struct SegSum {
  __device__ __forceinline__ Seg<T> operator()(const Seg<T>& a, const Seg<T>& b) const {
    Seg<T> r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : a.v + b.v;
    return r;
  }
};

template <typename T>
__device__ __forceinline__ T from_bits(ull b);
template <>
__device__ __forceinline__ ull from_bits<ull>(ull b) { return b; }
template <>
__device__ __forceinline__ double from_bits<double>(ull b) { return __longlong_as_double((ll)b); }

template <typename T>
__device__ __forceinline__ ull to_bits(T v);
template <>
__device__ __forceinline__ ull to_bits<ull>(ull v) { return v; }
template <>
__device__ __forceinline__ ull to_bits<double>(double v) { return (ull)__double_as_longlong(v); }

// suffix-in-run sums of lane l for this tile's rows, into sums[j] (the
// thread's ITEMS rows in reverse order: item j is row t_end - 1 - (x*ITEMS + j))
template <typename T>
__device__ void tile_suffix(const Params& p, int l, ll tend_full, void* st, ull (&sums)[ITEMS]) {
  typedef cub::BlockScan<Seg<T>, BLOCK> BS;
  Seg<T> items[ITEMS];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
    if (i >= p.L) {
      items[j].f = 1;
      items[j].v = T(0);
      continue;
    }
    const bool last = is_last(p, i);
    T x = from_bits<T>(value_bits(p, l, i));
    if (i == tend_full - 1 && !last) x = x + from_bits<T>(p.carry[(ll)blockIdx.x * p.nl + l]);
    items[j].f = last ? 1 : 0;
    items[j].v = x;
  }
  BS(*reinterpret_cast<typename BS::TempStorage*>(st)).InclusiveScan(items, items, SegSum<T>());
  for (int j = 0; j < ITEMS; ++j) sums[j] = to_bits<T>(items[j].v);
}

__global__ void finish_kernel(const Params p) {
  typedef cub::BlockScan<Seg<ull>, BLOCK> BSU;
  typedef cub::BlockScan<Seg<double>, BLOCK> BSF;
  __shared__ union {
    typename BSU::TempStorage u;
    typename BSF::TempStorage f;
  } tmp;
  const ll tend_full = ((ll)blockIdx.x + 1) * TILE;
  ull cnt[ITEMS], rid[ITEMS], sc[ITEMS], cur[ITEMS];
  for (int l = 0; l < p.nl; ++l) {
    if (p.is_float[l]) {
      tile_suffix<double>(p, l, tend_full, &tmp, cur);
    } else {
      tile_suffix<ull>(p, l, tend_full, &tmp, cur);
    }
    __syncthreads();
    for (int j = 0; j < ITEMS; ++j) {
      const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
      if (i < p.L) ((ull*)p.out[l])[i] = cur[j];
      if (l == p.cnt_lane) cnt[j] = cur[j];
      if (l == p.rid_lane) rid[j] = cur[j];
      if (l == p.score_lane) sc[j] = cur[j];
    }
  }
  const int sf = p.is_float[p.score_lane];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
    if (i >= p.L) continue;
    const ll c = (ll)cnt[j];
    ll g = -1;
    if (c > 0) {
      const ll a = (ll)rid[j];
      g = a / c;
      if ((a % c != 0) && ((a < 0) != (c < 0))) --g;  // floor division
    }
    p.gpos[i] = g;
    const bool valid = is_first(p, i) && c > 0;
    p.vout[i] = (uint8_t)valid;
    ull s;
    if (sf) {
      const double x = __longlong_as_double((ll)sc[j]);
      s = (ull)__double_as_longlong(valid ? (p.desc ? x : -x) : -__longlong_as_double(0x7ff0000000000000LL));
    } else {
      s = valid ? (p.desc ? sc[j] : (ull)0 - sc[j]) : (ull)(-I64_MAX);
    }
    ((ull*)p.score)[i] = s;
  }
}

}  // namespace

// scratch words the host allocates: head (ntiles * nl), hasflag bytes
// (ntiles, rounded up to words), carry (ntiles * nl)
extern "C" int64_t tt_run_agg_scratch_words(int64_t L, int nl) {
  const int64_t nt = (L + TILE - 1) / TILE;
  return nt * nl * 2 + (nt + 7) / 8;
}

// words: L, nl, cnt_lane, rid_lane, score_lane, desc, kd, mask,
//        per lane (data, valid, is_float, out), gpos, vout, score, scratch
extern "C" int tt_run_agg(const int64_t* w, int nwords, void* stream) {
  Params p;
  int at = 0;
  auto take = [&](void) -> int64_t { return at < nwords ? w[at++] : (at++, 0); };
  p.L = take();
  p.nl = (int)take();
  p.cnt_lane = (int)take();
  p.rid_lane = (int)take();
  p.score_lane = (int)take();
  p.desc = (int)take();
  if (p.L < 1 || p.nl < 1 || p.nl > MAXL) return -1;
  if (p.cnt_lane < 0 || p.cnt_lane >= p.nl || p.rid_lane < 0 || p.rid_lane >= p.nl ||
      p.score_lane < 0 || p.score_lane >= p.nl)
    return -1;
  p.kd = (const ll*)take();
  p.mask = (const uint8_t*)take();
  for (int l = 0; l < p.nl; ++l) {
    p.data[l] = (const void*)take();
    p.valid[l] = (const uint8_t*)take();
    p.is_float[l] = (int)take();
    p.out[l] = (void*)take();
  }
  p.gpos = (ll*)take();
  p.vout = (uint8_t*)take();
  p.score = (void*)take();
  ull* scratch = (ull*)take();
  if (at != nwords) return -1;
  const ll nt = (p.L + TILE - 1) / TILE;
  p.head = scratch;
  p.carry = scratch + nt * p.nl;
  p.hasflag = (uint8_t*)(scratch + 2 * nt * p.nl);
  cudaStream_t s = (cudaStream_t)stream;
  heads_kernel<<<(unsigned)nt, BLOCK, 0, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  carry_kernel<<<(unsigned)((nt + 255) / 256), 256, 0, s>>>(p, nt);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  finish_kernel<<<(unsigned)nt, BLOCK, 0, s>>>(p);
  return (int)cudaGetLastError();
}
