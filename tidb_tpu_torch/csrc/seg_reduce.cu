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
// the moved mask is set, INT64_MAX elsewhere), each lane reads the
// neutral of its op off that mask (the reference's _neutral, equal to the
// sentinel below), a count lane adds its counts, and the runs hold at most
// n_dev fragments. The steps:
//
//   tt_sr_code    code = sum over the keys of kd * stride (int64 wrap),
//                 kd = ((d - lo) floordiv step + 1) * v for an int key,
//                 (d + 1) * v for a dict-coded one; masked rows INT64_MAX
//   (K8)          kernels/lex_sort sorts the code, stable as jnp.argsort
//   tt_sr_reduce  at sorted position i (row o = order[i]) lane l's value
//                 is ok ? data[o] : sentinel (ok = mask[o] & valid[o]; a
//                 count lane: ok; the sentinel 0 for sums, the reference's
//                 where(ok, d, big) value for min / max). Per lane, the
//                 op's combine from i to the end of i's run, by the
//                 segmented run scan of seg_scan.cuh (shared with P7,
//                 csrc/run_agg.cu): gather_kernel writes sk = code[order],
//                 the scan's poison / heads / carry kernels run over sk's
//                 runs, and finish_kernel takes each tile's reverse
//                 segmented scan; then per row: sum lanes keep the total
//                 at a run's first row and 0 elsewhere (the reference's
//                 where(first, ...)); a float sum is NaN where its run
//                 follows a poisoned row (the reference's prefix
//                 difference is NaN there), fvalid = first & code !=
//                 INT64_MAX, fkey = fvalid ? code : INT64_MAX, score =
//                 fvalid ? (desc ? s : -s) : floor
//   (K6)          kernels/topk picks the kk best scores, lax.top_k's order
//   tt_sr_emit    [fkey, fvalid, lanes...] at the picks into the rows of
//                 the packed result
//
// The combines are seg_scan.cuh's: integer sums modulo 2^64 (the
// reference's prefix differences, bit for bit, overflow or not), float
// sums in a tree order (they differ from the reference's prefix
// differences by rounding only, and write the positive quiet NaN where
// the reference's NaN may be x86's negative one), min / max signed,
// unsigned (uint64) or as floats with NaN winning. The reference's
// distance doubling over runs of at most max_run rows (N for a local
// reduce, n_dev for the final one) covers the window [i, i + span) of
// each row i, span the least power of two >= max_run, and folds its
// neutral wherever that window reaches past i's run or past N. That
// leaves every result unchanged except for uint64, where the neutral is
// 2^63 - 1 (min) / 2^63 (max) in the lane's own dtype: there a row's
// total is combined with it once more unless row i + span - 1 lies in
// i's run.
//
// Bound: bytes. Every lane is gathered through the sort permutation twice
// (heads, finish); every output is written once.
//
// Plain C interface (nvcc + ctypes): kernels/seg_reduce.py packs each
// call's arguments into one int64 word array; launches on the given
// stream, never synchronizes, returns the cudaError_t of the launches (0
// = success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_scan.cuh"

namespace {

using namespace seg_scan;

constexpr int MAXK = 8;

struct Params {
  Lanes s;  // key = sk, order = the K8 permutation
  int score_lane, desc;
  ll span;  // the doubling's window: the least power of two >= max_run
  const ll* code;
  ll* sk;  // scratch: the sorted code
  ull* out[MAXL];
  ll* fkey;
  uint8_t* fvalid;
  ull* score;
};

struct CodeP {
  ll n;
  int nk;
  const uint8_t* mask;
  ll* code;
  const ll* d[MAXK];
  const uint8_t* v[MAXK];
  ll lo[MAXK], step[MAXK], stride[MAXK];
  int is_int[MAXK];
};

__global__ void group_code_kernel(const CodeP p) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += (ll)gridDim.x * blockDim.x) {
    if (!p.mask[i]) {
      p.code[i] = I64_MAX;
      continue;
    }
    ull code = 0;
    for (int k = 0; k < p.nk; ++k) {
      if (!p.v[k][i]) continue;  // kd * v with v = 0
      ll kd;
      if (p.is_int[k]) {
        const ll x = (ll)((ull)p.d[k][i] - (ull)p.lo[k]);
        const ll s = p.step[k];
        ll q = x / s;
        if ((x % s != 0) && ((x < 0) != (s < 0))) --q;  // floor division
        kd = (ll)((ull)q + 1ULL);
      } else {
        kd = (ll)((ull)p.d[k][i] + 1ULL);
      }
      code += (ull)kd * (ull)p.stride[k];
    }
    p.code[i] = (ll)code;
  }
}

__global__ void raw_code_kernel(ll n, const uint8_t* mask, const ll* key, ll* code) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x)
    code[i] = mask[i] ? key[i] : I64_MAX;
}

__global__ void gather_kernel(const Params p) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < p.s.n; i += (ll)gridDim.x * blockDim.x)
    p.sk[i] = p.code[p.s.order[i]];
}

__global__ void finish_kernel(const Params p) {
  __shared__ SegScan::TempStorage tmp;
  const Lanes& s = p.s;
  const ll tend_full = ((ll)blockIdx.x + 1) * TILE;
  ull sc[ITEMS], cur[ITEMS];
  for (int l = 0; l < s.nl; ++l) {
    const int op = s.op[l];
    run_suffix(s, l, tend_full, tmp, cur);
    for (int j = 0; j < ITEMS; ++j) {
      const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
      if (i >= s.n) continue;
      ull v = cur[j];
      if (is_sum(op)) {
        if (!is_first(s, i)) v = 0ULL;
        else if (op == OP_SUM_F64 && s.poison[l] < i) v = QNAN_BITS;  // a non-finite prefix
      } else if (op == OP_MIN_U64 || op == OP_MAX_U64) {
        const ll e = i + p.span - 1;
        if (!(e < s.n && p.sk[e] == p.sk[i])) v = combine(op, v, null_bits(op));
      }
      p.out[l][i] = v;
      if (l == p.score_lane) sc[j] = v;
    }
  }
  const int sop = s.op[p.score_lane];
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
    if (i >= s.n) continue;
    const ll key = p.sk[i];
    const bool valid = is_first(s, i) && key != I64_MAX;
    p.fvalid[i] = (uint8_t)valid;
    p.fkey[i] = valid ? key : I64_MAX;
    if (p.score == nullptr) continue;  // a local reduce: no picks
    ull v;
    if (sop == OP_SUM_F64) {
      const double x = f64(sc[j]);
      v = valid ? bits(p.desc ? x : -x) : NINF_BITS;
    } else {
      v = valid ? (p.desc ? sc[j] : 0ULL - sc[j]) : (ull)(-I64_MAX);
      if (sop == OP_SUM_U64) v ^= I64_MIN_BITS;  // the unsigned order as int64
    }
    p.score[i] = v;
  }
}

struct EmitP {
  ll kk;
  int nl;
  const int* idx;
  const ll* fkey;
  const uint8_t* fvalid;
  ll* rows;
  ll row_stride;
  const ull* tot[MAXL];
};

__global__ void emit_kernel(const EmitP p) {
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < p.kk; t += (ll)gridDim.x * blockDim.x) {
    const ll i = p.idx[t];
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

unsigned grid_for(ll n, int n_sms) {
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// scratch words: sk (n), then seg_scan.cuh's layout
extern "C" int64_t tt_sr_scratch_words(int64_t n, int nl) { return n + scratch_words(n, nl); }

// words: n, nkeys, mask, code, per key (d, v, lo, step, stride, is_int)
extern "C" int tt_sr_code(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  CodeP p;
  p.n = t();
  p.nk = (int)t();
  if (p.n < 1 || p.nk < 1 || p.nk > MAXK) return -1;
  p.mask = (const uint8_t*)t();
  p.code = (ll*)t();
  for (int k = 0; k < p.nk; ++k) {
    p.d[k] = (const ll*)t();
    p.v[k] = (const uint8_t*)t();
    p.lo[k] = t();
    p.step[k] = t();
    p.stride[k] = t();
    p.is_int[k] = (int)t();
    if (p.step[k] < 1) return -1;
  }
  if (!t.done()) return -1;
  group_code_kernel<<<grid_for(p.n, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// words: n, mask, key, code
extern "C" int tt_sr_code_raw(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 4 || w[0] < 1) return -1;
  raw_code_kernel<<<grid_for(w[0], n_sms), BLOCK, 0, (cudaStream_t)stream>>>(w[0], (const uint8_t*)w[1],
                                                                             (const ll*)w[2], (ll*)w[3]);
  return (int)cudaGetLastError();
}

// words: n, nl, score_lane, desc, span, code, order, mask, per lane (op, data, valid, out),
//        fkey, fvalid, score (0: none), scratch
extern "C" int tt_sr_reduce(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  Params p;
  Lanes& s = p.s;
  s.n = t();
  s.nl = (int)t();
  p.score_lane = (int)t();
  p.desc = (int)t();
  p.span = t();
  if (s.n < 1 || s.nl < 1 || s.nl > MAXL || p.score_lane < 0 || p.score_lane >= s.nl || p.span < 1 ||
      (p.span & (p.span - 1)) != 0)
    return -1;
  p.code = (const ll*)t();
  s.order = (const int*)t();
  s.mask = (const uint8_t*)t();
  for (int l = 0; l < s.nl; ++l) {
    s.op[l] = (int)t();
    s.data[l] = (const ull*)t();
    s.valid[l] = (const uint8_t*)t();
    p.out[l] = (ull*)t();
    if (s.op[l] < OP_COUNT || s.op[l] > OP_MAX_F64 || (s.op[l] != OP_COUNT && s.data[l] == nullptr)) return -1;
  }
  if (!is_sum(s.op[p.score_lane])) return -1;
  p.fkey = (ll*)t();
  p.fvalid = (uint8_t*)t();
  p.score = (ull*)t();
  ull* scratch = (ull*)t();
  if (!t.done()) return -1;
  p.sk = (ll*)scratch;
  s.key = p.sk;
  layout(s, scratch + s.n);
  cudaStream_t st = (cudaStream_t)stream;
  gather_kernel<<<grid_for(s.n, n_sms), BLOCK, 0, st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = prepare(s, n_sms, st);
  if (rc) return rc;
  finish_kernel<<<(unsigned)tiles(s.n), BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// words: kk, nl, idx, fkey, fvalid, rows, row_stride, per lane the totals
extern "C" int tt_sr_emit(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  EmitP p;
  p.kk = t();
  p.nl = (int)t();
  if (p.kk < 0 || p.nl < 0 || p.nl > MAXL) return -1;
  p.idx = (const int*)t();
  p.fkey = (const ll*)t();
  p.fvalid = (const uint8_t*)t();
  p.rows = (ll*)t();
  p.row_stride = t();
  for (int l = 0; l < p.nl; ++l) p.tot[l] = (const ull*)t();
  if (!t.done()) return -1;
  if (p.kk == 0) return 0;
  emit_kernel<<<grid_for(p.kk, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
