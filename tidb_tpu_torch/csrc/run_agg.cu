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
// computes the same suffix-in-run sums directly with the segmented run
// scan of seg_scan.cuh (P5, csrc/seg_reduce.cu, shares its combines): tile heads,
// carries, then finish_kernel's reverse segmented scan per tile, and per
// row
//
//   gpos  = cnt > 0 ? rid_sum // cnt : -1
//   valid = run start & cnt > 0
//   score = valid ? (desc ? s : -s) : floor
//
// (cnt the match-count lane, rid_sum the row-id lane, s the ORDER BY
// lane; floor -INT64_MAX or -inf).
//
// Integer lanes add in unsigned 64-bit arithmetic: a run sum equals the
// reference's difference of wrapped prefixes bit for bit, prefix overflow
// or not. Float lanes add in a fixed tree order (deterministic); they
// differ from the reference's prefix differences by rounding only, except
// where a NaN or an infinity lies before the row in the stream: there the
// reference's prefix difference is NaN, and so is the kernel's (the scan's
// poison row; the positive quiet NaN is written).
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

#include "seg_scan.cuh"

namespace {

using namespace seg_scan;

constexpr int MAX_LANES = 16;

struct Params {
  Lanes s;  // key = kd, no order
  int cnt_lane, rid_lane, score_lane, desc;
  ull* out[MAXL];
  ll* gpos;
  uint8_t* vout;
  ull* score;
};

__global__ void finish_kernel(const Params p) {
  __shared__ SegScan::TempStorage tmp;
  const Lanes& s = p.s;
  const ll tend_full = ((ll)blockIdx.x + 1) * TILE;
  ull cnt[ITEMS], rid[ITEMS], sc[ITEMS], cur[ITEMS];
  for (int l = 0; l < s.nl; ++l) {
    run_suffix(s, l, tend_full, tmp, cur);
    for (int j = 0; j < ITEMS; ++j) {
      const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
      if (s.op[l] == OP_SUM_F64 && s.poison[l] < i) cur[j] = QNAN_BITS;  // a non-finite prefix
      if (i < s.n) p.out[l][i] = cur[j];
      if (l == p.cnt_lane) cnt[j] = cur[j];
      if (l == p.rid_lane) rid[j] = cur[j];
      if (l == p.score_lane) sc[j] = cur[j];
    }
  }
  const bool sf = s.op[p.score_lane] == OP_SUM_F64;
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = tend_full - 1 - (ll)(threadIdx.x * ITEMS + j);
    if (i >= s.n) continue;
    const ll c = (ll)cnt[j];
    ll g = -1;
    if (c > 0) {
      const ll a = (ll)rid[j];
      g = a / c;
      if ((a % c != 0) && ((a < 0) != (c < 0))) --g;  // floor division
    }
    p.gpos[i] = g;
    const bool valid = is_first(s, i) && c > 0;
    p.vout[i] = (uint8_t)valid;
    ull v;
    if (sf) {
      const double x = f64(sc[j]);
      v = valid ? bits(p.desc ? x : -x) : NINF_BITS;
    } else {
      v = valid ? (p.desc ? sc[j] : (ull)0 - sc[j]) : (ull)(-I64_MAX);
    }
    p.score[i] = v;
  }
}

}  // namespace

// scratch words the host allocates (seg_scan.cuh's layout)
extern "C" int64_t tt_run_agg_scratch_words(int64_t L, int nl) { return scratch_words(L, nl); }

// words: L, nl, cnt_lane, rid_lane, score_lane, desc, kd, mask,
//        per lane (data, valid, is_float, out), gpos, vout, score, scratch
extern "C" int tt_run_agg(const int64_t* w, int nwords, void* stream) {
  Params p;
  Lanes& s = p.s;
  int at = 0;
  auto take = [&](void) -> int64_t { return at < nwords ? w[at++] : (at++, 0); };
  s.n = take();
  s.nl = (int)take();
  p.cnt_lane = (int)take();
  p.rid_lane = (int)take();
  p.score_lane = (int)take();
  p.desc = (int)take();
  if (s.n < 1 || s.nl < 1 || s.nl > MAX_LANES) return -1;
  if (p.cnt_lane < 0 || p.cnt_lane >= s.nl || p.rid_lane < 0 || p.rid_lane >= s.nl ||
      p.score_lane < 0 || p.score_lane >= s.nl)
    return -1;
  s.key = (const ll*)take();
  s.order = nullptr;
  s.mask = (const uint8_t*)take();
  for (int l = 0; l < s.nl; ++l) {
    s.data[l] = (const ull*)take();
    s.valid[l] = (const uint8_t*)take();
    const int is_float = (int)take();
    s.op[l] = s.data[l] == nullptr ? OP_COUNT : (is_float ? OP_SUM_F64 : OP_SUM_I64);
    p.out[l] = (ull*)take();
  }
  p.gpos = (ll*)take();
  p.vout = (uint8_t*)take();
  p.score = (ull*)take();
  ull* scratch = (ull*)take();
  if (at != nwords) return -1;
  layout(s, scratch);
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = prepare(s, 132, st);
  if (rc) return rc;
  finish_kernel<<<(unsigned)tiles(s.n), BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}
