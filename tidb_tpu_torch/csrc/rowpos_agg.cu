// P6 rowpos_agg: the rowpos MPP aggregation's own steps around K4's
// scatter and K6's top-k.
//
// Replaces rowpos_agg_stage of tidb_tpu/parallel/mpp.py:1788-1848. The
// stage at n_dev 1 (where psum_scatter / pmin / pmax are the identity):
//
//   tt_rp_seg     seg = clip(rid, 0, B - 1) as int32: the group is the
//                 build row the join gathered (masked rows are dropped by
//                 K4 through the mask, the reference's slot Bp)
//   (K4)          kernels/seg_agg in its segment-lane mode: the
//                 _agg_partials lanes (:2048-2080) into [B] rows
//   tt_rp_score   per build row g: valid = presence[g] > 0,
//                 score = valid ? (desc ? s : -s) : floor (_topk_score
//                 :1984; floor -INT64_MAX or -inf)
//   (K6)          kernels/topk: the kk best scores in lax.top_k's order
//   tt_rp_emit    gidx = valid[idx] ? base + idx : -1 and, into the rows
//                 of the packed result, [gidx, valid[idx], lanes[idx]...]
//                 (the lanes past a dedicated presence lane)
//
// Over n_dev ranks (:1798-1846) K4 scatters into Bp = ceil(B / n_dev) *
// n_dev rows, the mesh's collectives leave each rank its block of blk =
// Bp / n_dev rows (psum_scatter of the sums, pmin / pmax then a slice of
// the min / max lanes: parallel/mesh.py), and the picks entries — score,
// K6, emit — run over that block with base = axis_index * blk.
//
// Bound: bytes. The score pass reads two [B] lanes and writes two; the
// emit pass touches kk entries per lane. The scatter (K4) dominates.
//
// Plain C interface (nvcc + ctypes): kernels/rowpos_agg.py packs each
// call's arguments into one int64 word array; launches on the given
// stream, never synchronizes, returns the cudaError_t of the launch (0 =
// success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int MAXL = 32;
constexpr ll I64_MAX = 0x7fffffffffffffffLL;

unsigned grid_for(ll n, int n_sms) {
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

__global__ void seg_kernel(ll n, ll nseg, const ll* __restrict__ rid, int* seg) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    const ll r = rid[i];
    seg[i] = (int)(r < 0 ? 0 : (r > nseg - 1 ? nseg - 1 : r));
  }
}

__global__ void score_kernel(ll nseg, int desc, int is_float, const ll* __restrict__ pres, const ll* __restrict__ s,
                             uint8_t* valid, ll* score) {
  for (ll g = (ll)blockIdx.x * blockDim.x + threadIdx.x; g < nseg; g += (ll)gridDim.x * blockDim.x) {
    const bool v = pres[g] > 0;
    valid[g] = (uint8_t)v;
    if (is_float) {
      const double x = __longlong_as_double(s[g]);
      const double y = v ? (desc ? x : -x) : -__longlong_as_double(0x7ff0000000000000LL);
      score[g] = __double_as_longlong(y);
    } else {
      score[g] = v ? (desc ? s[g] : (ll)(0ULL - (ull)s[g])) : -I64_MAX;
    }
  }
}

struct EmitP {
  ll kk;
  int nl;
  const int* idx;
  const uint8_t* valid;
  ll base;
  ll* gidx;
  ll* rows;  // null: gidx only
  ll row_stride;
  const ll* lane[MAXL];
};

__global__ void emit_kernel(const EmitP p) {
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < p.kk; t += (ll)gridDim.x * blockDim.x) {
    const ll i = p.idx[t];
    const bool v = p.valid[i] != 0;
    const ll g = v ? p.base + i : -1;
    p.gidx[t] = g;
    if (p.rows == nullptr) continue;
    p.rows[t] = g;
    p.rows[p.row_stride + t] = v ? 1 : 0;
    for (int l = 0; l < p.nl; ++l) p.rows[(2 + l) * p.row_stride + t] = p.lane[l][i];
  }
}

}  // namespace

// words: n, nseg, rid, seg
extern "C" int tt_rp_seg(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 4 || w[0] < 0 || w[1] < 1) return -1;
  if (w[0] == 0) return 0;
  seg_kernel<<<grid_for(w[0], n_sms), BLOCK, 0, (cudaStream_t)stream>>>(w[0], w[1], (const ll*)w[2], (int*)w[3]);
  return (int)cudaGetLastError();
}

// words: nseg, desc, is_float, presence lane, score lane, valid, score
extern "C" int tt_rp_score(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 7 || w[0] < 1) return -1;
  score_kernel<<<grid_for(w[0], n_sms), BLOCK, 0, (cudaStream_t)stream>>>(
      w[0], (int)w[1], (int)w[2], (const ll*)w[3], (const ll*)w[4], (uint8_t*)w[5], (ll*)w[6]);
  return (int)cudaGetLastError();
}

// words: kk, nl, idx, valid, base, gidx, rows (or 0), row_stride, per shipped lane its [B] row
extern "C" int tt_rp_emit(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords < 8) return -1;
  EmitP p;
  p.kk = w[0];
  p.nl = (int)w[1];
  if (p.kk < 0 || p.nl < 0 || p.nl > MAXL || nwords != 8 + p.nl) return -1;
  p.idx = (const int*)w[2];
  p.valid = (const uint8_t*)w[3];
  p.base = w[4];
  p.gidx = (ll*)w[5];
  p.rows = (ll*)w[6];
  p.row_stride = w[7];
  for (int l = 0; l < p.nl; ++l) p.lane[l] = (const ll*)w[8 + l];
  if (p.kk == 0) return 0;
  emit_kernel<<<grid_for(p.kk, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
