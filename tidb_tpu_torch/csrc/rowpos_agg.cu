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
//                 (the lanes past a dedicated presence lane), in one pass
//
// Over n_dev ranks (:1798-1846) K4 scatters into Bp = ceil(B / n_dev) *
// n_dev rows, the mesh's collectives leave each rank its block of blk =
// Bp / n_dev rows (psum_scatter of the sums, pmin / pmax then a slice of
// the min / max lanes: parallel/mesh.py), and the picks entries — score,
// K6, emit — run over that block with base = axis_index * blk.
//
// Each call's parameters travel in one block of int64 words on the card
// (RpBlock below), which kernels/rowpos_agg.py uploads in the call's one
// copy together with K4's descriptor table and K6's task table. Only the
// lanes the score and emit passes read (K4's rows, or on the mesh the
// blocks the collectives returned, read through their strides) and the
// block's first build row travel as kernel parameters, from a host array.
//
// Bound: bytes. The score pass reads two [B] lanes and writes two; the
// emit pass touches kk entries per lane. The scatter (K4) dominates; the
// call, a few microseconds of device work a pass, is bound by its host
// side and its launches.
//
// Plain C interface (nvcc + ctypes): every entry point launches on the
// given stream, never synchronizes, and returns the cudaError_t of the
// launch (0 = success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int MAXL = 32;
constexpr ll I64_MAX = 0x7fffffffffffffffLL;

// kernels/rowpos_agg.py BLOCK_FIELDS: the words, in order
struct RpBlock {
  ll n, nseg;
  const ll* rid;
  int* seg;
  ll blk, desc, is_float;
  uint8_t* valid;
  ll* score;
  ll kk;
  const int* idx;
  ll* gidx;
  ll* rows;  // null: gidx only
  ll row_stride;
};

struct Lanes {  // by value: the lanes as the score and emit passes find them
  ll base;      // the block's first build row
  const ll* pres;
  ll pres_stride;
  const ll* s;
  ll s_stride;
  int nl;  // shipped lanes
  const ll* lane[MAXL];
  ll stride[MAXL];
};

unsigned grid_for(ll n, int n_sms) {
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

__global__ void seg_kernel(const RpBlock* __restrict__ b) {
  const ll n = b->n, top = b->nseg - 1;
  const ll* __restrict__ rid = b->rid;
  int* __restrict__ seg = b->seg;
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    const ll r = rid[i];
    seg[i] = (int)(r < 0 ? 0 : (r > top ? top : r));
  }
}

__global__ void score_kernel(const RpBlock* __restrict__ b, const Lanes L) {
  const ll blk = b->blk;
  const bool desc = b->desc != 0, is_float = b->is_float != 0;
  uint8_t* __restrict__ valid = b->valid;
  ll* __restrict__ score = b->score;
  for (ll g = (ll)blockIdx.x * blockDim.x + threadIdx.x; g < blk; g += (ll)gridDim.x * blockDim.x) {
    const bool v = L.pres[g * L.pres_stride] > 0;
    const ll s = L.s[g * L.s_stride];
    valid[g] = (uint8_t)v;
    if (is_float) {
      const double x = __longlong_as_double(s);
      const double y = v ? (desc ? x : -x) : -__longlong_as_double(0x7ff0000000000000LL);
      score[g] = __double_as_longlong(y);
    } else {
      score[g] = v ? (desc ? s : (ll)(0ULL - (ull)s)) : -I64_MAX;
    }
  }
}

__global__ void emit_kernel(const RpBlock* __restrict__ b, const Lanes L) {
  const ll kk = b->kk, rs = b->row_stride;
  const int* __restrict__ idx = b->idx;
  const uint8_t* __restrict__ valid = b->valid;
  ll* __restrict__ gidx = b->gidx;
  ll* __restrict__ rows = b->rows;
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < kk; t += (ll)gridDim.x * blockDim.x) {
    const ll i = idx[t];
    const bool v = valid[i] != 0;
    const ll g = v ? L.base + i : -1;
    gidx[t] = g;
    if (rows == nullptr) continue;
    rows[t] = g;
    rows[rs + t] = v ? 1 : 0;
    for (int l = 0; l < L.nl; ++l) rows[(2 + l) * rs + t] = L.lane[l][i * L.stride[l]];
  }
}

// words: base, presence lane, its stride, score lane, its stride, nl, per
// shipped lane (address, stride)
int take_lanes(const int64_t* w, int nwords, Lanes& L) {
  if (nwords < 6) return -1;
  L.base = w[0];
  L.pres = (const ll*)w[1];
  L.pres_stride = w[2];
  L.s = (const ll*)w[3];
  L.s_stride = w[4];
  L.nl = (int)w[5];
  if (L.nl < 0 || L.nl > MAXL || nwords != 6 + 2 * L.nl || L.pres == nullptr || L.s == nullptr) return -1;
  for (int l = 0; l < L.nl; ++l) {
    L.lane[l] = (const ll*)w[6 + 2 * l];
    L.stride[l] = w[7 + 2 * l];
  }
  return 0;
}

}  // namespace

// The int64 words of a parameter block (kernels/rowpos_agg.py checks its
// layout against it).
extern "C" int64_t tt_rp_block_words() { return (int64_t)(sizeof(RpBlock) / sizeof(int64_t)); }

// block: the call's RpBlock on the card; n its row count
extern "C" int tt_rp_seg(const void* block, int64_t n, int n_sms, void* stream) {
  if (block == nullptr || n < 0) return -1;
  if (n == 0) return 0;
  seg_kernel<<<grid_for(n, n_sms), BLOCK, 0, (cudaStream_t)stream>>>((const RpBlock*)block);
  return (int)cudaGetLastError();
}

// blk: the block's build rows; lanes: a HOST array of take_lanes' words
extern "C" int tt_rp_score(const void* block, int64_t blk, const int64_t* lanes, int nwords, int n_sms,
                           void* stream) {
  Lanes L;
  if (block == nullptr || blk < 1 || take_lanes(lanes, nwords, L) != 0) return -1;
  score_kernel<<<grid_for(blk, n_sms), BLOCK, 0, (cudaStream_t)stream>>>((const RpBlock*)block, L);
  return (int)cudaGetLastError();
}

// kk: the picks; lanes as tt_rp_score's
extern "C" int tt_rp_emit(const void* block, int64_t kk, const int64_t* lanes, int nwords, int n_sms,
                          void* stream) {
  Lanes L;
  if (block == nullptr || kk < 0 || take_lanes(lanes, nwords, L) != 0) return -1;
  if (kk == 0) return 0;
  emit_kernel<<<grid_for(kk, n_sms), BLOCK, 0, (cudaStream_t)stream>>>((const RpBlock*)block, L);
  return (int)cudaGetLastError();
}
