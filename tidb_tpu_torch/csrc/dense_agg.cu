// P8 dense_agg: the dense MPP aggregation's group code, and its partial
// lanes copied into the rows of the packed result.
//
// Replaces the dense branch of kernel() in tidb_tpu/parallel/mpp.py:
// 1960-1973 (MPPEngine._build_program) with _agg_partials :2048-2080, at
// n_dev 1 (psum / pmin / pmax are the identity there). P8 is a thin pair
// of kernels around K4's segment-lane mode (csrc/seg_agg.cu):
//
//   tt_dense_code  per row the reference's int32 mixed radix (0 with no
//                  key: a join aggregate without GROUP BY, nseg 1): kd = v ?
//                  int32(d) - lo + 1 : 0, code = code * (dom + 1) + kd, all
//                  in int32 wrap (lo as the int32 jnp casts it to: a narrow
//                  domain above 2^31 codes as it would in int64); a masked
//                  row or a code outside [0, nseg) gets nseg, the slot K4
//                  drops (jax's scatter drops it too)
//   (K4)           kernels/seg_agg folds the partial lanes by that segment
//                  lane, K4's partials being the reference's bit for bit
//                  (kernels/red.seg_lane: a NULL row's sentinel is the op's
//                  identity, except for a uint64 min / max, whose sentinel
//                  2^63 - 1 / 2^63 is folded into the data first)
//   tt_dense_emit  each lane's nseg partials from K4's int / float matrix
//                  into its row of the packed (n + 1, W) result, in the
//                  reference's interleaved lane order
//
// Bound: bytes. The code kernel reads the mask and the key lanes and
// writes 4 bytes a row; K4 reads them back with 8 data bytes and a valid
// byte per lane and row; the copy moves nl * nseg words.
//
// Plain C interface (nvcc + ctypes): kernels/dense_agg.py packs each
// call's arguments into one int64 word array; launches on the given
// stream, never synchronizes, returns the cudaError_t of the launch (0 =
// success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;

constexpr int BLOCK = 256;
constexpr int MAXK = 8;
constexpr int MAXL = 32;

struct CodeP {
  ll n;
  int nk;
  ll nseg;
  const uint8_t* mask;
  int32_t* seg;
  const ll* kd[MAXK];
  const uint8_t* kv[MAXK];
  int lo[MAXK];
  int dom[MAXK];
};

__global__ void code_kernel(const CodeP p) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += (ll)gridDim.x * blockDim.x) {
    int32_t out = (int32_t)p.nseg;
    if (p.mask[i]) {
      uint32_t code = 0;
      for (int k = 0; k < p.nk; ++k) {
        uint32_t kd = 0;
        if (p.kv[k][i]) kd = (uint32_t)(int32_t)p.kd[k][i] - (uint32_t)p.lo[k] + 1u;
        code = code * (uint32_t)(p.dom[k] + 1) + kd;
      }
      const ll c = (ll)(int32_t)code;
      if (c >= 0 && c < p.nseg) out = (int32_t)c;
    }
    p.seg[i] = out;
  }
}

struct EmitP {
  int nl;
  ll nseg;
  ll* rows;
  ll row_stride;
  const ll* src[MAXL];
};

__global__ void emit_kernel(const EmitP p) {
  const ll total = (ll)p.nl * p.nseg;
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += (ll)gridDim.x * blockDim.x) {
    const int l = (int)(t / p.nseg);
    const ll g = t % p.nseg;
    p.rows[(ll)l * p.row_stride + g] = p.src[l][g];
  }
}

unsigned grid_for(ll n, int n_sms) {
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// words: n, nk, nseg, mask, seg, per key (d, v, lo32, dom)
extern "C" int tt_dense_code(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords < 5) return -1;
  CodeP p;
  p.n = w[0];
  p.nk = (int)w[1];
  p.nseg = w[2];
  if (p.n < 0 || p.nk < 0 || p.nk > MAXK || p.nseg < 1 || p.nseg >= (1LL << 31)) return -1;
  if (nwords != 5 + 4 * p.nk) return -1;
  p.mask = (const uint8_t*)w[3];
  p.seg = (int32_t*)w[4];
  int at = 5;
  for (int k = 0; k < p.nk; ++k) {
    p.kd[k] = (const ll*)w[at++];
    p.kv[k] = (const uint8_t*)w[at++];
    p.lo[k] = (int)w[at++];
    p.dom[k] = (int)w[at++];
  }
  if (p.n == 0) return 0;
  code_kernel<<<grid_for(p.n, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// words: nl, nseg, rows, row_stride, per lane its source row
extern "C" int tt_dense_emit(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords < 4) return -1;
  EmitP p;
  p.nl = (int)w[0];
  p.nseg = w[1];
  if (p.nl < 1 || p.nl > MAXL || p.nseg < 1 || nwords != 4 + p.nl) return -1;
  p.rows = (ll*)w[2];
  p.row_stride = w[3];
  for (int l = 0; l < p.nl; ++l) p.src[l] = (const ll*)w[4 + l];
  emit_kernel<<<grid_for((ll)p.nl * p.nseg, n_sms), BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
