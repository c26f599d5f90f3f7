// P3 lut_join: one fused join level of an MPP chain, probing a direct-
// address table (LUT) of the build side.
//
// Replaces tidb_tpu/parallel/mpp.py:1516-1544 (lut_join inside
// MPPEngine._build_program). One thread per probe row i:
//
//   for each key k:  ok_k = valid_k[i] & (d_k[i] >= lo_k) & (d_k[i] < hi_k)
//                    acc += (d_k[i] - lo_k) * stride_k        (int64 wrap)
//   pos   = lut[clip(acc, 0, lut_dom - 1)]                    (int32, -1 absent)
//   bsel  = clip(pos, 0, B - 1)
//   match = pmask[i] & all(ok_k) & (pos >= 0) & bmask[bsel]
//   every gathered build lane g:  out_d[i] = d_g[bsel]   (8-byte words)
//                                 out_v[i] = v_g[bsel] & match
//   rowid[i] = match ? brow[bsel] : -1
//   every copied lane c:          dst_c[i] = src_c[i]  (the probe side's
//                                 row ids into their rows of the packed
//                                 result, rows mode's last level)
//
// The range check comes before the packing: a key outside the build
// domain misses and never wraps into a false slot. `match` is written as
// a bool byte or, for a row of the packed result, as an int64 0/1.
//
// Bound: bytes. The probe lanes stream once; the LUT, the build mask, the
// build row ids and the gathered build lanes are random reads (the LUT of
// Q3's orders level is 4 MB at 1M orders and stays in the 50 MB L2).
//
// Plain C interface (nvcc + ctypes): kernels/lut_join.py packs the
// arguments into one int64 word array (pointers as integers); the launch
// goes on the given stream, never synchronizes, and the function returns
// the cudaError_t of the launch (0 = success) or -1 for an argument it
// does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int MAXK = 4;   // key columns of one level
constexpr int MAXG = 32;  // gathered build lanes
constexpr int MAXC = 8;   // copied lanes

struct Params {
  ll n;
  int nkeys, ng, nc, match_i64;
  const ll* kd[MAXK];
  const uint8_t* kv[MAXK];
  ll lo[MAXK], hi[MAXK], stride[MAXK];
  const uint8_t* pmask;
  const int* lut;
  ll lut_dom;
  const uint8_t* bmask;
  const ll* brow;
  ll B;
  const ll* gd[MAXG];
  const uint8_t* gv[MAXG];
  ll* od[MAXG];
  uint8_t* ov[MAXG];
  void* match_out;
  ll* rowid_out;
  const ll* cs[MAXC];
  ll* cd[MAXC];
};

__global__ void lut_join_kernel(const Params p) {
  const ll stride = (ll)gridDim.x * blockDim.x;
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += stride) {
    ull acc = 0;
    bool pkv = true;
    for (int k = 0; k < p.nkeys; ++k) {
      const ll dd = p.kd[k][i];
      pkv = pkv && p.kv[k][i] != 0 && dd >= p.lo[k] && dd < p.hi[k];
      acc += ((ull)dd - (ull)p.lo[k]) * (ull)p.stride[k];
    }
    ll a = (ll)acc;
    a = a < 0 ? 0 : (a > p.lut_dom - 1 ? p.lut_dom - 1 : a);
    const ll pos = (ll)p.lut[a];
    const ll bsel = pos < 0 ? 0 : (pos > p.B - 1 ? p.B - 1 : pos);
    const bool match = p.pmask[i] != 0 && pkv && pos >= 0 && p.bmask[bsel] != 0;
    for (int g = 0; g < p.ng; ++g) {
      p.od[g][i] = p.gd[g][bsel];
      p.ov[g][i] = (uint8_t)(match && p.gv[g][bsel] != 0);
    }
    if (p.match_i64) {
      ((ll*)p.match_out)[i] = match ? 1 : 0;
    } else {
      ((uint8_t*)p.match_out)[i] = (uint8_t)match;
    }
    p.rowid_out[i] = match ? p.brow[bsel] : -1;
    for (int c = 0; c < p.nc; ++c) p.cd[c][i] = p.cs[c][i];
  }
}

}  // namespace

// words: n, nkeys, ng, nc, match_i64,
//        per key (kd, kv, lo, hi, stride),
//        pmask, lut, lut_dom, bmask, brow, B,
//        per gathered lane (gd, gv, od, ov),
//        match_out, rowid_out,
//        per copied lane (cs, cd)
extern "C" int tt_lut_join(const int64_t* w, int nwords, int n_sms, void* stream) {
  Params p;
  int at = 0;
  auto take = [&](void) -> int64_t { return at < nwords ? w[at++] : (at++, 0); };
  p.n = take();
  p.nkeys = (int)take();
  p.ng = (int)take();
  p.nc = (int)take();
  p.match_i64 = (int)take();
  if (p.n < 0 || p.nkeys < 1 || p.nkeys > MAXK || p.ng < 0 || p.ng > MAXG || p.nc < 0 || p.nc > MAXC)
    return -1;
  for (int k = 0; k < p.nkeys; ++k) {
    p.kd[k] = (const ll*)take();
    p.kv[k] = (const uint8_t*)take();
    p.lo[k] = take();
    p.hi[k] = take();
    p.stride[k] = take();
  }
  p.pmask = (const uint8_t*)take();
  p.lut = (const int*)take();
  p.lut_dom = take();
  p.bmask = (const uint8_t*)take();
  p.brow = (const ll*)take();
  p.B = take();
  for (int g = 0; g < p.ng; ++g) {
    p.gd[g] = (const ll*)take();
    p.gv[g] = (const uint8_t*)take();
    p.od[g] = (ll*)take();
    p.ov[g] = (uint8_t*)take();
  }
  p.match_out = (void*)take();
  p.rowid_out = (ll*)take();
  for (int c = 0; c < p.nc; ++c) {
    p.cs[c] = (const ll*)take();
    p.cd[c] = (ll*)take();
  }
  if (at != nwords || p.lut_dom < 1 || p.B < 1) return -1;
  if (p.n == 0) return 0;
  const int threads = 256;
  ll blocks = (p.n + threads - 1) / threads;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  lut_join_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
