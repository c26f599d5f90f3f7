// M1 q1_local: one shard's fused TPC-H Q1 — filter, group code, six exact
// int64 segment sums.
//
// Replaces tidb_tpu/parallel/mesh.py:57 q1_local_kernel (the flagship
// program of __graft_entry__.entry). Per row i:
//
//   mask = row_valid[i] && ship[i] <= cutoff
//   seg  = rf[i] * 2 + ls[i]  (dropped outside [0, nseg), as jax's
//          segment_sum drops it)
//   disc_price = price * (100 - disc), charge = disc_price * (100 + tax)
//   out[:, seg] += (1, qty, price, disc_price, charge, disc)
//
// every product and sum in unsigned 64-bit arithmetic, i.e. the int64
// wrap XLA's arithmetic has. Wrapping sums are associative, so the result
// is bit-exact whatever the order of the atomics.
//
// Bound: bytes. Each row reads seven int64 lanes and a valid byte (57
// bytes); the output is 48 * nseg bytes. With every row landing in one of
// a handful of slots, atomics per row would serialize on those slots, so
// for nseg <= 8 (Q1's 6) each thread accumulates its rows in registers —
// six lanes by eight segments, selected without indexing — then the warp
// reduces them with shuffles and one lane per warp adds them to the
// block's shared slots, merged once into the output. A wider nseg adds
// each row to the output with global atomics.
//
// Plain C interface (nvcc + ctypes): tt_q1_local zeroes the output and
// launches on the given stream, never synchronizes, and returns the
// cudaError_t of the launch (0 = success), or -1 for an argument it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int NS = 8;  // the register path's segments
constexpr int NL = 6;  // count, qty, price, disc_price, charge, disc

struct Lanes {
  const ll *qty, *price, *disc, *tax, *rf, *ls, *ship;
  const uint8_t* rv;
};

// the row's segment, or -1 when it is masked out or its code falls out
__device__ __forceinline__ ll segment(const Lanes& L, ll i, ll nseg, ll cutoff) {
  if (!L.rv[i] || L.ship[i] > cutoff) return -1;
  const ll code = (ll)((ull)L.rf[i] * 2ULL + (ull)L.ls[i]);
  return code >= 0 && code < nseg ? code : -1;
}

__device__ __forceinline__ void row_values(const Lanes& L, ll i, ull v[NL]) {
  const ull price = (ull)L.price[i], disc = (ull)L.disc[i];
  const ull disc_price = price * (100ULL - disc);
  v[0] = 1;
  v[1] = (ull)L.qty[i];
  v[2] = price;
  v[3] = disc_price;
  v[4] = disc_price * (100ULL + (ull)L.tax[i]);
  v[5] = disc;
}

__global__ void q1_small_kernel(const Lanes L, ll n, ll nseg, ll cutoff, ull* out) {
  __shared__ ull acc[NL * NS];
  for (int j = threadIdx.x; j < NL * NS; j += blockDim.x) acc[j] = 0;
  __syncthreads();
  ull r[NL][NS];
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int g = 0; g < NS; ++g) r[l][g] = 0;
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    const ll s = segment(L, i, nseg, cutoff);
    if (s < 0) continue;
    ull v[NL];
    row_values(L, i, v);
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      if (s == g) {
#pragma unroll
        for (int l = 0; l < NL; ++l) r[l][g] += v[l];
      }
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      ull x = r[l][g];
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0 && x) atomicAdd(&acc[l * NS + g], x);
    }
  __syncthreads();
  for (int j = threadIdx.x; j < NL * NS; j += blockDim.x) {
    const int l = j / NS, g = j % NS;
    if (g < nseg && acc[j]) atomicAdd(&out[(ll)l * nseg + g], acc[j]);
  }
}

__global__ void q1_wide_kernel(const Lanes L, ll n, ll nseg, ll cutoff, ull* out) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    const ll s = segment(L, i, nseg, cutoff);
    if (s < 0) continue;
    ull v[NL];
    row_values(L, i, v);
    for (int l = 0; l < NL; ++l) atomicAdd(&out[(ll)l * nseg + s], v[l]);
  }
}

}  // namespace

extern "C" int tt_q1_local(const int64_t* qty, const int64_t* price, const int64_t* disc, const int64_t* tax,
                           const int64_t* rf, const int64_t* ls, const int64_t* ship, const uint8_t* rv,
                           int64_t n, int64_t nseg, int64_t cutoff, int64_t* out, int n_sms, void* stream) {
  if (n < 0 || nseg < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(int64_t) * NL * nseg, s);
  int err = (int)cudaGetLastError();
  if (err != 0 || n == 0) return err;
  Lanes L{(const ll*)qty, (const ll*)price, (const ll*)disc, (const ll*)tax, (const ll*)rf, (const ll*)ls,
          (const ll*)ship, rv};
  ll blocks = (n + BLOCK - 1) / BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  if (nseg <= NS)
    q1_small_kernel<<<(unsigned)blocks, BLOCK, 0, s>>>(L, n, nseg, cutoff, (ull*)out);
  else
    q1_wide_kernel<<<(unsigned)blocks, BLOCK, 0, s>>>(L, n, nseg, cutoff, (ull*)out);
  return (int)cudaGetLastError();
}
