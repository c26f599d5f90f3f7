// M3 hash_repartition: the local half of the MPP hash exchange — each
// valid row into its owner's send buffer, in row order.
//
// Replaces the body of local() in tidb_tpu/parallel/mesh.py:104
// hash_repartition up to its all_to_all: owner = key mod n_dev (floored,
// as jnp's %: CUDA's % truncates, so a negative remainder gets n_dev
// added), a stable argsort of the rows by owner (invalid rows last, in
// bin n_dev), per-owner counts and exclusive offsets, a scatter into
// [n_dev, cap] buffers, and the count of valid rows beyond cap. The
// collectives (all_to_all, the all_reduce of the dropped count) are
// torch.distributed calls in tidb_tpu_torch/parallel/mesh.py.
//
// Design: n_dev + 1 bins need no sort, only a stable counting partition.
//   1. count    each block walks one tile of TILE rows in steps of one row
//               per thread; __match_any_sync groups a warp's rows by bin,
//               and the rank of a row among its warp's equal-bin rows, the
//               counts of the earlier warps and the tile's running count
//               give its stable rank in the tile; the tile's per-bin
//               counts go to counts[tile][bin]
//   2. scan     one block per bin turns the column into exclusive offsets
//               over the tiles (CUB BlockScan) and writes the bin's total
//               to row ntiles; a bin's rows beyond cap add to `dropped`
//   3. scatter  the tiles are walked again with the same ranks; a valid
//               row at position p < cap of owner o writes buf[o][p]
// The buffers arrive zeroed, so unused slots stay zero. The reference's
// scatter clips every target into [0, cap), so a row without a slot (in
// the last bucket, an invalid row too) also lands on slot cap - 1, and
// XLA's CPU scatter keeps the last writer there, a zero: slot (o, cap-1)
// stays empty when owner o has more than cap rows, or when o is the last
// owner, has exactly cap rows and some row is invalid. Pass 3 follows
// that rule.
//
// Bound: bytes. Passes 1 and 3 read the keys and valid bytes, pass 3 the
// payload too, and the buffers are written once (17 bytes a row at most).
//
// Plain C interface (nvcc + ctypes): tt_hash_repartition launches the
// three kernels on the given stream, never synchronizes, and returns the
// cudaError_t of the launches (0 = success), or -1 for an argument it
// does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int STEPS = 16;
constexpr ll TILE = (ll)BLOCK * STEPS;
constexpr int MAX_BINS = 1025;
constexpr int SCAN = 512;  // threads of the scan block (its registers bound it)

struct P {
  const ll* keys;
  const ll* payload;
  const uint8_t* valid;
  ll n;
  int n_dev;
  ll cap;
  int* counts;  // [ntiles + 1][n_dev + 1]: per-tile counts → offsets; the totals last
  ll ntiles;
  ll* buf_k;
  ll* buf_p;
  uint8_t* buf_v;
  ll* dropped;
};

__device__ __forceinline__ int owner_of(const P& p, ll i) {
  if (i >= p.n) return -1;
  if (!p.valid[i]) return p.n_dev;
  ll r = p.keys[i] % p.n_dev;
  if (r < 0) r += p.n_dev;
  return (int)r;
}

// Passes 1 (scatter = false) and 3 (scatter = true): one tile per block.
template <bool SCATTER>
__global__ void tile_kernel(const P p) {
  __shared__ int wcnt[WARPS][MAX_BINS];
  __shared__ int run[MAX_BINS];
  const int nbins = p.n_dev + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < nbins; j += BLOCK) {
    run[j] = 0;
    for (int w = 0; w < WARPS; ++w) wcnt[w][j] = 0;
  }
  __syncthreads();
  const ll tile = blockIdx.x;
  const int* base = p.counts + tile * nbins;  // pass 3: the tile's offsets
  const int* total = p.counts + p.ntiles * nbins;
  for (int step = 0; step < STEPS; ++step) {
    const ll i = tile * TILE + (ll)step * BLOCK + threadIdx.x;
    const int bin = owner_of(p, i);
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int rank_w = __popc(peers & ((1u << lane) - 1));
    const bool leader = rank_w == 0;
    if (bin >= 0 && leader) wcnt[warp][bin] = __popc(peers);
    __syncthreads();
    if (SCATTER && bin >= 0 && bin < p.n_dev) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += wcnt[w][bin];
      const ll pos = (ll)base[bin] + run[bin] + before + rank_w;
      const ll tot = total[bin];
      const bool emptied = tot > p.cap || (bin == p.n_dev - 1 && tot == p.cap && total[p.n_dev] > 0);
      if (pos < p.cap && !(pos == p.cap - 1 && emptied)) {
        const ll slot = (ll)bin * p.cap + pos;
        p.buf_k[slot] = p.keys[i];
        p.buf_p[slot] = p.payload[i];
        p.buf_v[slot] = 1;
      }
    }
    __syncthreads();
    if (bin >= 0 && leader) {
      atomicAdd(&run[bin], __popc(peers));
      wcnt[warp][bin] = 0;
    }
    __syncthreads();
  }
  if (!SCATTER)
    for (int j = threadIdx.x; j < nbins; j += BLOCK) p.counts[tile * nbins + j] = run[j];
}

// Pass 2: bin blockIdx.x's exclusive offsets over the tiles, its total and drops.
__global__ void __launch_bounds__(SCAN) scan_kernel(const P p) {
  typedef cub::BlockScan<ll, SCAN> Scan;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ ll carry;
  const int nbins = p.n_dev + 1, bin = blockIdx.x;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (ll t0 = 0; t0 < p.ntiles; t0 += SCAN) {
    const ll t = t0 + threadIdx.x;
    const ll c = t < p.ntiles ? p.counts[t * nbins + bin] : 0;
    ll excl, sum;
    Scan(tmp).ExclusiveSum(c, excl, sum);
    const ll at = carry;
    if (t < p.ntiles) p.counts[t * nbins + bin] = (int)(at + excl);
    __syncthreads();
    if (threadIdx.x == 0) carry = at + sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    p.counts[p.ntiles * nbins + bin] = (int)carry;
    if (bin < p.n_dev && carry > p.cap) atomicAdd((unsigned long long*)p.dropped, (unsigned long long)(carry - p.cap));
  }
}

}  // namespace

extern "C" int64_t tt_hash_repartition_blocks(int64_t n) { return (n + TILE - 1) / TILE; }

extern "C" int tt_hash_repartition(const int64_t* keys, const int64_t* payload, const uint8_t* valid, int64_t n,
                                   int n_dev, int64_t cap, int32_t* counts, int64_t* buf_k, int64_t* buf_p,
                                   uint8_t* buf_v, int64_t* dropped, void* stream) {
  if (n < 0 || n_dev < 1 || n_dev + 1 > MAX_BINS || cap < 1 || n >= (1LL << 31)) return -1;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  P p{(const ll*)keys, (const ll*)payload, valid, n, n_dev, cap, counts, tt_hash_repartition_blocks(n),
      (ll*)buf_k, (ll*)buf_p, buf_v, (ll*)dropped};
  tile_kernel<false><<<(unsigned)p.ntiles, BLOCK, 0, s>>>(p);
  scan_kernel<<<(unsigned)(n_dev + 1), SCAN, 0, s>>>(p);
  tile_kernel<true><<<(unsigned)p.ntiles, BLOCK, 0, s>>>(p);
  return (int)cudaGetLastError();
}
