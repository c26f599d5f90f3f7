// P2 exchange: the MPP hash exchange's device half — every row of a mask
// into its owner's bucket of one send buffer, in row order, for every lane
// of the exchange at once.
//
// Replaces exchange_all of tidb_tpu/parallel/mpp.py:1465-1514 up to its
// all_to_all, with the owner key of pack_keys (:1451):
//
//   okey  = sum over the keys of (d - lo) * stride (int64 wrap), truncated
//           to int32 where key_i32 (its value then sign-extended); on a
//           probe side a row whose key is not valid (some key's valid lane
//           unset) takes its row index instead (the reference's
//           where(pkv, pkey, arange(rows)))
//   owner = okey mod n_dev, floored (jnp's %; CUDA's % truncates, so a
//           negative remainder gets n_dev added); a row outside the mask
//           owns the bin n_dev, which is no bucket
//
// The reference sorts the rows stably by owner and gathers each owner's
// first bcap rows into its bucket. Here n_dev + 1 bins need no sort, only
// a stable counting partition (the design of M3, csrc/hash_repartition.cu,
// without its clipped scatter):
//   1. count    each block walks one tile of TILE rows in steps of one row
//               per thread, computes each row's bin (kept in a byte per
//               row) and the tile's per-bin counts
//   2. scan     one block per bin turns its column of tile counts into
//               exclusive offsets (CUB BlockScan) and writes the bin's
//               total; an owner's rows beyond bcap add to `dropped`
//   3. scatter  the tiles are walked again: __match_any_sync groups a
//               warp's rows by bin, so a row's rank among its warp's
//               equal-bin rows, the counts of the earlier warps and the
//               tile's running count give its stable position p; a row of
//               owner o with p < bcap copies every lane's element into the
//               send buffer's row o, at the lane's byte offset + p * size
// The send buffer arrives zeroed, so slots past an owner's count stay zero
// (a moved mask is False there). Lanes of 8, 4 and 1 bytes a row; the
// lane table is walked in chunks of MAXL lanes, one scatter launch each.
//
// Bound: bytes. Pass 1 reads the mask and the key lanes and writes one
// byte a row; pass 3 reads that byte and every lane once, and writes each
// moved element once.
//
// Plain C interface (nvcc + ctypes): kernels/exchange.py packs the call's
// arguments into one int64 word array; tt_exchange launches on the given
// stream, never synchronizes, and returns the cudaError_t of the launches
// (0 = success), or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int STEPS = 16;
constexpr ll TILE = (ll)BLOCK * STEPS;
constexpr int MAX_DEV = 64;
constexpr int MAX_BINS = MAX_DEV + 1;
constexpr int MAXK = 8;
constexpr int MAXL = 40;
constexpr int SCAN = 512;  // threads of the scan block

struct P {
  ll n;
  int n_dev;
  ll bcap;
  const uint8_t* mask;
  int nk, key_i32, probe;
  const ll* d[MAXK];
  const uint8_t* v[MAXK];  // null: the key lane has no valid lane
  ll lo[MAXK], stride[MAXK];
  uint8_t* bin;  // [n] scratch: the row's bin
  int* counts;   // [ntiles + 1][n_dev + 1]: per-tile counts → offsets; the totals last
  ll ntiles;
  ll* dropped;
};

struct LaneP {
  int nl;
  const uint8_t* src[MAXL];
  int size[MAXL];
  ll off[MAXL];  // byte offset of the lane's bcap slots in a send row
  uint8_t* dst;
  ll dst_stride;  // bytes of one send row
};

__device__ __forceinline__ int bin_of(const P& p, ll i) {
  if (!p.mask[i]) return p.n_dev;
  ull acc = 0ULL;
  bool kv = true;
  for (int k = 0; k < p.nk; ++k) {
    acc += ((ull)p.d[k][i] - (ull)p.lo[k]) * (ull)p.stride[k];
    if (p.v[k] != nullptr && !p.v[k][i]) kv = false;
  }
  ll key = (ll)acc;
  if (p.key_i32) key = (ll)(int)(unsigned)(acc & 0xffffffffULL);
  if (p.probe && !kv) key = i;
  ll r = key % p.n_dev;
  if (r < 0) r += p.n_dev;
  return (int)r;
}

// Passes 1 (SCATTER = false) and 3 (SCATTER = true): one tile per block.
template <bool SCATTER>
__global__ void tile_kernel(const P p, const LaneP lp) {
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
  for (int step = 0; step < STEPS; ++step) {
    const ll i = tile * TILE + (ll)step * BLOCK + threadIdx.x;
    int bin = -1;
    if (i < p.n) {
      if (SCATTER) {
        bin = p.bin[i];
      } else {
        bin = bin_of(p, i);
        p.bin[i] = (uint8_t)bin;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int rank_w = __popc(peers & ((1u << lane) - 1));
    const bool leader = rank_w == 0;
    if (bin >= 0 && leader) wcnt[warp][bin] = __popc(peers);
    __syncthreads();
    if (SCATTER && bin >= 0 && bin < p.n_dev) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += wcnt[w][bin];
      const ll pos = (ll)base[bin] + run[bin] + before + rank_w;
      if (pos < p.bcap) {
        uint8_t* row = lp.dst + (ll)bin * lp.dst_stride;
        for (int l = 0; l < lp.nl; ++l) {
          const int sz = lp.size[l];
          uint8_t* to = row + lp.off[l] + pos * sz;
          if (sz == 8) {
            *reinterpret_cast<ull*>(to) = reinterpret_cast<const ull*>(lp.src[l])[i];
          } else if (sz == 4) {
            *reinterpret_cast<unsigned*>(to) = reinterpret_cast<const unsigned*>(lp.src[l])[i];
          } else {
            *to = lp.src[l][i];
          }
        }
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
    if (bin < p.n_dev && carry > p.bcap)
      atomicAdd((unsigned long long*)p.dropped, (unsigned long long)(carry - p.bcap));
  }
}

struct Words {
  const int64_t* w;
  int n;
  int at;
  int64_t operator()() { return at < n ? w[at++] : (at++, 0); }
  bool done() const { return at == n; }
};

}  // namespace

extern "C" int64_t tt_exchange_tiles(int64_t n) { return (n + TILE - 1) / TILE; }

// words: n, n_dev, bcap, mask, bin scratch, counts, dropped,
//        nk, key_i32, probe, per key (d, v or 0, lo, stride),
//        nl, dst, dst_stride, per lane (src, size, off)
extern "C" int tt_exchange(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  P p;
  p.n = t();
  p.n_dev = (int)t();
  p.bcap = t();
  p.mask = (const uint8_t*)t();
  p.bin = (uint8_t*)t();
  p.counts = (int*)t();
  p.dropped = (ll*)t();
  p.nk = (int)t();
  p.key_i32 = (int)t();
  p.probe = (int)t();
  if (p.n < 0 || p.n >= (1LL << 31) || p.n_dev < 1 || p.n_dev > MAX_DEV || p.bcap < 1 || p.nk < 1 || p.nk > MAXK)
    return -1;
  for (int k = 0; k < p.nk; ++k) {
    p.d[k] = (const ll*)t();
    p.v[k] = (const uint8_t*)t();
    p.lo[k] = t();
    p.stride[k] = t();
  }
  const int nl = (int)t();
  uint8_t* dst = (uint8_t*)t();
  const ll dst_stride = t();
  if (nl < 0 || t.at + 3 * nl != nwords) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(p.dropped, 0, sizeof(ll), s);
  if (rc || p.n == 0) return rc;
  p.ntiles = tt_exchange_tiles(p.n);
  LaneP none;
  none.nl = 0;
  none.dst = dst;
  none.dst_stride = dst_stride;
  tile_kernel<false><<<(unsigned)p.ntiles, BLOCK, 0, s>>>(p, none);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<(unsigned)(p.n_dev + 1), SCAN, 0, s>>>(p);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  for (int l0 = 0; l0 < nl; l0 += MAXL) {
    LaneP lp;
    lp.nl = nl - l0 < MAXL ? nl - l0 : MAXL;
    lp.dst = dst;
    lp.dst_stride = dst_stride;
    for (int l = 0; l < lp.nl; ++l) {
      lp.src[l] = (const uint8_t*)t();
      lp.size[l] = (int)t();
      lp.off[l] = t();
      if (lp.size[l] != 1 && lp.size[l] != 4 && lp.size[l] != 8) return -1;
    }
    tile_kernel<true><<<(unsigned)p.ntiles, BLOCK, 0, s>>>(p, lp);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
