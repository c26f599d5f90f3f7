// M3 hash_repartition: the local half of the MPP hash exchange — each
// valid row into its owner's send buffer, in row order.
//
// Replaces the body of local() in tidb_tpu/parallel/mesh.py:104
// hash_repartition up to its all_to_all: owner = key mod n_dev (floored,
// as jnp's %: CUDA's % truncates, so a negative remainder gets n_dev
// added; a power-of-two n_dev masks the key, which floors too), a stable
// argsort of the rows by owner (invalid rows last, in bin n_dev), per-owner
// counts and exclusive offsets, a scatter into [n_dev, cap] buffers, and
// the count of valid rows beyond cap. The collectives (all_to_all, the
// all_reduce of the dropped count) are torch.distributed calls in
// tidb_tpu_torch/parallel/mesh.py.
//
// Design: n_dev + 1 bins need no sort, only a stable counting partition,
// and owner o's rows go to slots o * cap + (their rank among o's rows), so
// a tile needs only each owner's rows in the tiles before it: one sweep
// with decoupled look-back (compact.cuh's take_tile and look_back, one
// look-back slot an owner and tile; the ranking and the look-back per
// owner are partition.cuh's, shared with P2), then a small fill. Two
// launches:
//
//   sweep   one tile of TILE rows a block, in ticket order. Each row's
//           key, payload and valid byte is read once (a warp reads 32
//           consecutive rows a round). n_dev 1 takes a path of its own,
//           the main path's: compact.cuh's place_tile — the valid rows
//           are a compaction carrying a payload — and each kept row is
//           written straight to its slot (a warp's kept rows are
//           consecutive slots). n_dev >= 2: each warp ranks its rows by
//           owner in row order (one ballot a bit of the bin, a running
//           count a warp and owner in shared memory), the tile's per-owner
//           counts are published at once, the rows are staged in shared
//           memory grouped by owner, warp w looks back owners w, w + 8,
//           ... and each owner's run goes to consecutive slots (coalesced
//           stores). The last tile writes each owner's total.
//   fill    zeros where no row lands — slots [min(total_o, cap), cap) of
//           each owner and the reference's emptied slot (o, cap - 1) —
//           `dropped`, and the look-back scratch back to zero for the next
//           call on the stream (grid-wide: at 1,024 owners a tile has
//           1,024 descriptors, too many for one last block). At n_dev 1
//           with every row valid it writes only `dropped` and the scratch.
//
// No buffer arrives zeroed and nothing is memset. The reference's scatter
// clips every target into [0, cap), so a row without a slot (in the last
// bucket, an invalid row too) also lands on slot cap - 1, and XLA's CPU
// scatter keeps the last writer there, a zero: slot (o, cap-1) stays empty
// when owner o has more than cap rows, or when o is the last owner, has
// exactly cap rows and some row is invalid. A tile cannot decide that
// (later tiles may add rows to o): the fill does, from the totals.
//
// A tile's look-back costs one warp look-back an owner: at 1,024 owners a
// warp runs 128 in sequence (each at least one round trip to L2), so a
// tile spends ≈ 0.1 ms there and n_dev 1,024 is correct but far slower
// than n_dev 1-8; its scratch is 16 bytes an owner and tile (128 MB at
// 16M rows and 1,024 owners).
//
// Bound: bytes. The keys, payload and valid bytes are read once and every
// slot of the buffers is written once (17 bytes a row and slot).
//
// Plain C interface (nvcc + ctypes): tt_hash_repartition launches the two
// kernels on the given stream, never synchronizes, and returns the
// cudaError_t of the launches (0 = success), or -1 for an argument it
// does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

#include "compact.cuh"
#include "partition.cuh"

namespace {

typedef long long ll;
using compact::LookBack;
using compact::P2;

constexpr int BLOCK = compact::BLOCK;
constexpr int ITEMS = compact::ITEMS;
constexpr int TILE = compact::TILE;  // rows a tile
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_DEV = 1024;
constexpr int PER = (MAX_DEV + BLOCK - 1) / BLOCK;  // owners a thread in the tile's scan
constexpr int FILL_PER_SM = 4;
constexpr unsigned FULL = 0xffffffffu;

struct P {
  const ll* keys;
  const ll* payload;
  const uint8_t* valid;
  ll n;
  int n_dev;
  ll cap;
  ll ntiles;
  ll* buf_k;
  ll* buf_p;
  uint8_t* buf_v;
  ll* dropped;
  ll* tot;  // [n_dev] each owner's valid rows, written by the last tile
};

__device__ __forceinline__ int owner_of(ll k, int nd) {
  if ((nd & (nd - 1)) == 0) return (int)(k & (ll)(nd - 1));
  ll r = k % nd;
  if (r < 0) r += nd;
  return (int)r;
}

__device__ __forceinline__ void put_row(const P& p, ll slot, ll k, ll v) {
  p.buf_k[slot] = k;
  p.buf_p[slot] = v;
  p.buf_v[slot] = 1;
}

// n_dev 1: the valid rows compacted, each written straight to its slot
__global__ void __launch_bounds__(BLOCK) one_kernel(const P p, const LookBack lb) {
  __shared__ compact::Temp tmp;
  __shared__ unsigned s_tile;
  const ll tile = compact::take_tile(lb, &s_tile);
  bool keep[ITEMS];
  ll k[ITEMS], v[ITEMS];
  unsigned kmask[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = compact::row_of(tile, j);
    const bool in = i < p.n;
    keep[j] = in && p.valid[i] != 0;
    k[j] = in ? p.keys[i] : 0;
    v[j] = in ? p.payload[i] : 0;
  }
  compact::place_tile(lb, tile, keep, kmask, tmp);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (!keep[j]) continue;
    const ll pos = compact::kept_before(tmp, kmask, j);
    if (pos < p.cap) put_row(p, pos, k[j], v[j]);
  }
  if (tile == p.ntiles - 1 && threadIdx.x == 0) p.tot[0] = tmp.base + tmp.count;
}

// dynamic shared memory of part_kernel at nd owners
__host__ __device__ inline size_t part_smem(int nd) {
  return (size_t)TILE * (8 + 8 + 2) + (size_t)nd * (8 + 4 * (WARPS + 2));
}

// n_dev >= 2: rank by owner, publish, stage grouped by owner, look back,
// write each owner's run
__global__ void __launch_bounds__(BLOCK) part_kernel(const P p, const LookBack lb) {
  typedef cub::BlockScan<int, BLOCK> Scan;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ unsigned s_tile;
  __shared__ int s_kept;
  const int nd = p.n_dev;
  ll* skey = (ll*)smem;                  // [TILE] the tile's valid rows, grouped by owner
  ll* spay = skey + TILE;                // [TILE]
  ll* gbase = spay + TILE;               // [nd] owner o's rows in the tiles before this one
  int* cnt = (int*)(gbase + nd);         // [WARPS][nd] each warp's rows of o → its first slot in o's run
  int* tcount = cnt + WARPS * nd;        // [nd] the tile's rows of o
  int* lstart = tcount + nd;             // [nd] where o's run starts in the staged tile
  uint16_t* sown = (uint16_t*)(lstart + nd);  // [TILE] each staged row's owner
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ll tile = compact::take_tile(lb, &s_tile);
  for (int j = threadIdx.x; j < WARPS * nd; j += BLOCK) cnt[j] = 0;
  // warp w's rows: 32 consecutive rows a round, ITEMS rounds
  const ll base = tile * TILE + (ll)w * 32 * ITEMS + lane;
  ll k[ITEMS], v[ITEMS];
  int o[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const ll i = base + r * 32;
    const bool in = i < p.n;
    o[r] = in && p.valid[i] != 0 ? 0 : nd;
    k[r] = in ? p.keys[i] : 0;
    v[r] = in ? p.payload[i] : 0;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if (o[r] == 0) o[r] = owner_of(k[r], nd);
  __syncthreads();  // cnt zeroed
  // 1. each row's rank among its warp's rows of its owner, in row order
  int rk[ITEMS];
  int* const c = cnt + w * nd;
  part::rank_rows(o, nd, c, rk);
  __syncthreads();
  // 2. per owner: each warp's first slot among the tile's rows of the
  //    owner, and the tile's count, published at once for the tiles after
  part::warp_offsets(lb, tile, nd, cnt, tcount);
  __syncthreads();
  // 3. where each owner's run starts in the staged tile
  {
    int cc[PER], total;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int oo = threadIdx.x * PER + q;
      cc[q] = oo < nd ? tcount[oo] : 0;
    }
    Scan(scan_tmp).ExclusiveSum(cc, cc, total);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int oo = threadIdx.x * PER + q;
      if (oo < nd) lstart[oo] = cc[q];
    }
    if (threadIdx.x == 0) s_kept = total;
  }
  __syncthreads();
  // 4. the rows staged grouped by owner, in row order within an owner
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (o[r] >= nd) continue;
    const int slot = lstart[o[r]] + c[o[r]] + rk[r];
    skey[slot] = k[r];
    spay[slot] = v[r];
    sown[slot] = (uint16_t)o[r];
  }
  // 5. each owner's rows in the tiles before: warp w looks back owners w, w + WARPS, ...
  part::look_back_owners(lb, tile, p.ntiles, nd, tcount, gbase, p.tot);
  __syncthreads();
  // 6. each owner's run to its consecutive slots
  for (int j = threadIdx.x; j < s_kept; j += BLOCK) {
    const int oo = sown[j];
    const ll pos = gbase[oo] + (j - lstart[oo]);
    if (pos < p.cap) put_row(p, (ll)oo * p.cap + pos, skey[j], spay[j]);
  }
}

__device__ __forceinline__ void clear_row(const P& p, ll slot) {
  p.buf_k[slot] = 0;
  p.buf_p[slot] = 0;
  p.buf_v[slot] = 0;
}

// zeros where no row landed — each owner's slots [min(total, cap), cap),
// spread evenly over the grid through the prefix of those ranges' lengths
// — the emptied slots, `dropped`, and the look-back scratch back to zero
__global__ void __launch_bounds__(BLOCK) fill_kernel(const P p, const LookBack lb) {
  typedef cub::BlockScan<ll, BLOCK> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ ll s_pre[MAX_DEV + 1];  // where each owner's zero range starts among them all
  __shared__ ll s_sum[WARPS], s_drop[WARPS];
  __shared__ ll s_invalid;
  const int nd = p.n_dev;
  const ll gt = (ll)blockIdx.x * BLOCK + threadIdx.x, gs = (ll)gridDim.x * BLOCK;
  if (gt == 0) {
    *lb.ticket() = 0u;
    *lb.done() = 0u;
  }
  for (ll j = gt; j < p.ntiles * nd; j += gs) compact::put_desc(lb.desc(j), 0, P2{0, 0});
  ll z[PER], sum = 0, drop = 0, zsum;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int o = threadIdx.x * PER + q;
    const ll t = o < nd && p.n > 0 ? p.tot[o] : 0;
    z[q] = o < nd ? p.cap - (t < p.cap ? t : p.cap) : 0;
    sum += t;
    drop += t > p.cap ? t - p.cap : 0;
  }
  Scan(scan_tmp).ExclusiveSum(z, z, zsum);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int o = threadIdx.x * PER + q;
    if (o < nd) s_pre[o] = z[q];
  }
  if (threadIdx.x == 0) s_pre[nd] = zsum;
  __syncthreads();
  for (ll f = gt; f < zsum; f += gs) {
    int lo = 0, hi = nd - 1;  // the last owner whose range starts at or before f: f lies in it
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_pre[mid] <= f) lo = mid; else hi = mid - 1;
    }
    clear_row(p, (ll)lo * p.cap + p.cap - (s_pre[lo + 1] - f));
  }
  if (blockIdx.x != 0) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, off);
    drop += __shfl_xor_sync(FULL, drop, off);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[w] = sum;
    s_drop[w] = drop;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ll a = 0, d = 0;
    for (int q = 0; q < WARPS; ++q) {
      a += s_sum[q];
      d += s_drop[q];
    }
    s_invalid = p.n - a;
    *p.dropped = d;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nd; o += BLOCK) {
    const ll t = p.n > 0 ? p.tot[o] : 0;
    if (t > p.cap || (o == nd - 1 && t == p.cap && s_invalid > 0)) clear_row(p, (ll)o * p.cap + p.cap - 1);
  }
}

int set_smem(int dev) {  // part_kernel's dynamic shared memory above 48 KB, once a device
  static bool done[64];
  if (dev < 0 || dev >= 64) return -1;
  if (done[dev]) return 0;
  const int rc = (int)cudaFuncSetAttribute(part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)part_smem(MAX_DEV));
  if (rc == 0) done[dev] = true;
  return rc;
}

}  // namespace

// scratch words of a call over n rows and n_dev owners: the owners'
// totals, then compact.cuh's look-back (one descriptor an owner and tile)
extern "C" int64_t tt_hash_repartition_scratch(int64_t n, int n_dev) {
  return MAX_DEV + compact::scratch_words(compact::tiles(n) * n_dev);
}

extern "C" int tt_hash_repartition(const int64_t* keys, const int64_t* payload, const uint8_t* valid, int64_t n,
                                   int n_dev, int64_t cap, int64_t* buf_k, int64_t* buf_p, uint8_t* buf_v,
                                   int64_t* dropped, int64_t* scratch, int n_sms, void* stream) {
  if (n < 0 || n_dev < 1 || n_dev > MAX_DEV || cap < 1 || n >= (1LL << 31)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  P p{(const ll*)keys, (const ll*)payload, valid, n, n_dev, cap, compact::tiles(n), (ll*)buf_k, (ll*)buf_p,
      buf_v, (ll*)dropped, (ll*)scratch};
  const LookBack lb{(ll*)scratch + MAX_DEV};
  if (n > 0) {
    if (n_dev == 1) {
      one_kernel<<<(unsigned)p.ntiles, BLOCK, 0, s>>>(p, lb);
    } else {
      int dev = 0;
      int rc = (int)cudaGetDevice(&dev);
      if (rc == 0) rc = set_smem(dev);
      if (rc) return rc;
      part_kernel<<<(unsigned)p.ntiles, BLOCK, part_smem(n_dev), s>>>(p, lb);
    }
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const ll work = p.ntiles * n_dev > (ll)n_dev * cap ? p.ntiles * n_dev : (ll)n_dev * cap;
  ll blocks = (work + (ll)BLOCK * 8 - 1) / ((ll)BLOCK * 8);
  const ll most = (ll)(n_sms > 0 ? n_sms : 132) * FILL_PER_SM;
  if (blocks > most) blocks = most;
  fill_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), BLOCK, 0, s>>>(p, lb);
  return (int)cudaGetLastError();
}
