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
// first bcap rows into its bucket. n_dev + 1 bins need no sort, only a
// stable counting partition: the design of M3's n_dev >= 2 path
// (csrc/hash_repartition.cu), whose ranking and per-owner look-back this
// file shares through partition.cuh. Two launches, whatever the lane count:
//
//   sweep   one tile of TILE rows a block, in ticket order (compact.cuh's
//           take_tile). Each row's owner is computed once from the mask and
//           its keys (owner_of). Each warp ranks its rows by owner in row
//           order, the tile publishes its per-owner counts at once and
//           looks back one slot an owner: every row's slot is then known
//           (rows of its owner before the tile + its warp's first slot +
//           its rank). Lane by lane, the tile's rows are staged in shared
//           memory grouped by owner — owner o's run placed so that a staged
//           index and its slot agree mod 16 (ALIGN) — and written out in
//           16-byte units: a unit that lies inside the run is one 16-byte
//           store (2 rows of an 8-byte lane, 4 of a 4-byte one, 16 of a
//           1-byte one), the run's partial first and last units element by
//           element. Two staging buffers alternate, so a lane costs one
//           barrier, and the next lane's rows are loaded into registers
//           before it (a lane's loads would otherwise wait out a memory
//           latency at every barrier). The last tile writes each owner's
//           total.
//   fill    zeroes what no row reached — slots [min(total_o, bcap), cap_l)
//           of every lane and owner (cap_l: the lane's slots up to its
//           16-byte-aligned end) and the row's end past the lanes — in
//           16-byte stores, writes `dropped` (the rows past bcap) and sets
//           the look-back scratch back to zero for the next call on the
//           stream.
//
// No buffer arrives zeroed and nothing is memset: every byte of the send
// buffer is written exactly once. kernels/exchange.layout puts every
// lane's slots at a 16-byte-aligned offset and makes a send row a multiple
// of 16 bytes, so a slot's 16-byte unit is aligned wherever it lies.
//
// Bound: bytes. The mask, the keys and every lane are read once; every
// byte of the send buffer is written once.
//
// Parameters travel by value (a kernel parameter, no upload): the lanes in
// the smallest of the LANE_CAPS tiers that holds them. Plain C interface
// (nvcc + ctypes): tt_exchange reads the call's int64 words on the host,
// launches the two kernels on the given stream, never synchronizes, and
// returns the cudaError_t of the launches (0 = success), or -1 for an
// argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "partition.cuh"

namespace {

typedef long long ll;
typedef unsigned long long ull;
using compact::LookBack;
using compact::P2;

constexpr int BLOCK = compact::BLOCK;
constexpr int ITEMS = compact::ITEMS;
constexpr int TILE = compact::TILE;  // rows a tile
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_DEV = 64;
constexpr int MAXK = 8;
constexpr int ALIGN = 16;  // a staged index and its slot agree mod ALIGN
// 16-byte units a tile's runs can touch, by lane class (8-, 4-, 1-byte
// lanes: 2, 4, 16 slots a unit): the rows over the slots a unit, plus a
// partial unit at each end of every owner's run
constexpr int UCAP0 = TILE / 2 + 2 * MAX_DEV;
constexpr int UCAP1 = TILE / 4 + 2 * MAX_DEV;
constexpr int UCAP2 = TILE / 16 + 2 * MAX_DEV;
// the sweep's launch bounds: blocks an SM (64 registers; at 1 the compiler
// took more registers and at 6 it spilled, and both ran slower: PERF.md,
// PR 17); shared memory holds it to 5 blocks an SM at 4 owners anyway
constexpr int SWEEP_BLOCKS = 4;
constexpr int FILL_PER_SM = 32;  // fill blocks an SM (8 and 16 ran slower)
constexpr int FILL_UNITS = 4;   // 16-byte units a fill thread stores at once
constexpr unsigned FULL = 0xffffffffu;

#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
constexpr int LANE_CAPS[] = {16, 64, 224, 1920};  // 1920 lanes: ≈ 31 KB of parameters (12.1+: up to 32,764 bytes)
#else
constexpr int LANE_CAPS[] = {16, 64, 224};  // within the 4 KB of parameters of older toolkits
#endif
constexpr int NCAPS = sizeof(LANE_CAPS) / sizeof(int);

struct Key {
  const ll* d;
  const uint8_t* v;  // null: the key lane has no valid lane
  ll lo, stride;
};

struct Lane {
  const uint8_t* src;
  ll off_size;  // byte offset of the lane's slots in a send row << 8 | element size (8, 4 or 1)
};

template <int CAP>
struct Args {
  ll n, bcap;
  ll row_bytes;  // bytes of one send row (a multiple of 16)
  ll at;         // where the lanes end in a send row
  ll ntiles;
  const uint8_t* mask;
  uint8_t* dst;
  ll* dropped;
  ll* tot;  // [MAX_DEV] each owner's rows, written by the sweep's last tile
  int n_dev, nk, key_i32, probe, nl;
  Key keys[MAXK];
  Lane lanes[CAP];
};

__device__ __forceinline__ int size_of(const Lane& L) { return (int)(L.off_size & 0xff); }
__device__ __forceinline__ ll off_of(const Lane& L) { return L.off_size >> 8; }
__device__ __forceinline__ int class_of(int sz) { return sz == 8 ? 0 : sz == 4 ? 1 : 2; }
__host__ __device__ __forceinline__ ll lane_bytes(ll bcap, int sz) { return (bcap * sz + 15) / 16 * 16; }

// the row's bin: its owner, or n_dev outside the mask (module note)
template <int CAP>
__device__ __forceinline__ int owner_of(const Args<CAP>& a, ll i) {
  if (!a.mask[i]) return a.n_dev;
  ull acc = 0ULL;
  bool kv = true;
  for (int k = 0; k < a.nk; ++k) {
    const Key& K = a.keys[k];
    acc += ((ull)K.d[i] - (ull)K.lo) * (ull)K.stride;
    if (K.v != nullptr && !K.v[i]) kv = false;
  }
  ll key = (ll)acc;
  if (a.key_i32) key = (ll)(int)(unsigned)(acc & 0xffffffffULL);
  if (a.probe && !kv) key = i;
  ll r = key % a.n_dev;
  if (r < 0) r += a.n_dev;
  return (int)r;
}

// exclusive prefix over nd <= 64 owners, two a lane (owners 2 * lane and
// 2 * lane + 1), run by one whole warp: → the total
__device__ __forceinline__ ll warp_excl2(ll& x0, ll& x1) {
  const int lane = threadIdx.x & 31;
  const ll pair = x0 + x1;
  ll inc = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const ll y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  const ll ex = inc - pair;
  x1 = ex + x0;
  x0 = ex;
  return __shfl_sync(FULL, inc, 31);
}

// one element of sz bytes from staged index s to slot pointer d
__device__ __forceinline__ void copy_elem(uint8_t* d, const uint8_t* s, int sz) {
  if (sz == 8) *(ull*)d = *(const ull*)s;
  else if (sz == 4) *(unsigned*)d = *(const unsigned*)s;
  else *d = *s;
}

// this thread's rows of lane L (the rows with an owner: pos[r] >= 0) into
// registers, whatever the element size
__device__ __forceinline__ void load_rows(const Lane& L, ll base, const int (&pos)[ITEMS], ull (&x)[ITEMS]) {
  const int sz = size_of(L);
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const ll i = base + r * 32;
    x[r] = 0;
    if (pos[r] < 0) continue;
    if (sz == 8) x[r] = __ldg((const ull*)L.src + i);
    else if (sz == 4) x[r] = __ldg((const unsigned*)L.src + i);
    else x[r] = __ldg(L.src + i);
  }
}

// dynamic shared memory of the sweep at nd owners: two staging buffers
__host__ __device__ inline size_t sweep_smem(int nd) { return 2 * (size_t)(TILE + ALIGN * nd) * 8; }

template <int CAP>
__global__ void __launch_bounds__(BLOCK, SWEEP_BLOCKS) sweep_kernel(const __grid_constant__ Args<CAP> a, const LookBack lb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cnt[WARPS * MAX_DEV];  // each warp's rows of o → its first slot among the tile's rows of o
  __shared__ int tcount[MAX_DEV];       // the tile's rows of o
  __shared__ int sstart[MAX_DEV];       // where o's run starts in a staging buffer
  __shared__ ll gbase[MAX_DEV];         // o's rows in the tiles before this one
  __shared__ int upre[3][MAX_DEV + 1];  // per lane class: units of the owners before o (the total last)
  __shared__ ll ufirst[3][MAX_DEV];     // per lane class: o's first unit in its bucket
  __shared__ uint8_t uown[UCAP0 + UCAP1 + UCAP2];  // each unit's owner, class by class
  __shared__ unsigned s_tile;
  const int nd = a.n_dev;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint8_t* const sbuf0 = smem;
  uint8_t* const sbuf1 = smem + (size_t)(TILE + ALIGN * nd) * 8;
  const ll tile = compact::take_tile(lb, &s_tile);
  for (int j = threadIdx.x; j < WARPS * nd; j += BLOCK) cnt[j] = 0;
  // warp w's rows: 32 consecutive rows a round, ITEMS rounds
  const ll base = tile * TILE + (ll)w * 32 * ITEMS + lane;
  int o[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const ll i = base + r * 32;
    o[r] = i < a.n ? owner_of(a, i) : nd;
  }
  __syncthreads();  // cnt zeroed
  int rk[ITEMS];
  part::rank_rows(o, nd, cnt + w * nd, rk);
  __syncthreads();
  part::warp_offsets(lb, tile, nd, cnt, tcount);
  __syncthreads();
  part::look_back_owners(lb, tile, a.ntiles, nd, tcount, gbase, a.tot);
  __syncthreads();
  if (w == 0) {  // staged starts, and each lane class's units per owner
    const int q0 = 2 * lane, q1 = q0 + 1;
    const ll t0 = q0 < nd ? tcount[q0] : 0, t1 = q1 < nd ? tcount[q1] : 0;
    ll p0 = q0 < nd ? t0 + ALIGN : 0, p1 = q1 < nd ? t1 + ALIGN : 0;
    warp_excl2(p0, p1);  // room of ALIGN slots an owner: the run fits after its shift
    if (q0 < nd) sstart[q0] = (int)(p0 + ((gbase[q0] - p0) & (ALIGN - 1)));
    if (q1 < nd) sstart[q1] = (int)(p1 + ((gbase[q1] - p1) & (ALIGN - 1)));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const ll V = c == 0 ? 2 : c == 1 ? 4 : 16;
      ll u[2], f[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + h;
        u[h] = f[h] = 0;
        if (q < nd) {
          const ll g0 = gbase[q], t = h ? t1 : t0;
          const ll g1 = g0 + t < a.bcap ? g0 + t : a.bcap;
          if (g1 > g0) {
            f[h] = g0 / V;
            u[h] = (g1 + V - 1) / V - f[h];
          }
        }
      }
      const ll total = warp_excl2(u[0], u[1]);
      if (q0 < nd) { upre[c][q0] = (int)u[0]; ufirst[c][q0] = f[0]; }
      if (q1 < nd) { upre[c][q1] = (int)u[1]; ufirst[c][q1] = f[1]; }
      if (lane == 0) upre[c][nd] = (int)total;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // each unit's owner: the last owner whose units start at or before it
    uint8_t* const own = uown + (c == 0 ? 0 : c == 1 ? UCAP0 : UCAP0 + UCAP1);
    for (int ui = threadIdx.x; ui < upre[c][nd]; ui += BLOCK) {
      int lo = 0, hi = nd - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (upre[c][mid] <= ui) lo = mid; else hi = mid - 1;
      }
      own[ui] = (uint8_t)lo;
    }
  }
  int pos[ITEMS];  // each row's staged index (-1: no owner)
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) pos[r] = o[r] < nd ? sstart[o[r]] + cnt[w * nd + o[r]] + rk[r] : -1;
  __syncthreads();  // uown written
  // lane by lane: lane l + 1's rows are loaded into registers while lane l
  // is staged and written, so each lane's loads are in flight across the
  // barrier before it
  ull cur[ITEMS], nxt[ITEMS];
  if (a.nl > 0) load_rows(a.lanes[0], base, pos, cur);
  for (int l = 0; l < a.nl; ++l) {
    const Lane L = a.lanes[l];
    if (l + 1 < a.nl) load_rows(a.lanes[l + 1], base, pos, nxt);
    const int sz = size_of(L), c = class_of(sz);
    const ll V = 16 / sz;
    uint8_t* const sb = (l & 1) ? sbuf1 : sbuf0;
    // stage: the tile's rows of this lane grouped by owner
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (pos[r] < 0) continue;
      if (sz == 8) ((ull*)sb)[pos[r]] = cur[r];
      else if (sz == 4) ((unsigned*)sb)[pos[r]] = (unsigned)cur[r];
      else sb[pos[r]] = (uint8_t)cur[r];
    }
    __syncthreads();
    // write: each unit of every owner's run, 16 bytes at once where the run covers it
    const uint8_t* const own = uown + (c == 0 ? 0 : c == 1 ? UCAP0 : UCAP0 + UCAP1);
    const ll off = off_of(L);
    for (int ui = threadIdx.x; ui < upre[c][nd]; ui += BLOCK) {
      const int q = own[ui];
      const ll g0 = gbase[q], g1 = g0 + tcount[q] < a.bcap ? g0 + tcount[q] : a.bcap;
      const ll p0 = (ufirst[c][q] + (ui - upre[c][q])) * V;
      const ll s0 = p0 - g0 + sstart[q];  // p0's staged index (≡ p0 mod ALIGN)
      uint8_t* const d = a.dst + (ll)q * a.row_bytes + off + p0 * sz;
      if (p0 >= g0 && p0 + V <= g1) {
        *(uint4*)d = *(const uint4*)(sb + s0 * sz);
      } else {
        for (int k = 0; k < (int)V; ++k)
          if (p0 + k >= g0 && p0 + k < g1) copy_elem(d + k * sz, sb + (s0 + k) * sz, sz);
      }
    }
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) cur[r] = nxt[r];
    // no barrier: the next lane stages into the other buffer, which the
    // last reads of it (lane l - 1) finished before this lane's barrier
  }
}

// zeroes where no row landed (every lane's slots [min(total, bcap), cap_l)
// of each owner, 16 bytes a store; blockIdx.y is the lane), `dropped`, the
// row's end past the lanes and the look-back scratch
template <int CAP>
__global__ void __launch_bounds__(BLOCK) fill_kernel(const __grid_constant__ Args<CAP> a, const LookBack lb) {
  __shared__ ll zpre[MAX_DEV + 1];  // zero units of the owners before o (the total last)
  __shared__ ll zb0[MAX_DEV];       // o's first byte to zero in the lane's slots
  const int nd = a.n_dev, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ll fb = (ll)blockIdx.y * gridDim.x + blockIdx.x;
  const ll gt = fb * BLOCK + threadIdx.x, gs = (ll)gridDim.x * gridDim.y * BLOCK;
  if (gt == 0) {
    *lb.ticket() = 0u;
    *lb.done() = 0u;
  }
  for (ll j = gt; j < a.ntiles * nd; j += gs) compact::put_desc(lb.desc(j), 0, P2{0, 0});
  if (fb == 0) {
    if (w == 0) {
      ll drop = 0;
      for (int q = lane; q < nd; q += 32) {
        const ll t = a.n > 0 ? a.tot[q] : 0;
        drop += t > a.bcap ? t - a.bcap : 0;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) drop += __shfl_xor_sync(FULL, drop, off);
      if (lane == 0) *a.dropped = drop;
    }
    for (ll j = threadIdx.x; j < (ll)nd * (a.row_bytes - a.at); j += BLOCK)  // a row's end past the lanes
      a.dst[j / (a.row_bytes - a.at) * a.row_bytes + a.at + j % (a.row_bytes - a.at)] = 0;
  }
  if ((int)blockIdx.y >= a.nl) return;
  const Lane L = a.lanes[blockIdx.y];
  const int sz = size_of(L);
  const ll off = off_of(L), units = lane_bytes(a.bcap, sz) / 16;
  if (w == 0) {
    const int q0 = 2 * lane, q1 = q0 + 1;
    ll z0 = 0, z1 = 0;
    if (q0 < nd) {
      const ll t = a.n > 0 ? a.tot[q0] : 0;
      zb0[q0] = (t < a.bcap ? t : a.bcap) * sz;
      z0 = units - zb0[q0] / 16;
    }
    if (q1 < nd) {
      const ll t = a.n > 0 ? a.tot[q1] : 0;
      zb0[q1] = (t < a.bcap ? t : a.bcap) * sz;
      z1 = units - zb0[q1] / 16;
    }
    const ll total = warp_excl2(z0, z1);
    if (q0 < nd) zpre[q0] = z0;
    if (q1 < nd) zpre[q1] = z1;
    if (lane == 0) zpre[nd] = total;
  }
  __syncthreads();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const ll total = zpre[nd];
  for (ll f0 = (ll)blockIdx.x * BLOCK * FILL_UNITS + threadIdx.x; f0 < total; f0 += (ll)gridDim.x * BLOCK * FILL_UNITS) {
#pragma unroll
    for (int k = 0; k < FILL_UNITS; ++k) {  // FILL_UNITS stores in flight a thread
      const ll f = f0 + k * BLOCK;
      if (f >= total) break;
      int lo = 0, hi = nd - 1;  // the last owner whose units start at or before f
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (zpre[mid] <= f) lo = mid; else hi = mid - 1;
      }
      const ll u = zb0[lo] / 16 + (f - zpre[lo]);
      uint8_t* const row = a.dst + (ll)lo * a.row_bytes + off;
      if (u * 16 >= zb0[lo]) {
        *(uint4*)(row + u * 16) = zero;
      } else {  // the unit holds the owner's last rows: zero only past them
        for (ll b = zb0[lo]; b < (u + 1) * 16; ++b) row[b] = 0;
      }
    }
  }
}

int set_smem(int dev) {  // the sweeps' dynamic shared memory above 48 KB, once a device
  static bool done[64];
  if (dev < 0 || dev >= 64) return -1;
  if (done[dev]) return 0;
  int rc = 0;
  rc = rc ? rc : (int)cudaFuncSetAttribute(sweep_kernel<LANE_CAPS[0]>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sweep_smem(MAX_DEV));
  rc = rc ? rc : (int)cudaFuncSetAttribute(sweep_kernel<LANE_CAPS[1]>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sweep_smem(MAX_DEV));
  rc = rc ? rc : (int)cudaFuncSetAttribute(sweep_kernel<LANE_CAPS[2]>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sweep_smem(MAX_DEV));
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  rc = rc ? rc : (int)cudaFuncSetAttribute(sweep_kernel<LANE_CAPS[3]>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sweep_smem(MAX_DEV));
#endif
  if (rc == 0) done[dev] = true;
  return rc;
}

struct Words {
  const int64_t* w;
  int n;
  int at;
  int64_t operator()() { return at < n ? w[at++] : (at++, 0); }
};

template <int CAP>
int launch(Words& t, ll nl, ll* scratch, int n_sms, cudaStream_t s, const Args<16>& head) {
  Args<CAP> a;
  a.n = head.n;
  a.bcap = head.bcap;
  a.row_bytes = head.row_bytes;
  a.mask = head.mask;
  a.dst = head.dst;
  a.dropped = head.dropped;
  a.n_dev = head.n_dev;
  a.nk = head.nk;
  a.key_i32 = head.key_i32;
  a.probe = head.probe;
  for (int k = 0; k < MAXK; ++k) a.keys[k] = head.keys[k];
  a.nl = (int)nl;
  a.at = 0;
  for (int l = 0; l < a.nl; ++l) {
    const ll src = t(), off = t(), sz = t();
    if ((sz != 1 && sz != 4 && sz != 8) || off < 0 || off % 16 != 0 || off >= (1LL << 55)) return -1;
    a.lanes[l].src = (const uint8_t*)src;
    a.lanes[l].off_size = off << 8 | sz;
    const ll end = off + lane_bytes(a.bcap, (int)sz);
    if (end > a.row_bytes) return -1;
    if (end > a.at) a.at = end;
  }
  a.ntiles = compact::tiles(a.n);
  a.tot = scratch;
  const LookBack lb{scratch + MAX_DEV};
  if (a.n > 0) {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = set_smem(dev);
    if (rc) return rc;
    sweep_kernel<CAP><<<(unsigned)a.ntiles, BLOCK, sweep_smem(a.n_dev), s>>>(a, lb);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  // grid: one row of blocks a lane, enough of them for the largest lane's zeros
  const ll ny = a.nl > 0 ? a.nl : 1;
  const ll most = (ll)(n_sms > 0 ? n_sms : 132) * FILL_PER_SM;
  ll nx = ((ll)a.n_dev * (lane_bytes(a.bcap, 8) / 16) + (ll)BLOCK * FILL_UNITS - 1) / ((ll)BLOCK * FILL_UNITS);
  const ll cap = most / ny > 1 ? most / ny : 1;
  if (nx > cap) nx = cap;
  if (nx < 1) nx = 1;
  fill_kernel<CAP><<<dim3((unsigned)nx, (unsigned)ny), BLOCK, 0, s>>>(a, lb);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch words of a call over n rows and n_dev owners: the owners'
// totals, then compact.cuh's look-back (one descriptor an owner and tile)
extern "C" int64_t tt_exchange_scratch(int64_t n, int n_dev) {
  return MAX_DEV + compact::scratch_words(compact::tiles(n) * n_dev);
}

// the most lanes one call takes
extern "C" int tt_exchange_max_lanes() { return LANE_CAPS[NCAPS - 1]; }

// words: n, n_dev, bcap, mask, dst, row_bytes, dropped, nk, key_i32,
//        probe, per key (d, v or 0, lo, stride), nl, per lane (src, byte
//        offset, size)
extern "C" int tt_exchange(const int64_t* w, int nwords, int64_t* scratch, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  Args<16> h;
  h.n = t();
  h.n_dev = (int)t();
  h.bcap = t();
  h.mask = (const uint8_t*)t();
  h.dst = (uint8_t*)t();
  h.row_bytes = t();
  h.dropped = (ll*)t();
  h.nk = (int)t();
  h.key_i32 = (int)t();
  h.probe = (int)t();
  if (h.n < 0 || h.n >= (1LL << 31) || h.n_dev < 1 || h.n_dev > MAX_DEV || h.bcap < 1 || h.nk < 1 ||
      h.nk > MAXK || h.row_bytes < 16 || h.row_bytes % 16 != 0)
    return -1;
  for (int k = 0; k < MAXK; ++k) h.keys[k] = Key{nullptr, nullptr, 0, 0};
  for (int k = 0; k < h.nk; ++k) {
    h.keys[k].d = (const ll*)t();
    h.keys[k].v = (const uint8_t*)t();
    h.keys[k].lo = t();
    h.keys[k].stride = t();
  }
  const ll nl = t();
  if (nl < 0 || nl > LANE_CAPS[NCAPS - 1] || t.at + 3 * nl != nwords) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  ll* sc = (ll*)scratch;
  if (nl <= LANE_CAPS[0]) return launch<LANE_CAPS[0]>(t, nl, sc, n_sms, s, h);
  if (nl <= LANE_CAPS[1]) return launch<LANE_CAPS[1]>(t, nl, sc, n_sms, s, h);
  if (nl <= LANE_CAPS[2]) return launch<LANE_CAPS[2]>(t, nl, sc, n_sms, s, h);
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  return launch<LANE_CAPS[3]>(t, nl, sc, n_sms, s, h);
#else
  return -1;
#endif
}
