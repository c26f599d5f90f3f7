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
// is bit-exact whatever the order of the folds.
//
// Bound: bytes. Each row reads seven int64 lanes and a valid byte (57
// bytes); the output is 48 * nseg bytes. At 3.35 TB/s and ~0.7 us of HBM
// latency an SM needs ~20 KB in flight, which a thread-per-row loop whose
// loads wait on each other (valid byte and ship, then rf / ls, then the
// values) and whose 48 register accumulators hold an SM to one or two
// blocks never reaches. So, for nseg <= 8 (the main path's: 8 in entry()'s
// spec, 6 in the dryrun's):
//
//   * A persistent grid of one block an SM walks tiles of TILE rows
//     (tile t, t + grid, ...). Thread 0 copies each tile's eight streams
//     (seven int64 lanes, the valid bytes) into shared memory with
//     Hopper's bulk copies (cp.async.bulk, completion on an mbarrier per
//     stage), STAGES tiles ahead: ~88 KB in flight an SM, independent of
//     the registers the accumulators take.
//   * No peeling and no second path for views at any row offset: a lane's
//     copy is the 16-byte-aligned window around its rows (a bulk copy
//     needs 16-byte addresses and sizes), and a row sits at the lane's
//     base address modulo 16 past the window's start (the same for every
//     tile, since a tile is a multiple of 16 bytes of every lane). The
//     window never leaves the 16-byte chunks holding the lane's own rows.
//   * Every lane of a tile is loaded; the mask, the code and the wrapping
//     products come from shared memory; each thread folds its rows into
//     NL x NSEG register accumulators (NSEG a template argument: selected
//     without indexing).
//   * One merge: the warps' shuffle trees and the block's shared slots
//     give a block partial, written to the stream's scratch; the last block
//     (an atomic ticket, left at zero) folds the partials and writes every
//     output word: no memset, no global atomics.
//
// A wider nseg (not on the main path) adds each row to the zeroed output
// with global atomics (q1_wide_kernel).
//
// Plain C interface (nvcc + ctypes): tt_q1_local launches on the given
// stream, never synchronizes, and returns the cudaError_t of the launch (0 =
// success), or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int NS = 8;        // the staged path's segments at most (kernels/q1_local.py NS)
constexpr int NL = 6;        // count, qty, price, disc_price, charge, disc
constexpr int NLANES = 7;    // the int64 input streams: qty, price, disc, tax, rf, ls, ship
constexpr int TILE = 512;    // rows a tile (kernels/q1_local.py TILE)
constexpr int STAGES = 4;    // tiles in flight a block (kernels/q1_local.py STAGES)
constexpr int BLOCK = 256;   // threads of a staged block
constexpr int WIDE_BLOCK = 256;
constexpr int LANE_BYTES = TILE * 8 + 16;  // an int64 lane's window: its rows and one 16-byte chunk
constexpr int RV_BYTES = TILE + 16;        // the valid bytes' window
constexpr int STAGE_BYTES = NLANES * LANE_BYTES + RV_BYTES;
constexpr int RED_AT = STAGES * STAGE_BYTES + STAGES * 8;  // after the stages and their mbarriers
constexpr int LAST_AT = RED_AT + (BLOCK / 32) * NL * NS * 8;  // the last-block flag
constexpr int SMEM_BYTES = LAST_AT + 16;
constexpr int PARTS_AT = 2;  // scratch words: the ticket, then the blocks' partials (kernels/q1_local.py)

static_assert(LANE_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0 && TILE % 16 == 0, "bulk copies need 16 bytes");
static_assert(SMEM_BYTES <= 227 * 1024, "one block an SM");

struct Lanes {
  const ll* l[NLANES];  // qty, price, disc, tax, rf, ls, ship
  const uint8_t* rv;
};

// --- Hopper's bulk copies and mbarriers -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// The 16-byte-aligned window [a0, a1) holding bytes [lo, hi) of a stream.
__device__ __forceinline__ uintptr_t window_start(uintptr_t lo) { return lo & ~(uintptr_t)15; }
__device__ __forceinline__ uint32_t window_bytes(uintptr_t lo, uintptr_t hi) {
  return (uint32_t)(((hi + 15) & ~(uintptr_t)15) - (lo & ~(uintptr_t)15));
}

// Thread 0: tile t's eight windows into stage `st`, completing on `bar`.
__device__ __forceinline__ void copy_tile(const Lanes& L, ll n, ll t, unsigned char* st, uint64_t* bar) {
  const ll r0 = t * TILE, r1 = r0 + TILE < n ? r0 + TILE : n;
  uint32_t bytes[NLANES + 1];
  uint32_t total = 0;
#pragma unroll
  for (int k = 0; k < NLANES; ++k) {
    bytes[k] = window_bytes((uintptr_t)(L.l[k] + r0), (uintptr_t)(L.l[k] + r1));
    total += bytes[k];
  }
  bytes[NLANES] = window_bytes((uintptr_t)(L.rv + r0), (uintptr_t)(L.rv + r1));
  total += bytes[NLANES];
  mbar_expect_tx(bar, total);
#pragma unroll
  for (int k = 0; k < NLANES; ++k)
    bulk_copy(st + k * LANE_BYTES, (const void*)window_start((uintptr_t)(L.l[k] + r0)), bytes[k], bar);
  bulk_copy(st + NLANES * LANE_BYTES, (const void*)window_start((uintptr_t)(L.rv + r0)), bytes[NLANES], bar);
}

// --- the staged kernel ----------------------------------------------------

template <int NSEG>
__global__ void __launch_bounds__(BLOCK, 1)
    q1_staged_kernel(const Lanes L, ll n, ll cutoff, ll* __restrict__ ticket, ull* __restrict__ parts,
                     ull* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  ull* red = reinterpret_cast<ull*>(smem + RED_AT);  // [warps][NL * NSEG]
  int& last_block = *reinterpret_cast<int*>(smem + LAST_AT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ll tiles = (n + TILE - 1) / TILE;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      const ll t = (ll)blockIdx.x + (ll)s * gridDim.x;
      if (t < tiles) copy_tile(L, n, t, smem + s * STAGE_BYTES, &bars[s]);
    }
  }
  // a row's place in its window: the stream's base address modulo 16
  int off[NLANES];
#pragma unroll
  for (int k = 0; k < NLANES; ++k) off[k] = (int)((uintptr_t)L.l[k] & 15);
  const int off_rv = (int)((uintptr_t)L.rv & 15);
  ull r[NL][NSEG];
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int g = 0; g < NSEG; ++g) r[l][g] = 0;
  for (ll k = 0;; ++k) {
    const ll t = (ll)blockIdx.x + k * gridDim.x;
    if (t >= tiles) break;
    const int s = (int)(k % STAGES);
    mbar_wait(&bars[s], (uint32_t)((k / STAGES) & 1));
    const unsigned char* st = smem + s * STAGE_BYTES;
    const ll* qty = reinterpret_cast<const ll*>(st + 0 * LANE_BYTES + off[0]);
    const ll* price = reinterpret_cast<const ll*>(st + 1 * LANE_BYTES + off[1]);
    const ll* disc = reinterpret_cast<const ll*>(st + 2 * LANE_BYTES + off[2]);
    const ll* tax = reinterpret_cast<const ll*>(st + 3 * LANE_BYTES + off[3]);
    const ll* rf = reinterpret_cast<const ll*>(st + 4 * LANE_BYTES + off[4]);
    const ll* ls = reinterpret_cast<const ll*>(st + 5 * LANE_BYTES + off[5]);
    const ll* ship = reinterpret_cast<const ll*>(st + 6 * LANE_BYTES + off[6]);
    const uint8_t* rv = st + NLANES * LANE_BYTES + off_rv;
    const ll left = n - t * TILE;
    const int rows = left < TILE ? (int)left : TILE;
    for (int i = tid; i < rows; i += BLOCK) {
      const ull q = (ull)qty[i], p = (ull)price[i], d = (ull)disc[i], x = (ull)tax[i];
      const ll code = (ll)((ull)rf[i] * 2ULL + (ull)ls[i]);
      const bool in = rv[i] != 0 && ship[i] <= cutoff && code >= 0 && code < NSEG;
      const ull dp = p * (100ULL - d);
      const ull v[NL] = {1ULL, q, p, dp, dp * (100ULL + x), d};
#pragma unroll
      for (int g = 0; g < NSEG; ++g) {
        if (in && code == g) {
#pragma unroll
          for (int l = 0; l < NL; ++l) r[l][g] += v[l];
        }
      }
    }
    __syncthreads();  // every thread is done with stage s: refill it
    if (tid == 0) {
      const ll tn = t + (ll)STAGES * gridDim.x;
      if (tn < tiles) copy_tile(L, n, tn, smem + s * STAGE_BYTES, &bars[s]);
    }
  }
  // the block's partial: a shuffle tree a warp, then the warps' slots
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int g = 0; g < NSEG; ++g) {
      ull x = r[l][g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) red[warp * NL * NSEG + l * NSEG + g] = x;
    }
  __syncthreads();
  const int S = NL * NSEG;
  if (tid < S) {
    ull x = 0;
    for (int w = 0; w < BLOCK / 32; ++w) x += red[w * S + tid];
    if (gridDim.x == 1)
      out[tid] = x;  // out is [NL, nseg] with nseg == NSEG: slot l * NSEG + g
    else
      parts[(ll)blockIdx.x * S + tid] = x;
  }
  if (gridDim.x == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(reinterpret_cast<ull*>(ticket), 1ULL) == (ull)(gridDim.x - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid < S) {
    ull x = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) x += __ldcg(parts + (ll)b * S + tid);
    out[tid] = x;
  }
  if (tid == 0) *ticket = 0;  // left at zero for the next call
}

// nseg > NS: each row into the zeroed output by global atomics
__global__ void q1_wide_kernel(const Lanes L, ll n, ll nseg, ll cutoff, ull* out) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x) {
    const ll code = (ll)((ull)L.l[4][i] * 2ULL + (ull)L.l[5][i]);
    if (!L.rv[i] || L.l[6][i] > cutoff || code < 0 || code >= nseg) continue;
    const ull p = (ull)L.l[1][i], d = (ull)L.l[2][i];
    const ull dp = p * (100ULL - d);
    const ull v[NL] = {1ULL, (ull)L.l[0][i], p, dp, dp * (100ULL + (ull)L.l[3][i]), d};
    for (int l = 0; l < NL; ++l) atomicAdd(&out[(ll)l * nseg + code], v[l]);
  }
}

template <int NSEG>
int launch_staged(const Lanes& L, ll n, ll cutoff, unsigned grid, ll* scratch, ull* out, cudaStream_t s) {
  // the dynamic shared-memory limit is a function's attribute on each
  // device: set once a device (a mesh's ranks launch from threads at
  // once; setting it twice does no harm)
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaGetLastError();
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit == 0 || !(set_on.load(std::memory_order_acquire) & bit)) {
    if (cudaFuncSetAttribute(q1_staged_kernel<NSEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    set_on.fetch_or(bit, std::memory_order_release);
  }
  q1_staged_kernel<NSEG><<<grid, BLOCK, SMEM_BYTES, s>>>(L, n, cutoff, scratch,
                                                        reinterpret_cast<ull*>(scratch) + PARTS_AT, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The staged kernel's grid for n rows: one block an SM, at most a block a
// tile, at least one (it writes the output even for n = 0).
extern "C" int64_t tt_q1_grid(int64_t n, int n_sms) {
  const ll tiles = (n + TILE - 1) / TILE;
  const ll cap = n_sms > 0 ? n_sms : 132;
  return tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
}

// nseg <= NS: `scratch` holds PARTS_AT + grid * NL * nseg int64 words, its
// first (the ticket) zero and left at zero. nseg > NS: scratch unused.
extern "C" int tt_q1_local(const int64_t* qty, const int64_t* price, const int64_t* disc, const int64_t* tax,
                           const int64_t* rf, const int64_t* ls, const int64_t* ship, const uint8_t* rv,
                           int64_t n, int64_t nseg, int64_t cutoff, int64_t* out, int n_sms, int64_t* scratch,
                           void* stream) {
  if (n < 0 || nseg < 1) return -1;
  const Lanes L{{(const ll*)qty, (const ll*)price, (const ll*)disc, (const ll*)tax, (const ll*)rf, (const ll*)ls,
                 (const ll*)ship},
                rv};
  for (int k = 0; k < NLANES; ++k)
    if ((uintptr_t)L.l[k] & 7) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (nseg <= NS) {
    if (scratch == nullptr) return -1;
    const unsigned grid = (unsigned)tt_q1_grid(n, n_sms);
    ull* o = reinterpret_cast<ull*>(out);
    switch (nseg) {
      case 1: return launch_staged<1>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 2: return launch_staged<2>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 3: return launch_staged<3>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 4: return launch_staged<4>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 5: return launch_staged<5>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 6: return launch_staged<6>(L, n, cutoff, grid, (ll*)scratch, o, s);
      case 7: return launch_staged<7>(L, n, cutoff, grid, (ll*)scratch, o, s);
      default: return launch_staged<8>(L, n, cutoff, grid, (ll*)scratch, o, s);
    }
  }
  cudaMemsetAsync(out, 0, sizeof(int64_t) * NL * nseg, s);
  int err = (int)cudaGetLastError();
  if (err != 0 || n == 0) return err;
  ll blocks = (n + WIDE_BLOCK - 1) / WIDE_BLOCK;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  q1_wide_kernel<<<(unsigned)blocks, WIDE_BLOCK, 0, s>>>(L, n, nseg, cutoff, (ull*)out);
  return (int)cudaGetLastError();
}
