// K8 lex_sort: stable lexicographic sort permutation over key operands.
//
// Replaces tidb_tpu/copr/tpu_engine.py:195-208 lex_sort_perm, which
// chains single-key stable lax.sorts (most significant operand first,
// ties by row id). The same permutation comes out of a one-sweep LSD
// radix sort written by hand:
//
//   1. orand_kernel: per operand, the OR and the AND of its
//      order-preserving unsigned key over all rows. OR ^ AND are the bits
//      that vary; every other bit is constant and cannot order anything.
//      The operands' addresses travel as kernel parameters.
//   2. The host (kernels/lex_sort.py) reads the OR/AND once, packs each
//      operand's varying bit range, least significant operand lowest,
//      into composite words of at most 64 bits, and uploads every word's
//      field descriptors in one copy. A flag operand costs one bit, a
//      constant operand none. A word of at most 32 bits sorts 4-byte keys
//      (the plan's key_bytes).
//   3. Per word, least significant word first:
//        build_keys  gathers the word's fields through the permutation so
//                    far (a task field, the row's task = row / task_width,
//                    is computed, not read), writes the keys, and counts
//                    every 8-bit digit of the word at once into
//                    [passes, 256] global counts (the up-front histogram);
//        pass_kernel one launch per 8-bit digit. A tile (256 threads x
//                    16 rows, 24 for 4-byte keys, in dynamic shared
//                    memory) takes its index from an atomic counter, ranks
//                    its rows by digit stably in index order (each warp's
//                    run as two interleaved chains, peers found by one
//                    ballot a digit bit, then per digit across the
//                    chains), publishes its per-digit
//                    counts with decoupled look-back, stages the rows in
//                    shared memory grouped by digit, and once its prefix
//                    is known writes each digit's run to its global slots
//                    (coalesced stores). The digit offsets are each
//                    block's own exclusive scan of the up-front counts.
//
// Decoupled look-back: one 64-bit flag a (tile, digit) holds the epoch
// (the call's pass number, from 1), the kind (aggregate: the tile's own
// count; inclusive: the count of every tile up to it) and the count, so
// value and status are one store and one load: no fence is needed
// between them. The flags are zeroed once per call; a flag from an
// earlier pass carries an older epoch and reads as not yet published. A
// tile waits only on tiles whose index is lower, which an atomic counter
// hands out in the order the blocks start, so it never waits on a block
// that is not running.
//
// Order-preserving keys, per operand kind: csrc/sort_key.cuh (shared
// with K7).
//
// Task-leading mode (K10's sort, tidb_tpu/copr/tpu_engine.py:1096-1134
// vmapping lex_sort_perm over a launch group): G tasks' rows laid out as
// [G, width] sort by (task, operands...). The host puts the task, row /
// width, into the most significant ceil(log2 G) bits of the last word;
// no task lane is materialized. The passes stay LSD and stable, so task
// g's sorted rows are exactly perm[g*width, (g+1)*width) in its own
// stable order: a segmented sort with fixed segments in one radix sort,
// with one OR/AND (and one host read) for the whole group.
//
// Bound: bytes. The operands are read once by orand_kernel and once per
// word by build_keys (which writes the keys); each pass reads and writes
// a key and a row id: 24 bytes a row with 8-byte keys, 16 with 4-byte
// keys (the first pass of a word reads the permutation so far as its row
// ids, the last writes only them). Passes follow the data: TPC-H
// lineitem's extendedprice varies in 24 bits, so a DESC price key costs
// 3 passes, not 8.
//
// Plain C interface (nvcc + ctypes). Every entry point launches on the
// given stream, never synchronizes, and returns the cudaError_t of its
// launches (0 = success), or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sort_key.cuh"

namespace {

using u64 = unsigned long long;
using u32 = unsigned int;

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3, K_TASK = 4 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // = kRadix: thread t owns digit t
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = 2 * kWarps;  // a pass ranks each warp's run as two chains
constexpr int kMaxOps = 32;     // operands per orand launch (kernel parameters)
constexpr int kHistParts = 2;   // copies of the up-front histogram: lane & 1 picks one
constexpr int kBuildPerSm = 8;  // build_keys blocks per SM
// look-back flag: epoch << 34 | kind << 32 | count
constexpr u64 kAggregate = 1ULL << 32;
constexpr u64 kInclusive = 2ULL << 32;
constexpr int kEpochShift = 34;
constexpr int kLookBack = 8;  // flags a look-back step reads at once

template <typename KeyT>
struct TileOf;
template <>
struct TileOf<u64> {
  static constexpr int kItems = 16;
};
template <>
struct TileOf<u32> {
  static constexpr int kItems = 24;
};
constexpr int kMinTile = kThreads * 16;  // the smaller tile: sizes the flags

struct OpArgs {  // the operands of one orand launch, by value
  const void* data[kMaxOps];
  int32_t kind[kMaxOps];
  int32_t nops;
};

struct FieldDesc {  // int64 triples: ptr, kind | src_shift << 32, width | dst_shift << 32
  const void* data;  // null for K_TASK
  int32_t kind;
  int32_t src_shift;
  int32_t width;
  int32_t dst_shift;
};

__device__ __forceinline__ u64 ordered(const void* data, int32_t kind, int64_t row) {
  return sort_key::load_key(data, kind, row);
}

__global__ void init_orand(u64* orand, int nops) {
  for (int t = threadIdx.x; t < nops; t += blockDim.x) {
    orand[2 * t] = 0ULL;
    orand[2 * t + 1] = ~0ULL;
  }
}

__global__ void orand_kernel(const OpArgs ops, int64_t n, u64* orand) {
  __shared__ u64 s_or[kWarps], s_and[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k = 0; k < ops.nops; ++k) {
    const void* data = ops.data[k];
    const int32_t kind = ops.kind[k];
    u64 o = 0ULL, a = ~0ULL;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      u64 u = ordered(data, kind, i);
      o |= u;
      a &= u;
    }
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_xor_sync(kFull, o, off);
      a &= __shfl_xor_sync(kFull, a, off);
    }
    if (lane == 0) {
      s_or[w] = o;
      s_and[w] = a;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 1; q < kWarps; ++q) {
        o |= s_or[q];
        a &= s_and[q];
      }
      atomicOr(&orand[2 * k], o);
      atomicAnd(&orand[2 * k + 1], a);
    }
    __syncthreads();
  }
}

// The word's keys and its up-front histogram: counts[p * 256 + d] += rows
// whose digit p is d. A digit the same in every row of a warp is counted
// with one atomic (redux.sync), any other one per row into one of
// kHistParts copies, so that a warp's same-digit rows conflict at most
// 16 ways.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads) build_keys(const FieldDesc* __restrict__ f, int nf, int64_t n,
                                                       int64_t task_width, const int32_t* __restrict__ perm_in,
                                                       KeyT* __restrict__ keys, int passes,
                                                       u32* __restrict__ counts) {
  extern __shared__ u32 h[];  // [kHistParts][passes][256]
  const int span = passes * kRadix;
  for (int j = threadIdx.x; j < kHistParts * span; j += blockDim.x) h[j] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  u32* mine = h + (lane & (kHistParts - 1)) * span;
  // i0 is the same for the whole block: every lane of a warp takes part in
  // each round's warp intrinsics
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x; i0 < n; i0 += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = i0 + threadIdx.x;
    const bool ok = i < n;
    u64 key = 0ULL;
    if (ok) {
      const int64_t row = perm_in != nullptr ? (int64_t)perm_in[i] : i;
      for (int j = 0; j < nf; ++j) {
        u64 u = (f[j].kind == K_TASK ? (u64)(row / task_width) : ordered(f[j].data, f[j].kind, row)) >>
                f[j].src_shift;
        if (f[j].width < 64) u &= (1ULL << f[j].width) - 1ULL;
        key |= u << f[j].dst_shift;
      }
      keys[i] = (KeyT)key;
    }
    const unsigned live = __ballot_sync(kFull, ok);
    for (int p = 0; p < passes; ++p) {
      const u32 d = (u32)(key >> (8 * p)) & 0xFFu;
      const u32 lo = __reduce_min_sync(kFull, ok ? d : 0xFFFFFFFFu);
      const u32 hi = __reduce_max_sync(kFull, ok ? d : 0u);
      if (lo == hi) {
        if (lane == __ffs(live) - 1) atomicAdd(&h[p * kRadix + d], (u32)__popc(live));
      } else if (ok) {
        atomicAdd(&mine[p * kRadix + d], 1u);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    u32 s = 0u;
    for (int q = 0; q < kHistParts; ++q) s += h[q * span + j];
    if (s != 0u) atomicAdd(&counts[j], s);
  }
}

// Exclusive scans of two int32 per thread over a 256-thread block, at once.
__device__ __forceinline__ int2 block_excl_scan2_256(int32_t a, int32_t b, int2* ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t va = a, vb = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t ya = __shfl_up_sync(kFull, va, off), yb = __shfl_up_sync(kFull, vb, off);
    if (lane >= off) {
      va += ya;
      vb += yb;
    }
  }
  if (lane == 31) ws[w] = make_int2(va, vb);
  __syncthreads();
  int32_t pa = 0, pb = 0;
  for (int q = 0; q < w; ++q) {
    pa += ws[q].x;
    pb += ws[q].y;
  }
  __syncthreads();
  return make_int2(pa + va - a, pb + vb - b);
}

// The lanes of the warp whose digit (0..256) equals this lane's: one ballot
// a bit of the digit (cheaper than __match_any_sync here).
__device__ __forceinline__ unsigned peers_of(u32 d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bb = __ballot_sync(kFull, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? bb : ~bb;
  }
  return peers;
}

__device__ __forceinline__ u64 load_flag(const u64* p) { return *(const volatile u64*)p; }
__device__ __forceinline__ void store_flag(u64* p, u64 v) { *(volatile u64*)p = v; }

// One 8-bit LSD pass over the digit at `shift`: keys_in/vals_in (null =
// row ids 0..n-1) -> keys_out (null on the word's last pass) / vals_out.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads, 2)
    pass_kernel(const KeyT* __restrict__ keys_in, const int32_t* __restrict__ vals_in, int64_t n, int shift,
                const u32* __restrict__ counts, u32* __restrict__ tile_ctr, u64* flags, u64 epoch,
                KeyT* __restrict__ keys_out, int32_t* __restrict__ vals_out) {
  constexpr int kItems = TileOf<KeyT>::kItems;
  constexpr int kTile = kThreads * kItems;
  extern __shared__ unsigned char smem[];
  KeyT* skey = (KeyT*)smem;                  // [kTile]
  int32_t* sval = (int32_t*)(skey + kTile);  // [kTile]
  __shared__ u32 whist[kChains][kRadix];     // digit counts of each chain, then its first slot in the digit
  __shared__ int32_t lstart[kRadix];         // tile-local slot of the tile's first row of digit d
  __shared__ int32_t gbase[kRadix];          // global slot of the same row
  __shared__ int2 ws[kWarps];
  __shared__ u32 s_tile;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) s_tile = atomicAdd(tile_ctr, 1u);
  for (int q = 0; q < kChains; ++q) whist[q][t] = 0u;
  __syncthreads();
  const int64_t tile = (int64_t)s_tile;
  // warp w owns rows [base, base + 32 * kItems) of the tile, 32 a round
  const int64_t base = tile * kTile + (int64_t)w * 32 * kItems;
  KeyT key[kItems];
  int32_t val[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * 32 + lane;
    const bool ok = i < n;
    key[r] = ok ? keys_in[i] : (KeyT)0;
    val[r] = ok ? (vals_in != nullptr ? vals_in[i] : (int32_t)i) : 0;
  }
  // 1. rank in index order within a digit: digit << 16 | rank. The warp's
  //    run is two chains, its first half and its second, each ranked on
  //    its own counters (chain 2w + h), so their rounds interleave; the
  //    chains' order is the rows' order
  u32 dr[kItems];
  const unsigned lt = (1u << lane) - 1u;
  constexpr int kHalf = kItems / 2;
  u32* const c0 = whist[2 * w];
  u32* const c1 = whist[2 * w + 1];
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    const bool ok0 = base + r * 32 + lane < n, ok1 = base + (kHalf + r) * 32 + lane < n;
    const u32 d0 = ok0 ? (u32)(key[r] >> shift) & 0xFFu : (u32)kRadix;
    const u32 d1 = ok1 ? (u32)(key[kHalf + r] >> shift) & 0xFFu : (u32)kRadix;
    const unsigned p0 = peers_of(d0), p1 = peers_of(d1);
    const u32 b0 = ok0 ? c0[d0] : 0u, b1 = ok1 ? c1[d1] : 0u;
    __syncwarp();
    if (ok0 && (p0 & lt) == 0u) c0[d0] = b0 + (u32)__popc(p0);
    if (ok1 && (p1 & lt) == 0u) c1[d1] = b1 + (u32)__popc(p1);
    __syncwarp();
    dr[r] = (d0 << 16) | (b0 + (u32)__popc(p0 & lt));
    dr[kHalf + r] = (d1 << 16) | (b1 + (u32)__popc(p1 & lt));
  }
  __syncthreads();
  // 2. digit t: each chain's count becomes its first slot within the digit
  u32 mine = 0u;
  for (int q = 0; q < kChains; ++q) {
    const u32 c = whist[q][t];
    whist[q][t] = mine;
    mine += c;
  }
  // publish the tile's count at once: the tiles after it look back on it
  u64* flag = flags + tile * kRadix + t;
  const u64 tag = epoch << kEpochShift;
  store_flag(flag, tag | (tile == 0 ? kInclusive : kAggregate) | (u64)mine);
  // the tile's digit starts, and the digits' global starts from the
  // up-front counts
  const int2 starts = block_excl_scan2_256((int32_t)mine, (int32_t)counts[t], ws);
  lstart[t] = starts.x;
  const int32_t doff = starts.y;
  __syncthreads();
  // 3. stage the tile in shared memory, grouped by digit
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const u32 d = dr[r] >> 16;
    if (d < (u32)kRadix) {
      const int32_t slot = lstart[d] + (int32_t)whist[2 * w + (r >= kHalf)][d] + (int32_t)(dr[r] & 0xFFFFu);
      skey[slot] = key[r];
      sval[slot] = val[r];
    }
  }
  // 4. look-back: digit t's rows in the tiles before this one, a window of
  //    kLookBack flags a step (their loads overlap), summed in order up to
  //    the first inclusive one; a flag not yet published is waited on
  u32 excl = 0u;
  if (tile > 0) {
    int64_t j = tile - 1;
    for (bool found = false; !found;) {
      u64 fl[kLookBack];
#pragma unroll
      for (int q = 0; q < kLookBack; ++q) fl[q] = j - q >= 0 ? load_flag(flags + (j - q) * kRadix + t) : 0ULL;
      int q = 0;
      for (; q < kLookBack; ++q) {
        if ((fl[q] >> kEpochShift) != epoch) break;
        excl += (u32)fl[q];
        if (fl[q] & kInclusive) {
          found = true;
          break;
        }
      }
      j -= q;  // tile 0 is always inclusive: j never passes it
    }
    store_flag(flag, tag | kInclusive | (u64)(excl + mine));
  }
  gbase[t] = doff + (int32_t)excl;
  __syncthreads();
  // 5. write out: neighbouring slots of one digit go to neighbouring
  //    global slots, so the stores coalesce
  const int64_t first = tile * kTile;
  const int len = (int)(n - first < kTile ? n - first : kTile);
  for (int j = t; j < len; j += kThreads) {
    const KeyT k = skey[j];
    const int d = (int)((k >> shift) & 0xFF);
    const int32_t pos = gbase[d] + (j - lstart[d]);
    if (keys_out != nullptr) keys_out[pos] = k;
    vals_out[pos] = sval[j];
  }
}

int grid_for(int64_t n, int n_sms, int per_sm) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)(n_sms > 0 ? n_sms : 132) * per_sm;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

template <typename KeyT>
size_t pass_smem() {
  return (size_t)kThreads * TileOf<KeyT>::kItems * (sizeof(KeyT) + sizeof(int32_t));
}

// cudaFuncSetAttribute for pass_kernel<KeyT>'s dynamic shared memory, once
// per card.
template <typename KeyT>
int allow_pass_smem(size_t bytes) {
  static std::atomic<unsigned> done{0u};  // a bit a card
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0 || (dev < 32 && ((done.load() >> dev) & 1u))) return err;
  err = (int)cudaFuncSetAttribute(pass_kernel<KeyT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0 && dev < 32) done.fetch_or(1u << dev);
  return err;
}

template <typename KeyT>
int sort_word(const FieldDesc* fields, int nfields, int passes, int64_t n, int64_t task_width,
              const int32_t* perm_in, KeyT* key_a, KeyT* key_b, int32_t* val_a, int32_t* val_b, u32* counts,
              u32* tile_ctr, u64* flags, int epoch0, int32_t* perm_out, int keep_keys, int n_sms, cudaStream_t s) {
  const size_t smem = pass_smem<KeyT>();
  int err = allow_pass_smem<KeyT>(smem);
  if (err != 0) return err;
  const size_t hsmem = (size_t)kHistParts * passes * kRadix * sizeof(u32);
  build_keys<KeyT><<<grid_for(n, n_sms, kBuildPerSm), kThreads, hsmem, s>>>(fields, nfields, n, task_width,
                                                                            perm_in, key_a, passes, counts);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t tiles = (n + kThreads * TileOf<KeyT>::kItems - 1) / (kThreads * TileOf<KeyT>::kItems);
  KeyT* ks = key_a;
  KeyT* kd = key_b;
  const int32_t* vs = perm_in;  // the first pass reads the permutation so far as its row ids
  int32_t* vd = val_a;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    pass_kernel<KeyT><<<(unsigned)tiles, kThreads, smem, s>>>(ks, vs, n, 8 * p, counts + p * kRadix,
                                                               tile_ctr + p, flags, (u64)(epoch0 + p + 1),
                                                               last && !keep_keys ? nullptr : kd,
                                                               last ? perm_out : vd);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    KeyT* kt = ks;
    ks = kd;
    kd = kt;
    vs = vd;
    vd = vd == val_a ? val_b : val_a;
  }
  return 0;
}

}  // namespace

// Uint64 slots of the look-back flags for n rows (every word of a call
// shares them: the epoch tells the passes apart).
extern "C" int64_t tt_lex_flags_len(int64_t n) {
  return (int64_t)kRadix * ((n + kMinTile - 1) / kMinTile);
}

// orand[2k] / orand[2k+1] = OR / AND of operand k's ordered keys. `ops` is
// a HOST array of int64 pairs (address, kind); it travels to the card as
// kernel parameters, kMaxOps operands a launch.
extern "C" int tt_lex_orand(const long long* ops, int nops, int64_t n, u64* orand, int n_sms, void* stream) {
  if (nops <= 0 || n < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  init_orand<<<1, 256, 0, s>>>(orand, nops);
  int err = (int)cudaGetLastError();
  if (err != 0 || n == 0) return err;
  for (int k0 = 0; k0 < nops; k0 += kMaxOps) {
    OpArgs a;
    a.nops = nops - k0 < kMaxOps ? nops - k0 : kMaxOps;
    for (int k = 0; k < a.nops; ++k) {
      a.data[k] = (const void*)ops[2 * (k0 + k)];
      a.kind[k] = (int32_t)ops[2 * (k0 + k) + 1];
    }
    orand_kernel<<<grid_for(n, n_sms, 8), kThreads, 0, s>>>(a, n, orand + 2 * k0);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// Stable sort of rows by one composite word of `bits` bits (1..64) in keys
// of `key_bytes` bytes (4 for a word of at most 32 bits, else 8: the
// host's plan decides), after the permutation perm_in (null = identity);
// the sorted row ids land in perm_out. A K_TASK field reads row / task_width
// (task_width >= 1). key_a/key_b: n keys of 8 bytes (4 used when bits <=
// 32); val_a/val_b: int32 [n]; counts: uint32 [passes * 256] and
// tile_ctr: uint32 [passes], both zero; flags: uint64
// [tt_lex_flags_len(n)], zero or from earlier passes of the call, whose
// epochs are 1..epoch0 (this word's passes take epoch0 + 1 ...). With
// keep_keys the last pass also writes the sorted keys, into key_b after an
// odd number of passes and key_a after an even one (a caller that
// compares neighbouring sorted rows reads them there: K9's sweep).
extern "C" int tt_lex_sort_word(const void* fields, int nfields, int bits, int key_bytes, int64_t n,
                                int64_t task_width, const int32_t* perm_in, void* key_a, void* key_b,
                                int32_t* val_a, int32_t* val_b, u32* counts, u32* tile_ctr, u64* flags,
                                int epoch0, int32_t* perm_out, int keep_keys, int n_sms, void* stream) {
  if (nfields <= 0 || bits <= 0 || bits > 8 * key_bytes || (key_bytes != 4 && key_bytes != 8) || n <= 0 ||
      n > 0x7fffffffLL || task_width <= 0 || epoch0 < 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int passes = (bits + 7) / 8;
  const FieldDesc* f = (const FieldDesc*)fields;
  if (key_bytes == 4)
    return sort_word<u32>(f, nfields, passes, n, task_width, perm_in, (u32*)key_a, (u32*)key_b, val_a, val_b,
                          counts, tile_ctr, flags, epoch0, perm_out, keep_keys, n_sms, s);
  return sort_word<u64>(f, nfields, passes, n, task_width, perm_in, (u64*)key_a, (u64*)key_b, val_a, val_b,
                        counts, tile_ctr, flags, epoch0, perm_out, keep_keys, n_sms, s);
}
