// K8 lex_sort: stable lexicographic sort permutation over key operands.
//
// Replaces tidb_tpu/copr/tpu_engine.py:195-208 lex_sort_perm, which
// chains single-key stable lax.sorts (most significant operand first,
// ties by row id). The same permutation comes out of an LSD radix sort
// written by hand:
//
//   1. orand_kernel: per operand, the OR and the AND of its
//      order-preserving unsigned key over all rows. OR ^ AND are the bits
//      that vary; every other bit is constant and cannot order anything.
//   2. The host (kernels/lex_sort.py) packs each operand's varying bit
//      range, least significant operand lowest, into 64-bit composite
//      words. A flag operand costs one bit, a constant operand none.
//   3. Per word, least significant word first: build_keys gathers the
//      word's fields through the permutation so far (a task field, the
//      row's task = row / task_width, is computed, not read), then one
//      8-bit LSD pass per 8 bits of the word, each three kernels:
//        hist_kernel    per-tile digit histogram (warp-aggregated shared
//                       atomics), digit-major [256, tiles]
//        scan_digits    exclusive scan of each digit's tile counts, and
//                       each digit's total
//        scatter_kernel stable scatter: a tile ranks its elements within
//                       their digit in index order (__match_any_sync per
//                       warp, then a per-digit prefix across warps),
//                       stages them in shared memory grouped by digit,
//                       and writes each digit's run to its global slots
//                       (coalesced stores).
//
// Order-preserving keys, per operand kind:
//   I32  x ^ 0x80000000 (as uint32)
//   I64  x ^ 2^63
//   U64  x
//   F64  lax.sort's order: -0.0 folds to +0.0 and every NaN to one +NaN
//        (jax/_src/lax/lax.py _canonicalize_float_for_sort), then the
//        IEEE total order: negative -> ~bits, else bits | 2^63. NaN sorts
//        after +inf. XLA evaluates that fold's x == 0 with subnormals
//        flushed (on the CPU as on the TPU), so every subnormal folds to
//        +0.0 too: |x| < DBL_MIN is zero here.
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
// word by build_keys; each pass reads and writes 12 bytes a row (8-byte
// key, 4-byte row id). Passes follow the data: TPC-H lineitem's
// extendedprice varies in 24 bits, so a DESC price key costs 3 passes,
// not 8.
//
// Plain C interface (nvcc + ctypes). Every entry point launches on the
// given stream, never synchronizes, and returns the cudaError_t of its
// launches (0 = success), or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3, K_TASK = 4 };

constexpr u64 kSign = 0x8000000000000000ULL;
constexpr double kDblMin = 2.2250738585072014e-308;  // smallest normal double
constexpr int kThreads = 256;  // = kRadix: thread t owns digit t
constexpr int kItems = 8;  // 2048-row tiles: the staged tile fits static shared memory
constexpr int kTile = kThreads * kItems;
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

struct OpDesc {  // kernels/lex_sort.py packs these as int64 pairs
  const void* data;
  int64_t kind;
};

struct FieldDesc {  // int64 triples: ptr, kind | src_shift << 32, width | dst_shift << 32
  const void* data;  // null for K_TASK
  int32_t kind;
  int32_t src_shift;
  int32_t width;
  int32_t dst_shift;
};

__device__ __forceinline__ u64 ordered(const void* data, int32_t kind, int64_t row) {
  switch (kind) {
    case K_I32:
      return (u64)(uint32_t)(((const int32_t*)data)[row] ^ (int32_t)0x80000000);
    case K_I64:
      return (u64)((const long long*)data)[row] ^ kSign;
    case K_U64:
      return (u64)((const long long*)data)[row];
    default: {
      double x = ((const double*)data)[row];
      u64 b;
      if (fabs(x) < kDblMin)  // zeros and subnormals (module note)
        b = 0ULL;
      else if (x != x)
        b = 0x7ff8000000000000ULL;
      else
        b = (u64)__double_as_longlong(x);
      return (b & kSign) ? ~b : (b | kSign);
    }
  }
}

__global__ void init_orand(u64* orand, int nops) {
  for (int t = threadIdx.x; t < nops; t += blockDim.x) {
    orand[2 * t] = 0ULL;
    orand[2 * t + 1] = ~0ULL;
  }
}

__global__ void orand_kernel(const OpDesc* __restrict__ ops, int nops, int64_t n, u64* orand) {
  __shared__ u64 s_or[kWarps], s_and[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k = 0; k < nops; ++k) {
    const void* data = ops[k].data;
    const int32_t kind = (int32_t)ops[k].kind;
    u64 o = 0ULL, a = ~0ULL;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      u64 u = ordered(data, kind, i);
      o |= u;
      a &= u;
    }
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_xor_sync(0xffffffffu, o, off);
      a &= __shfl_xor_sync(0xffffffffu, a, off);
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

__global__ void build_keys(const FieldDesc* __restrict__ f, int nf, int64_t n, int64_t task_width,
                           const int32_t* __restrict__ perm_in, u64* __restrict__ keys,
                           int32_t* __restrict__ vals) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = perm_in != nullptr ? (int64_t)perm_in[i] : i;
    u64 key = 0ULL;
    for (int j = 0; j < nf; ++j) {
      u64 u = (f[j].kind == K_TASK ? (u64)(row / task_width) : ordered(f[j].data, f[j].kind, row)) >>
              f[j].src_shift;
      if (f[j].width < 64) u &= (1ULL << f[j].width) - 1ULL;
      key |= u << f[j].dst_shift;
    }
    keys[i] = key;
    vals[i] = (int32_t)row;
  }
}

__global__ void hist_kernel(const u64* __restrict__ keys, int64_t n, int shift, int64_t tiles,
                            int32_t* __restrict__ counts) {
  __shared__ int32_t h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const int d = i < n ? (int)((keys[i] >> shift) & 0xFFULL) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < kRadix && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  counts[(int64_t)threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// One block per digit: exclusive scan of the digit's per-tile counts in
// place, and the digit's total.
__global__ void scan_digits(int32_t* __restrict__ counts, int64_t tiles,
                            int32_t* __restrict__ totals) {
  __shared__ int32_t ws[kScanThreads / 32];
  int32_t* c = counts + (int64_t)blockIdx.x * tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int nw = kScanThreads / 32;
  int32_t carry = 0;
  for (int64_t start = 0; start < tiles; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const int32_t x = i < tiles ? c[i] : 0;
    int32_t v = x;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane == 31) ws[w] = v;
    __syncthreads();
    if (w == 0) {
      int32_t s = lane < nw ? ws[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      if (lane < nw) ws[lane] = s;
    }
    __syncthreads();
    const int32_t incl = v + (w > 0 ? ws[w - 1] : 0);
    if (i < tiles) c[i] = carry + incl - x;
    carry += ws[nw - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Exclusive scan of one int32 per thread over a 256-thread block.
__device__ __forceinline__ int32_t block_excl_scan_256(int32_t x, int32_t* ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t v = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) ws[w] = v;
  __syncthreads();
  int32_t before = 0;
  for (int q = 0; q < w; ++q) before += ws[q];
  __syncthreads();
  return before + v - x;
}

__global__ void scatter_kernel(const u64* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
                               int64_t n, int shift, int64_t tiles,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ totals, u64* __restrict__ keys_out,
                               int32_t* __restrict__ vals_out) {
  __shared__ int32_t ws[kWarps];
  __shared__ int32_t gbase[kRadix];   // global slot of the tile's first row of digit d
  __shared__ int32_t lstart[kRadix];  // tile-local slot of the same row
  __shared__ int32_t placed[kRadix];  // rows of digit d placed so far
  __shared__ int32_t wcnt[2][kWarps][kRadix];
  __shared__ u64 skey[kTile];
  __shared__ int32_t sval[kTile];
  const int t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const int64_t at = (int64_t)t * tiles + blockIdx.x;
  const int32_t mine = (blockIdx.x + 1 < tiles ? counts[at + 1] : totals[t]) - counts[at];
  gbase[t] = block_excl_scan_256(totals[t], ws) + counts[at];
  lstart[t] = block_excl_scan_256(mine, ws);
  placed[t] = 0;
  for (int q = 0; q < kWarps; ++q) {
    wcnt[0][q][t] = 0;
    wcnt[1][q][t] = 0;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  // 1. stable rank in the tile: rows land in shared memory grouped by
  //    digit, in index order within a digit
  for (int r = 0; r < kItems; ++r) {
    const int b = r & 1;
    const int64_t i = tile + (int64_t)r * kThreads + t;
    const bool ok = i < n;
    const u64 key = ok ? keys_in[i] : 0ULL;
    const int32_t val = ok ? vals_in[i] : 0;
    const int d = ok ? (int)((key >> shift) & 0xFFULL) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int wr = __popc(peers & lt);
    if (ok && wr == 0) wcnt[b][w][d] = __popc(peers);
    __syncthreads();
    // digit t: the warps' counts become their starting slots, in warp
    // order; the other buffer is cleared for the next round
    int32_t run = placed[t];
    for (int q = 0; q < kWarps; ++q) {
      const int32_t c = wcnt[b][q][t];
      wcnt[b][q][t] = run;
      run += c;
      wcnt[b ^ 1][q][t] = 0;
    }
    placed[t] = run;
    __syncthreads();
    if (ok) {
      const int32_t slot = lstart[d] + wcnt[b][w][d] + wr;
      skey[slot] = key;
      sval[slot] = val;
    }
  }
  __syncthreads();
  // 2. write out: neighbouring slots of one digit go to neighbouring
  //    global slots, so the stores coalesce
  const int64_t len = n - tile < kTile ? n - tile : kTile;
  for (int j = t; j < len; j += kThreads) {
    const u64 key = skey[j];
    const int d = (int)((key >> shift) & 0xFFULL);
    const int32_t pos = gbase[d] + (j - lstart[d]);
    if (keys_out != nullptr) keys_out[pos] = key;
    vals_out[pos] = sval[j];
  }
}

int grid_for(int64_t n, int n_sms, int per_sm) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)(n_sms > 0 ? n_sms : 132) * per_sm;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

// Int32 slots of tt_lex_sort_word's `counts` scratch for n rows.
extern "C" int64_t tt_lex_counts_len(int64_t n) {
  return (int64_t)kRadix * ((n + kTile - 1) / kTile);
}

// orand[2k] / orand[2k+1] = OR / AND of operand k's ordered keys.
extern "C" int tt_lex_orand(const void* ops, int nops, int64_t n, u64* orand, int n_sms,
                            void* stream) {
  if (nops <= 0 || n < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  init_orand<<<1, 256, 0, s>>>(orand, nops);
  int err = (int)cudaGetLastError();
  if (err != 0 || n == 0) return err;
  orand_kernel<<<grid_for(n, n_sms, 8), kThreads, 0, s>>>((const OpDesc*)ops, nops, n, orand);
  return (int)cudaGetLastError();
}

// Stable sort of rows by one composite word of `bits` bits (1..64), after
// the permutation perm_in (null = identity); the sorted row ids land in
// perm_out. A K_TASK field reads row / task_width (task_width >= 1).
// key_a/key_b: u64 [n]; val_a/val_b: int32 [n]; counts: int32
// [tt_lex_counts_len(n)]; totals: int32 [256].
extern "C" int tt_lex_sort_word(const void* fields, int nfields, int bits, int64_t n,
                                int64_t task_width, const int32_t* perm_in, u64* key_a,
                                u64* key_b, int32_t* val_a, int32_t* val_b, int32_t* counts,
                                int32_t* totals, int32_t* perm_out, int n_sms, void* stream) {
  if (nfields <= 0 || bits <= 0 || bits > 64 || n <= 0 || n > 0x7fffffffLL || task_width <= 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + kTile - 1) / kTile;
  build_keys<<<grid_for(n, n_sms, 16), kThreads, 0, s>>>((const FieldDesc*)fields, nfields, n,
                                                         task_width, perm_in, key_a, val_a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int passes = (bits + 7) / 8;
  u64* ks = key_a;
  u64* kd = key_b;
  int32_t* vs = val_a;
  int32_t* vd = val_b;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const int shift = 8 * p;
    hist_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(ks, n, shift, tiles, counts);
    scan_digits<<<kRadix, kScanThreads, 0, s>>>(counts, tiles, totals);
    scatter_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(ks, vs, n, shift, tiles, counts, totals,
                                                        last ? nullptr : kd, last ? perm_out : vd);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    u64* kt = ks;
    ks = kd;
    kd = kt;
    int32_t* vt = vs;
    vs = vd;
    vd = vt;
  }
  return 0;
}
