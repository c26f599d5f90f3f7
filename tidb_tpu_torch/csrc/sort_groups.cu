// K9 sort_groups: dense group ids of a sort-based GROUP BY.
//
// Replaces tidb_tpu/copr/tpu_engine.py:1351-1400 (the kernel of
// TPUEngine._lower_agg_sorted) up to its segment reductions, which K4
// (csrc/seg_agg.cu, precomputed-segment mode) takes over. The reference
// sorts every row by (masked flag, per key its NULL flag and value bits)
// and numbers the masked-in rows' distinct key tuples in that order. A
// stable sort by (flag, keys) orders the masked-in rows by their keys and
// then the masked rows by theirs, so the solo call sorts only what the
// groups need:
//
//   compact_kernel  one pass over the rows (csrc/compact.cuh's tile: warp-
//                   striped rows, ballots, decoupled look-back): the rows
//                   whose mask is set, M of them, get their operands in
//                   row order — per key null = !v (int32, written only
//                   for a key with a valid lane) and val = v ? bits(d) : 0
//                   (int64) — with their row ids (crow); the masked rows'
//                   ids follow in `tail` (their keys are not read). bits:
//                   int32 codes sign-extend; int64 and uint64 as they are;
//                   float64 folds -0.0 and the subnormals into +0.0 (the
//                   reference's x == 0.0 test runs with XLA's subnormals
//                   flushed), then its bit pattern. `res` gets M and the
//                   OR / AND of every operand's K8 key (an int32 operand's
//                   x ^ 2^31, an int64's x ^ 2^63), the tiles' pairs folded
//                   by the launch's last block: one host read brings them
//   (K8)            kernels/lex_sort sorts the M kept rows by (null_0,
//                   val_0, ...) in only the bits they vary in (no flag
//                   operand, no read of its own); where its plan is one
//                   word it hands back that word's sorted keys
//   sweep_kernel    one pass over the sorted positions [0, M): a position
//                   starts a group where it is its task's first or its
//                   operands differ from the position before — K8's
//                   sorted words compared (coalesced) where the plan is
//                   one word, else each varying operand gathered once per
//                   position into shared memory (a row of halo before the
//                   tile) and compared there. The starts are placed by
//                   place_tile's look-back, so a group's id is the count
//                   of starts before it: seg[row] (row order, uncapped),
//                   first[id] = the operand index of the group's first
//                   position, and ends[task] = the groups up to the task's
//                   last position, n_groups for the solo call, which is
//                   the second host read
//   solo_finish_kernel
//                   after the host chose cap = cap_of(n_groups): kval[j,
//                   id] = val_j and kvalid = 1 - null_j at first[id] for id
//                   < min(n_groups, cap), INT64_MIN / -1 past them (every
//                   row of a group holds the same key words, so this is
//                   the reference's _seg_max over the group); seg = cap at
//                   the masked rows; and, only where cap < n_groups, seg
//                   clamped to cap
//
// Every kernel reads its keys (kind, lanes, operand outputs) through a key
// table on the card, so a call takes any number of keys: the solo call's
// entry point writes it from the call's words with put_keys launches
// (rows by value, stream-ordered: no pinned buffer, no event), the task
// mode's rides in its task table. The sweep skips an operand whose OR
// equals its AND.
//
// The permutation of every row (K8's over the reference's operands) is
// the kept rows' crow[perm_M] followed by the masked rows sorted by their
// own operands: kernels/sort_groups.py builds it when it is asked for
// (tail_ops_kernel writes the masked rows' operands, K8 sorts them,
// perm_kernel writes both halves). The engine never asks.
//
// Task-grid mode (K10's sort GROUP BY, tidb_tpu/copr/tpu_engine.py:1096-1134
// vmapping the kernel above over a launch group): G tasks, each through
// its row of the task table (its mask and key lanes, read to the group's
// `width`), into slice y of [G, width] operands (ops_kernel, every row,
// with each task's masked-in count and every operand's OR / AND, which the
// host reads in the call's first read). K8's task-leading mode sorts them
// by (task, flag, keys) with that OR / AND (no read of its own): task y's
// sorted positions are y * width + [0, width), its masked-in rows first.
// The sweep runs over all of them with those counts (a task's first
// position starts a group; the ids run on across the tasks), ends[]
// gives every task's count in one read, and task_finish_kernel finds the
// masked positions through the permutation.
// The solo call is a compacted G = 1.
//
// Bound: bytes. The mask, the kept rows' key lanes, the kept operands
// (written once, read by K8's passes and once by the sweep or its words),
// seg, and the keys of the groups. The sweep's gathers through the
// permutation (crow, seg, the operands off one word) are the cost beyond
// it; Q18's lineitem arrives sorted by its key, so they are near
// sequential there.
//
// Plain C interface (nvcc + ctypes): kernels/sort_groups.py packs each
// call's arguments into one int64 word array (the key tables and the task
// mode's task table are on the card); every entry point launches on the
// given stream, never synchronizes, and returns the cudaError_t of its
// launches (0 = success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

using compact::ll;
using compact::LookBack;
using compact::ull;

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3 };

constexpr int BLOCK = compact::BLOCK;
constexpr int ITEMS = compact::ITEMS;
constexpr int TILE = compact::TILE;
constexpr int WARPS = compact::WARPS;
constexpr int OPS_THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // the compaction's and the sweep's blocks an SM (their launch bounds)
constexpr unsigned FULL = 0xffffffffu;
constexpr ull SIGN = 0x8000000000000000ULL;
constexpr ll I64_MIN = (ll)0x8000000000000000ULL;

// a row's operands for one key: null = !valid, val = valid ? bits(d) : 0
__device__ __forceinline__ void key_ops(int kind, const void* data, const uint8_t* valid, ll row, int32_t* nul,
                                        ll* val) {
  const bool v = valid == nullptr || valid[row] != 0;
  *nul = v ? 0 : 1;
  ll x = 0;
  if (v) {
    if (kind == K_I32) {
      x = ((const int32_t*)data)[row];
    } else if (kind == K_F64) {
      const double d = ((const double*)data)[row];
      x = fabs(d) < 2.2250738585072014e-308 ? 0LL : __double_as_longlong(d);
    } else {
      x = ((const ll*)data)[row];
    }
  }
  *val = x;
}

// K8's order-preserving keys of an int32 and an int64 operand
__device__ __forceinline__ ull key32(int32_t x) { return (ull)((uint32_t)x ^ 0x80000000u); }
__device__ __forceinline__ ull key64(ll x) { return (ull)x ^ SIGN; }

// One key's row of a key table on the card (int64 words, as
// kernels/sort_groups.py KEY_FIELDS packs them): every kernel reads its
// keys through the table, so a call takes any number of keys.
struct KeyRow {
  ll kind;
  const void* data;      // the key lane (the task mode: 0, its task table holds each task's)
  const uint8_t* valid;  // null: every row valid (the task mode: 0, as data)
  int32_t* nul;          // the operands: null = !valid, int32; null where the key has no valid lane
  ll* val;               // val = valid ? bits(d) : 0, int64
};

// PUT_ROWS key rows by value, written to a key table on the card
constexpr int PUT_ROWS = 16;
struct KeyChunk {
  KeyRow r[PUT_ROWS];
};

__global__ void put_keys(const KeyChunk c, int nrows, KeyRow* dst) {
  if ((int)threadIdx.x < nrows) dst[threadIdx.x] = c.r[threadIdx.x];
}

// ------------------------------------------------------------ compaction

struct CompactP {
  ll n;
  const uint8_t* mask;
  const KeyRow* keys;
  int nk;
  int32_t* crow;
  int32_t* tail;
  ll* res;  // [1 + 4 * nk]: M, then per key the OR / AND of null's keys and of val's
};

// Rows row_of(tile, j) of the block's tile; the kept rows' operands at
// their places, the masked rows' ids in `tail`. Each key's four (OR,
// NOT-AND) words a tile go to the scratch after the descriptors, at [tile]
// [key][4], for the last block to fold. Key 0's lanes are loaded before
// the look-back, so that their latency overlaps it; the block keeps few
// registers (several blocks an SM: the pass is latency-bound).
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) compact_kernel(const CompactP p, const LookBack lb, ll ntiles) {
  __shared__ compact::Temp tmp;
  __shared__ unsigned s_tile;
  __shared__ ull s_red[4][WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ll tile = compact::take_tile(lb, &s_tile);
  bool keep[ITEMS];
  unsigned kmask[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll row = compact::row_of(tile, j);
    keep[j] = row < p.n && p.mask[row] != 0;
  }
  ull* part = (ull*)lb.desc(ntiles);  // [tile][key][4] after the descriptors
  for (int k = 0; k < p.nk; ++k) {
    const int kind = (int)p.keys[k].kind;
    const void* data = p.keys[k].data;
    const uint8_t* valid = p.keys[k].valid;
    int32_t nl[ITEMS];
    ll v[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (keep[j]) key_ops(kind, data, valid, compact::row_of(tile, j), &nl[j], &v[j]);
    if (k == 0) {  // the places, while key 0's loads are in flight
      compact::place_tile(lb, tile, keep, kmask, tmp);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const ll row = compact::row_of(tile, j);
        if (row >= p.n) continue;
        const ll kept = compact::kept_before(tmp, kmask, j);
        if (keep[j])
          p.crow[kept] = (int32_t)row;
        else
          p.tail[row - kept] = (int32_t)row;
      }
      if (threadIdx.x == 0 && tile == ntiles - 1) p.res[0] = tmp.base + tmp.count;
    }
    int32_t* nul_out = p.keys[k].nul;
    ll* val_out = p.keys[k].val;
    ull r[4] = {0ULL, 0ULL, 0ULL, 0ULL};  // null's OR, NOT-AND; val's OR, NOT-AND
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (!keep[j]) continue;
      const ll kept = compact::kept_before(tmp, kmask, j);
      if (nul_out != nullptr) nul_out[kept] = nl[j];
      val_out[kept] = v[j];
      const ull a = key32(nl[j]), b = key64(v[j]);
      r[0] |= a;
      r[1] |= ~a;
      r[2] |= b;
      r[3] |= ~b;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) r[q] |= __shfl_xor_sync(FULL, r[q], off);
      if (lane == 0) s_red[q][w] = r[q];
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      ull x = 0ULL;
      for (int q = 0; q < WARPS; ++q) x |= s_red[threadIdx.x][q];
      part[(tile * p.nk + k) * 4 + threadIdx.x] = x;
    }
    __syncthreads();
  }
  if (compact::last_block(lb, &tmp.last)) {  // every tile's words are written: fold them
    for (int q = w; q < 4 * p.nk; q += WARPS) {  // a warp a (key, word)
      const int k = q >> 2, c = q & 3;
      ull x = 0ULL;
      for (ll t = lane; t < ntiles; t += 32) x |= __ldcg(part + (t * p.nk + k) * 4 + c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x |= __shfl_xor_sync(FULL, x, off);
      if (lane == 0) p.res[1 + q] = (ll)((c & 1) ? ~x : x);  // the OR, or the AND from the NOT-AND
    }
    compact::reset(lb, ntiles + 2 * ntiles * p.nk);  // the descriptors and the words
  }
}

// ------------------------------------------------------------ task mode

// Host-built table (kernels/sort_groups.py packs it as int64): G task rows
// of 1 + 2 * nkeys addresses (mask, then per key its data and its valid
// lane, 0 = all valid), then nkeys KeyRows shared by the tasks (their
// operands [G * width]).

// Task blockIdx.y's rows 0..width of its own lanes into slice y of the
// outputs, its masked-in rows counted into mcount[y], and every operand's
// OR / NOT-AND of K8's keys into orand ([flag, then per key null and val]
// × [OR, NOT-AND], zero on entry: one atomic a word a block), so that K8
// needs no pass of its own over the operands and no read. A key at a time
// over the block's rows, so that a thread holds four words, however many
// keys there are.
__global__ void ops_kernel(const long long* __restrict__ tasks, int64_t width, const KeyRow* __restrict__ keys,
                           int nkeys, int32_t* __restrict__ flag, int32_t* __restrict__ mcount, ull* orand) {
  __shared__ ull s_red[4][OPS_THREADS / 32];
  __shared__ int s_cnt[OPS_THREADS / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long* T = tasks + (int64_t)blockIdx.y * (1 + 2 * nkeys);
  const uint8_t* mask = (const uint8_t*)T[0];
  const int64_t base = (int64_t)blockIdx.y * width;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x, step = (int64_t)gridDim.x * blockDim.x;
  for (int j = -1; j < nkeys; ++j) {  // j = -1: the flag
    ull r[4] = {0ULL, 0ULL, 0ULL, 0ULL};
    int c = 0;
    for (int64_t i = i0; i < width; i += step) {
      if (j < 0) {
        const bool m = mask[i] != 0;
        flag[base + i] = m ? 0 : 1;
        c += m;
        const ull a = key32(m ? 0 : 1);
        r[0] |= a;
        r[1] |= ~a;
      } else {
        int32_t nl;
        ll v;
        key_ops((int)keys[j].kind, (const void*)T[1 + 2 * j], (const uint8_t*)T[2 + 2 * j], i, &nl, &v);
        keys[j].nul[base + i] = nl;
        keys[j].val[base + i] = v;
        const ull a = key32(nl), b = key64(v);
        r[0] |= a;
        r[1] |= ~a;
        r[2] |= b;
        r[3] |= ~b;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) r[q] |= __shfl_xor_sync(FULL, r[q], off);
      if (lane == 0) s_red[q][w] = r[q];
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) s_cnt[w] = c;
    __syncthreads();
    const int words = j < 0 ? 2 : 4;
    if (threadIdx.x < words) {
      ull x = 0ULL;
      for (int q = 0; q < OPS_THREADS / 32; ++q) x |= s_red[threadIdx.x][q];
      if (x != 0ULL) atomicOr(orand + (j < 0 ? 0 : 2 + 4 * j) + threadIdx.x, x);
    }
    if (j < 0 && threadIdx.x == 32) {
      int t = 0;
      for (int q = 0; q < OPS_THREADS / 32; ++q) t += s_cnt[q];
      if (t != 0) atomicAdd(mcount + blockIdx.y, t);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ the sweep

struct SweepP {
  ll n;                  // sorted positions (G * width, or the solo call's M)
  ll width;              // positions a task (the solo call: M)
  const int32_t* mcount;  // a task's masked-in positions, its first (null: every position)
  const int32_t* perm;    // sorted position -> operand index
  const int32_t* crow;    // operand index -> row (null: the index is the row)
  const void* words;      // K8's sorted last word, `key_bytes` wide (null: the operands)
  int key_bytes;
  const KeyRow* keys;     // the operands compared where there are no words
  int nk;
  const ull* orand;       // per key its null's (OR, AND) and its val's: an operand the same everywhere is skipped
  int notand;             // orand holds NOT-AND words in place of the ANDs
  int32_t* seg;  // [rows], row order: a masked-in row's group id, uncapped
  int32_t* first;  // [groups]: the operand index of the group's first position
  ll* ends;        // [G]: the groups whose first position is at or before the task's last
};

__device__ __forceinline__ ll load_op(const void* op, bool i32, ll idx) {
  return i32 ? (ll)((const int32_t*)op)[idx] : ((const ll*)op)[idx];
}

// positions row_of(tile, j) of the block's tile. Each position's operand
// index and row are loaded before the look-back (their latency overlaps
// it); positions are int32 (fewer than 2^31), the task and its offset are
// recomputed where needed, so that the block keeps few registers.
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) sweep_kernel(const SweepP p, const LookBack lb, ll ntiles) {
  __shared__ compact::Temp tmp;
  __shared__ unsigned s_tile;
  __shared__ ll s_op[TILE + 1];  // one operand of the tile's positions, after position tile * TILE - 1's
  const ll tile = compact::take_tile(lb, &s_tile);
  const ll t0 = tile * TILE;
  int32_t idx[ITEMS], row[ITEMS];
  bool in[ITEMS], start[ITEMS];
  unsigned kmask[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll pos = t0 + j * BLOCK + threadIdx.x;
    ll l = pos;
    bool live = pos < p.n;
    if (p.mcount != nullptr && live) {  // the task mode: a task's masked-in positions come first
      const unsigned g = (unsigned)pos / (unsigned)p.width;  // positions < 2^31: a 32-bit division
      l = pos - (ll)g * p.width;
      live = l < (ll)p.mcount[g];
    }
    in[j] = live;
    start[j] = live && l == 0;
    idx[j] = live ? p.perm[pos] : 0;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) row[j] = in[j] && p.crow != nullptr ? p.crow[idx[j]] : idx[j];
  if (p.words != nullptr) {
    if (p.key_bytes == 4) {
      const uint32_t* wd = (const uint32_t*)p.words;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const ll pos = t0 + j * BLOCK + threadIdx.x;
        if (in[j] && !start[j]) start[j] = wd[pos] != wd[pos - 1];
      }
    } else {
      const ull* wd = (const ull*)p.words;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const ll pos = t0 + j * BLOCK + threadIdx.x;
        if (in[j] && !start[j]) start[j] = wd[pos] != wd[pos - 1];
      }
    }
  } else {
    bool diff[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) diff[j] = false;
    // a masked-in position past its task's first has its predecessor in
    // the task, masked in too: the halo is needed only then
    const bool halo = threadIdx.x == 0 && in[0] && !start[0];
    const ll prev = halo ? (ll)p.perm[t0 - 1] : 0;
    for (int q = 0; q < 2 * p.nk; ++q) {  // per key its null operand, then its val (the same at every thread)
      const ull o = p.orand[2 * q], a = p.orand[2 * q + 1];
      const bool i32 = (q & 1) == 0;
      const void* op = i32 ? (const void*)p.keys[q >> 1].nul : (const void*)p.keys[q >> 1].val;
      if (op == nullptr || o == (p.notand ? ~a : a)) continue;  // no position differs in it
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (in[j]) s_op[1 + j * BLOCK + threadIdx.x] = load_op(op, i32, idx[j]);
      if (halo) s_op[0] = load_op(op, i32, prev);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int at = j * BLOCK + threadIdx.x;
        if (in[j] && !start[j]) diff[j] |= s_op[1 + at] != s_op[at];
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) start[j] |= diff[j];
  }
  compact::place_tile(lb, tile, start, kmask, tmp);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll pos = t0 + j * BLOCK + threadIdx.x;
    if (pos >= p.n) continue;
    const ll before = compact::kept_before(tmp, kmask, j);  // groups started before position pos
    if (in[j]) {
      const ll id = start[j] ? before : before - 1;
      p.seg[row[j]] = (int32_t)id;
      if (start[j]) p.first[id] = idx[j];
    }
    const unsigned g = p.mcount != nullptr ? (unsigned)pos / (unsigned)p.width : 0u;
    if (pos - (ll)g * p.width == p.width - 1) p.ends[g] = before + (start[j] ? 1 : 0);
  }
  if (compact::last_block(lb, &tmp.last)) compact::reset(lb, ntiles);
}

// ------------------------------------------------------------ after the read

struct FinishP {
  ll cap, ng;
  const KeyRow* keys;
  int nk;
  const int32_t* first;
  ll* kval;    // [nk, cap]
  ll* kvalid;  // [nk, cap]
  int32_t* seg;
};

// group t's key words (t < cap): its first position's operands below
// min(ng, cap), INT64_MIN / -1 past them
__device__ __forceinline__ void group_keys(const FinishP& p, ll t) {
  const ll o = t < p.ng ? (ll)p.first[t] : -1;
  for (int k = 0; k < p.nk; ++k) {
    const int32_t* nul = p.keys[k].nul;
    p.kval[k * p.cap + t] = o < 0 ? I64_MIN : p.keys[k].val[o];
    p.kvalid[k * p.cap + t] = o < 0 ? -1 : nul != nullptr ? 1 - (ll)nul[o] : 1;
  }
}

__device__ __forceinline__ void clamp_seg(const FinishP& p, ll row) {
  if (p.seg[row] > p.cap) p.seg[row] = (int32_t)p.cap;
}

// the solo call: the keys, seg = cap at the masked rows (`tail`), and the
// first `nclamp` kept rows' ids clamped to cap (M where cap < ng, else 0)
__global__ void solo_finish_kernel(const FinishP p, const int32_t* __restrict__ tail, ll ntail,
                                   const int32_t* __restrict__ crow, ll nclamp, ll span) {
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < span; t += (ll)gridDim.x * blockDim.x) {
    if (t < p.cap) group_keys(p, t);
    if (t < ntail) p.seg[tail[t]] = (int32_t)p.cap;
    if (t < nclamp) clamp_seg(p, crow[t]);
  }
}

// the task mode: the keys, seg = cap at each task's masked positions (those
// past its mcount, found through the permutation), the others' ids clamped
// where `clamp` (cap < ng)
__global__ void task_finish_kernel(const FinishP p, const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ mcount, ll width, ll npos, int clamp, ll span) {
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < span; t += (ll)gridDim.x * blockDim.x) {
    if (t < p.cap) group_keys(p, t);
    if (t < npos) {
      const ll g = (ll)((unsigned)t / (unsigned)width);
      if (t - g * width >= (ll)mcount[g])
        p.seg[perm[t]] = (int32_t)p.cap;
      else if (clamp)
        clamp_seg(p, perm[t]);
    }
  }
}

// ------------------------------------------------------------ the permutation, on request

// the masked rows' operands, tail order (the table's outputs [ntail])
__global__ void tail_ops_kernel(const KeyRow* __restrict__ keys, int nk, const int32_t* __restrict__ tail,
                                ll ntail) {
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < ntail; t += (ll)gridDim.x * blockDim.x) {
    const ll row = tail[t];
    for (int j = 0; j < nk; ++j) {
      int32_t nl;
      ll v;
      key_ops((int)keys[j].kind, keys[j].data, keys[j].valid, row, &nl, &v);
      if (keys[j].nul != nullptr) keys[j].nul[t] = nl;
      keys[j].val[t] = v;
    }
  }
}

__global__ void perm_kernel(ll n, ll m, const int32_t* __restrict__ crow, const int32_t* __restrict__ perm_m,
                            const int32_t* __restrict__ tail, const int32_t* __restrict__ perm_t,
                            int32_t* __restrict__ out) {
  for (ll i = (ll)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (ll)gridDim.x * blockDim.x)
    out[i] = i < m ? crow[perm_m[i]] : tail[perm_t != nullptr ? (ll)perm_t[i - m] : i - m];
}

// ------------------------------------------------------------ host side

struct Words {
  const int64_t* w;
  int n;
  int at;
  int64_t operator()() { return at < n ? w[at++] : (at++, 0); }
  bool done() const { return at == n; }
};

unsigned grid_for(ll n, int n_sms, int per_sm) {
  ll blocks = (n + OPS_THREADS - 1) / OPS_THREADS;
  const ll cap = (ll)(n_sms > 0 ? n_sms : 132) * per_sm;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// the key table's address and its row count
int take_keys(Words& t, const KeyRow** keys, int* nk) {
  *keys = (const KeyRow*)t();
  *nk = (int)t();
  return *keys == nullptr || *nk < 1 ? -1 : 0;
}

// the key table's address, its row count, then its rows (KeyRow's words
// each, the lanes present), written to the table: 0 or a cudaError_t, -1
// for a row it does not take
int put_table(Words& t, const KeyRow** keys, int* nk, cudaStream_t s) {
  if (take_keys(t, keys, nk) != 0) return -1;
  KeyRow* dst = (KeyRow*)*keys;
  for (int j0 = 0; j0 < *nk; j0 += PUT_ROWS) {
    KeyChunk c;
    const int m = *nk - j0 < PUT_ROWS ? *nk - j0 : PUT_ROWS;
    for (int j = 0; j < m; ++j) {
      KeyRow& r = c.r[j];
      r.kind = t();
      r.data = (const void*)t();
      r.valid = (const uint8_t*)t();
      r.nul = (int32_t*)t();
      r.val = (ll*)t();
      if (r.kind < K_I32 || r.kind > K_F64 || r.data == nullptr || r.val == nullptr) return -1;
    }
    put_keys<<<1, PUT_ROWS, 0, s>>>(c, m, dst + j0);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// words: cap, ng, keys, nk, first, kval, kvalid, seg
int take_finish(Words& t, FinishP& p) {
  p.cap = t();
  p.ng = t();
  if (p.cap < 0 || p.cap > 0x7fffffffLL || p.ng < 0 || take_keys(t, &p.keys, &p.nk) != 0) return -1;
  p.first = (const int32_t*)t();
  p.kval = (ll*)t();
  p.kvalid = (ll*)t();
  p.seg = (int32_t*)t();
  return (p.ng > 0 && p.cap > 0 && p.first == nullptr) || p.seg == nullptr ? -1 : 0;
}

}  // namespace

// scratch words of the compaction over n rows of nk keys, and of the sweep
// over n sorted positions (both zero, and left at zero)
extern "C" int64_t tt_sg_compact_scratch(int64_t n, int nk) {
  const ll t = compact::tiles(n);
  return compact::scratch_words(t + 2 * t * (ll)nk);
}
extern "C" int64_t tt_sg_sweep_scratch(int64_t n) { return compact::scratch_words(compact::tiles(n)); }

// words: n, mask, the key table (put_table's words: its address on the
// card, nk, the rows), crow, tail, res, scratch
extern "C" int tt_sg_compact(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  CompactP p;
  p.n = t();
  p.mask = (const uint8_t*)t();
  if (p.n < 1 || p.n > 0x7fffffffLL || p.mask == nullptr) return -1;
  const int err = put_table(t, &p.keys, &p.nk, (cudaStream_t)stream);
  if (err != 0) return err;
  p.crow = (int32_t*)t();
  p.tail = (int32_t*)t();
  p.res = (ll*)t();
  LookBack lb{(ll*)t()};
  if (!t.done() || p.crow == nullptr || p.tail == nullptr || p.res == nullptr || lb.ws == nullptr) return -1;
  const ll nt = compact::tiles(p.n);
  compact_kernel<<<(unsigned)nt, BLOCK, 0, (cudaStream_t)stream>>>(p, lb, nt);
  return (int)cudaGetLastError();
}

// The operands of G tasks (tasks / keys: the table above; flag and the
// keys' outputs [G * width]; mcount int32 [G] and orand uint64 [2 + 4 *
// nkeys], zeroed here).
extern "C" int tt_sg_ops(const void* tasks, int G, int64_t width, const void* keys, int nkeys, int32_t* flag,
                         int32_t* mcount, ull* orand, int n_sms, void* stream) {
  if (width <= 0 || nkeys <= 0 || G < 1 || G > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(mcount, 0, sizeof(int32_t) * (size_t)G, s);
  if (err == 0) err = (int)cudaMemsetAsync(orand, 0, sizeof(ull) * (size_t)(2 + 4 * nkeys), s);
  if (err != 0) return err;
  int64_t blocks = (width + OPS_THREADS - 1) / OPS_THREADS;
  const int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 16 + G - 1) / G;
  if (blocks > per_task) blocks = per_task;
  ops_kernel<<<dim3((unsigned)blocks, (unsigned)G), OPS_THREADS, 0, s>>>(
      (const long long*)tasks, width, (const KeyRow*)keys, nkeys, flag, mcount, orand);
  return (int)cudaGetLastError();
}

// words: n, width, mcount, perm, crow, words, key_bytes, keys, nk, orand,
// notand, seg, first, ends, scratch
extern "C" int tt_sg_sweep(const int64_t* w, int nwords, int n_sms, void* stream) {
  (void)n_sms;
  Words t{w, nwords, 0};
  SweepP p;
  p.n = t();
  p.width = t();
  p.mcount = (const int32_t*)t();
  p.perm = (const int32_t*)t();
  p.crow = (const int32_t*)t();
  p.words = (const void*)t();
  p.key_bytes = (int)t();
  if (p.n < 1 || p.n > 0x7fffffffLL || p.width < 1 || p.n % p.width != 0 || p.perm == nullptr ||
      (p.words != nullptr && p.key_bytes != 4 && p.key_bytes != 8) || take_keys(t, &p.keys, &p.nk) != 0)
    return -1;
  p.orand = (const ull*)t();
  p.notand = (int)t();
  p.seg = (int32_t*)t();
  p.first = (int32_t*)t();
  p.ends = (ll*)t();
  LookBack lb{(ll*)t()};
  if (!t.done() || p.orand == nullptr || p.seg == nullptr || p.first == nullptr || p.ends == nullptr ||
      lb.ws == nullptr)
    return -1;
  const ll nt = compact::tiles(p.n);
  sweep_kernel<<<(unsigned)nt, BLOCK, 0, (cudaStream_t)stream>>>(p, lb, nt);
  return (int)cudaGetLastError();
}

// words: take_finish's, then tail, ntail, crow, nclamp
extern "C" int tt_sg_finish_solo(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  FinishP p;
  if (take_finish(t, p) != 0) return -1;
  const int32_t* tail = (const int32_t*)t();
  const ll ntail = t();
  const int32_t* crow = (const int32_t*)t();
  const ll nclamp = t();
  if (!t.done() || ntail < 0 || nclamp < 0 || (ntail > 0 && tail == nullptr) || (nclamp > 0 && crow == nullptr))
    return -1;
  ll span = p.cap > ntail ? p.cap : ntail;
  if (nclamp > span) span = nclamp;
  if (span == 0) return 0;
  solo_finish_kernel<<<grid_for(span, n_sms, 16), OPS_THREADS, 0, (cudaStream_t)stream>>>(p, tail, ntail, crow,
                                                                                          nclamp, span);
  return (int)cudaGetLastError();
}

// words: take_finish's, then perm, mcount, width, npos
extern "C" int tt_sg_finish_tasks(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  FinishP p;
  if (take_finish(t, p) != 0) return -1;
  const int32_t* perm = (const int32_t*)t();
  const int32_t* mcount = (const int32_t*)t();
  const ll width = t();
  const ll npos = t();
  if (!t.done() || perm == nullptr || mcount == nullptr || width < 1 || npos < 1 || npos % width != 0) return -1;
  const ll span = p.cap > npos ? p.cap : npos;
  task_finish_kernel<<<grid_for(span, n_sms, 16), OPS_THREADS, 0, (cudaStream_t)stream>>>(
      p, perm, mcount, width, npos, p.cap < p.ng ? 1 : 0, span);
  return (int)cudaGetLastError();
}

// words: ntail, tail, a key table as tt_sg_compact's (its outputs [ntail])
extern "C" int tt_sg_tail_ops(const int64_t* w, int nwords, int n_sms, void* stream) {
  Words t{w, nwords, 0};
  const ll ntail = t();
  const int32_t* tail = (const int32_t*)t();
  const KeyRow* keys;
  int nk;
  if (ntail < 1 || tail == nullptr) return -1;
  const int err = put_table(t, &keys, &nk, (cudaStream_t)stream);
  if (err != 0) return err;
  if (!t.done()) return -1;
  tail_ops_kernel<<<grid_for(ntail, n_sms, 16), OPS_THREADS, 0, (cudaStream_t)stream>>>(keys, nk, tail, ntail);
  return (int)cudaGetLastError();
}

// words: n, m, crow, perm_m, tail, perm_t (0: the tail in row order), out
extern "C" int tt_sg_perm(const int64_t* w, int nwords, int n_sms, void* stream) {
  if (nwords != 7 || w[0] < 1 || w[1] < 0 || w[1] > w[0] || w[6] == 0) return -1;
  if (w[1] > 0 && (w[2] == 0 || w[3] == 0)) return -1;
  if (w[1] < w[0] && w[4] == 0) return -1;
  perm_kernel<<<grid_for(w[0], n_sms, 16), OPS_THREADS, 0, (cudaStream_t)stream>>>(
      w[0], w[1], (const int32_t*)w[2], (const int32_t*)w[3], (const int32_t*)w[4], (const int32_t*)w[5],
      (int32_t*)w[6]);
  return (int)cudaGetLastError();
}
