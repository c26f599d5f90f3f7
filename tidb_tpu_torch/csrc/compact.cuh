// Sentinel-last compaction, shared by P4 (sort_join.cu) and P5
// (seg_reduce.cu), and the decoupled look-back both build on; K9
// (sort_groups.cu) places its masked-in rows and numbers its groups with
// the same place_tile.
//
// A stable sort of an operand whose masked rows all hold the sentinel (the
// operand's largest value) orders the other rows stably among themselves
// and then the sentinel rows in row order. So it is the same permutation
// as: compact the rows whose operand is not the sentinel (M of them),
// stably sort only those, and append the rest in row order. Partitioning
// on `operand != sentinel` (not on the mask) keeps a valid row whose
// operand equals the sentinel among the masked ones, where the reference's
// jnp.argsort puts it. compact_tile is one pass over the rows, inside the
// kernel that computes the operand (P5's group code, P4's packed build
// key): per tile of TILE rows (rounds of BLOCK consecutive rows, so that a
// warp's loads and stores are 32 consecutive rows) a block counts its kept
// rows by ballots, takes its offset by decoupled look-back and writes
//
//   comp / crow   the kept operands and their row ids, in row order
//   tail          the other rows' ids, in row order (null: not written)
//   res           M, and the OR and AND of the kept operands' keys
//                 (x ^ 2^63, K8's order-preserving key of an int64): the
//                 bits K8's radix plan needs
//
// so that the host reads M and the OR/AND in one copy and K8
// (csrc/lex_sort.cu) sorts M rows in only the bits they vary in.
//
// The look-back scratch (int64 words): [0] tile ticket, [1] done ticket,
// then one 16-byte descriptor a (tile, slot) — word 0: status << 62 | a
// (status 0 none, 1 aggregate, 2 inclusive prefix), word 1: b — stored and
// loaded as one 16-byte transaction, so status and value arrive together;
// after a compaction's descriptors, each tile's OR and NOT-AND (written by
// its block, folded by the launch's last block: no atomics on one word).
// The scratch is zeroed when it is allocated
// (kernels/tables.stream_scratch); the last block of a launch (by the done
// ticket) sets everything it used back to zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace compact {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
constexpr int ITEMS = 8;
constexpr int TILE = BLOCK * ITEMS;  // rows a compaction tile
constexpr int HEAD = 8;              // scratch words before the descriptors
constexpr ull SIGN = 0x8000000000000000ULL;
constexpr unsigned FULL = 0xffffffffu;
constexpr ll A_MASK = (1LL << 62) - 1;

struct P2 {
  ll a;  // < 2^62
  ll b;
};

struct LookBack {
  ll* ws;
  __device__ unsigned* ticket() const { return (unsigned*)ws; }
  __device__ unsigned* done() const { return (unsigned*)(ws + 1); }
  __device__ ll* desc(ll j) const { return ws + HEAD + 2 * j; }
};

// scratch words of a launch with `descs` descriptors
inline ll scratch_words(ll descs) { return HEAD + 2 * descs; }

// scratch words of a compaction over ntiles tiles: a descriptor and an
// (OR, NOT-AND) pair a tile
inline ll compact_words(ll ntiles) { return HEAD + 4 * ntiles; }

inline ll tiles(ll n) { return (n + TILE - 1) / TILE; }

__device__ __forceinline__ void put_desc(ll* d, ll status, const P2& v) {
  asm volatile("st.volatile.global.v2.s64 [%0], {%1, %2};" ::"l"(d), "l"((status << 62) | v.a), "l"(v.b)
               : "memory");
}

__device__ __forceinline__ ll get_desc(const ll* d, P2* v) {  // → status
  ll w0, w1;
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];" : "=l"(w0), "=l"(w1) : "l"(d) : "memory");
  v->a = w0 & A_MASK;
  v->b = w1;
  return (ll)((ull)w0 >> 62);
}

// The exclusive prefix of slot `slot` of tile `tile` (descriptor j * slots
// + slot of tile j), run by the 32 lanes of one warp after the tile has
// published its aggregate: the warp reads the descriptors of the 32 tiles
// before the window's start at once (lane q on tile j - q), waits until
// each has published, folds them in order up to the nearest inclusive one
// (earlier tiles sit in higher lanes) and moves the window back until it
// meets one. Op: P2 id() and P2 operator()(earlier, later).
template <typename Op>
__device__ P2 look_back(const LookBack& lb, ll tile, int slots, int slot, const Op& op) {
  const int lane = threadIdx.x & 31;
  P2 excl = op.id();
  for (ll j = tile - 1;; j -= 32) {
    const ll q = j - lane;
    ll s = 2;  // before tile 0: nothing to fold
    P2 v = op.id();
    if (q >= 0) {
      while ((s = get_desc(lb.desc(q * slots + slot), &v)) == 0) {
      }
    }
    const unsigned incl = __ballot_sync(FULL, s == 2);
    if (incl && lane > __ffs(incl) - 1) v = op.id();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      P2 o;
      o.a = __shfl_down_sync(FULL, v.a, off);
      o.b = __shfl_down_sync(FULL, v.b, off);
      if (lane + off < 32) v = op(o, v);
    }
    P2 w;
    w.a = __shfl_sync(FULL, v.a, 0);
    w.b = __shfl_sync(FULL, v.b, 0);
    excl = op(w, excl);
    if (incl) break;
  }
  return excl;
}

// the block's tile, in the order the blocks start (a block only ever waits
// on a lower tile, which a running block holds)
__device__ __forceinline__ ll take_tile(const LookBack& lb, unsigned* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(lb.ticket(), 1u);
  __syncthreads();
  return (ll)*s_tile;
}

// whether this block is the launch's last to finish (every block calls it
// once, at its end)
__device__ __forceinline__ bool last_block(const LookBack& lb, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(lb.done(), 1u) == gridDim.x - 1;
  __syncthreads();
  return *s_last != 0;
}

// the last block sets the tickets and `descs` descriptors back to zero
__device__ __forceinline__ void reset(const LookBack& lb, ll descs) {
  for (ll j = threadIdx.x; j < 2 * descs; j += blockDim.x) lb.ws[HEAD + j] = 0;
  if (threadIdx.x == 0) {
    *lb.ticket() = 0u;
    *lb.done() = 0u;
  }
}

struct AddA {  // the kept-row count in a
  __device__ __forceinline__ P2 id() const { return P2{0, 0}; }
  __device__ __forceinline__ P2 operator()(const P2& x, const P2& y) const { return P2{x.a + y.a, 0}; }
};

struct Out {
  ll* comp;      // [N] the first M: the kept operands, in row order
  int32_t* crow;  // [N] the first M: their row ids
  int32_t* tail;  // [N] the first N - M: the other rows' ids, in row order (null: none written)
  ll* res;       // [3] M, OR, AND of the kept keys (x ^ 2^63)
};

constexpr int WARPS = BLOCK / 32;
constexpr int PARTS = ITEMS * WARPS;  // (round, warp) parts of a tile, in row order

// row j of this thread's tile: rounds of BLOCK consecutive rows, so that
// each warp loads and stores 32 consecutive rows at once
__device__ __forceinline__ ll row_of(ll tile, int j) { return tile * TILE + (ll)j * BLOCK + threadIdx.x; }

struct Temp {
  int off[PARTS];           // kept rows of the tile before each (round, warp) part
  ull bits[2][WARPS];       // each warp's OR and NOT-AND
  ll base;                  // kept rows before the tile
  ll count;                 // kept rows in the tile
  int last;
};

// The places of a tile's kept rows (rows row_of(tile, j), j < ITEMS, keep[j]
// false past n): each (round, warp) part counts its kept rows by one
// ballot (kmask), warp 0 scans the PARTS counts and takes the tile's offset
// by look-back (publishing the tile's inclusive count for the tiles after
// it). Called once by every thread of a block of BLOCK threads; it ends on
// a barrier, after which kept_before() gives each row's place.
__device__ __forceinline__ void place_tile(const LookBack& lb, ll tile, const bool (&keep)[ITEMS],
                                           unsigned (&kmask)[ITEMS], Temp& tmp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    kmask[j] = __ballot_sync(FULL, keep[j]);
    if (lane == 0) tmp.off[j * WARPS + w] = __popc(kmask[j]);
  }
  __syncthreads();
  if (w == 0) {  // the parts' exclusive offsets (PARTS / 32 a lane), then the tile's by look-back
    constexpr int PER = PARTS / 32;
    int c[PER], sum = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      c[q] = tmp.off[lane * PER + q];
      sum += c[q];
    }
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    const int agg = __shfl_sync(FULL, inc, 31);
    int run = inc - sum;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      tmp.off[lane * PER + q] = run;
      run += c[q];
    }
    ll before = 0;
    if (tile == 0) {
      if (lane == 0) put_desc(lb.desc(0), 2, P2{agg, 0});
    } else {
      if (lane == 0) put_desc(lb.desc(tile), 1, P2{agg, 0});
      before = look_back(lb, tile, 1, 0, AddA()).a;
      if (lane == 0) put_desc(lb.desc(tile), 2, P2{before + agg, 0});
    }
    if (lane == 0) {
      tmp.base = before;
      tmp.count = agg;
    }
  }
  __syncthreads();
}

// kept rows before row_of(tile, j) of this thread (after place_tile)
__device__ __forceinline__ ll kept_before(const Temp& tmp, const unsigned (&kmask)[ITEMS], int j) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return tmp.base + tmp.off[j * WARPS + w] + __popc(kmask[j] & ((1u << lane) - 1u));
}

// One tile of the compaction over rows row_of(tile, j), j < ITEMS, with
// operand x[j] and keep[j] (false past n). Called once by every thread of a
// block of BLOCK threads, as the block's last work: the block's end runs
// the done ticket (the caller's grid is ntiles blocks, one tile each). The
// kept rows find their places by place_tile; thread 0 files the tile's OR
// and NOT-AND, which the launch's last block folds.
__device__ __forceinline__ void compact_tile(const LookBack& lb, ll tile, ll ntiles, ll n, const ll (&x)[ITEMS],
                                             const bool (&keep)[ITEMS], const Out& out, Temp& tmp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned kmask[ITEMS];
  ull o = 0ULL, na = 0ULL;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (keep[j]) {
      const ull u = (ull)x[j] ^ SIGN;
      o |= u;
      na |= ~u;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    o |= __shfl_xor_sync(FULL, o, off);
    na |= __shfl_xor_sync(FULL, na, off);
  }
  if (lane == 0) {
    tmp.bits[0][w] = o;
    tmp.bits[1][w] = na;
  }
  place_tile(lb, tile, keep, kmask, tmp);  // its barriers order the bits before thread 0's fold
  ull* part = (ull*)lb.desc(ntiles);  // the tiles' (OR, NOT-AND) pairs
  if (threadIdx.x == 0) {
    ull bo = 0ULL, bn = 0ULL;
    for (int q = 0; q < WARPS; ++q) {
      bo |= tmp.bits[0][q];
      bn |= tmp.bits[1][q];
    }
    part[2 * tile] = bo;
    part[2 * tile + 1] = bn;
    if (tile == ntiles - 1) out.res[0] = tmp.base + tmp.count;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const ll i = row_of(tile, j);
    if (i >= n) break;
    const ll kept = kept_before(tmp, kmask, j);  // kept rows before row i
    if (keep[j]) {
      out.comp[kept] = x[j];
      out.crow[kept] = (int32_t)i;
    } else if (out.tail != nullptr) {
      out.tail[i - kept] = (int32_t)i;
    }
  }
  if (last_block(lb, &tmp.last)) {  // every tile's pair is written: fold them
    ull bo = 0ULL, bn = 0ULL;
    for (ll j = threadIdx.x; j < ntiles; j += BLOCK) {
      bo |= __ldcg(part + 2 * j);
      bn |= __ldcg(part + 2 * j + 1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bo |= __shfl_xor_sync(FULL, bo, off);
      bn |= __shfl_xor_sync(FULL, bn, off);
    }
    if (lane == 0) {
      tmp.bits[0][w] = bo;
      tmp.bits[1][w] = bn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 0; q < WARPS; ++q) {
        bo |= tmp.bits[0][q];
        bn |= tmp.bits[1][q];
      }
      out.res[1] = (ll)bo;
      out.res[2] = (ll)~bn;
    }
    reset(lb, 2 * ntiles);  // the descriptors and the pairs: the next launch on this scratch finds zeros
  }
}

}  // namespace compact
}  // namespace
