// K4 seg_agg: masked direct-address GROUP BY partials.
//
// Replaces the aggregation kernel of tidb_tpu/copr/tpu_engine.py:1287-1304
// (TPUEngine._lower_agg.kernel) with its reductions _seg_sum / _seg_min /
// _seg_max (:175-193) and the per-function partials of
// _agg_partials_device (:1527-1617); its task-grid mode replaces K10's
// reduction (tpu_engine.py:1096-1134 _vmapped_program over that kernel).
// Per row i:
//
//   code = mixed radix over the key lanes: code = code*(dom+1) + kd,
//          kd = key - lo + 1 for a valid key, 0 (the NULL slot) otherwise;
//          in the int32-wrap key form (a launch's `wrap32`: P8's dense MPP
//          code, tidb_tpu/parallel/mpp.py:1962-1967) each key's low 32 bits,
//          the code wrapped to int32 after each key, so codes above 2^31
//          turn negative and drop (a template argument: the other callers'
//          kernels compile without it);
//          or, in the precomputed-segment mode of the sort-based GROUP BY
//          (tpu_engine.py:1380-1399), the row's id from K9's segment lane
//          (csrc/sort_groups.cu), rows at or beyond nseg dropped
//   rows with mask[i] == 0 go to the overflow slot nseg, i.e. are dropped
//   every value lane k with ok = valid_k[i] folds its value into
//   out[k][code] with the lane's op (a row without ok is skipped):
//
//   COUNT      += 1                              -> int64 row
//   SUM_I64    += x, two's-complement wrap (mod 2^64), the wrap XLA's
//                 int64 segment sums have
//   SUM_F64    += x (order differs from XLA's: floats agree within the
//                 reference's own rtol 1e-9 / atol 1e-6, not bit for bit)
//   MIN/MAX_I64, MIN/MAX_U64 (unsigned order on uint64 bit patterns),
//   MIN/MAX_F64 (a NaN wins and stays, as XLA's min/max propagate NaN)
//   FIRST_ROW  min row index i over rows with ok, n for a masked-in row
//              without (the reference's where(ok, i, n))  -> int64 row
//   AND/OR/XOR_I64  &= | |= | ^= x: bit_and / bit_or / bit_xor, which the
//              reference reduces per bit over 64 lanes and recombines by
//              shifts (tpu_engine.py:1596-1617); their fills are their
//              identities -1 / 0 / 0, what the reference's per-bit
//              identities give an empty segment
//
// Empty segments keep the lane's fill (the reference's sentinel in the
// lane's own dtype: iinfo(dtype).max for MIN over an int32 dict-code lane,
// uint64 max bits for MIN_U64, +inf for MIN_F64, N for FIRST_ROW, 0 for
// sums and counts). Results land directly in the packed [k_i, nseg] int64
// and [k_f, nseg] float64 matrices the engine ships to the host, rows
// `ostride` elements apart (nseg; P8 writes every lane, float lanes as their
// bits, straight into its row of the MPP program's packed result, whose
// rows are wider than nseg).
//
// Bound: bytes. Each row reads its mask byte, its key lanes and, per value
// lane, 8 bytes of data plus one valid byte; outputs are k*nseg*8 bytes.
// What stands between a kernel and that bound is contention: TPC-H Q1 has
// nseg 12 with 4 live slots, Q6 one slot, so a warp's 32 rows land on 1-4
// addresses. The design:
//
//   * Rows in groups. A thread takes U = 4 consecutive rows at a time and
//     reads each byte lane (mask, valid) as one 4-byte load and each
//     8-byte lane as two 16-byte loads (scalar loads for a group past the
//     end or a lane that is not 16-byte aligned); the next value lane's
//     loads are issued before the current lane's reduction, so every
//     thread keeps two lanes' loads in flight.
//   * Op dispatch out of the row loop. The lane descriptors sit in shared
//     memory, read once per block; the op `switch` is taken once per lane
//     and row group, each case a template instance for its op. Lanes that
//     repeat another (same op, data, valid and fill: Q1's counts of the
//     masked-in rows) are folded once and copied at the merge.
//   * Warp pre-aggregation (MODE_WARP). Per row of a group the warp finds
//     the rows that share its segment (__match_any_sync on the code); the
//     peers combine their values by a shuffle tree whose schedule is
//     computed once per row and serves every lane (COUNT and FIRST_ROW
//     need only a ballot: rows ascend with the lane); the lowest peer
//     folds the result into its WARP's private slots in shared memory.
//     Leaders of one row hold distinct segments, so the fold is a plain
//     read-modify-write, ordered by __syncwarp: no atomics at all.
//   * Registers (MODE_REG), the threshold: nseg 1 with at most REG_LANES
//     (4) lanes, Q6's one global slot. Every thread accumulates its rows
//     in registers and the warp reduces once at the end (a butterfly).
//   * One merge across blocks. A block folds its warps' slots into one
//     partial per slot and writes it to a scratch [blocks, slots]; the
//     last block (an atomic ticket per task, left at zero) folds the
//     partials, skipping those still at their fill, and writes every
//     output, fills included: no init kernel, no per-block global atomics.
//   * MODE_GLOBAL, the fallback when the warps' slots do not fit shared
//     memory (Q18's subquery over ~3.9M groups, P6's build space): an init
//     kernel writes the fills, then each thread folds runs of equal
//     segments among its U rows and updates global memory atomically
//     (floats' min / max by compare-and-swap).
//
// One kernel body serves a solo call (a grid of one task) and K10's task
// grid: the grid's y axis is the task, read through a task table (TaskAgg:
// its mask, segment lane or key descriptors, lane descriptors and output
// slices) in device memory; each task reduces its first `width` rows (the
// group's narrowed width: rows past a task's real rows are masked, so
// dropping them changes no bit) into its own [k_i, nseg] / [k_f, nseg]
// slice. A sort GROUP BY's launch group reads each task's row of K9's
// task-grid segment lane instead of keys: the group ids run on across the
// tasks, so every task folds into ONE shared pair (shared_out, nseg = the
// group's total n_groups) and the merge spans every task's blocks.
//
// Plain C interface (nvcc + ctypes). The host (kernels/seg_agg.py
// `plan`) picks the mode, block size, blocks per task and shared bytes;
// tt_seg_agg_tasks launches on the given stream, never synchronizes, and
// returns the cudaError_t of the launches (0 = success), or -1 for an
// argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef long long ll;
typedef unsigned long long ull;

enum Op : int32_t {
  OP_COUNT = 0,
  OP_SUM_I64 = 1,
  OP_SUM_F64 = 2,
  OP_MIN_I64 = 3,
  OP_MAX_I64 = 4,
  OP_MIN_U64 = 5,
  OP_MAX_U64 = 6,
  OP_MIN_F64 = 7,
  OP_MAX_F64 = 8,
  OP_FIRST_ROW = 9,
  OP_AND_I64 = 10,
  OP_OR_I64 = 11,
  OP_XOR_I64 = 12,
};

enum Mode : int { MODE_REG = 0, MODE_WARP = 1, MODE_GLOBAL = 2 };

// Host-built descriptor tables (an int64 tensor on the card, laid out as
// these structs; kernels/grouped.py `seg_desc` packs them).
struct KeyDesc {
  const void* data;      // int32 or int64 key lane [N]
  const uint8_t* valid;  // bool [N], or null = all valid
  int64_t lo;
  int64_t dom;
  int64_t elem_bytes;    // 4 or 8
};

struct LaneDesc {
  const void* data;      // int64 or float64 [N], null for COUNT / FIRST_ROW
  const uint8_t* valid;  // bool [N], or null = every masked-in row
  int64_t fill;          // identity bits (int64, or float64 bits)
  int32_t op;
  int32_t out;           // row of the int or float output matrix
};

struct TaskAgg {
  const uint8_t* mask;    // bool [>= width]
  const int32_t* seg;     // precomputed segment lane, or null (key lanes)
  const KeyDesc* keys;    // [nkeys]
  const LaneDesc* lanes;  // [nlanes]
  int64_t* iout;          // this task's [k_i, nseg] slice
  double* fout;           // this task's [k_f, nseg] slice
};

constexpr int U = 4;            // rows per thread per group (kernels/seg_agg.py ROWS)
constexpr int REG_LANES = 4;    // MODE_REG's lane limit
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double dv(ull x) { return __longlong_as_double((ll)x); }
__device__ __forceinline__ ull db(double x) { return (ull)__double_as_longlong(x); }

__host__ __device__ constexpr ull ident_of(int op) {
  return op == OP_MIN_I64 || op == OP_FIRST_ROW ? 0x7FFFFFFFFFFFFFFFull
         : op == OP_MAX_I64                     ? 0x8000000000000000ull
         : op == OP_MIN_U64 || op == OP_AND_I64 ? ~0ull
         : op == OP_MIN_F64                     ? 0x7FF0000000000000ull  // +inf
         : op == OP_MAX_F64                     ? 0xFFF0000000000000ull  // -inf
                                                : 0ull;
}

__device__ __forceinline__ bool is_float_op(int op) {
  return op == OP_SUM_F64 || op == OP_MIN_F64 || op == OP_MAX_F64;
}

// Combine two partials of one slot.
template <int OP>
__device__ __forceinline__ ull comb(ull a, ull b) {
  if constexpr (OP == OP_COUNT || OP == OP_SUM_I64) {
    return a + b;
  } else if constexpr (OP == OP_SUM_F64) {
    return db(__dadd_rn(dv(a), dv(b)));
  } else if constexpr (OP == OP_MIN_I64 || OP == OP_FIRST_ROW) {
    return (ll)b < (ll)a ? b : a;
  } else if constexpr (OP == OP_MAX_I64) {
    return (ll)b > (ll)a ? b : a;
  } else if constexpr (OP == OP_MIN_U64) {
    return b < a ? b : a;
  } else if constexpr (OP == OP_MAX_U64) {
    return b > a ? b : a;
  } else if constexpr (OP == OP_MIN_F64) {
    const double x = dv(a), y = dv(b);
    return x != x ? a : (y != y ? b : (y < x ? b : a));
  } else if constexpr (OP == OP_MAX_F64) {
    const double x = dv(a), y = dv(b);
    return x != x ? a : (y != y ? b : (y > x ? b : a));
  } else if constexpr (OP == OP_AND_I64) {
    return a & b;
  } else if constexpr (OP == OP_OR_I64) {
    return a | b;
  } else {
    return a ^ b;
  }
}

// One row's contribution: `in` = masked in with a live segment, `ok` =
// the lane's valid bit; a NULL row folds n into FIRST_ROW, else nothing.
template <int OP>
__device__ __forceinline__ ull rowval(bool in, bool ok, ull raw, ll row, ll n) {
  if constexpr (OP == OP_COUNT) {
    return (in && ok) ? 1ull : 0ull;
  } else if constexpr (OP == OP_FIRST_ROW) {
    return in ? (ok ? (ull)row : (ull)n) : ident_of(OP);
  } else {
    return (in && ok) ? raw : ident_of(OP);
  }
}

#define SEG_AGG_OPS(X)                                                                     \
  X(OP_COUNT) X(OP_SUM_I64) X(OP_SUM_F64) X(OP_MIN_I64) X(OP_MAX_I64) X(OP_MIN_U64)        \
  X(OP_MAX_U64) X(OP_MIN_F64) X(OP_MAX_F64) X(OP_FIRST_ROW) X(OP_AND_I64) X(OP_OR_I64)     \
  X(OP_XOR_I64)

__device__ __forceinline__ ull comb_rt(int op, ull a, ull b) {
  switch (op) {
#define X(O) \
  case O:    \
    return comb<O>(a, b);
    SEG_AGG_OPS(X)
#undef X
  }
  return a;
}

// --- loads of a row group ------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// bit u set when byte r0 + u is nonzero (0 past n)
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ p, ll r0, ll n) {
  const uint8_t* q = p + r0;
  if (r0 + U <= n && ((uintptr_t)q & 3) == 0) {
    const unsigned m = __vcmpne4(__ldg(reinterpret_cast<const unsigned*>(q)), 0u);
    return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
  }
  unsigned b = 0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r0 + u < n && __ldg(q + u)) b |= 1u << u;
  return b;
}

__device__ __forceinline__ void load8(const void* __restrict__ base, ll r0, ll n, ull (&x)[U]) {
  const ll* p = reinterpret_cast<const ll*>(base) + r0;
  if (r0 + U <= n && aligned16(base)) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
    x[0] = (ull)a.x;
    x[1] = (ull)a.y;
    x[2] = (ull)b.x;
    x[3] = (ull)b.y;
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) x[u] = r0 + u < n ? (ull)__ldg(p + u) : 0ull;
}

__device__ __forceinline__ void load4(const void* __restrict__ base, ll r0, ll n, ll (&x)[U]) {
  const int* p = reinterpret_cast<const int*>(base) + r0;
  if (r0 + U <= n && aligned16(base)) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) x[u] = r0 + u < n ? (ll)__ldg(p + u) : 0;
}

// The group's segments: s[u] = the row's slot, or -1 when it is masked
// out, past n, or its code falls outside [0, nseg). WRAP32: the keys'
// int32-wrap form (file note).
template <bool WRAP32>
__device__ __forceinline__ void group_segs(const TaskAgg& T, const KeyDesc* __restrict__ keys,
                                           int nkeys, ll nseg, ll r0, ll n, int (&s)[U]) {
  const unsigned mb = load_bits(T.mask, r0, n);
  ll code[U];
  if (T.seg != nullptr) {
    load4(T.seg, r0, n, code);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) code[u] = 0;
    for (int k = 0; k < nkeys; ++k) {
      const KeyDesc& K = keys[k];
      ll kv[U];
      if (K.elem_bytes == 4) {
        load4(K.data, r0, n, kv);
      } else {
        ull w[U];
        load8(K.data, r0, n, w);
#pragma unroll
        for (int u = 0; u < U; ++u) kv[u] = (ll)w[u];
      }
      const unsigned vb = K.valid != nullptr ? load_bits(K.valid, r0, n) : 0xFu;
      if constexpr (WRAP32) {
        // int32(d) - lo + 1 and the code in int32 wrap: the same low 32
        // bits as the reference's int32 arithmetic, exact in 64 bits here
        // (lo is the int32 the host wrapped it to, the code stays in int32)
#pragma unroll
        for (int u = 0; u < U; ++u)
          code[u] = (ll)(int32_t)(uint32_t)((ull)code[u] * (ull)(K.dom + 1) +
                                            (((vb >> u) & 1) ? (ull)((ll)(int32_t)kv[u] - K.lo + 1) : 0ull));
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) code[u] = code[u] * (K.dom + 1) + (((vb >> u) & 1) ? kv[u] - K.lo + 1 : 0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = ((mb >> u) & 1) && code[u] >= 0 && code[u] < nseg ? (int)code[u] : -1;
}

struct LaneRows {
  ull x[U];
  unsigned ok;  // valid bits
};

__device__ __forceinline__ void load_lane(const LaneDesc& L, ll r0, ll n, LaneRows& r) {
  if (L.data != nullptr) {
    load8(L.data, r0, n, r.x);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) r.x[u] = 0;
  }
  r.ok = L.valid != nullptr ? load_bits(L.valid, r0, n) : 0xFu;
}

// --- MODE_REG: a thread's rows in registers ---------------------------------

template <int OP>
__device__ __forceinline__ ull reg_lane(ull acc, const LaneRows& r, unsigned inb, ll r0, ll n) {
  if constexpr (OP == OP_COUNT) {
    return acc + (ull)__popc(inb & r.ok);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) acc = comb<OP>(acc, rowval<OP>((inb >> u) & 1, (r.ok >> u) & 1, r.x[u], r0 + u, n));
    return acc;
  }
}

// the warp's total (a butterfly), folded by lane 0 into the warp's slot
template <int OP>
__device__ __forceinline__ void reg_total(ull acc, int lane, ull* slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = comb<OP>(acc, __shfl_xor_sync(FULL, acc, off));
  if (lane == 0) *slot = comb<OP>(*slot, acc);
}

// --- MODE_WARP: one row group of one lane ---------------------------------

// Per row of a group: the peers (rows of the warp with the same segment),
// the shuffle schedule that folds them into the lowest peer (6 bits a
// round: 1 + the source lane, 0 = none), and whether this thread leads a
// live segment; the rounds (warp-uniform) serve every row of the group.
struct Peers {
  unsigned peers[U];
  unsigned sched[U];
  int rounds;
  unsigned lead;  // bit u: this thread folds row u's segment
};

__device__ __forceinline__ void find_peers(const int (&s)[U], int lane, Peers& P) {
  unsigned hi[U];
  int rank[U];
  P.lead = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned peers = __match_any_sync(FULL, s[u]);
    P.peers[u] = peers;
    P.sched[u] = 0;
    if (s[u] >= 0 && __ffs(peers) - 1 == lane) P.lead |= 1u << u;
    hi[u] = peers & (0xfffffffeu << lane);  // the peers above this lane
    rank[u] = __popc(peers & ((1u << lane) - 1u));
  }
  // Westphal's tree, the U rows side by side: each round a peer adds the
  // next remaining peer above it; peers whose rank bit is set drop out (a
  // row done early shuffles from itself: source 0)
  int it = 0;
  for (;;) {
    unsigned left = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) left |= hi[u];
    if (!__any_sync(FULL, left != 0)) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      P.sched[u] |= (unsigned)__ffs(hi[u]) << (6 * it);
      hi[u] &= __ballot_sync(FULL, !(rank[u] & 1));
      rank[u] >>= 1;
    }
    ++it;
  }
  P.rounds = it;
}

template <int OP>
__device__ __forceinline__ void warp_lane(const LaneRows& r, const int (&s)[U], const Peers& P, int lane,
                                          ll r0, ll n, ull* __restrict__ slots) {
  ull v[U];
  if constexpr (OP == OP_COUNT) {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = (ull)__popc(__ballot_sync(FULL, s[u] >= 0 && ((r.ok >> u) & 1)) & P.peers[u]);
  } else if constexpr (OP == OP_FIRST_ROW) {
    // rows ascend with the lane: the least row with ok is the lowest such
    // peer's
    const ll warp_r0 = r0 - (ll)lane * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned hits = __ballot_sync(FULL, s[u] >= 0 && ((r.ok >> u) & 1)) & P.peers[u];
      v[u] = hits ? (ull)(warp_r0 + (ll)(__ffs(hits) - 1) * U + u) : (ull)n;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = rowval<OP>(s[u] >= 0, (r.ok >> u) & 1, r.x[u], r0 + u, n);
    for (int i = 0; i < P.rounds; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int nx = (P.sched[u] >> (6 * i)) & 63;
        const ull t = __shfl_sync(FULL, v[u], nx ? nx - 1 : lane);
        if (nx) v[u] = comb<OP>(v[u], t);
      }
    }
  }
  // leaders of one row hold distinct segments; a later row's leader may
  // hold an earlier one's
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if ((P.lead >> u) & 1) slots[s[u]] = comb<OP>(slots[s[u]], v[u]);
    __syncwarp();
  }
}

// --- MODE_GLOBAL: runs of equal segments among a thread's rows -------------

template <int OP>
__device__ __forceinline__ void atomic_fold(ull* slot, ull v) {
  if constexpr (OP == OP_COUNT || OP == OP_SUM_I64) {
    atomicAdd(slot, v);
  } else if constexpr (OP == OP_SUM_F64) {
    atomicAdd(reinterpret_cast<double*>(slot), dv(v));
  } else if constexpr (OP == OP_MIN_I64 || OP == OP_FIRST_ROW) {
    atomicMin(reinterpret_cast<ll*>(slot), (ll)v);
  } else if constexpr (OP == OP_MAX_I64) {
    atomicMax(reinterpret_cast<ll*>(slot), (ll)v);
  } else if constexpr (OP == OP_MIN_U64) {
    atomicMin(slot, v);
  } else if constexpr (OP == OP_MAX_U64) {
    atomicMax(slot, v);
  } else if constexpr (OP == OP_MIN_F64 || OP == OP_MAX_F64) {
    ull old = *slot, assumed;
    do {
      assumed = old;
      const ull want = comb<OP>(assumed, v);
      if (want == assumed) return;
      old = atomicCAS(slot, assumed, want);
    } while (old != assumed);
  } else if constexpr (OP == OP_AND_I64) {
    atomicAnd(slot, v);
  } else if constexpr (OP == OP_OR_I64) {
    atomicOr(slot, v);
  } else {
    atomicXor(slot, v);
  }
}

template <int OP>
__device__ __forceinline__ void global_lane(const LaneRows& r, const int (&s)[U], ll r0, ll n, ull* out) {
  int cur = -1;
  ull acc = ident_of(OP);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (s[u] < 0) continue;
    const ull v = rowval<OP>(true, (r.ok >> u) & 1, r.x[u], r0 + u, n);
    if (s[u] == cur) {
      acc = comb<OP>(acc, v);
      continue;
    }
    if (cur >= 0 && acc != ident_of(OP)) atomic_fold<OP>(out + cur, acc);
    cur = s[u];
    acc = v;
  }
  if (cur >= 0 && acc != ident_of(OP)) atomic_fold<OP>(out + cur, acc);
}

// lane L's slot `seg` in its output row (rows `ostride` elements apart)
__device__ __forceinline__ ull* out_slot(const TaskAgg& T, const LaneDesc& L, ll ostride, ll seg) {
  return is_float_op(L.op) ? reinterpret_cast<ull*>(T.fout + (ll)L.out * ostride + seg)
                           : reinterpret_cast<ull*>(T.iout + (ll)L.out * ostride + seg);
}

// Shared layout: lane descriptors, key descriptors, the active lanes and
// each lane's source lane (ints), then (16-byte aligned) the warps' slots
// [W][nlanes * nseg] (MODE_REG / MODE_WARP; also the merge's buffer of
// blockDim entries). kernels/seg_agg.py `plan` computes the same bytes.
__host__ __device__ constexpr ll desc_bytes(int nkeys, int nlanes) {
  return ((ll)nlanes * (ll)sizeof(LaneDesc) + (ll)nkeys * (ll)sizeof(KeyDesc) + 8LL * nlanes + 4 + 15) / 16 * 16;
}

template <int MODE, bool WRAP32>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    seg_agg_kernel(const TaskAgg* __restrict__ tasks, ll width, int nkeys, int nlanes, ll nseg, ll ostride,
                   int shared_out, ll* __restrict__ tickets, ull* __restrict__ parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  LaneDesc* sl = reinterpret_cast<LaneDesc*>(smem);
  KeyDesc* sk = reinterpret_cast<KeyDesc*>(sl + nlanes);
  int* act = reinterpret_cast<int*>(sk + nkeys);  // the lanes folded, in order
  int* src = act + nlanes;                       // the lane whose slots hold lane k's result
  int* nact = src + nlanes;
  ull* wsl = reinterpret_cast<ull*>(smem + desc_bytes(nkeys, nlanes));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const TaskAgg T = tasks[blockIdx.y];
  const ll S = (ll)nlanes * nseg;
  for (int j = tid; j < nlanes; j += blockDim.x) sl[j] = T.lanes[j];
  for (int j = tid; j < nkeys; j += blockDim.x) sk[j] = T.keys[j];
  __syncthreads();
  if (tid == 0) {
    int na = 0;
    for (int k = 0; k < nlanes; ++k) {
      src[k] = k;
      if (MODE != MODE_GLOBAL)
        for (int j = 0; j < k; ++j)
          if (sl[j].op == sl[k].op && sl[j].data == sl[k].data && sl[j].valid == sl[k].valid &&
              sl[j].fill == sl[k].fill) {
            src[k] = src[j];
            break;
          }
      if (src[k] == k) act[na++] = k;
    }
    *nact = na;
  }
  ull* mine = wsl + (ll)warp * S;
  if (MODE != MODE_GLOBAL) {
    for (ll t = lane; t < S; t += 32) mine[t] = (ull)sl[t / nseg].fill;
  }
  __syncthreads();
  const int na = *nact;
  const ll n = width;
  const ll warps = (ll)gridDim.x * W;
  ull acc[REG_LANES];
  if constexpr (MODE == MODE_REG) {
#pragma unroll
    for (int j = 0; j < REG_LANES; ++j) {
      if (j < na) {
        switch (sl[act[j]].op) {
#define X(O)               \
  case O:                  \
    acc[j] = ident_of(O);  \
    break;
          SEG_AGG_OPS(X)
#undef X
        }
      }
    }
  }
  // all 32 threads of a warp walk the groups together (the warp's
  // collectives need every lane); a group past the end has no live rows
  for (ll gw = (ll)blockIdx.x * W + warp; gw * 32 * U < n; gw += warps) {
    const ll r0 = (gw * 32 + lane) * U;
    int s[U];
    group_segs<WRAP32>(T, sk, nkeys, nseg, r0, n, s);
    if constexpr (MODE == MODE_REG) {
      unsigned inb = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) inb |= (s[u] >= 0 ? 1u : 0u) << u;
      LaneRows nxt;
      if (na > 0) load_lane(sl[act[0]], r0, n, nxt);
#pragma unroll
      for (int j = 0; j < REG_LANES; ++j) {
        if (j < na) {
          const LaneRows cur = nxt;
          if (j + 1 < na) load_lane(sl[act[j + 1]], r0, n, nxt);
          switch (sl[act[j]].op) {
#define X(O)                                          \
  case O:                                             \
    acc[j] = reg_lane<O>(acc[j], cur, inb, r0, n);     \
    break;
            SEG_AGG_OPS(X)
#undef X
          }
        }
      }
    } else if constexpr (MODE == MODE_WARP) {
      Peers P;
      find_peers(s, lane, P);
      LaneRows nxt;
      if (na > 0) load_lane(sl[act[0]], r0, n, nxt);
      for (int j = 0; j < na; ++j) {
        const LaneRows cur = nxt;
        if (j + 1 < na) load_lane(sl[act[j + 1]], r0, n, nxt);
        ull* slots = mine + (ll)act[j] * nseg;
        switch (sl[act[j]].op) {
#define X(O)                                    \
  case O:                                       \
    warp_lane<O>(cur, s, P, lane, r0, n, slots); \
    break;
          SEG_AGG_OPS(X)
#undef X
        }
      }
    } else {
      LaneRows nxt;
      if (na > 0) load_lane(sl[act[0]], r0, n, nxt);
      for (int j = 0; j < na; ++j) {
        const LaneRows cur = nxt;
        if (j + 1 < na) load_lane(sl[act[j + 1]], r0, n, nxt);
        const LaneDesc& L = sl[act[j]];
        ull* out = out_slot(T, L, ostride, 0);
        switch (L.op) {
#define X(O)                               \
  case O:                                  \
    global_lane<O>(cur, s, r0, n, out);    \
    break;
          SEG_AGG_OPS(X)
#undef X
        }
      }
    }
  }
  if constexpr (MODE == MODE_GLOBAL) {
    return;
  } else {
    if constexpr (MODE == MODE_REG) {
      // nseg is 1: lane k's slot is k
#pragma unroll
      for (int j = 0; j < REG_LANES; ++j) {
        if (j < na) {
          const int k = act[j];
          switch (sl[k].op) {
#define X(O)                                 \
  case O:                                    \
    reg_total<O>(acc[j], lane, mine + k);    \
    break;
            SEG_AGG_OPS(X)
#undef X
          }
        }
      }
    }
    __syncthreads();
    // the block's partial of every slot: its warps' slots, those still at
    // their fill skipped (a fill is its op's identity, or for FIRST_ROW
    // and min / max a bound the min / max keeps)
    const int G = gridDim.y;
    const ll nb = shared_out ? (ll)G * gridDim.x : (ll)gridDim.x;  // blocks that merge into this task's outputs
    const ll p0 = shared_out ? 0 : (ll)blockIdx.y * gridDim.x;      // the group's first partial
    const ll grp = shared_out ? 0 : blockIdx.y;
    ull* mypart = parts + ((ll)blockIdx.y * gridDim.x + blockIdx.x) * S;
    for (ll t = tid; t < S; t += blockDim.x) {
      const int k = (int)(t / nseg);
      const ll sg = t - (ll)k * nseg;
      const LaneDesc& L = sl[k];
      const ull fill = (ull)L.fill;
      const ll from = (ll)src[k] * nseg + sg;
      ull r = fill;
      for (int w = 0; w < W; ++w) {
        const ull v = wsl[(ll)w * S + from];
        if (v != fill) r = comb_rt(L.op, r, v);
      }
      if (nb == 1)
        *out_slot(T, L, ostride, sg) = r;
      else
        mypart[t] = r;
    }
    if (nb == 1) return;
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_block = atomicAdd(reinterpret_cast<ull*>(tickets + grp), 1ull) == (ull)(nb - 1);
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    // the last block folds the group's partials: C slots at a time, each
    // over P interleaved parts of the blocks, then the P parts of a slot
    const int C = S < 32 ? (int)S : 32, P = blockDim.x / C;
    const int c = tid % C, p = tid / C;
    for (ll t0 = 0; t0 < S; t0 += C) {
      const ll t = t0 + c;
      const bool live = p < P && t < S;
      const int k = live ? (int)(t / nseg) : 0;
      const int op = sl[k].op;
      const ull fill = (ull)sl[k].fill;
      if (live) {
        ull r = fill;
        for (ll b = p; b < nb; b += P) {
          const ull v = __ldcg(reinterpret_cast<const unsigned long long*>(parts + (p0 + b) * S + t));
          if (v != fill) r = comb_rt(op, r, v);
        }
        wsl[p * C + c] = r;
      }
      __syncthreads();
      if (p == 0 && t < S) {
        ull r = wsl[c];
        for (int q = 1; q < P; ++q) {
          const ull v = wsl[q * C + c];
          if (v != fill) r = comb_rt(op, r, v);
        }
        *out_slot(T, sl[k], ostride, t - (ll)k * nseg) = r;
      }
      __syncthreads();
    }
    if (tid == 0) tickets[grp] = 0;  // left at zero for the next call
  }
}

// MODE_GLOBAL's outputs start at their fills.
__global__ void init_kernel(const TaskAgg* __restrict__ tasks, int nlanes, ll nseg, ll ostride) {
  const TaskAgg T = tasks[blockIdx.y];
  const ll total = (ll)nlanes * nseg;
  for (ll t = (ll)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += (ll)gridDim.x * blockDim.x) {
    const LaneDesc& L = T.lanes[t / nseg];
    *out_slot(T, L, ostride, t % nseg) = (ull)L.fill;
  }
}

template <int MODE>
int launch(bool wrap32, const TaskAgg* T, int G, ll width, int nkeys, int nlanes, ll nseg, ll ostride,
           int shared_out, int threads, int blocks, ll smem, ll* tickets, ull* parts, cudaStream_t s) {
  const auto kernel = wrap32 ? seg_agg_kernel<MODE, true> : seg_agg_kernel<MODE, false>;
  // The opt-in shared-memory limit is the function's attribute on each
  // device: set once a device, a bit each (a mesh's ranks launch from
  // threads at once; setting it twice does no harm).
  static std::atomic<unsigned long long> set_on[2];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaGetLastError();
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit == 0 || !(set_on[wrap32].load(std::memory_order_acquire) & bit)) {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return (int)cudaGetLastError();
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024 - (int)fa.sharedSizeBytes) != cudaSuccess)
      return (int)cudaGetLastError();
    set_on[wrap32].fetch_or(bit, std::memory_order_release);
  }
  kernel<<<dim3((unsigned)blocks, (unsigned)G), threads, (size_t)smem, s>>>(
      T, width, nkeys, nlanes, nseg, ostride, shared_out, tickets, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch (two in MODE_GLOBAL: the fills, then the folds) over G tasks.
// `blocks` is the grid's x extent, blocks per task. Where blocks merge
// (MODE_REG / MODE_WARP, more than one block to a task's outputs),
// `tickets` holds a word per task (one with shared_out), zero and left at
// zero, and `parts` the partials [G * blocks, nlanes * nseg]. `ostride` is
// the elements between two rows of an output matrix (>= nseg); `wrap32`
// reads every key in the int32-wrap form (file note).
extern "C" int tt_seg_agg_tasks(const void* tasks, int G, int64_t width, int nkeys, int nlanes, int64_t nseg,
                                int64_t ostride, int wrap32, int shared_out, int mode, int threads, int blocks,
                                int64_t smem, int64_t* tickets, int64_t* parts, void* stream) {
  if (nseg <= 0 || nseg >= ((int64_t)1 << 31) || ostride < nseg || nlanes <= 0 || nkeys < 0 || G < 1 ||
      G > 65535 || blocks < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || smem > 227 * 1024 ||
      width < 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const TaskAgg* T = (const TaskAgg*)tasks;
  ll* tk = reinterpret_cast<ll*>(tickets);
  ull* pt = reinterpret_cast<ull*>(parts);
  const bool w = wrap32 != 0 && nkeys > 0;
  const ll S = (ll)nlanes * nseg;
  ll need = desc_bytes(nkeys, nlanes);
  if (mode != MODE_GLOBAL) {
    const ll slots = (ll)(threads / 32) * S;
    need += 8 * (slots > threads ? slots : threads);
    const ll nb = shared_out ? (ll)G * blocks : blocks;
    if (nb > 1 && (tickets == nullptr || parts == nullptr)) return -1;
    if (mode == MODE_REG && (nseg != 1 || nlanes > REG_LANES)) return -1;
  }
  if (smem < need) return -1;
  switch (mode) {
    case MODE_REG:
      return launch<MODE_REG>(w, T, G, width, nkeys, nlanes, nseg, ostride, shared_out, threads, blocks, smem,
                              tk, pt, s);
    case MODE_WARP:
      return launch<MODE_WARP>(w, T, G, width, nkeys, nlanes, nseg, ostride, shared_out, threads, blocks, smem,
                               tk, pt, s);
    case MODE_GLOBAL: {
      ll init_blocks = (S + 255) / 256;
      if (init_blocks > 65535) init_blocks = 65535;
      init_kernel<<<dim3((unsigned)init_blocks, shared_out ? 1u : (unsigned)G), 256, 0, s>>>(T, nlanes, nseg,
                                                                                          ostride);
      const int err = (int)cudaGetLastError();
      if (err != 0 || width == 0) return err;
      return launch<MODE_GLOBAL>(w, T, G, width, nkeys, nlanes, nseg, ostride, shared_out, threads, blocks,
                                 smem, tk, pt, s);
    }
  }
  return -1;
}
