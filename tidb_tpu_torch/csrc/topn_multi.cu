// K7 topn_multi: the first k rows of a multi-key TopN, by radix select.
//
// Replaces the kernel of tidb_tpu/copr/tpu_engine.py:1796-1835
// (TPUEngine._lower_topn_multi): the reference writes the sort operands
// of every row (the masked flag, then per key its NULL flag and its
// value), sorts every row by them with lex_sort_perm and keeps the first
// n row ids with their mask bits. Here no operand array is written and
// no row is sorted but the few that can be among the first k.
//
// The rows' order is lexicographic over the words of a composite key,
// most significant first (NW = 2 * nkeys + 1 words):
//
//   word 0        (mask ? 0 : 2) | null_0          (4 classes)
//   word 2j       null_j, j >= 1                   (2 classes)
//   word 2j + 1   key j's value: valid ? d : 0, then ~x (an integer) or
//                 -x (a float) for DESC, then K8's order-preserving key
//                 (csrc/sort_key.cuh: lax.sort's float fold)
//   word NW - 1   the row id
//   null_j = DESC ? !valid : valid (NULLs first ASC, last DESC)
//
// which is the reference's operand order, ties broken by the row id as
// the stable sort breaks them. Every composite value is distinct, so
// exactly k rows lie at or below the k-th smallest: the select needs no
// tie rule, and its k rows in order are lex_sort_perm's first k, bit for
// bit, the masked rows that fill them included.
//
// select_kernel, one persistent (cooperative) launch for every task of a
// call, runs passes over a task's candidates — its rows equal to the
// threshold on every bit fixed so far — each followed by a pick:
//
//   class pass   at a flag word (word 0, null_j): counts the candidates
//                of each class and takes the OR / AND of the next word
//                (key j's value) per class; the pick fixes the class
//                holding the k-th row and keeps its OR / AND, so a value
//                word's varying bits are known over its own candidates
//                only: a pass over every row reads the mask and the first
//                key's lanes, not every key's;
//   digit pass   at a value word or the row id: a histogram of up to 8
//                bits, from the top varying bit down (constant bits are
//                never visited); the pick fixes the digit holding the
//                k-th row;
//   collect      once the candidates and the rows already below the
//                threshold number at most the endgame size (`etrig`), or
//                every remaining candidate is needed: every one of them
//                is output.
//
// A pass classifies each candidate against the digit (or class) fixed by
// the pick before it: below it, the row is one of the k (it goes to the
// output, a warp-aggregated slot); equal, it stays a candidate; above, it
// drops. Candidates are read from every row, their words recomputed from
// the lanes in registers (only the words the pass needs), until they fit
// a compact buffer of width / 8 row ids; after that the passes and the
// collect read only the buffer. A digit pass over every row that may not
// write the buffer yet speculates: each warp buffers its candidates at
// its smallest digit when that is no larger than the smallest its block
// has seen. When the pick's digit is the smallest digit of all (k small
// beside a bucket, the usual case) every candidate of the next pass is in
// that buffer, and the next pass reads it instead of every row; else the
// buffer is dropped. The pick is made by the block that
// arrives last at the task's barrier (a ticket); the others wait on the
// task's generation word, so a task's passes run back to back within the
// launch and tasks do not wait on each other. No host read, no array of
// every row written.
//
// order_kernel (k up to order_cap(nkeys): shared memory), one block a
// task, sorts the collected rows (at most the endgame size) by their
// composite keys in shared memory (a bitonic sort) and writes the first k
// row ids and their mask bits in order. Above the cap, keys_kernel writes
// the k rows unordered with their words, and the wrapper orders them with
// K8 (kernels/topn_multi.py).
//
// Task grid: the solo TopN is a grid of one task, K10's multi-key TopN
// (tidb_tpu/copr/tpu_engine.py:1096-1134 vmapping the kernel above over a
// launch group) one of G tasks, each through its row of the task table
// (its mask and its keys' data and valid lanes, read to the group's
// `width`), with its own state row. The table travels by value in the
// launch parameters when it fits (kParamWords words), else from device
// memory.
//
// Bound: bytes. The function reads the mask and every key's data and
// valid lanes once and writes k row ids and mask bits. The select reads
// the mask and the first key's lanes once per pass while the candidates
// are many — on TPC-H's multi-key TopN two passes (the class pass and a
// speculating digit pass of the price) — then a buffer of their row ids;
// later keys are read only at the candidates, unless every row ties on
// the first keys. A pass over every row is bound by the loads in flight:
// a thread loads kRows rows' key-0 inputs at once, 4 blocks an SM (more
// rows a thread cost registers and blocks, and ran slower on the card).
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "sort_key.cuh"

namespace {

using u64 = unsigned long long;
using u32 = unsigned int;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;        // select_kernel blocks an SM (launch bounds)
constexpr int kRows = 2;             // rows a thread loads at once
constexpr int kRowsPerBlock = kThreads * kRows;  // rows a select block takes a round
constexpr int kOrderThreads = 1024;
constexpr int kOrderCap = 4096;            // largest k ordered in the kernel
constexpr int kOrderSmem = 200 * 1024;     // shared memory the ordering may take
constexpr int kEndgame = 1024;             // rows the select may leave to the ordering
constexpr int kParamWords = 440;           // table words passed by value
constexpr long long kSpinLimit = 1LL << 26;  // a wait past this traps (about 4 s)

// State (u64 [S_LEN] a task). BAR / GEN: the task's barrier (arrivals,
// generation). The pick writes the next pass's view: PHASE (0 select, 1
// collect), SRC (-1 every row, 0 / 1 that buffer; BUFN0 / BUFN1 their
// counts), PW / PMASK / PVAL (the word, bits and threshold bits fixed by
// the last pick, which the next pass classifies by; PW -1: none), CW /
// CTOP / VARY (the word of the next pass, its next digit's top bit, the
// word's varying bits), REM (rows still needed), NCAND (candidates). OUT
// counts the rows output, NOUT their total after the collect. CNT / OR /
// NAND: a class pass's count, OR and NOT-AND per class; HIST a digit
// pass's. BAR, OUT, BUFN*, CNT, OR, NAND and HIST are zero between calls
// (the scratch is zeroed once; each call leaves them at zero, and a
// task's row lies at the same place whatever the call's keys and tasks);
// every other word is written by a pick before it is read. T and KNOWN
// per word (the threshold bits fixed so far, and which of them earlier
// passes have classified by) live in the call's own buffer `tk`.
enum {
  S_BAR = 0, S_GEN, S_PHASE, S_SRC, S_BUFN0, S_BUFN1, S_OUT, S_NOUT, S_PW, S_PMASK, S_PVAL, S_CW, S_CTOP, S_VARY,
  S_REM, S_NCAND, S_CNT = 16, S_OR = 20, S_NAND = 24, S_HIST = 32, S_LEN = S_HIST + 256
};

struct Args {
  const long long* table;  // the table in device memory, or null: `words`
  u64* state;              // [G, S_LEN]
  u64* tk;                 // [G, 2 * nw]: T, KNOWN per word
  u32* out;                // [G, oc]: the rows output
  u32* buf;                // [2, G, bcap]: the candidate buffers
  int64_t width, k, oc, bcap;
  int G, g0, nk, etrig;    // etrig 0: no endgame (k above the ordering cap)
  // nk key descriptors (kind | desc << 8), then G rows of 1 + 2 * nk
  // addresses: the mask, then per key its data and valid lanes (0: every
  // row valid)
  long long words[kParamWords];
};

// The XOR that takes a key's bits (zeroed under NULL) to its value word:
// for an integer DESC's ~x and K8's sign flip in one; for a float DESC's
// -x, K8's fold following (module note).
__device__ __forceinline__ u64 flip_of(long long kd) {
  const int kind = (int)(kd & 0xff);
  const bool desc = (kd >> 8) & 1;
  if (kind == sort_key::K_F64) return desc ? sort_key::kSign : 0ULL;
  const u64 neg = desc ? (kind == sort_key::K_I32 ? 0xffffffffULL : ~0ULL) : 0ULL;
  return neg ^ (kind == sort_key::K_I32 ? 0x80000000ULL : kind == sort_key::K_I64 ? sort_key::kSign : 0ULL);
}

// A task's lanes: key 0's (read by every pass over every row) in
// registers, every key's through the table row.
struct Task {
  const uint8_t* mask;
  const void* d0;
  const uint8_t* v0;
  u64 flip0;
  int kind0;
  bool desc0;
  const long long* lanes;  // the task's table row
  const long long* kd;     // the key descriptors
  int nk;
};

__device__ __forceinline__ Task task_at(const long long* row, const long long* kd, int nk) {
  return {(const uint8_t*)row[0], (const void*)row[1], (const uint8_t*)row[2], flip_of(kd[0]), (int)(kd[0] & 0xff),
          ((kd[0] >> 8) & 1) != 0, row, kd, nk};
}

// Task y's row of the table and the key descriptors, where the call put them.
__device__ __forceinline__ const long long* table_of(const Args& a) { return a.table ? a.table : a.words; }

__device__ __forceinline__ Task task_of(const Args& a, int y) {
  const long long* tab = table_of(a);
  return task_at(tab + a.nk + (int64_t)y * (1 + 2 * a.nk), tab, a.nk);
}

// A key's value word from its bits (module note).
__device__ __forceinline__ u64 value_word(int kind, u64 flip, bool v, u64 bits) {
  const u64 x = (v ? bits : 0ULL) ^ flip;
  return kind == sort_key::K_F64 ? sort_key::of_f64(__longlong_as_double((long long)x)) : x;
}

// A key's NULL flag word (word 0 also holds the masked flag).
__device__ __forceinline__ u64 flag_word(bool desc, int j, bool v, bool m) {
  const u64 nul = (v != desc) ? 1ULL : 0ULL;
  return j == 0 ? ((m ? 0ULL : 2ULL) | nul) : nul;
}

// Word w of row r of the task (module note).
__device__ __forceinline__ u64 word_of(const Task& T, int w, int64_t r) {
  const int j = w >> 1;
  if (j == T.nk) return (u64)r;
  if (j == 0) {
    const bool v = T.v0 == nullptr || T.v0[r] != 0;
    if ((w & 1) == 0) return flag_word(T.desc0, 0, v, T.mask[r] != 0);
    return value_word(T.kind0, T.flip0, v, sort_key::load_bits(T.d0, T.kind0, r));
  }
  const long long kd = T.kd[j];
  const uint8_t* valid = (const uint8_t*)T.lanes[2 + 2 * j];
  const bool v = valid == nullptr || valid[r] != 0;
  if ((w & 1) == 0) return flag_word(((kd >> 8) & 1) != 0, j, v, false);
  const int kind = (int)(kd & 0xff);
  return value_word(kind, flip_of(kd), v, sort_key::load_bits((const void*)T.lanes[1 + 2 * j], kind, r));
}

// A row's inputs to words 0 and 1 (the mask, key 0's valid flag and bits),
// loaded ahead for the passes that read them: a thread's kRows rows' loads
// are in flight together.
struct Pre {
  u64 d;
  bool m, v;
};

__device__ __forceinline__ Pre prefetch(const Task& T, int r) {
  Pre p;
  p.m = T.mask[r] != 0;
  p.v = T.v0 == nullptr || T.v0[r] != 0;
  p.d = sort_key::load_bits(T.d0, T.kind0, r);
  return p;
}

// One round's rows (-1 past the source's end) from every row or a
// buffer, and, with `pre`, their inputs to words 0 and 1.
__device__ __forceinline__ void fetch_round(const Task& T, int64_t i0, int64_t len, bool every, const u32* sb,
                                            bool pre, int (&rows)[kRows], Pre (&pf)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t i = i0 + q * kThreads + threadIdx.x;
    rows[q] = i < len ? (every ? (int)i : (int)__ldcg(sb + i)) : -1;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) pf[q] = pre && rows[q] >= 0 ? prefetch(T, rows[q]) : Pre{0ULL, false, false};
}

__device__ __forceinline__ int msb(u64 x) { return 63 - __clzll((long long)x); }
__device__ __forceinline__ int lsb(u64 x) { return __ffsll((long long)x) - 1; }

// What every block of a task reads before a pass (the state's view).
struct View {
  int phase, src, pw, cw, ctop;
  int64_t len, rem, ncand;
  u64 pmask, pval, vary;
};

// 1: one of the k (below the threshold at the pend bits), 0: still a
// candidate, -1: not (above it, or off the bits classified earlier:
// checked only when the candidates are every row; a buffer holds only
// rows equal on them). x0 / x1: the row's words 0 and 1 when `pre`.
__device__ __forceinline__ int classify(const Task& T, const View& v, const u64* tk, bool every, int row, u64 x0,
                                        u64 x1, bool pre) {
  for (int w = 0; w <= v.pw; ++w) {  // the known bits all lie at or before the pend word
    const u64 kn = every ? tk[2 * w + 1] : 0ULL;
    if (w < v.pw && kn == 0ULL) continue;
    const u64 x = (pre && w == 0) ? x0 : (pre && w == 1) ? x1 : word_of(T, w, row);
    if ((x ^ tk[2 * w]) & kn) return -1;
    if (w == v.pw) {
      const u64 p = x & v.pmask;
      return p < v.pval ? 1 : (p == v.pval ? 0 : -1);
    }
  }
  return 0;  // nothing fixed yet
}

// classify while the pend word is word 0 or 1 (the passes over every row
// at key 0): from the row's two words and the pass's threshold words
// t0 / k0 / t1 / k1 (T, KNOWN), with no loop.
__device__ __forceinline__ int classify01(const View& v, bool every, u64 t0, u64 k0, u64 t1, u64 k1, u64 x0,
                                          u64 x1) {
  if (v.pw < 0) return 0;
  if (every && (((x0 ^ t0) & k0) | ((x1 ^ t1) & k1))) return -1;
  const u64 p = (v.pw == 0 ? x0 : x1) & v.pmask;
  return p < v.pval ? 1 : (p == v.pval ? 0 : -1);
}

// A slot of `ctr` for every lane that wants one, one atomic a warp (every
// lane of the warp calls it); -1 for the others.
__device__ __forceinline__ int64_t warp_slot(bool want, u64* ctr) {
  const unsigned b = __ballot_sync(kFull, want);
  if (b == 0u) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(b) - 1;
  u64 base = 0ULL;
  if (lane == leader) base = atomicAdd(ctr, (u64)__popc(b));
  base = __shfl_sync(kFull, base, leader);
  return want ? (int64_t)(base + (u64)__popc(b & ((1u << lane) - 1u))) : -1;
}

__device__ __forceinline__ void red_release(u64* p) {  // *p += 1, after every earlier write
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 x;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  return x;
}

// Inclusive scan of one u64 per thread over a kThreads block.
__device__ __forceinline__ u64 block_incl_scan(u64 x, u64* ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  u64 v = x;
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) ws[w] = v;
  __syncthreads();
  u64 before = 0ULL;
  for (int q = 0; q < w; ++q) before += ws[q];
  __syncthreads();
  return before + v;
}

// The word after `cw` as the next pass's: a flag word (a class pass), or
// the row id with the bits that vary below `width`.
__device__ __forceinline__ void next_word(View& n, int cw, int nw, int64_t width) {
  n.cw = cw + 1;
  n.vary = 0ULL;
  n.ctop = -1;
  if (n.cw == nw - 1 && width > 1) {
    n.vary = (~0ULL) >> __clzll((long long)(width - 1));
    n.ctop = msb(n.vary);
  }
}

// One task's select (module note), every block of the task.
__global__ void __launch_bounds__(kThreads, kMinBlocks) select_kernel(const __grid_constant__ Args a) {
  extern __shared__ u64 s_tk[];  // T, KNOWN per word (2 * nw), then the task's table row and key descriptors
  __shared__ u32 h[256];
  __shared__ u64 s_cls[kWarps][3][4];  // per warp: count, OR, NOT-AND per class
  __shared__ u64 ws[kWarps];
  __shared__ View s_v;
  __shared__ int s_last;
  __shared__ u64 s_gen;
  __shared__ u32 s_min;  // a speculating pass: the smallest digit the block has seen; the pick: the smallest bucket
  const int y = a.g0 + blockIdx.y, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nw = 2 * a.nk + 1;
  u64* st = a.state + (int64_t)y * S_LEN;
  u64* tw = a.tk + (int64_t)y * 2 * nw;
  long long* s_tab = (long long*)(s_tk + 2 * nw);  // the row (1 + 2 * nk), then nk descriptors
  {
    const long long* tab = table_of(a);
    for (int i = t; i < 1 + 2 * a.nk; i += kThreads) s_tab[i] = tab[a.nk + (int64_t)y * (1 + 2 * a.nk) + i];
    for (int i = t; i < a.nk; i += kThreads) s_tab[1 + 2 * a.nk + i] = tab[i];
  }
  __syncthreads();
  const Task T = task_at(s_tab, s_tab + 1 + 2 * a.nk, a.nk);
  u32* out = a.out + (int64_t)y * a.oc;
  // the first pass: a class pass of word 0 over every row, nothing fixed
  View v;
  v.src = -1;
  v.len = a.width;
  v.pw = -1;
  v.pmask = v.pval = 0ULL;
  v.cw = 0;
  v.ctop = -1;
  v.vary = 0ULL;
  v.rem = a.k;
  v.ncand = a.width;
  v.phase = (a.k == a.width || (a.etrig && a.width <= a.etrig)) ? 1 : 0;
  for (int i = t; i < 2 * nw; i += kThreads) s_tk[i] = 0ULL;
  __syncthreads();
  // each pick fixes a class or at least one bit: a longer walk is a fault
  for (int pass = 0;; ++pass) {
    if (pass > 9 * nw + 4) __trap();
    const bool every = v.src < 0, collect = v.phase == 1;
    const bool cls = !collect && (v.cw & 1) == 0 && v.cw < nw - 1;
    const bool write = !collect && (!every || v.ncand <= a.bcap);
    // a digit pass over every row that does not write the buffer writes the
    // candidates at the smallest digit seen so far: when the pick's digit is
    // the smallest one, the next pass reads them and not every row
    const bool spec = !collect && !cls && every && !write;
    const int dst = v.src == 0 ? 1 : 0;
    const u32* sb = a.buf + ((int64_t)(every ? 0 : v.src) * a.G + y) * a.bcap;
    u32* wb = a.buf + ((int64_t)dst * a.G + y) * a.bcap;
    const int dlo = (!collect && !cls) ? max(v.ctop - 7, lsb(v.vary)) : 0;
    const u64 dm = (!collect && !cls) ? (2ULL << (v.ctop - dlo)) - 1ULL : 0ULL;
    // the pass reads words 0 and 1 (prefetched) when it fixes or compares them
    const bool pre = (v.pw >= 0 && v.pw <= 1) || (!collect && v.cw <= 1) ||
                     (every && (s_tk[1] != 0ULL || s_tk[3] != 0ULL));
    const bool fast = pre && v.pw <= 1;
    const u64 t0 = s_tk[0], k0 = s_tk[1], t1 = s_tk[2], k1 = s_tk[3];
    h[t] = 0u;
    if (t == 0) s_min = 256u;
    u32 cnt[4] = {0u, 0u, 0u, 0u};
    u64 orv[4] = {0ULL, 0ULL, 0ULL, 0ULL}, nand[4] = {0ULL, 0ULL, 0ULL, 0ULL};
    __syncthreads();
    // i0 is the same for the whole block: every lane takes part in each
    // round's warp intrinsics
    for (int64_t i0 = (int64_t)blockIdx.x * kRowsPerBlock; i0 < v.len; i0 += (int64_t)gridDim.x * kRowsPerBlock) {
      int rows[kRows];
      Pre pf[kRows];
      fetch_round(T, i0, v.len, every, sb, pre, rows, pf);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int row = rows[q] < 0 ? 0 : rows[q];
        const u64 x0 = pre ? flag_word(T.desc0, 0, pf[q].v, pf[q].m) : 0ULL;
        const u64 x1 = pre ? value_word(T.kind0, T.flip0, pf[q].v, pf[q].d) : 0ULL;
        const int c = rows[q] < 0 ? -1
                      : fast      ? classify01(v, every, t0, k0, t1, k1, x0, x1)
                                  : classify(T, v, s_tk, every, row, x0, x1, pre);
        const int64_t pos = warp_slot(collect ? c >= 0 : c == 1, &st[S_OUT]);
        if (pos >= 0 && pos < a.oc) out[pos] = (u32)row;
        if (collect) continue;
        if (cls) {
          if (c == 0) {
            const u64 b = v.cw == 0 ? x0 : word_of(T, v.cw, row), x = v.cw == 0 ? x1 : word_of(T, v.cw + 1, row);
            // a warp's rows are mostly of one class: one branch runs
            if (b == 0) {
              ++cnt[0];
              orv[0] |= x;
              nand[0] |= ~x;
            } else if (b == 1) {
              ++cnt[1];
              orv[1] |= x;
              nand[1] |= ~x;
            } else if (b == 2) {
              ++cnt[2];
              orv[2] |= x;
              nand[2] |= ~x;
            } else {
              ++cnt[3];
              orv[3] |= x;
              nand[3] |= ~x;
            }
          }
        } else {
          const u64 xw = c != 0 ? 0ULL : (pre && v.cw == 1) ? x1 : word_of(T, v.cw, row);
          const u32 d = c == 0 ? (u32)((xw >> dlo) & dm) : 256u;
          // a digit the same in every candidate of the warp costs one atomic
          const unsigned in = __ballot_sync(kFull, d < 256u);
          const u32 lo = __reduce_min_sync(kFull, d), hi = __reduce_max_sync(kFull, d < 256u ? d : 0u);
          if (lo == hi) {
            if (lane == __ffs(in) - 1) atomicAdd(&h[d], (u32)__popc(in));
          } else if (d < 256u) {
            atomicAdd(&h[d], 1u);
          }
          if (spec) {  // lo: the warp's smallest digit (256: no candidate)
            const int64_t p = warp_slot(d < 256u && d <= min(lo, *(volatile u32*)&s_min), &st[S_BUFN0 + dst]);
            if (p >= 0 && p < a.bcap) wb[p] = (u32)row;
            if (lane == 0 && lo < 256u) atomicMin(&s_min, lo);
          }
        }
        if (write) {
          const int64_t p = warp_slot(c == 0, &st[S_BUFN0 + dst]);
          if (p >= 0) wb[p] = (u32)row;
        }
      }
    }
    // the block's partials
    if (cls) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u64 cq = cnt[q];
        for (int off = 16; off > 0; off >>= 1) {
          cq += __shfl_xor_sync(kFull, cq, off);
          orv[q] |= __shfl_xor_sync(kFull, orv[q], off);
          nand[q] |= __shfl_xor_sync(kFull, nand[q], off);
        }
        if (lane == 0) {
          s_cls[wid][0][q] = cq;
          s_cls[wid][1][q] = orv[q];
          s_cls[wid][2][q] = nand[q];
        }
      }
    }
    __syncthreads();
    if (cls && t < 4) {
      u64 c0 = 0ULL, o0 = 0ULL, n0 = 0ULL;
      for (int q = 0; q < kWarps; ++q) {
        c0 += s_cls[q][0][t];
        o0 |= s_cls[q][1][t];
        n0 |= s_cls[q][2][t];
      }
      if (c0) {
        atomicAdd(&st[S_CNT + t], c0);
        atomicOr(&st[S_OR + t], o0);
        atomicOr(&st[S_NAND + t], n0);
      }
    } else if (!collect && !cls && h[t] != 0u) {
      atomicAdd(&st[S_HIST + t], (u64)h[t]);
    }
    // the task's barrier: the block arriving last picks
    __threadfence();
    __syncthreads();
    if (t == 0) {
      s_gen = ld_acquire(&st[S_GEN]);  // before arriving
      s_last = atomicAdd(&st[S_BAR], 1ULL) == (u64)(gridDim.x - 1);
    }
    __syncthreads();
    if (collect) {  // the last pass: the last block closes the call's state
      if (s_last && t == 0) {
        __threadfence();
        st[S_NOUT] = atomicExch(&st[S_OUT], 0ULL);
        st[S_BUFN0] = 0ULL;
        st[S_BUFN1] = 0ULL;
        st[S_BAR] = 0ULL;
      }
      return;
    }
    if (s_last) {
      __threadfence();
      // the counts of the buckets, thread t holding bucket t
      u64 c = 0ULL;
      if (cls) {
        if (t < 4) {
          c = atomicExch(&st[S_CNT + t], 0ULL);
          s_cls[0][1][t] = atomicExch(&st[S_OR + t], 0ULL);
          s_cls[0][2][t] = atomicExch(&st[S_NAND + t], 0ULL);
        }
      } else {
        c = atomicExch(&st[S_HIST + t], 0ULL);
      }
      if (t == 0) s_min = 256u;
      __syncthreads();
      if (spec && c != 0ULL) atomicMin(&s_min, (u32)t);
      const u64 incl = block_incl_scan(c, ws);
      const u64 excl = incl - c;
      const u64 rem = (u64)v.rem;
      if (excl < rem && rem <= incl) {  // exactly one bucket holds the k-th row
        View n;
        const u64 b = (u64)t;
        if (v.pw >= 0) s_tk[2 * v.pw + 1] |= v.pmask;
        if (cls) {
          s_tk[2 * v.cw] = b;
          n.pw = v.cw;
          n.pmask = v.cw == 0 ? 3ULL : 1ULL;
          n.pval = b;
          const u64 vary = s_cls[0][1][t] ^ ~s_cls[0][2][t];
          if (vary) {
            n.cw = v.cw + 1;
            n.vary = vary;
            n.ctop = msb(vary);
          } else {
            next_word(n, v.cw + 1, nw, a.width);
          }
        } else {
          s_tk[2 * v.cw] |= b << dlo;
          n.pw = v.cw;
          n.pmask = dm << dlo;
          n.pval = b << dlo;
          const u64 rest = v.vary & ((1ULL << dlo) - 1ULL);
          if (rest) {
            n.cw = v.cw;
            n.vary = v.vary;
            n.ctop = msb(rest);
          } else {
            next_word(n, v.cw, nw, a.width);
          }
        }
        n.rem = (int64_t)(rem - excl);
        n.ncand = (int64_t)c;
        // the speculation holds when the k-th row's digit is the smallest one
        // and the buffer did not overflow
        const bool held = spec && t == (int)s_min && __ldcg(&st[S_BUFN0 + dst]) <= (u64)a.bcap;
        n.src = write || held ? dst : v.src;
        n.phase = (n.ncand == n.rem || (a.etrig && (a.k - n.rem) + n.ncand <= a.etrig)) ? 1 : 0;
        st[S_PHASE] = (u64)n.phase;
        st[S_SRC] = (u64)(long long)n.src;
        st[S_PW] = (u64)n.pw;
        st[S_PMASK] = n.pmask;
        st[S_PVAL] = n.pval;
        st[S_CW] = (u64)n.cw;
        st[S_CTOP] = (u64)(long long)n.ctop;
        st[S_VARY] = n.vary;
        st[S_REM] = (u64)n.rem;
        st[S_NCAND] = (u64)n.ncand;
        if (write || held)
          st[S_BUFN0 + (1 - dst)] = 0ULL;  // the next pass writes there
        else if (spec)
          st[S_BUFN0 + dst] = 0ULL;  // the speculation missed: its rows are dropped
      }
      __syncthreads();
      for (int i = t; i < 2 * nw; i += kThreads) tw[i] = s_tk[i];
      __threadfence();
      __syncthreads();
      if (t == 0) {
        st[S_BAR] = 0ULL;
        red_release(&st[S_GEN]);
      }
    } else if (t == 0) {
      long long spins = 0;
      while (ld_acquire(&st[S_GEN]) == s_gen) {
        __nanosleep(64);
        if (++spins > kSpinLimit) __trap();
      }
    }
    __syncthreads();
    // the next pass's view, as the pick left it
    if (t == 0) {
      View n;
      n.phase = (int)__ldcg(&st[S_PHASE]);
      n.src = (int)(long long)__ldcg(&st[S_SRC]);
      n.pw = (int)(long long)__ldcg(&st[S_PW]);
      n.pmask = __ldcg(&st[S_PMASK]);
      n.pval = __ldcg(&st[S_PVAL]);
      n.cw = (int)__ldcg(&st[S_CW]);
      n.ctop = (int)(long long)__ldcg(&st[S_CTOP]);
      n.vary = __ldcg(&st[S_VARY]);
      n.rem = (int64_t)__ldcg(&st[S_REM]);
      n.ncand = (int64_t)__ldcg(&st[S_NCAND]);
      n.len = n.src < 0 ? a.width : (int64_t)__ldcg(&st[S_BUFN0 + n.src]);
      s_v = n;
    }
    for (int i = t; i < 2 * nw; i += kThreads) s_tk[i] = __ldcg(&tw[i]);
    __syncthreads();
    v = s_v;
    __syncthreads();  // s_v is rewritten after the next pass
  }
}

// The composite key's flag bits of a row, packed for the ordering: word 0
// in bits 0-1, null_j (j >= 1) in bit j + 1.
__device__ __forceinline__ u32 flag_bits(const Task& T, int64_t r) {
  u32 f = (u32)word_of(T, 0, r);
  for (int j = 1; j < T.nk; ++j) f |= (u32)word_of(T, 2 * j, r) << (j + 1);
  return f;
}

// Task blockIdx.x's collected rows in the composite order, its first k
// written: idx (int64 [G, k], task-local row ids) and ok (their mask
// bits). Shared memory: per slot its key values (u64 [nk]), flag bits,
// row id and the sort's index.
__global__ void __launch_bounds__(kOrderThreads) order_kernel(const __grid_constant__ Args a, int64_t* idx,
                                                             uint8_t* ok) {
  extern __shared__ unsigned char smem[];
  const int y = a.g0 + blockIdx.x, nk = a.nk;
  const Task T = task_of(a, y);
  const int64_t n = (int64_t)__ldcg(&a.state[(int64_t)y * S_LEN + S_NOUT]);
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  u64* vals = (u64*)smem;                  // [nk][p2]
  u32* flg = (u32*)(vals + (int64_t)nk * p2);  // [p2]
  u32* rws = flg + p2;                     // [p2]
  uint16_t* ix = (uint16_t*)(rws + p2);    // [p2]
  const u32* out = a.out + (int64_t)y * a.oc;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    ix[i] = (uint16_t)i;
    if (i < n) {
      const int64_t r = (int64_t)__ldcg(out + i);
      rws[i] = (u32)r;
      flg[i] = flag_bits(T, r);
      for (int j = 0; j < nk; ++j) vals[(int64_t)j * p2 + i] = word_of(T, 2 * j + 1, r);
    } else {  // the pads sort last
      rws[i] = 0xffffffffu;
      flg[i] = 0xffffffffu;
      for (int j = 0; j < nk; ++j) vals[(int64_t)j * p2 + i] = ~0ULL;
    }
  }
  __syncthreads();
  // p before q in the composite order?
  auto less = [&](int p, int q) {
    const u32 f = flg[p], g = flg[q];
    for (int j = 0; j < nk; ++j) {
      const u32 fw = j == 0 ? (f & 3u) : ((f >> (j + 1)) & 1u), gw = j == 0 ? (g & 3u) : ((g >> (j + 1)) & 1u);
      if (fw != gw) return fw < gw;
      const u64 x = vals[(int64_t)j * p2 + p], z = vals[(int64_t)j * p2 + q];
      if (x != z) return x < z;
    }
    return rws[p] < rws[q];
  };
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        if (less(ix[hi], ix[lo]) == up) {
          const uint16_t tmp = ix[lo];
          ix[lo] = ix[hi];
          ix[hi] = tmp;
        }
      }
      __syncthreads();
    }
  }
  const uint8_t* mask = (const uint8_t*)T.lanes[0];
  for (int64_t i = threadIdx.x; i < a.k; i += blockDim.x) {
    const u32 r = rws[ix[i]];
    idx[(int64_t)y * a.k + i] = (int64_t)r;
    ok[(int64_t)y * a.k + i] = mask[r];
  }
}

// Above the ordering cap: task blockIdx.y's k rows unordered, with their
// words for K8 (keys: u64 [nw, G * k]).
__global__ void __launch_bounds__(kThreads) keys_kernel(const __grid_constant__ Args a, int64_t* idx, uint8_t* ok,
                                                        u64* keys) {
  const int y = a.g0 + blockIdx.y, nw = 2 * a.nk + 1;
  const Task T = task_of(a, y);
  const u32* out = a.out + (int64_t)y * a.oc;
  const uint8_t* mask = (const uint8_t*)T.lanes[0];
  const int64_t stride = (int64_t)a.G * a.k;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.k; i += (int64_t)gridDim.x * kThreads) {
    const int64_t r = (int64_t)__ldcg(out + i), o = (int64_t)y * a.k + i;
    idx[o] = r;
    ok[o] = mask[r];
    for (int w = 0; w < nw; ++w) keys[w * stride + o] = word_of(T, w, r);
  }
}

__host__ __device__ constexpr int order_bytes(int nk) { return 8 * nk + 10; }

int order_cap(int nk) {
  if (nk < 1 || nk > 31) return 0;  // the flag bits of every key in one u32
  int cap = kOrderCap;
  while (cap > 0 && (int64_t)cap * order_bytes(nk) > kOrderSmem) cap >>= 1;
  return cap;
}

// The select's endgame size (rows it may leave to the ordering; 0 when K8
// orders them) and the output slots a task needs for k rows of nk keys.
struct Endgame {
  int etrig;
  int64_t oc;
};

Endgame endgame(int64_t k, int nk, int ordered) {
  const int cap = order_cap(nk);
  const int etrig = ordered ? (int)(k > kEndgame ? k : (kEndgame < cap ? kEndgame : cap)) : 0;
  return {etrig, ordered ? (k > etrig ? k : etrig) : k};
}

// Once per card: order_kernel's largest dynamic shared memory, and how
// many select blocks an SM holds (at the shared memory of up to 31 keys).
struct CardInfo {
  int occ;
  int err;
};

CardInfo card_info() {
  static std::atomic<int> occ_of[32];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return {0, err};
  if (dev < 32 && occ_of[dev].load() > 0) return {occ_of[dev].load(), 0};
  err = (int)cudaFuncSetAttribute(order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOrderSmem);
  if (err != 0) return {0, err};
  int occ = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, select_kernel, kThreads,
                                                             16 * (2 * 31 + 1) + 8 * (1 + 3 * 31));
  if (err != 0 || occ < 1) return {0, err != 0 ? err : -1};
  if (dev < 32) occ_of[dev].store(occ);
  return {occ, 0};
}

}  // namespace

// Int64 slots of the `state` scratch, per task.
extern "C" int64_t tt_topn_multi_state_len() { return S_LEN; }

// Table words passed by value at most.
extern "C" int tt_topn_multi_param_words() { return kParamWords; }

// The largest k whose rows the kernel orders itself for nk keys (0: none;
// above it K8 orders them).
extern "C" int tt_topn_multi_order_cap(int nk) { return order_cap(nk); }

// The slots of `out` a task needs: tt_topn_multi's oc.
extern "C" int64_t tt_topn_multi_out_cap(int64_t k, int nk, int ordered) { return endgame(k, nk, ordered).oc; }

// G tasks' first k rows of `width` (1 <= k <= width): the table (nwords
// int64: the key descriptors, then the task rows; by value from the host
// array `host_words` when nwords <= kParamWords, else read from
// `dev_table`). ordered (k <= order_cap(nk)): idx (int64 [G, k]) and ok
// (bool [G, k]) in the composite order; else unordered, with their words
// in keys (u64 [2 * nk + 1, G * k]) for K8. state: u64 [G, S_LEN]
// (zeroed when allocated, left as the kernel needs it); tk: u64 [G, 2 *
// (2 * nk + 1)]; out: uint32 [G, oc], oc = max(k, etrig); buf: uint32 [2,
// G, (width + 7) / 8].
extern "C" int tt_topn_multi(const long long* host_words, int nwords, const void* dev_table, int G, int nk,
                             int64_t width, int64_t k, int ordered, u64* state, u64* tk, u32* out, u32* buf,
                             int64_t* idx, uint8_t* ok, u64* keys, int n_sms, void* stream) {
  if (G < 1 || G > 65535 || nk < 1 || width < 1 || width > 0x7fffffffLL || k < 1 || k > width ||
      nwords != nk + G * (1 + 2 * nk) || (ordered && k > order_cap(nk)) || (!ordered && keys == nullptr) ||
      (nwords > kParamWords && dev_table == nullptr))
    return -1;
  const CardInfo ci = card_info();
  if (ci.err != 0) return ci.err;
  cudaStream_t s = (cudaStream_t)stream;
  static_assert(sizeof(Args) <= 4000, "Args must fit the kernel parameters");
  Args a;
  a.table = nwords > kParamWords ? (const long long*)dev_table : nullptr;
  if (a.table == nullptr) memcpy(a.words, host_words, sizeof(long long) * nwords);
  a.state = state;
  a.tk = tk;
  a.out = out;
  a.buf = buf;
  a.width = width;
  a.k = k;
  const Endgame e = endgame(k, nk, ordered);
  a.etrig = e.etrig;
  a.oc = e.oc;
  a.bcap = (width + 7) / 8;
  a.G = G;
  a.nk = nk;
  const int nw = 2 * nk + 1;
  const size_t tk_smem = (size_t)16 * nw + (size_t)8 * (1 + 3 * nk);
  int occ = ci.occ;
  if (nk > 31) {  // more shared memory than the cached occupancy assumed
    int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, select_kernel, kThreads, tk_smem);
    if (err != 0 || occ < 1) return err != 0 ? err : -1;
  }
  const int64_t resident = (int64_t)occ * (n_sms > 0 ? n_sms : 132);
  const int gc = (int)(G < resident ? G : resident);  // tasks a launch holds
  for (int g0 = 0; g0 < G; g0 += gc) {
    const int gy = G - g0 < gc ? G - g0 : gc;
    int64_t nb = (width + kRowsPerBlock - 1) / kRowsPerBlock;
    if (nb > resident / gy) nb = resident / gy;
    if (nb < 1) nb = 1;
    a.g0 = g0;
    void* params[] = {(void*)&a};
    int err = (int)cudaLaunchCooperativeKernel((const void*)select_kernel, dim3((unsigned)nb, (unsigned)gy),
                                               dim3(kThreads), params, tk_smem, s);
    if (err != 0) return err;
    if (ordered) {
      int p2 = 1;
      while (p2 < a.oc) p2 <<= 1;
      order_kernel<<<gy, kOrderThreads, (size_t)p2 * order_bytes(nk), s>>>(a, idx, ok);
    } else {
      int64_t kb = (k + kThreads - 1) / kThreads;
      if (kb > 1024) kb = 1024;
      keys_kernel<<<dim3((unsigned)kb, (unsigned)gy), kThreads, 0, s>>>(a, idx, ok, keys);
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}
