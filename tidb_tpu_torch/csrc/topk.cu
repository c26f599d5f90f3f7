// K6 topk: the k best rows of a single-key TopN, by radix select.
//
// Replaces the kernel of tidb_tpu/copr/tpu_engine.py:1759-1781
// (TPUEngine._lower_topn): the reference builds an int64 (or float64)
// sort key from the row mask, the key's validity and its data, and asks
// lax.top_k for the k largest. Here, with u the key's order-preserving
// unsigned form:
//
//   key    int:   DESC  (m && v) ? d : INT64_MIN
//                 ASC   m ? (v ? -d : INT64_MAX - 1) : INT64_MIN
//                 (-d wraps: -INT64_MIN is INT64_MIN, the masked rows' lo)
//          float: DESC  (m && v) ? d : -inf
//                 ASC   m ? (v ? -d : +inf) : -inf
//   u      int:   key ^ 2^63
//          float: the IEEE total order of the bits, which is lax.top_k's
//                 order on the CPU: -NaN < -inf < ... < -0.0 < +0.0 <
//                 ... < +inf < +NaN (no folding of -0.0, unlike lax.sort)
//
// lax.top_k's order is (u desc, row asc). The select works on the 96-bit
// key (u, ~row), whose descending order is exactly that and whose values
// are all distinct, so the k best rows are exactly the rows whose key is
// at least the k-th largest: no tie needs a second rule.
//
//   1. topk_init, topk_orand: per task, the OR / AND of u over its rows
//      (the bits that vary), u computed in registers from the key, valid
//      and mask lanes (no array of u is written), and the histogram of
//      u's top digit, which the first pass then needs not read;
//   2. one topk_pass per 8-bit digit, most significant first: the 8
//      digits of u (a digit constant within the task returns at once, on
//      the device) and the digits of ~row that vary below `width`. A pass
//      reads the task's candidates: every row (u recomputed) until they
//      are few, then a compact buffer of (u, row) pairs. It classifies
//      each against the threshold digits fixed so far: a candidate whose
//      digit just fixed is above the threshold's is one of the k (it goes
//      to the output, a warp-aggregated slot), one equal to it stays a
//      candidate (histogrammed at this pass's digit and, once the
//      candidates fit the buffer, written to it), one below drops. The
//      block that finishes last (a ticket counter) picks the digit that
//      holds the k-th largest key and keeps how many candidates are still
//      needed: hist and pick in one launch. When every remaining candidate
//      is needed, the task is done and later passes return at once;
//   3. topk_collect: the candidates still standing go to the output;
//   4. topk_order (k <= kOrderCap): one block a task sorts its k (u, row)
//      pairs by (u desc, row asc) in shared memory (a bitonic sort) and
//      writes the row ids and their mask bits in lax.top_k's order. Above
//      the cap the output stays unordered with its u, and the wrapper
//      orders it with K8 (kernels/topk.py).
//
// Every kernel runs over a task grid: the solo TopN is a grid of one
// task, and K10's task-grid mode (tidb_tpu/copr/tpu_engine.py:1096-1134
// vmapping the kernel above over a launch group) one of G tasks. One radix
// select per task, the task on the grid's y axis (x for the one-block
// kernels), each through its row of a task table (its key, valid and mask
// lanes, read to the group's `width`), with its own state row: its own OR
// / AND, threshold, candidate source and counters.
//
// Bound: bytes. The key's 8 bytes and two 1-byte flags are read once and
// k row ids and mask bits written. The kernel reads the lanes once for the
// OR / AND and once per pass while the candidates are many; once they fit
// the buffer (width / 8 pairs) the passes and the collect read only the
// buffer. TPC-H's extendedprice key over a padded tile varies in the top
// digit (masked rows, counted with the OR / AND) and three low ones: three
// reads of the lanes, then the buffer.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using u64 = unsigned long long;
using u32 = unsigned int;

constexpr u64 kSign = 0x8000000000000000ULL;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOrderThreads = 1024;
constexpr int kOrderCap = 4096;  // largest k ordered in the kernel: 48 KB of (u, row) pairs

// State (u64 [S_LEN] a task). Digits are numbered 11..0 over (u, r), r =
// ~row: 11..4 are u's bytes (shift 8 * (dig - 4)), 3..0 r's. PRE_* hold
// the threshold's digits fixed so far, KNOWN_* the mask of those whose
// candidates are already classified; PEND the digit fixed last (its
// candidates are classified by the next kernel), or -1. NCAND candidates
// are still standing (the rows equal to the threshold on every fixed
// digit), REM of them are still needed; DONE when NCAND == REM. SRC: -1 =
// every row, 0 / 1 = that buffer, BUFN0 / BUFN1 its count. OUT counts the
// rows output, TICKET the blocks of a pass that are done.
enum {
  S_OR = 0, S_AND, S_PRE_U, S_PRE_R, S_KNOWN_U, S_KNOWN_R, S_PEND, S_REM, S_NCAND, S_DONE, S_SRC,
  S_BUFN0, S_BUFN1, S_OUT, S_TICKET, S_HIST = 16, S_LEN = S_HIST + 256
};

struct Lanes {  // a task's row of the task table
  const void* data;
  const uint8_t* valid;  // null: every key valid
  const uint8_t* mask;
};

__device__ __forceinline__ Lanes lanes_of(const long long* tasks, int y) {
  const long long* T = tasks + 3 * (int64_t)y;
  return {(const void*)T[0], (const uint8_t*)T[1], (const uint8_t*)T[2]};
}

__device__ __forceinline__ u64 total_order(double x) {
  const u64 b = (u64)__double_as_longlong(x);
  return (b & kSign) ? ~b : (b | kSign);
}

// u of row i (module note).
__device__ __forceinline__ u64 key_of(const Lanes& L, int is_float, int desc, int64_t i) {
  const bool m = L.mask[i] != 0;
  const bool v = L.valid == nullptr || L.valid[i] != 0;
  if (is_float) {
    const double d = ((const double*)L.data)[i];
    const double inf = __longlong_as_double(0x7ff0000000000000LL);
    double key;
    if (desc)
      key = (m && v) ? d : -inf;
    else
      key = m ? (v ? -d : inf) : -inf;
    return total_order(key);
  }
  const u64 d = (u64)((const long long*)L.data)[i];
  u64 key;  // two's complement bits of the int64 key
  if (desc)
    key = (m && v) ? d : kSign;
  else
    key = m ? (v ? (0ULL - d) : (kSign - 2ULL)) : kSign;  // kSign - 2: INT64_MAX - 1
  return key ^ kSign;
}

__device__ __forceinline__ u32 digit_of(u64 u, u32 r, int dig) {
  return dig >= 4 ? (u32)(u >> (8 * (dig - 4))) & 0xFFu : (r >> (8 * dig)) & 0xFFu;
}

// A task's threshold so far, as every block of a kernel reads it.
struct View {
  u64 known_u, want_u;  // want = PRE & KNOWN
  u32 known_r, want_r;
  int pend;
  u32 chosen;  // the threshold's digit at pend
};

__device__ __forceinline__ View view_of(const u64* st) {
  View v;
  v.known_u = st[S_KNOWN_U];
  v.want_u = st[S_PRE_U] & v.known_u;
  v.known_r = (u32)st[S_KNOWN_R];
  v.want_r = (u32)st[S_PRE_R] & v.known_r;
  v.pend = (int)(long long)st[S_PEND];
  v.chosen = v.pend >= 0 ? digit_of(st[S_PRE_U], (u32)st[S_PRE_R], v.pend) : 0u;
  return v;
}

// 1: one of the k (above the threshold at pend), 0: still a candidate,
// -1: not one (below the threshold, or classified by an earlier kernel).
__device__ __forceinline__ int classify(const View& v, u64 u, u32 r) {
  if ((u & v.known_u) != v.want_u || (r & v.known_r) != v.want_r) return -1;
  if (v.pend < 0) return 0;
  const u32 d = digit_of(u, r, v.pend);
  return d > v.chosen ? 1 : (d == v.chosen ? 0 : -1);
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

// The outputs of a task: row ids, their u, their mask bits.
struct Out {
  int32_t* cand;
  u64* candu;
  uint8_t* okc;
  int64_t k;
};

__device__ __forceinline__ void emit(bool take, u64 u, int64_t row, const Lanes& L, u64* st, const Out& o) {
  const int64_t pos = warp_slot(take, &st[S_OUT]);
  if (pos >= 0 && pos < o.k) {  // exactly k are taken; the bound only guards the outputs
    o.cand[pos] = (int32_t)row;
    o.candu[pos] = u;
    o.okc[pos] = L.mask[row];
  }
}

__global__ void topk_init(u64* state, int64_t k, int64_t width) {
  u64* st = state + (int64_t)blockIdx.x * S_LEN;
  for (int t = threadIdx.x; t < S_LEN; t += blockDim.x) st[t] = 0ULL;
  __syncthreads();
  if (threadIdx.x == 0) {
    st[S_AND] = ~0ULL;
    st[S_PEND] = (u64)-1LL;
    st[S_SRC] = (u64)-1LL;
    st[S_REM] = (u64)k;
    st[S_NCAND] = (u64)width;
    st[S_DONE] = k == width ? 1ULL : 0ULL;  // every row is one of the k
  }
}

// Also counts u's top digit (digit 11) of every row into the state's
// histogram: the first pass to run, digit 11's when it varies, then only
// picks (every row is a candidate of it); when it is constant, that pass
// clears the count.
__global__ void topk_orand(const long long* __restrict__ tasks, int is_float, int desc, int64_t width,
                           u64* state) {
  __shared__ u64 s_or[kWarps], s_and[kWarps];
  __shared__ u32 h[256];
  const Lanes L = lanes_of(tasks, blockIdx.y);
  u64* st = state + (int64_t)blockIdx.y * S_LEN;
  if (st[S_DONE]) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  h[threadIdx.x] = 0u;
  __syncthreads();
  u64 o = 0ULL, a = ~0ULL;
  // i0 is the same for the whole block: every lane takes part in each
  // round's warp intrinsics
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads; i0 < width; i0 += (int64_t)gridDim.x * kThreads) {
    const int64_t i = i0 + threadIdx.x;
    const bool ok = i < width;
    const u64 u = ok ? key_of(L, is_float, desc, i) : 0ULL;
    if (ok) {
      o |= u;
      a &= u;
    }
    // a digit the same in every row of the warp costs one atomic
    const u32 d = (u32)(u >> 56);
    const unsigned live = __ballot_sync(kFull, ok);
    const u32 lo = __reduce_min_sync(kFull, ok ? d : 0xFFFFFFFFu), hi = __reduce_max_sync(kFull, ok ? d : 0u);
    if (lo == hi) {
      if (lane == __ffs(live) - 1) atomicAdd(&h[d], (u32)__popc(live));
    } else if (ok) {
      atomicAdd(&h[d], 1u);
    }
  }
  __syncthreads();
  if (h[threadIdx.x] != 0u) atomicAdd(&st[S_HIST + threadIdx.x], (u64)h[threadIdx.x]);
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
    atomicOr(&st[S_OR], o);
    atomicAnd(&st[S_AND], a);
  }
}

// The candidates' source of task y: every row, or buffer `src`.
struct Source {
  int src;
  int64_t len;
  const u64* bu;
  const u32* br;
};

__device__ __forceinline__ Source source_of(const u64* st, int y, int G, const u64* bufu, const u32* bufr,
                                            int64_t bcap, int64_t width) {
  Source s;
  s.src = (int)(long long)st[S_SRC];
  s.len = s.src < 0 ? width : (int64_t)st[S_BUFN0 + s.src];
  const int64_t off = ((int64_t)(s.src < 0 ? 0 : s.src) * G + y) * bcap;
  s.bu = bufu + off;
  s.br = bufr + off;
  return s;
}

__device__ __forceinline__ void load(const Source& s, const Lanes& L, int is_float, int desc, int64_t i, u64& u,
                                     int64_t& row) {
  if (s.src < 0) {
    row = i;
    u = key_of(L, is_float, desc, i);
  } else {
    row = (int64_t)s.br[i];
    u = s.bu[i];
  }
}

// Inclusive scan of one u64 per thread over a 256-thread block.
__device__ __forceinline__ u64 block_incl_scan_256(u64 x, u64* ws) {
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

// One digit of every task's select (module note, step 2).
__global__ void __launch_bounds__(kThreads) topk_pass(const long long* __restrict__ tasks, int is_float, int desc,
                                                      int64_t width, int64_t k, int dig, u64* state, u64* bufu,
                                                      u32* bufr, int64_t bcap, int32_t* cand, u64* candu,
                                                      uint8_t* okc) {
  __shared__ u32 h[256];
  __shared__ u64 ws[kWarps];
  __shared__ int s_last;
  const int y = blockIdx.y, G = gridDim.y, t = threadIdx.x;
  u64* st = state + (int64_t)y * S_LEN;
  if (st[S_DONE]) return;
  if (dig >= 4 && (((st[S_OR] ^ st[S_AND]) >> (8 * (dig - 4))) & 0xFFULL) == 0ULL) {  // constant
    if (dig == 11 && blockIdx.x == 0) st[S_HIST + t] = 0ULL;  // topk_orand's count of it
    return;
  }
  const Lanes L = lanes_of(tasks, y);
  const View v = view_of(st);
  const Source s = source_of(st, y, G, bufu, bufr, bcap, width);
  // digit 11, the first digit of u, was counted by topk_orand: every row is
  // its candidate, none is output yet and none is written (NCAND = width)
  const int64_t len = dig == 11 ? 0 : s.len;
  // the candidates standing after this kernel's classification are NCAND;
  // they go to the other buffer once they fit
  const bool write = len > 0 && (s.src >= 0 || (int64_t)st[S_NCAND] <= bcap);
  const int dst = s.src == 0 ? 1 : 0;
  u64* wu = bufu + ((int64_t)dst * G + y) * bcap;
  u32* wr = bufr + ((int64_t)dst * G + y) * bcap;
  const Out o{cand + (int64_t)y * k, candu + (int64_t)y * k, okc + (int64_t)y * k, k};
  h[t] = 0u;
  __syncthreads();
  const int lane = t & 31;
  // i0 is the same for the whole block: every lane takes part in each
  // round's warp intrinsics
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads; i0 < len; i0 += (int64_t)gridDim.x * kThreads) {
    const int64_t i = i0 + t;
    u64 u = 0ULL;
    int64_t row = 0;
    int c = -1;
    if (i < s.len) {
      load(s, L, is_float, desc, i, u, row);
      c = classify(v, u, ~(u32)row);
    }
    emit(c == 1, u, row, L, st, o);
    const u32 d = c == 0 ? digit_of(u, ~(u32)row, dig) : 256u;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256u && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], (u32)__popc(peers));
    if (write) {
      const int64_t pos = warp_slot(c == 0, &st[S_BUFN0 + dst]);
      if (pos >= 0) {
        wu[pos] = u;
        wr[pos] = (u32)row;
      }
    }
  }
  __syncthreads();
  if (h[t] != 0u) atomicAdd(&st[S_HIST + t], (u64)h[t]);
  // the block that finishes last picks the digit
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&st[S_TICKET], 1ULL) == (u64)(gridDim.x - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // thread t holds digit 255 - t: the scan runs from the largest digit down
  const int dd = 255 - t;
  const u64 c = atomicAdd(&st[S_HIST + dd], 0ULL);
  const u64 rem = st[S_REM];
  const u64 incl = block_incl_scan_256(c, ws);
  const u64 excl = incl - c;
  st[S_HIST + dd] = 0ULL;
  if (excl < rem && rem <= incl) {  // exactly one digit holds the k-th largest
    if (dig >= 4)
      st[S_PRE_U] |= (u64)dd << (8 * (dig - 4));
    else
      st[S_PRE_R] |= (u64)dd << (8 * dig);
    if (v.pend >= 4)
      st[S_KNOWN_U] |= 0xFFULL << (8 * (v.pend - 4));
    else if (v.pend >= 0)
      st[S_KNOWN_R] |= 0xFFULL << (8 * v.pend);
    st[S_PEND] = (u64)dig;
    st[S_REM] = rem - excl;
    st[S_NCAND] = c;
    st[S_DONE] = c == rem - excl ? 1ULL : 0ULL;
    if (write) {
      st[S_SRC] = (u64)dst;
      st[S_BUFN0 + (1 - dst)] = 0ULL;  // the next pass writes there
    }
  }
  if (t == 0) st[S_TICKET] = 0ULL;
}

// The candidates still standing are all needed (module note, step 3).
__global__ void __launch_bounds__(kThreads) topk_collect(const long long* __restrict__ tasks, int is_float,
                                                         int desc, int64_t width, int64_t k, u64* state,
                                                         const u64* bufu, const u32* bufr, int64_t bcap,
                                                         int32_t* cand, u64* candu, uint8_t* okc) {
  const int y = blockIdx.y, G = gridDim.y;
  u64* st = state + (int64_t)y * S_LEN;
  const Lanes L = lanes_of(tasks, y);
  const View v = view_of(st);
  const Source s = source_of(st, y, G, bufu, bufr, bcap, width);
  const Out o{cand + (int64_t)y * k, candu + (int64_t)y * k, okc + (int64_t)y * k, k};
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads; i0 < s.len; i0 += (int64_t)gridDim.x * kThreads) {
    const int64_t i = i0 + threadIdx.x;
    u64 u = 0ULL;
    int64_t row = 0;
    int c = -1;
    if (i < s.len) {
      load(s, L, is_float, desc, i, u, row);
      c = classify(v, u, ~(u32)row);
    }
    emit(c >= 0, u, row, L, st, o);
  }
}

// lax.top_k's order of a task's k outputs (module note, step 4): p2 is k
// rounded up to a power of two.
__global__ void __launch_bounds__(kOrderThreads) topk_order(const long long* __restrict__ tasks, int64_t k,
                                                            int p2, int32_t* cand, const u64* candu,
                                                            uint8_t* okc) {
  extern __shared__ unsigned char smem[];
  u64* su = (u64*)smem;          // [p2]
  u32* sr = (u32*)(su + p2);     // [p2]
  const int y = blockIdx.x;
  const uint8_t* mask = (const uint8_t*)tasks[3 * (int64_t)y + 2];
  cand += (int64_t)y * k;
  candu += (int64_t)y * k;
  okc += (int64_t)y * k;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    su[i] = i < k ? candu[i] : 0ULL;  // the pads sort last: u 0, row past every row
    sr[i] = i < k ? (u32)cand[i] : 0xFFFFFFFFu;
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        // hi before lo in (u desc, row asc)?
        const bool hi_first = su[hi] > su[lo] || (su[hi] == su[lo] && sr[hi] < sr[lo]);
        if (hi_first == up) {
          const u64 tu = su[lo];
          su[lo] = su[hi];
          su[hi] = tu;
          const u32 tr = sr[lo];
          sr[lo] = sr[hi];
          sr[hi] = tr;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    cand[i] = (int32_t)sr[i];
    okc[i] = mask[sr[i]];
  }
}

// cudaFuncSetAttribute for topk_order's largest dynamic shared memory, once
// per card.
int allow_order_smem() {
  static std::atomic<unsigned> done{0u};  // a bit a card
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0 || (dev < 32 && ((done.load() >> dev) & 1u))) return err;
  err = (int)cudaFuncSetAttribute(topk_order, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kOrderCap * (int)(sizeof(u64) + sizeof(u32)));
  if (err == 0 && dev < 32) done.fetch_or(1u << dev);
  return err;
}

}  // namespace

// Int64 slots of the `state` scratch, per task.
extern "C" int64_t tt_topk_state_len() { return S_LEN; }

// (u, row) pairs a candidate buffer holds, per task and buffer: the
// passes write it only once the candidates fit.
extern "C" int64_t tt_topk_buf_cap(int64_t width) { return (width + 7) / 8; }

// G tasks through the task table (int64 [G, 3]: data, valid or 0, mask),
// each task's first `width` rows (the solo call is G = 1): cand (int32
// [G, k]) gets each task's k best rows (task-local ids), candu (uint64 [G,
// k]) their u and okc (bool [G, k]) their mask bits — in lax.top_k's
// order when `order` (k <= kOrderCap, kernels/topk.py ORDER_CAP), else
// unordered. state: u64 [G, tt_topk_state_len()]; bufu: u64 [2, G, bcap],
// bufr: uint32 [2, G, bcap], bcap = tt_topk_buf_cap(width).
extern "C" int tt_topk_select_tasks(const void* tasks, int G, int is_float, int desc, int64_t width, int64_t k,
                                    u64* state, u64* bufu, u32* bufr, int32_t* cand, u64* candu, uint8_t* okc,
                                    int order, int n_sms, void* stream) {
  if (G < 1 || G > 65535 || width <= 0 || width > 0x7fffffffLL || k <= 0 || k > width ||
      (order && k > kOrderCap))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* T = (const long long*)tasks;
  const int64_t bcap = tt_topk_buf_cap(width);
  int64_t blocks = (width + kThreads - 1) / kThreads;
  // n_sms * 8 blocks, shared out over the tasks
  const int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 8 + G - 1) / G;
  if (blocks > per_task) blocks = per_task;
  const dim3 grid((unsigned)blocks, (unsigned)G);
  topk_init<<<G, 32, 0, s>>>(state, k, width);
  topk_orand<<<grid, kThreads, 0, s>>>(T, is_float, desc, width, state);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // u's 8 digits, then the digits of ~row that vary below width
  int rdig = 0;
  for (int64_t top = width - 1; top > 0; top >>= 8) ++rdig;
  for (int dig = 11; dig >= 0; --dig) {
    if (dig < 4 && dig >= rdig) continue;
    topk_pass<<<grid, kThreads, 0, s>>>(T, is_float, desc, width, k, dig, state, bufu, bufr, bcap, cand, candu,
                                        okc);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  topk_collect<<<grid, kThreads, 0, s>>>(T, is_float, desc, width, k, state, bufu, bufr, bcap, cand, candu, okc);
  err = (int)cudaGetLastError();
  if (err != 0 || !order) return err;
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  const size_t smem = (size_t)p2 * (sizeof(u64) + sizeof(u32));
  err = allow_order_smem();
  if (err != 0) return err;
  topk_order<<<G, kOrderThreads, smem, s>>>(T, k, p2, cand, candu, okc);
  return (int)cudaGetLastError();
}
