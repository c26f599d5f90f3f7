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
//   1. topk_keys   writes u [n] and reduces its OR / AND (the bits that
//                  vary);
//   2. eight select passes over 8-bit digits, most significant first:
//                  topk_hist counts the digit of every row whose higher
//                  digits equal the threshold found so far, topk_pick
//                  (one thread) takes the digit holding the k-th largest
//                  and keeps how many rows equal to the threshold are
//                  still needed (`rem`). A digit that is constant over
//                  all rows costs one early-returning launch, no read;
//   3. topk_eqcount + scan_excl + topk_collect: every row with u > T
//      goes to the first k - rem candidate slots (atomics: order does
//      not matter), and the rem rows with u == T of lowest index to the
//      rest (a tile-ordered scan keeps index order).
//
// The candidates are then ordered by (u desc, row asc) with K8
// (kernels/topk.py), which is lax.top_k's order: equal keys keep the lower
// index first.
//
// Every kernel runs over a task grid: the solo TopN is a grid of one
// task, and K10's task-grid mode (tidb_tpu/copr/tpu_engine.py:1096-1134
// vmapping the kernel above over a launch group) one of G tasks. One radix
// select per task, the task on the grid's y axis, each through its row of
// a task table (its key, valid and mask lanes, read to the group's
// `width`), with its own state row: its own OR / AND, so a digit constant
// within a task costs that task nothing, and its own threshold. Each task
// collects k = min(n, width) candidates with their mask bits; K8's
// task-leading mode orders all G * k of them by (task, u desc, row asc).
//
// Bound: bytes. The key's 8 bytes and two 1-byte flags are read once;
// u (8 bytes a row) is written once and read once per varying digit and
// twice by the collect. TPC-H's extendedprice key varies in 24 bits:
// three select passes.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launches (0 = success) or
// -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr u64 kSign = 0x8000000000000000ULL;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// state (u64 [8 + 256] a task): OR, AND, threshold prefix, rem, gt
// counter, -, -, -, hist[256]
enum { S_OR = 0, S_AND = 1, S_PREFIX = 2, S_REM = 3, S_GT = 4, S_HIST = 8, S_LEN = S_HIST + 256 };

// Every kernel below runs one task per grid row (blockIdx.y; blockIdx.x
// for the one-block kernels): task y's keys are U[y * n, (y + 1) * n), its
// state row state[y * S_LEN], its tile counts tilecnt[y * tiles] and its k
// candidates cand[y * k]. The solo mode is the grid of one task.

__global__ void topk_init(u64* state, int64_t k) {
  state += (int64_t)blockIdx.x * S_LEN;
  for (int t = threadIdx.x; t < S_LEN; t += blockDim.x) state[t] = 0ULL;
  __syncthreads();
  if (threadIdx.x == 0) {
    state[S_AND] = ~0ULL;
    state[S_REM] = (u64)k;
  }
}

__device__ __forceinline__ u64 total_order(double x) {
  const u64 b = (u64)__double_as_longlong(x);
  return (b & kSign) ? ~b : (b | kSign);
}

// Task y through its row of the task table: (data, valid or 0, mask).
__global__ void topk_keys(const long long* __restrict__ tasks, int is_float, int desc, int64_t n,
                          u64* __restrict__ U, u64* state) {
  __shared__ u64 s_or[kWarps], s_and[kWarps];
  const long long* T = tasks + 3 * (int64_t)blockIdx.y;
  const void* data = (const void*)T[0];
  const uint8_t* valid = (const uint8_t*)T[1];
  const uint8_t* mask = (const uint8_t*)T[2];
  U += (int64_t)blockIdx.y * n;
  state += (int64_t)blockIdx.y * S_LEN;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  u64 o = 0ULL, a = ~0ULL;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool m = mask[i] != 0;
    const bool v = valid == nullptr || valid[i] != 0;
    u64 u;
    if (is_float) {
      const double d = ((const double*)data)[i];
      const double inf = __longlong_as_double(0x7ff0000000000000LL);
      double key;
      if (desc)
        key = (m && v) ? d : -inf;
      else
        key = m ? (v ? -d : inf) : -inf;
      u = total_order(key);
    } else {
      const u64 d = (u64)((const long long*)data)[i];
      u64 key;  // two's complement bits of the int64 key
      if (desc)
        key = (m && v) ? d : kSign;
      else
        key = m ? (v ? (0ULL - d) : (kSign - 2ULL)) : kSign;  // kSign - 2: INT64_MAX - 1
      u = key ^ kSign;
    }
    U[i] = u;
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
    atomicOr(&state[S_OR], o);
    atomicAnd(&state[S_AND], a);
  }
}

__device__ __forceinline__ bool constant_digit(const u64* state, int shift) {
  return (((state[S_OR] ^ state[S_AND]) >> shift) & 0xFFULL) == 0ULL;
}

__global__ void topk_hist(const u64* __restrict__ U, int64_t n, int shift, u64* state) {
  U += (int64_t)blockIdx.y * n;
  state += (int64_t)blockIdx.y * S_LEN;
  if (constant_digit(state, shift)) return;
  __shared__ unsigned int h[256];
  h[threadIdx.x] = 0u;
  __syncthreads();
  const int hi = shift + 8;
  const u64 prefix = state[S_PREFIX];
  const int lane = threadIdx.x & 31;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i - threadIdx.x < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int d = 256;
    if (i < n) {
      const u64 u = U[i];
      if (hi >= 64 || (u >> hi) == (prefix >> hi)) d = (int)((u >> shift) & 0xFFULL);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < 256 && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], (unsigned)__popc(peers));
  }
  __syncthreads();
  if (h[threadIdx.x] != 0u) atomicAdd(&state[S_HIST + threadIdx.x], (u64)h[threadIdx.x]);
}

__global__ void topk_pick(u64* state, int shift) {
  if (threadIdx.x != 0) return;
  state += (int64_t)blockIdx.x * S_LEN;
  if (constant_digit(state, shift)) {
    state[S_PREFIX] |= ((state[S_AND] >> shift) & 0xFFULL) << shift;
    return;
  }
  u64 rem = state[S_REM];
  int chosen = 0;
  for (int d = 255; d >= 0; --d) {
    const u64 c = state[S_HIST + d];
    if (c >= rem) {
      chosen = d;
      break;
    }
    rem -= c;
  }
  state[S_PREFIX] |= (u64)chosen << shift;
  state[S_REM] = rem;
  for (int d = 0; d < 256; ++d) state[S_HIST + d] = 0ULL;
}

__global__ void topk_eqcount(const u64* __restrict__ U, int64_t n, const u64* state,
                             int32_t* __restrict__ tilecnt) {
  __shared__ int32_t ws[kWarps];
  U += (int64_t)blockIdx.y * n;
  state += (int64_t)blockIdx.y * S_LEN;
  tilecnt += (int64_t)blockIdx.y * gridDim.x;
  const u64 T = state[S_PREFIX];
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  int32_t c = 0;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile + (int64_t)r * kThreads + threadIdx.x;
    c += (i < n && U[i] == T) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int q = 0; q < kWarps; ++q) s += ws[q];
    tilecnt[blockIdx.x] = s;
  }
}

// One block a task: exclusive scan of the task's x[0..len) in place.
__global__ void scan_excl(int32_t* __restrict__ x, int64_t len) {
  __shared__ int32_t ws[kScanThreads / 32];
  x += (int64_t)blockIdx.x * len;
  constexpr int nw = kScanThreads / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t carry = 0;
  for (int64_t start = 0; start < len; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const int32_t a = i < len ? x[i] : 0;
    int32_t v = a;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane == 31) ws[w] = v;
    __syncthreads();
    if (w == 0) {
      int32_t s = ws[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      ws[lane] = s;
    }
    __syncthreads();
    if (i < len) x[i] = carry + v - a + (w > 0 ? ws[w - 1] : 0);
    carry += ws[nw - 1];
    __syncthreads();
  }
}

// okc gets each candidate's mask bit, read through the task table.
__global__ void topk_collect(const u64* __restrict__ U, int64_t n, int64_t k, u64* state,
                             const int32_t* __restrict__ tileoff, int32_t* __restrict__ cand,
                             const long long* __restrict__ tasks, uint8_t* __restrict__ okc) {
  __shared__ int32_t ws[kWarps];
  U += (int64_t)blockIdx.y * n;
  state += (int64_t)blockIdx.y * S_LEN;
  tileoff += (int64_t)blockIdx.y * gridDim.x;
  cand += (int64_t)blockIdx.y * k;
  const uint8_t* mask = (const uint8_t*)tasks[3 * (int64_t)blockIdx.y + 2];
  okc += (int64_t)blockIdx.y * k;
  const u64 T = state[S_PREFIX];
  const int64_t rem = (int64_t)state[S_REM];
  const int64_t ngt = k - rem;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int64_t carry = tileoff[blockIdx.x];
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile + (int64_t)r * kThreads + threadIdx.x;
    const u64 u = i < n ? U[i] : 0ULL;
    const bool eq = i < n && u == T;
    if (i < n && u > T) {
      const u64 pos = atomicAdd(&state[S_GT], 1ULL);
      cand[pos] = (int32_t)i;
      okc[pos] = mask[i];
    }
    const unsigned bal = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) ws[w] = __popc(bal);
    __syncthreads();
    int64_t before = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      before += q < w ? ws[q] : 0;
      total += ws[q];
    }
    if (eq) {
      const int64_t rank = carry + before + __popc(bal & lt);
      if (rank < rem) {
        cand[ngt + rank] = (int32_t)i;
        okc[ngt + rank] = mask[i];
      }
    }
    carry += total;
    __syncthreads();
  }
}

}  // namespace

// Int64 slots of the `state` scratch.
extern "C" int64_t tt_topk_state_len() { return S_LEN; }

// Int32 slots of the `tilecnt` scratch for n rows.
extern "C" int64_t tt_topk_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// G tasks through the task table (int64 [G, 3]: data, valid or 0, mask),
// each task's first `width` rows (the solo call is G = 1); cand (int32 [G, k])
// gets each task's k candidates (task-local rows, unordered) and okc
// (bool [G, k]) their mask bits. U: u64 [G, width]; state: u64 [G,
// tt_topk_state_len()]; tilecnt: int32 [G, tt_topk_tiles(width)].
extern "C" int tt_topk_select_tasks(const void* tasks, int G, int is_float, int desc,
                                    int64_t width, int64_t k, u64* U, u64* state,
                                    int32_t* tilecnt, int32_t* cand, uint8_t* okc, int n_sms,
                                    void* stream) {
  if (G < 1 || G > 65535 || width <= 0 || width > 0x7fffffffLL || k <= 0 || k > width) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* T = (const long long*)tasks;
  int64_t blocks = (width + kThreads - 1) / kThreads;
  // n_sms * 8 blocks, shared out over the tasks
  const int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 8 + G - 1) / G;
  if (blocks > per_task) blocks = per_task;
  const dim3 grid((unsigned)blocks, (unsigned)G);
  topk_init<<<G, 256, 0, s>>>(state, k);
  topk_keys<<<grid, kThreads, 0, s>>>(T, is_float, desc, width, U, state);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  for (int shift = 56; shift >= 0; shift -= 8) {
    topk_hist<<<grid, kThreads, 0, s>>>(U, width, shift, state);
    topk_pick<<<G, 32, 0, s>>>(state, shift);
  }
  const int64_t tiles = (width + kTile - 1) / kTile;
  const dim3 tgrid((unsigned)tiles, (unsigned)G);
  topk_eqcount<<<tgrid, kThreads, 0, s>>>(U, width, state, tilecnt);
  scan_excl<<<G, kScanThreads, 0, s>>>(tilecnt, tiles);
  topk_collect<<<tgrid, kThreads, 0, s>>>(U, width, k, state, tilecnt, cand, T, okc);
  return (int)cudaGetLastError();
}
