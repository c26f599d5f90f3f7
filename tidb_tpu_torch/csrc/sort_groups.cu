// K9 sort_groups: dense group ids of a sort-based GROUP BY.
//
// Replaces tidb_tpu/copr/tpu_engine.py:1351-1400 (the kernel of
// TPUEngine._lower_agg_sorted) up to its segment reductions, which K4
// (csrc/seg_agg.cu, precomputed-segment mode) takes over. Three steps
// around K8 (csrc/lex_sort.cu):
//
//   sg_ops_kernel       the sort operands, per row i:
//                         flag[i]   = !mask[i]                (int32)
//                         null_j[i] = !v                      (int32)
//                         val_j[i]  = v ? bits(d) : 0         (int64)
//                       bits: int32 codes sign-extend; int64 and uint64
//                       as they are; float64 folds -0.0 into +0.0, then
//                       its bit pattern (GROUP BY needs equality only).
//                       The reference's fold tests x == 0.0 with XLA's
//                       subnormals flushed, so subnormals fold to +0.0
//                       as well: |x| < DBL_MIN is zero here.
//   -- K8 sorts rows by (flag, null_0, val_0, ...) into perm --
//   sg_count_kernel     per tile of sorted positions, the count of group
//                       starts: new[i] = !flag[perm[i]] && (i == 0 ||
//                       some key operand differs from position i - 1)
//   scan_excl           the tiles' offsets, and n_groups (their total)
//   sg_segments_kernel  with the capacity the host chose from n_groups:
//                       seg0 = (group starts up to i) - 1, per row
//                       seg[perm[i]] = !flag ? min(seg0, cap) : cap
//                       (scattered back to row order, so K4 reads every
//                       value lane in place instead of gathering it), and
//                       at each group start below cap the group's key
//                       outputs: kval_j[seg0] = val_j, kvalid_j[seg0] =
//                       1 - null_j. Every row of a group holds the same
//                       key words, so this equals the reference's
//                       _seg_max over the group on [0, n_groups).
//
// Task-grid mode (K10's sort GROUP BY, tidb_tpu/copr/tpu_engine.py:1096-1134
// vmapping the kernel above over a launch group): G tasks, the grid's y
// axis the task, each through its row of the task table (its mask and key
// lanes, read to the group's `width`), their operands into slice y of
// [G, width] lanes. K8's task-leading mode sorts them by (task, flag, keys),
// so task y's sorted positions are y * width + [0, width): the count and
// segment kernels tile each task's positions on their own, a task's first
// position starts a group, and one scan over all the tasks' tiles numbers
// the groups on across the tasks (task g's ids start at the earlier tasks'
// total). sg_task_counts gives each task's n_groups ([G], read by the host
// in one sync); the segments run with cap = the total, so none is capped,
// and the keys land in [nkeys, total]. The solo mode is G = 1.
//
// Bound: bytes. The ops pass reads mask, keys and valid bytes once and
// writes 4 + 12 bytes a key per row; count and segments read the perm
// (4 bytes) and gather each row's operands and its predecessor's; the
// scatter writes 4 bytes a row. The gathers follow the sort order, so
// they are the cost beyond the bound.
//
// Plain C interface (nvcc + ctypes): every entry point launches on the
// given stream, never synchronizes, and returns the cudaError_t of its
// launches (0 = success) or -1 for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3 };

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// Host-built table (kernels/sort_groups.py packs it as int64): G task rows
// of 1 + 2 * nkeys addresses (mask, then per key its data and its valid
// lane, 0 = all valid), then nkeys SgKey rows shared by the tasks.
struct SgKey {
  int64_t kind;
  int32_t* null_out;  // [G * width]
  long long* val_out;  // [G * width]
};

struct KeyOps {  // int64 pairs: the operands K8 sorted by
  const int32_t* null_;
  const long long* val;
};

// Task blockIdx.y's rows 0..width of its own lanes into slice y of the
// outputs.
__global__ void sg_ops_kernel(const long long* __restrict__ tasks, int64_t width,
                              const SgKey* __restrict__ keys, int nkeys,
                              int32_t* __restrict__ flag) {
  const long long* T = tasks + (int64_t)blockIdx.y * (1 + 2 * nkeys);
  const uint8_t* mask = (const uint8_t*)T[0];
  const int64_t base = (int64_t)blockIdx.y * width;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    flag[base + i] = mask[i] ? 0 : 1;
    for (int j = 0; j < nkeys; ++j) {
      const void* data = (const void*)T[1 + 2 * j];
      const uint8_t* valid = (const uint8_t*)T[2 + 2 * j];
      const int64_t kind = keys[j].kind;
      const bool v = valid == nullptr || valid[i] != 0;
      keys[j].null_out[base + i] = v ? 0 : 1;
      long long x = 0;
      if (v) {
        if (kind == K_I32) {
          x = ((const int32_t*)data)[i];
        } else if (kind == K_F64) {
          const double d = ((const double*)data)[i];
          x = fabs(d) < 2.2250738585072014e-308 ? 0LL : __double_as_longlong(d);
        } else {
          x = ((const long long*)data)[i];
        }
      }
      keys[j].val_out[base + i] = x;
    }
  }
}

// Sorted position i starts a group: its row is masked in and it is its
// task's first position (`first`) or differs from position i - 1.
__device__ __forceinline__ bool group_start(const int32_t* __restrict__ flag,
                                            const KeyOps* __restrict__ keys, int nkeys,
                                            const int32_t* __restrict__ perm, int64_t i,
                                            bool first, int64_t* row_out) {
  const int64_t row = perm[i];
  *row_out = row;
  if (flag[row] != 0) return false;
  if (first) return true;
  const int64_t prev = perm[i - 1];
  for (int j = 0; j < nkeys; ++j)
    if (keys[j].null_[row] != keys[j].null_[prev] || keys[j].val[row] != keys[j].val[prev])
      return true;
  return false;
}

// Tile blockIdx.x of task blockIdx.y (its sorted positions y * width +
// [x * kTile, (x + 1) * kTile) within the task's width): its count of
// group starts into tilecnt[y * gridDim.x + x].
__global__ void sg_count_kernel(const int32_t* __restrict__ flag, const KeyOps* __restrict__ keys,
                                int nkeys, const int32_t* __restrict__ perm, int64_t width,
                                int32_t* __restrict__ tilecnt) {
  __shared__ int32_t ws[kWarps];
  const int64_t base = (int64_t)blockIdx.y * width;
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  int32_t c = 0;
  for (int r = 0; r < kItems; ++r) {
    const int64_t l = tile + (int64_t)r * kThreads + threadIdx.x;
    int64_t row;
    if (l < width && group_start(flag, keys, nkeys, perm, base + l, l == 0, &row)) ++c;
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int q = 0; q < kWarps; ++q) s += ws[q];
    tilecnt[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// One block: exclusive scan of x[0..len) in place, the total into x[len].
__global__ void scan_excl(int32_t* __restrict__ x, int64_t len) {
  __shared__ int32_t ws[kScanThreads / 32];
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
  if (threadIdx.x == 0) x[len] = carry;
}

// n_groups of each task from the scanned tile offsets (tpt tiles a task,
// the total at [G * tpt]).
__global__ void sg_task_counts(const int32_t* __restrict__ tileoff, int64_t tpt, int G,
                               int32_t* __restrict__ counts) {
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    counts[g] = tileoff[(int64_t)(g + 1) * tpt] - tileoff[(int64_t)g * tpt];
}

__global__ void sg_segments_kernel(const int32_t* __restrict__ flag,
                                   const KeyOps* __restrict__ keys, int nkeys,
                                   const int32_t* __restrict__ perm, int64_t width,
                                   const int32_t* __restrict__ tileoff, int64_t cap,
                                   int32_t* __restrict__ seg, long long* __restrict__ kval,
                                   long long* __restrict__ kvalid) {
  __shared__ int32_t ws[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned le = (lane == 31) ? 0xffffffffu : ((1u << (lane + 1)) - 1u);
  int64_t carry = tileoff[(int64_t)blockIdx.y * gridDim.x + blockIdx.x];
  const int64_t base = (int64_t)blockIdx.y * width;
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t l = tile + (int64_t)r * kThreads + threadIdx.x;
    const int64_t i = base + l;
    int64_t row = 0;
    const bool start = l < width && group_start(flag, keys, nkeys, perm, i, l == 0, &row);
    const unsigned bal = __ballot_sync(0xffffffffu, start);
    if (lane == 0) ws[w] = __popc(bal);
    __syncthreads();
    int64_t before = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      before += q < w ? ws[q] : 0;
      total += ws[q];
    }
    if (l < width) {
      const int64_t seg0 = carry + before + __popc(bal & le) - 1;
      const bool in = flag[row] == 0;
      seg[row] = (int32_t)(in ? (seg0 < cap ? seg0 : cap) : cap);
      if (start && seg0 < cap) {
        for (int j = 0; j < nkeys; ++j) {
          kval[(int64_t)j * cap + seg0] = keys[j].val[row];
          kvalid[(int64_t)j * cap + seg0] = 1 - keys[j].null_[row];
        }
      }
    }
    carry += total;
    __syncthreads();
  }
}

}  // namespace

// Tiles of one task of `width` sorted positions (the tile-count scratch
// holds G of them, plus the total).
extern "C" int64_t tt_sg_tiles(int64_t width) { return (width + kTile - 1) / kTile; }

// The sort operands of G tasks (tasks / keys: the table above; flag and the
// keys' outputs: [G * width]).
extern "C" int tt_sg_ops(const void* tasks, int G, int64_t width, const void* keys, int nkeys,
                         int32_t* flag, int n_sms, void* stream) {
  if (width <= 0 || nkeys <= 0 || G < 1 || G > 65535) return -1;
  int64_t blocks = (width + kThreads - 1) / kThreads;
  const int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 16 + G - 1) / G;
  if (blocks > per_task) blocks = per_task;
  sg_ops_kernel<<<dim3((unsigned)blocks, (unsigned)G), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)tasks, width, (const SgKey*)keys, nkeys, flag);
  return (int)cudaGetLastError();
}

// tilecnt: int32 [G * tt_sg_tiles(width) + 1]; after it runs,
// tilecnt[G * tiles] is the group's n_groups and, when counts is not
// null, counts[g] (int32 [G]) task g's.
extern "C" int tt_sg_count(const int32_t* flag, const void* keys, int nkeys, const int32_t* perm,
                           int G, int64_t width, int32_t* tilecnt, int32_t* counts, void* stream) {
  if (width <= 0 || (int64_t)G * width > 0x7fffffffLL || nkeys <= 0 || G < 1 || G > 65535)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (width + kTile - 1) / kTile;
  sg_count_kernel<<<dim3((unsigned)tiles, (unsigned)G), kThreads, 0, s>>>(
      flag, (const KeyOps*)keys, nkeys, perm, width, tilecnt);
  scan_excl<<<1, kScanThreads, 0, s>>>(tilecnt, (int64_t)G * tiles);
  if (counts != nullptr) sg_task_counts<<<1, 64, 0, s>>>(tilecnt, tiles, G, counts);
  return (int)cudaGetLastError();
}

// seg: int32 [G * width] in row order; kval / kvalid: int64 [nkeys, cap],
// filled by the caller with INT64_MIN / -1. Group ids run on across the
// tasks (task g's from the earlier tasks' total); with cap = the total,
// none is capped.
extern "C" int tt_sg_segments(const int32_t* flag, const void* keys, int nkeys,
                              const int32_t* perm, int G, int64_t width, const int32_t* tilecnt,
                              int64_t cap, int32_t* seg, long long* kval, long long* kvalid,
                              void* stream) {
  if (width <= 0 || nkeys <= 0 || cap <= 0 || cap > 0x7fffffffLL || G < 1 || G > 65535) return -1;
  const int64_t tiles = (width + kTile - 1) / kTile;
  sg_segments_kernel<<<dim3((unsigned)tiles, (unsigned)G), kThreads, 0, (cudaStream_t)stream>>>(
      flag, (const KeyOps*)keys, nkeys, perm, width, tilecnt, cap, seg, kval, kvalid);
  return (int)cudaGetLastError();
}
