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

struct OpsDesc {  // int64 5-tuples from kernels/sort_groups.py
  const void* data;
  const uint8_t* valid;  // null = all valid
  int64_t kind;
  int32_t* null_out;
  long long* val_out;
};

struct KeyOps {  // int64 pairs: the operands K8 sorted by
  const int32_t* null_;
  const long long* val;
};

__global__ void sg_ops_kernel(const uint8_t* __restrict__ mask, int64_t n,
                              const OpsDesc* __restrict__ keys, int nkeys,
                              int32_t* __restrict__ flag) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    flag[i] = mask[i] ? 0 : 1;
    for (int j = 0; j < nkeys; ++j) {
      const OpsDesc& K = keys[j];
      const bool v = K.valid == nullptr || K.valid[i] != 0;
      K.null_out[i] = v ? 0 : 1;
      long long x = 0;
      if (v) {
        if (K.kind == K_I32) {
          x = ((const int32_t*)K.data)[i];
        } else if (K.kind == K_F64) {
          const double d = ((const double*)K.data)[i];
          x = fabs(d) < 2.2250738585072014e-308 ? 0LL : __double_as_longlong(d);
        } else {
          x = ((const long long*)K.data)[i];
        }
      }
      K.val_out[i] = x;
    }
  }
}

__device__ __forceinline__ bool group_start(const int32_t* __restrict__ flag,
                                            const KeyOps* __restrict__ keys, int nkeys,
                                            const int32_t* __restrict__ perm, int64_t i,
                                            int64_t* row_out) {
  const int64_t row = perm[i];
  *row_out = row;
  if (flag[row] != 0) return false;
  if (i == 0) return true;
  const int64_t prev = perm[i - 1];
  for (int j = 0; j < nkeys; ++j)
    if (keys[j].null_[row] != keys[j].null_[prev] || keys[j].val[row] != keys[j].val[prev])
      return true;
  return false;
}

__global__ void sg_count_kernel(const int32_t* __restrict__ flag, const KeyOps* __restrict__ keys,
                                int nkeys, const int32_t* __restrict__ perm, int64_t n,
                                int32_t* __restrict__ tilecnt) {
  __shared__ int32_t ws[kWarps];
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  int32_t c = 0;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile + (int64_t)r * kThreads + threadIdx.x;
    int64_t row;
    if (i < n && group_start(flag, keys, nkeys, perm, i, &row)) ++c;
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

__global__ void sg_segments_kernel(const int32_t* __restrict__ flag,
                                   const KeyOps* __restrict__ keys, int nkeys,
                                   const int32_t* __restrict__ perm, int64_t n,
                                   const int32_t* __restrict__ tileoff, int64_t cap,
                                   int32_t* __restrict__ seg, long long* __restrict__ kval,
                                   long long* __restrict__ kvalid) {
  __shared__ int32_t ws[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned le = (lane == 31) ? 0xffffffffu : ((1u << (lane + 1)) - 1u);
  int64_t carry = tileoff[blockIdx.x];
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile + (int64_t)r * kThreads + threadIdx.x;
    int64_t row = 0;
    const bool start = i < n && group_start(flag, keys, nkeys, perm, i, &row);
    const unsigned bal = __ballot_sync(0xffffffffu, start);
    if (lane == 0) ws[w] = __popc(bal);
    __syncthreads();
    int64_t before = 0, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      before += q < w ? ws[q] : 0;
      total += ws[q];
    }
    if (i < n) {
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

int grid_for(int64_t n, int n_sms) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

// Int32 slots of the tile-count scratch for n rows (the tiles, plus the total).
extern "C" int64_t tt_sg_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

extern "C" int tt_sg_ops(const uint8_t* mask, int64_t n, const void* keys, int nkeys,
                         int32_t* flag, int n_sms, void* stream) {
  if (n <= 0 || nkeys <= 0) return -1;
  sg_ops_kernel<<<grid_for(n, n_sms), kThreads, 0, (cudaStream_t)stream>>>(
      mask, n, (const OpsDesc*)keys, nkeys, flag);
  return (int)cudaGetLastError();
}

// tilecnt: int32 [tt_sg_tiles(n) + 1]; after it runs, tilecnt[tiles] is n_groups.
extern "C" int tt_sg_count(const int32_t* flag, const void* keys, int nkeys, const int32_t* perm,
                           int64_t n, int32_t* tilecnt, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || nkeys <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + kTile - 1) / kTile;
  sg_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(flag, (const KeyOps*)keys, nkeys, perm, n,
                                                       tilecnt);
  scan_excl<<<1, kScanThreads, 0, s>>>(tilecnt, tiles);
  return (int)cudaGetLastError();
}

// seg: int32 [n] in row order; kval / kvalid: int64 [nkeys, cap], filled
// by the caller with INT64_MIN / -1.
extern "C" int tt_sg_segments(const int32_t* flag, const void* keys, int nkeys,
                              const int32_t* perm, int64_t n, const int32_t* tilecnt, int64_t cap,
                              int32_t* seg, long long* kval, long long* kvalid, void* stream) {
  if (n <= 0 || nkeys <= 0 || cap <= 0 || cap > 0x7fffffffLL) return -1;
  const int64_t tiles = (n + kTile - 1) / kTile;
  sg_segments_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      flag, (const KeyOps*)keys, nkeys, perm, n, tilecnt, cap, seg, kval, kvalid);
  return (int)cudaGetLastError();
}
