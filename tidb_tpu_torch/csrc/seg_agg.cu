// K4 seg_agg: masked direct-address GROUP BY partials.
//
// Replaces the aggregation kernel of tidb_tpu/copr/tpu_engine.py:1287-1304
// (TPUEngine._lower_agg.kernel) with its reductions _seg_sum / _seg_min /
// _seg_max (:175-193) and the per-function partials of
// _agg_partials_device (:1527-1617). Per row i:
//
//   code = mixed radix over the key lanes: code = code*(dom+1) + kd,
//          kd = key - lo + 1 for a valid key, 0 (the NULL slot) otherwise;
//          or, in the precomputed-segment mode of the sort-based GROUP BY
//          (tpu_engine.py:1380-1399), the row's id from K9's segment lane
//          (csrc/sort_groups.cu), rows at or beyond nseg dropped
//   rows with mask[i] == 0 go to the overflow slot nseg, i.e. are dropped
//   every value lane k with ok = valid_k[i] folds its value into
//   out[k][code] with the lane's op (a row without ok is skipped):
//
//   COUNT      += 1                              -> int64 row
//   SUM_I64    += x, two's-complement wrap (atomicAdd on unsigned long
//                 long), the wrap XLA's int64 segment sums have
//   SUM_F64    += x (order differs from XLA's: floats agree within the
//                 reference's own rtol 1e-9 / atol 1e-6, not bit for bit)
//   MIN/MAX_I64, MIN/MAX_U64 (unsigned order on uint64 bit patterns),
//   MIN/MAX_F64 (compare-and-swap loop; a NaN wins and stays, as XLA's
//                 min/max propagate NaN)
//   FIRST_ROW  min row index i over rows with ok, n for a masked-in row
//              without (the reference's where(ok, i, n))  -> int64 row
//   AND/OR/XOR_I64  &= | |= | ^= x (64-bit atomicAnd / atomicOr /
//              atomicXor): bit_and / bit_or / bit_xor, which the
//              reference reduces per bit over 64 lanes and recombines by
//              shifts (tpu_engine.py:1596-1617); their fills are their
//              identities -1 / 0 / 0, what the reference's per-bit
//              identities give an empty segment
//
// Empty segments keep the lane's fill (the reference's sentinel in the
// lane's own dtype: iinfo(dtype).max for MIN over an int32 dict-code lane,
// uint64 max bits for MIN_U64, +inf for MIN_F64, N for FIRST_ROW, 0 for
// sums and counts). Results land directly in the packed [k_i, nseg] int64
// and [k_f, nseg] float64 matrices the engine ships to the host.
//
// Bound: bytes. Each row reads its mask byte, its key lanes and, per value
// lane, 8 bytes of data plus one valid byte; outputs are k*nseg*8 bytes.
// The atomics are the risk, not the bytes: TPC-H Q1 has nseg = 12 and
// every row hits one of ~6 live slots. So when all lanes' slots fit in
// 48 KB of shared memory (the SEG_DENSE_MAX regime, tpu_engine.py:168),
// each block privatises them, accumulates with shared-memory atomics and
// merges once into global memory; larger nseg (up to 65536 direct, or
// the sort path's group capacity: 4,194,304 for TPC-H Q18's GROUP BY
// l_orderkey at 16M rows) atomically updates global memory directly. Warp-level pre-aggregation is left for
// a later change.
//
// Task-grid mode (K10's reduction, tidb_tpu/copr/tpu_engine.py:1096-1134
// _vmapped_program over the kernel above): one launch reduces G tasks of a
// launch group, the grid's y axis the task. A task table (TaskAgg: the
// task's mask, key and lane descriptors and its output slices) sits in
// device memory; each task reduces its first `width` rows (the group's
// narrowed width: rows past a task's real rows are masked, so dropping
// them changes no bit) into its own [k_i, nseg] / [k_f, nseg] slice of
// the [G, k_i, nseg] / [G, k_f, nseg] outputs. The shared-memory
// privatisation is per (block, task), with the same merge, and the
// bitwise ops are the same atomics. A sort GROUP BY's launch group reads
// each task's row of K9's task-grid segment lane instead of keys: the
// group ids run on across the tasks, so every task folds into ONE shared
// [k_i, nseg] / [k_f, nseg] pair (nseg = the group's total n_groups),
// filled once; a task's rows reach only its own segments.
//
// Plain C interface (nvcc + ctypes). tt_seg_agg launches an init kernel
// and the aggregation kernel on the given stream, never synchronizes, and
// returns the cudaError_t of the launches (0 = success), or -1 for an
// argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Host-built descriptor tables (an int64 tensor on the card, laid out as
// these structs; kernels/seg_agg.py packs them).
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

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_float_op(int32_t op) {
  return op == OP_SUM_F64 || op == OP_MIN_F64 || op == OP_MAX_F64;
}

__device__ __forceinline__ bool nan64(double x) { return x != x; }

__device__ __forceinline__ void atomic_min_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    double cur = __longlong_as_double((long long)assumed);
    bool better = nan64(v) ? !nan64(cur) : (v < cur);
    if (!better) return;
    old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
  } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f64(double* addr, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    double cur = __longlong_as_double((long long)assumed);
    bool better = nan64(v) ? !nan64(cur) : (v > cur);
    if (!better) return;
    old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
  } while (old != assumed);
}

// Fold one value into a slot (shared or global memory alike). `raw` is
// the lane's 8 data bytes for row i (unused by COUNT / FIRST_ROW).
__device__ __forceinline__ void fold(int32_t op, unsigned long long* slot, int64_t raw,
                                     int64_t row) {
  switch (op) {
    case OP_COUNT:
      atomicAdd(slot, 1ULL);
      break;
    case OP_SUM_I64:
      atomicAdd(slot, (unsigned long long)raw);
      break;
    case OP_SUM_F64:
      atomicAdd(reinterpret_cast<double*>(slot), __longlong_as_double(raw));
      break;
    case OP_MIN_I64:
      atomicMin(reinterpret_cast<long long*>(slot), (long long)raw);
      break;
    case OP_MAX_I64:
      atomicMax(reinterpret_cast<long long*>(slot), (long long)raw);
      break;
    case OP_MIN_U64:
      atomicMin(slot, (unsigned long long)raw);
      break;
    case OP_MAX_U64:
      atomicMax(slot, (unsigned long long)raw);
      break;
    case OP_MIN_F64:
      atomic_min_f64(reinterpret_cast<double*>(slot), __longlong_as_double(raw));
      break;
    case OP_MAX_F64:
      atomic_max_f64(reinterpret_cast<double*>(slot), __longlong_as_double(raw));
      break;
    case OP_FIRST_ROW:
      atomicMin(reinterpret_cast<long long*>(slot), (long long)row);
      break;
    case OP_AND_I64:
      atomicAnd(slot, (unsigned long long)raw);
      break;
    case OP_OR_I64:
      atomicOr(slot, (unsigned long long)raw);
      break;
    case OP_XOR_I64:
      atomicXor(slot, (unsigned long long)raw);
      break;
  }
}

__device__ __forceinline__ unsigned long long* out_slot(const LaneDesc& L, int64_t* iout,
                                                        double* fout, int64_t nseg,
                                                        int64_t seg) {
  return is_float_op(L.op)
             ? reinterpret_cast<unsigned long long*>(fout + (int64_t)L.out * nseg + seg)
             : reinterpret_cast<unsigned long long*>(iout + (int64_t)L.out * nseg + seg);
}

// Segment of row i, or -1 when the row is masked out. With a
// precomputed segment lane (K9's group ids) the row's id is read, and an
// id at or beyond nseg (the overflow slot) drops the row too.
__device__ __forceinline__ int64_t row_segment(const uint8_t* __restrict__ mask,
                                               const int32_t* __restrict__ seg,
                                               const KeyDesc* __restrict__ keys, int nkeys,
                                               int64_t nseg, int64_t i) {
  if (!mask[i]) return -1;
  if (seg != nullptr) {
    const int64_t s = seg[i];
    return s < nseg ? s : -1;
  }
  int64_t code = 0;
  for (int k = 0; k < nkeys; ++k) {
    const KeyDesc& K = keys[k];
    int64_t kd = 0;
    if (K.valid == nullptr || K.valid[i]) {
      int64_t kv = K.elem_bytes == 4 ? (int64_t)((const int32_t*)K.data)[i]
                                     : ((const int64_t*)K.data)[i];
      kd = kv - K.lo + 1;
    }
    code = code * (K.dom + 1) + kd;
  }
  return code;
}

__device__ __forceinline__ void fold_row(const LaneDesc* __restrict__ lanes, int nlanes,
                                         int64_t i, int64_t n, int64_t seg,
                                         unsigned long long* base, int64_t nseg,
                                         int64_t* iout, double* fout) {
  for (int k = 0; k < nlanes; ++k) {
    const LaneDesc& L = lanes[k];
    int64_t row = i;
    if (L.valid != nullptr && !L.valid[i]) {
      // a row whose value is NULL adds nothing — except to FIRST_ROW,
      // where the reference folds the out-of-range index n for it
      if (L.op != OP_FIRST_ROW) continue;
      row = n;
    }
    int64_t raw = L.data != nullptr ? ((const int64_t*)L.data)[i] : 0;
    unsigned long long* slot =
        base != nullptr ? base + (int64_t)k * nseg + seg : out_slot(L, iout, fout, nseg, seg);
    fold(L.op, slot, raw, row);
  }
}

__global__ void init_kernel(const LaneDesc* __restrict__ lanes, int nlanes, int64_t nseg,
                            int64_t* iout, double* fout) {
  int64_t total = (int64_t)nlanes * nseg;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const LaneDesc& L = lanes[t / nseg];
    *out_slot(L, iout, fout, nseg, t % nseg) = (unsigned long long)L.fill;
  }
}

// nseg * nlanes slots privatised per block in dynamic shared memory.
__global__ void seg_agg_shared_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                      const int32_t* __restrict__ segs,
                                      const KeyDesc* __restrict__ keys, int nkeys,
                                      const LaneDesc* __restrict__ lanes, int nlanes,
                                      int64_t nseg, int64_t* iout, double* fout) {
  extern __shared__ unsigned long long acc[];
  int64_t total = (int64_t)nlanes * nseg;
  for (int64_t t = threadIdx.x; t < total; t += blockDim.x)
    acc[t] = (unsigned long long)lanes[t / nseg].fill;
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t seg = row_segment(mask, segs, keys, nkeys, nseg, i);
    if (seg < 0) continue;
    fold_row(lanes, nlanes, i, n, seg, acc, nseg, iout, fout);
  }
  __syncthreads();
  // merge the block's partials; a slot still at its fill is the identity
  // of its op (the bitwise ops take no other fill), so folding it changes
  // nothing and is skipped. COUNT and
  // FIRST_ROW fold a value, not a row, here: sum the count, min the row.
  for (int64_t t = threadIdx.x; t < total; t += blockDim.x) {
    const LaneDesc& L = lanes[t / nseg];
    unsigned long long v = acc[t];
    if (v == (unsigned long long)L.fill) continue;
    unsigned long long* slot = out_slot(L, iout, fout, nseg, t % nseg);
    if (L.op == OP_COUNT)
      atomicAdd(slot, v);
    else if (L.op == OP_FIRST_ROW)
      atomicMin(reinterpret_cast<long long*>(slot), (long long)v);
    else
      fold(L.op, slot, (int64_t)v, 0);
  }
}

__global__ void seg_agg_global_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                      const int32_t* __restrict__ segs,
                                      const KeyDesc* __restrict__ keys, int nkeys,
                                      const LaneDesc* __restrict__ lanes, int nlanes,
                                      int64_t nseg, int64_t* iout, double* fout) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t seg = row_segment(mask, segs, keys, nkeys, nseg, i);
    if (seg < 0) continue;
    fold_row(lanes, nlanes, i, n, seg, nullptr, nseg, iout, fout);
  }
}

// One task's entry of the task table (kernels/grouped.py lays it out).
struct TaskAgg {
  const uint8_t* mask;    // bool [>= width]
  const int32_t* seg;     // precomputed segment lane, or null (key lanes)
  const KeyDesc* keys;    // [nkeys]
  const LaneDesc* lanes;  // [nlanes]
  int64_t* iout;          // this task's [k_i, nseg] slice
  double* fout;           // this task's [k_f, nseg] slice
};

__global__ void init_tasks_kernel(const TaskAgg* __restrict__ tasks, int nlanes, int64_t nseg) {
  const TaskAgg T = tasks[blockIdx.y];
  int64_t total = (int64_t)nlanes * nseg;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const LaneDesc& L = T.lanes[t / nseg];
    *out_slot(L, T.iout, T.fout, nseg, t % nseg) = (unsigned long long)L.fill;
  }
}

__global__ void seg_agg_tasks_shared_kernel(const TaskAgg* __restrict__ tasks, int64_t width,
                                            int nkeys, int nlanes, int64_t nseg) {
  extern __shared__ unsigned long long acc[];
  const TaskAgg T = tasks[blockIdx.y];
  int64_t total = (int64_t)nlanes * nseg;
  for (int64_t t = threadIdx.x; t < total; t += blockDim.x)
    acc[t] = (unsigned long long)T.lanes[t / nseg].fill;
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t seg = row_segment(T.mask, T.seg, T.keys, nkeys, nseg, i);
    if (seg < 0) continue;
    fold_row(T.lanes, nlanes, i, width, seg, acc, nseg, T.iout, T.fout);
  }
  __syncthreads();
  for (int64_t t = threadIdx.x; t < total; t += blockDim.x) {
    const LaneDesc& L = T.lanes[t / nseg];
    unsigned long long v = acc[t];
    if (v == (unsigned long long)L.fill) continue;
    unsigned long long* slot = out_slot(L, T.iout, T.fout, nseg, t % nseg);
    if (L.op == OP_COUNT)
      atomicAdd(slot, v);
    else if (L.op == OP_FIRST_ROW)
      atomicMin(reinterpret_cast<long long*>(slot), (long long)v);
    else
      fold(L.op, slot, (int64_t)v, 0);
  }
}

__global__ void seg_agg_tasks_global_kernel(const TaskAgg* __restrict__ tasks, int64_t width,
                                            int nkeys, int nlanes, int64_t nseg) {
  const TaskAgg T = tasks[blockIdx.y];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t seg = row_segment(T.mask, T.seg, T.keys, nkeys, nseg, i);
    if (seg < 0) continue;
    fold_row(T.lanes, nlanes, i, width, seg, nullptr, nseg, T.iout, T.fout);
  }
}

}  // namespace

// Largest shared-memory footprint the privatised path uses (the static
// 48 KB limit, so no opt-in attribute is needed).
extern "C" int64_t tt_seg_agg_shared_max_bytes() { return 48 * 1024; }

extern "C" int tt_seg_agg(const uint8_t* mask, int64_t n, const int32_t* segs,
                          const void* keys, int nkeys,
                          const void* lanes, int nlanes, int64_t nseg, int64_t* iout,
                          double* fout, int n_sms, void* stream) {
  if (nseg <= 0 || nlanes <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const KeyDesc* K = (const KeyDesc*)keys;
  const LaneDesc* L = (const LaneDesc*)lanes;
  int64_t slots = (int64_t)nlanes * nseg;
  int64_t init_blocks = (slots + kThreads - 1) / kThreads;
  if (init_blocks > 65536) init_blocks = 65536;
  init_kernel<<<(unsigned)init_blocks, kThreads, 0, s>>>(L, nlanes, nseg, iout, fout);
  int err = (int)cudaGetLastError();
  if (err != 0 || n <= 0) return err;
  int64_t row_blocks = (n + kThreads - 1) / kThreads;
  int64_t smem = slots * 8;
  if (smem <= tt_seg_agg_shared_max_bytes()) {
    // a few blocks per SM: enough to hide latency, few enough that the
    // merge of each block's private slots stays cheap
    int64_t blocks = (int64_t)(n_sms > 0 ? n_sms : 132) * 8;
    if (blocks > row_blocks) blocks = row_blocks;
    seg_agg_shared_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(
        mask, n, segs, K, nkeys, L, nlanes, nseg, iout, fout);
  } else {
    if (row_blocks > ((int64_t)1 << 30)) row_blocks = (int64_t)1 << 30;
    seg_agg_global_kernel<<<(unsigned)row_blocks, kThreads, 0, s>>>(
        mask, n, segs, K, nkeys, L, nlanes, nseg, iout, fout);
  }
  return (int)cudaGetLastError();
}

// shared_out: every task's output slices are one [k_i, nseg] / [k_f,
// nseg] pair (segment lanes numbering the groups on across the tasks),
// filled once.
extern "C" int tt_seg_agg_tasks(const void* tasks, int G, int64_t width, int nkeys, int nlanes,
                                int64_t nseg, int shared_out, int n_sms, void* stream) {
  if (nseg <= 0 || nlanes <= 0 || G < 1 || G > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const TaskAgg* T = (const TaskAgg*)tasks;
  int64_t slots = (int64_t)nlanes * nseg;
  int64_t init_blocks = (slots + kThreads - 1) / kThreads;
  if (init_blocks > 65535) init_blocks = 65535;
  init_tasks_kernel<<<dim3((unsigned)init_blocks, shared_out ? 1u : (unsigned)G), kThreads, 0, s>>>(
      T, nlanes, nseg);
  int err = (int)cudaGetLastError();
  if (err != 0 || width <= 0) return err;
  int64_t row_blocks = (width + kThreads - 1) / kThreads;
  int64_t smem = slots * 8;
  if (smem <= tt_seg_agg_shared_max_bytes()) {
    // the solo mode's few blocks per SM, shared out over the tasks
    int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 8 + G - 1) / G;
    int64_t blocks = row_blocks < per_task ? row_blocks : per_task;
    seg_agg_tasks_shared_kernel<<<dim3((unsigned)blocks, (unsigned)G), kThreads, (size_t)smem, s>>>(
        T, width, nkeys, nlanes, nseg);
  } else {
    if (row_blocks > 65535) row_blocks = 65535;
    seg_agg_tasks_global_kernel<<<dim3((unsigned)row_blocks, (unsigned)G), kThreads, 0, s>>>(
        T, width, nkeys, nlanes, nseg);
  }
  return (int)cudaGetLastError();
}
