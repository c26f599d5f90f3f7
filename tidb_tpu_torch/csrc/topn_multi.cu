// K7 topn_multi: the sort operands of a multi-key TopN, in one pass.
//
// Replaces the operand build of tidb_tpu/copr/tpu_engine.py:1812-1828
// (TPUEngine._lower_topn_multi's kernel). Per row i it writes
//
//   flag[i]          = !mask[i]                 (int32: masked rows last)
//   per key j:
//     null_j[i]      = DESC ? !v : v            (int32: NULLs first ASC,
//                                                last DESC)
//     val_j[i]       = v ? d : 0, then for DESC -x (float) or ~x (int);
//                      the key's own width and kind
//
// K8 (csrc/lex_sort.cu) then sorts rows by (flag, null_0, val_0, ...)
// and the engine keeps the first n row ids with their mask bits.
//
// Task-grid mode (K10's multi-key TopN, tidb_tpu/copr/tpu_engine.py:
// 1096-1134 vmapping the kernel above over a launch group): G tasks, the
// grid's y axis the task, each through its row of the task table (its
// mask and key lanes, read to the group's `width`), their operands into
// slice y of [G, width] lanes; K8's task-leading mode sorts them by (task,
// operands), and task y's first min(n, width) sorted rows are its answer.
// The solo mode is G = 1.
//
// Bound: bytes. It reads the mask byte and each key's data and valid byte
// once, and writes 4 bytes of flag plus 4 + 4/8 bytes per key.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launch (0 = success) or -1
// for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3 };

// Host-built table (kernels/topn_multi.py packs it as int64): G task rows
// of 1 + 2 * nkeys addresses (mask, then per key its data and its valid
// lane, 0 = all valid), then nkeys KeyDesc rows shared by the tasks.
struct KeyDesc {
  int32_t kind;
  int32_t desc;
  int32_t* null_out;  // [G * width]
  void* val_out;      // [G * width], the key's own width
};

// Task blockIdx.y's rows 0..width into slice y of the outputs.
__global__ void topn_multi_ops_kernel(const long long* __restrict__ tasks, int64_t width,
                                      const KeyDesc* __restrict__ keys, int nkeys,
                                      int32_t* __restrict__ flag) {
  const long long* T = tasks + (int64_t)blockIdx.y * (1 + 2 * nkeys);
  const uint8_t* mask = (const uint8_t*)T[0];
  const int64_t base = (int64_t)blockIdx.y * width;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t o = base + i;
    flag[o] = mask[i] ? 0 : 1;
    for (int j = 0; j < nkeys; ++j) {
      const KeyDesc& K = keys[j];
      const void* data = (const void*)T[1 + 2 * j];
      const uint8_t* valid = (const uint8_t*)T[2 + 2 * j];
      const bool v = valid == nullptr || valid[i] != 0;
      K.null_out[o] = (K.desc ? !v : v) ? 1 : 0;
      if (K.kind == K_I32) {
        int32_t x = v ? ((const int32_t*)data)[i] : 0;
        ((int32_t*)K.val_out)[o] = K.desc ? ~x : x;
      } else if (K.kind == K_F64) {
        double x = v ? ((const double*)data)[i] : 0.0;
        ((double*)K.val_out)[o] = K.desc ? -x : x;
      } else {
        long long x = v ? ((const long long*)data)[i] : 0LL;
        ((long long*)K.val_out)[o] = K.desc ? ~x : x;
      }
    }
  }
}

}  // namespace

// The operands of G tasks (tasks / keys: the table above; flag and every
// key's outputs [G * width]).
extern "C" int tt_topn_multi_ops(const void* tasks, int G, int64_t width, const void* keys,
                                 int nkeys, int32_t* flag, int n_sms, void* stream) {
  if (width < 0 || nkeys < 0 || G < 1 || G > 65535) return -1;
  if (width == 0) return 0;
  int64_t blocks = (width + 255) / 256;
  const int64_t per_task = ((int64_t)(n_sms > 0 ? n_sms : 132) * 16 + G - 1) / G;
  if (blocks > per_task) blocks = per_task;
  topn_multi_ops_kernel<<<dim3((unsigned)blocks, (unsigned)G), 256, 0, (cudaStream_t)stream>>>(
      (const long long*)tasks, width, (const KeyDesc*)keys, nkeys, flag);
  return (int)cudaGetLastError();
}
