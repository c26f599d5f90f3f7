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

struct KeyDesc {  // kernels/topn_multi.py packs these as int64 5-tuples
  const void* data;
  const uint8_t* valid;  // null = all valid
  int32_t kind;
  int32_t desc;
  int32_t* null_out;
  void* val_out;
};

__global__ void topn_multi_ops_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                      const KeyDesc* __restrict__ keys, int nkeys,
                                      int32_t* __restrict__ flag) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    flag[i] = mask[i] ? 0 : 1;
    for (int j = 0; j < nkeys; ++j) {
      const KeyDesc& K = keys[j];
      const bool v = K.valid == nullptr || K.valid[i] != 0;
      K.null_out[i] = (K.desc ? !v : v) ? 1 : 0;
      if (K.kind == K_I32) {
        int32_t x = v ? ((const int32_t*)K.data)[i] : 0;
        ((int32_t*)K.val_out)[i] = K.desc ? ~x : x;
      } else if (K.kind == K_F64) {
        double x = v ? ((const double*)K.data)[i] : 0.0;
        ((double*)K.val_out)[i] = K.desc ? -x : x;
      } else {
        long long x = v ? ((const long long*)K.data)[i] : 0LL;
        ((long long*)K.val_out)[i] = K.desc ? ~x : x;
      }
    }
  }
}

}  // namespace

extern "C" int tt_topn_multi_ops(const uint8_t* mask, int64_t n, const void* keys, int nkeys,
                                 int32_t* flag, int n_sms, void* stream) {
  if (n < 0 || nkeys < 0) return -1;
  if (n == 0) return 0;
  int64_t blocks = (n + 255) / 256;
  const int64_t cap = (int64_t)(n_sms > 0 ? n_sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  topn_multi_ops_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      mask, n, (const KeyDesc*)keys, nkeys, flag);
  return (int)cudaGetLastError();
}
