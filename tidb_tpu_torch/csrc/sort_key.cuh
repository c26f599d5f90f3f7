// The order-preserving unsigned key of a sort operand, shared by K8
// (csrc/lex_sort.cu) and K7 (csrc/topn_multi.cu): two values compare as
// lax.sort compares them exactly when their keys compare as unsigned
// 64-bit integers.
//
//   I32  x ^ 0x80000000 (as uint32)
//   I64  x ^ 2^63
//   U64  x
//   F64  lax.sort's order: -0.0 folds to +0.0 and every NaN to one +NaN
//        (jax/_src/lax/lax.py _canonicalize_float_for_sort), then the
//        IEEE total order: negative -> ~bits, else bits | 2^63. NaN sorts
//        after +inf. XLA evaluates that fold's x == 0 with subnormals
//        flushed (on the CPU as on the TPU), so every subnormal folds to
//        +0.0 too: |x| < DBL_MIN is zero here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace sort_key {

enum Kind : int32_t { K_I32 = 0, K_I64 = 1, K_U64 = 2, K_F64 = 3 };

constexpr unsigned long long kSign = 0x8000000000000000ULL;
constexpr double kDblMin = 2.2250738585072014e-308;  // smallest normal double

// The key of a float64 value.
__device__ __forceinline__ unsigned long long of_f64(double x) {
  unsigned long long b;
  if (fabs(x) < kDblMin)  // zeros and subnormals
    b = 0ULL;
  else if (x != x)
    b = 0x7ff8000000000000ULL;
  else
    b = (unsigned long long)__double_as_longlong(x);
  return (b & kSign) ? ~b : (b | kSign);
}

// The key of element `row` of a lane of `kind`, each kind loaded apart
// (K8's key build).
__device__ __forceinline__ unsigned long long load_key(const void* data, int32_t kind, int64_t row) {
  switch (kind) {
    case K_I32:
      return (unsigned long long)(uint32_t)(((const int32_t*)data)[row] ^ (int32_t)0x80000000);
    case K_I64:
      return (unsigned long long)((const long long*)data)[row] ^ kSign;
    case K_U64:
      return (unsigned long long)((const long long*)data)[row];
    default:
      return of_f64(((const double*)data)[row]);
  }
}

// The bits of element `row` of a lane of `kind` (4 bytes for I32, else 8).
__device__ __forceinline__ unsigned long long load_bits(const void* data, int32_t kind, int64_t row) {
  return kind == K_I32 ? (unsigned long long)(uint32_t)((const int32_t*)data)[row]
                       : (unsigned long long)((const long long*)data)[row];
}

}  // namespace sort_key
}  // namespace
