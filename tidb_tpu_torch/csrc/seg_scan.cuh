// The lane ops of the segmented run aggregations, shared by P5
// (seg_reduce.cu) and P7 (run_agg.cu): their sentinels, identities and
// combines. Both run one sweep over their rows with decoupled look-back
// carries (compact.cuh's look_back): P5 forward over the sorted rows, P7
// backward over its stream (a run's suffix sums).
//
// Lane l's value at a row is x = ok ? data_l : null_bits(op) (a count
// lane: ok ? 1 : 0), ok the row's mask and lane valid. null_bits is the
// reference's sentinel of a row without ok (0 for sums, where(ok, d,
// big)'s big for min / max).
//
// The combines: count and integer sums add modulo 2^64 (the reference's
// differences of wrapped prefixes, bit for bit); float sums add in a
// fixed order (deterministic; they differ from prefix differences by
// rounding only); min / max compare signed, unsigned (uint64 bits) or as
// floats with a NaN winning (jnp.minimum / jnp.maximum propagate NaN).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace seg_scan {

typedef long long ll;
typedef unsigned long long ull;

constexpr int MAXL = 32;
constexpr ll I64_MAX = 0x7fffffffffffffffLL;
constexpr ull I64_MIN_BITS = 0x8000000000000000ULL;
constexpr ull INF_BITS = 0x7ff0000000000000ULL;
constexpr ull NINF_BITS = 0xfff0000000000000ULL;
constexpr ull QNAN_BITS = 0x7ff8000000000000ULL;

enum Op : int {
  OP_COUNT = 0, OP_SUM_I64 = 1, OP_SUM_U64 = 2, OP_SUM_F64 = 3, OP_MIN_I64 = 4, OP_MAX_I64 = 5,
  OP_MIN_U64 = 6, OP_MAX_U64 = 7, OP_MIN_F64 = 8, OP_MAX_F64 = 9,
};

__host__ __device__ __forceinline__ bool is_sum(int op) { return op <= OP_SUM_F64; }

__device__ __forceinline__ double f64(ull b) { return __longlong_as_double((ll)b); }
__device__ __forceinline__ ull bits(double x) { return (ull)__double_as_longlong(x); }

// the value a row with mask & ~valid folds (the reference's sentinel)
__device__ __forceinline__ ull null_bits(int op) {
  switch (op) {
    case OP_MIN_I64: case OP_MIN_U64: return (ull)I64_MAX;
    case OP_MAX_I64: case OP_MAX_U64: return I64_MIN_BITS;
    case OP_MIN_F64: return INF_BITS;
    case OP_MAX_F64: return NINF_BITS;
    default: return 0ULL;
  }
}

__device__ __forceinline__ ull identity(int op) {
  switch (op) {
    case OP_MIN_U64: return ~0ULL;
    case OP_MAX_U64: return 0ULL;
    default: return null_bits(op);
  }
}

__device__ __forceinline__ ull combine(int op, ull a, ull b) {
  switch (op) {
    case OP_SUM_F64: return bits(f64(a) + f64(b));
    case OP_MIN_I64: return (ll)a < (ll)b ? a : b;
    case OP_MAX_I64: return (ll)a > (ll)b ? a : b;
    case OP_MIN_U64: return a < b ? a : b;
    case OP_MAX_U64: return a > b ? a : b;
    case OP_MIN_F64: {
      const double x = f64(a), y = f64(b);
      if (x != x) return a;
      if (y != y) return b;
      return y < x ? b : a;
    }
    case OP_MAX_F64: {
      const double x = f64(a), y = f64(b);
      if (x != x) return a;
      if (y != y) return b;
      return y > x ? b : a;
    }
    default: return a + b;  // count and integer sums, modulo 2^64
  }
}

}  // namespace seg_scan
}  // namespace
