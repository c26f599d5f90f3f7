// K2/K3 + P1 expr_eval: one launch evaluates a compiled expression
// program over every row.
//
// Replaces the device evaluation of tidb_tpu/copr/tpu_engine.py:1021
// (_eval_device) and :1044 (_mask) inside the filter program
// (:1138-1158), the aggregation program's argument lanes (:1287-1304,
// :1527-1617) and the TopN keys (:1762, :1818); and of the MPP program's
// scan stage (tidb_tpu/parallel/mpp.py:1431), post-join conditions
// (:1557, :1649) and aggregate arguments (:1678, :1879, :2050). XLA fuses
// each tree into its program; here the host compiles the tree once
// (tidb_tpu_torch/expr/program.py) into a typed register program, and
// this kernel interprets it.
//
// Bound: bytes. Each row reads its input lanes (8 bytes a data lane, 4 a
// dict-code lane, 1 a valid lane) and writes its outputs (8 or 1 bytes).
// An interpreter stands between a kernel and that bound twice: each op's
// decode and dispatch, and a register file in shared memory that every
// op reads and writes. The design:
//
//   * U = 4 rows per thread. A thread takes U consecutive rows at a time;
//     each op is decoded and dispatched once for its U rows, and each of
//     its register reads serves U rows. A warp's U-row groups are
//     adjacent, so its loads stay coalesced: an 8-byte lane is read as two
//     16-byte loads a thread, a 4-byte lane as one, a byte lane as one
//     4-byte load (scalar loads at the end of a lane or for a lane that is
//     not 16-byte aligned); stores likewise.
//   * Loads ahead of arithmetic. The compiler emits a program's lane loads
//     first (expr/program.py); the kernel runs that prefix as a load
//     phase, one load op's U rows in flight at a time (four independent
//     loads a thread, 32 warps an SM), before any arithmetic. Holding more
//     ops' rows in flight costs a thread registers or a block shared
//     memory, and on the card that lost more than it gained: two ops' rows
//     in registers spilled, and cp.async copies of every op's rows into
//     shared memory (no registers held) ran slower than loads op by op and
//     their staging cost a block an SM (PERF.md, Findings). A program that
//     reloads its lanes (one past its register budget) keeps its loads
//     where they are, each issuing U independent loads.
//   * The register file in shared memory: data [register][U][thread] (8
//     bytes, conflict-free), validity [register][thread] as one byte of U
//     bits, so three-valued logic and the NULL propagation of arithmetic
//     are one bitwise op for U rows. The host sizes the block from the
//     program's registers (nregs * (8U + 1) bytes a thread) and launches
//     enough blocks to fill every SM (kernels/expr_eval.py launch_shape).
//   * At block start the constant pool, the lane pointers and (when they
//     fit) the ops are copied into shared memory, so every warp reads the
//     same op and takes the same branch.
//
//   * Two instantiations. The ops past arithmetic, compares and logic
//     (integer and float division, the selects of CASE / IF / COALESCE,
//     rounding, the math and date functions, the bit operators: from
//     EXT_FIRST on) are compiled into expr_eval_kernel<true> only; a
//     program without them (Q1's, Q6's, the checksum's) runs
//     expr_eval_kernel<false>, whose dispatch and registers are those of
//     the kernel before them. The host picks one (Params.ext_ops).
//
// Per row group the thread computes every condition into the mask and
// every value output, and stores each output once: one launch per
// program, where the reference's trace issued one array op per tree node.
//
// Arithmetic, as the reference's jitted XLA CPU program computes it:
//   * int64 adds, subtracts and multiplies wrap (done in unsigned);
//   * doubles with __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, but
//     where XLA's CPU contracts a multiply-add (FFMA, an add or subtract
//     of a product with no other use; the float MOD): __fma_rn; a
//     subnormal operand reads as zero of its sign
//     and a subnormal result is flushed (XLA CPU's DAZ/FTZ); negation
//     flips the sign bit only; a division by a constant is a multiply by
//     its reciprocal (FMULK), as XLA rewrites it;
//   * uint64 -> double rounds once (__ull2double_rn); double -> int64
//     saturates, NaN -> 0 (F2I truncates, RINT rounds half to even);
//   * comparisons in the domain the compiler chose: signed, unsigned,
//     double (NaN: only `ne` holds) or mixed signed/unsigned (class, lo).
//
// Task-grid mode (K10, tidb_tpu/copr/tpu_engine.py:1096-1134): the same
// kernel body over G tasks of a launch group, one launch; each task's
// lanes are read through its row of the pointer tables, the first `n`
// (the group's narrowed width) rows of each.
//
// Plain C interface (nvcc + ctypes): kernels/expr_eval.py fills a Params
// struct; tt_expr_eval launches on the given stream, never synchronizes,
// and returns the cudaError_t of the launch (0 = success), or -1 for an
// argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int MAX_PTRS = 192;
constexpr int U = 4;   // rows per thread (expr/program.py ROWS)
constexpr unsigned ALLV = (1u << U) - 1;

enum Code : int32_t {
  NOP = 0, LD8, LD4, LDB, LDK, I2F, U2F, F2I, RINT, FMULK, IMULK, RDIVK,
  IADD, ISUB, IMUL, FADD, FSUB, FMUL, INEG, FNEG, CMP, IN0, IN, INF,
  AND, OR, NOT, ISNULL, MASK, ZNULL, IHI, ILO, ST8, STV, STB,
  // the extended instantiation's ops (expr/program.py EXT_OPS), from EXT_FIRST on
  IDIV, RDIV, IFLOORK, IMODK, ITRUNCK, IABS, MAX, MIN, X2F, BAND, BOR, BXOR,
  BNOT, SHL, SHR, XOR, ISTRUE, ISFALSE, SEL, COAL, NULLIF, VAND, FDIV, FABS,
  FFLOOR, FCEIL, FTRUNC, FRNDA, FSIGN, FUN1, FUN2, FFMA
};
constexpr int EXT_FIRST = IDIV;
enum Dom : int32_t { DOM_I = 0, DOM_U = 1, DOM_F = 2, DOM_X = 3 };
// IDIV's aux; FDIV's modes (aux & 15, the product's second factor's register above);
// FUN1's functions (aux & 15, the domain above) and FUN2's (expr/program.py)
enum IdivMode : int32_t { IDIV_S = 0, IDIV_U = 1, IMOD_S = 2 };
enum FdivMode : int32_t { FDIV_PLAIN = 0, FDIV_GUARD = 1, FDIV_MOD = 2, FDIV_MODK = 3, FDIV_PRODUCT = 4 };
constexpr int FDIV_REG_SHIFT = 4;
// FFMA's aux: the flags below, the addend's register above FDIV_REG_SHIFT
enum FmaFlags : int32_t { FMA_NEG_PRODUCT = 1, FMA_NEG_ADDEND = 2 };
enum Fun1 : int32_t { F_SQRT = 0, F_EXP, F_LOG, F_SIN, F_COS, F_TAN, F_ASIN, F_ACOS, F_ATAN };
enum Fun1Dom : int32_t { D_ANY = 0, D_GE0 = 1, D_GT0 = 2 };
enum Fun2 : int32_t { F_POW = 0, F_ATAN2 = 1 };
constexpr int SEL_REG_BITS = 16;

struct Op {
  int32_t code, dst, a, b, aux;
};

struct KParams {
  const Op* ops;
  const ll* consts;
  const ll* ext_in;
  const ll* ext_out;
  ll n;
  int nops, nk, nregs, n_in, n_out, ops_in_smem, nld;
  ll in[MAX_PTRS];
  ll out[MAX_PTRS];
};

constexpr double DBL_MIN_NORMAL = 2.2250738585072014e-308;
constexpr double TWO63 = 9223372036854775808.0;

__device__ __forceinline__ double as_f(ll x) { return __longlong_as_double(x); }
__device__ __forceinline__ ll as_i(double x) { return __double_as_longlong(x); }

// XLA CPU's denormals-are-zero / flush-to-zero: a subnormal as a zero of
// its sign
__device__ __forceinline__ double daz(double x) { return fabs(x) < DBL_MIN_NORMAL ? copysign(0.0, x) : x; }

__device__ __forceinline__ ll sat_i64(double x) {
  if (x != x) return 0;
  if (x >= TWO63) return (ll)0x7FFFFFFFFFFFFFFFLL;
  if (x <= -TWO63) return (ll)(0x8000000000000000ULL);
  return (ll)x;
}

__device__ __forceinline__ bool nz(ll d, int is_float) { return is_float ? daz(as_f(d)) != 0.0 : d != 0; }

// exact integer division by a positive constant, half away from zero
// (expr/builtins._round_div: |INT64_MIN| wraps and floor-divides there)
__device__ __forceinline__ ll round_div(ll num, ll den) {
  const ll a = num < 0 ? (ll)(0ULL - (ull)num) : num;
  ll q = a / den;
  if (a % den != 0 && a < 0) --q;
  const ll r = (ll)((ull)a - (ull)q * (ull)den);
  if (2 * r >= den) ++q;
  return num < 0 ? (ll)(0ULL - (ull)q) : q;
}

__device__ __forceinline__ bool compare(int aux, ll a, ll b) {
  const int dom = aux & 3, pred = (aux >> 2) & 7;
  if (dom == DOM_F) {
    const double x = daz(as_f(a)), y = daz(as_f(b));
    switch (pred) {
      case 0: return x == y;
      case 1: return x != y;
      case 2: return x < y;
      case 3: return x <= y;
      case 4: return x > y;
      default: return x >= y;
    }
  }
  bool eq, lt;
  if (dom == DOM_U) {
    eq = a == b;
    lt = (ull)a < (ull)b;
  } else if (dom == DOM_X) {  // (class, lo): -1 negative signed, 0 below 2^63, +1 unsigned above
    const int ca = a < 0 ? ((aux >> 5) & 1 ? 1 : -1) : 0;
    const int cb = b < 0 ? ((aux >> 6) & 1 ? 1 : -1) : 0;
    eq = ca == cb && a == b;
    lt = ca < cb || (ca == cb && a < b);
  } else {
    eq = a == b;
    lt = a < b;
  }
  switch (pred) {
    case 0: return eq;
    case 1: return !eq;
    case 2: return lt;
    case 3: return lt || eq;
    case 4: return !(lt || eq);
    default: return !lt;
  }
}

// --- the extended instantiation's ops ------------------------------------
//
// Integer division is guarded as the reference guards it (a zero divisor
// reads 1, INT64_MIN / -1 is INT64_MIN, XLA's rule, where CUDA's is
// undefined); shifts by 64 or more, or by a negative count, give 0. Doubles
// follow XLA's CPU: operands flushed, results flushed, but for sin and tan
// and the operands of pow and atan2; max / min return a NaN operand as it
// is and order -0.0 below +0.0; a float MOD is one fused multiply-add, as
// XLA's CPU contracts a - trunc(a / b) * b.

__device__ __forceinline__ ll neg(ll x) { return (ll)(0ULL - (ull)x); }
__device__ __forceinline__ ll iabs(ll x) { return x < 0 ? neg(x) : x; }
__device__ __forceinline__ ll tdiv(ll a, ll b) { return b == -1 ? neg(a) : a / b; }

// jnp's floor division (b != 0)
__device__ __forceinline__ ll jfloordiv(ll a, ll b) {
  const ll q = tdiv(a, b);
  const ll r = (ll)((ull)a - (ull)q * (ull)b);
  return (r != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// expr/builtins._round_div over a divisor lane: half away from zero, with
// jnp's integer semantics (|INT64_MIN| wraps)
__device__ __forceinline__ ll round_div_lane(ll num, ll den) {
  const ll ds = den == 0 ? 1 : den;
  const ll an = iabs(num), ad = iabs(ds);
  ll q = jfloordiv(an, ad);
  const ll r = (ll)((ull)an - (ull)q * (ull)ad);
  if ((ll)((ull)r * 2ULL) >= ad) q = (ll)((ull)q + 1ULL);
  return ((num < 0) != (ds < 0)) ? neg(q) : q;
}

// floor division and modulo by a positive constant
__device__ __forceinline__ ll floordivk(ll a, ll k) {
  const ll q = a / k;
  return (a % k != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ double maxmin(double x, double y, bool is_max) {
  x = daz(x);
  y = daz(y);
  if (x != x) return x;
  if (y != y) return y;
  if (x == y) return (signbit(x) != 0) == is_max ? y : x;
  return (x > y) == is_max ? x : y;
}

__device__ __forceinline__ double fun1(int fn, double x) {
  switch (fn) {
    case F_SQRT: return sqrt(x);
    case F_EXP: return exp(x);
    case F_LOG: return log(x);
    case F_SIN: return sin(x);
    case F_COS: return cos(x);
    case F_TAN: return tan(x);
    case F_ASIN: return asin(x);
    case F_ACOS: return acos(x);
    default: return atan(x);
  }
}

// One op of the extended instantiation over a thread's U rows, read from
// and written to the register file. Inlined into expr_eval_kernel<true>
// only (a call an op ran FN_MIX's program 1.3x slower on the card: PERF.md,
// Findings); the base instantiation's dispatch never sees it.
__device__ __forceinline__ void ext_op(const Op o, ll* R, unsigned char* V, const ll* sk, int t, int T) {
#define XR(r, u) R[((ll)(r) * U + (u)) * T + t]
#define XV(r) V[(ll)(r) * T + t]
#define XU _Pragma("unroll") for (int u = 0; u < U; ++u)
  ll d[U];
  const unsigned va = XV(o.a);
  unsigned v = va;
  switch (o.code) {
    case IDIV: {
      const unsigned vb = XV(o.b);
      v = 0;
      XU {
        const ll a = XR(o.a, u), b = XR(o.b, u), bs = b == 0 ? 1 : b;
        if (o.aux == IDIV_U)
          d[u] = (ll)((ull)a / (ull)bs);
        else if (o.aux == IDIV_S)
          d[u] = tdiv(a, bs);
        else
          d[u] = (ll)((ull)a - (ull)tdiv(a, bs) * (ull)bs);
        if (b != 0) v |= 1u << u;
      }
      v &= va & vb;
      break;
    }
    case RDIV: {
      const unsigned vb = XV(o.b);
      v = 0;
      XU {
        const ll b = XR(o.b, u);
        d[u] = round_div_lane(XR(o.a, u), b);
        if (b != 0) v |= 1u << u;
      }
      v &= va & vb;
      break;
    }
    case IFLOORK: {
      const ll k = sk[o.b];
      XU d[u] = floordivk(XR(o.a, u), k);
      break;
    }
    case IMODK: {
      const ll k = sk[o.b];
      XU {
        const ll r = XR(o.a, u) % k;
        d[u] = r < 0 ? r + k : r;
      }
      break;
    }
    case ITRUNCK: {
      const ll k = sk[o.b];
      XU {
        const ll a = XR(o.a, u);
        const ll q = floordivk(iabs(a), k);
        d[u] = a < 0 ? neg(q) : (a == 0 ? 0 : q);
      }
      break;
    }
    case IABS:
      XU d[u] = o.aux ? (ll)(int32_t)(uint32_t)(ull)iabs(XR(o.a, u)) : iabs(XR(o.a, u));
      break;
    case MAX:
    case MIN: {
      const bool is_max = o.code == MAX;
      XU {
        const ll a = XR(o.a, u), b = XR(o.b, u);
        if (o.aux == DOM_F)
          d[u] = as_i(maxmin(as_f(a), as_f(b), is_max));
        else if (o.aux == DOM_U)
          d[u] = (((ull)a < (ull)b) == is_max) ? b : a;
        else
          d[u] = ((a < b) == is_max) ? b : a;
      }
      v = va & XV(o.b);
      break;
    }
    case X2F:
      XU {
        const ll a = XR(o.a, u);
        double f = __ll2double_rn(a);
        if (o.aux && a < 0) f = __dadd_rn(f, 18446744073709551616.0);
        d[u] = as_i(f);
      }
      break;
    case BAND:
      XU d[u] = XR(o.a, u) & XR(o.b, u);
      v = va & XV(o.b);
      break;
    case BOR:
      XU d[u] = XR(o.a, u) | XR(o.b, u);
      v = va & XV(o.b);
      break;
    case BXOR:
      XU d[u] = XR(o.a, u) ^ XR(o.b, u);
      v = va & XV(o.b);
      break;
    case BNOT:
      XU d[u] = ~XR(o.a, u);
      break;
    case SHL:
    case SHR:
      XU {
        const ll b = XR(o.b, u);
        const ull a = (ull)XR(o.a, u);
        d[u] = (b >= 0 && b < 64) ? (ll)(o.code == SHL ? a << (b & 63) : a >> (b & 63)) : 0;
      }
      v = va & XV(o.b);
      break;
    case XOR:
      XU d[u] = nz(XR(o.a, u), o.aux & 1) != nz(XR(o.b, u), (o.aux >> 1) & 1);
      v = va & XV(o.b);
      break;
    case ISTRUE:
    case ISFALSE:
      XU d[u] = (nz(XR(o.a, u), o.aux & 1) == (o.code == ISTRUE)) && ((va >> u) & 1);
      v = ALLV;
      break;
    case SEL: {
      const int c = o.aux & ((1 << SEL_REG_BITS) - 1), fl = (o.aux >> SEL_REG_BITS) & 1;
      const unsigned vc = XV(c), vb = XV(o.b);
      v = 0;
      XU {
        const bool cond = nz(XR(c, u), fl) && ((vc >> u) & 1);
        d[u] = cond ? XR(o.a, u) : XR(o.b, u);
        v |= ((cond ? va : vb) >> u & 1u) << u;
      }
      break;
    }
    case COAL: {
      const unsigned vb = XV(o.b);
      XU d[u] = ((va >> u) & 1) ? XR(o.a, u) : XR(o.b, u);
      v = va | vb;
      break;
    }
    case NULLIF: {
      const unsigned vb = XV(o.b);
      unsigned eq = 0;
      XU {
        d[u] = XR(o.a, u);
        eq |= (unsigned)(XR(o.b, u) != 0) << u;
      }
      v = va & ~(eq & vb) & ALLV;
      break;
    }
    case VAND:
      XU d[u] = XR(o.a, u);
      v = va & XV(o.b);
      break;
    case FDIV: {
      const int mode = o.aux & ((1 << FDIV_REG_SHIFT) - 1), c = o.aux >> FDIV_REG_SHIFT;
      v = va & XV(o.b);
      if (mode & FDIV_PRODUCT) v &= XV(c);
      unsigned okb = 0;
      XU {
        const double fa = daz(as_f(XR(o.a, u))), fb = daz(as_f(XR(o.b, u)));
        const bool ok = mode == FDIV_PLAIN || (mode & 3) == FDIV_MODK || fb != 0.0;
        okb |= (unsigned)ok << u;
        const double bs = ok ? fb : 1.0;
        if (mode == FDIV_PLAIN || mode == FDIV_GUARD) {
          d[u] = as_i(daz(__ddiv_rn(fa, bs)));
          continue;
        }
        double prod = fa, fk = 0.0;
        if (mode & FDIV_PRODUCT) {
          fk = daz(as_f(XR(c, u)));
          prod = daz(__dmul_rn(fa, fk));
        }
        const double q = (mode & 3) == FDIV_MODK ? daz(__dmul_rn(prod, __ddiv_rn(1.0, bs))) : daz(__ddiv_rn(prod, bs));
        const double tq = trunc(q);
        const double r = (mode & FDIV_PRODUCT) ? __fma_rn(fa, fk, -daz(__dmul_rn(tq, bs))) : __fma_rn(-tq, bs, fa);
        d[u] = as_i(daz(r));
      }
      v &= okb;
      break;
    }
    case FFMA: {  // (±a) * b + (±c) rounded once, as XLA's CPU contracts an add of a product
      const int c = o.aux >> FDIV_REG_SHIFT;
      v = va & XV(o.b) & XV(c);
      XU {
        const double x = daz(as_f(XR(o.a, u))), y = daz(as_f(XR(o.b, u))), z = daz(as_f(XR(c, u)));
        d[u] = as_i(daz(__fma_rn((o.aux & FMA_NEG_PRODUCT) ? -x : x, y, (o.aux & FMA_NEG_ADDEND) ? -z : z)));
      }
      break;
    }
    case FABS:
      XU d[u] = XR(o.a, u) & 0x7FFFFFFFFFFFFFFFLL;
      break;
    case FFLOOR:
      XU d[u] = as_i(floor(daz(as_f(XR(o.a, u)))));
      break;
    case FCEIL:
      XU d[u] = as_i(ceil(daz(as_f(XR(o.a, u)))));
      break;
    case FTRUNC:
      XU d[u] = as_i(trunc(daz(as_f(XR(o.a, u)))));
      break;
    case FRNDA:
      XU {
        const double s = daz(as_f(XR(o.a, u)));
        d[u] = as_i(s >= 0.0 ? floor(daz(__dadd_rn(s, 0.5))) : ceil(daz(__dsub_rn(s, 0.5))));
      }
      break;
    case FSIGN:
      XU {
        const double s = daz(as_f(XR(o.a, u)));
        d[u] = (s != s || s == 0.0) ? 0 : (s > 0.0 ? 1 : -1);
      }
      break;
    case FUN1: {
      const int fn = o.aux & 15, dom = o.aux >> 4;
      unsigned okb = 0;
      XU {
        const double x = as_f(XR(o.a, u));
        if (fn == F_SIN || fn == F_TAN) {  // no flush on either side
          d[u] = as_i(fun1(fn, x));
          okb |= 1u << u;
          continue;
        }
        const double s = daz(x);
        const bool ok = dom == D_GE0 ? s >= 0.0 : (dom == D_GT0 ? s > 0.0 : true);
        okb |= (unsigned)ok << u;
        d[u] = as_i(daz(fun1(fn, ok ? s : 1.0)));
      }
      v = va & okb;
      break;
    }
    case FUN2:
      XU {
        const double x = as_f(XR(o.a, u)), y = as_f(XR(o.b, u));
        d[u] = as_i(daz(o.aux == F_POW ? pow(x, y) : atan2(x, y)));
      }
      v = va & XV(o.b);
      break;
    default:
      return;
  }
  XU XR(o.dst, u) = d[u];
  XV(o.dst) = (unsigned char)v;
#undef XR
#undef XV
#undef XU
}

__device__ __forceinline__ bool aligned(ll p, int bytes) { return (p & (bytes - 1)) == 0; }

// The U rows from r0 of a lane (past n: 0). `full`: every row is below n.
__device__ __forceinline__ void ld8(ll base, ll r0, ll n, bool full, ll (&d)[U]) {
  const ll* q = reinterpret_cast<const ll*>(base) + r0;
  if (full && aligned(base, 16)) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(q));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(q) + 1);
    d[0] = a.x;
    d[1] = a.y;
    d[2] = b.x;
    d[3] = b.y;
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) d[u] = r0 + u < n ? __ldg(q + u) : 0;
}

__device__ __forceinline__ void ld4(ll base, ll r0, ll n, bool full, ll (&d)[U]) {
  const int32_t* q = reinterpret_cast<const int32_t*>(base) + r0;
  if (full && aligned(base, 16)) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(q));
    d[0] = a.x;
    d[1] = a.y;
    d[2] = a.z;
    d[3] = a.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) d[u] = r0 + u < n ? (ll)__ldg(q + u) : 0;
}

// bit u: byte r0 + u of a byte lane is nonzero
__device__ __forceinline__ unsigned ldbits(ll base, ll r0, ll n, bool full) {
  const unsigned char* q = reinterpret_cast<const unsigned char*>(base) + r0;
  if (full && aligned(base, 4)) {
    const unsigned m = __vcmpne4(__ldg(reinterpret_cast<const unsigned*>(q)), 0u);
    return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u);
  }
  unsigned b = 0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r0 + u < n && __ldg(q + u)) b |= 1u << u;
  return b;
}

__device__ __forceinline__ void st8(ll base, ll r0, ll n, bool full, const ll (&d)[U]) {
  ll* q = reinterpret_cast<ll*>(base) + r0;
  if (full && aligned(base, 16)) {
    reinterpret_cast<longlong2*>(q)[0] = make_longlong2(d[0], d[1]);
    reinterpret_cast<longlong2*>(q)[1] = make_longlong2(d[2], d[3]);
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r0 + u < n) q[u] = d[u];
}

// bytes r0 .. r0 + U - 1 of a bool lane: bit u of `bits`
__device__ __forceinline__ void stbits(ll base, ll r0, ll n, bool full, unsigned bits) {
  unsigned char* q = reinterpret_cast<unsigned char*>(base) + r0;
  if (full && aligned(base, 4)) {
    *reinterpret_cast<unsigned*>(q) = (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) | ((bits & 8u) << 21);
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r0 + u < n) q[u] = (bits >> u) & 1u;
}

// A load op's U rows: data and validity bits.
__device__ __forceinline__ void load_op(const Op& o, const ll* sin, ll r0, ll n, bool full, ll (&d)[U],
                                        unsigned& v) {
  if (o.code == LDB) {
    const unsigned b = ldbits(sin[o.a], r0, n, full);
#pragma unroll
    for (int u = 0; u < U; ++u) d[u] = (b >> u) & 1u;
    v = ALLV;
    return;
  }
  if (o.code == LD8)
    ld8(sin[o.a], r0, n, full, d);
  else
    ld4(sin[o.a], r0, n, full, d);
  v = o.b < 0 ? ALLV : ldbits(sin[o.b], r0, n, full);
}

// EXT: the extended instantiation (a program holding an op from EXT_FIRST
// on); the base one's dispatch holds none of them.
template <bool EXT>
__global__ void __launch_bounds__(256, 4) expr_eval_kernel(const KParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x;
  ll* sk = reinterpret_cast<ll*>(smem);
  ll* sin = sk + p.nk;
  ll* sout = sin + p.n_in;
  ll* R = sout + p.n_out;
  unsigned char* V = reinterpret_cast<unsigned char*>(R + (ll)p.nregs * U * T);
  Op* sops = reinterpret_cast<Op*>(V + (((ll)p.nregs * T + 15) & ~15LL));
  for (int j = t; j < p.nk; j += T) sk[j] = p.consts[j];
  // the pointer tables: by value, or in device memory as [tasks, n] rows
  // (a wide program, or the task-grid mode: row blockIdx.y is this task's)
  for (int j = t; j < p.n_in; j += T) sin[j] = p.ext_in ? p.ext_in[(ll)blockIdx.y * p.n_in + j] : p.in[j];
  for (int j = t; j < p.n_out; j += T) sout[j] = p.ext_out ? p.ext_out[(ll)blockIdx.y * p.n_out + j] : p.out[j];
  if (p.ops_in_smem)
    for (int j = t; j < p.nops; j += T) sops[j] = p.ops[j];
  __syncthreads();
  const Op* ops = p.ops_in_smem ? sops : p.ops;
#define RD(r, u) R[((ll)(r) * U + (u)) * T + t]
#define VB(r) V[(ll)(r) * T + t]
#define FOR_U _Pragma("unroll") for (int u = 0; u < U; ++u)
  const ll n = p.n, groups = (n + U - 1) / U;
  for (ll g = (ll)blockIdx.x * T + t; g < groups; g += (ll)gridDim.x * T) {
    const ll r0 = g * U;
    const bool full = r0 + U <= n;
    // the load phase: each load op's U rows in flight, then into the
    // register file
    for (int k = 0; k < p.nld; ++k) {
      ll d[U];
      unsigned v;
      const Op& o = ops[k];
      load_op(o, sin, r0, n, full, d, v);
      FOR_U RD(o.dst, u) = d[u];
      VB(o.dst) = (unsigned char)v;
    }
    for (int k = p.nld; k < p.nops; ++k) {
      const Op o = ops[k];
      ll d[U];
      unsigned v = ALLV;
      switch (o.code) {
        case LD8:
        case LD4:
        case LDB:
          load_op(o, sin, r0, n, full, d, v);
          break;
        case LDK:
          FOR_U d[u] = sk[o.a];
          v = o.aux ? ALLV : 0u;
          break;
        case I2F:
          FOR_U d[u] = as_i(__ll2double_rn(RD(o.a, u)));
          v = VB(o.a);
          break;
        case U2F:
          FOR_U d[u] = as_i(__ull2double_rn((ull)RD(o.a, u)));
          v = VB(o.a);
          break;
        case F2I:
          FOR_U d[u] = sat_i64(trunc(as_f(RD(o.a, u))));
          v = VB(o.a);
          break;
        case RINT:
          FOR_U d[u] = sat_i64(rint(as_f(RD(o.a, u))));
          v = VB(o.a);
          break;
        case FMULK: {  // a division by a constant c is FMULK by 1 / c (the host rounds it once)
          const double k = as_f(sk[o.b]);
          FOR_U d[u] = as_i(daz(__dmul_rn(daz(as_f(RD(o.a, u))), k)));
          v = VB(o.a);
          break;
        }
        case IMULK: {
          const ull k = (ull)sk[o.b];
          FOR_U d[u] = (ll)((ull)RD(o.a, u) * k);
          v = VB(o.a);
          break;
        }
        case RDIVK: {
          const ll k = sk[o.b];
          FOR_U d[u] = round_div(RD(o.a, u), k);
          v = VB(o.a);
          break;
        }
        case IADD:
          FOR_U d[u] = (ll)((ull)RD(o.a, u) + (ull)RD(o.b, u));
          v = VB(o.a) & VB(o.b);
          break;
        case ISUB:
          FOR_U d[u] = (ll)((ull)RD(o.a, u) - (ull)RD(o.b, u));
          v = VB(o.a) & VB(o.b);
          break;
        case IMUL:
          FOR_U d[u] = (ll)((ull)RD(o.a, u) * (ull)RD(o.b, u));
          v = VB(o.a) & VB(o.b);
          break;
        case FADD:
          FOR_U d[u] = as_i(daz(__dadd_rn(daz(as_f(RD(o.a, u))), daz(as_f(RD(o.b, u))))));
          v = VB(o.a) & VB(o.b);
          break;
        case FSUB:
          FOR_U d[u] = as_i(daz(__dsub_rn(daz(as_f(RD(o.a, u))), daz(as_f(RD(o.b, u))))));
          v = VB(o.a) & VB(o.b);
          break;
        case FMUL:
          FOR_U d[u] = as_i(daz(__dmul_rn(daz(as_f(RD(o.a, u))), daz(as_f(RD(o.b, u))))));
          v = VB(o.a) & VB(o.b);
          break;
        case INEG:
          FOR_U d[u] = (ll)(0ULL - (ull)RD(o.a, u));
          v = VB(o.a);
          break;
        case FNEG:
          FOR_U d[u] = RD(o.a, u) ^ (ll)0x8000000000000000ULL;
          v = VB(o.a);
          break;
        case CMP: {
          const unsigned va = VB(o.a), vb = VB(o.b);
          if ((o.aux >> 7) & 1) {  // nulleq: NULL <=> NULL holds, never NULL
            FOR_U {
              const bool a_ok = (va >> u) & 1, b_ok = (vb >> u) & 1;
              d[u] = (compare(o.aux, RD(o.a, u), RD(o.b, u)) && a_ok && b_ok) || (!a_ok && !b_ok);
            }
          } else {
            FOR_U d[u] = compare(o.aux, RD(o.a, u), RD(o.b, u));
            v = va & vb;
          }
          break;
        }
        case IN0:
          FOR_U d[u] = 0;
          v = ~(unsigned)VB(o.a) & ALLV;
          break;
        case IN: {  // dst accumulates (hit, any_null)
          const unsigned vb = VB(o.b);
          FOR_U d[u] = RD(o.dst, u) | (ll)(compare(o.aux & 0x63, RD(o.a, u), RD(o.b, u)) && ((vb >> u) & 1));
          v = (VB(o.dst) | ~vb) & ALLV;
          break;
        }
        case INF: {
          const unsigned va = VB(o.a), vb = VB(o.b);
          v = 0;
          FOR_U {
            const ll hit = RD(o.a, u);
            d[u] = hit;
            if (((vb >> u) & 1) && (hit != 0 || !((va >> u) & 1))) v |= 1u << u;
          }
          break;
        }
        case AND: {
          const unsigned va = VB(o.a), vb = VB(o.b);
          unsigned ta = 0, tb = 0;
          FOR_U {
            ta |= (unsigned)nz(RD(o.a, u), o.aux & 1) << u;
            tb |= (unsigned)nz(RD(o.b, u), (o.aux >> 1) & 1) << u;
          }
          const unsigned all = ta & tb & va & vb;
          FOR_U d[u] = (all >> u) & 1;
          v = (va & vb) | (va & ~ta) | (vb & ~tb);  // known, or some side known false
          break;
        }
        case OR: {
          const unsigned va = VB(o.a), vb = VB(o.b);
          unsigned tr = 0;
          FOR_U tr |= (unsigned)((nz(RD(o.a, u), o.aux & 1) && ((va >> u) & 1)) ||
                                 (nz(RD(o.b, u), (o.aux >> 1) & 1) && ((vb >> u) & 1)))
                      << u;
          FOR_U d[u] = (tr >> u) & 1;
          v = (va & vb) | tr;
          break;
        }
        case NOT:
          FOR_U d[u] = !nz(RD(o.a, u), o.aux & 1);
          v = VB(o.a);
          break;
        case ISNULL: {
          const unsigned va = VB(o.a);
          FOR_U d[u] = !((va >> u) & 1);
          break;
        }
        case MASK: {
          const unsigned va = VB(o.a);
          FOR_U d[u] = RD(o.dst, u) != 0 && ((va >> u) & 1) && nz(RD(o.a, u), o.aux & 1);
          break;
        }
        case ZNULL: {
          const unsigned va = VB(o.a);
          FOR_U d[u] = ((va >> u) & 1) ? RD(o.a, u) : 0;
          v = va;
          break;
        }
        case IHI:
          FOR_U d[u] = RD(o.a, u) >> 32;
          v = VB(o.a);
          break;
        case ILO:
          FOR_U d[u] = RD(o.a, u) & 0xFFFFFFFFLL;
          v = VB(o.a);
          break;
        case ST8:
          FOR_U d[u] = RD(o.a, u);
          st8(sout[o.dst], r0, n, full, d);
          continue;
        case STV:
          stbits(sout[o.dst], r0, n, full, VB(o.a));
          continue;
        case STB: {
          unsigned b = 0;
          FOR_U b |= (unsigned)(RD(o.a, u) != 0) << u;
          stbits(sout[o.dst], r0, n, full, b);
          continue;
        }
        default:
          if constexpr (EXT)
            if (o.code >= EXT_FIRST) ext_op(o, R, V, sk, t, T);
          continue;
      }
      FOR_U RD(o.dst, u) = d[u];
      VB(o.dst) = (unsigned char)v;
    }
  }
#undef RD
#undef VB
#undef FOR_U
}

}  // namespace

// The host's call, as kernels/expr_eval.py lays it out.
struct Params {
  const void* ops;
  const void* consts;
  const void* ext_in;
  const void* ext_out;
  int64_t n;
  int nops, nk, nregs, n_in, n_out, threads, blocks, ops_in_smem, nld, ext_ops;
  int64_t smem;
  int64_t in_ptrs[MAX_PTRS];
  int64_t out_ptrs[MAX_PTRS];
};

template <bool EXT>
static int launch_as(const Params* h, int tasks, void* stream) {
  if (h->n < 0 || h->nops < 0 || h->nregs < 0 || h->threads < 32 || h->threads > 256 || h->blocks < 1 ||
      h->nld < 0 || h->nld > h->nops)
    return -1;
  if ((h->n_in > MAX_PTRS && !h->ext_in) || (h->n_out > MAX_PTRS && !h->ext_out)) return -1;
  const int64_t need = 8LL * (h->nk + h->n_in + h->n_out) + 8LL * U * h->nregs * h->threads +
                       ((int64_t)h->nregs * h->threads + 15) / 16 * 16 +
                       (h->ops_in_smem ? 20LL * h->nops : 0);
  // The opt-in limit (less the kernel's static shared memory) is the
  // function's attribute on each device: set once a device and
  // instantiation, a bit each (a mesh's ranks launch from threads at once;
  // setting it twice does no harm).
  static std::atomic<unsigned long long> set_on{0};
  static std::atomic<int> dyn_max{-1};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaGetLastError();
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit == 0 || !(set_on.load(std::memory_order_acquire) & bit)) {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, expr_eval_kernel<EXT>) != cudaSuccess) return (int)cudaGetLastError();
    const int lim = 227 * 1024 - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(expr_eval_kernel<EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lim) != cudaSuccess)
      return (int)cudaGetLastError();
    dyn_max.store(lim);
    set_on.fetch_or(bit, std::memory_order_release);
  }
  if (need > h->smem || h->smem > dyn_max.load()) return -1;
  KParams p;
  p.ops = (const Op*)h->ops;
  p.consts = (const ll*)h->consts;
  p.ext_in = (const ll*)h->ext_in;
  p.ext_out = (const ll*)h->ext_out;
  p.n = h->n;
  p.nops = h->nops;
  p.nk = h->nk;
  p.nregs = h->nregs;
  p.n_in = h->n_in;
  p.n_out = h->n_out;
  p.ops_in_smem = h->ops_in_smem;
  p.nld = h->nld;
  for (int j = 0; j < MAX_PTRS; ++j) {
    p.in[j] = j < h->n_in && !h->ext_in ? h->in_ptrs[j] : 0;
    p.out[j] = j < h->n_out && !h->ext_out ? h->out_ptrs[j] : 0;
  }
  if (h->n == 0) return 0;
  expr_eval_kernel<EXT><<<dim3(h->blocks, tasks), h->threads, (size_t)h->smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static int launch(const Params* h, int tasks, void* stream) {
  return h->ext_ops ? launch_as<true>(h, tasks, stream) : launch_as<false>(h, tasks, stream);
}

extern "C" int tt_expr_eval(const Params* h, void* stream) { return launch(h, 1, stream); }

// K10's task-grid mode (tidb_tpu/copr/tpu_engine.py:1096 _vmapped_program):
// the same program over the first h->n rows of each of `tasks` tasks. The
// pointer tables are [tasks, n_in] and [tasks, n_out] in device memory;
// the grid's y axis is the task.
extern "C" int tt_expr_eval_tasks(const Params* h, int tasks, void* stream) {
  if (tasks < 1 || tasks > 65535 || !h->ext_in || !h->ext_out) return -1;
  return launch(h, tasks, stream);
}
