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
// Design. One thread per row, grid-stride. At block start the constant
// pool, the lane pointers and (when they fit) the ops are copied into
// shared memory, so every warp reads the same op and takes the same
// branch. Each register is 8 data bytes (int64, or a double's bits) and
// a valid byte, in shared memory laid out [register][thread]; the host
// sizes the block from the program's register count. Per row the thread
// loads each input lane once (held in a register until its last use),
// computes every condition into the mask and every value output, and
// stores each output once: one launch per program, where the reference's
// trace (and the port's earlier glue) issued one array op per tree node.
//
// Arithmetic, as the reference's XLA CPU program computes it:
//   * int64 adds, subtracts and multiplies wrap (done in unsigned);
//   * doubles with __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, never
//     contracted into a multiply-add; a subnormal operand reads as zero
//     of its sign and a subnormal result is flushed (XLA CPU's DAZ/FTZ);
//     negation flips the sign bit only;
//   * uint64 -> double rounds once (__ull2double_rn); double -> int64
//     saturates, NaN -> 0 (F2I truncates, RINT rounds half to even);
//   * comparisons in the domain the compiler chose: signed, unsigned,
//     double (NaN: only `ne` holds) or mixed signed/unsigned (class, lo).
//
// Bound: bytes. Each row reads its input lanes (8 bytes a data lane, 4 a
// dict-code lane, 1 a valid lane) and writes its outputs (8 or 1 bytes);
// the interpreter's per-op dispatch is the risk on long programs.
//
// Task-grid mode (K10, tidb_tpu/copr/tpu_engine.py:1096-1134): the same
// program over G tasks of a launch group, one launch; each task's lanes
// are read through its row of the pointer tables, the first `n` (the
// group's narrowed width) rows of each.
//
// Plain C interface (nvcc + ctypes): kernels/expr_eval.py fills a Params
// struct; tt_expr_eval launches on the given stream, never synchronizes,
// and returns the cudaError_t of the launch (0 = success), or -1 for an
// argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int MAX_PTRS = 192;

enum Code : int32_t {
  NOP = 0, LD8, LD4, LDB, LDK, I2F, U2F, F2I, RINT, FDIVK, IMULK, RDIVK,
  IADD, ISUB, IMUL, FADD, FSUB, FMUL, INEG, FNEG, CMP, IN0, IN, INF,
  AND, OR, NOT, ISNULL, MASK, ZNULL, IHI, ILO, ST8, STV, STB
};
enum Dom : int32_t { DOM_I = 0, DOM_U = 1, DOM_F = 2, DOM_X = 3 };

struct Op {
  int32_t code, dst, a, b, aux;
};

struct KParams {
  const Op* ops;
  const ll* consts;
  const ll* ext_in;
  const ll* ext_out;
  ll n;
  int nops, nk, nregs, n_in, n_out, ops_in_smem;
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

__global__ void expr_eval_kernel(const KParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x;
  ll* sk = reinterpret_cast<ll*>(smem);
  ll* sin = sk + p.nk;
  ll* sout = sin + p.n_in;
  ll* R = sout + p.n_out;
  unsigned char* V = reinterpret_cast<unsigned char*>(R + (ll)p.nregs * T);
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
#define RD(r) R[(ll)(r) * T + t]
#define VD(r) V[(ll)(r) * T + t]
  for (ll i = (ll)blockIdx.x * T + t; i < p.n; i += (ll)gridDim.x * T) {
    for (int k = 0; k < p.nops; ++k) {
      const Op o = ops[k];
      ll d = 0;
      unsigned char v = 1;
      switch (o.code) {
        case LD8:
          d = reinterpret_cast<const ll*>(sin[o.a])[i];
          v = o.b < 0 ? 1 : reinterpret_cast<const unsigned char*>(sin[o.b])[i] != 0;
          break;
        case LD4:
          d = (ll) reinterpret_cast<const int32_t*>(sin[o.a])[i];
          v = o.b < 0 ? 1 : reinterpret_cast<const unsigned char*>(sin[o.b])[i] != 0;
          break;
        case LDB:
          d = reinterpret_cast<const unsigned char*>(sin[o.a])[i] != 0;
          break;
        case LDK:
          d = sk[o.a];
          v = (unsigned char)o.aux;
          break;
        case I2F: d = as_i(__ll2double_rn(RD(o.a))); v = VD(o.a); break;
        case U2F: d = as_i(__ull2double_rn((ull)RD(o.a))); v = VD(o.a); break;
        case F2I: d = sat_i64(trunc(as_f(RD(o.a)))); v = VD(o.a); break;
        case RINT: d = sat_i64(rint(as_f(RD(o.a)))); v = VD(o.a); break;
        case FDIVK: d = as_i(daz(__ddiv_rn(daz(as_f(RD(o.a))), as_f(sk[o.b])))); v = VD(o.a); break;
        case IMULK: d = (ll)((ull)RD(o.a) * (ull)sk[o.b]); v = VD(o.a); break;
        case RDIVK: d = round_div(RD(o.a), sk[o.b]); v = VD(o.a); break;
        case IADD: d = (ll)((ull)RD(o.a) + (ull)RD(o.b)); v = VD(o.a) & VD(o.b); break;
        case ISUB: d = (ll)((ull)RD(o.a) - (ull)RD(o.b)); v = VD(o.a) & VD(o.b); break;
        case IMUL: d = (ll)((ull)RD(o.a) * (ull)RD(o.b)); v = VD(o.a) & VD(o.b); break;
        case FADD:
          d = as_i(daz(__dadd_rn(daz(as_f(RD(o.a))), daz(as_f(RD(o.b))))));
          v = VD(o.a) & VD(o.b);
          break;
        case FSUB:
          d = as_i(daz(__dsub_rn(daz(as_f(RD(o.a))), daz(as_f(RD(o.b))))));
          v = VD(o.a) & VD(o.b);
          break;
        case FMUL:
          d = as_i(daz(__dmul_rn(daz(as_f(RD(o.a))), daz(as_f(RD(o.b))))));
          v = VD(o.a) & VD(o.b);
          break;
        case INEG: d = (ll)(0ULL - (ull)RD(o.a)); v = VD(o.a); break;
        case FNEG: d = RD(o.a) ^ (ll)0x8000000000000000ULL; v = VD(o.a); break;
        case CMP: {
          const unsigned char va = VD(o.a), vb = VD(o.b);
          const bool r = compare(o.aux, RD(o.a), RD(o.b));
          if ((o.aux >> 7) & 1) {  // nulleq: NULL <=> NULL holds, never NULL
            d = (r && va && vb) || (!va && !vb);
          } else {
            d = r;
            v = va & vb;
          }
          break;
        }
        case IN0: d = 0; v = !VD(o.a); break;
        case IN: {  // dst accumulates (hit, any_null)
          const unsigned char vb = VD(o.b);
          const bool e = compare(o.aux & 0x63, RD(o.a), RD(o.b)) && vb;
          d = RD(o.dst) | (ll)e;
          v = VD(o.dst) | !vb;
          break;
        }
        case INF: {
          const ll hit = RD(o.a);
          d = hit;
          v = VD(o.b) && (hit != 0 || !VD(o.a));
          break;
        }
        case AND: {
          const unsigned char va = VD(o.a), vb = VD(o.b);
          const bool ta = nz(RD(o.a), o.aux & 1), tb = nz(RD(o.b), (o.aux >> 1) & 1);
          const bool false_any = (va && !ta) || (vb && !tb);
          d = ta && tb && va && vb;
          v = (va && vb) || false_any;
          break;
        }
        case OR: {
          const unsigned char va = VD(o.a), vb = VD(o.b);
          const bool tr = (nz(RD(o.a), o.aux & 1) && va) || (nz(RD(o.b), (o.aux >> 1) & 1) && vb);
          d = tr;
          v = (va && vb) || tr;
          break;
        }
        case NOT: d = !nz(RD(o.a), o.aux & 1); v = VD(o.a); break;
        case ISNULL: d = !VD(o.a); break;
        case MASK: d = RD(o.dst) != 0 && VD(o.a) && nz(RD(o.a), o.aux & 1); break;
        case ZNULL: d = VD(o.a) ? RD(o.a) : 0; v = VD(o.a); break;
        case IHI: d = RD(o.a) >> 32; v = VD(o.a); break;
        case ILO: d = RD(o.a) & 0xFFFFFFFFLL; v = VD(o.a); break;
        case ST8: reinterpret_cast<ll*>(sout[o.dst])[i] = RD(o.a); continue;
        case STV: reinterpret_cast<unsigned char*>(sout[o.dst])[i] = VD(o.a); continue;
        case STB: reinterpret_cast<unsigned char*>(sout[o.dst])[i] = RD(o.a) != 0; continue;
        default: continue;
      }
      RD(o.dst) = d;
      VD(o.dst) = v;
    }
  }
#undef RD
#undef VD
}

}  // namespace

// The host's call, as kernels/expr_eval.py lays it out.
struct Params {
  const void* ops;
  const void* consts;
  const void* ext_in;
  const void* ext_out;
  int64_t n;
  int nops, nk, nregs, n_in, n_out, threads, blocks, ops_in_smem;
  int64_t smem;
  int64_t in_ptrs[MAX_PTRS];
  int64_t out_ptrs[MAX_PTRS];
};

static int launch(const Params* h, int tasks, void* stream) {
  if (h->n < 0 || h->nops < 0 || h->nregs < 0 || h->threads < 32 || h->threads > 1024 || h->blocks < 1)
    return -1;
  if ((h->n_in > MAX_PTRS && !h->ext_in) || (h->n_out > MAX_PTRS && !h->ext_out)) return -1;
  const int64_t need = 8LL * (h->nk + h->n_in + h->n_out) + 8LL * h->nregs * h->threads +
                       ((int64_t)h->nregs * h->threads + 15) / 16 * 16 +
                       (h->ops_in_smem ? 20LL * h->nops : 0);
  if (need > h->smem || h->smem > 227 * 1024) return -1;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(expr_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    attr = true;
  }
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
  for (int j = 0; j < MAX_PTRS; ++j) {
    p.in[j] = j < h->n_in && !h->ext_in ? h->in_ptrs[j] : 0;
    p.out[j] = j < h->n_out && !h->ext_out ? h->out_ptrs[j] : 0;
  }
  if (h->n == 0) return 0;
  expr_eval_kernel<<<dim3(h->blocks, tasks), h->threads, (size_t)h->smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
