// K1 decode_lane: expands uploaded column lanes to their dense form — every
// coded lane of a call in one launch.
//
// Replaces tidb_tpu/copr/tpu_engine.py:1169 TPUEngine._decode_lane, the
// in-program decode XLA fused into every cop program, and the decode of
// K10's grouped program (:1096-1134 _vmapped_program, with :1065-1094
// _narrow_args). Codecs (host encode half: tidb_tpu_torch/copr/tilecache.py,
// a copy of the reference's):
//
//   pack  out[i] = (T)code[i] + base          uint8/16/32 codes, int32/int64 T
//                                              (uint64 lanes travel as int64
//                                              bits; the add wraps mod 2^W
//                                              exactly like the reference)
//   dict  out[i] = vocab[code[i]]              a gather of 4- or 8-byte values
//                                              (a code past the vocab reads
//                                              its last entry, as XLA's
//                                              clamped gather does)
//   rle   out[i] = vals[j], j = first run whose inclusive end > i; rows past
//         the last run read the LAST entry (the encoder's zero pad run), as
//         jnp.repeat(..., total_repeat_length) does
//
// The all-valid alias and dense lanes never reach this file (the wrappers
// hand back row_valid / the lane itself without a launch).
//
// One launch decodes a call's every coded lane. Its entries (Ent) are the
// lanes: in the solo mode (_decode) each coded data and valid lane of the
// call, `rows` the batch's padded rows; in the task mode (_decode_tasks)
// each such lane of every task of a launch group, `rows` the group's
// narrowed `width` and `out` the task's row of the lane's [G, width]
// output. That narrowing is a bound on the row loop and no copy, and it is
// exact: every later kernel masks with row_valid, and the rows dropped are
// padding. An rle payload decodes its first `width` rows exactly as it
// would at full width (run ends are absolute), as _narrow_args passes rle
// payloads through untouched.
//
// Work items are (entry, chunk) pairs, CH rows a chunk, numbered entry by
// entry (Ent.item0). A grid of MIN_BLOCKS blocks an SM walks them, so a
// 4,096-row burst lane and a 16M-row Q1 lane both keep the card busy. A
// thread decodes RPT rows of an item in steps of 16 / VB consecutive rows
// (VB: the value's bytes): one 16-byte store of their values and one
// vector load of their codes (2-16 bytes) a step, a warp's step covering
// consecutive rows, so its loads and its 512 bytes of stores coalesce. (A
// thread's 16 consecutive rows, one 16-byte code load and eight stores at
// a 128-byte stride, ran 6x slower on Q1's lanes: PERF.md, PR 17.) Each
// entry starts its chunks at `head`, the first row whose output address is
// 16-byte aligned (task rows and narrowed views start anywhere); the head
// rows, an entry's ragged end and the codes of an entry whose code address
// is not aligned with its output take a scalar path in the same kernel. A dict vocab of
// at most VOCAB_SMEM bytes is copied to shared memory once a block and
// entry; a larger one is read through the read-only cache. rle reads the
// inclusive run ends the wrapper computes once per resident lane: a
// thread searches for its first row's run only, then walks forward (by
// steps doubling from the last run it found). A block finds its first
// item's entry by a binary search over the entries' first items.
//
// Entries travel by value as a kernel parameter, in the smallest of the
// ENT_CAPS tiers that holds them (4 KB of parameters; 32,764 bytes with a
// toolkit of 12.1 or later); past the largest tier they come from one
// copy of a pinned host table into device memory.
//
// Bound: bytes. Per output row one code (1-4 B) is read and one value
// (1-8 B) written; vocab and run arrays are a few KB and stay in cache.
//
// Plain C interface (nvcc + ctypes): tt_decode_lanes reads the call's int64
// words on the host, launches on the given stream, never synchronizes, and
// returns the cudaError_t of the launch (0 = success) or -1 for an argument
// it does not take.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef long long ll;
typedef unsigned long long ull;

constexpr int BLOCK = 256;
// blocks an SM (launch bounds, grid) and rows a thread an item: 6 and 32
// ran Q1's lanes faster than 4 and 16, 8 blocks and 64 rows slower, and a
// path for whole items with no bound a step (every step's loads issued
// first) slower still (PERF.md, PR 17)
constexpr int MIN_BLOCKS = 6;
constexpr int RPT = 32;
constexpr int CH = BLOCK * RPT;         // rows a work item
constexpr int VOCAB_SMEM = 32 * 1024;  // bytes: a dict vocab up to this sits in shared memory
constexpr int WORDS = 7;                // int64 words an entry in the call's words

enum { PACK = 0, DICT = 1, RLE = 2 };
enum { CODES_ALIGNED = 1, VOCAB_IN_SMEM = 2 };

struct Ent {
  const void* src;  // pack / dict codes; rle run values
  const void* aux;  // dict vocab; rle inclusive run ends (int64); null for pack
  void* out;
  ll rows;   // rows to decode
  ll base;   // pack base bits
  ll item0;  // the entry's first work item
  int naux;  // vocab length / run count
  int head;  // rows before the first row whose output address is 16-byte aligned
  int kind;  // codec | code bytes << 8 | value bytes << 16 | flags << 24
  int pad;
};

#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
constexpr int ENT_CAPS[] = {8, 60, 500};  // 500 entries: 32,000 bytes of parameters (12.1+)
#else
constexpr int ENT_CAPS[] = {8, 60};  // within 4 KB of parameters
#endif
constexpr int NCAPS = sizeof(ENT_CAPS) / sizeof(int);

template <int CAP>
struct Args {
  const Ent* table;  // CAP 0: the entries in device memory
  ll items;          // work items in all
  int ne;
  int pad;
  Ent ents[CAP > 0 ? CAP : 1];
};

template <int B> struct UInt;
template <> struct UInt<1> { typedef uint8_t T; };
template <> struct UInt<2> { typedef uint16_t T; };
template <> struct UInt<4> { typedef unsigned T; };
template <> struct UInt<8> { typedef ull T; };

// N codes of CB bytes from one aligned load of N * CB bytes (2, 4, 8 or 16)
template <int CB, int N>
__device__ __forceinline__ void load_codes(const void* p, unsigned (&c)[N]) {
  constexpr int BYTES = CB * N;
  unsigned x[4] = {0u, 0u, 0u, 0u};
  if constexpr (BYTES == 16) {
    const uint4 w = __ldg((const uint4*)p);
    x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
  } else if constexpr (BYTES == 8) {
    const uint2 w = __ldg((const uint2*)p);
    x[0] = w.x, x[1] = w.y;
  } else if constexpr (BYTES == 4) {
    x[0] = __ldg((const unsigned*)p);
  } else {
    x[0] = __ldg((const unsigned short*)p);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const unsigned w = x[(k * CB) >> 2];
    if constexpr (CB == 4) c[k] = w;
    else c[k] = (w >> (((k * CB) & 3) * 8)) & (CB == 2 ? 0xffffu : 0xffu);
  }
}

// one row's value of a pack or dict entry from its code
template <int CODEC, int VB>
__device__ __forceinline__ typename UInt<VB>::T value_of(const Ent& e, const void* vocab, unsigned code) {
  typedef typename UInt<VB>::T U;
  if constexpr (CODEC == PACK) return (U)code + (U)e.base;
  const ll c = (ll)code < (ll)e.naux ? (ll)code : (ll)e.naux - 1;
  return ((const U*)vocab)[c];
}

// 16 / VB values as one 16-byte store to out (16-byte aligned)
template <int VB>
__device__ __forceinline__ void store16(void* out, const typename UInt<VB>::T (&v)[16 / VB]) {
  uint4 u;
  if constexpr (VB == 8) {
    u = make_uint4((unsigned)v[0], (unsigned)((ull)v[0] >> 32), (unsigned)v[1], (unsigned)((ull)v[1] >> 32));
  } else if constexpr (VB == 4) {
    u = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned x[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      x[h] = (unsigned)v[4 * h] | (unsigned)v[4 * h + 1] << 8 | (unsigned)v[4 * h + 2] << 16 |
             (unsigned)v[4 * h + 3] << 24;
    u = make_uint4(x[0], x[1], x[2], x[3]);
  }
  *(uint4*)out = u;
}

// the first run from j on whose inclusive end is past row r (runs: n):
// ends[j] first, then steps doubling from j, then a binary search
__device__ __forceinline__ int advance(const ll* __restrict__ ends, int n, int j, ll r) {
  if (j >= n || __ldg(ends + j) > r) return j;
  int lo = j, step = 1;  // ends[lo] <= r
  while (lo + step < n && __ldg(ends + lo + step) <= r) {
    lo += step;
    step <<= 1;
  }
  int hi = lo + step < n ? lo + step : n;  // ends[hi] > r, or hi == n
  ++lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > r) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The rows of one work item: head row hr (-1: none), then in each of
// RPT * VB / 16 steps 16 / VB consecutive rows a thread from r0 + step *
// BLOCK * (16 / VB), so that a warp's 16-byte stores of a step are 512
// contiguous bytes; rows at or past r1 (the entry's end) are left out, a
// step that reaches r1 goes row by row. CODEC RLE reads run values through
// the run ends, finding its first row's run by a search and the later ones
// forward.
template <int CODEC, int CB, int VB>
__device__ __forceinline__ void item_rows(const Ent& e, const void* vocab, ll hr, ll r0, ll r1) {
  typedef typename UInt<CB>::T C;
  typedef typename UInt<VB>::T U;
  constexpr int V = 16 / VB;  // rows a 16-byte store
  const C* codes = (const C*)e.src;
  const U* vals = (const U*)e.src;
  const ll* ends = (const ll*)e.aux;
  const int n = e.naux;
  U* out = (U*)e.out;
  int j = 0;
  if constexpr (CODEC == RLE) {
    if (hr >= 0) {
      const int h = advance(ends, n, 0, hr);
      out[hr] = __ldg(vals + (h < n ? h : n - 1));
    }
    j = r0 < r1 ? advance(ends, n, 0, r0 + (ll)threadIdx.x * V) : 0;
  } else {
    if (hr >= 0) out[hr] = value_of<CODEC, VB>(e, vocab, (unsigned)__ldg(codes + hr));
  }
#pragma unroll
  for (int s = 0; s < RPT / V; ++s) {
    const ll r = r0 + (ll)s * BLOCK * V + (ll)threadIdx.x * V;
    if (r >= r1) break;
    U v[V];
    if (r + V <= r1) {
      if constexpr (CODEC == RLE) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          j = advance(ends, n, j, r + k);
          v[k] = __ldg(vals + (j < n ? j : n - 1));
        }
      } else {
        unsigned c[V];
        if ((e.kind >> 24) & CODES_ALIGNED) {
          load_codes<CB, V>(codes + r, c);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) c[k] = (unsigned)__ldg(codes + r + k);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = value_of<CODEC, VB>(e, vocab, c[k]);
      }
      store16<VB>(out + r, v);
    } else {
      for (ll q = r; q < r1; ++q) {
        if constexpr (CODEC == RLE) {
          j = advance(ends, n, j, q);
          out[q] = __ldg(vals + (j < n ? j : n - 1));
        } else {
          out[q] = value_of<CODEC, VB>(e, vocab, (unsigned)__ldg(codes + q));
        }
      }
    }
  }
}

// the codec, code width and value width of an entry → its instantiation
__device__ __forceinline__ void dispatch(const Ent& e, const void* vocab, ll hr, ll r0, ll r1) {
  const int codec = e.kind & 0xff, cb = (e.kind >> 8) & 0xff, vb = (e.kind >> 16) & 0xff;
#define ROWS(C, CB, VB) item_rows<C, CB, VB>(e, vocab, hr, r0, r1)
  if (codec == RLE) {
    if (vb == 8) ROWS(RLE, 1, 8); else if (vb == 4) ROWS(RLE, 1, 4); else ROWS(RLE, 1, 1);
  } else if (codec == PACK) {
    if (vb == 8) {
      if (cb == 1) ROWS(PACK, 1, 8); else if (cb == 2) ROWS(PACK, 2, 8); else ROWS(PACK, 4, 8);
    } else {
      if (cb == 1) ROWS(PACK, 1, 4); else if (cb == 2) ROWS(PACK, 2, 4); else ROWS(PACK, 4, 4);
    }
  } else {
    if (vb == 8) {
      if (cb == 1) ROWS(DICT, 1, 8); else if (cb == 2) ROWS(DICT, 2, 8); else ROWS(DICT, 4, 8);
    } else {
      if (cb == 1) ROWS(DICT, 1, 4); else if (cb == 2) ROWS(DICT, 2, 4); else ROWS(DICT, 4, 4);
    }
  }
#undef ROWS
}

template <int CAP>
__device__ __forceinline__ const Ent& ent(const Args<CAP>& a, int i) {
  if constexpr (CAP > 0) return a.ents[i];
  else return a.table[i];
}

template <int CAP>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) lanes_kernel(const __grid_constant__ Args<CAP> a) {
  extern __shared__ __align__(16) unsigned char svocab[];
  int e = 0, loaded = -1;
  {  // the block's first item's entry: the last whose first item is at or before it
    int hi = a.ne - 1;
    while (e < hi) {
      const int mid = (e + hi + 1) >> 1;
      if (ent(a, mid).item0 <= (ll)blockIdx.x) e = mid; else hi = mid - 1;
    }
  }
  for (ll item = blockIdx.x; item < a.items; item += gridDim.x) {
    while (e + 1 < a.ne && ent(a, e + 1).item0 <= item) ++e;
    const Ent E = ent(a, e);
    const void* vocab = E.aux;
    if ((E.kind >> 24) & VOCAB_IN_SMEM) {
      if (loaded != e) {  // the block's first item of this entry: its vocab to shared memory
        __syncthreads();  // the last item's reads of the previous vocab are done
        const int bytes = E.naux * ((E.kind >> 16) & 0xff);
        for (int q = threadIdx.x; q < bytes / 16; q += BLOCK) ((uint4*)svocab)[q] = __ldg((const uint4*)E.aux + q);
        for (int b = bytes / 16 * 16 + threadIdx.x; b < bytes; b += BLOCK) svocab[b] = __ldg((const uint8_t*)E.aux + b);
        __syncthreads();
        loaded = e;
      }
      vocab = svocab;
    }
    const ll c = item - E.item0;
    // the entry's first item also takes the rows before the aligned ones, one a thread
    const ll hr = c == 0 && threadIdx.x < E.head ? (ll)threadIdx.x : -1;
    const ll r0 = E.head + c * CH;
    const ll r1 = r0 + CH < E.rows ? r0 + CH : E.rows;
    dispatch(E, vocab, hr, r0, r1);
  }
}

struct Plan {
  ll items;
  int smem;  // bytes of shared memory for vocabs
};

// the call's words → entries (module note), or -1 for an argument the
// kernel does not take
int plan(const int64_t* w, int ne, Ent* ents, Plan* p) {
  p->items = 0;
  p->smem = 0;
  for (int i = 0; i < ne; ++i) {
    const int64_t* x = w + (ll)i * WORDS;
    const int codec = (int)(x[0] & 0xff), vb = (int)((x[0] >> 16) & 0xff);
    int cb = (int)((x[0] >> 8) & 0xff);
    Ent& e = ents[i];
    memset(&e, 0, sizeof(Ent));
    e.src = (const void*)x[1];
    e.aux = (const void*)x[2];
    e.naux = (int)x[3];
    e.base = x[4];
    e.out = (void*)x[5];
    e.rows = x[6];
    if (codec == RLE) {
      if ((vb != 1 && vb != 4 && vb != 8) || x[3] < 1 || x[3] >= (1LL << 31) || x[2] % 8 != 0) return -1;
      cb = 1;
    } else if (codec == PACK || codec == DICT) {
      if ((vb != 4 && vb != 8) || (cb != 1 && cb != 2 && cb != 4) || x[1] % cb != 0) return -1;
      if (codec == DICT && (x[3] < 1 || x[3] >= (1LL << 31) || x[2] % vb != 0)) return -1;
    } else {
      return -1;
    }
    if (e.rows < 0 || x[5] % vb != 0 || (codec == RLE && x[1] % vb != 0)) return -1;
    const ll mis = (ll)((ull)x[5] & 15ULL);
    ll head = mis == 0 ? 0 : (16 - mis) / vb;
    if (head > e.rows) head = e.rows;
    e.head = (int)head;
    int flags = 0;
    if (codec != RLE && ((ull)x[1] + (ull)(head * cb)) % 16 == 0) flags |= CODES_ALIGNED;
    if (codec == DICT && (ll)e.naux * vb <= VOCAB_SMEM && (ull)x[2] % 16 == 0) {
      flags |= VOCAB_IN_SMEM;
      const int bytes = (e.naux * vb + 15) / 16 * 16;
      if (bytes > p->smem) p->smem = bytes;
    }
    e.kind = codec | cb << 8 | vb << 16 | flags << 24;
    e.item0 = p->items;
    p->items += e.rows == 0 ? 0 : e.rows <= head ? 1 : (e.rows - head + CH - 1) / CH;
  }
  return 0;
}

template <int CAP>
int launch(const Ent* ents, int ne, const Ent* table, const Plan& p, int n_sms, cudaStream_t s) {
  Args<CAP> a;
  a.table = table;
  a.items = p.items;
  a.ne = ne;
  a.pad = 0;
  if constexpr (CAP > 0) memcpy(a.ents, ents, sizeof(Ent) * ne);
  if (p.items == 0) return 0;
  ll grid = (ll)(n_sms > 0 ? n_sms : 132) * MIN_BLOCKS;
  if (grid > p.items) grid = p.items;
  lanes_kernel<CAP><<<(unsigned)grid, BLOCK, p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// the most entries that travel by value (past it: a pinned table and a copy)
extern "C" int tt_decode_max_by_value() { return ENT_CAPS[NCAPS - 1]; }

extern "C" int tt_decode_ent_bytes() { return (int)sizeof(Ent); }

// words: per entry (codec | code bytes << 8 | value bytes << 16, src, aux,
// naux, base bits, out, rows). Past tt_decode_max_by_value() entries,
// table_host (pinned, ne * tt_decode_ent_bytes() bytes) receives the
// entries and is copied to table_dev on the stream; the caller keeps it
// until that copy has run.
extern "C" int tt_decode_lanes(const int64_t* w, int ne, void* table_host, void* table_dev, int n_sms,
                               void* stream) {
  if (ne < 0) return -1;
  if (ne == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  if (ne > ENT_CAPS[NCAPS - 1]) {
    if (table_host == nullptr || table_dev == nullptr) return -1;
    Ent* ents = (Ent*)table_host;
    if (plan(w, ne, ents, &p)) return -1;
    const int rc = (int)cudaMemcpyAsync(table_dev, table_host, sizeof(Ent) * ne, cudaMemcpyHostToDevice, s);
    if (rc) return rc;
    return launch<0>(nullptr, ne, (const Ent*)table_dev, p, n_sms, s);
  }
  Ent ents[ENT_CAPS[NCAPS - 1]];
  if (plan(w, ne, ents, &p)) return -1;
  if (ne <= ENT_CAPS[0]) return launch<ENT_CAPS[0]>(ents, ne, nullptr, p, n_sms, s);
  if (ne <= ENT_CAPS[1]) return launch<ENT_CAPS[1]>(ents, ne, nullptr, p, n_sms, s);
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  return launch<ENT_CAPS[2]>(ents, ne, nullptr, p, n_sms, s);
#else
  return -1;
#endif
}
