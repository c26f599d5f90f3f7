// K1 decode_lane: expands one uploaded column lane to its dense [T, R] form.
//
// Replaces tidb_tpu/copr/tpu_engine.py:1169 TPUEngine._decode_lane, the
// in-program decode XLA fused into every cop program. Codecs (host encode
// half: tidb_tpu_torch/copr/tilecache.py, a copy of the reference's):
//
//   pack  out[i] = (T)code[i] + base          uint8/16/32 codes, int32/int64 T
//                                              (uint64 lanes travel as int64
//                                              bits; the add wraps mod 2^W
//                                              exactly like the reference)
//   dict  out[i] = vocab[code[i]]              a gather of 4- or 8-byte values
//   rle   out[i] = vals[j], j = first run whose inclusive end > i; rows past
//         the last run read the LAST entry (the encoder's zero pad run), as
//         jnp.repeat(..., total_repeat_length) does
//
// The all-valid alias and dense lanes never reach this file (the wrapper
// returns row_valid / the lane itself without a launch).
//
// Bound: bytes. Per output row it reads one code (1-4 B) and writes one
// value (4-8 B); vocab and run arrays are a few KB and stay in L1/L2. The
// rle search reads log2(runs) run ends per row from cache. One thread per
// output row, grid-stride, consecutive threads on consecutive rows so
// every load and store coalesces.
//
// Task-grid mode (K10's decode, tidb_tpu/copr/tpu_engine.py:1096-1134
// _vmapped_program with :1065-1094 _narrow_args): one launch decodes the
// same lane of G tasks of a launch group. A task table of G entries
// (TaskLane: the payload, the vocab or run ends, the pack base — a launch
// parameter in the solo mode, per task here — and the task's output
// row) sits in device memory; the grid's y axis is the task. Each task
// decodes only its first `width` flattened rows into row g of a [G, width]
// output. That narrowing is a bound on the row loop and no copy, and it
// is exact: every later kernel masks with row_valid, and the rows dropped
// are padding. An rle payload decodes its first `width` rows exactly as it
// would at full width (run ends are absolute), as _narrow_args passes rle
// payloads through untouched. The tasks of a group share the codec
// signature (the program key carries it), so one code and value width
// holds for the whole table.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// launches on the given stream, never synchronizes, and returns the
// cudaError_t of the launch (0 = success) or -1 for an argument it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > (int64_t)1 << 30) b = (int64_t)1 << 30;  // grid-stride covers the rest
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename C, typename U>
__global__ void pack_kernel(const C* __restrict__ codes, U base, U* __restrict__ out,
                            int64_t n) {
  // unsigned arithmetic: the wrap is defined, and bit-identical to the
  // signed two's-complement add of the reference
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = (U)codes[i] + base;
}

template <typename C, typename V>
__global__ void dict_kernel(const C* __restrict__ codes, const V* __restrict__ vocab,
                            int64_t nvocab, V* __restrict__ out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t c = (int64_t)codes[i];
    // XLA gathers clamp out-of-range indices; codes are in-domain by
    // construction, the clamp only keeps a corrupt code from faulting
    out[i] = vocab[c < nvocab ? c : nvocab - 1];
  }
}

template <typename V>
__global__ void rle_kernel(const V* __restrict__ vals, const int64_t* __restrict__ ends,
                           int64_t nruns, V* __restrict__ out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t lo = 0, hi = nruns;  // first j with ends[j] > i
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (ends[mid] > i) hi = mid; else lo = mid + 1;
    }
    out[i] = vals[lo < nruns ? lo : nruns - 1];
  }
}

template <typename C>
int launch_pack(const void* codes, int64_t base_bits, int out_bytes, void* out, int64_t n,
                cudaStream_t s) {
  if (out_bytes == 8)
    pack_kernel<C, uint64_t><<<grid_for(n), kThreads, 0, s>>>(
        (const C*)codes, (uint64_t)base_bits, (uint64_t*)out, n);
  else if (out_bytes == 4)
    pack_kernel<C, uint32_t><<<grid_for(n), kThreads, 0, s>>>(
        (const C*)codes, (uint32_t)base_bits, (uint32_t*)out, n);
  else
    return -1;
  return (int)cudaGetLastError();
}

template <typename C>
int launch_dict(const void* codes, const void* vocab, int64_t nvocab, int elem_bytes,
                void* out, int64_t n, cudaStream_t s) {
  if (elem_bytes == 8)
    dict_kernel<C, uint64_t><<<grid_for(n), kThreads, 0, s>>>(
        (const C*)codes, (const uint64_t*)vocab, nvocab, (uint64_t*)out, n);
  else if (elem_bytes == 4)
    dict_kernel<C, uint32_t><<<grid_for(n), kThreads, 0, s>>>(
        (const C*)codes, (const uint32_t*)vocab, nvocab, (uint32_t*)out, n);
  else
    return -1;
  return (int)cudaGetLastError();
}

// One task's entry of a lane's task table (an int64 [G, 5] tensor on the
// card, laid out by kernels/grouped.py).
struct TaskLane {
  const void* src;  // pack codes / dict codes / rle run values
  const void* aux;  // dict vocab / inclusive rle run ends (int64); null for pack
  int64_t naux;     // vocab length / run count
  int64_t base;     // pack base bits
  void* out;        // this task's row of the [G, width] output
};

template <typename C, typename U>
__global__ void pack_tasks_kernel(const TaskLane* __restrict__ tab, int64_t width) {
  const TaskLane t = tab[blockIdx.y];
  const C* __restrict__ codes = (const C*)t.src;
  U* __restrict__ out = (U*)t.out;
  const U base = (U)t.base;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = (U)codes[i] + base;
}

template <typename C, typename V>
__global__ void dict_tasks_kernel(const TaskLane* __restrict__ tab, int64_t width) {
  const TaskLane t = tab[blockIdx.y];
  const C* __restrict__ codes = (const C*)t.src;
  const V* __restrict__ vocab = (const V*)t.aux;
  V* __restrict__ out = (V*)t.out;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t c = (int64_t)codes[i];
    out[i] = vocab[c < t.naux ? c : t.naux - 1];
  }
}

template <typename V>
__global__ void rle_tasks_kernel(const TaskLane* __restrict__ tab, int64_t width) {
  const TaskLane t = tab[blockIdx.y];
  const V* __restrict__ vals = (const V*)t.src;
  const int64_t* __restrict__ ends = (const int64_t*)t.aux;
  V* __restrict__ out = (V*)t.out;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t lo = 0, hi = t.naux;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (ends[mid] > i) hi = mid; else lo = mid + 1;
    }
    out[i] = vals[lo < t.naux ? lo : t.naux - 1];
  }
}

inline dim3 task_grid(int64_t width, int G) {
  int64_t b = (width + kThreads - 1) / kThreads;
  if (b > 65535) b = 65535;  // grid-stride covers the rest
  return dim3((unsigned)(b < 1 ? 1 : b), (unsigned)G);
}

}  // namespace

extern "C" int tt_decode_pack_tasks(const void* table, int G, int code_bytes, int out_bytes,
                                    int64_t width, void* stream) {
  if (G < 1 || G > 65535) return -1;
  if (width <= 0) return 0;
  const TaskLane* t = (const TaskLane*)table;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = task_grid(width, G);
#define PACK(C)                                                                      \
  if (out_bytes == 8) pack_tasks_kernel<C, uint64_t><<<g, kThreads, 0, s>>>(t, width); \
  else if (out_bytes == 4) pack_tasks_kernel<C, uint32_t><<<g, kThreads, 0, s>>>(t, width); \
  else return -1;
  switch (code_bytes) {
    case 1: PACK(uint8_t) break;
    case 2: PACK(uint16_t) break;
    case 4: PACK(uint32_t) break;
    default: return -1;
  }
#undef PACK
  return (int)cudaGetLastError();
}

extern "C" int tt_decode_dict_tasks(const void* table, int G, int code_bytes, int elem_bytes,
                                    int64_t width, void* stream) {
  if (G < 1 || G > 65535) return -1;
  if (width <= 0) return 0;
  const TaskLane* t = (const TaskLane*)table;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = task_grid(width, G);
#define DICT(C)                                                                      \
  if (elem_bytes == 8) dict_tasks_kernel<C, uint64_t><<<g, kThreads, 0, s>>>(t, width); \
  else if (elem_bytes == 4) dict_tasks_kernel<C, uint32_t><<<g, kThreads, 0, s>>>(t, width); \
  else return -1;
  switch (code_bytes) {
    case 1: DICT(uint8_t) break;
    case 2: DICT(uint16_t) break;
    case 4: DICT(uint32_t) break;
    default: return -1;
  }
#undef DICT
  return (int)cudaGetLastError();
}

extern "C" int tt_decode_rle_tasks(const void* table, int G, int elem_bytes, int64_t width,
                                   void* stream) {
  if (G < 1 || G > 65535) return -1;
  if (width <= 0) return 0;
  const TaskLane* t = (const TaskLane*)table;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = task_grid(width, G);
  switch (elem_bytes) {
    case 1: rle_tasks_kernel<uint8_t><<<g, kThreads, 0, s>>>(t, width); break;
    case 4: rle_tasks_kernel<uint32_t><<<g, kThreads, 0, s>>>(t, width); break;
    case 8: rle_tasks_kernel<uint64_t><<<g, kThreads, 0, s>>>(t, width); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_decode_pack(const void* codes, int code_bytes, int64_t base_bits,
                              int out_bytes, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1: return launch_pack<uint8_t>(codes, base_bits, out_bytes, out, n, s);
    case 2: return launch_pack<uint16_t>(codes, base_bits, out_bytes, out, n, s);
    case 4: return launch_pack<uint32_t>(codes, base_bits, out_bytes, out, n, s);
    default: return -1;
  }
}

extern "C" int tt_decode_dict(const void* codes, int code_bytes, const void* vocab,
                              int64_t nvocab, int elem_bytes, void* out, int64_t n,
                              void* stream) {
  if (n <= 0) return 0;
  if (nvocab <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1: return launch_dict<uint8_t>(codes, vocab, nvocab, elem_bytes, out, n, s);
    case 2: return launch_dict<uint16_t>(codes, vocab, nvocab, elem_bytes, out, n, s);
    case 4: return launch_dict<uint32_t>(codes, vocab, nvocab, elem_bytes, out, n, s);
    default: return -1;
  }
}

extern "C" int tt_decode_rle(const void* vals, int elem_bytes, const int64_t* ends,
                             int64_t nruns, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (nruns <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1:
      rle_kernel<uint8_t><<<grid_for(n), kThreads, 0, s>>>(
          (const uint8_t*)vals, ends, nruns, (uint8_t*)out, n);
      break;
    case 4:
      rle_kernel<uint32_t><<<grid_for(n), kThreads, 0, s>>>(
          (const uint32_t*)vals, ends, nruns, (uint32_t*)out, n);
      break;
    case 8:
      rle_kernel<uint64_t><<<grid_for(n), kThreads, 0, s>>>(
          (const uint64_t*)vals, ends, nruns, (uint64_t*)out, n);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
