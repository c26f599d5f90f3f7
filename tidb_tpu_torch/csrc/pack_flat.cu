// W2 pack_flat: every output lane of a window program into one int64
// buffer, for a single device-to-host copy.
//
// Replaces tidb_tpu/jaxenv.py:104-138 pack_flat. The buffer is
//
//   [n, kind0, len0, kind1, len1, ... | seg0 | seg1 | ...]
//
// The header is static: kernels/pack_flat.py writes it from the host.
// This kernel writes every segment in one launch, from a table of
// (source pointer, source kind, length, word offset):
//
//   * 8-byte lanes (int64, float64 and uint64 bit patterns) are copied
//     bit for bit;
//   * int32 lanes are widened to int64, float32 lanes to float64 (then
//     bit-cast);
//   * bool lanes are bit-packed 64 rows to a word: bit j of word w holds
//     row 64·w + j (the little-endian order torchenv.unpack_flat reads).
//     One warp makes one word from two 32-lane ballots; rows past the
//     lane's length read as 0, so the tail of the last word is zero.
//
// Bound: bytes. Each source byte is read once and each output word
// written once; the bool lanes shrink 8x on the way.
//
// Plain C interface (nvcc + ctypes): launches on the given stream, never
// synchronizes, returns the cudaError_t of the launch (0 = success) or -1
// for an argument it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum SrcKind : int64_t { S_B64 = 0, S_I32 = 1, S_F32 = 2, S_BOOL = 3 };

struct Seg {  // kernels/pack_flat.py packs these as int64 4-tuples
  const void* src;
  int64_t kind;
  int64_t len;  // rows of the source lane
  int64_t off;  // first output word of the segment
};

__global__ void pack_flat_kernel(const Seg* __restrict__ segs, long long* __restrict__ out) {
  const Seg s = segs[blockIdx.y];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  long long* dst = out + s.off;
  if (s.kind == S_BOOL) {
    const uint8_t* src = (const uint8_t*)s.src;
    const int lane = threadIdx.x & 31;
    const int64_t words = (s.len + 63) / 64;
    // one warp per word; the whole warp takes the same trip count, so
    // every lane is present at each ballot
    for (int64_t w = tid >> 5; w < words; w += stride >> 5) {
      const int64_t r0 = w * 64 + lane, r1 = r0 + 32;
      const unsigned lo = __ballot_sync(0xffffffffu, r0 < s.len && src[r0] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, r1 < s.len && src[r1] != 0);
      if (lane == 0) dst[w] = (long long)(((unsigned long long)hi << 32) | lo);
    }
    return;
  }
  for (int64_t i = tid; i < s.len; i += stride) {
    long long x;
    if (s.kind == S_B64) {
      x = ((const long long*)s.src)[i];
    } else if (s.kind == S_I32) {
      x = (long long)((const int32_t*)s.src)[i];
    } else {
      x = __double_as_longlong((double)((const float*)s.src)[i]);
    }
    dst[i] = x;
  }
}

}  // namespace

extern "C" int tt_pack_flat(const void* segs, int nseg, int64_t max_threads, long long* out,
                            int n_sms, void* stream) {
  if (nseg < 0 || nseg > 65535 || max_threads < 0) return -1;
  if (nseg == 0 || max_threads == 0) return 0;
  const int threads = 256;
  int64_t blocks = (max_threads + threads - 1) / threads;
  const int64_t cap = (int64_t)(n_sms > 0 ? n_sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)nseg);
  pack_flat_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>((const Seg*)segs, out);
  return (int)cudaGetLastError();
}
