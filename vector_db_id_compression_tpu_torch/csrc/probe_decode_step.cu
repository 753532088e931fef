// Decode-step probe (K4), one thread per lane.
//
// Replaces the TPU kernel tools/profiling/profile_pallas2.py (`kernel`,
// launched by `run`): `steps` steps in the shape of one ROC decode step, per
// lane b with carry (ptr, x), ptr starting at capp / 2 and x at 7 p[b]:
//   w     = buf[ptr - 1, b] (0 where ptr - 1 lies outside [0, capp))
//   buf[ptr, b] = x         (nothing where ptr lies outside [0, capp))
//   rank  = #{j < i : syms[j, b] < x}, compared as signed i32
//   syms[i, b] = x
//   emit[i, b] = w + rank + (2^30 / (i + 1)) + ((1 << p) - 1) + (x >>> p)
//   ptr  += (w & 1) - (rank & 1);  x += w + rank
// with i32 arithmetic that wraps (done here in uint32_t, since signed overflow
// is undefined in C++) and >>> a logical shift. The TPU kernel does the gather
// and scatter as one-hot passes over buf and writes buf in place; here they
// are indexed accesses to a scratch copy of buf, as the decode kernel works on
// a copy of each stack. The plain version is ops/probes.py::
// probe_decode_step_plain.
//
// What bounds it on the H100: the rank pass, an O(i) count per step over the
// global-memory symbol scratch ([steps, lanes] layout, so a warp's loads
// coalesce), about steps^2 / 2 = 605,000 loads per lane at 1100 steps; the
// serial carry (shift, divide, gather, scatter) is a chain of a few dozen
// dependent instructions per step. 256 lanes are 8 warps on 8 of the 132 SMs.
// Set beside the decode kernel's time per step, it separates the decode's
// serial chain from its rank pass.
//
// What the design does about it: nothing; it is a probe.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void probe_decode_step_kernel(const int32_t* __restrict__ buf,
                                         const int32_t* __restrict__ p, int capp,
                                         int B, int steps, int32_t* buf_scratch,
                                         int32_t* syms, int32_t* emit) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int r = 0; r < capp; ++r) buf_scratch[(int64_t)r * B + b] = buf[(int64_t)r * B + b];
  int pb = p[b];
  uint32_t pmask = (1u << pb) - 1u;
  int ptr = capp / 2;
  uint32_t x = (uint32_t)pb * 7u;
  for (int i = 0; i < steps; ++i) {
    uint32_t w = (ptr >= 1 && ptr <= capp)
                     ? (uint32_t)buf_scratch[(int64_t)(ptr - 1) * B + b] : 0u;
    if (ptr >= 0 && ptr < capp) buf_scratch[(int64_t)ptr * B + b] = (int32_t)x;
    uint32_t rank = 0;
    for (int j = 0; j < i; ++j) rank += syms[(int64_t)j * B + b] < (int32_t)x ? 1u : 0u;
    syms[(int64_t)i * B + b] = (int32_t)x;
    uint32_t q = (uint32_t)((1 << 30) / (i + 1));
    emit[(int64_t)i * B + b] = (int32_t)(w + rank + q + pmask + (x >> pb));
    ptr += (int)(w & 1u) - (int)(rank & 1u);
    x += w + rank;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). buf i32[capp, B], p i32[B] with
// values in [0, 32). Outputs, allocated by the caller: emit i32[steps, B];
// scratch buf_scratch i32[capp, B] and syms i32[steps, B]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int probe_decode_step_launch(const void* buf, const void* p, int capp,
                                        int B, int steps, void* buf_scratch,
                                        void* syms, void* emit, void* stream) {
  if (B <= 0) return 0;
  probe_decode_step_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)buf, (const int32_t*)p, capp, B, steps, (int32_t*)buf_scratch,
      (int32_t*)syms, (int32_t*)emit);
  return (int)cudaGetLastError();
}
