// Dependent-gather probe (K3), one thread per row.
//
// Replaces the TPU kernel tools/profiling/profile_pallas.py (`kernel`,
// launched by `run`): for `steps` steps, idx = (idx + (win[b, idx] & 1)) % W
// per row b, where the TPU kernel gathers win[b, idx] with a one-hot
// compare-and-sum over the row. Here the gather is an indexed load. The plain
// version is ops/probes.py::probe_gather_plain.
//
// What bounds it on the H100: each step's load address depends on the
// previous load, so a thread pays one memory latency per step (L1 after the
// first touch of its 512-byte row) — the dependent-load latency that the ROC
// decode pays in its refill and rank passes. 256 rows are 8 warps on 8 of the
// 132 SMs.
//
// What the design does about it: nothing; it is a probe of that latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void probe_gather_kernel(const int32_t* __restrict__ win,
                                    const int32_t* __restrict__ idx0, int B,
                                    int W, int steps, int32_t* out) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* row = win + (int64_t)b * W;
  int idx = idx0[b];
  for (int i = 0; i < steps; ++i) idx = (idx + (row[idx] & 1)) % W;
  out[b] = idx;
}

}  // namespace

// Plain C entry point (bound with ctypes). win i32[B, W] (u32 bit patterns),
// idx0 i32[B] with values in [0, W); out i32[B], allocated by the caller.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_gather_launch(const void* win, const void* idx0, int B, int W,
                                   int steps, void* out, void* stream) {
  if (B <= 0) return 0;
  probe_gather_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)win, (const int32_t*)idx0, B, W, steps, (int32_t*)out);
  return (int)cudaGetLastError();
}
