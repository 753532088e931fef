// Dependent-gather probe (K3): a thread per row, the rows' windows in shared
// memory.
//
// Replaces the TPU kernel tools/profiling/profile_pallas.py (`kernel`,
// launched by `run`): for `steps` steps, idx = (idx + (win[b, idx] & 1)) % W
// per row b, where the TPU kernel keeps the window in VMEM, on-chip memory,
// and gathers win[b, idx] with a one-hot compare-and-sum over the row. The
// plain version is ops/probes.py::probe_gather_plain.
//
// What bounds it on the H100: each step's address depends on the previous
// step's load, so a row pays one load latency per step, 1100 in a row; the
// bytes (128 KB of windows) take 0.04 us. The floor is a dependent
// shared-memory load per step (chip_smoke.py probe_latency_bounds: the
// lesser of the published SHARED_LOAD_CYCLES and the card's clock64()
// reading).
//
// What the design does about it (probe_lane.cuh):
//   - on-chip, as on the TPU: each block stages the windows of its 32 rows
//     into shared memory with all its 256 threads (a warp reads one column of
//     the 32 rows, 16 columns a thread in flight, each row's 128-byte lines
//     cached in L1 after their first touch), then one warp runs the 32
//     chains;
//   - a layout without bank conflicts: element (j, row r) at word 32 j + r, so
//     the 32 rows of the warp read 32 different banks whatever their indices
//     (rows at a stride of W = 128 words would all read one bank, and the
//     rows start together at idx 0 and move by 0 or 1 a step);
//   - the step tabulated: each word holds the byte offset of its row's
//     successor, (idx + (w & 1)) mod W computed for every element while
//     staging, the wrap one compare since idx + (w & 1) lies in [0, W]; a
//     step is then one shared load whose result is the next load's address,
//     with no arithmetic and no run-time division between them.
// Shared-memory threshold: the 32 rows' windows take 128 W bytes; the
// wrapper refuses a W whose windows do not fit one block's shared memory
// (ops/_build.py SHARED_BYTES_PER_BLOCK).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_lane.cuh"

namespace {

constexpr int kStageThreads = 256;  // threads of a block: all stage, one warp chains
constexpr int kStage = 16;          // columns a thread loads at once

__global__ void probe_gather_kernel(const int32_t* __restrict__ win,
                                    const int32_t* __restrict__ idx0, int B, int W,
                                    int steps, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t table[];  // [W][kGatherRows] byte offsets
  const int r = threadIdx.x % probe::kGatherRows;
  const int b = blockIdx.x * probe::kGatherRows + r;
  // warp c stages the columns j = c (mod warps), kStage of them at a time:
  // the loads of a batch all in flight before its stores; rows past B chain
  // nowhere
  constexpr int kWarps = kStageThreads / probe::kGatherRows;
  for (int j0 = threadIdx.x / probe::kGatherRows; j0 < W; j0 += kStage * kWarps) {
    int32_t w[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int j = j0 + k * kWarps;
      w[k] = b < B && j < W ? __ldg(win + (int64_t)b * W + j) : 0;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int j = j0 + k * kWarps;
      if (j < W)
        table[j * probe::kGatherRows + r] =
            b < B ? probe::gather_successor(j, r, w[k], W) : probe::gather_offset(j, r);
    }
  }
  __syncthreads();
  if (threadIdx.x >= probe::kGatherRows || b >= B) return;
  const int off = probe::gather_chain(table, probe::gather_offset(idx0[b], r), steps);
  out[b] = probe::gather_index(off);
}

}  // namespace

// Plain C entry point (bound with ctypes). win i32[B, W] (u32 bit patterns),
// idx0 i32[B] with values in [0, W); out i32[B], allocated by the caller.
// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the block's shared-memory limit).
extern "C" int probe_gather_launch(const void* win, const void* idx0, int B, int W,
                                   int steps, void* out, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)W * probe::kGatherRows * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        probe_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_gather_kernel<<<(B + probe::kGatherRows - 1) / probe::kGatherRows, kStageThreads,
                        smem, (cudaStream_t)stream>>>(
      (const int32_t*)win, (const int32_t*)idx0, B, W, steps, (int32_t*)out);
  return (int)cudaGetLastError();
}
