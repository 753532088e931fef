// Decode-step probe (K4): a warp per lane, the lane's state in shared memory.
//
// Replaces the TPU kernel tools/profiling/profile_pallas2.py (`kernel`,
// launched by `run`): `steps` steps in the shape of one ROC decode step per
// lane b (probe_lane.cuh decode_steps: a gather from buf at ptr - 1, a scatter
// to buf at ptr, the rank of the current value among the earlier ones, the
// emit, the carry), where the TPU kernel keeps buf, the symbols and the emits
// in VMEM, on-chip memory, and gathers and scatters with one-hot passes. The
// plain version is ops/probes.py::probe_decode_step_plain.
//
// What bounds it on the H100: each lane is one chain of dependent steps. The
// next value waits for the rank of this one, a count over every earlier
// symbol; the next gather's address waits for the rank and the gather before
// it. The bytes (buf in, the emits out: 2 MB) take 0.6 us, the compares
// (1100^2 / 2 per lane) spread over the card 5 us, so the bound is the chain:
// chip_smoke.py probe_latency_bounds takes a step's floor as the lesser of
// two links read with clock64() (probe_step_latency below), a compare, a warp
// reduction of counts and an add, or a compare, a ballot, its population
// count and an add.
//
// What the design does about it, K1's structure (roc_decode.cu, roc_lane.cuh
// LaneWarp), then the step cut to the fewest instructions, since one warp
// issues about one a cycle (probe_lane.cuh, K4):
//   - a warp per lane, a block of ceil(lanes / SMs) lanes (2 for 256 lanes
//     on 132 SMs), so the 256 warps spread over the card;
//   - the lane's state on chip: its copy of buf, its symbols past the
//     registers and its emits in shared memory (12 KB a lane at the probe's
//     shape), buf staged in before the chain (32 loads a thread in flight)
//     and the emits written out after it;
//   - the rank split over the 32 threads: thread t holds the symbols j = t
//     (mod 32), the first 36 in registers (the probe's 1100 steps need 35),
//     and counts those below the value with a compare and a predicated add
//     each, unrolled over as many registers as the step can have filled
//     (segments of 128 steps, each counting 4 more: no loads, no loop, no
//     jump table); one __reduce_add_sync sums the 32 counts;
//   - no branch in a step: the 32 threads carry the same (ptr, x, w), so the
//     gather is a broadcast, the scatter and the emit are stores of one value
//     by every thread, the range checks predicate them (PTX on 32-bit shared
//     addresses), and the appends of the symbols sit outside the steps'
//     loop, once every 32 steps;
//   - the emit's terms that depend on its step and lane alone (2^30 / (i + 1)
//     and (1 << p) - 1) added as the emits are written out, off the chain.
// Shared-memory threshold: the wrapper refuses a shape one lane of which
// does not fit a block's shared memory (probe_lane.cuh decode_step_lane_bytes
// against ops/_build.py SHARED_BYTES_PER_BLOCK).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "probe_lane.cuh"

namespace {

constexpr int kStage = 32;  // rows of buf a thread loads at once

__global__ void probe_decode_step_kernel(const int32_t* __restrict__ buf,
                                         const int32_t* __restrict__ p, int capp, int B,
                                         int steps, int32_t* __restrict__ emit) {
  extern __shared__ __align__(16) int32_t smem[];
  const int L = blockDim.x / roc::kWarpSize;  // lanes of a block
  const int l = threadIdx.x / roc::kWarpSize;
  const int t = threadIdx.x % roc::kWarpSize;
  const int b = blockIdx.x * L + l;
  if (b >= B) return;  // the whole warp
  // lane l's copy of buf (capp words), its symbols past the registers and its
  // emits (steps words each)
  int32_t* lane = smem + (int64_t)l * (capp + 2 * steps);
  int32_t* emits = lane + capp + steps;
  // its column of buf, kStage rows a thread at a time: the loads of a batch
  // all in flight before its stores
  const int32_t* col = buf + b;
  for (int r0 = t; r0 < capp; r0 += kStage * roc::kWarpSize) {
    int32_t v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int r = r0 + k * roc::kWarpSize;
      v[k] = r < capp ? __ldg(col + (int64_t)r * B) : 0;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k)
      if (r0 + k * roc::kWarpSize < capp) lane[r0 + k * roc::kWarpSize] = v[k];
  }
  __syncwarp();
  const int pb = p[b];
  probe::decode_steps(lane, capp, lane + capp, steps, pb, emits, 1, t);
  __syncwarp();
  // its emits, each with the terms that depend on its step and lane alone
  for (int i = t; i < steps; i += roc::kWarpSize)
    emit[(int64_t)i * B + b] = (int32_t)((uint32_t)emits[i] + probe::emit_terms(i, pb));
}

// Cycles of three dependent chains on one warp, `iters` links each, read
// with clock64(): two links of a rank, what K4's next value waits for at the
// least, x += __reduce_add_sync(s < x) (a compare, a warp reduction of the
// counts, an add) and x += popc(ballot(s < x)) (a compare, a warp ballot of
// the bits, its count, an add); and a shared-memory pointer chase (one
// dependent load a link). Also the nanoseconds of the first chain on the
// global timer, which give the SM clock it ran at.
__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__global__ void probe_step_latency_kernel(int iters, const int32_t* __restrict__ seed,
                                          long long* cycles, int32_t* sink) {
  __shared__ int32_t chase[32 * roc::kWarpSize];
  const int t = threadIdx.x;
  for (int j = 0; j < 32; ++j) chase[j * roc::kWarpSize + t] = (((j + 1) & 31) * 32 + t) * 4;
  __syncwarp();
  const int32_t s = seed[t];
  uint32_t x = (uint32_t)seed[roc::kWarpSize];
  const long long n0 = global_ns();
  const long long c0 = clock64();
  for (int k = 0; k < iters; ++k) x += __reduce_add_sync(0xFFFFFFFFu, s < (int32_t)x ? 1u : 0u);
  const long long c1 = clock64();
  const long long n1 = global_ns();
  for (int k = 0; k < iters; ++k) x += (uint32_t)__popc(__ballot_sync(0xFFFFFFFFu, s < (int32_t)x));
  const long long c2 = clock64();
  const int off = probe::gather_chain(chase, t * 4, iters);
  const long long c3 = clock64();
  sink[t] = (int32_t)x + off;
  if (t == 0) {
    cycles[0] = c1 - c0;
    cycles[1] = c3 - c2;
    cycles[2] = n1 - n0;
    cycles[3] = c2 - c1;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). buf i32[capp, B], p i32[B] with
// values in [0, 32); emit i32[steps, B], allocated by the caller; buf is only
// read; shared_bytes the dynamic shared memory a block may use (ops/_build.py
// SHARED_BYTES_PER_BLOCK), which one lane must fit. Launches on `stream` and
// returns cudaGetLastError() (or the error of raising the block's
// shared-memory limit).
extern "C" int probe_decode_step_launch(const void* buf, const void* p, int capp, int B,
                                        int steps, int shared_bytes, void* emit,
                                        void* stream) {
  if (B <= 0) return 0;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t lane_bytes = probe::decode_step_lane_bytes(capp, steps);
  // as few lanes a block as spread them over every SM, as many as fit
  const int lanes = (int)std::max<int64_t>(
      1, std::min<int64_t>(std::min((B + sms - 1) / sms, 32), shared_bytes / lane_bytes));
  const size_t smem = (size_t)(lanes * lane_bytes);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        probe_decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_decode_step_kernel<<<(B + lanes - 1) / lanes, lanes * roc::kWarpSize, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)buf, (const int32_t*)p, capp, B, steps, (int32_t*)emit);
  return (int)cudaGetLastError();
}

// seed i32[33] (the 32 threads' symbols, then the start value); cycles
// i64[4] (the reduction rank chain's cycles, the load chain's, the
// reduction chain's nanoseconds, the ballot rank chain's cycles); sink
// i32[32]. One warp.
extern "C" int probe_step_latency_launch(int iters, const void* seed, void* cycles, void* sink,
                                         void* stream) {
  probe_step_latency_kernel<<<1, roc::kWarpSize, 0, (cudaStream_t)stream>>>(
      iters, (const int32_t*)seed, (long long*)cycles, (int32_t*)sink);
  return (int)cudaGetLastError();
}
