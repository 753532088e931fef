// ROC multiset decode, one thread per lane (one lane = one inverted list).
//
// Replaces the TPU kernel vector_db_id_compression_tpu/ops/roc_pallas.py
// (_decode_kernel, launched by _decode_call) in its plain mode S = 1. It
// computes what that kernel and the plain version
// codecs/roc_device.py::roc_decode_batch compute, lane for lane and bit for
// bit: per step i, codec_pop (16-bit slices, high first, refilling from the
// stack or the MT19937 pool at mt_ctr), the rank = the count of earlier
// symbols strictly smaller, push_with_finer_precision(rank, i + 1), and the
// symbol emitted at its sampling-order slot n - 1 - i. Output is always in
// encode sampling order.
//
// Decode pops and spills stack words, so each lane works on a per-call
// scratch copy of its stored stack: the stored stream is never written, and
// the next search decodes the same lists again.
//
// What bounds it on the H100: each lane is one serial dependency chain, so
// the kernel is latency-bound, plus the rank pass, an O(i) count per step over
// a global-memory scratch ([n_max, lanes] layout, so a warp's loads coalesce
// when its lanes are at the same step) — O(n^2) loads per list. With a few
// hundred to 1024 touched lists and 32 threads per block, most of the 132 SMs
// are idle.
//
// What the design does about it: nothing yet. A simple kernel that is right
// comes first. A rank-space Fenwick tree (native/roc_native.cpp:143-220 in the
// JAX package), a warp-wide rank count, and more lanes per SM are the first
// things a performance change attacks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "roc_lane.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void roc_decode_kernel(const uint64_t* __restrict__ head,
                                  const uint32_t* __restrict__ stack, int cap,
                                  const int32_t* __restrict__ stack_len,
                                  const int32_t* __restrict__ mt_ctr,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ precision,
                                  const int64_t* __restrict__ lanes, int Q,
                                  int stride, const uint32_t* __restrict__ pool,
                                  int pool_size, int n_slices, int n_max,
                                  uint32_t* stack_scratch, uint64_t* syms,
                                  int64_t* ids, int32_t* err) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  int64_t row = lanes[q];
  roc::Strided<uint32_t> scratch{stack_scratch + q, stride};
  int len = stack_len[row];
  const uint32_t* stored = stack + row * cap;
  for (int j = 0; j < len && j < cap; ++j) scratch[j] = stored[j];
  roc::LaneState s{head[row], scratch, cap, len, pool, pool_size, mt_ctr[row], 0};
  roc::decode_lane(s, lengths[row], precision[row], n_slices,
                   roc::Strided<uint64_t>{syms + q, stride}, ids + (int64_t)q * n_max,
                   n_max);
  err[q] = s.err;
}

}  // namespace

// Plain C entry point (bound with ctypes). Decodes the Q lanes lanes[0, Q) of
// a lane table: head u64[L], stack u32[L, cap], stack_len, mt_ctr, lengths,
// precision i32[L]; pool u32[pool_size]. Outputs, allocated by the caller:
// ids i64[Q, n_max], err i32[Q]; scratch: stack_scratch u32[cap, stride],
// syms u64[n_max, stride], with stride >= Q a multiple of 32 so that every
// warp's row segment starts on a cache-line boundary (on an H100, 1023 lanes
// at stride 1023 took 29% longer than 1024 lanes). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int roc_decode_launch(const void* head, const void* stack, int cap,
                                 const void* stack_len, const void* mt_ctr,
                                 const void* lengths, const void* precision,
                                 const void* lanes, int Q, int stride,
                                 const void* pool, int pool_size, int n_slices,
                                 int n_max, void* stack_scratch, void* syms,
                                 void* ids, void* err, void* stream) {
  if (Q <= 0) return 0;
  roc_decode_kernel<<<(Q + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint64_t*)head, (const uint32_t*)stack, cap,
      (const int32_t*)stack_len, (const int32_t*)mt_ctr,
      (const int32_t*)lengths, (const int32_t*)precision,
      (const int64_t*)lanes, Q, stride, (const uint32_t*)pool, pool_size,
      n_slices, n_max, (uint32_t*)stack_scratch, (uint64_t*)syms,
      (int64_t*)ids, (int32_t*)err);
  return (int)cudaGetLastError();
}

// Message for a code returned by either launch function.
extern "C" const char* roc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
