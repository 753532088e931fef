// Chain probe: the serial rANS chain of ROC lanes with no rank and no select
// work (roc_lane.cuh decode_chain, encode_chain), one lane per block.
//
// Replaces no TPU kernel. It measures the floor of a step of the two ROC
// kernels (roc_decode.cu, roc_encode.cu): the decode chain takes each step's
// rank as given, the encode chain each step's id in sampling order, so that a
// step is only the chain's own dependent arithmetic (pop_symbol and push_mod,
// or pop_mod and push_symbol) and its stack words. Given the ranks the decode
// computes, and the ids in the order the encode selects them, it reproduces
// the codec bit for bit: its plain versions are ops/probes.py::
// chain_decode_plain and chain_encode_plain.
//
// The block's threads stage the lane's inputs (ranks or ids) and its stack
// copy into shared memory first, so the chain's loads are shared loads that do
// not depend on the head; then thread 0 runs the chain; then the block writes
// the outputs. The time of one lane is the chain's length times its step, on
// one thread with nothing else to wait for.
#include <cuda_runtime.h>
#include <stdint.h>

#include "roc_lane.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void probe_chain_decode_kernel(const uint64_t* __restrict__ head,
                                          const uint32_t* __restrict__ stack, int cap,
                                          const int32_t* __restrict__ stack_len,
                                          const int32_t* __restrict__ mt_ctr,
                                          const int32_t* __restrict__ lengths,
                                          const int32_t* __restrict__ precision,
                                          const int32_t* __restrict__ ranks, int n_max,
                                          const uint32_t* __restrict__ pool, int pool_size,
                                          int n_slices, uint64_t* syms_out, int32_t* err) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* syms = reinterpret_cast<uint64_t*>(smem);
  int32_t* rk = reinterpret_cast<int32_t*>(syms + n_max);
  uint32_t* stk = reinterpret_cast<uint32_t*>(rk + n_max);
  const int64_t b = blockIdx.x;
  const int n = lengths[b], len = stack_len[b];
  for (int j = threadIdx.x; j < n; j += blockDim.x) rk[j] = ranks[b * n_max + j];
  for (int j = threadIdx.x; j < len && j < cap; j += blockDim.x) stk[j] = stack[b * cap + j];
  __syncthreads();
  if (threadIdx.x == 0) {
    roc::LaneState<roc::Stack<false>> s{head[b], {stk}, cap, len, pool, pool_size, mt_ctr[b], 0};
    roc::decode_chain(s, n, precision[b], n_slices, rk, syms);
    err[b] = s.err;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_max; j += blockDim.x)
    syms_out[b * n_max + j] = j < n ? syms[j] : 0;
}

__global__ void probe_chain_encode_kernel(const uint64_t* __restrict__ ids,
                                          const int32_t* __restrict__ lengths,
                                          const int32_t* __restrict__ precision, int n_max,
                                          const uint32_t* __restrict__ pool, int pool_size,
                                          int n_slices, uint64_t* head, uint32_t* stack, int cap,
                                          int32_t* stack_len, int32_t* mt_ctr, int32_t* err) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int height;
  uint64_t* sym = reinterpret_cast<uint64_t*>(smem);
  uint32_t* stk = reinterpret_cast<uint32_t*>(sym + n_max);
  const int64_t b = blockIdx.x;
  const int n = lengths[b];
  for (int j = threadIdx.x; j < n; j += blockDim.x) sym[j] = ids[b * n_max + j];
  __syncthreads();
  if (threadIdx.x == 0) {
    roc::LaneState<roc::Stack<false>> s{roc::RANS_L, {stk}, cap, 0, pool, pool_size, 0, 0};
    roc::encode_chain(s, sym, n, precision[b], n_slices);
    head[b] = s.head;
    stack_len[b] = s.len;
    mt_ctr[b] = s.mt_ctr;
    err[b] = s.err;
    height = s.len < cap ? s.len : cap;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < height; j += blockDim.x) stack[b * cap + j] = stk[j];
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// Plain C entry points (bound with ctypes); each launches one block per lane
// on `stream` and returns the CUDA error code (an error where a lane's
// buffers exceed the card's shared memory per block).
//
// Decode: head u64[B], stack u32[B, cap], stack_len, mt_ctr, lengths,
// precision i32[B], ranks i32[B, n_max] (the rank of each step), pool
// u32[pool_size]. Outputs: syms u64[B, n_max] (decode order, zeros past each
// length), err i32[B].
extern "C" int probe_chain_decode_launch(const void* head, const void* stack, int cap,
                                         const void* stack_len, const void* mt_ctr,
                                         const void* lengths, const void* precision,
                                         const void* ranks, int B, int n_max,
                                         const void* pool, int pool_size, int n_slices,
                                         void* syms, void* err, void* stream) {
  if (B <= 0) return 0;
  size_t smem = (size_t)n_max * 12 + (size_t)cap * 4;
  int e = set_smem((const void*)probe_chain_decode_kernel, smem);
  if (e) return e;
  probe_chain_decode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)head, (const uint32_t*)stack, cap, (const int32_t*)stack_len,
      (const int32_t*)mt_ctr, (const int32_t*)lengths, (const int32_t*)precision,
      (const int32_t*)ranks, n_max, (const uint32_t*)pool, pool_size, n_slices,
      (uint64_t*)syms, (int32_t*)err);
  return (int)cudaGetLastError();
}

// Encode: ids u64[B, n_max] (each lane's ids in sampling order), lengths,
// precision i32[B], pool u32[pool_size]. Outputs: head u64[B], stack
// u32[B, cap] (zero-filled by the caller), stack_len, mt_ctr, err i32[B].
extern "C" int probe_chain_encode_launch(const void* ids, const void* lengths,
                                         const void* precision, int B, int n_max,
                                         const void* pool, int pool_size, int n_slices,
                                         void* head, void* stack, int cap, void* stack_len,
                                         void* mt_ctr, void* err, void* stream) {
  if (B <= 0) return 0;
  size_t smem = (size_t)n_max * 8 + (size_t)cap * 4;
  int e = set_smem((const void*)probe_chain_encode_kernel, smem);
  if (e) return e;
  probe_chain_encode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)ids, (const int32_t*)lengths, (const int32_t*)precision, n_max,
      (const uint32_t*)pool, pool_size, n_slices, (uint64_t*)head, (uint32_t*)stack, cap,
      (int32_t*)stack_len, (int32_t*)mt_ctr, (int32_t*)err);
  return (int)cudaGetLastError();
}
