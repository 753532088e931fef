// ROC multiset encode, one thread per lane (one lane = one inverted list, or
// one block of graph nodes whose S neighbour sets are chained through one
// state).
//
// Replaces the TPU kernel vector_db_id_compression_tpu/ops/roc_encode_pallas.py
// (_encode_kernel, launched by _encode_call). It computes what that kernel and
// the plain version codecs/roc_device.py::roc_encode_batch compute, lane for
// lane and bit for bit: per step i, with nmax = n - i, pop_with_finer_precision
// (nmax), then select and remove the idx-th smallest remaining id, recording
// its sorted slot in `order`, then codec_push(symbol) in 16-bit slices.
//
// Chained mode (S > 1) is the RocBlockGraph build, which the JAX package runs
// as an XLA scan (codecs/roc_device.py::roc_encode_chained) and which has no
// Pallas kernel: the same steps for slots S-1, ..., 0 in turn on one state
// per lane, empty slots as no-ops, no sampling order kept. Its plain version
// is codecs/roc_device.py::roc_encode_chained; as a loop of plain launches it
// would cost S x n_max steps of small launches.
//
// What bounds it on the H100: each lane is one serial dependency chain of
// 64-bit divides, shifts and compares, so the kernel is latency-bound; the
// select is a Fenwick tree in global memory ([n_max + 1, B] layout, reused by
// every slot), O(log n) dependent loads per step. With 1024 lists and 32
// threads per block only 32 of the 132 SMs hold a warp; the graph's 62,500
// blocks fill them all, 16 slots of up to 32 steps per thread.
//
// What the design does about it: nothing yet. A simple kernel that is right
// comes first. Spreading a lane's work over a warp (parallel select), keeping
// the tree in shared memory, and more lanes per SM are the first things a
// performance change attacks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "roc_lane.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void roc_encode_kernel(const uint64_t* __restrict__ sorted_ids,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ precision,
                                  int B, int S, int stride, int n_max,
                                  const uint32_t* __restrict__ pool, int pool_size,
                                  int n_slices, int32_t* tree, uint64_t* head,
                                  uint32_t* stack, int cap, int32_t* stack_len,
                                  int32_t* mt_ctr, int32_t* order, int32_t* err) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  roc::LaneState s{roc::RANS_L,
                   roc::Strided<uint32_t>{stack + (int64_t)lane * cap, 1},
                   cap, 0, pool, pool_size, 0, 0};
  roc::encode_slots(s, sorted_ids + (int64_t)lane * S * n_max,
                    lengths + (int64_t)lane * S, precision + (int64_t)lane * S, S,
                    n_slices, roc::Strided<int32_t>{tree + lane, stride},
                    order ? order + (int64_t)lane * n_max : nullptr, n_max);
  head[lane] = s.head;
  stack_len[lane] = s.len;
  mt_ctr[lane] = s.mt_ctr;
  err[lane] = s.err;
}

}  // namespace

// Plain C entry point (bound with ctypes). Inputs: sorted_ids u64[B, S, n_max]
// (ascending in [0, len) per slot), lengths and precision i32[B, S], pool
// u32[pool_size]. Outputs, allocated by the caller: head u64[B], stack
// u32[B, cap] (zero-filled), stack_len, mt_ctr, err i32[B], and order
// i32[B, n_max] for S = 1 (null for S > 1: chained encode keeps no order);
// scratch tree i32[n_max + 1, stride], with stride >= B a multiple of 32 (warp
// rows start on a cache-line boundary). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int roc_encode_launch(const void* sorted_ids, const void* lengths,
                                 const void* precision, int B, int S, int stride,
                                 int n_max,
                                 const void* pool, int pool_size, int n_slices,
                                 void* tree, void* head, void* stack, int cap,
                                 void* stack_len, void* mt_ctr, void* order,
                                 void* err, void* stream) {
  if (B <= 0) return 0;
  roc_encode_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint64_t*)sorted_ids, (const int32_t*)lengths,
      (const int32_t*)precision, B, S, stride, n_max, (const uint32_t*)pool,
      pool_size, n_slices, (int32_t*)tree, (uint64_t*)head, (uint32_t*)stack, cap,
      (int32_t*)stack_len, (int32_t*)mt_ctr, (int32_t*)order, (int32_t*)err);
  return (int)cudaGetLastError();
}
