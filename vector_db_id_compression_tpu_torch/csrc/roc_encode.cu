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
// 64-bit divides, shifts and compares, one gather of the selected id and the
// select itself, so the kernel is latency-bound: the 32 lanes of a warp
// advance in lockstep, and a launch takes as long as its longest lane. The
// bytes (ids in, stacks and orders out: about 21 MB for IVF1024 over 1M ids)
// take about 6 us at 3.35 TB/s. The chain probe (probe_chain.cu) times the
// chain alone, with each step's id given: chip_smoke.py sets the kernel
// beside it.
//
// What the design does about it (roc_lane.cuh select_remove): the select
// lives in shared memory, as a bitmap of the lane's remaining sorted slots
// (n_max bits) and a Fenwick tree over the words' counts (n_max / 32 rows), in
// [row, lane] layout so that a warp's 32 lanes hit 32 banks whatever their
// rows. The k-th remaining slot costs about log2(n_max / 32) dependent shared
// loads and five popcounts inside the word, instead of log2(n_max) dependent
// global loads; about 0.5 KB a lane at n_max 2127, 17 KB per block of 32.
// Shared-memory threshold: a block of 32 lanes keeps the structure in shared
// memory while 32 lanes' worth fits into the card's limit of dynamic shared
// memory per block (ops/_build.py SHARED_BYTES_PER_BLOCK, 227 KB on the
// H100: lists of up to about 29,000 ids); longer lanes keep the same
// structure in global memory (kShared = false).
#include <cuda_runtime.h>
#include <stdint.h>

#include "roc_lane.cuh"

namespace {

// Rows of a lane's select structure: the bitmap words, then the tree (row 0
// unused).
__host__ __device__ int select_rows(int n_max) {
  return 2 * roc::select_words(n_max) + 1;
}

// kShared places the select structures in dynamic shared memory, else in
// `scratch` (global), with the same carve-up: row r of lane j of block b at
// (b * select_rows + r) * blockDim.x + j.
template <bool kShared>
__global__ void roc_encode_kernel(const uint64_t* __restrict__ sorted_ids,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ precision,
                                  int B, int S, int n_max,
                                  const uint32_t* __restrict__ pool, int pool_size,
                                  int n_slices, uint32_t* scratch, uint64_t* head,
                                  uint32_t* stack, int cap, int32_t* stack_len,
                                  int32_t* mt_ctr, int32_t* order, int32_t* err) {
  extern __shared__ uint32_t smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int64_t block_words = (int64_t)select_rows(n_max) * blockDim.x;
  uint32_t* base = (kShared ? smem : scratch + blockIdx.x * block_words) + threadIdx.x;
  const int words = roc::select_words(n_max);
  roc::Strided<uint32_t> bits{base, blockDim.x};
  roc::Strided<int32_t> tree{reinterpret_cast<int32_t*>(base) + (int64_t)words * blockDim.x,
                             blockDim.x};
  roc::LaneState<roc::Stack<false>> s{roc::RANS_L, {stack + (int64_t)lane * cap}, cap, 0,
                                      pool, pool_size, 0, 0};
  roc::encode_slots(s, sorted_ids + (int64_t)lane * S * n_max, lengths + (int64_t)lane * S,
                    precision + (int64_t)lane * S, S, n_slices, bits, tree,
                    order ? order + (int64_t)lane * n_max : nullptr, n_max);
  head[lane] = s.head;
  stack_len[lane] = s.len;
  mt_ctr[lane] = s.mt_ctr;
  err[lane] = s.err;
}

}  // namespace

// Bytes of one lane's select structure: per lane of a block, in shared or in
// global memory.
extern "C" long long roc_encode_lane_bytes(int n_max) {
  return 4ll * select_rows(n_max);
}

// Plain C entry point (bound with ctypes). Inputs: sorted_ids u64[B, S, n_max]
// (ascending in [0, len) per slot), lengths and precision i32[B, S], pool
// u32[pool_size]. Outputs, allocated by the caller: head u64[B], stack
// u32[B, cap] (zero-filled), stack_len, mt_ctr, err i32[B], and order
// i32[B, n_max] for S = 1 (null for S > 1: chained encode keeps no order).
// `lanes` lanes per block; shared = 1 puts the select structures in dynamic
// shared memory (lanes * roc_encode_lane_bytes bytes per block, which the
// caller keeps within the card's limit), shared = 0 in `scratch`,
// u8[ceil(B / lanes) * lanes * roc_encode_lane_bytes] (null in the shared
// layout). Launches on `stream` and returns the CUDA error code.
extern "C" int roc_encode_launch(const void* sorted_ids, const void* lengths,
                                 const void* precision, int B, int S, int n_max,
                                 const void* pool, int pool_size, int n_slices, int lanes,
                                 int shared, void* scratch, void* head, void* stack, int cap,
                                 void* stack_len, void* mt_ctr, void* order, void* err,
                                 void* stream) {
  if (B <= 0) return 0;
  if (lanes < 1 || lanes > 1024) return (int)cudaErrorInvalidValue;
  auto kernel = shared ? &roc_encode_kernel<true> : &roc_encode_kernel<false>;
  size_t smem = shared ? (size_t)lanes * roc_encode_lane_bytes(n_max) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + lanes - 1) / lanes, lanes, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)sorted_ids, (const int32_t*)lengths, (const int32_t*)precision, B, S,
      n_max, (const uint32_t*)pool, pool_size, n_slices, (uint32_t*)scratch,
      (uint64_t*)head, (uint32_t*)stack, cap, (int32_t*)stack_len, (int32_t*)mt_ctr,
      (int32_t*)order, (int32_t*)err);
  return (int)cudaGetLastError();
}
