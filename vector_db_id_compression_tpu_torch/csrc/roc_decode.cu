// ROC multiset decode, one warp per lane (one lane = one inverted list, or
// one block of graph nodes whose S neighbour sets are chained through one
// state).
//
// Replaces the TPU kernel vector_db_id_compression_tpu/ops/roc_pallas.py
// (_decode_kernel, launched by _decode_call), in its plain mode S = 1 and its
// chained mode S > 1 (_run_decode_chained, RocChainedPallasDecoder: the
// RocBlockGraph fetch inside the graph walk). It computes what that kernel and
// the plain versions codecs/roc_device.py::roc_decode_batch and
// roc_decode_chained compute, lane for lane and bit for bit: per slot, slot 0
// first, and per step i, codec_pop (16-bit slices, high first, refilling from
// the stack or the MT19937 pool at mt_ctr), the rank = the count of earlier
// symbols of the slot strictly smaller, push_with_finer_precision(rank, i + 1),
// and the symbol emitted at its sampling-order slot n - 1 - i. Each slot has
// its own length and precision. Output is always in encode sampling order.
//
// Decode pops and spills stack words, so each lane works on a copy of its
// stored stack: the stored stream is never written, and the next search
// decodes the same lists again.
//
// What bounds it on the H100: each lane is one serial dependency chain (a
// few dozen dependent integer operations per step), and step i also ranks the
// new symbol among the i before it, O(n^2) comparisons per list. The bytes
// (stacks in, ids out: about 10 MB for the 1024 lists of IVF1024 over 1M ids)
// take about 3 us at 3.35 TB/s, so the bound is the longest lane's chain.
// The chain probe (probe_chain.cu) times that chain alone, with each step's
// rank given: chip_smoke.py sets the kernel beside it.
//
// What the design does about it (roc_lane.cuh decode_lane):
//   - a warp per lane: the 32 threads run the chain in lockstep on the same
//     values (no broadcast), and the rank is split over them: thread t counts
//     the symbols j = t (mod 32), and __reduce_add_sync sums the counts, so a
//     step costs i / 32 conflict-free shared loads per thread instead of i
//     dependent global loads on one thread;
//   - the lane's symbols (u32 when every precision of the batch is <= 32,
//     else u64) and its stack copy live in shared memory; thread 0 writes
//     each spilled word, and the ids are written once at the end of the lane,
//     reversed, in one coalesced pass;
//   - blocks of a few warps with dynamic shared memory sized from n_max and
//     cap (about 15 KB a lane at n_max 2127 and precision 20), so a launch of
//     a thousand lanes spreads over every SM and runs all at once. (Handing
//     the lanes out longest first was measured and left out: with every
//     lane resident from the start it gained nothing and its sort cost
//     up to 0.2 ms per launch; PERF.md §6.)
// Shared-memory threshold: a block takes as many warps (up to the wrapper's
// count) as fit into the card's limit of dynamic shared memory per block
// (ops/_build.py SHARED_BYTES_PER_BLOCK, 227 KB on the H100); a lane that does
// not fit alone keeps the same two buffers in global memory (kShared =
// false), still one warp per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "roc_lane.cuh"

namespace {

// err value of a lane index outside [0, L); the codec's own faults set 1
constexpr int kLaneOutOfRange = 2;

__host__ __device__ constexpr int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// A lane's buffers: the symbols at offset 0, the stack copy after them.
__host__ __device__ constexpr int64_t syms_bytes(int n_max, int sym_bytes) {
  return align16((int64_t)n_max * sym_bytes);
}
__host__ __device__ constexpr int64_t lane_bytes(int n_max, int cap, int sym_bytes) {
  return syms_bytes(n_max, sym_bytes) + align16((int64_t)cap * 4);
}

// kChained = false is the per-list decode (S = 1) as its own instance, so that
// the slot loop does not change its code. kShared places the lane buffers in
// dynamic shared memory, warp w of the block at w * lane_bytes, else in
// `scratch` (global), the warp of lane q at q * lane_bytes.
template <bool kChained, bool kShared, typename Sym>
__global__ void roc_decode_kernel(const uint64_t* __restrict__ head,
                                  const uint32_t* __restrict__ stack, int cap,
                                  const int32_t* __restrict__ stack_len,
                                  const int32_t* __restrict__ mt_ctr, int L,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ precision, int S,
                                  const int64_t* __restrict__ lanes, int Q,
                                  const uint32_t* __restrict__ pool, int pool_size,
                                  int n_slices, int n_max, unsigned char* scratch,
                                  int64_t* ids, int32_t* err) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / roc::kWarpSize;
  const int w = threadIdx.x / roc::kWarpSize;
  const int t = threadIdx.x % roc::kWarpSize;
  const int64_t q = (int64_t)blockIdx.x * warps + w;
  if (q >= Q) return;  // the whole warp
  const int64_t row = lanes[q];
  if (row < 0 || row >= L) {
    if (t == 0) err[q] = kLaneOutOfRange;
    return;
  }
  const int64_t lb = lane_bytes(n_max, cap, (int)sizeof(Sym));
  unsigned char* buf = kShared ? smem + w * lb : scratch + q * lb;
  Sym* syms = reinterpret_cast<Sym*>(buf);
  uint32_t* stk = reinterpret_cast<uint32_t*>(buf + syms_bytes(n_max, (int)sizeof(Sym)));
  const int len = stack_len[row];
  const uint32_t* stored = stack + row * cap;
  for (int j = t; j < len && j < cap; j += roc::kWarpSize) stk[j] = stored[j];
  __syncwarp();
  roc::LaneState<roc::Stack<true>> s{head[row], {stk}, cap, len, pool, pool_size,
                                     mt_ctr[row], 0};
  const roc::LaneWarp warp{t};
  if (kChained)
    roc::decode_slots(s, lengths + row * S, precision + row * S, S, n_slices, syms,
                      ids + (int64_t)q * S * n_max, n_max, warp);
  else
    roc::decode_lane(s, lengths[row], precision[row], n_slices, syms,
                     ids + (int64_t)q * n_max, n_max, warp);
  if (t == 0) err[q] = s.err;
}

template <bool kChained, bool kShared, typename Sym>
int launch(int warps, size_t smem, cudaStream_t stream, int Q, const void* head,
           const void* stack, int cap, const void* stack_len, const void* mt_ctr, int L,
           const void* lengths, const void* precision, int S, const void* lanes,
           const void* pool, int pool_size, int n_slices, int n_max, void* scratch,
           void* ids, void* err) {
  auto kernel = &roc_decode_kernel<kChained, kShared, Sym>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (Q + warps - 1) / warps;
  kernel<<<blocks, warps * roc::kWarpSize, smem, stream>>>(
      (const uint64_t*)head, (const uint32_t*)stack, cap, (const int32_t*)stack_len,
      (const int32_t*)mt_ctr, L, (const int32_t*)lengths, (const int32_t*)precision, S,
      (const int64_t*)lanes, Q, (const uint32_t*)pool, pool_size,
      n_slices, n_max, (unsigned char*)scratch, (int64_t*)ids, (int32_t*)err);
  return (int)cudaGetLastError();
}

template <bool kChained, bool kShared>
int launch_sym(int sym_bytes, int warps, size_t smem, cudaStream_t stream, int Q,
               const void* head, const void* stack, int cap, const void* stack_len,
               const void* mt_ctr, int L, const void* lengths, const void* precision, int S,
               const void* lanes, const void* pool, int pool_size, int n_slices,
               int n_max, void* scratch, void* ids, void* err) {
  auto go = sym_bytes == 4 ? &launch<kChained, kShared, uint32_t>
                           : &launch<kChained, kShared, uint64_t>;
  return go(warps, smem, stream, Q, head, stack, cap, stack_len, mt_ctr, L, lengths,
            precision, S, lanes, pool, pool_size, n_slices, n_max, scratch, ids, err);
}

}  // namespace

// Bytes of one lane's buffers (symbols of sym_bytes = 4 or 8 each, and the
// stack copy): per warp of a block in the shared layout, per lane of the
// launch in the global one.
extern "C" long long roc_decode_lane_bytes(int n_max, int cap, int sym_bytes) {
  return lane_bytes(n_max, cap, sym_bytes);
}

// Plain C entry point (bound with ctypes). Decodes the Q lanes lanes[0, Q) of
// a lane table: head u64[L], stack u32[L, cap], stack_len, mt_ctr i32[L],
// lengths, precision i32[L, S]; pool u32[pool_size]; warp q of the launch
// decodes lane lanes[q]. Outputs, allocated by the caller:
// ids i64[Q, S, n_max], err i32[Q] (0; 1 on stack overflow or pool
// exhaustion; 2 for a lane index outside [0, L), whose ids stay unwritten, so
// the caller checks the lane bounds with the one read of err). sym_bytes is 4
// when every precision is <= 32, else 8. warps lanes per block; shared = 1
// puts the lane buffers in dynamic shared memory (warps *
// roc_decode_lane_bytes bytes per block, which the caller keeps within the
// card's limit), shared = 0 in `scratch`, u8[Q * roc_decode_lane_bytes]
// (null in the shared layout). Launches on `stream` and returns the CUDA
// error code.
extern "C" int roc_decode_launch(const void* head, const void* stack, int cap,
                                 const void* stack_len, const void* mt_ctr, int L,
                                 const void* lengths, const void* precision, int S,
                                 const void* lanes, int Q,
                                 const void* pool, int pool_size, int n_slices,
                                 int n_max, int sym_bytes, int warps, int shared,
                                 void* scratch, void* ids, void* err, void* stream) {
  if (Q <= 0) return 0;
  if ((sym_bytes != 4 && sym_bytes != 8) || warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  size_t smem = shared ? (size_t)warps * lane_bytes(n_max, cap, sym_bytes) : 0;
  auto go = S == 1 ? (shared ? &launch_sym<false, true> : &launch_sym<false, false>)
                   : (shared ? &launch_sym<true, true> : &launch_sym<true, false>);
  return go(sym_bytes, warps, smem, (cudaStream_t)stream, Q, head, stack, cap, stack_len,
            mt_ctr, L, lengths, precision, S, lanes, pool, pool_size, n_slices, n_max,
            scratch, ids, err);
}

// Message for a code returned by any launch function of the library.
extern "C" const char* roc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
