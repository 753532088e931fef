// Grouped float IVF scan (K5): a block a list, every query that probes the
// list at once, the k nearest of each (query, list) slot kept on chip.
//
// Replaces no TPU kernel: the JAX package leaves its float scan to XLA
// (search/ivf.py `_scan_flat_bucket`, `_scan_flat_allpairs`). It replaces the
// port's per-bucket chain of `nonzero` (a host sync), a gather of each
// probed list's padded payload once per probing query, a batched gemv, a
// masked topk and a scatter into the candidates (search/ivf.py
// `_scan_flat_pairs`, `_scan_flat_dense`). The plain version is
// ops/ivf_scan.py `scan_flat_grouped_plain`.
//
// What bounds it on the H100: the bytes. Each probed list's true rows are
// read once (4 d bytes a row, and its norm), the slots' queries once, and
// k distances and labels a slot written once; the float32 work, slots x
// rows x 2 d operations, is a few GFLOP, below the bytes at 67 TFLOP/s on
// the CUDA cores. The gather it replaces wrote and read again each list's
// padded payload once per probing query (about 11 GB a 1000-query call over
// SIFT1M's shape).
//
// What the design does about it:
//   - the slots come grouped by list (ops/ivf_scan.py `group_slots`, a sort
//     on the device, so nothing waits for the host): block b takes lane b of
//     a size bucket, finds its list's slots, and returns at once where none
//     probes it;
//   - the list's rows stream through shared memory in tiles of 64 rows, up
//     to 128 floats of each at a time, double-buffered with cp.async, 16
//     bytes a copy where d is a multiple of 4; only rows below the list's
//     length are read, never the bucket's padding;
//   - a tile is read once for up to 32 of the list's queries (a chunk), held
//     beside it in shared memory; a list with more probing queries is
//     streamed once a chunk. A warp computes 4 queries against the tile's 64
//     rows, two a lane, in full float32 FMA on the CUDA cores (no TF32 or
//     tensor-core product: the configuration promises exact float32 L2
//     distances); rows are padded in shared memory to a stride of 4 words
//     mod 32, so the lanes' 16-byte loads meet no bank conflict;
//   - distance = ||y||^2 - 2 <x, y>, as `_scan_flat_pairs` computes it (the
//     product summed in another order); each warp keeps its queries' k
//     nearest sorted in shared memory. After a tile, only its distances
//     below the current k-th move anything, and all at once: each such
//     candidate's place is its rank among the tile's others (shuffles over
//     the ballot) plus the held entries not above it (a binary search), a
//     held entry moves down by the candidates below it, and every entry
//     still within the k is written in one step, so a tie goes to the lower
//     offset (no serial insertion, whose chain of dependent shared-memory
//     steps held the first tiles of every list);
//   - the lanes of a bucket are sorted by length, and the blocks take the
//     longest first, so the longest lists do not run alone at the end;
//   - the results go straight into the search's candidates: distance +
//     ||x||^2 and the label (list << 32 | offset), +inf and -1 past what the
//     list holds, at the slot's row, with no scatter after.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                                // rows of a tile, two a lane
constexpr int kQueriesPerWarp = 4;
constexpr int kQueries = kWarps * kQueriesPerWarp;       // queries of a chunk
constexpr int kMaxK = 128;                               // ops/ivf_scan.py MAX_K
constexpr int kMaxChunk = 128;                           // floats of a row staged at once
constexpr unsigned kFull = 0xffffffffu;

// floats of a row staged at once: d rounded up to 4, at most kMaxChunk
__host__ __device__ inline int chunk_width(int d) {
  const int w = (d + 3) & ~3;
  return w < kMaxChunk ? w : kMaxChunk;
}

// words between two staged rows: at least the width and 4 mod 32, so that
// the 8 lanes of a quarter warp reading 16 bytes of 8 rows hit 32 banks
__host__ __device__ inline int chunk_stride(int width) { return width + (36 - width % 32) % 32; }

// buffers of the queries: one where a row is one chunk (the queries stay
// for every tile), else two
__host__ __device__ inline int query_buffers(int d) { return d <= kMaxChunk ? 1 : 2; }

// dynamic shared memory of a block: the chunk's slots and queries' rows,
// two buffers of a tile, the queries' buffers, the k nearest of each query
size_t smem_bytes(int d, int k) {
  const int stride = chunk_stride(chunk_width(d));
  return (sizeof(int64_t) + sizeof(int)) * kQueries +
         sizeof(float) * (2 * kRows + query_buffers(d) * kQueries) * stride +
         (sizeof(float) + sizeof(int)) * kQueries * k;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4 bytes, or 4 zero bytes where !fill (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copies `count` rows of width `cw` (floats; padded with zeros to a multiple
// of 4) from src rows at `src_row(r)` into dst[r * stride]. Thread t takes
// item t, t + kThreads, ..., where item i is (row i / g, 16-byte group or
// element i % g); (r_start, g_start) is t's first item, (r_step, g_step)
// the stride kThreads in that form, so no division runs here.
template <bool kVec, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int count, int total, int cw, int cw4,
                                           int stride, int g, int r_start, int g_start,
                                           int r_step, int g_step, RowPtr src_row) {
  for (int r = r_start, gi = g_start; r < total;) {
    if (r < count) {
      const float* src = src_row(r);
      if (kVec) {
        const int e = gi * 4;
        if (e < cw) cp_async16(dst + r * stride + e, src + e);
      } else if (gi < cw4) {
        cp_async4(dst + r * stride + gi, src + (gi < cw ? gi : 0), gi < cw);
      }
    }
    r += r_step;
    gi += g_step;
    if (gi >= g) {
      gi -= g;
      ++r;
    }
  }
}

// Entries of the sorted td[0, cnt) at most d.
__device__ __forceinline__ int count_at_most(const float* td, int cnt, float d) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (td[mid] <= d)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Offers a tile's distances, two a lane (rows row0 = base + lane and row0 +
// 32; v0, v1 whether the rows exist), to a warp's k nearest (td, to) of one
// query, sorted by (distance, offset), holding cnt. Those below the k-th
// take their places at once: a candidate's place is its rank among the
// tile's passing candidates plus the held entries at most its distance
// (every held entry has a lower offset); a held entry moves down by the
// candidates below it. Lane l holds entries l, l + 32, ... (kPer of them,
// kPer * 32 >= k). The warp calls it on every lane, with cnt and k the same.
template <int kPer>
__device__ __forceinline__ void offer(float* td, int* to, int& cnt, int k, bool v0, float d0,
                                      bool v1, float d1, int base, int lane) {
  const float kth = cnt < k ? INFINITY : td[k - 1];
  const bool p0 = v0 && d0 < kth, p1 = v1 && d1 < kth;
  const unsigned b0 = __ballot_sync(kFull, p0), b1 = __ballot_sync(kFull, p1);
  if (!(b0 | b1)) return;
  const int row0 = base + lane, row1 = row0 + 32;
  float hd[kPer];
  int ho[kPer], down[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = r * 32 + lane;
    hd[r] = j < cnt ? td[j] : INFINITY;
    ho[r] = j < cnt ? to[j] : 0;
    down[r] = 0;
  }
  int rank0 = 0, rank1 = 0;
  for (unsigned m = b0; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const float c = __shfl_sync(kFull, d0, src);
    const int row = base + src;
    rank0 += c < d0 || (c == d0 && row < row0);
    rank1 += c < d1 || (c == d1 && row < row1);
#pragma unroll
    for (int r = 0; r < kPer; ++r) down[r] += c < hd[r];
  }
  for (unsigned m = b1; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const float c = __shfl_sync(kFull, d1, src);
    const int row = base + 32 + src;
    rank0 += c < d0 || (c == d0 && row < row0);
    rank1 += c < d1 || (c == d1 && row < row1);
#pragma unroll
    for (int r = 0; r < kPer; ++r) down[r] += c < hd[r];
  }
  if (p0) rank0 += count_at_most(td, cnt, d0);
  if (p1) rank1 += count_at_most(td, cnt, d1);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int j = r * 32 + lane;
    if (j < cnt && j + down[r] < k) {
      td[j + down[r]] = hd[r];
      to[j + down[r]] = ho[r];
    }
  }
  if (p0 && rank0 < k) {
    td[rank0] = d0;
    to[rank0] = row0;
  }
  if (p1 && rank1 < k) {
    td[rank1] = d1;
    to[rank1] = row1;
  }
  __syncwarp();
  const int all = cnt + __popc(b0) + __popc(b1);
  cnt = all < k ? all : k;
}

template <bool kVec, int kPer>
__global__ void __launch_bounds__(kThreads, 2)
    ivf_flat_scan_kernel(const float* __restrict__ payload, const float* __restrict__ norms,
                         const int64_t* __restrict__ lengths, const int64_t* __restrict__ lists,
                         const int64_t* __restrict__ order, const int64_t* __restrict__ starts,
                         const float* __restrict__ xq, const float* __restrict__ x2, int n_pad,
                         int d, int nprobe, int k, float* __restrict__ out_d,
                         int64_t* __restrict__ out_l) {
  // the bucket's lanes ascend in length: the longest first
  const int lane_b = gridDim.x - 1 - blockIdx.x;
  const int64_t list = lists[lane_b];
  const int64_t first = starts[list];
  const int64_t m = starts[list + 1] - first;
  const int n = static_cast<int>(lengths[lane_b]);
  if (m <= 0 || n <= 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* slot_s = reinterpret_cast<int64_t*>(smem);
  int* query_s = reinterpret_cast<int*>(slot_s + kQueries);
  const int width = chunk_width(d), stride = chunk_stride(width);
  float* rows_s = reinterpret_cast<float*>(query_s + kQueries);  // [2][kRows][stride]
  float* qs_s = rows_s + 2 * kRows * stride;          // [query_buffers][kQueries][stride]
  float* topd = qs_s + query_buffers(d) * kQueries * stride;      // [kQueries][k]
  int* topo = reinterpret_cast<int*>(topd + kQueries * k);        // [kQueries][k]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (d + width - 1) / width;
  const int stages = (n + kRows - 1) / kRows * chunks;
  // with one chunk a row the queries stay in their one buffer for every tile
  const bool resident = query_buffers(d) == 1;
  const int g = kVec ? width / 4 : width;
  const int r_start = threadIdx.x / g, g_start = threadIdx.x % g;
  const int r_step = kThreads / g, g_step = kThreads % g;
  const float* lane_rows = payload + static_cast<int64_t>(lane_b) * n_pad * d;
  const float* lane_norms = norms + static_cast<int64_t>(lane_b) * n_pad;

  for (int64_t c0 = 0; c0 < m; c0 += kQueries) {
    const int mq = static_cast<int>(m - c0 < kQueries ? m - c0 : kQueries);
    if (threadIdx.x < mq) {
      const int64_t slot = order[first + c0 + threadIdx.x];
      slot_s[threadIdx.x] = slot;
      query_s[threadIdx.x] = static_cast<int>(slot / nprobe);
    }
    __syncthreads();

    // stage s: tile s / chunks, floats [(s % chunks) * width, + width) of
    // each row, into buffer s % 2
    auto stage = [&](int s) {
      const int t = s / chunks, c = s - t * chunks;
      const int e0 = c * width;
      const int cw = d - e0 < width ? d - e0 : width;
      const int cw4 = (cw + 3) & ~3;
      const int row0 = t * kRows;
      const int rows = n - row0 < kRows ? n - row0 : kRows;
      stage_rows<kVec>(rows_s + (s % 2) * kRows * stride, rows, kRows, cw, cw4, stride, g,
                       r_start, g_start, r_step, g_step, [&](int r) {
                         return lane_rows + static_cast<int64_t>(row0 + r) * d + e0;
                       });
      if (!resident || s == 0)
        stage_rows<kVec>(qs_s + (resident ? 0 : s % 2) * kQueries * stride, mq, kQueries, cw,
                         cw4, stride, g, r_start, g_start, r_step, g_step, [&](int r) {
                           return xq + static_cast<int64_t>(query_s[r]) * d + e0;
                         });
      cp_async_commit();
    };

    const bool active = warp * kQueriesPerWarp < mq;
    int cnt[kQueriesPerWarp];
    float acc[kQueriesPerWarp][2];
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      cnt[i] = 0;
      acc[i][0] = acc[i][1] = 0.f;
    }
    stage(0);
    for (int s = 0; s < stages; ++s) {
      if (s + 1 < stages)
        stage(s + 1);
      else
        cp_async_commit();  // an empty group: wait_group 1 then waits for stage s
      cp_async_wait_prior();
      __syncthreads();
      if (active) {
        const int t = s / chunks, c = s - t * chunks;
        const int cw = d - c * width < width ? d - c * width : width;
        const int cw4 = (cw + 3) & ~3;
        const float* ys = rows_s + (s % 2) * kRows * stride;
        const float* xs = qs_s + (resident ? 0 : s % 2) * kQueries * stride +
                          warp * kQueriesPerWarp * stride;
        for (int e = 0; e < cw4; e += 4) {
          const float4 y0 = *reinterpret_cast<const float4*>(ys + lane * stride + e);
          const float4 y1 = *reinterpret_cast<const float4*>(ys + (lane + 32) * stride + e);
#pragma unroll
          for (int i = 0; i < kQueriesPerWarp; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(xs + i * stride + e);
            acc[i][0] = dot4(x, y0, acc[i][0]);
            acc[i][1] = dot4(x, y1, acc[i][1]);
          }
        }
        if (c == chunks - 1) {
          const int row0 = t * kRows + lane, row1 = row0 + 32;
          const float n0 = row0 < n ? lane_norms[row0] : 0.f;
          const float n1 = row1 < n ? lane_norms[row1] : 0.f;
#pragma unroll
          for (int i = 0; i < kQueriesPerWarp; ++i) {
            const int qi = warp * kQueriesPerWarp + i;
            if (qi < mq)
              offer<kPer>(topd + qi * k, topo + qi * k, cnt[i], k, row0 < n,
                          n0 - 2.f * acc[i][0], row1 < n, n1 - 2.f * acc[i][1], t * kRows, lane);
            acc[i][0] = acc[i][1] = 0.f;
          }
        }
      }
      __syncthreads();  // buffer s % 2 is free for stage s + 2
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < kQueriesPerWarp; ++i) {
        const int qi = warp * kQueriesPerWarp + i;
        if (qi < mq) {
          const int64_t slot = slot_s[qi];
          const float xx = x2[query_s[qi]];
          for (int j = lane; j < k; j += 32) {
            const bool held = j < cnt[i];
            out_d[slot * k + j] = held ? topd[qi * k + j] + xx : INFINITY;
            out_l[slot * k + j] = held ? (list << 32) | topo[qi * k + j] : -1;
          }
        }
      }
    }
    __syncthreads();  // the slots and query buffers are the next chunk's
  }
}

template <bool kVec, int kPer>
int launch(int B, size_t smem, cudaStream_t stream, const float* payload, const float* norms,
           const int64_t* lengths, const int64_t* lists, const int64_t* order,
           const int64_t* starts, const float* xq, const float* x2, int n_pad, int d,
           int nprobe, int k, float* out_d, int64_t* out_l) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_flat_scan_kernel<kVec, kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ivf_flat_scan_kernel<kVec, kPer><<<B, kThreads, smem, stream>>>(
      payload, norms, lengths, lists, order, starts, xq, x2, n_pad, d, nprobe, k, out_d, out_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest k the kernel keeps.
extern "C" int ivf_flat_scan_max_k() { return kMaxK; }

// Plain C entry point (bound with ctypes). One size bucket of B lanes:
// payload f32[B, n_pad, d], norms f32[B, n_pad] (||y||^2), lengths i64[B],
// lists i64[B] (each lane's list number); the search's slots grouped by
// list: order i64[S] (slot q * nprobe + p, those of list l at
// order[starts[l], starts[l + 1])), starts i64[nlist + 1]; xq f32[nq, d],
// x2 f32[nq] (||x||^2). Writes, for every slot of a lane's list, k sorted
// distances (+ x2) and labels (list << 32 | offset) into out_d f32[S, k]
// and out_l i64[S, k], +inf and -1 past the list's length; other rows are
// left as they are. vec = 1 takes 16-byte copies, which need d % 4 == 0 and
// payload and xq 16-byte aligned. Launches on `stream`, allocates nothing,
// and returns the CUDA error code of the launch.
extern "C" int ivf_flat_scan_launch(const void* payload, const void* norms, const void* lengths,
                                    const void* lists, int B, int n_pad, int d,
                                    const void* order, const void* starts, const void* xq,
                                    const void* x2, int nprobe, int k, int vec, void* out_d,
                                    void* out_l, void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > kMaxK || d < 1 || nprobe < 1 || (vec && d % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d, k);
  // held entries a lane keeps in registers while a tile's candidates move in
  auto go = k <= 32 ? (vec ? &launch<true, 1> : &launch<false, 1>)
                    : (vec ? &launch<true, kMaxK / 32> : &launch<false, kMaxK / 32>);
  return go(B, smem, static_cast<cudaStream_t>(stream), static_cast<const float*>(payload),
            static_cast<const float*>(norms), static_cast<const int64_t*>(lengths),
            static_cast<const int64_t*>(lists), static_cast<const int64_t*>(order),
            static_cast<const int64_t*>(starts), static_cast<const float*>(xq),
            static_cast<const float*>(x2), n_pad, d, nprobe, k, static_cast<float*>(out_d),
            static_cast<int64_t*>(out_l));
}
