// Per-row and per-lane steps of the two probes, shared by the CUDA kernels
// probe_gather.cu (K3) and probe_decode_step.cu (K4), and by the CPU build of
// the tests (tests/test_torch_probe_lane_cpu.py), which runs them through g++
// behind a loop over rows and lanes and holds them bit-exact against the plain
// versions in ops/probes.py. As in roc_lane.cuh, ROC_HD drops the CUDA
// qualifiers when __CUDACC__ is undefined, and LaneWarp runs the 32 threads of
// a warp as one thread.
#pragma once

#include <stdint.h>

#include <climits>

#include "roc_lane.cuh"

namespace probe {

// ------------------------------------------------------------------ K3

// K3's step, idx -> (idx + (win[idx] & 1)) mod W, tabulated: the window of a
// block of kGatherRows rows is stored column-major, element (j, row r) at word
// j * kGatherRows + r, so that the rows of a warp read 32 different banks
// whatever their indices, and each word holds the byte offset of its row's
// successor element. A step is then one dependent shared-memory load, with
// no arithmetic between one load and the next.
constexpr int kGatherRows = 32;

// Byte offset of element (j, r) in the column-major window.
ROC_HD int gather_offset(int j, int r) { return (j * kGatherRows + r) * 4; }

// The index of the element at byte offset `off`.
ROC_HD int gather_index(int off) { return off / (kGatherRows * 4); }

// The word stored for element (j, r) of a row whose word there is `w`: the
// offset of its successor. j + (w & 1) lies in [0, W], so the wrap is one
// compare and no division.
ROC_HD int gather_successor(int j, int r, int32_t w, int W) {
  int next = j + (w & 1);
  if (next == W) next = 0;
  return gather_offset(next, r);
}

// `steps` dependent loads from `off` through the tabulated window `table`
// (its byte offsets); returns the last offset.
ROC_HD int gather_chain(const int32_t* table, int off, int steps) {
  const char* base = reinterpret_cast<const char*>(table);
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int i = 0; i < steps; ++i) off = *reinterpret_cast<const int32_t*>(base + off);
  return off;
}

// ------------------------------------------------------------------ K4
//
// A step of K4 is a chain: the next value waits for the rank of this one (a
// count over every earlier symbol, summed over the warp), and the next
// gather's address waits for the rank and this gather. On the card the step
// is issue-bound besides: a warp issues about one instruction a cycle, and
// the count takes two for each symbol a thread holds. So the step below is
// kept to the fewest instructions and no branches (a taken branch stalls the
// warp longer than the step's arithmetic): conditional stores are predicated
// PTX, every thread stores the step's emit (the 32 carry the same value), and
// the terms of an emit that depend on the step or lane alone are added as the
// kernel writes the emits out.

#ifdef __CUDACC__
#define PROBE_UNROLL _Pragma("unroll")
#else
#define PROBE_UNROLL
#endif

// A lane's words in shared memory (its buffer, the symbols past the
// registers, the staged emits), read and written through 32-bit shared-space
// addresses with PTX: an address kept as a generic pointer makes the compiler
// rebuild the shared window's base (a read of the special register
// SR_CgaCtaId) before the access, and a conditional store becomes a branch.
// Built for the CPU, a pointer and plain ifs.
struct SharedWords {
#ifdef __CUDA_ARCH__
  uint32_t base;
  explicit ROC_HD SharedWords(int32_t* p) : base((uint32_t)__cvta_generic_to_shared(p)) {}
  ROC_HD int32_t get(int j) const {
    int32_t v;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(base + 4u * (uint32_t)j) : "memory");
    return v;
  }
  // word j where c, else 0 (and no load)
  ROC_HD int32_t get_if(bool c, int j) const {
    int32_t v;
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n mov.u32 %0, 0;\n"
        " @p ld.shared.b32 %0, [%1];\n}"
        : "=r"(v) : "r"(base + 4u * (uint32_t)j), "r"((uint32_t)c) : "memory");
    return v;
  }
  ROC_HD void put(int j, int32_t v) const {
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(base + 4u * (uint32_t)j), "r"(v) : "memory");
  }
  ROC_HD void put_if(bool c, int j, int32_t v) const {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.shared.b32 [%0], %1;\n}"
        ::"r"(base + 4u * (uint32_t)j), "r"(v), "r"((uint32_t)c) : "memory");
  }
#else
  int32_t* base;
  explicit ROC_HD SharedWords(int32_t* p) : base(p) {}
  ROC_HD int32_t get(int j) const { return base[j]; }
  ROC_HD int32_t get_if(bool c, int j) const { return c ? base[j] : 0; }
  ROC_HD void put(int j, int32_t v) const { base[j] = v; }
  ROC_HD void put_if(bool c, int j, int32_t v) const {
    if (c) base[j] = v;
  }
#endif
};

// c + 1 where a < b (signed), else c. On the card a compare and a predicated
// add, two instructions (the compiler's own form of it takes three).
ROC_HD uint32_t add_if_below(uint32_t c, int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
  asm("{\n .reg .pred p;\n setp.lt.s32 p, %1, %2;\n @p add.u32 %0, %0, 1;\n}"
      : "+r"(c) : "r"(a), "r"(b));
  return c;
#else
  return a < b ? c + 1 : c;
#endif
}

// A thread's symbols of a K4 lane: the steps j = t (mod 32), the k-th of them
// (step 32 k + t) in register r[k] for k < kRegSyms (1152 steps: all of the
// probe's 1100), past that in shared memory at tail[32 k + t]. The newest, of
// the current 32 steps, waits in `pend` until the 32 are done and every
// thread appends its own, so n, the count appended, is the warp's. Registers
// not yet appended, and an empty pend, hold kEmpty, which counts below no
// value.
constexpr int kRegSyms = 36;
constexpr int kSegRegs = 4;  // registers a segment of steps adds (4 x 32 steps)
constexpr int32_t kEmpty = INT32_MAX;

struct ThreadSyms {
  int32_t r[kRegSyms];
  int32_t pend;
  int n;

  ROC_HD void init() {
    PROBE_UNROLL
    for (int k = 0; k < kRegSyms; ++k) r[k] = kEmpty;
    pend = kEmpty;
    n = 0;
  }
  // The count of the thread's symbols below x. Within a segment of steps n
  // stays below N, so the first N registers hold all the thread's symbols
  // but the tail's: N compares, unrolled, in four sums, no loads. (A ballot
  // and a population count per register instead of this count and one warp
  // reduction shortens no step: the ballots issue slower than the compares.)
  template <int N, bool kTail>
  ROC_HD uint32_t below(const SharedWords& tail, int t, int32_t x) const {
    uint32_t c[4] = {add_if_below(0u, pend, x), 0u, 0u, 0u};
    PROBE_UNROLL
    for (int k = 0; k < N; ++k) c[k & 3] = add_if_below(c[k & 3], r[k], x);
    if (kTail)
      for (int k = kRegSyms; k < n; ++k)
        c[k & 3] = add_if_below(c[k & 3], tail.get(k * roc::kWarpSize + t), x);
    return (c[0] + c[1]) + (c[2] + c[3]);
  }
  // The 32 steps done: pend appended, into r[n] (n in [N - kSegRegs, N)
  // within a segment of N) or, past the registers, into the tail.
  template <int N, bool kTail>
  ROC_HD void append(const SharedWords& tail, int t) {
    if (kTail) {
      tail.put(n * roc::kWarpSize + t, pend);
    } else {
      PROBE_UNROLL
      for (int k = N - kSegRegs; k < N; ++k) r[k] = k == n ? pend : r[k];
    }
    ++n;
    pend = kEmpty;
  }
};

// The symbols of a K4 lane. On the card, this thread's ThreadSyms, and the
// rank one warp reduction of the 32 threads' counts; built for the CPU, the
// 32 threads' ThreadSyms, summed in a loop.
struct LaneSyms {
#ifdef __CUDA_ARCH__
  ThreadSyms s;
#else
  ThreadSyms s[roc::kWarpSize];
#endif
  ROC_HD void init() {
#ifdef __CUDA_ARCH__
    s.init();
#else
    for (ThreadSyms& u : s) u.init();
#endif
  }
  template <int N, bool kTail>
  ROC_HD uint32_t rank(const SharedWords& tail, int t, int32_t x) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(0xFFFFFFFFu, s.below<N, kTail>(tail, t, x));
#else
    (void)t;
    uint32_t r = 0;
    for (int u = 0; u < roc::kWarpSize; ++u) r += s[u].below<N, kTail>(tail, u, x);
    return r;
#endif
  }
  // step i's symbol x, held by thread i mod 32
  ROC_HD void own(int i, int t, int32_t x) {
#ifdef __CUDA_ARCH__
    s.pend = (i & (roc::kWarpSize - 1)) == t ? x : s.pend;
#else
    (void)t;
    s[i & (roc::kWarpSize - 1)].pend = x;
#endif
  }
  template <int N, bool kTail>
  ROC_HD void append(const SharedWords& tail, int t) {
#ifdef __CUDA_ARCH__
    s.append<N, kTail>(tail, t);
#else
    (void)t;
    for (int u = 0; u < roc::kWarpSize; ++u) s[u].append<N, kTail>(tail, u);
#endif
  }
};

// The terms of step i's emit that depend on the step and the lane alone,
// 2^30 / (i + 1) + ((1 << p) - 1): decode_steps leaves them out, and the
// kernel adds them as it writes the emits out, off the lane's chain.
ROC_HD uint32_t emit_terms(int i, int p) {
  return (1u << 30) / (uint32_t)(i + 1) + ((1u << p) - 1u);
}

// One K4 lane between steps: its inputs, its carry (ptr, x), the step i and
// its symbols.
struct DecodeStepLane {
  SharedWords buf;
  int capp;
  SharedWords tail;
  int p;
  SharedWords emit;
  int emit_stride;
  int t;
  int ptr;
  uint32_t x;
  int i;
  LaneSyms syms;
};

// The lane's steps up to `end`, every one within a segment that counts the
// first N registers (and the tail if kTail):
//   w    = buf[ptr - 1]        (0 where ptr - 1 lies outside [0, capp))
//   buf[ptr] = x               (nothing where ptr lies outside [0, capp))
//   rank = #{j < i : syms[j] < x}, compared as signed i32
//   syms[i] = x
//   emit[i] = w + rank + (x >> p), emit_terms(i, p) aside
//   ptr += (w & 1) - (rank & 1);  x += w + rank
// with i32 arithmetic that wraps (done in uint32_t) and >> logical. On the
// card the 32 threads of a warp carry the same (ptr, x, w), so each writes
// the same value to buf[ptr] and to emit[i] (and reads its own write back);
// thread i mod 32 holds symbol i. The appends at the end of each 32 steps sit
// outside the steps' loop.
template <int N, bool kTail>
ROC_HD void decode_segment(DecodeStepLane& s, int end) {
  while (s.i < end) {
    const int group_end = (s.i | (roc::kWarpSize - 1)) + 1;
    const int stop = group_end < end ? group_end : end;
    for (; s.i < stop; ++s.i) {
      const uint32_t w = (uint32_t)s.buf.get_if((uint32_t)(s.ptr - 1) < (uint32_t)s.capp,
                                                s.ptr - 1);
      s.buf.put_if((uint32_t)s.ptr < (uint32_t)s.capp, s.ptr, (int32_t)s.x);
      const uint32_t rank = s.syms.rank<N, kTail>(s.tail, s.t, (int32_t)s.x);
      s.emit.put(s.i * s.emit_stride, (int32_t)(w + rank + (s.x >> s.p)));
      s.syms.own(s.i, s.t, (int32_t)s.x);
      s.ptr += (int)(w & 1u) - (int)(rank & 1u);
      s.x += w + rank;
    }
    if (s.i == group_end) s.syms.append<N, kTail>(s.tail, s.t);
  }
}

// Segments of kSegRegs x 32 steps, each counting kSegRegs registers more
// than the one before, the last with the tail: the counts grow with the
// steps, as a loop over the symbols would, without a loop or a jump table.
template <int N>
ROC_HD void decode_segments(DecodeStepLane& s, int steps) {
  const int end = N * roc::kWarpSize;
  decode_segment<N, false>(s, steps < end ? steps : end);
  if constexpr (N < kRegSyms) decode_segments<N + kSegRegs>(s, steps);
}

// K4's `steps` steps on one lane, carry (ptr, x), ptr from capp / 2 and x
// from 7 p (p in [0, 32)), all three regions in shared memory on the card:
// `buf` the lane's copy (capp words, written), `tail` steps words for the
// symbols past the registers, and step i's emit but its emit_terms to
// emit[i * emit_stride]. `t` is the thread of the warp (0 on the CPU).
ROC_HD void decode_steps(int32_t* buf, int capp, int32_t* tail, int steps, int p,
                         int32_t* emit, int emit_stride, int t) {
  static_assert(kRegSyms % kSegRegs == 0, "whole segments of registers");
  DecodeStepLane s{SharedWords(buf), capp, SharedWords(tail), p, SharedWords(emit),
                   emit_stride, t, capp / 2, (uint32_t)p * 7u, 0, {}};
  s.syms.init();
  decode_segments<kSegRegs>(s, steps);
  decode_segment<kRegSyms, true>(s, steps);
}

// Shared-memory bytes of one K4 lane: its copy of buf, its symbols and its
// emits (the kernel stages the emits and writes them at the end).
ROC_HD int64_t decode_step_lane_bytes(int capp, int steps) {
  return 4 * ((int64_t)capp + 2 * (int64_t)steps);
}

}  // namespace probe
