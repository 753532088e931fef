// Per-lane ROC (bits-back rANS multiset coding) steps, shared by the CUDA
// kernels roc_encode.cu and roc_decode.cu. Each function advances ONE lane
// (one inverted list) and mirrors, step for step, the lane-batched torch codec
// in codecs/roc_device.py — the kernels' plain version — including its clamps
// on stack overflow and pool exhaustion, so the two agree bit for bit.
//
// The u64 head and u32 stack words are native types here: no (hi, lo) split,
// no digit-wise long division. Everything is __host__ __device__ so that a
// plain C++ compiler builds the same code for the CPU cross-check in the
// tests (ROC_HD drops the CUDA qualifiers when __CUDACC__ is undefined).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ROC_HD __host__ __device__ __forceinline__
#else
#define ROC_HD inline
#endif

namespace roc {

constexpr uint64_t RANS_L = 1ull << 31;

// Element j of a lane lives at base[j * stride]. The kernels keep per-lane
// scratch in [rows, lanes] layout (stride = lane count), so the 32 lanes of a
// warp touch 32 neighbouring words when they are at the same row.
template <typename T>
struct Strided {
  T* base;
  int64_t stride;
  ROC_HD T& operator[](int64_t j) const { return base[j * stride]; }
};

struct LaneState {
  uint64_t head;
  Strided<uint32_t> stack;  // bottom-to-top words
  int cap;                  // stack rows available
  int len;                  // stack height
  const uint32_t* pool;     // shared MT19937(1234) initial-bits pool
  int pool_size;
  int mt_ctr;               // pool words drawn so far
  int err;                  // stack overflow or pool exhaustion
};

ROC_HD int clamp_int(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

ROC_HD void push_word(LaneState& s, uint32_t w) {
  if (s.len >= s.cap) s.err = 1;
  s.stack[clamp_int(s.len, 0, s.cap - 1)] = w;
  s.len++;
}

// One refill word: the stack top if the stack is nonempty, else the pool.
ROC_HD uint32_t pop_word(LaneState& s) {
  if (s.len > 0) {
    uint32_t w = s.stack[clamp_int(s.len - 1, 0, s.cap - 1)];
    s.len--;
    return w;
  }
  if (s.mt_ctr >= s.pool_size) s.err = 1;
  uint32_t w = s.pool[clamp_int(s.mt_ctr, 0, s.pool_size - 1)];
  s.mt_ctr++;
  return w;
}

// pop_with_finer_precision (reference codec.cpp:21-42). nmax >= 1.
ROC_HD uint32_t pop_mod(LaneState& s, uint32_t nmax) {
  uint64_t head0 = s.head;
  uint64_t q32 = RANS_L / nmax;
  if (head0 >= ((uint64_t)nmax * q32) << 32) {
    push_word(s, (uint32_t)head0);
    head0 >>= 32;
  }
  uint64_t q = head0 / nmax;
  uint32_t cfs = (uint32_t)(head0 % nmax);
  // refill on the pre-divide head, as the reference does
  if (head0 < RANS_L) q = (q << 32) | pop_word(s);
  s.head = q;
  return cfs;
}

// push_with_finer_precision (reference codec.cpp:44-63). nmax >= 1.
ROC_HD void push_mod(LaneState& s, uint32_t value, uint32_t nmax) {
  uint64_t head0 = s.head;
  uint64_t q32 = RANS_L / nmax;
  if (head0 >= q32 << 32) {
    push_word(s, (uint32_t)head0);
    head0 >>= 32;
  }
  uint64_t head = head0 * nmax + value;
  if (head < RANS_L) head = (head << 32) | pop_word(s);
  s.head = head;
}

// codec_push (reference codec.cpp:92-105): 16-bit slices, low slice first.
ROC_HD void push_symbol(LaneState& s, uint64_t symbol, int precision, int n_slices) {
  for (int si = 0; si < n_slices; ++si) {
    int p = clamp_int(precision - 16 * si, 0, 16);
    uint64_t sv = (symbol >> (16 * si)) & 0xFFFFull;
    if (s.head >= ((RANS_L >> p) << 32)) {
      push_word(s, (uint32_t)s.head);
      s.head >>= 32;
    }
    s.head = (s.head << p) + sv;
  }
}

// codec_pop (reference codec.cpp:107-121): high slice first.
ROC_HD uint64_t pop_symbol(LaneState& s, int precision, int n_slices) {
  uint64_t symbol = 0;
  for (int si = n_slices - 1; si >= 0; --si) {
    int p = clamp_int(precision - 16 * si, 0, 16);
    uint64_t cfs = s.head & ((1ull << p) - 1);
    uint64_t h = s.head >> p;
    if (h < RANS_L) h = (h << 32) | pop_word(s);
    s.head = h;
    symbol = (symbol << 16) | cfs;
  }
  return symbol;
}

// Order statistics over n sorted slots: a Fenwick tree of 0/1 counts (rows
// 1..n of `tree`), all ones to begin with.
ROC_HD void fenwick_fill(Strided<int32_t> tree, int n) {
  for (int i = 1; i <= n; ++i) tree[i] = i & -i;
}

// 0-based slot of the (k+1)-th remaining element, which is then removed —
// the same slot as the plain version's cumsum select.
ROC_HD int fenwick_select_remove(Strided<int32_t> tree, int n, int k) {
  int step = 1;
  while (2 * step <= n) step *= 2;
  int pos = 0;
  int rem = k + 1;
  for (; step > 0; step >>= 1) {
    int nxt = pos + step;
    if (nxt <= n && tree[nxt] < rem) {
      pos = nxt;
      rem -= tree[nxt];
    }
  }
  for (int i = pos + 1; i <= n; i += i & -i) tree[i]--;
  return pos;
}

// ROC encode of one lane (reference codec.cpp:123-138). `ids` holds the
// lane's n ids ascending; order[i] receives the sorted slot emitted at step i
// (-1 from n to n_max). s starts fresh (head RANS_L, empty stack).
ROC_HD void encode_lane(LaneState& s, const uint64_t* ids, int n, int precision,
                        int n_slices, Strided<int32_t> tree, int32_t* order,
                        int n_max) {
  fenwick_fill(tree, n);
  for (int i = 0; i < n; ++i) {
    uint32_t k = pop_mod(s, (uint32_t)(n - i));
    int pos = fenwick_select_remove(tree, n, (int)k);
    order[i] = pos;
    push_symbol(s, ids[pos], precision, n_slices);
  }
  for (int i = n; i < n_max; ++i) order[i] = -1;
}

// ROC decode of one lane (reference codec.cpp:140-152). Writes the n ids in
// encode sampling order to out[0, n) and zeros to out[n, n_max). `syms` is
// scratch for the symbols decoded so far; the rank of each new symbol is an
// O(i) count over them.
ROC_HD void decode_lane(LaneState& s, int n, int precision, int n_slices,
                        Strided<uint64_t> syms, int64_t* out, int n_max) {
  for (int i = 0; i < n; ++i) {
    uint64_t sym = pop_symbol(s, precision, n_slices);
    uint32_t rank = 0;
    for (int j = 0; j < i; ++j) rank += syms[j] < sym ? 1u : 0u;
    syms[i] = sym;
    push_mod(s, rank, (uint32_t)(i + 1));
    out[n - 1 - i] = (int64_t)sym;
  }
  for (int j = n; j < n_max; ++j) out[j] = 0;
}

}  // namespace roc
