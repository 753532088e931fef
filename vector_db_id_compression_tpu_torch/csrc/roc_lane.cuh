// Per-lane ROC (bits-back rANS multiset coding) steps, shared by the CUDA
// kernels roc_encode.cu and roc_decode.cu. Each function advances ONE lane
// (one inverted list, or a block of graph nodes whose neighbour sets are
// chained through one state) and mirrors, step for step, the lane-batched
// torch codec in codecs/roc_device.py — the kernels' plain version — including its clamps
// on stack overflow and pool exhaustion, so the two agree bit for bit.
//
// The encode runs a lane on one thread. The decode runs a lane on the 32
// threads of a warp (LaneWarp): every thread carries the same state and runs
// the same chain, and only the rank of each new symbol is split over them.
//
// The u64 head and u32 stack words are native types here: no (hi, lo) split,
// no digit-wise long division. Everything is __host__ __device__ so that a
// plain C++ compiler builds the same code for the CPU cross-check in the
// tests (ROC_HD drops the CUDA qualifiers when __CUDACC__ is undefined); built
// so, LaneWarp runs the warp's 32 threads as a loop.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ROC_HD __host__ __device__ __forceinline__
#else
#define ROC_HD inline
#endif

namespace roc {

constexpr uint64_t RANS_L = 1ull << 31;
constexpr int kWarpSize = 32;

// Element j of a lane lives at base[j * stride]. The encode keeps its
// per-lane select structure in [rows, lanes] layout (stride = lanes in the
// block), so the lanes of a warp touch 32 neighbouring words, one per bank.
template <typename T>
struct Strided {
  T* base;
  int64_t stride;
  ROC_HD T& operator[](int64_t j) const { return base[j * stride]; }
};

// A lane's stack words, bottom to top. With kWarp (the warp-per-lane decode)
// all 32 threads of the warp carry the same stack height: thread 0 stores a
// spilled word and the warp syncs before any thread reads it. Built for the
// CPU, both are plain stores.
template <bool kWarp>
struct Stack {
  uint32_t* base;
  ROC_HD uint32_t get(int j) const { return base[j]; }
  ROC_HD void put(int j, uint32_t w) const {
#ifdef __CUDA_ARCH__
    if (kWarp) {
      if ((threadIdx.x & (kWarpSize - 1)) == 0) base[j] = w;
      __syncwarp();
      return;
    }
#endif
    base[j] = w;
  }
};

template <class StackT>
struct LaneState {
  uint64_t head;
  StackT stack;             // bottom-to-top words
  int cap;                  // stack words available
  int len;                  // stack height
  const uint32_t* pool;     // shared MT19937(1234) initial-bits pool
  int pool_size;
  int mt_ctr;               // pool words drawn so far
  int err;                  // stack overflow or pool exhaustion
};

ROC_HD int clamp_int(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

template <class St>
ROC_HD void push_word(St& s, uint32_t w) {
  if (s.len >= s.cap) s.err = 1;
  s.stack.put(clamp_int(s.len, 0, s.cap - 1), w);
  s.len++;
}

// One refill word: the stack top if the stack is nonempty, else the pool.
template <class St>
ROC_HD uint32_t pop_word(St& s) {
  if (s.len > 0) {
    uint32_t w = s.stack.get(clamp_int(s.len - 1, 0, s.cap - 1));
    s.len--;
    return w;
  }
  if (s.mt_ctr >= s.pool_size) s.err = 1;
  uint32_t w = s.pool[clamp_int(s.mt_ctr, 0, s.pool_size - 1)];
  s.mt_ctr++;
  return w;
}

// pop_with_finer_precision (reference codec.cpp:21-42). nmax >= 1. RANS_L
// and nmax fit in 32 bits, so q32 is a 32-bit divide.
template <class St>
ROC_HD uint32_t pop_mod(St& s, uint32_t nmax) {
  uint64_t head0 = s.head;
  uint32_t q32 = (uint32_t)RANS_L / nmax;
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
template <class St>
ROC_HD void push_mod(St& s, uint32_t value, uint32_t nmax) {
  uint64_t head0 = s.head;
  uint32_t q32 = (uint32_t)RANS_L / nmax;
  if (head0 >= (uint64_t)q32 << 32) {
    push_word(s, (uint32_t)head0);
    head0 >>= 32;
  }
  uint64_t head = head0 * nmax + value;
  if (head < RANS_L) head = (head << 32) | pop_word(s);
  s.head = head;
}

// codec_push (reference codec.cpp:92-105): 16-bit slices, low slice first.
template <class St>
ROC_HD void push_symbol(St& s, uint64_t symbol, int precision, int n_slices) {
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
template <class St>
ROC_HD uint64_t pop_symbol(St& s, int precision, int n_slices) {
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

// ---------------------------------------------------------------- encode

ROC_HD int popcount32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __popc(w);
#else
  return __builtin_popcount(w);
#endif
}

// Words of the select structure for slots of up to n ids.
ROC_HD int select_words(int n) { return (n + 31) / 32; }

// The encode's order statistics over the n sorted slots of one multiset:
// bit b of bits[w] marks slot 32 w + b as not yet emitted, and a Fenwick tree
// over the words' counts (rows 1..select_words(n) of `tree`) finds the word
// that holds the k-th remaining slot. All slots remain to begin with.
ROC_HD void select_fill(Strided<uint32_t> bits, Strided<int32_t> tree, int n) {
  int m = select_words(n);
  for (int w = 0; w < m; ++w)
    bits[w] = n - 32 * w >= 32 ? 0xFFFFFFFFu : (1u << (n - 32 * w)) - 1u;
  // row i counts the slots of words (i - lowbit(i), i]; only the last word
  // can be partial, and it is never below row i's range
  for (int i = 1; i <= m; ++i) {
    int hi = 32 * i < n ? 32 * i : n;
    tree[i] = hi - 32 * (i - (i & -i));
  }
}

// Bit position of the (r+1)-th set bit of w (w has more than r set bits),
// by halving: five popcounts.
ROC_HD int select_in_word(uint32_t w, int r) {
  int pos = 0;
  for (int half = 16; half > 0; half >>= 1) {
    int c = popcount32(w & ((1u << half) - 1u));
    if (r >= c) {
      r -= c;
      w >>= half;
      pos += half;
    }
  }
  return pos;
}

// 0-based slot of the (k+1)-th remaining slot, which is then removed — the
// same slot as the plain version's cumsum select, since both return the
// (k+1)-th remaining slot in sorted order. `top` is the largest power of two
// <= select_words(n).
ROC_HD int select_remove(Strided<uint32_t> bits, Strided<int32_t> tree, int n, int top,
                         int k) {
  int m = select_words(n);
  int pos = 0;
  int rem = k + 1;
  for (int step = top; step > 0; step >>= 1) {
    int nxt = pos + step;
    if (nxt <= m) {
      int c = tree[nxt];
      if (c < rem) {
        pos = nxt;
        rem -= c;
      }
    }
  }
  uint32_t w = bits[pos];
  int b = select_in_word(w, rem - 1);
  bits[pos] = w & ~(1u << b);
  for (int i = pos + 1; i <= m; i += i & -i) tree[i]--;
  return 32 * pos + b;
}

// ROC encode of one multiset (reference codec.cpp:123-138) onto the lane's
// state so far: fresh (head RANS_L, empty stack) for a list, or the state the
// previous slot left for a chained lane. `ids` holds the n ids ascending;
// order[i], unless order is null, receives the sorted slot emitted at step i
// (-1 from n to n_max).
template <class St>
ROC_HD void encode_lane(St& s, const uint64_t* ids, int n, int precision, int n_slices,
                        Strided<uint32_t> bits, Strided<int32_t> tree, int32_t* order,
                        int n_max) {
  select_fill(bits, tree, n);
  int top = 1;
  while (2 * top <= select_words(n)) top *= 2;
  for (int i = 0; i < n; ++i) {
    uint32_t k = pop_mod(s, (uint32_t)(n - i));
    int pos = select_remove(bits, tree, n, top, (int)k);
    if (order) order[i] = pos;
    push_symbol(s, ids[pos], precision, n_slices);
  }
  if (order)
    for (int i = n; i < n_max; ++i) order[i] = -1;
}

// S multisets through one lane state (codecs/roc_device.py
// roc_encode_chained): slot t holds ids[t * n_max, t * n_max + lengths[t]),
// and slot S-1 goes first so that decode emits slot 0 first. S = 1 is the
// per-list encode; `order` (nullable) is meaningful only then.
template <class St>
ROC_HD void encode_slots(St& s, const uint64_t* ids, const int32_t* lengths,
                         const int32_t* precision, int S, int n_slices,
                         Strided<uint32_t> bits, Strided<int32_t> tree, int32_t* order,
                         int n_max) {
  for (int t = S - 1; t >= 0; --t)
    encode_lane(s, ids + (int64_t)t * n_max, lengths[t], precision[t], n_slices, bits, tree,
                order, n_max);
}

// ---------------------------------------------------------------- decode

// Thread t's share of the rank of `sym` among the first i symbols of a lane:
// the count of j < i with j = t (mod 32) and syms[j] < sym. The 32 shares sum
// to the rank. Sym is uint32_t only where every symbol fits in it.
template <typename Sym>
ROC_HD uint32_t rank_share(const Sym* syms, int i, uint64_t sym, int t) {
  const Sym key = (Sym)sym;
  uint32_t c = 0;
  for (int j = t; j < i; j += kWarpSize) c += syms[j] < key ? 1u : 0u;
  return c;
}

// The threads that carry one lane of the decode. On the card: the warp, this
// thread being thread t of 32; each thread stores the symbols j = t (mod 32),
// counts them for the rank, and a warp reduction sums the 32 counts. Built for
// the CPU, one thread stands for the 32: it takes the 32 shares in a loop,
// sums them, and stores every symbol.
struct LaneWarp {
  int t;
  template <typename Sym>
  ROC_HD uint32_t rank(const Sym* syms, int i, uint64_t sym) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(0xFFFFFFFFu, rank_share(syms, i, sym, t));
#else
    uint32_t r = 0;
    for (int u = 0; u < kWarpSize; ++u) r += rank_share(syms, i, sym, u);
    return r;
#endif
  }
  // whether this thread stores symbol j
  ROC_HD bool owns(int j) const {
#ifdef __CUDA_ARCH__
    return (j & (kWarpSize - 1)) == t;
#else
    return true;
#endif
  }
  // this thread's first index and stride in a pass over a row
  ROC_HD int first() const {
#ifdef __CUDA_ARCH__
    return t;
#else
    return 0;
#endif
  }
  ROC_HD int stride() const {
#ifdef __CUDA_ARCH__
    return kWarpSize;
#else
    return 1;
#endif
  }
  ROC_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

// ROC decode of one lane by a warp (reference codec.cpp:140-152). Every
// thread runs the chain (pop the symbol, push its rank modulo i + 1) on the
// same state; the rank is the warp's sum. `syms` holds the symbols decoded so
// far, symbol j stored and read only by thread j mod 32. At the end the warp
// writes the n ids in encode sampling order (decode order reversed) to
// out[0, n) and zeros to out[n, n_max), in one coalesced pass.
template <class St, typename Sym>
ROC_HD void decode_lane(St& s, int n, int precision, int n_slices, Sym* syms, int64_t* out,
                        int n_max, const LaneWarp& warp) {
  for (int i = 0; i < n; ++i) {
    uint64_t sym = pop_symbol(s, precision, n_slices);
    uint32_t rank = warp.rank(syms, i, sym);
    if (warp.owns(i)) syms[i] = (Sym)sym;
    push_mod(s, rank, (uint32_t)(i + 1));
  }
  warp.sync();
  for (int j = warp.first(); j < n_max; j += warp.stride())
    out[j] = j < n ? (int64_t)syms[n - 1 - j] : 0;
  warp.sync();  // the next slot overwrites syms
}

// Inverse of encode_slots (codecs/roc_device.py roc_decode_chained): slots
// 0..S-1 in turn on one state, slot t into out[t * n_max, (t + 1) * n_max),
// the symbol buffer restarted per slot.
template <class St, typename Sym>
ROC_HD void decode_slots(St& s, const int32_t* lengths, const int32_t* precision, int S,
                         int n_slices, Sym* syms, int64_t* out, int n_max,
                         const LaneWarp& warp) {
  for (int t = 0; t < S; ++t)
    decode_lane(s, lengths[t], precision[t], n_slices, syms, out + (int64_t)t * n_max, n_max,
                warp);
}

// ------------------------------------------------------------- chain only

// A lane's serial chain with its rank and select work taken out, for the
// chain probe (probe_chain.cu), which times it as the floor of a step of
// either kernel. The decode chain takes the rank of step i from ranks[i] and
// stores the symbol of step i at syms[i] (decode order); the encode chain
// pushes ids[i] at step i (the ids in sampling order). Given the ranks that
// decode_lane computes, or the ids in the order that encode_lane selects
// them, each leaves the state that decode_lane or encode_lane leaves.
template <class St>
ROC_HD void decode_chain(St& s, int n, int precision, int n_slices, const int32_t* ranks,
                         uint64_t* syms) {
  for (int i = 0; i < n; ++i) {
    syms[i] = pop_symbol(s, precision, n_slices);
    push_mod(s, (uint32_t)ranks[i], (uint32_t)(i + 1));
  }
}

template <class St>
ROC_HD void encode_chain(St& s, const uint64_t* ids, int n, int precision, int n_slices) {
  for (int i = 0; i < n; ++i) {
    pop_mod(s, (uint32_t)(n - i));
    push_symbol(s, ids[i], precision, n_slices);
  }
}

}  // namespace roc
