// Native host ROC codec — the framework's C++ runtime path for
// index-construction-scale encode/decode on the host CPU.
//
// A copy of the JAX package's native/roc_native.cpp, so that the port builds
// it from its own tree (native/__init__.py runs g++ into _build/).
//
// This is NOT a copy of the reference (custom_invlist_cpp/codec.cpp): the
// stream format is the same bit-exact contract the whole framework tests
// against (see core/rans.py for the semantics and reference file:line cites),
// but the architecture is this framework's own batch design:
//   - flat (offsets, values) batch API over thousands of lists, one call;
//   - std::thread fan-out over lists (the reference uses OpenMP pragmas);
//   - encode-side order statistics via a Fenwick binary-indexed tree over
//     rank space (mirrors core/order_stats.py), not a pointer BST;
//   - decode-side insert-rank via a treap with subtree counts.
//
// C ABI only — bound from Python with ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread roc_native.cpp -o libroc_native.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t RANS_L = 1ull << 31;
constexpr uint32_t MT_SEED = 1234;  // reference codec.h:16-18

// ---------------------------------------------------------------- MT19937
struct MT19937 {
    uint32_t s[624];
    int idx;
    explicit MT19937(uint32_t seed = MT_SEED) {
        s[0] = seed;
        for (int i = 1; i < 624; i++)
            s[i] = 1812433253u * (s[i - 1] ^ (s[i - 1] >> 30)) + (uint32_t)i;
        idx = 624;
    }
    void twist() {
        for (int i = 0; i < 624; i++) {
            uint32_t y = (s[i] & 0x80000000u) | (s[(i + 1) % 624] & 0x7fffffffu);
            s[i] = s[(i + 397) % 624] ^ (y >> 1);
            if (y & 1) s[i] ^= 2567483615u;
        }
        idx = 0;
    }
    uint32_t next() {
        if (idx >= 624) twist();
        uint32_t y = s[idx++];
        y ^= y >> 11;
        y ^= (y << 7) & 2636928640u;
        y ^= (y << 15) & 4022730752u;
        y ^= y >> 18;
        return y;
    }
};

// ------------------------------------------------------------- rANS state
struct State {
    uint64_t head = RANS_L;
    std::vector<uint32_t> stack;
    MT19937 mt;
    uint32_t mt_draws = 0;

    uint32_t slice() {
        if (!stack.empty()) {
            uint32_t w = stack.back();
            stack.pop_back();
            return w;
        }
        mt_draws++;
        return mt.next();
    }
    void push_word(uint32_t w) { stack.push_back(w); }
};

// power-of-two uniform coding (semantics: core/rans.py push/pop_uniform)
inline void push_uniform(State& st, uint64_t value, int precision) {
    uint64_t head = st.head;
    if (head >= ((RANS_L >> precision) << 32)) {
        st.push_word((uint32_t)head);
        head >>= 32;
    }
    st.head = (head << precision) + value;
}

inline uint64_t pop_uniform(State& st, int precision) {
    uint64_t head0 = st.head;
    uint64_t value = head0 & ((1ull << precision) - 1);
    uint64_t head = head0 >> precision;
    if (head < RANS_L) head = (head << 32) | st.slice();
    st.head = head;
    return value;
}

// arbitrary-modulus uniform coding (core/rans.py push/pop_mod)
inline void push_mod(State& st, uint64_t value, uint64_t nmax) {
    uint64_t head0 = st.head;
    if (head0 >= ((RANS_L / nmax) << 32)) {
        st.push_word((uint32_t)head0);
        head0 >>= 32;
    }
    uint64_t head = head0 * nmax + value;
    if (head < RANS_L) head = (head << 32) | st.slice();
    st.head = head;
}

inline uint64_t pop_mod(State& st, uint64_t nmax) {
    uint64_t head0 = st.head;
    if (head0 >= nmax * ((RANS_L / nmax) << 32)) {
        st.push_word((uint32_t)head0);
        head0 >>= 32;
    }
    uint64_t value = head0 % nmax;
    uint64_t head = head0 / nmax;
    if (head0 < RANS_L) head = st.slice() | (head << 32);
    st.head = head;
    return value;
}

inline int slice_precision(int precision, int lower) {
    int p = precision - lower;
    return p < 0 ? 0 : (p > 16 ? 16 : p);
}

// u64 symbol as four 16-bit slices (core/rans.py push/pop_symbol)
inline void push_symbol(State& st, uint64_t symbol, int precision) {
    for (int lower = 0; lower < 64; lower += 16)
        push_uniform(st, (symbol >> lower) & 0xffff,
                     slice_precision(precision, lower));
}

inline uint64_t pop_symbol(State& st, int precision) {
    uint64_t symbol = 0;
    for (int lower = 48; lower >= 0; lower -= 16)
        symbol = (symbol << 16) | pop_uniform(st, slice_precision(precision, lower));
    return symbol;
}

// ----------------------------------- encode-side Fenwick order statistics
struct FenwickSelect {
    int n, log2n;
    std::vector<int32_t> tree;  // 1-based BIT of presence counts
    explicit FenwickSelect(int n_) : n(n_), tree(n_ + 1, 0) {
        log2n = 0;
        while ((2 << log2n) <= n) log2n++;
        // all-ones init: tree[i] = i & (-i) gives presence count 1 per slot
        for (int i = 1; i <= n; i++) tree[i] = i & (-i);
    }
    // remove and return the rank-space position of the k-th smallest (0-based)
    int select_remove(int k) {
        int pos = 0, rem = k, step = 1 << log2n;
        while (step) {
            int nxt = pos + step;
            if (nxt <= n && tree[nxt] <= rem) {
                rem -= tree[nxt];
                pos = nxt;
            }
            step >>= 1;
        }
        for (int i = pos + 1; i <= n; i += i & (-i)) tree[i] -= 1;
        return pos;
    }
};

// --------------------------------------- decode-side treap (insert + rank)
struct Treap {
    struct Node {
        uint64_t key;
        uint32_t prio;
        int left = -1, right = -1, cnt = 1;
    };
    std::vector<Node> nodes;
    int root = -1;
    uint64_t lcg = 0x9e3779b97f4a7c15ull;

    uint32_t rand_prio() {
        lcg = lcg * 6364136223846793005ull + 1442695040888963407ull;
        return (uint32_t)(lcg >> 33);
    }
    int count(int t) { return t < 0 ? 0 : nodes[t].cnt; }
    void update(int t) {
        nodes[t].cnt = 1 + count(nodes[t].left) + count(nodes[t].right);
    }
    void split(int t, uint64_t key, int& l, int& r) {
        if (t < 0) { l = r = -1; return; }
        if (nodes[t].key < key) {
            split(nodes[t].right, key, nodes[t].right, r);
            l = t;
        } else {
            split(nodes[t].left, key, l, nodes[t].left);
            r = t;
        }
        update(t);
    }
    int merge(int l, int r) {
        if (l < 0) return r;
        if (r < 0) return l;
        if (nodes[l].prio > nodes[r].prio) {
            nodes[l].right = merge(nodes[l].right, r);
            update(l);
            return l;
        }
        nodes[r].left = merge(l, nodes[r].left);
        update(r);
        return r;
    }
    // insert key, return number of strictly smaller keys already present
    int insert_rank(uint64_t key) {
        int l, r;
        split(root, key, l, r);
        int rank = count(l);
        int node = (int)nodes.size();
        nodes.push_back(Node{key, rand_prio()});
        root = merge(merge(l, node), r);
        return rank;
    }
};

// ------------------------------------------------------------ per-list ops

// sort (id, position) pairs ascending by id; ids are distinct
void argsort_ids(const uint64_t* ids, int n, std::vector<int32_t>& perm) {
    perm.resize(n);
    for (int i = 0; i < n; i++) perm[i] = i;
    std::sort(perm.begin(), perm.end(),
              [&](int32_t a, int32_t b) { return ids[a] < ids[b]; });
}

void encode_one(const uint64_t* ids, int n, int precision,
                uint64_t* out_head, uint32_t* out_stack, int32_t cap,
                int32_t* out_stack_len, int32_t* out_order,
                uint32_t* out_mt_draws, std::atomic<int>* overflow) {
    State st;
    std::vector<int32_t> perm;
    argsort_ids(ids, n, perm);
    FenwickSelect tree(n);
    for (int i = 0; i < n; i++) {
        uint64_t idx = pop_mod(st, (uint64_t)(n - i));
        int pos = tree.select_remove((int)idx);
        push_symbol(st, ids[perm[pos]], precision);
        out_order[i] = perm[pos];
    }
    *out_head = st.head;
    *out_mt_draws = st.mt_draws;
    int len = (int)st.stack.size();
    if (len > cap) {
        overflow->store(1);
        len = cap;
    }
    *out_stack_len = (int32_t)st.stack.size();
    std::memcpy(out_stack, st.stack.data(), sizeof(uint32_t) * len);
}

void decode_one(uint64_t head, const uint32_t* stack, int stack_len,
                int n, int precision, uint64_t* out_ids) {
    State st;
    st.head = head;
    st.stack.assign(stack, stack + stack_len);
    Treap treap;
    treap.nodes.reserve(n);
    for (int i = 0; i < n; i++) {
        uint64_t symbol = pop_symbol(st, precision);
        int start = treap.insert_rank(symbol);
        push_mod(st, (uint64_t)start, (uint64_t)(i + 1));
        out_ids[n - i - 1] = symbol;
    }
}

void parallel_for_impl(int n, int n_threads,
                       const std::function<void(int)>& fn) {
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; i++) fn(i);
        return;
    }
    std::atomic<int> next(0);
    auto worker = [&] {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            fn(i);
        }
    };
    std::vector<std::thread> pool;
    int t = std::min(n_threads, n);
    pool.reserve(t);
    for (int i = 0; i < t; i++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}
}  // namespace

extern "C" {

// Encode n_lists lists of distinct u64 ids.
//   ids_flat / offsets[n_lists+1]: ragged input
//   precisions[n_lists]
//   out_heads[n_lists], out_stacks[n_lists*cap], out_stack_lens[n_lists]
//   out_order: ragged like ids_flat — per-list permutation (local indices)
//   out_mt_draws[n_lists]
// Returns 0, or 1 if any list overflowed `cap` stack words.
int roc_encode_lists(const uint64_t* ids_flat, const int64_t* offsets,
                     int n_lists, const int32_t* precisions,
                     uint64_t* out_heads, uint32_t* out_stacks, int32_t cap,
                     int32_t* out_stack_lens, int32_t* out_order,
                     uint32_t* out_mt_draws, int n_threads) {
    std::atomic<int> overflow(0);
    parallel_for_impl(n_lists, n_threads, [&](int li) {
        int64_t b = offsets[li], e = offsets[li + 1];
        encode_one(ids_flat + b, (int)(e - b), precisions[li],
                   out_heads + li, out_stacks + (int64_t)li * cap, cap,
                   out_stack_lens + li, out_order + b, out_mt_draws + li,
                   &overflow);
    });
    return overflow.load();
}

// Decode n_lists lists. Outputs ids in decode order (= encode sampling order).
int roc_decode_lists(const uint64_t* heads, const uint32_t* stacks,
                     int32_t cap, const int32_t* stack_lens,
                     const int64_t* offsets, int n_lists,
                     const int32_t* precisions, uint64_t* out_ids_flat,
                     int n_threads) {
    parallel_for_impl(n_lists, n_threads, [&](int li) {
        int64_t b = offsets[li], e = offsets[li + 1];
        decode_one(heads[li], stacks + (int64_t)li * cap, stack_lens[li],
                   (int)(e - b), precisions[li], out_ids_flat + b);
    });
    return 0;
}

}  // extern "C"
