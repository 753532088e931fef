// HNSW link assignment on the host: the order-dependent half of an insert
// batch (the JAX package's search/hnsw.py _insert_batch loop), point by point
// in batch order, over one layer's adjacency.
//
// For each point p of the batch at this level, its selected friends (the
// closest out_deg of its pool search, p itself and -1 dropped) become its row;
// on the re-link pass they are merged with the row it already has and the
// closest out_deg kept. Then p is added to each new friend's row: into its
// first free slot, or, when the row is full, the row keeps the Mcap closest
// of its entries and p. Each point's walk entry for the next level down
// becomes its first new friend.
//
// Distances are the JAX package's numpy float32 arithmetic bit for bit: the
// differences and squares rounded to float32, then summed in numpy's
// pairwise order (see pairwise_sum). Sorting by distance is stable, which is
// numpy's argsort order wherever the distances are distinct (and for up to 16
// elements, its insertion sort, always). Build without -ffast-math and with
// -ffp-contract=off, so that no sum is reassociated or fused.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

// numpy's pairwise summation of n contiguous float32 values (its
// FLOAT_pairwise_sum): sequential from -0.0 below 8 terms; up to 128, eight
// accumulators over strided terms combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))
// and the tail added in turn; above 128, the two halves split at a multiple
// of 8.
float pairwise_sum(const float* a, int64_t n) {
  if (n < 8) {
    float res = -0.0f;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    const int64_t m = n - n % 8;
    for (int64_t i = 8; i < m; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (int64_t i = m; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

struct Layer {
  int32_t* adj;
  int64_t cap;
  const float* xb;
  int64_t d;
  std::vector<float> sq;  // scratch: one row of squared differences

  int32_t* row(int64_t v) { return adj + v * cap; }

  // ((xb[c] - xb[v]) ** 2).sum() per candidate; inf for c < 0
  std::vector<float> dists(int64_t v, const std::vector<int64_t>& cand) {
    std::vector<float> out(cand.size());
    const float* x = xb + v * d;
    for (size_t i = 0; i < cand.size(); ++i) {
      if (cand[i] < 0) {
        out[i] = std::numeric_limits<float>::infinity();
        continue;
      }
      const float* y = xb + cand[i] * d;
      for (int64_t j = 0; j < d; ++j) {
        const float t = y[j] - x[j];
        sq[j] = t * t;
      }
      out[i] = pairwise_sum(sq.data(), d);
    }
    return out;
  }

  // the candidates ordered by distance to v (stable), first `keep` of them
  std::vector<int64_t> closest(int64_t v, const std::vector<int64_t>& cand, int64_t keep) {
    const std::vector<float> dv = dists(v, cand);
    std::vector<int64_t> idx(cand.size());
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int64_t a, int64_t b) { return dv[a] < dv[b]; });
    std::vector<int64_t> out;
    for (int64_t i = 0; i < std::min<int64_t>(keep, cand.size()); ++i) out.push_back(cand[idx[i]]);
    return out;
  }

  bool holds(int64_t v, int64_t p) {
    const int32_t* r = row(v);
    return std::find(r, r + cap, static_cast<int32_t>(p)) != r + cap;
  }
};

}  // namespace

extern "C" {

// adj: i32[N, cap] one layer, modified in place; xb: f32[N, d]; pts: i64[B]
// the batch; sub: i64[n_sub] the batch positions at this level, in order;
// sel: i64[n_sub, out_deg] each one's pool, closest first, -1 padded;
// cur: i64[B] walk entries, updated. Returns 0.
int hnsw_link(int32_t* adj, int64_t cap, const float* xb, int64_t d, const int64_t* pts,
              const int64_t* sub, int64_t n_sub, const int64_t* sel, int64_t out_deg,
              int64_t mcap, int relink, int64_t* cur) {
  Layer layer{adj, cap, xb, d, std::vector<float>(static_cast<size_t>(d))};
  for (int64_t r = 0; r < n_sub; ++r) {
    const int64_t bi = sub[r];
    const int64_t p = pts[bi];
    int32_t* prow = layer.row(p);
    std::vector<int64_t> friends;
    for (int64_t j = 0; j < out_deg; ++j) {
      const int64_t v = sel[r * out_deg + j];
      if (v >= 0 && v != p) friends.push_back(v);
    }
    if (relink) {
      // merge with the first pass's links (first occurrence kept), keep the
      // closest out_deg
      std::vector<int64_t> existing;
      for (int64_t j = 0; j < cap; ++j)
        if (prow[j] >= 0) existing.push_back(prow[j]);
      std::vector<int64_t> merged;
      for (const auto& src : {existing, friends})
        for (int64_t v : src)
          if (std::find(merged.begin(), merged.end(), v) == merged.end()) merged.push_back(v);
      if (!merged.empty()) merged = layer.closest(p, merged, out_deg);
      std::vector<int64_t> fresh;
      for (int64_t v : merged)
        if (std::find(existing.begin(), existing.end(), v) == existing.end()) fresh.push_back(v);
      std::fill(prow, prow + cap, -1);
      for (size_t j = 0; j < merged.size(); ++j) prow[j] = static_cast<int32_t>(merged[j]);
      friends = fresh;  // only fresh reverse edges below
    } else {
      for (size_t j = 0; j < friends.size(); ++j) prow[j] = static_cast<int32_t>(friends[j]);
    }
    for (int64_t v : friends) {
      if (layer.holds(v, p)) continue;
      int32_t* vrow = layer.row(v);
      int32_t* slot = std::find_if(vrow, vrow + cap, [](int32_t x) { return x < 0; });
      if (slot != vrow + cap) {
        *slot = static_cast<int32_t>(p);
        continue;
      }
      // prune: keep the mcap closest of the row and p
      std::vector<int64_t> cand(vrow, vrow + cap);
      cand.push_back(p);
      const std::vector<int64_t> keep = layer.closest(v, cand, mcap);
      for (size_t j = 0; j < keep.size(); ++j) vrow[j] = static_cast<int32_t>(keep[j]);
    }
    if (!friends.empty()) cur[bi] = friends[0];
  }
  return 0;
}

// distances from node v to each candidate, as hnsw_link computes them (for
// the tests against numpy)
void hnsw_pair_dists(const float* xb, int64_t d, int64_t v, const int64_t* cand, int64_t n,
                     float* out) {
  Layer layer{nullptr, 0, xb, d, std::vector<float>(static_cast<size_t>(d))};
  const std::vector<float> dv = layer.dists(v, std::vector<int64_t>(cand, cand + n));
  std::copy(dv.begin(), dv.end(), out);
}

}  // extern "C"
