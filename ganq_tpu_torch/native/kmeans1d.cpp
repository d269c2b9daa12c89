// Exact weighted 1-D k-means via dynamic programming with divide-and-conquer
// split-point monotonicity: O(k n log n) per problem.
//
// The PyTorch port's own copy of ganq_tpu/native/kmeans1d.cpp (same code,
// so both packages produce bit-identical codebooks from the same inputs).
// Native replacement for the reference's external `kmeans1d` C++ dependency
// (smpanaro fork, SMAWK-based; used for GANQ codebook init with LeanQuant
// weights, gptqmodel/quantization/ganq.py:423-438). Optimal 1-D clusters are
// contiguous in sorted order, so the DP over split points is exact; the
// divide-and-conquer recursion exploits monotonicity of the argmin.
//
// C ABI, consumed via ctypes (ganq_tpu_torch/ops/kmeans_exact.py), built by
// g++ at first use into build/. Threading is done on the Python side per
// row block (the GIL is released during the call).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

struct Prefix {
  std::vector<double> w, wx, wxx;
  explicit Prefix(const double* x, const double* wt, int n)
      : w(n + 1, 0.0), wx(n + 1, 0.0), wxx(n + 1, 0.0) {
    for (int i = 0; i < n; ++i) {
      w[i + 1] = w[i] + wt[i];
      wx[i + 1] = wx[i] + wt[i] * x[i];
      wxx[i + 1] = wxx[i] + wt[i] * x[i] * x[i];
    }
  }
  // weighted SSE of sorted x[i..j] (inclusive) around its weighted mean
  inline double cost(int i, int j) const {
    double sw = w[j + 1] - w[i];
    if (sw <= 0.0) return 0.0;
    double swx = wx[j + 1] - wx[i];
    double swxx = wxx[j + 1] - wxx[i];
    double c = swxx - swx * swx / sw;
    return c > 0.0 ? c : 0.0;
  }
  inline double mean(int i, int j) const {
    double sw = w[j + 1] - w[i];
    if (sw <= 0.0) return 0.0;  // zero-weight segment: centroid pinned below
    return (wx[j + 1] - wx[i]) / sw;
  }
};

// Fill layer `cur` of the DP for columns [lo, hi], knowing the optimal split
// for each column lies in [splo, sphi].
void dc_layer(const Prefix& pf, const std::vector<double>& prev,
              std::vector<double>& cur, std::vector<int>& arg,
              int lo, int hi, int splo, int sphi) {
  if (lo > hi) return;
  int mid = (lo + hi) / 2;
  double best = std::numeric_limits<double>::infinity();
  int best_i = splo;
  int up = sphi < mid ? sphi : mid;
  for (int i = splo; i <= up; ++i) {
    // clusters = prev layer covering [0, i-1], new cluster = [i, mid]
    double c = prev[i] + pf.cost(i, mid);
    if (c < best) {
      best = c;
      best_i = i;
    }
  }
  cur[mid + 1] = best;
  arg[mid] = best_i;
  dc_layer(pf, prev, cur, arg, lo, mid - 1, splo, best_i);
  dc_layer(pf, prev, cur, arg, mid + 1, hi, best_i, sphi);
}

}  // namespace

extern "C" {

// x must be sorted ascending; w are nonnegative weights.
// centroids_out: k doubles (ascending); assign_out: n ints (may be null).
// Returns the optimal objective value.
double kmeans1d_sorted(const double* x, const double* w, int32_t n, int32_t k,
                       double* centroids_out, int32_t* assign_out) {
  if (n <= 0 || k <= 0) return 0.0;
  Prefix pf(x, w, n);

  if (k >= n) {  // every point its own cluster; pad with the max value
    for (int i = 0; i < n; ++i) {
      if (assign_out) assign_out[i] = i;
      centroids_out[i] = x[i];
    }
    for (int c = n; c < k; ++c) centroids_out[c] = x[n - 1];
    return 0.0;
  }

  // D[t][j+1] = optimal cost of clustering x[0..j] into t+1 clusters
  std::vector<double> prev(n + 1), cur(n + 1);
  std::vector<std::vector<int>> args(k, std::vector<int>(n, 0));
  prev[0] = 0.0;
  for (int j = 0; j < n; ++j) prev[j + 1] = pf.cost(0, j);
  for (int t = 1; t < k; ++t) {
    cur[0] = 0.0;
    dc_layer(pf, prev, cur, args[t], 0, n - 1, 0, n - 1);
    std::swap(prev, cur);
  }
  double opt = prev[n];

  // backtrack segment boundaries
  std::vector<int> starts(k);
  int j = n - 1;
  for (int t = k - 1; t >= 1; --t) {
    starts[t] = args[t][j];
    j = starts[t] - 1;
  }
  starts[0] = 0;

  for (int t = 0; t < k; ++t) {
    int a = starts[t];
    int b = (t + 1 < k) ? starts[t + 1] - 1 : n - 1;
    double m = (pf.w[b + 1] - pf.w[a] > 0.0) ? pf.mean(a, b)
                                             : 0.5 * (x[a] + x[b]);
    centroids_out[t] = m;
    if (assign_out)
      for (int i = a; i <= b; ++i) assign_out[i] = t;
  }
  return opt;
}

// Batched entry: m independent rows sharing one weight vector (the GANQ
// shape: weights = diag(Hinv)^-exp are per-column, identical across rows).
// X: m*n row-major (unsorted). centroids_out: m*k (each row ascending).
void kmeans1d_rows(const double* X, const double* w, int32_t m, int32_t n,
                   int32_t k, double* centroids_out) {
  std::vector<std::pair<double, double>> buf(n);
  std::vector<double> xs(n), ws(n);
  for (int r = 0; r < m; ++r) {
    const double* x = X + (size_t)r * n;
    for (int i = 0; i < n; ++i) buf[i] = {x[i], w[i]};
    std::sort(buf.begin(), buf.end());
    for (int i = 0; i < n; ++i) {
      xs[i] = buf[i].first;
      ws[i] = buf[i].second;
    }
    kmeans1d_sorted(xs.data(), ws.data(), n, k,
                    centroids_out + (size_t)r * k, nullptr);
  }
}

}  // extern "C"
