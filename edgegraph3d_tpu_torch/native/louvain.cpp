// Native sequential local-moving pass of host Louvain.
//
// One level of Louvain's local moving over a CSR adjacency, with the
// float64 operations of the JAX package's numpy pass
// (edgegraph3d_tpu/matching/communities.py::_louvain_one_level) in the
// same order, so the labels are that pass's bit for bit:
//   - each sweep visits the active nodes in ascending order, after
//     clearing every active flag; a move wakes the mover's neighbours
//     for the next sweep; nodes without neighbours are skipped; at most
//     64 sweeps, and none after a sweep with no move;
//   - a visit sums the weights towards each neighbouring community as
//     np.add.reduceat sums a stable sort of them by label: the first
//     weight plus numpy's pairwise sum of the rest, in CSR order;
//   - the gains are evaluated as written there, the first maximum in
//     ascending label order wins, and the move rule keeps its 1e-12
//     tolerance.
// Built with -ffp-contract=off: a fused multiply-add rounds once where
// numpy rounds twice.  Exposed through a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// numpy's pairwise summation of n doubles (loops_utils.h.src,
// PW_BLOCKSIZE 128): a plain loop below 8 values, 8 partial sums up to
// 128, and above that two halves split at a multiple of 8.
double pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = -0.0;
    for (int64_t i = 0; i < n; i++) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; j++) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; j++) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; i++) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// One segment of np.add.reduceat: its first value, to which the reduce
// loop adds the pairwise sum of the others.
inline double segment_sum(const double* a, int64_t n) {
  return n == 1 ? a[0] : a[0] + pairwise_sum(a + 1, n - 1);
}

}  // namespace

extern "C" {

// np.add.reduceat(x[:n], starts) for strictly ascending starts[0] = 0:
// out[k] sums x[starts[k] : starts[k + 1]] (the last segment to n).
void eg3d_segment_sums(const double* x, const int64_t* starts,
                       int64_t n_seg, int64_t n, double* out) {
  for (int64_t k = 0; k < n_seg; k++) {
    const int64_t end = k + 1 < n_seg ? starts[k + 1] : n;
    out[k] = segment_sum(x + starts[k], end - starts[k]);
  }
}

// One level of local moving over the CSR adjacency (indptr [n + 1],
// nbr and w [indptr[n]]) of a graph with weighted degrees deg [n] and
// total weight two_m > 0.  Writes labels [n]; adds the sweeps run, the
// nodes visited and the moves made to counts [3].
void eg3d_louvain_one_level(const int64_t* indptr, const int64_t* nbr,
                            const double* w, const double* deg, int64_t n,
                            double two_m, int64_t* labels, int64_t* counts) {
  std::vector<double> sum_tot(deg, deg + n);  // degree per community
  std::vector<uint8_t> active(n, 1);
  std::vector<int64_t> order;
  order.reserve(n);
  int64_t max_deg = 0;
  for (int64_t i = 0; i < n; i++) {
    labels[i] = i;
    if (indptr[i + 1] - indptr[i] > max_deg)
      max_deg = indptr[i + 1] - indptr[i];
  }
  // a visit's neighbours grouped by label without a sort: slot[label]
  // is the label's group (-1 outside a visit), groups in first-seen
  // order, g_of the group of each neighbour, each group's weights kept
  // in CSR order in buf
  std::vector<int64_t> slot(n, -1);
  std::vector<int64_t> g_label(max_deg), g_count(max_deg), g_end(max_deg),
      g_of(max_deg);
  std::vector<double> buf(max_deg);
  for (int sweep = 0; sweep < 64; sweep++) {
    order.clear();
    for (int64_t i = 0; i < n; i++)
      if (active[i]) order.push_back(i);
    if (order.empty()) break;
    std::fill(active.begin(), active.end(), 0);
    counts[0]++;
    bool moved = false;
    for (const int64_t i : order) {
      const int64_t s = indptr[i], t = indptr[i + 1];
      if (s == t) continue;
      counts[1]++;
      int64_t ng = 0;
      for (int64_t k = s; k < t; k++) {
        const int64_t lab = labels[nbr[k]];
        int64_t g = slot[lab];
        if (g < 0) {
          g = slot[lab] = ng;
          g_label[ng] = lab;
          g_count[ng++] = 0;
        }
        g_count[g]++;
        g_of[k - s] = g;
      }
      for (int64_t g = 0, off = 0; g < ng; g++) {
        g_end[g] = off;
        off += g_count[g];
      }
      for (int64_t k = s; k < t; k++) buf[g_end[g_of[k - s]]++] = w[k];
      const int64_t ci = labels[i];
      const double di = deg[i];
      sum_tot[ci] -= di;
      bool has_own = false;
      double stay = 0.0, best_g = 0.0;
      int64_t best_c = -1;
      for (int64_t g = 0; g < ng; g++) {
        const int64_t c = g_label[g];
        slot[c] = -1;
        const double wc = segment_sum(buf.data() + g_end[g] - g_count[g],
                                      g_count[g]);
        const double gain = wc - di * sum_tot[c] / two_m;
        if (c == ci) {
          stay = gain;
          has_own = true;
        }
        // np.argmax over ascending labels: the first maximum
        if (best_c < 0 || gain > best_g || (gain == best_g && c < best_c)) {
          best_c = c;
          best_g = gain;
        }
      }
      if (!has_own) stay = -di * sum_tot[ci] / two_m;
      const bool move = best_g > stay + 1e-12 ||
                        (std::fabs(best_g - stay) <= 1e-12 && best_c < ci);
      const int64_t new_c = move ? best_c : ci;
      labels[i] = new_c;
      sum_tot[new_c] += di;
      if (new_c != ci) {
        moved = true;
        counts[2]++;
        for (int64_t k = s; k < t; k++) active[nbr[k]] = 1;
      }
    }
    if (!moved) break;
  }
}

}  // extern "C"
