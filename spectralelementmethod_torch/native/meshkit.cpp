// meshkit: native host-side mesh/runtime kernels (a copy of the JAX
// package's native/meshkit.cpp).
//
// The device compute runs in PyTorch and the CUDA kernels of csrc/; this
// module covers the *host* hot paths that are data-dependent and
// Python-slow:
//
//  * face-key matching (mesh adjacency / boundary attach) via an
//    open-addressing hash -- O(F) instead of numpy's O(F log F) sort;
//  * batched point location: uniform-bin candidate search + Newton
//    inverse isoparametric mapping with barycentric Lagrange evaluation.
//    This is the native counterpart of the reference's only C component
//    (sem/bary_interp.c, a standalone barycentric-interpolation
//    prototype that was never built) and of its Python point-location
//    loop (sem/mapping.py:146-178, sem/discrete.py:263-280).
//
// Built as a plain C-ABI shared library and loaded with ctypes; if the
// toolchain is unavailable the Python fallbacks in mesh/ and core/ are
// used instead.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hash-based key matching
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// partner[i] = j where keys[j] == keys[i] (j != i), else -1.
// Returns 0 on success, k>0 if some key occurs more than twice
// (k = 1-based index of an offending entry).
int64_t semn_match_keys(const int64_t* keys, int64_t n, int64_t* partner) {
  uint64_t cap = 1;
  while (cap < (uint64_t)(n * 2 + 2)) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::vector<int64_t> slot_key(cap);
  std::vector<int64_t> slot_ix(cap, -1);

  for (int64_t i = 0; i < n; ++i) partner[i] = -1;

  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    uint64_t h = mix64((uint64_t)k) & mask;
    for (;;) {
      if (slot_ix[h] < 0) {          // empty: insert
        slot_ix[h] = i;
        slot_key[h] = k;
        break;
      }
      if (slot_key[h] == k) {        // found the mate (slot stays occupied)
        const int64_t j = slot_ix[h];
        if (partner[j] != -1) return i + 1;  // third occurrence
        partner[i] = j;
        partner[j] = i;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return 0;
}

// out_idx[q] = index i with keys[i] == query[q], else -1 (first match).
void semn_lookup_keys(const int64_t* keys, int64_t n, const int64_t* query,
                      int64_t m, int64_t* out_idx) {
  uint64_t cap = 1;
  while (cap < (uint64_t)(n * 2 + 2)) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::vector<int64_t> slot_key(cap);
  std::vector<int64_t> slot_ix(cap, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    uint64_t h = mix64((uint64_t)k) & mask;
    while (slot_ix[h] >= 0 && slot_key[h] != k) h = (h + 1) & mask;
    if (slot_ix[h] < 0) { slot_ix[h] = i; slot_key[h] = k; }
  }
  for (int64_t q = 0; q < m; ++q) {
    const int64_t k = query[q];
    uint64_t h = mix64((uint64_t)k) & mask;
    int64_t r = -1;
    for (;;) {
      if (slot_ix[h] < 0) break;
      if (slot_key[h] == k) { r = slot_ix[h]; break; }
      h = (h + 1) & mask;
    }
    out_idx[q] = r;
  }
}

// ---------------------------------------------------------------------------
// Barycentric Lagrange evaluation (parity: sem/bary_interp.c:39-90)
// ---------------------------------------------------------------------------

// L_i(x) for the nodal basis {nodes, bary weights}; exact node hits yield
// a one-hot row (reference handles this with an early return,
// sem/bary_interp.c:79-81; sem/basis_functions.py:260-341 repairs NaNs).
static void bary_row(const double* nodes, const double* w, int n, double x,
                     double* L) {
  double denom = 0.0;
  int hit = -1;
  for (int i = 0; i < n; ++i) {
    const double dx = x - nodes[i];
    if (dx == 0.0) { hit = i; break; }
    L[i] = w[i] / dx;
    denom += L[i];
  }
  if (hit >= 0) {
    for (int i = 0; i < n; ++i) L[i] = 0.0;
    L[hit] = 1.0;
    return;
  }
  const double inv = 1.0 / denom;
  for (int i = 0; i < n; ++i) L[i] *= inv;
}

// interpolate k fields given as coeffs (k, n0, n1) at one 2D point
static void interp2(const double* coeffs, int k, int n0, int n1,
                    const double* L0, const double* L1, double* out) {
  for (int c = 0; c < k; ++c) {
    double acc = 0.0;
    const double* f = coeffs + (int64_t)c * n0 * n1;
    for (int i = 0; i < n0; ++i) {
      double row = 0.0;
      for (int j = 0; j < n1; ++j) row += f[i * n1 + j] * L1[j];
      acc += L0[i] * row;
    }
    out[c] = acc;
  }
}

// ---------------------------------------------------------------------------
// Batched point location
// ---------------------------------------------------------------------------

// Newton inverse of the isoparametric map in element e.
// x_coeffs: (E, 2, n0, n1) physical coords of basis nodes;
// j_coeffs:  (E, 2, 2, n0, n1) Jacobian at basis nodes.
// Returns 0 = converged inside, 1 = converged outside (xi still written),
// 2 = failed.
static int newton_inverse(const double* xc, const double* jc, int n0, int n1,
                          const double* nodes0, const double* w0,
                          const double* nodes1, const double* w1,
                          const double* pt, double* xi, double bound_tol,
                          int it_max, double tol, double* excess_out,
                          std::vector<double>& L0, std::vector<double>& L1) {
  xi[0] = 0.0; xi[1] = 0.0;
  for (int it = 0; it < it_max; ++it) {
    bary_row(nodes0, w0, n0, xi[0], L0.data());
    bary_row(nodes1, w1, n1, xi[1], L1.data());
    double x[2], J[4];
    interp2(xc, 2, n0, n1, L0.data(), L1.data(), x);
    interp2(jc, 4, n0, n1, L0.data(), L1.data(), J);
    const double f0 = x[0] - pt[0], f1 = x[1] - pt[1];
    const double det = J[0] * J[3] - J[1] * J[2];
    if (det == 0.0 || !std::isfinite(det)) return 2;
    const double d0 = (J[3] * f0 - J[1] * f1) / det;
    const double d1 = (-J[2] * f0 + J[0] * f1) / det;
    xi[0] -= d0; xi[1] -= d1;
    if (!std::isfinite(xi[0]) || !std::isfinite(xi[1])) return 2;
    // keep the iterate in a sane neighborhood of the element
    xi[0] = std::max(-3.0, std::min(3.0, xi[0]));
    xi[1] = std::max(-3.0, std::min(3.0, xi[1]));
    if (std::sqrt(d0 * d0 + d1 * d1) < tol) {
      const double e0 = std::max(std::fabs(xi[0]) - 1.0, 0.0);
      const double e1 = std::max(std::fabs(xi[1]) - 1.0, 0.0);
      const double excess = std::max(e0, e1);
      *excess_out = excess;
      return excess <= bound_tol ? 0 : 1;
    }
  }
  return 2;
}

// Locate Q points in a 2D mesh of E elements.
//   centroids: (E, 2); x_coeffs: (E, 2, n0, n1); j_coeffs: (E, 2, 2, n0, n1)
//   points: (Q, 2)
// Outputs: elem (Q,) -1 if not found; xi (Q, 2).
// extrapolate_tol: accept the least-excess candidate if within tolerance.
void semn_locate_points(
    const double* centroids, int64_t E,
    const double* x_coeffs, const double* j_coeffs, int n0, int n1,
    const double* nodes0, const double* w0,
    const double* nodes1, const double* w1,
    const double* points, int64_t Q,
    double bound_tol, double extrapolate_tol, int64_t max_candidates,
    int64_t* elem, double* xi_out) {
  // uniform bin grid over centroid bounding box
  double lo[2] = {1e300, 1e300}, hi[2] = {-1e300, -1e300};
  for (int64_t e = 0; e < E; ++e) {
    for (int d = 0; d < 2; ++d) {
      lo[d] = std::min(lo[d], centroids[e * 2 + d]);
      hi[d] = std::max(hi[d], centroids[e * 2 + d]);
    }
  }
  int nb = (int)std::max(1.0, std::floor(std::sqrt((double)E / 4.0)));
  nb = std::min(nb, 1024);
  double span[2] = {std::max(hi[0] - lo[0], 1e-300),
                    std::max(hi[1] - lo[1], 1e-300)};
  std::vector<std::vector<int32_t>> bins((size_t)nb * nb);
  auto bin_of = [&](double x, double y) {
    int bx = (int)((x - lo[0]) / span[0] * nb);
    int by = (int)((y - lo[1]) / span[1] * nb);
    bx = std::max(0, std::min(nb - 1, bx));
    by = std::max(0, std::min(nb - 1, by));
    return bx * nb + by;
  };
  for (int64_t e = 0; e < E; ++e)
    bins[bin_of(centroids[e * 2], centroids[e * 2 + 1])].push_back((int32_t)e);

  std::vector<double> L0(n0), L1(n1);
  std::vector<std::pair<double, int64_t>> cand;

  for (int64_t q = 0; q < Q; ++q) {
    const double* pt = points + q * 2;
    elem[q] = -1;
    int bx = (int)((pt[0] - lo[0]) / span[0] * nb);
    int by = (int)((pt[1] - lo[1]) / span[1] * nb);
    bx = std::max(0, std::min(nb - 1, bx));
    by = std::max(0, std::min(nb - 1, by));

    double best_excess = 1e300, best_xi[2] = {0, 0};
    int64_t best_e = -1;

    // pass 0: expanding bin-ring search, a few nearest candidates;
    // pass 1 (rare, if not strictly inside any): all elements by distance
    for (int pass = 0; pass < 2 && elem[q] < 0; ++pass) {
      cand.clear();
      if (pass == 0) {
        const int64_t want = max_candidates > 0 ? max_candidates : 16;
        for (int r = 0; r < nb && (int64_t)cand.size() < want; ++r) {
          for (int i = std::max(0, bx - r); i <= std::min(nb - 1, bx + r);
               ++i) {
            for (int j = std::max(0, by - r); j <= std::min(nb - 1, by + r);
                 ++j) {
              if (r > 0 && std::abs(i - bx) != r && std::abs(j - by) != r)
                continue;  // ring boundary only
              for (int32_t e : bins[(size_t)i * nb + j]) {
                const double dx = centroids[e * 2] - pt[0];
                const double dy = centroids[e * 2 + 1] - pt[1];
                cand.emplace_back(dx * dx + dy * dy, e);
              }
            }
          }
        }
        if ((int64_t)cand.size() >= E) {  // pass 0 already saw everything
          ;
        }
      } else {
        cand.reserve(E);
        for (int64_t e = 0; e < E; ++e) {
          const double dx = centroids[e * 2] - pt[0];
          const double dy = centroids[e * 2 + 1] - pt[1];
          cand.emplace_back(dx * dx + dy * dy, e);
        }
      }
      std::sort(cand.begin(), cand.end());

      for (auto& ce : cand) {
        const int64_t e = ce.second;
        double xi[2], excess = 1e300;
        const int rc = newton_inverse(
            x_coeffs + (int64_t)e * 2 * n0 * n1,
            j_coeffs + (int64_t)e * 4 * n0 * n1, n0, n1,
            nodes0, w0, nodes1, w1, pt, xi, bound_tol, 8, 1e-8, &excess,
            L0, L1);
        if (rc == 0) {
          elem[q] = e;
          xi_out[q * 2] = std::max(-1.0, std::min(1.0, xi[0]));
          xi_out[q * 2 + 1] = std::max(-1.0, std::min(1.0, xi[1]));
          best_e = -1;
          break;
        }
        if (rc == 1 && excess < best_excess) {
          best_excess = excess;
          best_e = e;
          best_xi[0] = xi[0];
          best_xi[1] = xi[1];
        }
      }
      if (pass == 0 && (int64_t)cand.size() >= E) break;  // saw all already
    }
    if (elem[q] < 0 && best_e >= 0 && best_excess <= extrapolate_tol) {
      elem[q] = best_e;
      xi_out[q * 2] = std::max(-1.0, std::min(1.0, best_xi[0]));
      xi_out[q * 2 + 1] = std::max(-1.0, std::min(1.0, best_xi[1]));
    }
  }
}

}  // extern "C"
