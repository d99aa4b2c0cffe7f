// fdal_setup: host setup routines of the PyTorch port (point location,
// tensor Lagrange tabulation, COO deduplication, compact-AL accumulation).
//
// The solve runs on the card; these are the host-side setup loops that the
// reference implements in C++ inside deal.II (rtree point location,
// FEValues tabulation, sparsity assembly).  A copy of the JAX package's
// native/fdal_setup.cpp, so that the port depends on no file outside its
// package.  Exposed through a plain C ABI for ctypes.
//
// Build: fictitious_domain_al_preconditioners_torch/native.py compiles it
// with g++ -O3 -march=native -fPIC -shared -std=c++17 at first use, into
// build/torch_native/libfdal_setup_<source hash>.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Locate points in a uniform grid: cell = floor((x - origin)/h) clipped,
// ref = local coordinate in [0,1]^dim.  Lexicographic cell index, first
// coordinate fastest (matches core/grid.py).
void fdal_locate_points(const double* points, int64_t n, int dim,
                        const double* origin, const double* h,
                        const int64_t* ncells, int64_t* cell_out,
                        double* ref_out) {
  std::vector<int64_t> strides(dim);
  strides[0] = 1;
  for (int d = 1; d < dim; ++d) strides[d] = strides[d - 1] * ncells[d - 1];
  for (int64_t i = 0; i < n; ++i) {
    int64_t cell = 0;
    for (int d = 0; d < dim; ++d) {
      double rel = (points[i * dim + d] - origin[d]) / h[d];
      int64_t c = (int64_t)std::floor(rel);
      if (c < 0) c = 0;
      if (c >= ncells[d]) c = ncells[d] - 1;
      ref_out[i * dim + d] = rel - (double)c;
      cell += c * strides[d];
    }
    cell_out[i] = cell;
  }
}

// 1D Lagrange basis values at x for the given nodes (n_nodes), direct
// product formula.
static void lagrange_1d(const double* nodes, int n_nodes, double x,
                        double* out) {
  for (int j = 0; j < n_nodes; ++j) {
    double v = 1.0;
    for (int m = 0; m < n_nodes; ++m)
      if (m != j) v *= (x - nodes[m]) / (nodes[j] - nodes[m]);
    out[j] = v;
  }
}

// Tensor-product Lagrange tabulation: values of all (n_nodes)^dim basis
// functions (first coordinate fastest) at n reference points.
void fdal_tabulate(const double* points, int64_t n, int dim,
                   const double* nodes, int n_nodes, double* out) {
  int nloc = 1;
  for (int d = 0; d < dim; ++d) nloc *= n_nodes;
  std::vector<double> v1(dim * n_nodes);
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < dim; ++d)
      lagrange_1d(nodes, n_nodes, points[i * dim + d], &v1[d * n_nodes]);
    for (int a = 0; a < nloc; ++a) {
      int idx = a;
      double val = 1.0;
      for (int d = 0; d < dim; ++d) {
        val *= v1[d * n_nodes + (idx % n_nodes)];
        idx /= n_nodes;
      }
      out[i * nloc + a] = val;
    }
  }
}

// Sort COO triplets by (row, col) and sum duplicates in place.
// Returns the deduplicated length.
int64_t fdal_coo_dedup(int64_t* rows, int64_t* cols, double* vals, int64_t nnz,
                       int64_t ncols) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    int64_t ka = rows[a] * ncols + cols[a];
    int64_t kb = rows[b] * ncols + cols[b];
    return ka < kb;
  });
  std::vector<int64_t> r(nnz), c(nnz);
  std::vector<double> v(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    r[i] = rows[order[i]];
    c[i] = cols[order[i]];
    v[i] = vals[order[i]];
  }
  int64_t out = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    if (out >= 0 && r[i] == rows[out] && c[i] == cols[out]) {
      vals[out] += v[i];
    } else {
      ++out;
      rows[out] = r[i];
      cols[out] = c[i];
      vals[out] = v[i];
    }
  }
  return out + 1;
}

// Dense compact-AL accumulation: A[idx[q,a], idx[q,b]] += phi[q,a]*phi[q,b]*w[q]
// over nq quad points with nloc local dofs (replaces numpy add.at, which is
// orders of magnitude slower for this access pattern).
void fdal_accumulate_al(const int64_t* idx, const double* phi, const double* w,
                        int64_t nq, int nloc, int64_t m, double* A) {
  for (int64_t q = 0; q < nq; ++q) {
    const double wq = w[q];
    const double* ph = phi + q * nloc;
    const int64_t* ix = idx + q * nloc;
    for (int a = 0; a < nloc; ++a) {
      const double pa = ph[a] * wq;
      double* row = A + ix[a] * m;
      for (int b = 0; b < nloc; ++b) row[ix[b]] += pa * ph[b];
    }
  }
}

}  // extern "C"
