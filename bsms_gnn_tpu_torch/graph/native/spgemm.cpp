// Boolean-semiring CSR SpGEMM (the pattern of C = A*A) for the bi-stride
// adjacency squaring, plus a CSR BFS (counterpart of
// bsms_gnn_tpu/graph/native/spgemm.cpp, the same functions and interface).
//
// Gustavson's algorithm with a dense last-seen marker per row: O(flops)
// time, O(n) scratch. Two passes (a symbolic count, then the fill) so the
// Python caller owns every allocation and the ctypes boundary stays plain.
//
// Built at first use by __init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC -o build/libbsms_graph.so spgemm.cpp

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// Symbolic pass: out_counts[i] = nnz of row i of A*A (diagonal dropped when
// drop_diag != 0). Returns total nnz.
int64_t spgemm_bool_sq_count(int64_t n, const int64_t* indptr,
                             const int64_t* indices, int drop_diag,
                             int64_t* out_counts) {
  std::vector<int64_t> marker(n, -1);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t count = 0;
    for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
      int64_t j = indices[jj];
      for (int64_t kk = indptr[j]; kk < indptr[j + 1]; ++kk) {
        int64_t k = indices[kk];
        if (drop_diag && k == i) continue;
        if (marker[k] != i) {
          marker[k] = i;
          ++count;
        }
      }
    }
    out_counts[i] = count;
    total += count;
  }
  return total;
}

// Numeric (pattern) pass: fill out_indices given out_indptr from the counts.
// Column indices within each row come out sorted.
void spgemm_bool_sq_fill(int64_t n, const int64_t* indptr,
                         const int64_t* indices, int drop_diag,
                         const int64_t* out_indptr, int64_t* out_indices) {
  std::vector<int64_t> marker(n, -1);
  std::vector<int64_t> row;
  row.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    row.clear();
    for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
      int64_t j = indices[jj];
      for (int64_t kk = indptr[j]; kk < indptr[j + 1]; ++kk) {
        int64_t k = indices[kk];
        if (drop_diag && k == i) continue;
        if (marker[k] != i) {
          marker[k] = i;
          row.push_back(k);
        }
      }
    }
    // Insertion of sorted output keeps downstream edge lists deterministic.
    std::sort(row.begin(), row.end());
    int64_t base = out_indptr[i];
    for (size_t t = 0; t < row.size(); ++t) out_indices[base + t] = row[t];
  }
}

// CSR BFS from `seed`; writes hop distance into dist (must be pre-filled
// with -1). Used for large-mesh precompute where even vectorized NumPy BFS
// is noticeable.
void csr_bfs(int64_t n, const int64_t* indptr, const int64_t* indices,
             int64_t seed, int64_t* dist) {
  std::queue<int64_t> q;
  dist[seed] = 0;
  q.push(seed);
  while (!q.empty()) {
    int64_t u = q.front();
    q.pop();
    int64_t d = dist[u] + 1;
    for (int64_t jj = indptr[u]; jj < indptr[u + 1]; ++jj) {
      int64_t v = indices[jj];
      if (dist[v] < 0) {
        dist[v] = d;
        q.push(v);
      }
    }
  }
}

}  // extern "C"
