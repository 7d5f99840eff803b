// graphcore: the host-side graph preprocessing of bliss_gnn_tpu_torch in
// C++ (counting sorts and one pass over the CSC ranges, where numpy's
// argsort and np.add.at take 10-30x longer at Reddit's 115M edges).
// Bound through ctypes by bliss_gnn_tpu_torch/graph/native.py, which
// builds this file at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -o libgraphcore.so graphcore.cpp
// The numpy versions in graph/structure.py give the same arrays.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Counting-sort edges by dst: fills indptr[n_nodes+1], csc_src[E] and
// perm[E] (canonical position -> input edge index; stable within a dst).
void build_csc(int64_t n_nodes, int64_t n_edges, const int64_t* src,
               const int64_t* dst, int64_t* indptr, int64_t* csc_src,
               int64_t* perm) {
  std::memset(indptr, 0, sizeof(int64_t) * (n_nodes + 1));
  for (int64_t e = 0; e < n_edges; ++e) indptr[dst[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; ++i) indptr[i + 1] += indptr[i];
  std::vector<int64_t> cursor(indptr, indptr + n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t p = cursor[dst[e]]++;
    csc_src[p] = src[e];
    perm[p] = e;
  }
}

// CSR (grouped by src) from the canonical CSC, csr_eid mapping back to
// canonical edge ids; within a src the edges keep canonical (dst) order.
void build_csr_from_csc(int64_t n_nodes, int64_t n_edges,
                        const int64_t* csc_indptr, const int64_t* csc_src,
                        int64_t* csr_indptr, int64_t* csr_dst,
                        int64_t* csr_eid) {
  std::memset(csr_indptr, 0, sizeof(int64_t) * (n_nodes + 1));
  for (int64_t e = 0; e < n_edges; ++e) csr_indptr[csc_src[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; ++i) csr_indptr[i + 1] += csr_indptr[i];
  std::vector<int64_t> cursor(csr_indptr, csr_indptr + n_nodes);
  int64_t d = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    while (e >= csc_indptr[d + 1]) ++d;
    int64_t p = cursor[csc_src[e]]++;
    csr_dst[p] = d;
    csr_eid[p] = e;
  }
}

// Per-dst normalised edge weights w_e / sum of w over dst(e)'s in-edges
// (1 / in-degree when weights is null), the sums in double.
void normalized_edata_c(int64_t n_nodes, int64_t n_edges,
                        const int64_t* csc_indptr, const float* weights,
                        float* out) {
  (void)n_edges;
  for (int64_t d = 0; d < n_nodes; ++d) {
    double s = 0;
    for (int64_t e = csc_indptr[d]; e < csc_indptr[d + 1]; ++e)
      s += weights ? weights[e] : 1.0;
    for (int64_t e = csc_indptr[d]; e < csc_indptr[d + 1]; ++e)
      out[e] = s > 0 ? (float)((weights ? weights[e] : 1.0) / s) : 0.0f;
  }
}

}  // extern "C"
