// Host-side graph kernels for cnn_graph_tpu.
//
// The accelerator does the filtering math; this library accelerates the host
// precompute whose reference implementation is pure-Python loops
// (SURVEY.md §2.2 — the reference has no native code at all; these are the
// framework's own hot host paths):
//
//   * graclus_one_level — randomized heavy-edge matching over a CSR graph
//     (the sequential inner loop of multilevel coarsening; Python-loop
//     equivalent in graphs/coarsening.py:graclus_pairing).  O(nnz) per
//     level but latency-bound in Python for multi-million-edge graphs.
//
// Built as a plain shared library; Python binds via ctypes
// (cnn_graph_tpu/native/__init__.py) with a NumPy fallback when no
// compiler is available.

#include <cstdint>
#include <cstring>

extern "C" {

// Greedy Graclus matching.  Inputs: CSR (indptr[n+1], indices[nnz],
// data[nnz]), visit order rid[n], pairing weights w[n].  Output:
// cluster[n].  Returns the number of clusters.
int64_t graclus_one_level(const int64_t* indptr, const int32_t* indices,
                          const double* data, const int64_t* rid,
                          const double* weights, int64_t n,
                          int32_t* cluster) {
    bool* matched = new bool[n]();
    int64_t n_clusters = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t tid = rid[i];
        if (matched[tid]) continue;
        matched[tid] = true;
        double best_gain = 0.0;
        int64_t best = -1;
        const double wt = 1.0 / weights[tid];
        for (int64_t e = indptr[tid]; e < indptr[tid + 1]; ++e) {
            const int32_t nid = indices[e];
            if (matched[nid]) continue;
            const double gain = data[e] * (wt + 1.0 / weights[nid]);
            if (gain > best_gain) {
                best_gain = gain;
                best = nid;
            }
        }
        cluster[tid] = static_cast<int32_t>(n_clusters);
        if (best >= 0) {
            cluster[best] = static_cast<int32_t>(n_clusters);
            matched[best] = true;
        }
        ++n_clusters;
    }
    delete[] matched;
    return n_clusters;
}

}  // extern "C"
