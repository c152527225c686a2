// Native host-side mesh preprocessing kernels.
//
// Counterpart of the reference's C++ remap construction
// (MeshShapeMatTrans / MeshForceOutputTrans constructors,
// fea/mesh_template.h:19-161, and the SparseLinearDescCompressed
// storage).  The device compute path is JAX/XLA; this module covers the
// topology -> padded-index-array preprocessing that would otherwise be
// Python loops over every tetrahedron.  Plain C ABI, loaded via ctypes;
// sanm_tpu falls back to the pure-Python builders when the shared
// object is unavailable.
//
// Conventions: vertices (V,3) float64 row-major; tets (T,4) int32;
// fixed mask (V,3) uint8 (1 = fixed).  Unknown numbering is row-major
// over free (vertex, coord) pairs, matching fea/remap.py.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Number the unknowns: vtx2uidx[v*3+c] = unknown index or -1 (fixed).
// Returns the number of unknowns.
int64_t number_unknowns(int64_t V, const uint8_t* fixed, int32_t* vtx2uidx,
                        int32_t* vertex_loc /* (n,2) out */) {
    int64_t u = 0;
    for (int64_t v = 0; v < V; ++v) {
        for (int c = 0; c < 3; ++c) {
            if (fixed[v * 3 + c]) {
                vtx2uidx[v * 3 + c] = -1;
            } else {
                vtx2uidx[v * 3 + c] = (int32_t)u;
                vertex_loc[u * 2] = (int32_t)v;
                vertex_loc[u * 2 + 1] = c;
                ++u;
            }
        }
    }
    return u;
}

// Shape-matrix remap: for each tet e, Ds[r, m-1] = x[v_m][r] - x[v_0][r].
// Row layout: out position e*9 + r*3 + (m-1); width 3 (v0 entry, vm
// entry, optional t-column entry).  Writes padded idx/coef (rows x 3)
// and the fixed-coordinate bias (T*9).
void build_shape_remap(int64_t T, int64_t V, const int32_t* tets,
                       const int32_t* vtx2uidx, const double* init,
                       const double* delta /* nullable */,
                       int64_t n_unknown, int32_t* idx, double* coef,
                       double* bias) {
    const int64_t W = 3;
    std::memset(idx, 0, sizeof(int32_t) * T * 9 * W);
    std::memset(coef, 0, sizeof(double) * T * 9 * W);
    std::memset(bias, 0, sizeof(double) * T * 9);
    for (int64_t e = 0; e < T; ++e) {
        int32_t v0 = tets[e * 4];
        for (int m = 1; m <= 3; ++m) {
            int32_t vm = tets[e * 4 + m];
            for (int r = 0; r < 3; ++r) {
                int64_t row = e * 9 + (int64_t)r * 3 + (m - 1);
                int w = 0;
                int32_t u0 = vtx2uidx[(int64_t)v0 * 3 + r];
                if (u0 < 0) {
                    bias[row] -= init[(int64_t)v0 * 3 + r];
                } else {
                    idx[row * W + w] = u0;
                    coef[row * W + w] = -1.0;
                    ++w;
                }
                int32_t um = vtx2uidx[(int64_t)vm * 3 + r];
                if (um < 0) {
                    bias[row] += init[(int64_t)vm * 3 + r];
                } else {
                    idx[row * W + w] = um;
                    coef[row * W + w] = 1.0;
                    ++w;
                }
                if (delta) {
                    double d = delta[(int64_t)vm * 3 + r] -
                               delta[(int64_t)v0 * 3 + r];
                    if (d != 0.0) {
                        idx[row * W + w] = (int32_t)n_unknown;
                        coef[row * W + w] = d;
                        ++w;
                    }
                }
            }
        }
    }
}

// Force-output remap, pass 1: per-unknown entry counts (3 per adjacent
// tet).  Returns the max count (padding width).
int64_t force_remap_count(int64_t T, int64_t n_unknown, const int32_t* tets,
                          const int32_t* vertex_loc, const int32_t* vtx_deg
                          /* per-vertex adjacency count (V,) */,
                          int64_t* counts /* (n,) out */) {
    int64_t maxw = 1;
    for (int64_t u = 0; u < n_unknown; ++u) {
        int32_t v = vertex_loc[u * 2];
        int64_t cnt = (int64_t)vtx_deg[v] * 3;
        counts[u] = cnt;
        if (cnt > maxw) maxw = cnt;
    }
    return maxw;
}

// Per-vertex adjacency (vertex -> (tet, corner) CSR), reference
// MeshVertexReverseList (fea/mesh.cpp:27-57).
void vertex_adjacency(int64_t T, int64_t V, const int32_t* tets,
                      int32_t* deg /* (V,) out */,
                      int32_t* adj_start /* (V+1,) out */,
                      int32_t* adj_tet /* (4T,) out */,
                      int32_t* adj_slot /* (4T,) out */) {
    std::memset(deg, 0, sizeof(int32_t) * V);
    for (int64_t e = 0; e < T; ++e)
        for (int s = 0; s < 4; ++s) deg[tets[e * 4 + s]]++;
    adj_start[0] = 0;
    for (int64_t v = 0; v < V; ++v) adj_start[v + 1] = adj_start[v] + deg[v];
    std::vector<int32_t> cur(adj_start, adj_start + V);
    for (int64_t e = 0; e < T; ++e) {
        for (int s = 0; s < 4; ++s) {
            int32_t v = tets[e * 4 + s];
            int32_t p = cur[v]++;
            adj_tet[p] = (int32_t)e;
            adj_slot[p] = s;
        }
    }
}

// Force-output remap, pass 2: fill padded rows.  norms: (T,4,3)
// per-corner normals.  Row u (unknown (v,c)): entries
// (tet*9 + c*3 + j, norms[tet, slot, j]) over adjacent (tet, slot).
void build_force_remap(int64_t n_unknown, int64_t W,
                       const int32_t* vertex_loc, const int32_t* adj_start,
                       const int32_t* adj_tet, const int32_t* adj_slot,
                       const double* norms, int32_t* idx, double* coef) {
    std::memset(idx, 0, sizeof(int32_t) * n_unknown * W);
    std::memset(coef, 0, sizeof(double) * n_unknown * W);
    for (int64_t u = 0; u < n_unknown; ++u) {
        int32_t v = vertex_loc[u * 2];
        int32_t c = vertex_loc[u * 2 + 1];
        int64_t w = 0;
        for (int32_t p = adj_start[v]; p < adj_start[v + 1]; ++p) {
            int64_t e = adj_tet[p];
            int s = adj_slot[p];
            for (int j = 0; j < 3; ++j) {
                idx[u * W + w] = (int32_t)(e * 9 + c * 3 + j);
                coef[u * W + w] = norms[(e * 4 + s) * 3 + j];
                ++w;
            }
        }
    }
}

// Transposed padding of a padded remap (assembly needs per-input-position
// rows).  Pass 1: counts + max width.
int64_t transpose_count(int64_t n_rows, int64_t W, const int32_t* idx,
                        const double* coef, int64_t inp_size,
                        int32_t* counts /* (inp_size,) out */) {
    std::memset(counts, 0, sizeof(int32_t) * inp_size);
    for (int64_t r = 0; r < n_rows; ++r)
        for (int64_t w = 0; w < W; ++w)
            if (coef[r * W + w] != 0.0) counts[idx[r * W + w]]++;
    int64_t maxw = 1;
    for (int64_t i = 0; i < inp_size; ++i)
        if (counts[i] > maxw) maxw = counts[i];
    return maxw;
}

// Pass 2: fill the transposed padded arrays.
void transpose_fill(int64_t n_rows, int64_t W, const int32_t* idx,
                    const double* coef, int64_t inp_size, int64_t TW,
                    int32_t* tidx, double* tcoef) {
    std::vector<int32_t> cur(inp_size, 0);
    std::memset(tidx, 0, sizeof(int32_t) * inp_size * TW);
    std::memset(tcoef, 0, sizeof(double) * inp_size * TW);
    for (int64_t r = 0; r < n_rows; ++r) {
        for (int64_t w = 0; w < W; ++w) {
            double c = coef[r * W + w];
            if (c == 0.0) continue;
            int32_t i = idx[r * W + w];
            int32_t p = cur[i]++;
            tidx[(int64_t)i * TW + p] = (int32_t)r;
            tcoef[(int64_t)i * TW + p] = c;
        }
    }
}

}  // extern "C"
