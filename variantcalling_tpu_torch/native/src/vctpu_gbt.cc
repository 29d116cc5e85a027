// Histogram gradient-boosted trees: the native CPU trainer and the quantile binning.
//
// A copy of the JAX package's native/src/vctpu_gbt.cc, trimmed to the two
// entry points the fit of the port needs (vctpu_bin_features and
// vctpu_gbt_fit; the forest walk and matrix builders are left out). It is
// the CPU half of models/boosting.fit, exactly as in the reference: with
// host inputs on the CPU and VCTPU_NATIVE_GBT on, the fit runs here
// (samples kept partitioned by node so each node's rows are contiguous,
// the smaller child's histogram built and the sibling's derived by
// subtraction, float32 sums); the card never takes it. Outputs:
// feats/bins (T, D, 2^D) int32 with -1 = dead node, leaves (T, 2^D)
// float32, which models/boosting._to_flat_forest consumes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "vctpu_threads.h"

extern "C" {

// Quantile binning: out[i,j] = searchsorted(edges[j], x[i,j], side='left'),
// NaN routed to the last bin (numpy's sort order puts NaN above all
// floats) — must match models/boosting.bin_features and the numpy host
// binning exactly, or trained splits shift by one bin.
int64_t vctpu_bin_features(
    const float* x,        // (n, f) row-major
    int64_t n, int32_t f,
    const float* edges,    // (f, n_edges) row-major, non-decreasing rows
    int32_t n_edges,
    uint8_t* out)          // (n, f)
{
    if (n < 0 || f <= 0 || n_edges <= 0 || n_edges > 255) return -1;
    vctpu::for_shards(n, vctpu::nthreads(), [&](int, int64_t r_lo, int64_t r_hi) {
        for (int64_t i = r_lo; i < r_hi; ++i) {
            const float* row = x + (size_t)i * f;
            uint8_t* orow = out + (size_t)i * f;
            for (int32_t j = 0; j < f; ++j) {
                const float v = row[j];
                const float* e = edges + (size_t)j * n_edges;
                if (std::isnan(v)) {
                    orow[j] = (uint8_t)n_edges;
                    continue;
                }
                // branch-light binary search: first index with e[idx] >= v
                int32_t lo = 0, hi = n_edges;
                while (lo < hi) {
                    const int32_t mid = (lo + hi) >> 1;
                    if (e[mid] < v) lo = mid + 1; else hi = mid;
                }
                orow[j] = (uint8_t)lo;
            }
        }
    });
    return 0;
}

// returns 0 on success, <0 on bad arguments.
int64_t vctpu_gbt_fit(
    const uint8_t* binned,   // (n, f) row-major bin ids in [0, b)
    const float* y,          // (n,) labels in {0, 1}
    const float* w,          // (n,) sample weights, or nullptr for all-1
    int64_t n, int32_t f, int32_t b,
    int32_t n_trees, int32_t depth,
    float learning_rate, float reg_lambda, float min_child_weight,
    float base_score,
    int32_t* out_feats,      // (n_trees, depth, 1<<depth)
    int32_t* out_bins,       // (n_trees, depth, 1<<depth)
    float* out_leaves)       // (n_trees, 1<<depth)
{
    if (n <= 0 || f <= 0 || b <= 1 || n_trees <= 0 || depth <= 0 || depth > 16)
        return -1;
    const int32_t leaves = 1 << depth;
    const int64_t fb = (int64_t)f * b;      // histogram cells per node
    const int64_t hs = 2 * fb;              // floats per node hist (g,h pairs)

    std::vector<float> margin((size_t)n, base_score);
    std::vector<float> g((size_t)n), h((size_t)n);
    std::vector<int64_t> idx((size_t)n), scratch((size_t)n);
    // node sample ranges for the current level: node k holds
    // idx[bounds[k] .. bounds[k+1])
    std::vector<int64_t> bounds, next_bounds;
    // per-level histograms, double-buffered parent/child
    std::vector<float> hist_a((size_t)leaves * hs), hist_b((size_t)leaves * hs);
    std::vector<int32_t> feat_lvl(leaves), bin_lvl(leaves);

    for (int32_t t = 0; t < n_trees; ++t) {
        // gradients/hessians of the logistic loss at the current margin
        for (int64_t i = 0; i < n; ++i) {
            float p = 1.0f / (1.0f + std::exp(-margin[i]));
            float wi = w ? w[i] : 1.0f;
            g[i] = wi * (p - y[i]);
            float hi = wi * p * (1.0f - p);
            h[i] = hi > 1e-12f ? hi : 1e-12f;
        }
        for (int64_t i = 0; i < n; ++i) idx[i] = i;
        bounds.assign({0, n});

        float* prev = hist_a.data();
        float* cur = hist_b.data();
        int32_t* tf = out_feats + (size_t)t * depth * leaves;
        int32_t* tb = out_bins + (size_t)t * depth * leaves;

        for (int32_t level = 0; level < depth; ++level) {
            const int32_t n_nodes = 1 << level;

            // ---- histograms for every node of this level -------------
            if (level == 0) {
                std::memset(cur, 0, (size_t)hs * sizeof(float));
                float* hcur = cur;
                for (int64_t i = 0; i < n; ++i) {
                    const uint8_t* row = binned + (size_t)i * f;
                    const float gi = g[i], hi = h[i];
                    for (int32_t j = 0; j < f; ++j) {
                        float* cell = hcur + 2 * ((int64_t)j * b + row[j]);
                        cell[0] += gi;
                        cell[1] += hi;
                    }
                }
            } else {
                // children of parent k sit at 2k (left) and 2k+1 (right);
                // build the smaller child by iteration, derive the
                // sibling as parent - child
                for (int32_t k = 0; k < n_nodes / 2; ++k) {
                    const int64_t s = bounds[2 * k], m = bounds[2 * k + 1],
                                  e = bounds[2 * k + 2];
                    const bool left_small = (m - s) <= (e - m);
                    const int32_t small_node = 2 * k + (left_small ? 0 : 1);
                    const int64_t ss = left_small ? s : m,
                                  se = left_small ? m : e;
                    float* hsmall = cur + (size_t)small_node * hs;
                    std::memset(hsmall, 0, (size_t)hs * sizeof(float));
                    for (int64_t r = ss; r < se; ++r) {
                        const int64_t i = idx[r];
                        const uint8_t* row = binned + (size_t)i * f;
                        const float gi = g[i], hi = h[i];
                        for (int32_t j = 0; j < f; ++j) {
                            float* cell = hsmall + 2 * ((int64_t)j * b + row[j]);
                            cell[0] += gi;
                            cell[1] += hi;
                        }
                    }
                    const float* hpar = prev + (size_t)k * hs;
                    float* hbig = cur + (size_t)(2 * k + (left_small ? 1 : 0)) * hs;
                    for (int64_t c = 0; c < hs; ++c)
                        hbig[c] = hpar[c] - hsmall[c];
                }
            }

            // ---- split search (same gain formula / tie-break order as
            // the jitted trainer: flat argmax over feature-major bins) --
            for (int32_t k = 0; k < n_nodes; ++k) {
                const float* hist = cur + (size_t)k * hs;
                float best_gain = 0.0f;  // dead unless strictly positive
                int32_t best_f = -1, best_b = 0;
                for (int32_t j = 0; j < f; ++j) {
                    const float* hf = hist + 2 * (int64_t)j * b;
                    float gt = 0.0f, ht = 0.0f;
                    for (int32_t c = 0; c < b; ++c) {
                        gt += hf[2 * c];
                        ht += hf[2 * c + 1];
                    }
                    const float parent = gt * gt / (ht + reg_lambda);
                    float gl = 0.0f, hl = 0.0f;
                    for (int32_t c = 0; c < b - 1; ++c) {  // last bin = no split
                        gl += hf[2 * c];
                        hl += hf[2 * c + 1];
                        const float gr = gt - gl, hr = ht - hl;
                        if (hl < min_child_weight || hr < min_child_weight)
                            continue;
                        const float gain = gl * gl / (hl + reg_lambda) +
                                           gr * gr / (hr + reg_lambda) - parent;
                        if (gain > best_gain) {  // strict: first max wins
                            best_gain = gain;
                            best_f = j;
                            best_b = c;
                        }
                    }
                }
                feat_lvl[k] = best_f;
                bin_lvl[k] = best_f >= 0 ? best_b : 0;
                tf[(size_t)level * leaves + k] = best_f;
                tb[(size_t)level * leaves + k] = bin_lvl[k];
            }
            for (int32_t k = n_nodes; k < leaves; ++k) {  // padding lanes
                tf[(size_t)level * leaves + k] = -1;
                tb[(size_t)level * leaves + k] = 0;
            }

            // ---- stable partition of every node's range --------------
            next_bounds.assign((size_t)(2 * n_nodes + 1), 0);
            for (int32_t k = 0; k < n_nodes; ++k) {
                const int64_t s = bounds[k], e = bounds[k + 1];
                const int32_t jf = feat_lvl[k];
                int64_t nl = 0;
                if (jf < 0) {
                    nl = e - s;  // dead: everything routes left
                } else {
                    const uint8_t cut = (uint8_t)bin_lvl[k];
                    int64_t lpos = s, rpos = 0;
                    for (int64_t r = s; r < e; ++r) {
                        const int64_t i = idx[r];
                        if (binned[(size_t)i * f + jf] > cut)
                            scratch[rpos++] = i;
                        else
                            idx[lpos++] = i;
                    }
                    std::memcpy(&idx[lpos], scratch.data(),
                                (size_t)rpos * sizeof(int64_t));
                    nl = lpos - s;
                }
                next_bounds[2 * k + 1] = s + nl;
                next_bounds[2 * k + 2] = e;
            }
            next_bounds[0] = 0;
            bounds.swap(next_bounds);
            std::swap(prev, cur);
        }

        // ---- leaf values + margin update -----------------------------
        float* tl = out_leaves + (size_t)t * leaves;
        for (int32_t k = 0; k < leaves; ++k) {
            const int64_t s = bounds[k], e = bounds[k + 1];
            float lg = 0.0f, lh = 0.0f;
            for (int64_t r = s; r < e; ++r) {
                lg += g[idx[r]];
                lh += h[idx[r]];
            }
            const float leaf = -learning_rate * lg / (lh + reg_lambda);
            tl[k] = leaf;
            for (int64_t r = s; r < e; ++r) margin[idx[r]] += leaf;
        }
    }
    return 0;
}

}  // extern "C"
