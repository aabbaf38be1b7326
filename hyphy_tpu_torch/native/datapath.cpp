// Host data-path kernels of the PyTorch port: pairwise TN93 distance
// estimation and alignment site-pattern compression.  A copy of the JAX
// package's hyphy_tpu/native/datapath.cpp; counterpart of the reference's
// C++ data layer (src/core/dataset_filter.cpp pattern dedup; distance
// estimation used by tree.infer.NJ for GARD's per-partition trees).
//
// A plain C ABI loaded with ctypes (hyphy_tpu_torch/native/__init__.py).
// Built with g++ by hyphy_tpu_torch/ops/cuda_build.py into
// build/hyphy_tpu_torch/; the NumPy mirrors (gard.tn93_distance with
// use_native=False, np.unique) are the plain versions the tests hold it to.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Pairwise TN93 distances.
//   states: [taxa * sites] int8, 0..3 = A,C,G,T; negative = unresolved
//   out:    [taxa * taxa] double (symmetric, zero diagonal)
// Saturated / undefined pairs get `saturation` (reference behavior:
// clamp to a large distance).
void tn93_distances(const int8_t* states, int64_t taxa, int64_t sites,
                    double saturation, double* out) {
    for (int64_t i = 0; i < taxa; ++i) {
        out[i * taxa + i] = 0.0;
        const int8_t* si = states + i * sites;
        for (int64_t j = i + 1; j < taxa; ++j) {
            const int8_t* sj = states + j * sites;
            int64_t tot = 0;
            int64_t counts[4] = {0, 0, 0, 0};
            int64_t p1 = 0, p2 = 0, q = 0;
            for (int64_t s = 0; s < sites; ++s) {
                int a = si[s], b = sj[s];
                if (a < 0 || b < 0) continue;
                ++tot;
                ++counts[a];
                ++counts[b];
                if (a == b) continue;
                bool pur_a = (a == 0) | (a == 2);
                bool pur_b = (b == 0) | (b == 2);
                if (pur_a && pur_b) ++p1;           // A<->G
                else if (!pur_a && !pur_b) ++p2;    // C<->T
                else ++q;                           // transversion
            }
            double d;
            if (tot == 0) {
                d = saturation;
            } else {
                double n2 = 2.0 * (double)tot;
                double pa = counts[0] / n2, pc = counts[1] / n2;
                double pg = counts[2] / n2, pt = counts[3] / n2;
                double gr = pa + pg, gy = pc + pt;
                double fp1 = (double)p1 / tot, fp2 = (double)p2 / tot;
                double fq = (double)q / tot;
                double k1 = 2.0 * pa * pg / (gr > 1e-12 ? gr : 1e-12);
                double k2 = 2.0 * pc * pt / (gy > 1e-12 ? gy : 1e-12);
                double k3 = 2.0 * (gr * gy
                                   - pa * pg * gy / (gr > 1e-12 ? gr : 1e-12)
                                   - pc * pt * gr / (gy > 1e-12 ? gy : 1e-12));
                double w1 = 1.0 - fp1 / (k1 > 1e-12 ? k1 : 1e-12)
                            - fq / (2.0 * gr > 1e-12 ? 2.0 * gr : 1e-12);
                double w2 = 1.0 - fp2 / (k2 > 1e-12 ? k2 : 1e-12)
                            - fq / (2.0 * gy > 1e-12 ? 2.0 * gy : 1e-12);
                double w3 = 1.0 - fq / (2.0 * gr * gy > 1e-12 ? 2.0 * gr * gy : 1e-12);
                if (w1 <= 0.0 || w2 <= 0.0 || w3 <= 0.0) {
                    d = saturation;
                } else {
                    d = -(k1 * std::log(w1) + k2 * std::log(w2) + k3 * std::log(w3));
                    if (!(d >= 0.0) || !std::isfinite(d)) d = saturation;
                }
            }
            out[i * taxa + j] = d;
            out[j * taxa + i] = d;
        }
    }
}

// Site-pattern compression (reference: _DataSetFilter::SetFilter,
// src/core/dataset_filter.cpp — duplicateMap/theFrequencies).
//   codes: [taxa * sites] int32 per-column character codes
//   pattern_index out: [sites]  (site -> pattern id)
//   first_site    out: [sites]  (pattern id -> representative site; only
//                                the first n_patterns entries are valid)
// Returns the number of distinct patterns.
int64_t compress_patterns(const int32_t* codes, int64_t taxa, int64_t sites,
                          int32_t* pattern_index, int32_t* first_site) {
    struct ColHash {
        const int32_t* codes; int64_t taxa; int64_t sites;
        size_t operator()(int64_t col) const {
            size_t h = 1469598103934665603ull;
            for (int64_t t = 0; t < taxa; ++t) {
                h ^= (size_t)codes[t * sites + col];
                h *= 1099511628211ull;
            }
            return h;
        }
    };
    struct ColEq {
        const int32_t* codes; int64_t taxa; int64_t sites;
        bool operator()(int64_t a, int64_t b) const {
            for (int64_t t = 0; t < taxa; ++t)
                if (codes[t * sites + a] != codes[t * sites + b]) return false;
            return true;
        }
    };
    ColHash hasher{codes, taxa, sites};
    ColEq eq{codes, taxa, sites};
    std::unordered_map<int64_t, int32_t, ColHash, ColEq> seen(
        (size_t)sites * 2, hasher, eq);
    int32_t n_patterns = 0;
    for (int64_t s = 0; s < sites; ++s) {
        auto it = seen.find(s);
        if (it == seen.end()) {
            seen.emplace(s, n_patterns);
            first_site[n_patterns] = (int32_t)s;
            pattern_index[s] = n_patterns;
            ++n_patterns;
        } else {
            pattern_index[s] = it->second;
        }
    }
    return n_patterns;
}

}  // extern "C"
