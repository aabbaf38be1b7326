// Host pairwise sequence alignment kernels of the PyTorch port.  A copy of
// the JAX package's hyphy_tpu/native/align.cpp.
//
// Counterpart of the reference's aligner (src/core/alignment.cpp): the HBL
// `AlignSequences` command does affine-gap dynamic programming in
// nucleotide/protein space or in codon space, where the reference strand
// moves in whole codons (3 nt) and the query strand may consume 1..5 nt per
// step, paying a per-nucleotide "miscall" (frameshift) penalty for steps
// that are out of frame (CodonAlignStringsStep, alignment.cpp:151; the
// 3x5/3x4/3x2/3x1 partial-codon scoring tables, alignment.cpp:225-470).
// This implementation scores partial codons on the fly as the best
// completion of the ref codon against the query nucleotides, charging
// |step-3| miscalls — the same move set and penalty structure without the
// reference's precomputed tables.
//
// A plain C ABI loaded with ctypes (hyphy_tpu_torch/align.py), built with
// g++ by hyphy_tpu_torch/ops/cuda_build.py into build/hyphy_tpu_torch/; the
// pure-Python mirror of the same recurrences (use_native=False) is the
// plain version the tests hold it to.  Irregular, sequential DP: it stays on
// the host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const double NEG_INF = -1e300;

inline double cell_max3(double a, double b, double c) {
    return std::max(a, std::max(b, c));
}

}  // namespace

extern "C" {

// Affine-gap Gotoh alignment over an arbitrary alphabet.
//   a, b:    int32 symbol codes (negative = treat as mismatch vs everything)
//   score:   [n_symbols * n_symbols] double substitution scores
//   open/extend: gap penalties (>= 0; subtracted)
//   local:   1 = Smith-Waterman, 0 = Needleman-Wunsch
// Outputs: path_a/path_b int32 arrays of length *path_len (caller allocates
// la+lb each); entries are symbol indices into a/b or -1 for a gap.
// Returns the alignment score.
double gotoh_align(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   const double* score, int64_t n_symbols,
                   double gap_open, double gap_extend,
                   int32_t local,
                   int32_t* path_a, int32_t* path_b, int64_t* path_len) {
    const int64_t w = lb + 1;
    std::vector<double> M((la + 1) * w, NEG_INF), X((la + 1) * w, NEG_INF),
        Y((la + 1) * w, NEG_INF);
    // traceback: 2 bits per matrix
    std::vector<uint8_t> tb((la + 1) * w, 0);
    M[0] = 0.0;
    for (int64_t j = 1; j <= lb; ++j) {
        Y[j] = -gap_open - (j - 1) * gap_extend;
        if (local) Y[j] = std::max(Y[j], 0.0);
        if (j > 1) tb[j] |= 2;  // boundary row: Y-extension chain
    }
    for (int64_t i = 1; i <= la; ++i) {
        X[i * w] = -gap_open - (i - 1) * gap_extend;
        if (local) X[i * w] = std::max(X[i * w], 0.0);
        if (i > 1) tb[i * w] |= 1;  // boundary column: X-extension chain
    }
    double best = 0.0;
    int64_t bi = 0, bj = 0;
    for (int64_t i = 1; i <= la; ++i) {
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t c = i * w + j, up = (i - 1) * w + j,
                          left = i * w + j - 1, diag = (i - 1) * w + j - 1;
            double s = (a[i - 1] >= 0 && b[j - 1] >= 0)
                           ? score[a[i - 1] * n_symbols + b[j - 1]]
                           : -gap_open;
            double m = cell_max3(M[diag], X[diag], Y[diag]) + s;
            if (local && m < 0.0) m = 0.0;
            M[c] = m;
            // X: gap in b (consume a)
            double xo = cell_max3(M[up], Y[up], NEG_INF) - gap_open;
            double xe = X[up] - gap_extend;
            X[c] = std::max(xo, xe);
            tb[c] |= (xe > xo) ? 1 : 0;
            // Y: gap in a (consume b)
            double yo = cell_max3(M[left], X[left], NEG_INF) - gap_open;
            double ye = Y[left] - gap_extend;
            Y[c] = std::max(yo, ye);
            tb[c] |= (ye > yo) ? 2 : 0;
            if (local) {
                double cb = cell_max3(M[c], X[c], Y[c]);
                if (cb > best) { best = cb; bi = i; bj = j; }
            }
        }
    }
    int64_t i = la, j = lb;
    if (local) { i = bi; j = bj; }
    double final_score;
    int state;  // 0=M, 1=X, 2=Y
    {
        const int64_t c = i * w + j;
        double m = M[c], x = X[c], y = Y[c];
        if (m >= x && m >= y) { final_score = m; state = 0; }
        else if (x >= y) { final_score = x; state = 1; }
        else { final_score = y; state = 2; }
    }
    std::vector<int32_t> ra, rb;
    while (i > 0 || j > 0) {
        const int64_t c = i * w + j;
        if (local && cell_max3(M[c], X[c], Y[c]) <= 0.0 &&
            (state == 0 ? M[c] : state == 1 ? X[c] : Y[c]) <= 0.0)
            break;
        if (state == 0) {
            if (i == 0 || j == 0) break;
            ra.push_back((int32_t)(i - 1));
            rb.push_back((int32_t)(j - 1));
            const int64_t diag = (i - 1) * w + j - 1;
            double m = M[diag], x = X[diag], y = Y[diag];
            state = (m >= x && m >= y) ? 0 : (x >= y ? 1 : 2);
            --i; --j;
        } else if (state == 1) {
            if (i == 0) break;
            ra.push_back((int32_t)(i - 1));
            rb.push_back(-1);
            bool ext = tb[c] & 1;
            --i;
            state = ext ? 1 : 0;
            if (!ext) {
                const int64_t p = i * w + j;
                state = (M[p] >= Y[p]) ? 0 : 2;
            }
        } else {
            if (j == 0) break;
            ra.push_back(-1);
            rb.push_back((int32_t)(j - 1));
            bool ext = tb[c] & 2;
            --j;
            state = ext ? 2 : 0;
            if (!ext) {
                const int64_t p = i * w + j;
                state = (M[p] >= X[p]) ? 0 : 1;
            }
        }
    }
    *path_len = (int64_t)ra.size();
    for (size_t k = 0; k < ra.size(); ++k) {
        path_a[k] = ra[ra.size() - 1 - k];
        path_b[k] = rb[ra.size() - 1 - k];
    }
    return final_score;
}

// Codon-aware alignment: `ref` moves in whole codons, `qry` consumes
// 1..5 nt per match step (|k-3| miscalls each) or whole-codon affine gaps.
//   ref, qry:     int32 nucleotide codes 0..3 (negative = N)
//   codon_score:  [64 * 64] double, row = ref codon, col = query codon
//   miscall:      per-nucleotide frameshift penalty (>= 0)
// Outputs: aligned nucleotide index paths as in gotoh_align (entries index
// into ref/qry, -1 = gap).  Returns the score.
double codon_align(const int32_t* ref, int64_t lr, const int32_t* qry, int64_t lq,
                   const double* codon_score,
                   double gap_open, double gap_extend,
                   double gap_open_q, double gap_extend_q,
                   double miscall,
                   int32_t* path_r, int32_t* path_q, int64_t* path_len) {
    const int64_t nr = lr / 3;              // whole ref codons
    const int64_t w = lq + 1;
    const int64_t cells = (nr + 1) * w;
    std::vector<double> M(cells, NEG_INF), X(cells, NEG_INF), Y(cells, NEG_INF);
    // move[c]: for M cells, the query step size (1..5); 0 = none
    std::vector<int8_t> move(cells, 0), xext(cells, 0), yext(cells, 0);
    M[0] = 0.0;
    for (int64_t j = 1; j <= lq; ++j) {
        Y[j] = -gap_open_q - (double)(j - 1) * gap_extend_q;
        if (j > 1) yext[j] = 1;  // boundary row: extension chain
    }
    for (int64_t i = 1; i <= nr; ++i) {
        X[i * w] = -gap_open - (double)(i - 1) * gap_extend;
        if (i > 1) xext[i * w] = 1;
    }

    // best codon-vs-query-window score: the ref codon against the best
    // subset of k query nucleotides arranged into a codon (k<3: missing
    // positions take the best completion; k>3: extra query nts skipped).
    auto step_score = [&](int64_t codon_row, const int32_t* q, int k) {
        const double* row = codon_score + codon_row * 64;
        double best_s = NEG_INF;
        if (k == 3) {
            if (q[0] < 0 || q[1] < 0 || q[2] < 0) return 0.0;  // N: neutral
            return row[q[0] * 16 + q[1] * 4 + q[2]];
        }
        if (k > 3) {
            // choose which 3 of k query nts form the codon (in order)
            for (int a = 0; a < k - 2; ++a)
                for (int b = a + 1; b < k - 1; ++b)
                    for (int c = b + 1; c < k; ++c) {
                        if (q[a] < 0 || q[b] < 0 || q[c] < 0) continue;
                        double s = row[q[a] * 16 + q[b] * 4 + q[c]];
                        if (s > best_s) best_s = s;
                    }
        } else {
            // k (1 or 2) query nts occupy k codon positions; maximize over
            // placements and completions
            for (int64_t cod = 0; cod < 64; ++cod) {
                int digs[3] = {(int)(cod >> 4), (int)((cod >> 2) & 3),
                               (int)(cod & 3)};
                // query nts must appear in order as a subsequence of digs
                bool ok = false;
                if (k == 1) {
                    ok = (q[0] < 0) || digs[0] == q[0] || digs[1] == q[0] ||
                         digs[2] == q[0];
                } else {
                    ok = (q[0] < 0 || q[1] < 0) ||
                         (digs[0] == q[0] && (digs[1] == q[1] || digs[2] == q[1])) ||
                         (digs[1] == q[0] && digs[2] == q[1]);
                }
                if (ok && row[cod] > best_s) best_s = row[cod];
            }
        }
        return best_s <= NEG_INF ? 0.0 : best_s;
    };

    for (int64_t i = 1; i <= nr; ++i) {
        const int32_t* rc = ref + (i - 1) * 3;
        int64_t codon_row = -1;
        if (rc[0] >= 0 && rc[1] >= 0 && rc[2] >= 0)
            codon_row = rc[0] * 16 + rc[1] * 4 + rc[2];
        for (int64_t j = 0; j <= lq; ++j) {
            const int64_t c = i * w + j;
            // match-type moves: query step k = 1..5
            for (int k = 1; k <= 5; ++k) {
                if (j < k) break;
                const int64_t p = (i - 1) * w + (j - k);
                double prev = cell_max3(M[p], X[p], Y[p]);
                if (prev <= NEG_INF) continue;
                double s;
                if (codon_row < 0) s = 0.0;  // N-containing ref codon
                else s = step_score(codon_row, qry + j - k, k);
                s -= miscall * std::abs(k - 3);
                if (prev + s > M[c]) { M[c] = prev + s; move[c] = (int8_t)k; }
            }
            if (i >= 1) {  // X: delete a ref codon (gap in query)
                const int64_t p = (i - 1) * w + j;
                double xo = cell_max3(M[p], Y[p], NEG_INF) - gap_open;
                double xe = X[p] - gap_extend;
                X[c] = std::max(X[c], std::max(xo, xe));
                xext[c] = xe > xo;
            }
            if (j >= 1) {  // Y: query insertion (gap in ref), per nucleotide
                const int64_t p = i * w + (j - 1);
                double yo = cell_max3(M[p], X[p], NEG_INF) - gap_open_q;
                double ye = Y[p] - gap_extend_q;
                Y[c] = std::max(Y[c], std::max(yo, ye));
                yext[c] = ye > yo;
            }
        }
    }

    int64_t i = nr, j = lq;
    int state;
    double final_score;
    {
        const int64_t c = i * w + j;
        double m = M[c], x = X[c], y = Y[c];
        if (m >= x && m >= y) { final_score = m; state = 0; }
        else if (x >= y) { final_score = x; state = 1; }
        else { final_score = y; state = 2; }
    }
    std::vector<int32_t> rp, qp;
    while (i > 0 || j > 0) {
        const int64_t c = i * w + j;
        if (state == 0) {
            int k = move[c];
            if (k == 0) break;
            // emit ref codon (3 nt) against k query nt, padding the shorter
            int mlen = std::max(3, k);
            for (int t = mlen - 1; t >= 0; --t) {
                rp.push_back(t < 3 ? (int32_t)((i - 1) * 3 + t) : -1);
                qp.push_back(t < k ? (int32_t)(j - k + t) : -1);
            }
            const int64_t p = (i - 1) * w + (j - k);
            double m = M[p], x = X[p], y = Y[p];
            state = (m >= x && m >= y) ? 0 : (x >= y ? 1 : 2);
            --i; j -= k;
        } else if (state == 1) {
            if (i == 0) break;
            for (int t = 2; t >= 0; --t) {
                rp.push_back((int32_t)((i - 1) * 3 + t));
                qp.push_back(-1);
            }
            bool ext = xext[c];
            --i;
            if (ext) state = 1;
            else {
                const int64_t p = i * w + j;
                state = (M[p] >= Y[p]) ? 0 : 2;
            }
        } else {
            if (j == 0) break;
            rp.push_back(-1);
            qp.push_back((int32_t)(j - 1));
            bool ext = yext[c];
            --j;
            if (ext) state = 2;
            else {
                const int64_t p = i * w + j;
                state = (M[p] >= X[p]) ? 0 : 1;
            }
        }
    }
    *path_len = (int64_t)rp.size();
    for (size_t k2 = 0; k2 < rp.size(); ++k2) {
        path_r[k2] = rp[rp.size() - 1 - k2];
        path_q[k2] = qp[rp.size() - 1 - k2];
    }
    return final_score;
}

}  // extern "C"
