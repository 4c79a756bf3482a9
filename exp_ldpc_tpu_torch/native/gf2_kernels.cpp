// Bit-packed GF(2) elimination kernels.
//
// Native backend for exp_ldpc_tpu.utils.gf2 (the framework's replacement for
// the galois/numba dependency of the reference, SURVEY.md §2.3): the O(n^3)
// homology behind logical-operator computation and the per-shot OSD
// eliminations run here.  Matrices are row-major uint64 words, 64 columns per
// word, little-endian bit order (matching gf2.pack_rows).
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by exp_ldpc_tpu.native).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// In-place reduced row echelon form over the first `reduce_cols` columns.
// data: rows x words packed matrix.  pivots_out: capacity >= min(rows, reduce_cols).
// Returns the number of pivots (rank over the reduced column range).
long long gf2_row_reduce(uint64_t* data, long long rows, long long words,
                         long long reduce_cols, long long* pivots_out) {
    long long pr = 0;  // pivot row
    for (long long col = 0; col < reduce_cols && pr < rows; ++col) {
        const long long w = col >> 6;
        const uint64_t bit = 1ULL << (col & 63);
        // find pivot
        long long src = -1;
        for (long long r = pr; r < rows; ++r) {
            if (data[r * words + w] & bit) { src = r; break; }
        }
        if (src < 0) continue;
        if (src != pr) {
            for (long long k = w; k < words; ++k) {
                uint64_t t = data[pr * words + k];
                data[pr * words + k] = data[src * words + k];
                data[src * words + k] = t;
            }
        }
        // eliminate all other rows holding this column
        const uint64_t* prow = data + pr * words;
        for (long long r = 0; r < rows; ++r) {
            if (r == pr) continue;
            if (data[r * words + w] & bit) {
                uint64_t* rrow = data + r * words;
                for (long long k = w; k < words; ++k) rrow[k] ^= prow[k];
            }
        }
        pivots_out[pr] = col;
        ++pr;
    }
    return pr;
}

// rank only (destroys data)
long long gf2_rank(uint64_t* data, long long rows, long long words, long long cols) {
    long long pr = 0;
    for (long long col = 0; col < cols && pr < rows; ++col) {
        const long long w = col >> 6;
        const uint64_t bit = 1ULL << (col & 63);
        long long src = -1;
        for (long long r = pr; r < rows; ++r) {
            if (data[r * words + w] & bit) { src = r; break; }
        }
        if (src < 0) continue;
        if (src != pr) {
            for (long long k = w; k < words; ++k) {
                uint64_t t = data[pr * words + k];
                data[pr * words + k] = data[src * words + k];
                data[src * words + k] = t;
            }
        }
        const uint64_t* prow = data + pr * words;
        for (long long r = pr + 1; r < rows; ++r) {
            if (data[r * words + w] & bit) {
                uint64_t* rrow = data + r * words;
                for (long long k = w; k < words; ++k) rrow[k] ^= prow[k];
            }
        }
        ++pr;
    }
    return pr;
}

// ---------------------------------------------------------------------------
// Batched ordered-statistics decoding (OSD) post-processing.
//
// Mirrors exp_ldpc_tpu/decoders/osd.py (the framework's replacement for the
// OSD stage of the reference's `ldpc` Cython bposd_decoder, consumed at
// reference/python/qldpc/misc/_experiment.py:218-219,227-228), threaded
// over shots.  Per shot: stable argsort of the BP posterior LLRs (most likely
// in error first), bit-packed Gaussian elimination of the column-permuted
// augmented matrix [H_ordered | s], then candidate enumeration (osd0 / osd_e /
// osd_cs per arXiv:2005.07016) scored by the posterior channel cost.
//
// method: 0 = osd0, 1 = osd_e, 2 = osd_cs.

static void osd_one_shot(const uint8_t* H, long long r, long long n,
                         const uint8_t* synd, const double* llr,
                         long long method, long long osd_order,
                         uint8_t* out,
                         // scratch (capacity: see osd_batch)
                         long long* order, uint64_t* packed, long long* pivots,
                         uint8_t* pivot_mask, long long* nonpivots,
                         double* cost_ord) {
    const long long words = (n + 1 + 63) >> 6;

    // reliability order: ascending LLR, stable (ties keep lower index first,
    // matching numpy argsort kind="stable"); NaNs sort last like numpy —
    // a bare `<` would violate strict weak ordering (UB in stable_sort)
    for (long long j = 0; j < n; ++j) order[j] = j;
    std::stable_sort(order, order + n, [llr](long long a, long long b) {
        const bool na = std::isnan(llr[a]), nb = std::isnan(llr[b]);
        if (na || nb) return nb && !na;
        return llr[a] < llr[b];
    });

    // augmented packed matrix rows = [H[:, order] | s]
    std::memset(packed, 0, sizeof(uint64_t) * r * words);
    for (long long row = 0; row < r; ++row) {
        uint64_t* prow = packed + row * words;
        const uint8_t* hrow = H + row * n;
        for (long long j = 0; j < n; ++j) {
            if (hrow[order[j]] & 1) prow[j >> 6] |= 1ULL << (j & 63);
        }
        if (synd[row] & 1) prow[n >> 6] |= 1ULL << (n & 63);
    }

    const long long r_rows = gf2_row_reduce(packed, r, words, n, pivots);

    // non-pivot (ordered) columns
    std::memset(pivot_mask, 0, n);
    for (long long i = 0; i < r_rows; ++i) pivot_mask[pivots[i]] = 1;
    long long k = 0;
    for (long long c = 0; c < n; ++c) {
        if (!pivot_mask[c]) nonpivots[k++] = c;
    }

    // candidate scoring cost in ordered coordinates: cost_ord[j] applies when
    // ordered bit j is set (original bit order[j])
    for (long long j = 0; j < n; ++j) {
        double x = llr[order[j]];
        if (x < -30.0) x = -30.0;
        if (x > 30.0) x = 30.0;
        double q = 1.0 / (1.0 + std::exp(x));
        if (q < 1e-12) q = 1e-12;
        if (q > 1.0 - 1e-12) q = 1.0 - 1e-12;
        double c = std::log((1.0 - q) / q);
        // floor at 1e-9 but PROPAGATE NaN (numpy np.maximum semantics — the
        // numpy oracle path keeps NaN costs, so candidate comparisons skip
        // identically in both backends)
        cost_ord[j] = (c > 1e-9 || std::isnan(c)) ? c : 1e-9;
    }

    const uint64_t syn_bit = 1ULL << (n & 63);
    const long long syn_word = n >> 6;
    auto rref_bit = [&](long long row, long long col) -> int {
        return (packed[row * words + (col >> 6)] >> (col & 63)) & 1;
    };

    // evaluate a candidate given the set non-pivot positions t[0..tw)
    // (indices into nonpivots); returns cost, fills x_piv on request
    auto candidate_cost = [&](const long long* t, long long tw) -> double {
        double c = 0.0;
        for (long long i = 0; i < r_rows; ++i) {
            int bit = (packed[i * words + syn_word] & syn_bit) ? 1 : 0;
            for (long long u = 0; u < tw; ++u) bit ^= rref_bit(i, nonpivots[t[u]]);
            if (bit) c += cost_ord[pivots[i]];
        }
        for (long long u = 0; u < tw; ++u) c += cost_ord[nonpivots[t[u]]];
        return c;
    };

    // enumeration identical to osd.py:_solve_candidates
    long long best_t[64];
    long long best_tw = 0;
    double best_cost = candidate_cost(nullptr, 0);
    long long t[64];

    if (method == 1) {  // osd_e: all 2^w patterns over the first w non-pivots
        const long long w = std::min<long long>(osd_order, k);
        for (long long pattern = 1; pattern < (1LL << w); ++pattern) {
            long long tw = 0;
            for (long long b = 0; b < w; ++b) {
                if ((pattern >> b) & 1) t[tw++] = b;
            }
            double c = candidate_cost(t, tw);
            if (c < best_cost) {
                best_cost = c;
                best_tw = tw;
                std::memcpy(best_t, t, sizeof(long long) * tw);
            }
        }
    } else if (method == 2) {  // osd_cs: all singles + pairs within first w
        for (long long i = 0; i < k; ++i) {
            t[0] = i;
            double c = candidate_cost(t, 1);
            if (c < best_cost) { best_cost = c; best_tw = 1; best_t[0] = i; }
        }
        const long long w = std::min<long long>(osd_order, k);
        for (long long i = 0; i < w; ++i) {
            for (long long j = i + 1; j < w; ++j) {
                t[0] = i; t[1] = j;
                double c = candidate_cost(t, 2);
                if (c < best_cost) {
                    best_cost = c; best_tw = 2; best_t[0] = i; best_t[1] = j;
                }
            }
        }
    }
    // method 0 (osd0): base candidate only

    // assemble the winner in ORIGINAL column coordinates
    std::memset(out, 0, n);
    for (long long i = 0; i < r_rows; ++i) {
        int bit = (packed[i * words + syn_word] & syn_bit) ? 1 : 0;
        for (long long u = 0; u < best_tw; ++u) bit ^= rref_bit(i, nonpivots[best_t[u]]);
        if (bit) out[order[pivots[i]]] = 1;
    }
    for (long long u = 0; u < best_tw; ++u) out[order[nonpivots[best_t[u]]]] = 1;
}

// Batched OSD over S shots, threaded.  H: r*n row-major dense 0/1.
// syndromes: S*r.  llrs: S*n.  out: S*n.  Returns 0 on success, <0 on error.
long long osd_batch(const uint8_t* H, long long r, long long n,
                    const uint8_t* syndromes, const double* llrs, long long S,
                    long long method, long long osd_order, long long nthreads,
                    uint8_t* out) {
    if (method < 0 || method > 2) return -1;
    if (osd_order < 0 || osd_order > 62) return -2;  // pattern fits in long long
    if (nthreads <= 0) {
        nthreads = (long long)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 1;
    }
    nthreads = std::min(nthreads, S > 0 ? S : 1);

    std::atomic<long long> next(0);
    auto worker = [&]() {
        const long long words = (n + 1 + 63) >> 6;
        std::vector<long long> order(n), pivots(std::min(r, n) + 1), nonpivots(n);
        std::vector<uint64_t> packed(r * words);
        std::vector<uint8_t> pivot_mask(n);
        std::vector<double> cost_ord(n);
        for (;;) {
            const long long s = next.fetch_add(1);
            if (s >= S) break;
            osd_one_shot(H, r, n, syndromes + s * r, llrs + s * n, method,
                         osd_order, out + s * n, order.data(), packed.data(),
                         pivots.data(), pivot_mask.data(), nonpivots.data(),
                         cost_ord.data());
        }
    };
    if (nthreads == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nthreads);
        for (long long i = 0; i < nthreads; ++i) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return 0;
}

}  // extern "C"
