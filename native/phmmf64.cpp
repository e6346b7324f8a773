// Native float64 PairHMM forward — the GKL double-fallback pass
// (IntelPairHmmCSource.cpp:75-78 recomputes underflowed testcases in
// double; the reference pays this in C, and the numpy diagonal sweep
// is far slower at dataset-scale fallback volumes).  Semantic contract
// is ops/oracle/phmm.py::compute_full_prob(dtype=float64): identical
// per-cell op tree (the computeMXY association,
// avx-pairhmm-template.h:186), row-major evaluation, sequential
// column sums — bit-exact (tests assert it; build uses
// -ffp-contract=off so no FMA contraction).
//
// Tables (ph2pr, matchToMatch, initial constant) are passed in from
// the Python context so there is exactly one source of truth.

#include <cstdint>
#include <vector>

namespace {
constexpr int AMBIG = 4;
}

extern "C" void gt_phmm_f64(
    const int8_t* rs_row, const int32_t* q, const int32_t* iq,
    const int32_t* dq, const int32_t* cq,  // [B, rp], row r at col r
    const int8_t* hap,                     // [B, hp]
    const int64_t* rslen, const int64_t* haplen, int64_t b, int64_t rp,
    int64_t hp, const double* ph2pr, const double* m2m,
    double initial_constant, double* out) {
    thread_local std::vector<double> mbuf, xbuf, ybuf, mcur, xcur, ycur;
    mbuf.resize(hp + 1);
    xbuf.resize(hp + 1);
    ybuf.resize(hp + 1);
    mcur.resize(hp + 1);
    xcur.resize(hp + 1);
    ycur.resize(hp + 1);
    for (int64_t lane = 0; lane < b; lane++) {
        const int8_t* rs = rs_row + lane * rp;
        const int32_t* lq = q + lane * rp;
        const int32_t* li = iq + lane * rp;
        const int32_t* ld = dq + lane * rp;
        const int32_t* lc = cq + lane * rp;
        const int8_t* hp_row = hap + lane * hp;
        const int64_t rows = rslen[lane] + 1;
        const int64_t cols = haplen[lane] + 1;
        if (cols <= 1 || rows <= 1) {
            out[lane] = 0.0;
            continue;
        }
        const double init_y = initial_constant / (double)haplen[lane];
        double* m_prev = mbuf.data();
        double* x_prev = xbuf.data();
        double* y_prev = ybuf.data();
        double* m_cur = mcur.data();
        double* x_cur = xcur.data();
        double* y_cur = ycur.data();
        for (int64_t c2 = 0; c2 < cols; c2++) {
            m_prev[c2] = 0.0;
            x_prev[c2] = 0.0;
            y_prev[c2] = init_y;
        }
        for (int64_t r = 1; r < rows; r++) {
            const int32_t _i = li[r] & 127;
            const int32_t _d = ld[r] & 127;
            const int32_t _c = lc[r] & 127;
            const int32_t _q = lq[r] & 127;
            const int32_t mn = _i < _d ? _i : _d;
            const int32_t mx = _i < _d ? _d : _i;
            const double p_mm = m2m[((mx * (mx + 1)) >> 1) + mn];
            const double p_gapm = 1.0 - ph2pr[_c];
            const double p_mx = ph2pr[_i];
            const double p_xx = ph2pr[_c];
            const double p_my = ph2pr[_d];
            const double p_yy = ph2pr[_c];
            const double distm = ph2pr[_q];
            const double one_m_distm = 1.0 - distm;
            const double distm3 = distm / 3.0;
            const int8_t rbase = rs[r];
            m_cur[0] = 0.0;
            x_cur[0] = 0.0;
            y_cur[0] = 0.0;
            for (int64_t c = 1; c < cols; c++) {
                const int8_t hbase = hp_row[c - 1];
                const bool match =
                    rbase == hbase || rbase == AMBIG || hbase == AMBIG;
                const double prior = match ? one_m_distm : distm3;
                m_cur[c] = prior * ((m_prev[c - 1] * p_mm
                                     + x_prev[c - 1] * p_gapm)
                                    + y_prev[c - 1] * p_gapm);
                x_cur[c] = m_prev[c] * p_mx + x_prev[c] * p_xx;
                y_cur[c] = m_cur[c - 1] * p_my + y_cur[c - 1] * p_yy;
            }
            double* t;
            t = m_prev; m_prev = m_cur; m_cur = t;
            t = x_prev; x_prev = x_cur; x_cur = t;
            t = y_prev; y_prev = y_cur; y_cur = t;
        }
        double sum_m = 0.0, sum_x = 0.0;
        for (int64_t c = 1; c < cols; c++) {
            sum_m += m_prev[c];
            sum_x += x_prev[c];
        }
        out[lane] = sum_m + sum_x;
    }
}
