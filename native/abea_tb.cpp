// abea host traceback + QC (f5c postalign semantics; the semantic contract
// is ops/abea.py::_traceback, itself cited to the reference's align.c
// postalign — this is a bit-exact native transcription of the Python walk:
// float32 emission term order matches numpy elementwise ops (the Makefile's
// -ffp-contract=off forbids FMA contraction), the emission sum and the
// backtrack-seed search accumulate in float64 exactly like the host code).
//
// Called per GROUP of same-bucket reads from _traceback_batch, in place
// of the numpy lockstep walk.

#include <cstdint>
#include <cmath>
#include <vector>

namespace {
constexpr uint8_t FROM_D = 0, FROM_U = 1, FROM_L = 2;
}

extern "C" int gt_abea_traceback(
    int64_t g_n,
    const uint8_t* trace,   // [G, nb_max, bw] full trace (rows 0,1 seeded)
    const int64_t* bll_e,   // [G, nb_max] band lower-left event index
    const double* lv,       // [G, nb_max-2] last-kmer column values
    const int32_t* ranks,   // [G, nk_max] kmer ranks
    const float* events,    // [G, ne_max] event means
    const float* lm, const float* ls, const float* lls,  // pore model
    const float* scales, const float* shifts,            // [G] (f32)
    const int64_t* ne, const int64_t* nk,                // [G]
    int64_t nb_max, int64_t bw, int64_t nk_max, int64_t ne_max,
    double lp_trim,         // np.log(0.01), passed in to match numpy's libm
    int32_t* out_pairs,     // [G, 2*cap] (kmer, event) forward order
    int64_t* out_n,         // [G] pair count (0 after QC drop)
    int64_t cap) {
    std::vector<int32_t> rev;
    for (int64_t g = 0; g < g_n; g++) {
        const int64_t n_events = ne[g], n_kmers = nk[g];
        const int64_t nb = n_events + n_kmers + 2;
        const uint8_t* tr = trace + g * nb_max * bw;
        const int64_t* be = bll_e + g * nb_max;
        const double* lvg = lv + g * (nb_max - 2);
        const int32_t* rk = ranks + g * nk_max;
        const float* ev = events + g * ne_max;
        const float sc = scales[g], sh = shifts[g];

        // backtrack seed: first index attaining the max of
        // last_val + remaining-trim penalty
        float best = -INFINITY;
        int64_t ce = 0;
        for (int64_t ei = 0; ei < n_events; ei++) {
            const int64_t bi = ei + n_kmers + 1;
            if (bi >= nb) break;
            // C reference: float s = band + (n-ei)*lp_trim (double math,
            // f32-rounded before the compare, align.c:427-432)
            const float s =
                (float)(lvg[bi - 2] + (double)(n_events - ei) * lp_trim);
            if (s > best) { best = s; ce = ei; }
        }

        int64_t ck = n_kmers - 1;
        double sum_em = 0.0;
        int64_t n_aligned = 0, gap = 0, max_gap = 0;
        rev.clear();
        while (ck >= 0 && ce >= 0) {
            rev.push_back((int32_t)ck);
            rev.push_back((int32_t)ce);
            const int32_t r = rk[ck];
            // float32 term order == the numpy/oracle expression
            const float gp = sc * lm[r] + sh;
            const float a = (ev[ce] - gp) / ls[r];
            const float lp = (float)(-0.918938) - lls[r] + ((float)(-0.5) * a) * a;
            sum_em += (double)lp;
            n_aligned++;
            const int64_t bi = ce + ck + 2;
            int64_t off = be[bi] - ce;  // clamp like the numpy walk's
            if (off < 0) off = 0;       // np.clip (degenerate seeds can
            if (off >= bw) off = bw - 1;  // step outside the band)
            const uint8_t frm = tr[bi * bw + off];
            if (frm == FROM_D) { ck--; ce--; gap = 0; }
            else if (frm == FROM_U) { ce--; gap = 0; }
            else { ck--; gap++; if (gap > max_gap) max_gap = gap; }
        }
        const int64_t n = (int64_t)rev.size() / 2;
        const double avg = sum_em / (double)(n_aligned > 0 ? n_aligned : 1);
        const bool spanned =
            n > 0 && rev[2 * (n - 1)] == 0 && rev[0] == (int32_t)(n_kmers - 1);
        if (n > cap) return -1;  // caller sized cap too small: hard error
        if (avg < -5.0 || !spanned || max_gap > 50) {
            out_n[g] = 0;
            continue;
        }
        out_n[g] = n;
        int32_t* op = out_pairs + g * 2 * cap;
        for (int64_t t = 0; t < n; t++) {  // reverse into forward order
            op[2 * t] = rev[2 * (n - 1 - t)];
            op[2 * t + 1] = rev[2 * (n - 1 - t) + 1];
        }
    }
    return 0;
}
