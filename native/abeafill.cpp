// Native adaptive banded event alignment (f5c eventalign semantics) —
// the host half of the abea dual-engine split.  Semantic contract is
// ops/oracle/abea.py::align (itself cited to benchmarks/abea/src/
// align.c:99-548): identical band movement, trim cells, float32 band
// stores with DOUBLE transition-constant promotion
// (f32(f64(band) + lp_f64 + f64(emit_f32))), the U-then-L tie-break,
// the trailing-trim backtrack start, and the three QC gates.  Tests
// assert bit-identical alignments to the oracle, including QC drops.
//
// Fill layout: per band, every in-band cell is independent — the up /
// left / diag reads are +/-1-shifted positions of the previous two
// bands, so band rows carry one -inf margin cell on each side and the
// inner loop is pure stride-1 (the per-kmer scaled gaussian params and
// the reversed event stream are precomputed once per read, turning the
// rank/event gathers into contiguous loads the compiler vectorizes).
// The reference's fill is scalar; this loop is the same math,
// vector-width wide.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int FROM_D = 0, FROM_U = 1, FROM_L = 2;

struct Scratch {
    std::vector<float> bands;    // (n_bands, bw + 2) with -inf margins
    std::vector<uint8_t> trace;  // (n_bands, bw)
    std::vector<int64_t> bll_e, bll_k;
    std::vector<float> mu_s, sd, lls_k;  // per-kmer scaled params
    std::vector<float> ev_rev;           // reversed event means
};

Scratch& scratch() {
    thread_local Scratch s;
    return s;
}

// the vectorizable core: cells [min_off, max_off) of one band.
// prev/prev2 point at the previous bands' MARGIN bases (index -1..bw),
// shifted so that for cell `off`: up = prev[off + sh_up], left =
// prev[off + sh_left], diag = prev2[off + sh_diag] with sh in {-1,0,+1}
// — all in the padded row.  kp/ep point at per-cell contiguous params.
void fill_cells(float* __restrict out, uint8_t* __restrict tr,
                const float* __restrict prev_up,
                const float* __restrict prev_left,
                const float* __restrict prev2_diag,
                const float* __restrict mu_s, const float* __restrict sd,
                const float* __restrict lls, const float* __restrict ev,
                int64_t n, double lp_step, double lp_stay, double lp_skip) {
    for (int64_t i = 0; i < n; i++) {
        const float a = (ev[i] - mu_s[i]) / sd[i];
        const float lp_emit = -0.918938f - lls[i] + -0.5f * a * a;
        const float score_d =
            (float)((double)prev2_diag[i] + lp_step + (double)lp_emit);
        const float score_u =
            (float)((double)prev_up[i] + lp_stay + (double)lp_emit);
        const float score_l = (float)((double)prev_left[i] + lp_skip);
        float max_score = score_d;
        int frm = FROM_D;
        if (score_u > max_score) max_score = score_u;
        if (max_score == score_u) frm = FROM_U;
        if (score_l > max_score) max_score = score_l;
        if (max_score == score_l) frm = FROM_L;
        out[i] = max_score;
        tr[i] = (uint8_t)frm;
    }
}

}  // namespace

// Returns npairs (0 = QC-dropped or empty), -1 = cap too small,
// -2 = bad shape.  out pairs are (kmer_idx, event_idx) ascending.
extern "C" int64_t gt_abea_align(
    const int32_t* kmer_ranks, int64_t n_kmers, const float* event_means,
    int64_t n_events, const float* level_mean, const float* level_stdv,
    const float* level_log_stdv, float scale, float shift,
    int32_t bandwidth, int32_t* out_kidx, int32_t* out_eidx, int64_t cap) {
    if (n_kmers <= 0 || n_events <= 0 || bandwidth <= 0) return 0;
    const int64_t bw = bandwidth;
    const int64_t half = bw / 2;
    const int64_t n_bands = n_events + 1 + n_kmers + 1;
    const int64_t stride = bw + 2;  // one -inf margin cell each side

    const double min_average_log_emission = -5.0;
    const int64_t max_gap_threshold = 50;
    const double events_per_kmer = (double)n_events / (double)n_kmers;
    const double p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0));
    const double epsilon = 1e-10;
    const double lp_skip = log(epsilon);
    const double lp_stay = log(p_stay);
    const double lp_step = log(1.0 - exp(lp_skip) - exp(lp_stay));
    const double lp_trim = log(0.01);

    Scratch& S = scratch();
    S.bands.assign((size_t)(n_bands * stride), -INFINITY);
    S.trace.assign((size_t)(n_bands * bw), 0);
    S.bll_e.resize(n_bands);
    S.bll_k.resize(n_bands);
    float* B = S.bands.data() + 1;  // B[bi*stride + off], off -1..bw valid
    uint8_t* T = S.trace.data();
    int64_t* bll_e = S.bll_e.data();
    int64_t* bll_k = S.bll_k.data();

    // per-kmer scaled params (contiguous by kmer index)
    S.mu_s.resize(n_kmers);
    S.sd.resize(n_kmers);
    S.lls_k.resize(n_kmers);
    for (int64_t i = 0; i < n_kmers; i++) {
        const int32_t r = kmer_ranks[i];
        S.mu_s[i] = scale * level_mean[r] + shift;
        S.sd[i] = level_stdv[r];
        S.lls_k[i] = level_log_stdv[r];
    }
    // reversed events: ev_rev[n_events - 1 - ei] = event_means[ei]
    S.ev_rev.resize(n_events);
    for (int64_t i = 0; i < n_events; i++)
        S.ev_rev[i] = event_means[n_events - 1 - i];

    auto emission_f32 = [&](int64_t ei, int64_t ki) -> float {
        const float a = (event_means[ei] - S.mu_s[ki]) / S.sd[ki];
        return -0.918938f - S.lls_k[ki] + -0.5f * a * a;
    };

    bll_e[0] = half - 1;
    bll_k[0] = -1 - half;
    bll_e[1] = bll_e[0] + 1;
    bll_k[1] = bll_k[0];
    B[0 * stride + (-1 - bll_k[0])] = 0.0f;
    const int64_t first_trim = bll_e[1] - 0;
    B[1 * stride + first_trim] = (float)lp_trim;
    T[1 * bw + first_trim] = FROM_U;

    for (int64_t bi = 2; bi < n_bands; bi++) {
        const float ll = B[(bi - 1) * stride + 0];
        const float ur = B[(bi - 1) * stride + (bw - 1)];
        const bool ll_ob = ll == -INFINITY;
        const bool ur_ob = ur == -INFINITY;
        const bool right = (ll_ob && ur_ob) ? (bi % 2 == 1) : (ll < ur);
        if (right) {
            bll_e[bi] = bll_e[bi - 1];
            bll_k[bi] = bll_k[bi - 1] + 1;
        } else {
            bll_e[bi] = bll_e[bi - 1] + 1;
            bll_k[bi] = bll_k[bi - 1];
        }

        const int64_t trim_off = -1 - bll_k[bi];
        if (trim_off >= 0 && trim_off < bw) {
            const int64_t ei = bll_e[bi] - trim_off;
            if (ei >= 0 && ei < n_events) {
                B[bi * stride + trim_off] = (float)(lp_trim * (double)(ei + 1));
                T[bi * bw + trim_off] = FROM_U;
            } else {
                B[bi * stride + trim_off] = -INFINITY;
            }
        }

        int64_t min_off = 0 - bll_k[bi];
        if (bll_e[bi] - (n_events - 1) > min_off)
            min_off = bll_e[bi] - (n_events - 1);
        if (min_off < 0) min_off = 0;
        int64_t max_off = n_kmers - bll_k[bi];
        if (bll_e[bi] + 1 < max_off) max_off = bll_e[bi] + 1;
        if (max_off > bw) max_off = bw;
        if (min_off >= max_off) continue;

        // neighbor shifts (constant per band): up/left in band bi-1,
        // diag in band bi-2, each at off + sh with sh in {-1, 0, +1}
        const int64_t sh_up = (bll_e[bi - 1] - bll_e[bi]) + 1;   // 0 or +1
        const int64_t sh_left = (bll_k[bi] - bll_k[bi - 1]) - 1; // -1 or 0
        const int64_t sh_diag = (bll_k[bi] - bll_k[bi - 2]) - 1; // -1..+1
        // per-cell contiguous streams: ki = bll_k[bi] + off,
        // rev_idx = (n_events - 1 - bll_e[bi]) + off
        const int64_t k0 = bll_k[bi] + min_off;
        const int64_t r0 = (n_events - 1 - bll_e[bi]) + min_off;
        fill_cells(B + bi * stride + min_off, T + bi * bw + min_off,
                   B + (bi - 1) * stride + min_off + sh_up,
                   B + (bi - 1) * stride + min_off + sh_left,
                   B + (bi - 2) * stride + min_off + sh_diag,
                   S.mu_s.data() + k0, S.sd.data() + k0,
                   S.lls_k.data() + k0, S.ev_rev.data() + r0,
                   max_off - min_off, lp_step, lp_stay, lp_skip);
    }

    // backtrack start: best (event, last kmer) with remaining-event trim
    float max_score = -INFINITY;
    int64_t curr_event_idx = 0;
    int64_t curr_kmer_idx = n_kmers - 1;
    for (int64_t ei = 0; ei < n_events; ei++) {
        const int64_t bi = (ei + 1) + (curr_kmer_idx + 1);
        const int64_t off = bll_e[bi] - ei;
        if (off >= 0 && off < bw) {
            const float s = (float)((double)B[bi * stride + off]
                                    + (double)(n_events - ei) * lp_trim);
            if (s > max_score) {
                max_score = s;
                curr_event_idx = ei;
            }
        }
    }

    int64_t cnt = 0;
    double sum_emission = 0.0;
    int64_t n_aligned = 0, curr_gap = 0, max_gap = 0;
    while (curr_kmer_idx >= 0 && curr_event_idx >= 0) {
        if (cnt >= cap) return -1;
        out_kidx[cnt] = (int32_t)curr_kmer_idx;
        out_eidx[cnt] = (int32_t)curr_event_idx;
        cnt++;
        sum_emission += (double)emission_f32(curr_event_idx, curr_kmer_idx);
        n_aligned++;
        const int64_t bi = (curr_event_idx + 1) + (curr_kmer_idx + 1);
        const int64_t off = bll_e[bi] - curr_event_idx;
        const uint8_t frm = T[bi * bw + off];
        if (frm == FROM_D) {
            curr_kmer_idx--;
            curr_event_idx--;
            curr_gap = 0;
        } else if (frm == FROM_U) {
            curr_event_idx--;
            curr_gap = 0;
        } else {
            curr_kmer_idx--;
            curr_gap++;
            if (curr_gap > max_gap) max_gap = curr_gap;
        }
    }
    // reverse into ascending order
    for (int64_t a = 0, b = cnt - 1; a < b; a++, b--) {
        const int32_t tk = out_kidx[a], te = out_eidx[a];
        out_kidx[a] = out_kidx[b];
        out_eidx[a] = out_eidx[b];
        out_kidx[b] = tk;
        out_eidx[b] = te;
    }

    const double avg = sum_emission / (double)(n_aligned ? n_aligned : 1);
    const bool spanned = cnt > 0 && out_kidx[0] == 0
                         && out_kidx[cnt - 1] == n_kmers - 1;
    if (avg < min_average_log_emission || !spanned
        || max_gap > max_gap_threshold)
        return 0;
    return cnt;
}
