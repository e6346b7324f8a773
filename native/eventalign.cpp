// f5c eventalign realign engine: segment-by-segment profile-HMM Viterbi
// alignment of events to the reference (the hot path of
// benchmarks/abea/src/eventalign.c align_read_to_ref:1263-1543 /
// profile_hmm_align:703-918 / profile_hmm_fill_generic_r9:345-598).
//
// Bit-exact contract with ops/oracle/eventalign.py (which is itself
// byte-exact vs the reference-built golden harness): f32 state matrices,
// double-log transitions rounded to f32, the last-max tie rule of
// update_cell, and the backtrack that starts at the fixed last
// (event, kmer) MATCH cell.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstring>
#include <vector>

namespace {

constexpr int K = 6;
constexpr int PSR9_KMER_SKIP = 0, PSR9_BAD_EVENT = 1, PSR9_MATCH = 2;
constexpr int HMT_FROM_SOFT = 5;
constexpr float NEG_INF = -INFINITY;

struct Transitions {
    float mm_self, mb, mk, mm_next, bb, bk, bm_next, bm_self, kk, km;
};

Transitions calc_transitions(double events_per_base) {
    // eventalign.c:171-243 — float probabilities, double log, f32 store
    float p_stay = (float)(1 - (1 / events_per_base));
    float p_skip = 0.0025f, p_bad = 0.001f;
    float p_mk = p_skip, p_mb = p_bad, p_mm_self = p_stay;
    float p_mm_next = 1.0f - p_mm_self - p_mk - p_mb;
    float p_bb = p_bad;
    float p_b3 = (1.0f - p_bb) / 3;
    float p_kk = 0.3f;
    float p_km = 1.0f - p_kk;
    Transitions t;
    t.mm_self = (float)log((double)p_mm_self);
    t.mb = (float)log((double)p_mb);
    t.mk = (float)log((double)p_mk);
    t.mm_next = (float)log((double)p_mm_next);
    t.bb = (float)log((double)p_bb);
    t.bk = (float)log((double)p_b3);
    t.bm_next = (float)log((double)p_b3);
    t.bm_self = (float)log((double)p_b3);
    t.kk = (float)log((double)p_kk);
    t.km = (float)log((double)p_km);
    return t;
}

struct AlnState { int event_idx, kmer_idx; char state; };

// eventalign.c:75-151 (flanking chains: double accumulate, f32 store)
void make_pre_flanking(int num_events, std::vector<float>& pre) {
    pre.assign(num_events + 1, 0.0f);
    pre[0] = (float)log(1 - 0.5);
    if (num_events + 1 > 1)
        pre[1] = (float)(log(0.5) + (double)(-3.0f) + log(1 - 0.9));
    for (int i = 2; i <= num_events; ++i)
        pre[i] = (float)(log(0.9) + (double)(-3.0f) + (double)pre[i - 1]);
}

void make_post_flanking(int num_events, std::vector<float>& post) {
    post.assign(num_events, 0.0f);
    post[num_events - 1] = (float)log(1 - 0.5);
    if (num_events > 1) {
        post[num_events - 2] =
            (float)(log(0.5) + (double)(-3.0f) + log(1 - 0.9));
        for (int i = num_events - 3; i >= 0; --i)
            post[i] = (float)(log(0.9) + (double)(-3.0f) + (double)post[i + 1]);
    }
}

// Viterbi fill + backtrack (eventalign.c:345-918).  seg_codes points at the
// fwd subsequence (0-3 codes); rc kmers are complemented/reversed in place.
void profile_hmm_align(const uint8_t* seg_codes, int seg_len,
                       const float* ev_mean,
                       float shift, float scale, float var, float log_var,
                       const float* m_mean, const float* m_stdv,
                       const float* m_log_stdv,
                       double events_per_base, int rc,
                       int e_start, int e_end, int event_stride,
                       std::vector<AlnState>& out) {
    out.clear();
    int n_kmers = seg_len - K + 1;
    int n_events = (e_end > e_start ? e_end - e_start : e_start - e_end) + 1;
    int n_rows = n_events + 1;
    int num_blocks = n_kmers + 2;
    int last_event_row_idx = n_rows - 1;

    Transitions t = calc_transitions(events_per_base);

    std::vector<int> ranks(n_kmers);
    for (int ki = 0; ki < n_kmers; ++ki) {
        uint32_t r = 0;
        if (!rc) {
            for (int j = 0; j < K; ++j) r = r * 4 + seg_codes[ki + j];
        } else {
            // rank of revcomp(fwd[ki..ki+K)) == rc_subseq kmer at the
            // mirrored offset (eventalign.c:437-445)
            for (int j = K - 1; j >= 0; --j)
                r = r * 4 + (3 - seg_codes[ki + j]);
        }
        ranks[ki] = (int)r;
    }

    std::vector<float> pre_flank, post_flank;
    make_pre_flanking(n_events, pre_flank);
    make_post_flanking(n_events, post_flank);

    // state value + backtrack matrices, row-major [n_rows][num_blocks]
    size_t sz = (size_t)n_rows * num_blocks;
    std::vector<float> M(sz, NEG_INF), B(sz, NEG_INF), Kv(sz, NEG_INF);
    std::vector<uint8_t> fM(sz, 0), fB(sz, 0), fK(sz, 0);

    for (int row = 1; row < n_rows; ++row) {
        const float* pm = &M[(size_t)(row - 1) * num_blocks];
        const float* pb = &B[(size_t)(row - 1) * num_blocks];
        const float* pk = &Kv[(size_t)(row - 1) * num_blocks];
        float* cm = &M[(size_t)row * num_blocks];
        float* cb = &B[(size_t)row * num_blocks];
        float* ck = &Kv[(size_t)row * num_blocks];
        uint8_t* cfm = &fM[(size_t)row * num_blocks];
        uint8_t* cfb = &fB[(size_t)row * num_blocks];
        uint8_t* cfk = &fK[(size_t)row * num_blocks];
        int event_idx = e_start + (row - 1) * event_stride;
        float lvl = ev_mean[event_idx];
        for (int block = 1; block < num_blocks - 1; ++block) {
            int ki = block - 1;
            int rank = ranks[ki];
            // log_probability_match_r9 (eventalign.c:302-343), f32 ops
            float gp_mean = scale * m_mean[rank] + shift;
            float gp_stdv = m_stdv[rank] * var;
            float gp_log_stdv = m_log_stdv[rank] + log_var;
            float a = (lvl - gp_mean) / gp_stdv;
            float lp_em = -0.918938f - gp_log_stdv + (-0.5f * a * a);

            float x[6];
            // PSR9_MATCH
            x[0] = t.mm_self + pm[block];
            x[1] = t.mm_next + pm[block - 1];
            x[2] = t.bm_self + pb[block];
            x[3] = t.bm_next + pb[block - 1];
            x[4] = t.km + pk[block - 1];
            x[5] = (ki == 0 && event_idx == e_start)
                       ? pre_flank[row - 1] : NEG_INF;
            float mx = x[0];
            uint8_t frm = 0;
            for (int i = 1; i < 6; ++i) {
                mx = x[i] > mx ? x[i] : mx;
                frm = mx == x[i] ? (uint8_t)i : frm;
            }
            cm[block] = mx + lp_em;
            cfm[block] = frm;

            // PSR9_BAD_EVENT
            x[0] = t.mb + pm[block];
            x[1] = NEG_INF;
            x[2] = t.bb + pb[block];
            x[3] = NEG_INF;
            x[4] = NEG_INF;
            x[5] = NEG_INF;
            mx = x[0];
            frm = 0;
            for (int i = 1; i < 6; ++i) {
                mx = x[i] > mx ? x[i] : mx;
                frm = mx == x[i] ? (uint8_t)i : frm;
            }
            cb[block] = mx + 0.0f;
            cfb[block] = frm;

            // PSR9_KMER_SKIP (same-row previous block)
            x[0] = NEG_INF;
            x[1] = t.mk + cm[block - 1];
            x[2] = NEG_INF;
            x[3] = t.bk + cb[block - 1];
            x[4] = t.kk + ck[block - 1];
            x[5] = NEG_INF;
            mx = x[0];
            frm = 0;
            for (int i = 1; i < 6; ++i) {
                mx = x[i] > mx ? x[i] : mx;
                frm = mx == x[i] ? (uint8_t)i : frm;
            }
            ck[block] = mx + 0.0f;
            cfk[block] = frm;
            (void)last_event_row_idx;  // end-state value is unused by the
            // fixed-cell backtrack below (eventalign.c:815-817)
        }
    }

    // Backtrack from the last event row at the last kmer MATCH cell
    int row = n_rows - 1;
    int col = 3 * n_kmers + PSR9_MATCH;
    while (row > 0) {
        int event_idx = e_start + (row - 1) * event_stride;
        int block = col / 3;
        int kmer_idx = block - 1;
        int curr_ps = col % 3;
        out.push_back({event_idx, kmer_idx, "KBM"[curr_ps]});
        const std::vector<uint8_t>& fmat =
            curr_ps == PSR9_KMER_SKIP ? fK
            : (curr_ps == PSR9_BAD_EVENT ? fB : fM);
        int movement = fmat[(size_t)row * num_blocks + block];
        if (movement == HMT_FROM_SOFT) break;
        int next_ps;
        switch (movement) {
            case 0: next_ps = PSR9_MATCH; break;
            case 1: kmer_idx -= 1; next_ps = PSR9_MATCH; break;
            case 2: next_ps = PSR9_BAD_EVENT; break;
            case 3: kmer_idx -= 1; next_ps = PSR9_BAD_EVENT; break;
            default: kmer_idx -= 1; next_ps = PSR9_KMER_SKIP; break;
        }
        if (curr_ps != PSR9_KMER_SKIP) row -= 1;
        col = 3 * (kmer_idx + 1) + next_ps;
    }
    // reverse in place
    for (size_t i = 0, j = out.size(); i + 1 < j; ++i, --j)
        std::swap(out[i], out[j - 1]);
}

int get_next_event(int start, int stop, int stride, const int32_t* b2e) {
    while (start != stop) {
        int ei = b2e[2 * start];
        if (ei != -1) return ei;
        start += stride;
    }
    return -1;
}

int get_closest_event_to(int k_idx, const int32_t* b2e, int b2e_size) {
    int stop_before = k_idx - 1000 > 0 ? k_idx - 1000 : 0;
    int stop_after =
        k_idx + 1000 < b2e_size - 1 ? k_idx + 1000 : b2e_size - 1;
    int before = get_next_event(k_idx, stop_before, -1, b2e);
    int after = get_next_event(k_idx, stop_after, 1, b2e);
    return before == -1 ? after : before;
}

}  // namespace

// Segments arrive pre-walked from the BAM cigar (the Python side's
// get_aligned_segments) and pre-trimmed to the max kmer index; pair_ref /
// pair_read are concatenated with seg_off[n_segs+1] offsets.
extern "C" int64_t gt_eventalign_realign(
    const uint8_t* ref_codes, int64_t ref_seg_len, int64_t ref_offset,
    const int32_t* pair_ref, const int32_t* pair_read,
    const int64_t* seg_off, int64_t n_segs,
    int32_t rc, int64_t read_length,
    const float* ev_mean, int64_t n_events,
    float shift, float scale, float var, float log_var,
    const float* m_mean, const float* m_stdv, const float* m_log_stdv,
    const int32_t* b2e, int64_t n_b2e, double events_per_base,
    int32_t* out_ref_pos, int32_t* out_event_idx, uint8_t* out_state,
    int64_t out_cap) {
    (void)n_events;
    int64_t n_out = 0;
    std::vector<AlnState> ev_aln;
    for (int64_t si = 0; si < n_segs; ++si) {
        const int32_t* ap_ref = pair_ref + seg_off[si];
        const int32_t* ap_read = pair_read + seg_off[si];
        int64_t n_pairs = seg_off[si + 1] - seg_off[si];
        if (n_pairs == 0) return n_out;

        bool do_base_rc = rc != 0;
        int read_kidx_start = ap_read[0];
        int read_kidx_end = ap_read[n_pairs - 1];
        if (do_base_rc) {
            read_kidx_start = (int)read_length - read_kidx_start - K;
            read_kidx_end = (int)read_length - read_kidx_end - K;
        }
        int first_event = get_closest_event_to(read_kidx_start, b2e, n_b2e);
        int last_event = get_closest_event_to(read_kidx_end, b2e, n_b2e);
        bool forward = first_event < last_event;
        int curr_start_event = first_event;
        int curr_start_ref = ap_ref[0];
        int64_t curr_pair_idx = 0;

        while ((forward && curr_start_event < last_event) ||
               (!forward && curr_start_event > last_event)) {
            // get_end_pair (eventalign.c:919-928)
            int64_t end_pair_idx = curr_pair_idx;
            {
                int ref_pos_max = curr_start_ref + 100;  // align_stride
                while (end_pair_idx < n_pairs &&
                       ap_ref[end_pair_idx] <= ref_pos_max)
                    end_pair_idx += 1;
                end_pair_idx = end_pair_idx < n_pairs ? end_pair_idx - 1
                                                      : n_pairs - 1;
            }
            int curr_end_ref = ap_ref[end_pair_idx];
            int curr_end_read = ap_read[end_pair_idx];
            if (do_base_rc)
                curr_end_read = (int)read_length - curr_end_read - K;
            int64_t s = curr_start_ref - ref_offset;
            int64_t l = curr_end_ref - curr_start_ref + 1;
            if (l < 2 * K) break;  // min sequence to align
            int input_event_stop_idx =
                get_closest_event_to(curr_end_read, b2e, n_b2e);
            int d = curr_start_event - input_event_stop_idx;
            if ((d < 0 ? -d : d) < 2) break;
            int event_stride = curr_start_event < input_event_stop_idx ? 1 : -1;

            profile_hmm_align(ref_codes + s, (int)l, ev_mean, shift, scale,
                              var, log_var, m_mean, m_stdv, m_log_stdv,
                              events_per_base, do_base_rc ? 1 : 0,
                              curr_start_event, input_event_stop_idx,
                              event_stride, ev_aln);

            int64_t num_output = 0;
            bool last_section = end_pair_idx == n_pairs - 1;
            int last_event_output = 0, last_ref_kmer_output = 0;
            for (size_t ai = 0; ai < ev_aln.size() &&
                                (num_output < 50 || last_section); ++ai) {
                const AlnState& as = ev_aln[ai];
                if (as.state != 'K' && as.event_idx != curr_start_event) {
                    if (n_out >= out_cap) return -1;
                    out_ref_pos[n_out] = curr_start_ref + as.kmer_idx;
                    out_event_idx[n_out] = as.event_idx;
                    out_state[n_out] = (uint8_t)as.state;
                    n_out += 1;
                    last_event_output = as.event_idx;
                    last_ref_kmer_output = curr_start_ref + as.kmer_idx;
                    num_output += 1;
                }
            }
            curr_start_event = last_event_output;
            curr_start_ref = last_ref_kmer_output;
            {
                int64_t pi = curr_pair_idx;
                while (pi < n_pairs && ap_ref[pi] <= curr_start_ref) pi += 1;
                curr_pair_idx = pi < n_pairs ? pi - 1 : n_pairs - 1;
            }
            if (num_output == 0) break;
        }
    }
    return n_out;
}

// -----------------------------------------------------------------------
// scaling_read (f5c.c scaling_single :1263-1330): postalign +
// recalibrate_model + QC gates, bit-exact with
// ops/oracle/eventalign.py::scaling_read — DOUBLE accumulation in the
// oracle's sequential order (numpy pairwise sums would drift the last
// ulp and flip QC gates), same M/E state rule (prev kmer rank over the
// expansion), same f32 stores.  This replaces a per-read Python pass.
// Returns 0 ok, 2 FAILED_ALIGNMENT, 1 FAILED_CALIBRATION,
// 4 FAILED_QUALITY_CHK (f5c.h:49-51 flag values).
extern "C" int32_t gt_eventalign_scaling(
    const uint8_t* seq_codes, int64_t seq_len,  // read codes, non-ACGT->0
    const int32_t* pair_k, const int32_t* pair_e, int64_t n_pairs,
    const float* ev_mean, const float* lm, const float* ls,
    float* sc_out,     // [4] shift, scale, var, log_var
    int32_t* b2e_out,  // [n_kmers * 2], -1 init done here
    double* epb_out) {
    const int64_t K = 6;
    const int64_t n_kmers = seq_len - K + 1;
    *epb_out = 0.0;
    for (int64_t i = 0; i < n_kmers * 2; i++) b2e_out[i] = -1;
    if (n_pairs == 0) return 2;  // FAILED_ALIGNMENT

    int32_t max_event = 0;
    int32_t min_event = INT32_MAX;
    int32_t prev_event_idx = -1;
    for (int64_t p = 0; p < n_pairs; p++) {
        const int32_t k_idx = pair_k[p];
        const int32_t event_idx = pair_e[p];
        if (event_idx != prev_event_idx) {
            if (b2e_out[k_idx * 2] == -1) b2e_out[k_idx * 2] = event_idx;
            b2e_out[k_idx * 2 + 1] = event_idx;
        }
        if (event_idx > max_event) max_event = event_idx;
        if (event_idx < min_event) min_event = event_idx;
        prev_event_idx = event_idx;
    }
    const double events_per_base =
        (double)(max_event - min_event) / (double)n_kmers;
    *epb_out = events_per_base;

    // rolling kmer ranks of the read sequence (rank per oracle
    // get_kmer_rank: kmer[0] in the HIGH bits)
    std::vector<int32_t> rank(n_kmers);
    {
        uint32_t r = 0;
        for (int64_t j = 0; j < K; j++)
            r = (r << 2) | (uint32_t)seq_codes[j];
        const uint32_t mask = (1u << (2 * K)) - 1;
        rank[0] = (int32_t)r;
        for (int64_t i = 1; i < n_kmers; i++) {
            r = ((r << 2) | (uint32_t)seq_codes[i + K - 1]) & mask;
            rank[i] = (int32_t)r;
        }
    }

    // expansion walk: collect M-state (rank, event) in oracle order
    std::vector<int32_t> m_rank;
    std::vector<int32_t> m_event;
    int64_t prev_kmer_rank = -1;
    for (int64_t ki = 0; ki < n_kmers; ki++) {
        const int32_t start = b2e_out[ki * 2];
        const int32_t stop = b2e_out[ki * 2 + 1];
        if (start == -1) continue;
        const int32_t kr = rank[ki];
        for (int32_t ev = start; ev <= stop; ev++) {
            if (prev_kmer_rank != (int64_t)kr) {
                m_rank.push_back(kr);
                m_event.push_back(ev);
            }
            prev_kmer_rank = (int64_t)kr;
        }
    }
    const int64_t num_m = (int64_t)m_rank.size();
    if (num_m < 200) return 1;  // FAILED_CALIBRATION (not calibrated)

    double A00 = 0.0, A01 = 0.0, A11 = 0.0, b0 = 0.0, b1 = 0.0;
    for (int64_t i = 0; i < num_m; i++) {
        const double e = (double)ev_mean[m_event[i]];
        const double mu = (double)lm[m_rank[i]];
        const double stdv = (double)ls[m_rank[i]];
        const double inv_var = 1.0 / (stdv * stdv);
        A00 += inv_var;
        A01 += mu * inv_var;
        A11 += mu * mu * inv_var;
        b0 += e * inv_var;
        b1 += mu * e * inv_var;
    }
    const double A10 = A01;
    const double div = A00 * A11 - A01 * A10;
    const double shift = -(A01 * b1 - A11 * b0) / div;
    const double scale = (A00 * b1 - A10 * b0) / div;
    double var = 0.0;
    for (int64_t i = 0; i < num_m; i++) {
        const double e = (double)ev_mean[m_event[i]];
        const double yi = e - shift - scale * (double)lm[m_rank[i]];
        const double stdv = (double)ls[m_rank[i]];
        var += yi * yi / (stdv * stdv);
    }
    var /= (double)num_m;
    var = sqrt(var);
    sc_out[0] = (float)shift;
    sc_out[1] = (float)scale;
    sc_out[2] = (float)var;
    sc_out[3] = (float)log(var);
    if ((double)sc_out[2] > 2.5) return 1;   // MIN_CALIBRATION_VAR
    if (events_per_base > 5.0) return 4;     // FAILED_QUALITY_CHK
    return 0;
}

// estimate_scalings_using_mom (align.c:49-95): sequential double sums
// (same ulp-exactness constraint as gt_eventalign_scaling).
extern "C" void gt_mom_scalings(const uint8_t* seq_codes, int64_t seq_len,
                                const float* ev_mean, int64_t n_events,
                                const float* lm, float* out_shift_scale) {
    const int64_t K = 6;
    const int64_t n_kmers = seq_len - K + 1;
    double event_level_sum = 0.0;
    for (int64_t i = 0; i < n_events; i++)
        event_level_sum += (double)ev_mean[i];
    double kmer_level_sum = 0.0, kmer_level_sq_sum = 0.0;
    {
        uint32_t r = 0;
        const uint32_t mask = (1u << (2 * K)) - 1;
        for (int64_t j = 0; j < K; j++)
            r = (r << 2) | (uint32_t)seq_codes[j];
        for (int64_t i = 0;; i++) {
            const double l = (double)lm[r];
            kmer_level_sum += l;
            kmer_level_sq_sum += l * l;
            if (i + 1 >= n_kmers) break;
            r = ((r << 2) | (uint32_t)seq_codes[i + K]) & mask;
        }
    }
    const double shift = event_level_sum / (double)n_events
                         - kmer_level_sum / (double)n_kmers;
    double event_level_sq_sum = 0.0;
    for (int64_t i = 0; i < n_events; i++) {
        const double x = (double)ev_mean[i];
        event_level_sq_sum += (x - shift) * (x - shift);
    }
    const double scale = (event_level_sq_sum / (double)n_events)
                         / (kmer_level_sq_sum / (double)n_kmers);
    out_shift_scale[0] = (float)shift;
    out_shift_scale[1] = (float)scale;
}

// ---------------------------------------------------------------------------
// TSV block emit (eventalign.c:1503-1531 emit_event_alignment_tsv).  The
// Python emitter's per-row f-string was ~30% of eventalign-mode wall time;
// this formats the whole read's rows into one buffer.  Byte-exactness with
// Python's "%.2f"-style formatting holds because glibc printf is correctly
// rounded (same shortest-fixed decimal as CPython's dtoa); the one divergence
// is negative NaN ("-nan" vs Python's "nan"), guarded explicitly.
static inline char* emit_f(char* w, double v, const char* fmt) {
    if (std::isnan(v)) { memcpy(w, "nan", 3); return w + 3; }
    return w + sprintf(w, fmt, v);
}

extern "C" int64_t gt_eventalign_emit(
    int64_t n, const int32_t* rp, const int32_t* ei,
    const uint8_t* kblob, const uint8_t* mkblob, int64_t kmer_size,
    const double* em, const double* es, const double* ed,
    const double* mm, const double* ms, const double* sl,
    const char* ref_name, const char* who,
    char* out, int64_t cap) {
    char* w = out;
    const int64_t reserve = 256 + kmer_size * 2
        + (int64_t)strlen(ref_name) + (int64_t)strlen(who);
    for (int64_t i = 0; i < n; i++) {
        if ((w - out) + reserve > cap) return -1;
        w += sprintf(w, "%s\t%d\t", ref_name, rp[i]);
        memcpy(w, kblob + i * kmer_size, kmer_size); w += kmer_size;
        w += sprintf(w, "\t%s\tt\t%d\t", who, ei[i]);
        w = emit_f(w, em[i], "%.2f"); *w++ = '\t';
        w = emit_f(w, es[i], "%.3f"); *w++ = '\t';
        w = emit_f(w, ed[i], "%.5f"); *w++ = '\t';
        memcpy(w, mkblob + i * kmer_size, kmer_size); w += kmer_size;
        *w++ = '\t';
        w = emit_f(w, mm[i], "%.2f"); *w++ = '\t';
        w = emit_f(w, ms[i], "%.2f"); *w++ = '\t';
        w = emit_f(w, sl[i], "%.2f"); *w++ = '\n';
    }
    return w - out;
}
