// medaka pileup event extraction (benchmarks/pileup/medaka_counts.c
// counting loop).  Semantic contract is ops/pileup.py::_read_events_fast
// / read_events: same per-cigar-op expansion (M/=/X bases, insertions
// anchored after M or D, deletion rows, qstrat clamp), batched over all
// records in one call.  The (vectorized-numpy) Python path remains the
// spec and the weibull path.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Handle {
    std::vector<int64_t> pos, minor, feat, qstrat, ins_pos, ins_len;
    std::vector<int32_t> rec_id;
};

}  // namespace

extern "C" void* gt_pileup_events(
    const uint8_t* seq, const uint8_t* qual, const int64_t* seq_off,
    const uint32_t* cigar, const int64_t* cigar_off,
    const int64_t* rpos, const uint8_t* rev, int64_t n_records,
    const int64_t* num2countbase,  // [32] lookup (python's table, -1 skip)
    int64_t del_feat_fwd, int64_t del_feat_rev, int64_t num_homop) {
    auto* h = new Handle();
    // BAM cigar op nibbles: MIDNSHP=X -> 0..8
    for (int64_t r = 0; r < n_records; r++) {
        const uint8_t* s = seq + seq_off[r];
        const uint8_t* q = qual + seq_off[r];
        int64_t rp = rpos[r];
        int64_t qp = 0;
        const int64_t rev_off = rev[r] ? 16 : 0;
        const int64_t del_feat = rev[r] ? del_feat_rev : del_feat_fwd;
        const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];

        auto emit = [&](int64_t q_idx, int64_t r_pos, int64_t minor_val) {
            const int64_t bi = num2countbase[s[q_idx] + rev_off];
            if (bi == -1) return;
            int64_t qs = 0;
            if (num_homop > 1) {
                qs = q[q_idx];
                if (qs > num_homop) qs = num_homop;
                qs -= 1;
                if (qs < 0) qs = 0;
            }
            h->pos.push_back(r_pos);
            h->minor.push_back(minor_val);
            h->feat.push_back(bi);
            h->qstrat.push_back(qs);
            h->rec_id.push_back((int32_t)r);
        };

        for (int64_t ci = c0; ci < c1; ci++) {
            const uint32_t w = cigar[ci];
            const int64_t op = w & 0xF;
            const int64_t ln = w >> 4;
            if (op == 0 || op == 7 || op == 8) {  // M, =, X
                for (int64_t t = 0; t < ln; t++) emit(qp + t, rp + t, 0);
                if (ci + 1 < c1 && (cigar[ci + 1] & 0xF) == 1) {  // I next
                    const int64_t ili = cigar[ci + 1] >> 4;
                    const int64_t anchor_r = rp + ln - 1;
                    const int64_t anchor_q = qp + ln - 1;
                    h->ins_pos.push_back(anchor_r);
                    h->ins_len.push_back(ili);
                    for (int64_t j = 1; j <= ili; j++)
                        emit(anchor_q + j, anchor_r, j);
                }
                rp += ln;
                qp += ln;
            } else if (op == 2) {  // D
                for (int64_t t = 0; t < ln; t++) {
                    h->pos.push_back(rp + t);
                    h->minor.push_back(0);
                    h->feat.push_back(del_feat);
                    h->qstrat.push_back(0);
                    h->rec_id.push_back((int32_t)r);
                }
                if (ci + 1 < c1 && (cigar[ci + 1] & 0xF) == 1) {
                    h->ins_pos.push_back(rp + ln - 1);
                    h->ins_len.push_back(cigar[ci + 1] >> 4);
                }
                rp += ln;
            } else if (op == 1 || op == 4) {  // I, S consume query
                qp += ln;
            } else if (op == 3) {  // N consumes reference
                rp += ln;
            }
            // H, P consume nothing
        }
    }
    return h;
}

extern "C" int64_t gt_pileup_n_events(void* hp) {
    return (int64_t)static_cast<Handle*>(hp)->pos.size();
}

extern "C" int64_t gt_pileup_n_ins(void* hp) {
    return (int64_t)static_cast<Handle*>(hp)->ins_pos.size();
}

extern "C" void gt_pileup_copy(void* hp, int64_t* pos, int64_t* minor,
                               int64_t* feat, int64_t* qstrat,
                               int32_t* rec_id, int64_t* ins_pos,
                               int64_t* ins_len) {
    auto* h = static_cast<Handle*>(hp);
    auto cp = [](auto& v, auto* dst) {
        for (std::size_t i = 0; i < v.size(); i++) dst[i] = v[i];
    };
    cp(h->pos, pos);
    cp(h->minor, minor);
    cp(h->feat, feat);
    cp(h->qstrat, qstrat);
    cp(h->rec_id, rec_id);
    cp(h->ins_pos, ins_pos);
    cp(h->ins_len, ins_len);
}

extern "C" void gt_pileup_free(void* hp) { delete static_cast<Handle*>(hp); }

// ---------------------------------------------------------------------
// Zero-storage pileup: pass 1 (layout) walks cigars once computing
// coverage + insertion widths + the column layout WITHOUT touching
// bases; pass 2 (fill) re-walks emitting each event straight into the
// caller-allocated matrix.  No per-event vectors (the handle-based
// path above stores 40 B/event; this is the production region path).

namespace {

struct LayoutHandle {
    int64_t start, end, n_cols;
    std::vector<int32_t> slot_of;    // [end-start], -1 = uncovered
    std::vector<int64_t> col_start;  // [n_pos+1]
    std::vector<int64_t> width;      // [n_pos]
    std::vector<int64_t> covered;    // [n_pos]
};

}  // namespace

extern "C" void* gt_pileup_layout(
    const uint32_t* cigar, const int64_t* cigar_off, const int64_t* rpos,
    const int32_t* span, int64_t n_records, int64_t start, int64_t end) {
    auto* L = new LayoutHandle();
    L->start = start;
    L->end = end;
    const int64_t rlen = end - start;
    std::vector<uint8_t> cover(rlen, 0);
    for (int64_t r = 0; r < n_records; r++) {
        int64_t s = rpos[r] > start ? rpos[r] : start;
        int64_t e = rpos[r] + (int64_t)span[r];
        if (e > end) e = end;
        if (e > s) std::memset(cover.data() + (s - start), 1,
                               (size_t)(e - s));
    }
    // insertion anchors from a cigar-op walk (no per-base work):
    // max insertion length per anchored ref position
    std::vector<int64_t> ins_w(rlen, 0);
    for (int64_t r = 0; r < n_records; r++) {
        int64_t rp = rpos[r];
        const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];
        for (int64_t ci = c0; ci < c1; ci++) {
            const uint32_t w = cigar[ci];
            const int64_t op = w & 0xF;
            const int64_t ln = w >> 4;
            if (op == 0 || op == 7 || op == 8 || op == 2) {  // M,=,X,D
                if (ci + 1 < c1 && (cigar[ci + 1] & 0xF) == 1) {
                    const int64_t a = rp + ln - 1;
                    const int64_t il = cigar[ci + 1] >> 4;
                    if (a >= start && a < end && il > ins_w[a - start])
                        ins_w[a - start] = il;
                }
                rp += ln;
            } else if (op == 3) {
                rp += ln;
            }
        }
    }
    L->slot_of.assign(rlen, -1);
    for (int64_t p = 0; p < rlen; p++) {
        if (cover[p]) {
            L->slot_of[p] = (int32_t)L->covered.size();
            L->covered.push_back(start + p);
            L->width.push_back(cover[p] && ins_w[p] ? ins_w[p] + 1 : 1);
        }
    }
    const int64_t n_pos = (int64_t)L->covered.size();
    L->col_start.resize(n_pos + 1);
    L->col_start[0] = 0;
    for (int64_t i = 0; i < n_pos; i++)
        L->col_start[i + 1] = L->col_start[i] + L->width[i];
    L->n_cols = L->col_start[n_pos];
    return L;
}

extern "C" int64_t gt_pileup_layout_cols(void* lp) {
    return static_cast<LayoutHandle*>(lp)->n_cols;
}

extern "C" void gt_pileup_fill(
    void* lp, const uint8_t* seq, const uint8_t* qual,
    const int64_t* seq_off, const uint32_t* cigar, const int64_t* cigar_off,
    const int64_t* rpos, const uint8_t* rev, int64_t n_records,
    const int64_t* num2countbase, int64_t del_feat_fwd,
    int64_t del_feat_rev, int64_t num_homop, int64_t featlen,
    int64_t* major, int64_t* minor, int32_t* matrix) {
    auto* L = static_cast<LayoutHandle*>(lp);
    const int64_t start = L->start, end = L->end;
    const int64_t W = featlen * num_homop;
    const int64_t n_pos = (int64_t)L->covered.size();
    for (int64_t i = 0; i < n_pos; i++) {
        for (int64_t j = 0; j < L->width[i]; j++) {
            major[L->col_start[i] + j] = L->covered[i];
            minor[L->col_start[i] + j] = j;
        }
    }
    const int32_t* slot_of = L->slot_of.data();
    const int64_t* col_start = L->col_start.data();
    const int64_t* width = L->width.data();
    for (int64_t r = 0; r < n_records; r++) {
        const uint8_t* s = seq + seq_off[r];
        const uint8_t* q = qual + seq_off[r];
        int64_t rp = rpos[r];
        int64_t qp = 0;
        const int64_t rev_off = rev[r] ? 16 : 0;
        const int64_t del_feat = rev[r] ? del_feat_rev : del_feat_fwd;
        const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];

        auto emit = [&](int64_t q_idx, int64_t r_pos, int64_t minor_val) {
            if (r_pos < start || r_pos >= end) return;
            const int64_t bi = num2countbase[s[q_idx] + rev_off];
            if (bi == -1) return;
            const int32_t sl = slot_of[r_pos - start];
            if (minor_val >= width[sl]) return;
            int64_t qs = 0;
            if (num_homop > 1) {
                qs = q[q_idx];
                if (qs > num_homop) qs = num_homop;
                qs -= 1;
                if (qs < 0) qs = 0;
            }
            matrix[(col_start[sl] + minor_val) * W + bi + featlen * qs]++;
        };

        for (int64_t ci = c0; ci < c1; ci++) {
            const uint32_t w = cigar[ci];
            const int64_t op = w & 0xF;
            const int64_t ln = w >> 4;
            if (op == 0 || op == 7 || op == 8) {  // M, =, X
                for (int64_t t = 0; t < ln; t++) emit(qp + t, rp + t, 0);
                if (ci + 1 < c1 && (cigar[ci + 1] & 0xF) == 1) {  // I next
                    const int64_t ili = cigar[ci + 1] >> 4;
                    const int64_t anchor_r = rp + ln - 1;
                    const int64_t anchor_q = qp + ln - 1;
                    for (int64_t j = 1; j <= ili; j++)
                        emit(anchor_q + j, anchor_r, j);
                }
                rp += ln;
                qp += ln;
            } else if (op == 2) {  // D
                for (int64_t t = 0; t < ln; t++) {
                    const int64_t r_pos = rp + t;
                    if (r_pos < start || r_pos >= end) continue;
                    const int32_t sl = slot_of[r_pos - start];
                    matrix[col_start[sl] * W + del_feat]++;
                }
                rp += ln;
            } else if (op == 1 || op == 4) {  // I, S consume query
                qp += ln;
            } else if (op == 3) {  // N consumes reference
                rp += ln;
            }
        }
    }
}

extern "C" void gt_pileup_layout_free(void* lp) {
    delete static_cast<LayoutHandle*>(lp);
}
