// Native convex graph-alignment engine (spoa SisdAlignmentEngine
// semantics — the host half of the poa dual-engine split, same
// precedent as fmi/kmer: graph DP is byte-chasing CPU-shaped work at
// small window sizes, and the reference's own SISD engine runs on one
// core).  Semantic contract is ops/oracle/poa.py::convex_align (itself
// cited to tools/spoa/src/sisd_alignment_engine.cpp:94-241,659-907):
// identical matrix values, max-cell choice (first max in rank-then-
// column order via strict <), traceback priority order (diag over
// preds, vertical over preds with extend-up, horizontal with
// extend-left) and both repair loops.  Tests assert native == oracle
// alignments on full multi-round consensus runs (nw/sw/ov).
//
// Fill layout: per row, pass 1 accumulates the predecessor-row terms
// (F/O gap-opens+extends and the diagonal H+profile) in stride-1 loops
// the compiler vectorizes; pass 2 is the sequential E/Q/H combine (the
// intra-row coupled recurrence, ~4-cycle dependency chain per cell).

#include <ctime>

#include "poagraph.h"

namespace gtpoa {
namespace {

constexpr int32_t NEG_INF = -(1 << 30);  // oracle/poa.py NEG_INF

struct Scratch {
    std::vector<int32_t> H, F, O, E, Q, prof, preds;
    std::vector<int32_t> node_rank;
};

Scratch& scratch() {
    thread_local Scratch s;
    return s;
}

// predecessor-row passes as standalone functions with __restrict
// parameters: distinct matrix rows never overlap, but through derived
// pointers the vectorizer needed >10 alias-version checks and gave up
// (the whole fill ran scalar).
void pred_first(int32_t* __restrict Fi, int32_t* __restrict Oi,
                int32_t* __restrict Hi, const int32_t* __restrict Hp,
                const int32_t* __restrict Fp, const int32_t* __restrict Op,
                const int32_t* __restrict prof, int64_t w, int32_t go,
                int32_t ge, int32_t qo, int32_t qe) {
    for (int64_t j = 1; j < w; j++) {
        const int32_t f = Hp[j] + go, fe = Fp[j] + ge;
        Fi[j] = f > fe ? f : fe;
        const int32_t o = Hp[j] + qo, oc = Op[j] + qe;
        Oi[j] = o > oc ? o : oc;
        Hi[j] = Hp[j - 1] + prof[j];
    }
}

void pred_more(int32_t* __restrict Fi, int32_t* __restrict Oi,
               int32_t* __restrict Hi, const int32_t* __restrict Hp,
               const int32_t* __restrict Fp, const int32_t* __restrict Op,
               const int32_t* __restrict prof, int64_t w, int32_t go,
               int32_t ge, int32_t qo, int32_t qe) {
    for (int64_t j = 1; j < w; j++) {
        int32_t f = Hp[j] + go;
        const int32_t fe = Fp[j] + ge;
        if (fe > f) f = fe;
        if (f > Fi[j]) Fi[j] = f;
        int32_t o = Hp[j] + qo;
        const int32_t oc = Op[j] + qe;
        if (oc > o) o = oc;
        if (o > Oi[j]) Oi[j] = o;
        const int32_t d = Hp[j - 1] + prof[j];
        if (d > Hi[j]) Hi[j] = d;
    }
}

// single-pred fast path (the overwhelmingly common row shape): also
// folds base = max(diag, F, O) into Hi so the sequential combine pass
// only chains E/Q — H's intermediate value is never needed again
// (traceback reads only the FINAL matrices).
void pred_single(int32_t* __restrict Fi, int32_t* __restrict Oi,
                 int32_t* __restrict Hi, const int32_t* __restrict Hp,
                 const int32_t* __restrict Fp, const int32_t* __restrict Op,
                 const int32_t* __restrict prof, int64_t w, int32_t go,
                 int32_t ge, int32_t qo, int32_t qe) {
    for (int64_t j = 1; j < w; j++) {
        const int32_t f = Hp[j] + go, fe = Fp[j] + ge;
        const int32_t fv = f > fe ? f : fe;
        Fi[j] = fv;
        const int32_t o = Hp[j] + qo, oc = Op[j] + qe;
        const int32_t ov = o > oc ? o : oc;
        Oi[j] = ov;
        int32_t hv = Hp[j - 1] + prof[j];
        if (fv > hv) hv = fv;
        if (ov > hv) hv = ov;
        Hi[j] = hv;
    }
}

// multi-pred epilogue: fold F/O into the H base (vectorized)
void combine_base(int32_t* __restrict Hi, const int32_t* __restrict Fi,
                  const int32_t* __restrict Oi, int64_t w) {
    for (int64_t j = 1; j < w; j++) {
        int32_t hv = Hi[j];
        if (Fi[j] > hv) hv = Fi[j];
        if (Oi[j] > hv) hv = Oi[j];
        Hi[j] = hv;
    }
}

}  // namespace

int64_t convex_align(PoaG& g, const char* seq, int64_t seq_len,
                     int32_t m, int32_t n, int32_t go, int32_t ge,
                     int32_t qo, int32_t qe, int32_t type,
                     int32_t* out_nid, int32_t* out_pos, int64_t cap) {
    const int64_t nn = (int64_t)g.nodes.size();
    if (nn == 0 || seq_len == 0) return 0;
    const int64_t w = seq_len + 1;
    const int64_t h = nn + 1;
    Scratch& S = scratch();
    S.H.resize(h * w);
    S.F.resize(h * w);
    S.O.resize(h * w);
    S.E.resize(h * w);
    S.Q.resize(h * w);
    int32_t* H = S.H.data();
    int32_t* F = S.F.data();
    int32_t* O = S.O.data();
    int32_t* E = S.E.data();
    int32_t* Q = S.Q.data();
    S.node_rank.resize(nn);
    int32_t* node_rank = S.node_rank.data();
    for (int64_t r = 0; r < nn; r++) node_rank[g.rank[r]] = (int32_t)r;

    // profiles: prof[code * w + j] = match/mismatch vs seq[j-1]
    const int64_t ncodes = (int64_t)g.decoder.size();
    S.prof.resize(ncodes * w);
    for (int64_t code = 0; code < ncodes; code++) {
        const char ch = g.decoder[code];
        int32_t* p = S.prof.data() + code * w;
        p[0] = 0;
        for (int64_t j = 1; j < w; j++) p[j] = ch == seq[j - 1] ? m : n;
    }

    // ---- boundary row 0 (initialize(): convex gap chains) ----
    H[0] = F[0] = O[0] = E[0] = Q[0] = 0;
    for (int64_t j = 1; j < w; j++) {
        O[j] = NEG_INF;
        Q[j] = qo + (int32_t)(j - 1) * qe;
        F[j] = NEG_INF;
        E[j] = go + (int32_t)(j - 1) * ge;
        H[j] = type == 1 ? 0 : (Q[j] > E[j] ? Q[j] : E[j]);  // sw: zero row
    }
    // ---- boundary column 0 (per-row, from predecessor rows) ----
    for (int64_t r = 1; r < h; r++) {
        const PNode& nd = g.nodes[g.rank[r - 1]];
        int32_t pen_o = nd.in_e.empty() ? qo - qe : NEG_INF;
        int32_t pen_f = nd.in_e.empty() ? go - ge : NEG_INF;
        for (int32_t ei : nd.in_e) {
            const int64_t pi = node_rank[g.edges[ei].begin] + 1;
            if (O[pi * w] > pen_o) pen_o = O[pi * w];
            if (F[pi * w] > pen_f) pen_f = F[pi * w];
        }
        O[r * w] = pen_o + qe;
        Q[r * w] = NEG_INF;
        F[r * w] = pen_f + ge;
        E[r * w] = NEG_INF;
        H[r * w] = type == 0 ? (O[r * w] > F[r * w] ? O[r * w] : F[r * w])
                             : 0;  // H col 0 from gap chains for kNW only
    }

    // ---- fill (rank order; i = rank + 1) ----
    int32_t max_score = type == 1 ? 0 : NEG_INF;
    int64_t max_i = -1, max_j = -1;
    for (int64_t i = 1; i < h; i++) {
        const PNode& nd = g.nodes[g.rank[i - 1]];
        const int32_t* prof = S.prof.data() + (int64_t)nd.code * w;
        int32_t* Hi = H + i * w;
        int32_t* Fi = F + i * w;
        int32_t* Oi = O + i * w;
        int32_t* Ei = E + i * w;
        int32_t* Qi = Q + i * w;
        // predecessor pass (vectorizable stride-1 max/add streams)
        bool first = true;
        S.preds.clear();
        for (int32_t ei : nd.in_e)
            S.preds.push_back(node_rank[g.edges[ei].begin] + 1);
        if (S.preds.empty()) S.preds.push_back(0);
        if (S.preds.size() == 1) {
            const int64_t pi = S.preds[0];
            pred_single(Fi, Oi, Hi, H + pi * w, F + pi * w, O + pi * w,
                        prof, w, go, ge, qo, qe);
        } else {
            for (int32_t pi : S.preds) {
                const int32_t* Hp = H + (int64_t)pi * w;
                const int32_t* Fp = F + (int64_t)pi * w;
                const int32_t* Op = O + (int64_t)pi * w;
                if (first) {
                    pred_first(Fi, Oi, Hi, Hp, Fp, Op, prof, w, go, ge, qo,
                               qe);
                    first = false;
                } else {
                    pred_more(Fi, Oi, Hi, Hp, Fp, Op, prof, w, go, ge, qo,
                              qe);
                }
            }
            combine_base(Hi, Fi, Oi, w);
        }
        // sequential combine: E/Q couple through H within the row
        // (Hi already holds max(diag, F, O) from the passes above)
        int32_t hprev = Hi[0], eprev = Ei[0], qprev = Qi[0];
        const bool sink = nd.out_e.empty();
        if (type == 0) {  // nw: hit only at (sink row, last column)
            for (int64_t j = 1; j < w; j++) {
                const int32_t e1 = hprev + go, e2 = eprev + ge;
                const int32_t ev = e1 > e2 ? e1 : e2;
                const int32_t q1 = hprev + qo, q2 = qprev + qe;
                const int32_t qv = q1 > q2 ? q1 : q2;
                Ei[j] = ev;
                Qi[j] = qv;
                int32_t hv = Hi[j];
                if (ev > hv) hv = ev;
                if (qv > hv) hv = qv;
                Hi[j] = hv;
                hprev = hv;
                eprev = ev;
                qprev = qv;
            }
            if (sink && max_score < Hi[w - 1]) {
                max_score = Hi[w - 1];
                max_i = i;
                max_j = w - 1;
            }
        } else {  // sw (clamp at 0, hit everywhere) / ov (hit on sinks)
            const bool sw = type == 1;
            const bool track = sw || sink;
            for (int64_t j = 1; j < w; j++) {
                const int32_t e1 = hprev + go, e2 = eprev + ge;
                const int32_t ev = e1 > e2 ? e1 : e2;
                const int32_t q1 = hprev + qo, q2 = qprev + qe;
                const int32_t qv = q1 > q2 ? q1 : q2;
                Ei[j] = ev;
                Qi[j] = qv;
                int32_t hv = Hi[j];
                if (ev > hv) hv = ev;
                if (qv > hv) hv = qv;
                if (sw && hv < 0) hv = 0;
                Hi[j] = hv;
                hprev = hv;
                eprev = ev;
                qprev = qv;
                if (track && max_score < hv) {
                    max_score = hv;
                    max_i = i;
                    max_j = j;
                }
            }
        }
    }
    if (max_i < 0) return 0;  // sw: no positive cell -> empty alignment

    // ---- traceback (oracle :352-444; type-dependent stop) ----
    int64_t i = max_i, j = max_j, cnt = 0;
    auto more = [&]() -> bool {
        if (type == 1) return H[i * w + j] != 0;
        if (type == 2) return !(i == 0 || j == 0);
        return !(i == 0 && j == 0);
    };
    while (more()) {
        const int32_t h_ij = H[i * w + j];
        bool found = false, extend_left = false, extend_up = false;
        int64_t prev_i = 0, prev_j = 0;
        if (i != 0 && j != 0) {
            const PNode& nd = g.nodes[g.rank[i - 1]];
            const int32_t mc = S.prof[(int64_t)nd.code * w + j];
            S.preds.clear();
            for (int32_t ei : nd.in_e)
                S.preds.push_back(node_rank[g.edges[ei].begin] + 1);
            if (S.preds.empty()) S.preds.push_back(0);
            for (int32_t pi : S.preds) {
                if (h_ij == H[(int64_t)pi * w + j - 1] + mc) {
                    prev_i = pi;
                    prev_j = j - 1;
                    found = true;
                    break;
                }
            }
        }
        if (!found && i != 0) {
            const PNode& nd = g.nodes[g.rank[i - 1]];
            S.preds.clear();
            for (int32_t ei : nd.in_e)
                S.preds.push_back(node_rank[g.edges[ei].begin] + 1);
            if (S.preds.empty()) S.preds.push_back(0);
            for (int32_t pi : S.preds) {
                const int64_t p = (int64_t)pi * w + j;
                const bool c1 = h_ij == F[p] + ge;
                const bool c2 = h_ij == H[p] + go;
                const bool c3 = h_ij == O[p] + qe;
                const bool c4 = h_ij == H[p] + qo;
                if (c1 || c2 || c3 || c4) {
                    extend_up |= c1 || (!c2 && c3);
                    prev_i = pi;
                    prev_j = j;
                    found = true;
                    break;
                }
            }
        }
        if (!found && j != 0) {
            const int64_t p = i * w + j - 1;
            const bool c1 = h_ij == E[p] + ge;
            const bool c2 = h_ij == H[p] + go;
            const bool c3 = h_ij == Q[p] + qe;
            const bool c4 = h_ij == H[p] + qo;
            if (c1 || c2 || c3 || c4) {
                extend_left |= c1 || (!c2 && c3);
                prev_i = i;
                prev_j = j - 1;
                found = true;
            }
        }
        if (cnt >= cap) return -1;
        out_nid[cnt] = i == prev_i ? -1 : g.rank[i - 1];
        out_pos[cnt] = j == prev_j ? -1 : (int32_t)(j - 1);
        cnt++;
        i = prev_i;
        j = prev_j;

        if (extend_left) {
            while (true) {
                if (cnt >= cap) return -1;
                out_nid[cnt] = -1;
                out_pos[cnt] = (int32_t)(j - 1);
                cnt++;
                j -= 1;
                const int64_t p = i * w + j;
                if (E[p] + ge != E[p + 1] && Q[p] + qe != Q[p + 1]) break;
            }
        } else if (extend_up) {
            while (true) {
                bool stop = true;
                int64_t up_i = 0;
                const PNode& nd = g.nodes[g.rank[i - 1]];
                for (int32_t ei : nd.in_e) {
                    const int64_t pi = node_rank[g.edges[ei].begin] + 1;
                    if (F[i * w + j] == F[pi * w + j] + ge
                        || O[i * w + j] == O[pi * w + j] + qe) {
                        up_i = pi;
                        stop = false;
                        break;
                    }
                }
                if (stop) {
                    for (int32_t ei : nd.in_e) {
                        const int64_t pi = node_rank[g.edges[ei].begin] + 1;
                        if (F[i * w + j] == H[pi * w + j] + go
                            || O[i * w + j] == H[pi * w + j] + qo) {
                            up_i = pi;
                            break;
                        }
                    }
                }
                if (cnt >= cap) return -1;
                out_nid[cnt] = g.rank[i - 1];
                out_pos[cnt] = -1;
                cnt++;
                i = up_i;
                if (stop || i == 0) break;
            }
        }
    }
    // reverse into oracle order
    for (int64_t a = 0, b = cnt - 1; a < b; a++, b--) {
        std::swap(out_nid[a], out_nid[b]);
        std::swap(out_pos[a], out_pos[b]);
    }
    return cnt;
}

}  // namespace gtpoa

extern "C" int64_t gt_poa_align(void* gp, const char* seq, int64_t seq_len,
                                int32_t m, int32_t n, int32_t go, int32_t ge,
                                int32_t qo, int32_t qe, int32_t type,
                                int32_t* out_nid, int32_t* out_pos,
                                int64_t cap) {
    return gtpoa::convex_align(*static_cast<gtpoa::PoaG*>(gp), seq, seq_len,
                               m, n, go, ge, qo, qe, type, out_nid, out_pos,
                               cap);
}

// Full per-window MSA loop in one call (align + add_alignment per
// sequence, then heaviest-bundle consensus) — the reference driver's
// per-batch body (msa_spoa_omp.cpp:364,441-458) with zero Python in
// the loop.  phase_s (nullable, 3 doubles) receives align / add /
// consensus seconds matching the driver's printed phase split.
extern "C" int64_t gt_poa_msa_window(const char* seqs, const int64_t* offs,
                                     const int32_t* lens, int64_t nseqs,
                                     int32_t m, int32_t n, int32_t go,
                                     int32_t ge, int32_t qo, int32_t qe,
                                     char* cons_out, int64_t cons_cap,
                                     double* phase_s) {
    struct Clock {
        static double now() {
            struct timespec ts;
            clock_gettime(CLOCK_MONOTONIC, &ts);
            return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
        }
    };
    gtpoa::PoaG g;
    std::vector<int32_t> nid, pos;
    double t_align = 0, t_add = 0;
    for (int64_t s = 0; s < nseqs; s++) {
        const char* seq = seqs + offs[s];
        const int64_t len = lens[s];
        int64_t cap = (int64_t)g.nodes.size() + len + 8;
        nid.resize(cap);
        pos.resize(cap);
        double t0 = Clock::now();
        int64_t cnt = gtpoa::convex_align(g, seq, len, m, n, go, ge, qo, qe,
                                          0, nid.data(), pos.data(), cap);
        while (cnt < 0) {  // cap bound is exact in theory; belt+braces
            cap *= 2;
            nid.resize(cap);
            pos.resize(cap);
            cnt = gtpoa::convex_align(g, seq, len, m, n, go, ge, qo, qe, 0,
                                      nid.data(), pos.data(), cap);
        }
        double t1 = Clock::now();
        g.add_alignment(nid.data(), pos.data(), cnt, seq, len);
        double t2 = Clock::now();
        t_align += t1 - t0;
        t_add += t2 - t1;
    }
    double t0 = Clock::now();
    int64_t out_len = 0;
    if (!g.rank.empty()) {
        g.traverse_heaviest_bundle();
        if ((int64_t)g.consensus.size() > cons_cap) return -1;
        for (size_t i = 0; i < g.consensus.size(); i++)
            cons_out[i] = g.decoder[g.nodes[g.consensus[i]].code];
        out_len = (int64_t)g.consensus.size();
    }
    if (phase_s) {
        phase_s[0] += t_align;
        phase_s[1] += t_add;
        phase_s[2] += Clock::now() - t0;
    }
    return out_len;
}
