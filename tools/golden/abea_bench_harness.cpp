// Same-machine perf baseline for the reference's adaptive banded event
// alignment (f5c align.c:169-548 — the CPU path of the abea
// benchmark).  Takes pre-made event MEANS (the same inputs
// tools/abea_scale_bench.py feeds the fill: scale=1 shift=0,
// event detection and scaling out of scope on both sides) and times
// align() alone, best-of-reps.
//
// Usage: abea_bench <model.tsv> <cases.txt> [reps]
//   model.tsv — "kmer level_mean level_stdv" per line (k=6)
//   cases.txt — per read: sequence line; then "n mean1 ... meann"
// Prints: "reads=<n> events=<e> best_s=<s> events_per_s=<r> pairs=<p>"
#include <cmath>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "f5c.h"
#include "f5cmisc.h"

static uint32_t kmer_rank(const char* kmer, uint32_t k) {
    uint32_t r = 0;
    for (uint32_t i = 0; i < k; i++) {
        int code;
        switch (kmer[i]) {
            case 'A': code = 0; break;
            case 'C': code = 1; break;
            case 'G': code = 2; break;
            default: code = 3;
        }
        r = r * 4 + code;
    }
    return r;
}

static double now_s() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

int main(int argc, char** argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s <model.tsv> <cases.txt> [reps]\n",
                argv[0]);
        return 2;
    }
    const int reps = argc > 3 ? atoi(argv[3]) : 3;
    const uint32_t K = 6;
    std::vector<model_t> models(1 << (2 * K));
    {
        std::ifstream mf(argv[1]);
        std::string line;
        while (std::getline(mf, line)) {
            if (line.empty() || line[0] == '#' || line.rfind("kmer", 0) == 0)
                continue;
            std::istringstream ss(line);
            std::string kmer;
            double mean, stdv;
            ss >> kmer >> mean >> stdv;
            if (kmer.size() != K) continue;
            model_t& m = models[kmer_rank(kmer.c_str(), K)];
            m.level_mean = (float)mean;
            m.level_stdv = (float)stdv;
#ifdef CACHED_LOG
            m.level_log_stdv = (float)log((double)m.level_stdv);
#endif
        }
    }

    std::vector<std::string> seqs;
    std::vector<std::vector<event_t>> events;
    {
        std::ifstream cf(argv[2]);
        std::string seq;
        while (cf >> seq) {
            size_t n;
            cf >> n;
            std::vector<event_t> ev(n);
            for (size_t i = 0; i < n; i++) {
                float m;
                cf >> m;
                ev[i].start = (uint64_t)i;
                ev[i].length = 1.0f;
                ev[i].mean = m;
                ev[i].stdv = 0.0f;
            }
            seqs.push_back(seq);
            events.push_back(std::move(ev));
        }
    }
    long long total_events = 0;
    for (auto& e : events) total_events += (long long)e.size();

    scalings_t sc;
    sc.scale = 1.0f;
    sc.shift = 0.0f;
    sc.var = 1.0f;

    double best = 1e30;
    long long pairs_total = 0;
    for (int rep = 0; rep < reps; rep++) {
        pairs_total = 0;
        double t0 = now_s();
        for (size_t r = 0; r < seqs.size(); r++) {
            event_table et;
            et.n = events[r].size();
            et.event = events[r].data();
            std::vector<AlignedPair> out(et.n * 2 + 16);
            int32_t np = align(out.data(), (char*)seqs[r].c_str(),
                               (int32_t)seqs[r].size(), et, models.data(),
                               sc, /*sample_rate=*/4000.0f);
            if (np > 0) pairs_total += np;
        }
        double dt = now_s() - t0;
        if (dt < best) best = dt;
    }
    printf("reads=%zu events=%lld best_s=%.3f events_per_s=%.1f "
           "pairs=%lld\n",
           seqs.size(), total_events, best, (double)total_events / best,
           pairs_total);
    return 0;
}
