// Same-machine perf baseline for the reference's banded SWA — BOTH paths:
//   scalar  — scalarBandedSWA per pair (bandedSWA.cpp:130-251, the
//             semantic spec)
//   avx2    — getScores16 -> smithWatermanBatchWrapper16 ->
//             smithWaterman256_16, the 16-lane inter-pair SIMD path the
//             reference driver actually runs in production
//             (benchmarks/bsw/main_banded.cpp:909 -> bandedSWA.cpp:1153,
//             1447).  Links the HE-free upstream copy
//             (tools/bwa-mem2/src/bandedSWA.cpp — same production code
//             without the fork's ciphertext veneers).
//
// Usage: bsw_bench <pairs.txt> <scalar|avx2> [max_pairs] [reps]
//   pairs.txt: 3-line records "h0 [tl ql]\n<target digits>\n<query digits>"
//   (the repo's bsw_scale format; digit-coded bases, ACGT also accepted).
// Prints: "<mode> pairs=<n> best_s=<s> pairs_per_s=<r> sum_score=<c>"
// best-of-reps wall time; the score checksum pins scalar == avx2.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "bandedSWA.h"

static void fill_scmat(int a, int b, int ambig, int8_t mat[25]) {
    int i, j, k;
    for (i = k = 0; i < 4; ++i) {
        for (j = 0; j < 4; ++j) mat[k++] = i == j ? a : -b;
        mat[k++] = ambig;
    }
    for (j = 0; j < 5; ++j) mat[k++] = ambig;
}

static double now_s() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

int main(int argc, char** argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s <pairs.txt> <scalar|avx2> [max] [reps]\n",
                argv[0]);
        return 2;
    }
    const std::string mode = argv[2];
    const int64_t max_pairs = argc > 3 ? atoll(argv[3]) : 100000;
    const int reps = argc > 4 ? atoi(argv[4]) : 3;

    FILE* f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 1; }
    std::vector<SeqPair> pairs;
    std::vector<uint8_t> bufRef, bufQer;
    char line[8192];
    while ((int64_t)pairs.size() < max_pairs && fgets(line, sizeof line, f)) {
        SeqPair sp;
        memset(&sp, 0, sizeof sp);
        sp.h0 = atoi(line);
        if (!fgets(line, sizeof line, f)) break;
        sp.idr = (int32_t)bufRef.size();
        int32_t l1 = 0;
        for (char* p = line; *p && *p != '\n'; p++, l1++) {
            uint8_t c = (uint8_t)*p;
            if (c >= '0' && c <= '4') c -= '0';
            else c = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2
                    : c == 'T' ? 3 : 4;
            bufRef.push_back(c);
        }
        sp.len1 = l1;
        if (!fgets(line, sizeof line, f)) break;
        sp.idq = (int32_t)bufQer.size();
        int32_t l2 = 0;
        for (char* p = line; *p && *p != '\n'; p++, l2++) {
            uint8_t c = (uint8_t)*p;
            if (c >= '0' && c <= '4') c -= '0';
            else c = c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2
                    : c == 'T' ? 3 : 4;
            bufQer.push_back(c);
        }
        sp.len2 = l2;
        sp.id = (int)pairs.size();
        sp.seqid = sp.regid = 0;
        pairs.push_back(sp);
    }
    fclose(f);
    const int64_t n = (int64_t)pairs.size();
    // pad to SIMD width + prefetch slack (the wrapper reads
    // pairArray[i + j + PFD] ahead of the live range)
    const int64_t padded = ((n + SIMD_WIDTH16 - 1) / SIMD_WIDTH16)
                           * SIMD_WIDTH16 + 64;
    pairs.resize(padded);
    for (int64_t k = n; k < padded; k++) {
        memset(&pairs[k], 0, sizeof(SeqPair));
        pairs[k].id = (int)k;
    }
    bufRef.resize(bufRef.size() + 64, 0);
    bufQer.resize(bufQer.size() + 64, 0);

    int8_t mat[25];
    fill_scmat(1, 4, -1, mat);  // main_banded.cpp:53-57 defaults
    BandedPairWiseSW bsw(6, 1, 6, 1, 100, 5, mat, 1, 4, 1);
    const int32_t w = 100;

    double best = 1e30;
    long long sum = 0;
    std::vector<SeqPair> work(pairs);  // the avx2 wrapper reorders/writes
    for (int rep = 0; rep < reps; rep++) {
        std::copy(pairs.begin(), pairs.end(), work.begin());
        double t0 = now_s();
        if (mode == "scalar") {
            for (int64_t k = 0; k < n; k++) {
                SeqPair& sp = work[k];
                int qle, tle, gtle, gscore, max_off;
                sp.score = bsw.scalarBandedSWA(
                    sp.len2, bufQer.data() + sp.idq, sp.len1,
                    bufRef.data() + sp.idr, w, sp.h0, &qle, &tle, &gtle,
                    &gscore, &max_off);
            }
        } else {
            bsw.getScores16(work.data(), bufRef.data(), bufQer.data(),
                            (int32_t)n, 1, w);
        }
        double dt = now_s() - t0;
        if (dt < best) best = dt;
        sum = 0;
        for (int64_t k = 0; k < padded; k++)
            if (work[k].id < n) sum += work[k].score;
    }
    printf("%s pairs=%lld best_s=%.4f pairs_per_s=%.1f sum_score=%lld\n",
           mode.c_str(), (long long)n, best, (double)n / best, sum);
    return 0;
}
