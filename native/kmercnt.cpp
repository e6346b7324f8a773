// Native host k-mer counting engine (the Flye vertex_index role,
// benchmarks/kmer-cnt/vertex_index.cpp:657-658 metrics contract).
//
// Counting at dataset scale is a random-access hash workload — the same
// CPU-shaped regime as FM-index seeding, where this framework already
// ships a host engine beside the device one.  The device sort-reduce
// pipeline (ops/kmer.py) stays the bench/multi-device path.  This
// single pass uses a rolling canonical code and an open-addressing
// table; at Gbp scale every probe is a DRAM round-trip, and
// prefetch-blocked probing + interleaved 16 B slots keep that regime
// memory-level-parallel and one-line-per-probe.
//
// Semantics are IDENTICAL to ops/kmer.count_kmers (tests pin equality):
// 2-bit codes with the N->3 quirk, len-k windows per read (the
// iterator stops one short of the last full window), canonical =
// min(code, revcomp) as a 64-bit compare, metrics = distinct /
// count(freq > saturation) / total windows.

#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <vector>

namespace {

// THP-backed table storage: at GB scale every probe is a TLB miss on
// 4 KB pages (the fmi hostpack32 sidecar plays the same trick).
void* huge_alloc(size_t bytes) {
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    madvise(p, bytes, MADV_HUGEPAGE);
    return p;
}

}  // namespace

extern "C" {

// Returns 0 ok; 1 = table load exceeded ~90% (caller retries with a
// larger log2_slots).
int32_t gt_kmer_count(const int8_t* codes, const int64_t* offs,
                      const int32_t* lens, int64_t n_reads, int32_t k,
                      int32_t min_len, int32_t saturation,
                      int32_t log2_slots, int64_t* total_kmers,
                      int64_t* hash_size, int64_t* occurrences) {
    const int64_t slots = 1LL << log2_slots;
    const int64_t mask = slots - 1;
    const int64_t limit = slots - slots / 10;  // 90% load cap
    // interleaved 16 B slots (key u64 + cnt u32 + pad): ONE cache line
    // and ONE TLB page per probe instead of the two the split
    // keys[]/cnt[] arrays paid — at GB scale every probe is a miss, so
    // line count is the wall
    struct Slot { uint64_t key; uint32_t cnt; uint32_t pad; };
    Slot* tab = (Slot*)huge_alloc((size_t)slots * sizeof(Slot));
    if (!tab) return 2;
    memset(tab, 0xFF, (size_t)slots * sizeof(Slot));  // key ~0 = empty
    struct Guard {
        Slot* t;
        int64_t s;
        ~Guard() { munmap(t, (size_t)s * sizeof(Slot)); }
    } guard{tab, slots};
    const uint64_t kmask =
        (2 * k >= 64) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int64_t occ = 0, used = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        const int32_t L = lens[r];
        if (L <= min_len || L - k <= 0) continue;
        const int8_t* s = codes + offs[r];
        uint64_t fwd = 0, rc = 0;
        for (int32_t j = 0; j < k; j++) {
            const uint64_t c = (uint64_t)(s[j] & 3);
            fwd = (fwd << 2) | c;
            rc |= (3ULL ^ c) << (2 * j);
        }
        const int32_t n_win = L - k;  // one short: iterator parity
        occ += n_win;
        // block the windows: roll a batch of keys + prefetch their hash
        // slots, THEN probe — at GB scale every probe is a cache+TLB
        // miss, and ~BLK-way memory-level parallelism
        // is the same trick as the fmi host engine's coroutine
        // scheduler (native/fmsearch.cpp), shaped for a tight loop.
        constexpr int32_t BLK = 48;
        uint64_t kbuf[BLK];
        int64_t ibuf[BLK];
        int32_t p = 0;
        while (p < n_win) {
            const int32_t nb =
                (n_win - p) < BLK ? (int32_t)(n_win - p) : BLK;
            for (int32_t b = 0; b < nb; b++) {
                const uint64_t key = fwd < rc ? fwd : rc;
                const uint64_t h = key * 0x9E3779B97F4A7C15ULL;
                const int64_t i = (int64_t)(h >> 32) & mask;
                kbuf[b] = key;
                ibuf[b] = i;
                __builtin_prefetch(&tab[i], 1);
                if (p + b + 1 < n_win) {
                    const uint64_t c = (uint64_t)(s[p + b + k] & 3);
                    fwd = ((fwd << 2) | c) & kmask;
                    rc = (rc >> 2) | ((3ULL ^ c) << (2 * (k - 1)));
                }
            }
            for (int32_t b = 0; b < nb; b++) {
                const uint64_t key = kbuf[b];
                int64_t i = ibuf[b];
                for (;;) {
                    if (tab[i].key == key) {
                        tab[i].cnt++;
                        break;
                    }
                    if (tab[i].key == ~0ULL) {
                        tab[i].key = key;
                        tab[i].cnt = 1;
                        if (++used > limit) return 1;
                        break;
                    }
                    i = (i + 1) & mask;
                }
            }
            p += nb;
        }
    }
    int64_t over = 0;
    for (int64_t i = 0; i < slots; i++) {
        if (tab[i].key != ~0ULL && (int64_t)tab[i].cnt > saturation) over++;
    }
    *total_kmers = used;
    *hash_size = over;
    *occurrences = occ;
    return 0;
}

}  // extern "C"
