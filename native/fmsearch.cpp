// Host FM-index SMEM search engine (bwa-mem2 3-phase semantics).
//
// Why this exists: the FM backward search is random-access pointer
// chasing over 64-byte occ rows, which a CPU core with ~16-way miss
// interleaving services well.  The framework therefore offers both
// engines (SURVEY.md §3.1 (a)): this native one for seeding throughput,
// the device one for integration with on-device pipelines.  Semantics are transcribed from the pinned
// oracle (genomicsbench_palisade_tpu/ops/oracle/fmi.py, itself cited to
// FMI_search.cpp:986-1326) — NOT from the reference source.
//
// Index layouts:
//   v1 (64 B/block, [blocks, 16] u32): count lo x4, count hi x4, one-hot
//      bits 0..31 x4 MSB-first, bits 32..63 x4 — the reference's own
//      CP_OCC shape (FMI_search.h:59-63).
//   v2 (32 B/block, [blocks, 8] u32): per-base counts RELATIVE to a
//      superblock base x4, then the 64 positions as TWO BIT-PLANES
//      (hi plane words for positions 0..31 / 32..63, lo plane likewise;
//      base c at position p <=> hi bit = c>>1, lo bit = c&1).  A
//      separate [n_superblocks, 4] int64 table (one row per 2^16
//      blocks, ~50 KB at hg38 scale so it lives in L2) carries the
//      absolute counts.  Half the per-access footprint of v1 — same
//      cache-line count per lookup but half the pages and twice the
//      LLC coverage, which is where the occ walk spends its time.
//      The sentinel position is stored as code 0 in the planes; occ
//      subtracts the spurious base-0 hit when the counted prefix
//      covers it.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <coroutine>
#include <thread>
#include <vector>

#include <sys/mman.h>

namespace {

constexpr int SB_SHIFT = 16;  // blocks per superblock (v2 layout)

struct Smem {
    int64_t rid, m, n, k, l, s;
};

struct Idx {
    const uint32_t* pack;    // v1: [blocks][16]; null in v2 mode
    const uint32_t* pack32;  // v2: [blocks][8]; null in v1 mode
    const int64_t* sbtab;    // v2: [n_superblocks][4]
    int64_t count[5];
    int64_t sentinel;
};

inline void occ4(const Idx& ix, int64_t pp, int64_t out[4]) {
    int64_t blk = pp >> 6;
    int y = (int)(pp & 63);
    if (ix.pack32) {
        const uint32_t* row = ix.pack32 + blk * 8;
        const int64_t* sb = ix.sbtab + (blk >> SB_SHIFT) * 4;
        uint64_t hi = ((uint64_t)row[4] << 32) | row[5];
        uint64_t lo = ((uint64_t)row[6] << 32) | row[7];
        uint64_t pm = y ? (~0ull << (64 - y)) : 0;  // positions 0..y-1
        for (int c = 0; c < 4; c++) {
            uint64_t m = ((c & 2) ? hi : ~hi) & ((c & 1) ? lo : ~lo) & pm;
            out[c] = sb[c] + row[c] + __builtin_popcountll(m);
        }
        // the sentinel is encoded as code 0; drop its spurious hit when
        // the prefix [blk*64, pp) covers it
        out[0] -= ((ix.sentinel >> 6) == blk && (int)(ix.sentinel & 63) < y);
        return;
    }
    const uint32_t* row = ix.pack + blk * 16;
    uint32_t hi_mask = 0, lo_mask = 0;
    int ym = y < 32 ? y : 32;
    if (ym > 0) hi_mask = 0xFFFFFFFFu << (32 - ym);
    int ym2 = y - 32;
    if (ym2 > 0) lo_mask = 0xFFFFFFFFu << (32 - ym2);
    for (int c = 0; c < 4; c++) {
        int64_t base = (int64_t)row[c] | ((int64_t)row[4 + c] << 32);
        int cnt = __builtin_popcount(row[8 + c] & hi_mask) +
                  __builtin_popcount(row[12 + c] & lo_mask);
        out[c] = base + cnt;
    }
}

// backwardExt (oracle backward_ext): updates (k,l,s) for base a
inline void backward_ext(const Idx& ix, Smem& sm, int a) {
    int64_t sp = sm.k, ep = sm.k + sm.s;
    int64_t osp[4], oep[4];
    occ4(ix, sp, osp);
    occ4(ix, ep, oep);
    int64_t k4[4], s4[4], l4[4];
    for (int c = 0; c < 4; c++) {
        k4[c] = ix.count[c] + osp[c];
        s4[c] = oep[c] - osp[c];
    }
    int64_t off = (sp <= ix.sentinel && ep > ix.sentinel) ? 1 : 0;
    l4[3] = sm.l + off;
    l4[2] = l4[3] + s4[3];
    l4[1] = l4[2] + s4[2];
    l4[0] = l4[1] + s4[1];
    sm.k = k4[a];
    sm.l = l4[a];
    sm.s = s4[a];
}

// forward ext = backward on the revcomp (swap k/l, base 3-a)
inline void forward_ext(const Idx& ix, Smem& sm, int a) {
    Smem t = sm;
    t.k = sm.l;
    t.l = sm.k;
    backward_ext(ix, t, 3 - a);
    sm.k = t.l;
    sm.l = t.k;
    sm.s = t.s;
}

inline Smem root(const Idx& ix, int64_t rid, int64_t x, int a) {
    Smem sm;
    sm.rid = rid;
    sm.m = x;
    sm.n = x;
    sm.k = ix.count[a];
    sm.l = ix.count[3 - a];
    sm.s = ix.count[a + 1] - ix.count[a];
    return sm;
}

// getSMEMsOnePosOneThread per-read body (oracle get_smems_one_pos)
int64_t one_pos(const Idx& ix, const int8_t* read, int64_t rl, int64_t rid,
                int64_t x, int64_t min_intv, int min_seed_len,
                std::vector<Smem>& matches, std::vector<Smem>& prev) {
    int a = read[x];
    int64_t next_x = x + 1;
    if (a >= 4) return next_x;
    Smem smem = root(ix, rid, x, a);
    prev.clear();  // caller-owned scratch: no per-position allocation
    for (int64_t j = x + 1; j < rl; j++) {
        a = read[j];
        next_x = j + 1;
        if (a >= 4) break;
        Smem nw = smem;
        forward_ext(ix, nw, a);
        nw.n = j;
        if (nw.s != smem.s) prev.push_back(smem);
        if (nw.s < min_intv) {
            next_x = j;
            break;
        }
        smem = nw;
    }
    if (smem.s >= min_intv) prev.push_back(smem);
    for (size_t i = 0, jj = prev.size(); i + 1 < jj; i++, jj--)
        std::swap(prev[i], prev[jj - 1]);

    int64_t num_prev = (int64_t)prev.size();
    for (int64_t j = x - 1; j >= 0; j--) {
        if (num_prev == 0) break;
        a = read[j];
        if (a > 3) break;
        int64_t num_curr = 0, curr_s = -1;
        int64_t p = 0;
        for (; p < num_prev; p++) {
            Smem sm = prev[p];
            Smem nw = sm;
            backward_ext(ix, nw, a);
            nw.m = j;
            if (nw.s < min_intv && (sm.n - sm.m + 1) >= min_seed_len) {
                matches.push_back(sm);
                break;
            }
            if (nw.s >= min_intv && nw.s != curr_s) {
                curr_s = nw.s;
                prev[num_curr++] = nw;
                break;
            }
        }
        p++;
        for (; p < num_prev; p++) {
            Smem sm = prev[p];
            Smem nw = sm;
            backward_ext(ix, nw, a);
            nw.m = j;
            if (nw.s >= min_intv && nw.s != curr_s) {
                curr_s = nw.s;
                prev[num_curr++] = nw;
            }
        }
        num_prev = num_curr;
    }
    if (num_prev != 0) {
        const Smem& sm = prev[0];
        if ((sm.n - sm.m + 1) >= min_seed_len) matches.push_back(sm);
    }
    return next_x;
}

void all_pos(const Idx& ix, const int8_t* read, int64_t rl, int64_t rid,
             int64_t min_intv, int min_seed_len, std::vector<Smem>& matches,
             std::vector<Smem>& prev) {
    int64_t x = 0;
    while (x < rl)
        x = one_pos(ix, read, rl, rid, x, min_intv, min_seed_len, matches, prev);
}

// bwtSeedStrategyAllPosOneThread (oracle bwt_seed_strategy_one_read)
void seed_strategy(const Idx& ix, const int8_t* read, int64_t rl, int64_t rid,
                   int64_t max_intv, int min_seed_len,
                   std::vector<Smem>& matches) {
    int64_t x = 0;
    while (x < rl) {
        int64_t next_x = x + 1;
        int a = read[x];
        if (a < 4) {
            Smem smem = root(ix, rid, x, a);
            for (int64_t j = x + 1; j < rl; j++) {
                next_x = j + 1;
                a = read[j];
                if (a >= 4) break;
                forward_ext(ix, smem, a);
                smem.n = j;
                if (smem.s < max_intv && (smem.n - smem.m + 1) >= min_seed_len) {
                    if (smem.s > 0) matches.push_back(smem);
                    break;
                }
            }
        }
        x = next_x;
    }
}

struct FmiResult {
    std::vector<Smem> s1, s2, s3;
};

// ---------------------------------------------------------------------------
// Interleaved (software-pipelined) engine.
//
// At genome scale every occ row is a cache+TLB miss: the serial state
// machine above is latency-bound on each dependent row, while ~16
// independent streams overlap their misses (memory-level parallelism).  The reference gets its single-thread
// throughput the same way — _mm_prefetch pipelining across reads in
// getSMEMsOnePosOneThread (FMI_search.cpp:986, ENABLE_PREFETCH) — and
// this engine is the same idea expressed as C++20 coroutines: G reads
// per thread run in lockstep, every (occ(sp), occ(ep)) pair issues
// prefetches and suspends, and the scheduler round-robins resumes so
// each fetch has G-1 other reads' work in flight to hide its miss.
// Emit order per read is identical to the serial engine (per-read
// result buffers concatenated in read order).
// ---------------------------------------------------------------------------

struct OccOut {
    int64_t osp[4], oep[4];
};

struct KLS {
    int64_t k, l, s;
};

// pure arithmetic tail of backward_ext once both occ rows are resolved
inline KLS apply_bwd(const Idx& ix, int64_t k, int64_t l, int64_t s, int a,
                     const OccOut& o) {
    int64_t sp = k, ep = k + s;
    int64_t k4[4], s4[4], l4[4];
    for (int c = 0; c < 4; c++) {
        k4[c] = ix.count[c] + o.osp[c];
        s4[c] = o.oep[c] - o.osp[c];
    }
    int64_t off = (sp <= ix.sentinel && ep > ix.sentinel) ? 1 : 0;
    l4[3] = l + off;
    l4[2] = l4[3] + s4[3];
    l4[1] = l4[2] + s4[2];
    l4[0] = l4[1] + s4[1];
    return {k4[a], l4[a], s4[a]};
}

struct Slot {
    std::coroutine_handle<> current;  // innermost suspended frame
};

// awaitable: prefetch the two occ rows, suspend; compute on resume
struct OccPair {
    const Idx& ix;
    Slot& slot;
    int64_t sp, ep;
    bool await_ready() const noexcept { return false; }
    void await_suspend(std::coroutine_handle<> h) noexcept {
        if (ix.pack32) {  // 32 B rows: one line each
            __builtin_prefetch(ix.pack32 + (sp >> 6) * 8);
            __builtin_prefetch(ix.pack32 + (ep >> 6) * 8);
        } else {
            const uint32_t* r1 = ix.pack + (sp >> 6) * 16;
            const uint32_t* r2 = ix.pack + (ep >> 6) * 16;
            __builtin_prefetch(r1);
            __builtin_prefetch(r1 + 8);
            __builtin_prefetch(r2);
            __builtin_prefetch(r2 + 8);
        }
        slot.current = h;
    }
    OccOut await_resume() const noexcept {
        OccOut o;
        occ4(ix, sp, o.osp);
        occ4(ix, ep, o.oep);
        return o;
    }
};

// child coroutine returning T, resuming its parent on completion
template <typename T>
struct SubTask {
    struct promise_type {
        T value{};
        std::coroutine_handle<> cont;
        SubTask get_return_object() {
            return {std::coroutine_handle<promise_type>::from_promise(*this)};
        }
        std::suspend_always initial_suspend() noexcept { return {}; }
        struct Final {
            bool await_ready() noexcept { return false; }
            std::coroutine_handle<> await_suspend(
                std::coroutine_handle<promise_type> h) noexcept {
                auto c = h.promise().cont;
                return c ? c : std::noop_coroutine();
            }
            void await_resume() noexcept {}
        };
        Final final_suspend() noexcept { return {}; }
        void return_value(T v) { value = v; }
        void unhandled_exception() { std::terminate(); }
    };
    std::coroutine_handle<promise_type> h;
    bool await_ready() const noexcept { return false; }
    std::coroutine_handle<> await_suspend(std::coroutine_handle<> parent) {
        h.promise().cont = parent;
        return h;  // symmetric transfer into the child
    }
    T await_resume() {
        T v = h.promise().value;
        h.destroy();
        return v;
    }
};

struct RootTask {
    struct promise_type {
        RootTask get_return_object() {
            return {std::coroutine_handle<promise_type>::from_promise(*this)};
        }
        std::suspend_always initial_suspend() noexcept { return {}; }
        std::suspend_always final_suspend() noexcept { return {}; }
        void return_void() {}
        void unhandled_exception() { std::terminate(); }
    };
    std::coroutine_handle<promise_type> h;
};

// one_pos as a coroutine; control flow mirrors one_pos() above line for
// line — only the ext calls become awaits
SubTask<int64_t> one_pos_co(const Idx& ix, Slot& slot, const int8_t* read,
                            int64_t rl, int64_t rid, int64_t x,
                            int64_t min_intv, int min_seed_len,
                            std::vector<Smem>& matches,
                            std::vector<Smem>& prev) {
    int a = read[x];
    int64_t next_x = x + 1;
    if (a >= 4) co_return next_x;
    Smem smem = root(ix, rid, x, a);
    prev.clear();
    for (int64_t j = x + 1; j < rl; j++) {
        a = read[j];
        next_x = j + 1;
        if (a >= 4) break;
        OccOut o = co_await OccPair{ix, slot, smem.l, smem.l + smem.s};
        KLS r = apply_bwd(ix, smem.l, smem.k, smem.s, 3 - a, o);
        Smem nw = smem;
        nw.k = r.l;
        nw.l = r.k;
        nw.s = r.s;
        nw.n = j;
        if (nw.s != smem.s) prev.push_back(smem);
        if (nw.s < min_intv) {
            next_x = j;
            break;
        }
        smem = nw;
    }
    if (smem.s >= min_intv) prev.push_back(smem);
    for (size_t i = 0, jj = prev.size(); i + 1 < jj; i++, jj--)
        std::swap(prev[i], prev[jj - 1]);

    int64_t num_prev = (int64_t)prev.size();
    for (int64_t j = x - 1; j >= 0; j--) {
        if (num_prev == 0) break;
        a = read[j];
        if (a > 3) break;
        int64_t num_curr = 0, curr_s = -1;
        int64_t p = 0;
        for (; p < num_prev; p++) {
            Smem sm = prev[p];
            OccOut o = co_await OccPair{ix, slot, sm.k, sm.k + sm.s};
            KLS r = apply_bwd(ix, sm.k, sm.l, sm.s, a, o);
            Smem nw = sm;
            nw.k = r.k;
            nw.l = r.l;
            nw.s = r.s;
            nw.m = j;
            if (nw.s < min_intv && (sm.n - sm.m + 1) >= min_seed_len) {
                matches.push_back(sm);
                break;
            }
            if (nw.s >= min_intv && nw.s != curr_s) {
                curr_s = nw.s;
                prev[num_curr++] = nw;
                break;
            }
        }
        p++;
        for (; p < num_prev; p++) {
            Smem sm = prev[p];
            OccOut o = co_await OccPair{ix, slot, sm.k, sm.k + sm.s};
            KLS r = apply_bwd(ix, sm.k, sm.l, sm.s, a, o);
            Smem nw = sm;
            nw.k = r.k;
            nw.l = r.l;
            nw.s = r.s;
            nw.m = j;
            if (nw.s >= min_intv && nw.s != curr_s) {
                curr_s = nw.s;
                prev[num_curr++] = nw;
            }
        }
        num_prev = num_curr;
    }
    if (num_prev != 0) {
        const Smem& sm = prev[0];
        if ((sm.n - sm.m + 1) >= min_seed_len) matches.push_back(sm);
    }
    co_return next_x;
}

// whole-read 3-phase pipeline as one root coroutine
RootTask read_co(const Idx& ix, Slot& slot, const int8_t* rd, int64_t rl,
                 int64_t rid, int min_seed_len, int split_len,
                 int split_width, int max_mem_intv, FmiResult& out,
                 std::vector<Smem>& m1, std::vector<Smem>& prev) {
    m1.clear();
    int64_t x = 0;
    while (x < rl)
        x = co_await one_pos_co(ix, slot, rd, rl, rid, x, 1, min_seed_len,
                                m1, prev);
    for (const Smem& sm : m1) {
        if ((sm.n + 1 - sm.m) >= split_len && sm.s <= split_width) {
            int64_t mid = (sm.n + 1 + sm.m) >> 1;
            co_await one_pos_co(ix, slot, rd, rl, rid, mid, sm.s + 1,
                                min_seed_len, out.s2, prev);
        }
    }
    out.s1.insert(out.s1.end(), m1.begin(), m1.end());
    // seed_strategy (phase 3), exts awaited
    int64_t x2 = 0;
    int msl3 = min_seed_len + 1;
    while (x2 < rl) {
        int64_t next_x = x2 + 1;
        int a = rd[x2];
        if (a < 4) {
            Smem smem = root(ix, rid, x2, a);
            for (int64_t j = x2 + 1; j < rl; j++) {
                next_x = j + 1;
                a = rd[j];
                if (a >= 4) break;
                OccOut o = co_await OccPair{ix, slot, smem.l, smem.l + smem.s};
                KLS r = apply_bwd(ix, smem.l, smem.k, smem.s, 3 - a, o);
                smem.k = r.l;
                smem.l = r.k;
                smem.s = r.s;
                smem.n = j;
                if (smem.s < max_mem_intv &&
                    (smem.n - smem.m + 1) >= msl3) {
                    if (smem.s > 0) out.s3.push_back(smem);
                    break;
                }
            }
        }
        x2 = next_x;
    }
}

// G-way interleaved scheduler over the read range [lo, hi)
void run_interleaved(const Idx& ix, const int8_t* reads,
                     const int64_t* read_off, const int32_t* read_len,
                     int64_t lo, int64_t hi, int min_seed_len,
                     int split_len, int split_width, int max_mem_intv,
                     std::vector<FmiResult>& per_read, int width) {
    struct Lane {
        RootTask root{};
        Slot slot{};
        std::vector<Smem> m1, prev;
        bool active = false;
    };
    std::vector<Lane> lanes(width);
    int64_t next = lo;
    int active = 0;
    auto start = [&](Lane& ln) {
        if (next >= hi) return;
        int64_t r = next++;
        ln.root = read_co(ix, ln.slot, reads + read_off[r], read_len[r], r,
                          min_seed_len, split_len, split_width, max_mem_intv,
                          per_read[r], ln.m1, ln.prev);
        ln.slot.current = ln.root.h;
        ln.active = true;
        active++;
    };
    for (auto& ln : lanes) start(ln);
    while (active > 0) {
        for (auto& ln : lanes) {
            if (!ln.active) continue;
            ln.slot.current.resume();
            if (ln.root.h.done()) {
                ln.root.h.destroy();
                ln.active = false;
                active--;
                start(ln);
            }
        }
    }
}

// shared 3-phase driver once the Idx (either layout) is assembled
void* fmi_run_common(Idx ix, const int8_t* reads, const int64_t* read_off,
                     const int32_t* read_len, int64_t n_reads,
                     int min_seed_len, int split_width, int max_mem_intv,
                     double split_factor, int n_threads,
                     const int64_t* count5) {
    int split_len = (int)(min_seed_len * split_factor + 0.499);

    auto* res = new FmiResult();
    if (n_threads < 1) n_threads = 1;

    // Engine choice: the interleaved engine wins once occ rows miss
    // cache (index beyond ~32 MB); the serial one avoids coroutine
    // overhead on toy indexes.  GT_FMI_ENGINE=serial|interleaved forces.
    int64_t n_blocks_bytes = 0;
    // count[4] = text length incl. sentinel; blocks = ceil(len/64)
    n_blocks_bytes = ((count5[4] + 63) / 64) * 64;
    bool interleave = n_blocks_bytes > (int64_t)32 * 1024 * 1024;
    if (const char* e = std::getenv("GT_FMI_ENGINE")) {
        if (std::strcmp(e, "serial") == 0) interleave = false;
        if (std::strcmp(e, "interleaved") == 0) interleave = true;
    }
    // Interleave width: on a 3.2 Gbp (6.4e9-char) index the rate
    // plateaus at W=64..96 (14.7k reads/s vs 11.7k at W=24, 1 thread;
    // deeper TLB misses need more concurrent streams) and falls past
    // 128 as the prefetch window outruns L2; at 256 Mbp W=24 is ~6%
    // ahead.  Scale with the occ-row table size; GT_FMI_WIDTH overrides.
    int width = n_blocks_bytes > (int64_t)2 * 1024 * 1024 * 1024 ? 64 : 24;
    if (const char* w = std::getenv("GT_FMI_WIDTH")) {
        int v = std::atoi(w);
        if (v >= 1 && v <= 256) width = v;
    }

    if (interleave) {
        std::vector<FmiResult> per_read(n_reads);
        std::vector<std::thread> pool;
        int64_t chunk = (n_reads + n_threads - 1) / n_threads;
        for (int tix = 0; tix < n_threads; tix++) {
            pool.emplace_back([&, tix]() {
                int64_t lo = tix * chunk;
                int64_t hi = std::min<int64_t>(lo + chunk, n_reads);
                if (lo < hi)
                    run_interleaved(ix, reads, read_off, read_len, lo, hi,
                                    min_seed_len, split_len, split_width,
                                    max_mem_intv, per_read, width);
            });
        }
        for (auto& t : pool) t.join();
        for (auto& p : per_read) {
            res->s1.insert(res->s1.end(), p.s1.begin(), p.s1.end());
            res->s2.insert(res->s2.end(), p.s2.begin(), p.s2.end());
            res->s3.insert(res->s3.end(), p.s3.begin(), p.s3.end());
        }
        return res;
    }

    std::vector<FmiResult> parts(n_threads);
    std::vector<std::thread> pool;
    int64_t chunk = (n_reads + n_threads - 1) / n_threads;
    for (int tix = 0; tix < n_threads; tix++) {
        pool.emplace_back([&, tix]() {
            FmiResult& out = parts[tix];
            int64_t lo = tix * chunk;
            int64_t hi = std::min<int64_t>(lo + chunk, n_reads);
            std::vector<Smem> m1, prev;
            for (int64_t r = lo; r < hi; r++) {
                const int8_t* rd = reads + read_off[r];
                int64_t rl = read_len[r];
                m1.clear();
                all_pos(ix, rd, rl, r, 1, min_seed_len, m1, prev);
                // phase 2: reseed qualifying phase-1 SMEMs in emit order
                for (const Smem& sm : m1) {
                    if ((sm.n + 1 - sm.m) >= split_len && sm.s <= split_width) {
                        int64_t mid = (sm.n + 1 + sm.m) >> 1;
                        one_pos(ix, rd, rl, r, mid, sm.s + 1, min_seed_len,
                                out.s2, prev);
                    }
                }
                out.s1.insert(out.s1.end(), m1.begin(), m1.end());
                seed_strategy(ix, rd, rl, r, max_mem_intv, min_seed_len + 1,
                              out.s3);
            }
        });
    }
    for (auto& t : pool) t.join();
    for (auto& p : parts) {
        res->s1.insert(res->s1.end(), p.s1.begin(), p.s1.end());
        res->s2.insert(res->s2.end(), p.s2.begin(), p.s2.end());
        res->s3.insert(res->s3.end(), p.s3.begin(), p.s3.end());
    }
    return res;
}

}  // namespace

extern "C" {

// Runs the full 3-phase pipeline over n_reads reads (v1 64 B rows).
void* gt_fmi_run(const uint32_t* cp_pack, const int64_t* count5,
                 int64_t sentinel, const int8_t* reads,
                 const int64_t* read_off, const int32_t* read_len,
                 int64_t n_reads, int min_seed_len, int split_width,
                 int max_mem_intv, double split_factor, int n_threads) {
    Idx ix;
    ix.pack = cp_pack;
    ix.pack32 = nullptr;
    ix.sbtab = nullptr;
    std::memcpy(ix.count, count5, 5 * sizeof(int64_t));
    ix.sentinel = sentinel;
    return fmi_run_common(ix, reads, read_off, read_len, n_reads,
                          min_seed_len, split_width, max_mem_intv,
                          split_factor, n_threads, count5);
}

// v2 compressed layout: 32 B bit-plane rows + superblock count table.
void* gt_fmi_run2(const uint32_t* pack32, const int64_t* sbtab,
                  const int64_t* count5, int64_t sentinel,
                  const int8_t* reads, const int64_t* read_off,
                  const int32_t* read_len, int64_t n_reads,
                  int min_seed_len, int split_width, int max_mem_intv,
                  double split_factor, int n_threads) {
    Idx ix;
    ix.pack = nullptr;
    ix.pack32 = pack32;
    ix.sbtab = sbtab;
    std::memcpy(ix.count, count5, 5 * sizeof(int64_t));
    ix.sentinel = sentinel;
    return fmi_run_common(ix, reads, read_off, read_len, n_reads,
                          min_seed_len, split_width, max_mem_intv,
                          split_factor, n_threads, count5);
}

// Anonymous mapping for the occ tables, optionally THP-backed: the walk
// is one dTLB miss per occ row on 4 KiB pages (6.4 GB v1 table = 1.6M
// pages); MADV_HUGEPAGE before first touch makes the kernel back the
// region with 2 MiB pages at fault time (THP is in madvise mode here),
// collapsing the page-walk depth.  File-backed mmap (the .npy sidecar)
// cannot be THP-backed, so callers copy the table in once per process.
void* gt_alloc_pages(int64_t bytes, int huge) {
    void* p = mmap(nullptr, (size_t)bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    if (huge) madvise(p, (size_t)bytes, MADV_HUGEPAGE);
    return p;
}

void gt_free_pages(void* p, int64_t bytes) {
    if (p) munmap(p, (size_t)bytes);
}

int64_t gt_fmi_n1(void* h) { return (int64_t)((FmiResult*)h)->s1.size(); }
int64_t gt_fmi_n2(void* h) { return (int64_t)((FmiResult*)h)->s2.size(); }
int64_t gt_fmi_n3(void* h) { return (int64_t)((FmiResult*)h)->s3.size(); }

// Copies s1 ++ s2 ++ s3 into six int64 arrays of length n1+n2+n3.
void gt_fmi_copy(void* h, int64_t* rid, int64_t* m, int64_t* n, int64_t* k,
                 int64_t* l, int64_t* s) {
    auto* res = (FmiResult*)h;
    int64_t i = 0;
    for (const auto* vec : {&res->s1, &res->s2, &res->s3}) {
        for (const Smem& sm : *vec) {
            rid[i] = sm.rid;
            m[i] = sm.m;
            n[i] = sm.n;
            k[i] = sm.k;
            l[i] = sm.l;
            s[i] = sm.s;
            i++;
        }
    }
}

void gt_fmi_free(void* h) { delete (FmiResult*)h; }

}  // extern "C"
