// Colored de Bruijn window assembly (Platypus-style, benchmarks/dbg).
// Semantic contract is ops/dbg.py (itself cited to debruijn.cpp): same
// node/edge colour+weight merging, the reference's len-k-1 loop bound,
// the k+1-window min-quality read filter, and the bounded bubble DFS
// with identical iteration order (nodes in insertion order, edges in
// creation order, stack-pop path order).  Returns node count + bubble
// path sequences; the Python graph stays the full-featured spec/API.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t REF = 1, READ = 2, REF_AND_READ = 3;

struct Edge { int32_t succ; double weight; };

struct Node {
    int32_t colours;
    int64_t position;
    double weight;
    std::vector<Edge> edges;
};

struct Graph {
    int64_t k;
    std::unordered_map<std::string, int32_t> id_of;
    std::vector<Node> nodes;          // insertion order == Python dict order
    std::vector<std::string> kmers;

    int32_t insert_or_update(const std::string& kmer, int32_t colours,
                             int64_t position, double weight) {
        auto it = id_of.find(kmer);
        if (it == id_of.end()) {
            int32_t id = (int32_t)nodes.size();
            id_of.emplace(kmer, id);
            nodes.push_back({colours, position, weight, {}});
            kmers.push_back(kmer);
            return id;
        }
        nodes[it->second].colours |= colours;
        nodes[it->second].weight += weight;
        return it->second;
    }

    void add_edge(const std::string& k1, const std::string& k2,
                  int32_t colours, int64_t pos1, int64_t pos2,
                  double node_weight, double edge_weight) {
        int32_t a = insert_or_update(k1, colours, pos1, node_weight);
        int32_t b = insert_or_update(k2, colours, pos2, node_weight);
        for (auto& e : nodes[a].edges) {
            if (e.succ == b) { e.weight += edge_weight; return; }
        }
        nodes[a].edges.push_back({b, edge_weight});
    }
};

// Fast-path graph for the common alphabet (every ref/read char in
// ACGTN, k <= 21): kmers become rolling 3-bit-packed u64 keys — O(1)
// per window instead of an O(k) string assign + hash — looked up in an
// open-addressing table (a std::unordered_map<string> path loses to
// the reference's custom bucket dict).  Node insertion order, colour/weight merge
// and edge creation order are IDENTICAL to the slow path (tests assert
// path-level equality vs the Python spec either way).
struct FastGraph {
    int64_t k;
    std::vector<Node> nodes;
    std::vector<uint64_t> keys;       // insertion-ordered, for decode
    std::vector<int64_t> table;       // open addressing: node id or -1
    uint64_t mask = 0;

    void reserve_table(size_t expected_nodes) {
        size_t cap = 64;
        while (cap < expected_nodes * 2) cap <<= 1;
        table.assign(cap, -1);
        mask = cap - 1;
        nodes.reserve(expected_nodes);
        keys.reserve(expected_nodes);
    }

    static uint64_t mix(uint64_t x) {
        x ^= x >> 33;
        x *= 0xFF51AFD7ED558CCDULL;
        x ^= x >> 33;
        return x;
    }

    void grow() {
        std::vector<int64_t> nt(table.size() * 2, -1);
        const uint64_t nm = nt.size() - 1;
        for (size_t id = 0; id < keys.size(); id++) {
            uint64_t h = mix(keys[id]) & nm;
            while (nt[h] != -1) h = (h + 1) & nm;
            nt[h] = (int64_t)id;
        }
        table.swap(nt);
        mask = nm;
    }

    int32_t insert_or_update(uint64_t key, int32_t colours,
                             int64_t position, double weight) {
        uint64_t h = mix(key) & mask;
        while (true) {
            int64_t id = table[h];
            if (id == -1) {
                if (nodes.size() * 4 >= table.size() * 3) {  // 75% load
                    grow();
                    return insert_or_update(key, colours, position, weight);
                }
                int32_t nid = (int32_t)nodes.size();
                table[h] = nid;
                nodes.push_back({colours, position, weight, {}});
                keys.push_back(key);
                return nid;
            }
            if (keys[id] == key) {
                nodes[id].colours |= colours;
                nodes[id].weight += weight;
                return (int32_t)id;
            }
            h = (h + 1) & mask;
        }
    }

    void link(int32_t a, int32_t b, double edge_weight) {
        for (auto& e : nodes[a].edges) {
            if (e.succ == b) { e.weight += edge_weight; return; }
        }
        nodes[a].edges.push_back({b, edge_weight});
    }

    std::string decode(int64_t id) const {
        static const char REV[8] = {'A', 'C', 'G', 'T', 'N',
                                    '?', '?', '?'};
        std::string s((size_t)k, 'A');
        uint64_t key = keys[id];
        for (int64_t i = k - 1; i >= 0; i--) {
            s[(size_t)i] = REV[key & 7];
            key >>= 3;
        }
        return s;
    }
};

// 3-bit codes for the fast path; 7 marks out-of-alphabet
inline const int8_t* code3_table() {
    static int8_t t[256];
    static bool init = false;
    if (!init) {
        std::memset(t, 7, sizeof(t));
        t[(unsigned char)'A'] = 0;
        t[(unsigned char)'C'] = 1;
        t[(unsigned char)'G'] = 2;
        t[(unsigned char)'T'] = 3;
        t[(unsigned char)'N'] = 4;
        init = true;
    }
    return t;
}

struct Handle {
    int64_t n_nodes = 0;
    std::vector<std::string> bubbles;  // path sequences
    int64_t seq_bytes = 0;
};

// bubble DFS: per REF_AND_READ node in insertion order, the
// reference's getVariantPathsThroughGraphFromNode run on each
// qualifying 2-node seed [start, succ] (ops/dbg.py
// variant_paths_from_seed; pinned by tools/golden/dbg_harness.cpp
// which executes the reference's own function per seed).
// GetKmer(id) -> std::string reconstructs a node's kmer.
template <class GetKmer>
void bubble_dfs(const std::vector<Node>& nodes, int64_t k,
                double min_weight, GetKmer get_kmer, Handle* h) {
    std::vector<std::vector<int32_t>> stack, finished;
    for (int32_t start = 0; start < (int32_t)nodes.size(); start++) {
        if (nodes[start].colours != REF_AND_READ) continue;
        for (const auto& se : nodes[start].edges) {
            const Node& snxt = nodes[se.succ];
            if (!(se.weight >= min_weight || snxt.colours == REF_AND_READ
                  || snxt.colours == REF))
                continue;
            stack.clear();
            finished.clear();
            stack.push_back({start, se.succ});
            bool exploded = false;
            while (!stack.empty()) {
                std::vector<int32_t> path = std::move(stack.back());
                stack.pop_back();
                if ((int64_t)stack.size() > 20
                    || (int64_t)finished.size() > 20) {
                    exploded = true;  // reference returns NULL
                    break;
                }
                bool dup = false;  // cycle within the path
                for (size_t a = 0; a < path.size() && !dup; a++)
                    for (size_t b = a + 1; b < path.size(); b++)
                        if (path[a] == path[b]) { dup = true; break; }
                if (dup) continue;
                const Node& end = nodes[path.back()];
                if (end.colours == REF_AND_READ) {
                    finished.push_back(path);
                } else if (end.colours == REF) {
                    continue;
                } else {
                    for (const auto& e : end.edges) {
                        const Node& nxt = nodes[e.succ];
                        if (e.weight >= min_weight
                            || nxt.colours == REF_AND_READ
                            || nxt.colours == REF) {
                            std::vector<int32_t> p2 = path;
                            p2.push_back(e.succ);
                            stack.push_back(std::move(p2));
                        }
                    }
                }
            }
            if (exploded || finished.empty()) continue;
            for (const auto& path : finished) {
                std::string seq;
                seq.reserve(path.size() + k);
                for (size_t i = 0; i + 1 < path.size(); i++)
                    seq.push_back(get_kmer(path[i])[0]);
                seq += get_kmer(path.back());
                h->seq_bytes += (int64_t)seq.size() + 1;
                h->bubbles.push_back(std::move(seq));
            }
        }
    }
}

// fast path: rolling 3-bit keys + cached successor node id (window
// i+1's first kmer IS window i's second — one table lookup per window
// instead of two, on top of the O(1) key roll)
Handle* build_fast(const char* ref, int64_t ref_len, int64_t ref_start,
                   const char* reads, const int64_t* read_off,
                   const uint8_t* quals, const int32_t* flags,
                   int64_t n_reads, int64_t k, int64_t min_qual,
                   int64_t min_reads) {
    const int8_t* code = code3_table();
    const uint64_t kmask = (k * 3 >= 64) ? ~0ULL : ((1ULL << (k * 3)) - 1);
    FastGraph g;
    g.k = k;
    int64_t total = ref_len;
    for (int64_t r = 0; r < n_reads; r++)
        total += read_off[r + 1] - read_off[r];
    g.reserve_table((size_t)total + 16);

    std::vector<uint64_t> keyv;
    auto roll_keys = [&](const char* s, int64_t len) {
        // keyv[i] = 3-bit-packed s[i..i+k-1] for all full windows
        keyv.clear();
        if (len < k) return;
        uint64_t key = 0;
        for (int64_t j = 0; j < k - 1; j++)
            key = (key << 3) | (uint64_t)code[(unsigned char)s[j]];
        for (int64_t i = 0; i + k <= len; i++) {
            key = ((key << 3)
                   | (uint64_t)code[(unsigned char)s[i + k - 1]]) & kmask;
            keyv.push_back(key);
        }
    };

    // load_reference: the reference's exact len-k-1 bound
    roll_keys(ref, ref_len);
    int32_t prev_b = -1;
    for (int64_t i = 0; i < ref_len - k - 1; i++) {
        int32_t a = prev_b >= 0
            ? (g.nodes[prev_b].colours |= REF,
               g.nodes[prev_b].weight += 1.0, prev_b)
            : g.insert_or_update(keyv[i], REF, ref_start + i, 1.0);
        int32_t b = g.insert_or_update(keyv[i + 1], REF, ref_start + i + 1,
                                       1.0);
        g.link(a, b, 1.0);
        prev_b = b;
    }
    // load_read: k+1-window min quality >= min_qual, no Ns in the window
    for (int64_t r = 0; r < n_reads; r++) {
        if (flags[r] & 0x200) continue;  // BAM_FQCFAIL
        const char* s = reads + read_off[r];
        const uint8_t* q = quals + read_off[r];
        const int64_t len = read_off[r + 1] - read_off[r];
        roll_keys(s, len);
        prev_b = -1;
        for (int64_t i = 0; i < len - k - 1; i++) {
            int64_t this_min = 255;
            bool ok = true;
            for (int64_t j = i; j <= i + k; j++) {
                if (q[j] < this_min) this_min = q[j];
                if (s[j] == 'N') { ok = false; break; }
            }
            if (ok && this_min >= min_qual) {
                const double w = (double)this_min;
                int32_t a = prev_b >= 0
                    ? (g.nodes[prev_b].colours |= READ,
                       g.nodes[prev_b].weight += w, prev_b)
                    : g.insert_or_update(keyv[i], READ, -1, w);
                int32_t b = g.insert_or_update(keyv[i + 1], READ, -1, w);
                g.link(a, b, w);
                prev_b = b;
            } else {
                prev_b = -1;
            }
        }
    }

    auto* h = new Handle();
    h->n_nodes = (int64_t)g.nodes.size();
    const double min_weight = (double)(min_reads * min_qual);
    bubble_dfs(g.nodes, k, min_weight,
               [&](int32_t id) { return g.decode(id); }, h);
    return h;
}

}  // namespace

extern "C" void* gt_dbg_window(
    const char* ref, int64_t ref_len, int64_t ref_start,
    const char* reads, const int64_t* read_off,  // [n_reads+1]
    const uint8_t* quals,                        // same offsets as reads
    const int32_t* flags, int64_t n_reads,
    int64_t k, int64_t min_qual, int64_t min_reads) {
    // fast-path eligibility: ACGTN alphabet and k packable into 64 bits
    bool fast = k <= 21;
    if (fast) {
        const int8_t* code = code3_table();
        for (int64_t i = 0; fast && i < ref_len; i++)
            fast = code[(unsigned char)ref[i]] != 7;
        const int64_t nb = read_off[n_reads];
        for (int64_t i = 0; fast && i < nb; i++)
            fast = code[(unsigned char)reads[i]] != 7;
    }
    if (fast)
        return build_fast(ref, ref_len, ref_start, reads, read_off, quals,
                          flags, n_reads, k, min_qual, min_reads);

    Graph g{k, {}, {}, {}};
    std::string k1, k2;
    // load_reference: the reference's exact len-k-1 bound
    for (int64_t i = 0; i < ref_len - k - 1; i++) {
        k1.assign(ref + i, k);
        k2.assign(ref + i + 1, k);
        g.add_edge(k1, k2, REF, ref_start + i, ref_start + i + 1, 1.0, 1.0);
    }
    // load_read: k+1-window min quality >= min_qual, no Ns in the window
    for (int64_t r = 0; r < n_reads; r++) {
        if (flags[r] & 0x200) continue;  // BAM_FQCFAIL
        const char* s = reads + read_off[r];
        const uint8_t* q = quals + read_off[r];
        const int64_t len = read_off[r + 1] - read_off[r];
        for (int64_t i = 0; i < len - k - 1; i++) {
            int64_t this_min = 255;
            bool ok = true;
            for (int64_t j = i; j <= i + k; j++) {
                if (q[j] < this_min) this_min = q[j];
                if (s[j] == 'N') { ok = false; break; }
            }
            if (ok && this_min >= min_qual) {
                k1.assign(s + i, k);
                k2.assign(s + i + 1, k);
                g.add_edge(k1, k2, READ, -1, -1, (double)this_min,
                           (double)this_min);
            }
        }
    }

    auto* h = new Handle();
    h->n_nodes = (int64_t)g.nodes.size();
    const double min_weight = (double)(min_reads * min_qual);
    bubble_dfs(g.nodes, k, min_weight,
               [&](int32_t id) { return g.kmers[id]; }, h);
    return h;
}

extern "C" int64_t gt_dbg_n_nodes(void* hp) {
    return static_cast<Handle*>(hp)->n_nodes;
}

extern "C" int64_t gt_dbg_n_bubbles(void* hp) {
    return (int64_t)static_cast<Handle*>(hp)->bubbles.size();
}

extern "C" int64_t gt_dbg_seq_bytes(void* hp) {
    return static_cast<Handle*>(hp)->seq_bytes;
}

extern "C" void gt_dbg_copy(void* hp, char* seqs) {
    auto* h = static_cast<Handle*>(hp);
    for (const auto& s : h->bubbles) {
        std::memcpy(seqs, s.data(), s.size());
        seqs += s.size();
        *seqs++ = '\n';
    }
}

extern "C" void gt_dbg_free(void* hp) { delete static_cast<Handle*>(hp); }
