// Native host I/O for the genomics framework: fast FASTA/FASTQ
// parsing + 2-bit encoding (the role kseq.h/bseq plays in the reference's
// L1 layer — reimplemented, not ported). Exposed via a C ABI for ctypes.
//
// Build: see native/Makefile (produces libgenomics_native.so).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

struct ParsedReads {
    std::vector<int8_t> codes;     // concatenated 2-bit(+4=N) codes
    std::vector<int8_t> quals;     // concatenated phred (FASTQ only, else -1)
    std::vector<int64_t> offsets;  // per-read start into codes
    std::vector<int32_t> lengths;  // per-read length
};

int8_t code_table[256];

void init_tables() {
    static bool done = false;
    if (done) return;
    memset(code_table, 4, sizeof(code_table));
    code_table['A'] = code_table['a'] = 0;
    code_table['C'] = code_table['c'] = 1;
    code_table['G'] = code_table['g'] = 2;
    code_table['T'] = code_table['t'] = 3;
    done = true;
}

// Reads a whole (possibly gzipped) file into memory.
bool slurp(const char* path, std::vector<char>& out) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    char buf[1 << 20];
    int n;
    while ((n = gzread(f, buf, sizeof(buf))) > 0) {
        out.insert(out.end(), buf, buf + n);
    }
    gzclose(f);
    return n == 0;
}

ParsedReads* parse(const char* path, int64_t limit) {
    init_tables();
    std::vector<char> data;
    if (!slurp(path, data)) return nullptr;
    auto* pr = new ParsedReads();
    size_t i = 0, n = data.size();
    int64_t count = 0;
    while (i < n && (limit < 0 || count < limit)) {
        // skip blank lines
        while (i < n && (data[i] == '\n' || data[i] == '\r')) i++;
        if (i >= n) break;
        char tag = data[i];
        if (tag == '>') {
            while (i < n && data[i] != '\n') i++;  // header
            i++;
            pr->offsets.push_back((int64_t)pr->codes.size());
            int32_t len = 0;
            while (i < n && data[i] != '>' && data[i] != '@') {
                char c = data[i++];
                if (c == '\n' || c == '\r') continue;
                pr->codes.push_back(code_table[(uint8_t)c]);
                len++;
            }
            pr->lengths.push_back(len);
            count++;
        } else if (tag == '@') {
            while (i < n && data[i] != '\n') i++;  // header
            i++;
            pr->offsets.push_back((int64_t)pr->codes.size());
            int32_t len = 0;
            while (i < n && data[i] != '\n') {
                pr->codes.push_back(code_table[(uint8_t)data[i++]]);
                len++;
            }
            i++;  // newline
            while (i < n && data[i] != '\n') i++;  // '+' line
            i++;
            for (int32_t q = 0; q < len && i < n; q++, i++) {
                pr->quals.push_back((int8_t)(data[i] - 33));
            }
            while (i < n && data[i] != '\n') i++;  // trailing
            i++;
            pr->lengths.push_back(len);
            count++;
        } else {
            while (i < n && data[i] != '\n') i++;  // unknown line: skip
            i++;
        }
    }
    return pr;
}

}  // namespace

extern "C" {

// Returns an opaque handle (or null). Caller must free with gt_free_reads.
void* gt_parse_reads(const char* path, int64_t limit) {
    return (void*)parse(path, limit);
}

int64_t gt_num_reads(void* h) { return (int64_t)((ParsedReads*)h)->lengths.size(); }
int64_t gt_total_bases(void* h) { return (int64_t)((ParsedReads*)h)->codes.size(); }
int64_t gt_num_quals(void* h) { return (int64_t)((ParsedReads*)h)->quals.size(); }

void gt_copy_out(void* h, int8_t* codes, int8_t* quals, int64_t* offsets,
                 int32_t* lengths) {
    auto* pr = (ParsedReads*)h;
    if (codes) memcpy(codes, pr->codes.data(), pr->codes.size());
    if (quals && !pr->quals.empty())
        memcpy(quals, pr->quals.data(), pr->quals.size());
    if (offsets) memcpy(offsets, pr->offsets.data(), pr->offsets.size() * 8);
    if (lengths) memcpy(lengths, pr->lengths.data(), pr->lengths.size() * 4);
}

void gt_free_reads(void* h) { delete (ParsedReads*)h; }

// Batched 2-bit k-mer packing into u32 hi/lo planes (k<=32) — host-side
// pre-processing for the k-mer pipeline when CPU-bound.
void gt_pack_kmers_u32(const int8_t* codes, int64_t n, int32_t k,
                       uint32_t* hi, uint32_t* lo) {
    if (n < k + 1) return;
    uint64_t cur = 0;
    uint64_t mask = (k * 2 >= 64) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    for (int32_t i = 0; i < k; i++) cur = (cur << 2) | (uint64_t)(codes[i] & 3);
    hi[0] = (uint32_t)(cur >> 32);
    lo[0] = (uint32_t)cur;
    for (int64_t p = 1; p < n - k; p++) {
        cur = ((cur << 2) | (uint64_t)(codes[p + k - 1] & 3)) & mask;
        hi[p] = (uint32_t)(cur >> 32);
        lo[p] = (uint32_t)cur;
    }
}

}  // extern "C"
