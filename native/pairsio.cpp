// Native pair-file I/O + bsw wire packing for the genomics framework.
//
// The bsw driver's input is the reference's 3-line record format
// (benchmarks/bsw/main_banded.cpp:148-202 loadPairs): an "<h0> ..." score
// line, then digit-coded target and query lines.  At the bsw_large scale
// (10.6M pairs / 3.8 GB, scripts/bsw_large:5-8) the vectorized-numpy
// parser spends ~22 s finding newlines and ~4 s parsing h0 digits, and
// the per-dispatch chunk prep (flat gather + mask scatter + 2-bit pack)
// costs another ~0.44 s x 162 chunks.  These are single-pass, memory-bandwidth-bound loops: they
// belong in C++ (same division of labor as the reference's C++ driver
// around its SIMD kernel).
//
// Exposed via the C ABI for ctypes (see io/native.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Number of complete 3-line records in buf (an unterminated final line
// counts, matching io/pairs.py's EOF-as-line-end rule).
int64_t gt_pairs_count(const uint8_t* buf, int64_t n) {
    int64_t lines = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
        lines++;
        if (!q) break;
        p = q + 1;
    }
    return lines / 3;
}

// Parse n records: h0 = first signed integer token of line 0 (digits stop
// at the first non-digit, like the vectorized parser), byte offsets and
// lengths of the target (line 1) and query (line 2) strings.  Offsets
// index the RAW buffer; callers decode via codes = int8(buf) - 48.
void gt_pairs_parse(const uint8_t* buf, int64_t nbytes, int64_t n,
                    int64_t* t_off, int32_t* t_len,
                    int64_t* q_off, int32_t* q_len, int32_t* h0) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + nbytes;
    for (int64_t i = 0; i < n; i++) {
        bool neg = (p < end && *p == '-');
        const uint8_t* s = p + (neg ? 1 : 0);
        int64_t v = 0;
        while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
        h0[i] = (int32_t)(neg ? -v : v);
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
        p = q ? q + 1 : end;

        q = (const uint8_t*)memchr(p, '\n', end - p);
        const uint8_t* e1 = q ? q : end;
        t_off[i] = p - buf;
        t_len[i] = (int32_t)(e1 - p);
        p = q ? q + 1 : end;

        q = (const uint8_t*)memchr(p, '\n', end - p);
        const uint8_t* e2 = q ? q : end;
        q_off[i] = p - buf;
        q_len[i] = (int32_t)(e2 - p);
        p = q ? q + 1 : end;
    }
}

// 2-bit-pack n rows of base codes for the bsw wire format: row i holds
// codes[off[i] : off[i]+len[i]] packed 4 bases/byte (little-endian within
// the byte, matching ops/bsw.py pack_codes_2bit), zero-filled to
// pad/4 bytes.  `bias` is subtracted from every byte first (48 when off[]
// indexes the raw ASCII-digit file buffer, 0 for already-decoded codes).
// Returns the count of out-of-range codes (after bias, outside 0..3);
// nonzero means the caller must use the raw int8 path for this chunk.
int64_t gt_bsw_pack_rows(const int8_t* codes, const int64_t* off,
                         const int32_t* len, int64_t n, int64_t pad,
                         int32_t bias, uint8_t* out) {
    const int64_t pb = pad / 4;
    int64_t bad = 0;
    for (int64_t i = 0; i < n; i++) {
        const int8_t* src = codes + off[i];
        const int64_t L = len[i];
        uint8_t* dst = out + i * pb;
        const int64_t full = L / 4;
        for (int64_t b = 0; b < full; b++) {
            uint8_t c0 = (uint8_t)(src[4 * b + 0] - bias);
            uint8_t c1 = (uint8_t)(src[4 * b + 1] - bias);
            uint8_t c2 = (uint8_t)(src[4 * b + 2] - bias);
            uint8_t c3 = (uint8_t)(src[4 * b + 3] - bias);
            bad += (c0 > 3) + (c1 > 3) + (c2 > 3) + (c3 > 3);
            dst[b] = (uint8_t)((c0 & 3) | ((c1 & 3) << 2) | ((c2 & 3) << 4) |
                               ((c3 & 3) << 6));
        }
        uint8_t last = 0;
        for (int64_t r = full * 4; r < L; r++) {
            uint8_t c = (uint8_t)(src[r] - bias);
            bad += c > 3;
            last |= (uint8_t)((c & 3) << ((r & 3) * 2));
        }
        int64_t used = full;
        if (L % 4) dst[used++] = last;
        memset(dst + used, 0, (size_t)(pb - used));
    }
    return bad;
}

// Fused ASCII-digit decode: out = (int8)(in - 48) in one pass.  numpy's
// astype + in-place subtract is two full passes over the buffer; g++
// vectorizes this one.
void gt_sub48(const uint8_t* in, int64_t n, int8_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = (int8_t)(in[i] - 48);
}

// Raw int8 fallback rows: row i = codes[off[i] : off[i]+len[i]] - bias,
// filled with `fill` to pad columns (the ambiguous-base value 4).
void gt_bsw_pad_rows(const int8_t* codes, const int64_t* off,
                     const int32_t* len, int64_t n, int64_t pad,
                     int32_t bias, int8_t fill, int8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const int8_t* src = codes + off[i];
        int8_t* dst = out + i * pad;
        const int64_t L = len[i];
        if (bias == 0) {
            memcpy(dst, src, (size_t)L);
        } else {
            for (int64_t j = 0; j < L; j++) dst[j] = (int8_t)(src[j] - bias);
        }
        memset(dst + L, fill, (size_t)(pad - L));
    }
}

}  // extern "C"
