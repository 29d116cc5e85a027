// CRAM 3.0 decoder of the port's native host engine: a copy of the JAX
// package's decoder, for the coverage_analysis and cnv_calling tools.
//
// The upstream tools read CRAM through samtools subprocesses (BASELINE
// config 4 is "30x WGS CRAM"); this is an in-process reader producing
// per-record alignment arrays (ref_id, pos, reference span, mapq, flags,
// read length) and samtools-depth difference arrays (vctpu_cram_depth),
// the same depth the BAM walker (vctpu_bam_depth) gives.
//
// Scope: CRAM 3.0 (the htslib default writer format), block compression
// raw/gzip/rANS-4x8, encodings NULL/EXTERNAL/HUFFMAN/BETA/BYTE_ARRAY_LEN/
// BYTE_ARRAY_STOP/GAMMA. CRAM 3.1 codecs and the rare golomb/subexp
// encodings return an error; io/cram.py raises ValueError on it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <map>
#include <string>
#include <vector>

#include <zlib.h>

namespace cram {

// ---------------------------------------------------------------------------
// byte cursor + ITF8/LTF8
// ---------------------------------------------------------------------------

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint8_t u8() {
        if (p >= end) { ok = false; return 0; }
        return *p++;
    }
    uint32_t u32le() {
        if (p + 4 > end) { ok = false; return 0; }
        uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
                     ((uint32_t)p[3] << 24);
        p += 4;
        return v;
    }
    void skip(int64_t n) {
        if (p + n > end) { ok = false; p = end; } else { p += n; }
    }
    int32_t itf8() {
        uint8_t b0 = u8();
        if ((b0 & 0x80) == 0) return b0;
        if ((b0 & 0x40) == 0) return ((b0 & 0x3F) << 8) | u8();
        if ((b0 & 0x20) == 0) {
            int32_t v = (b0 & 0x1F) << 16; v |= u8() << 8; v |= u8(); return v;
        }
        if ((b0 & 0x10) == 0) {
            int32_t v = (b0 & 0x0F) << 24; v |= u8() << 16; v |= u8() << 8; v |= u8(); return v;
        }
        int32_t v = (b0 & 0x0F) << 28; v |= u8() << 20; v |= u8() << 12; v |= u8() << 4;
        v |= (u8() & 0x0F);
        return v;
    }
    int64_t ltf8() {
        uint8_t b0 = u8();
        int n = 0;
        for (int i = 7; i >= 0; i--) {
            if (b0 & (1 << i)) n++; else break;
        }
        int64_t v = (n < 8) ? (b0 & ((1 << (7 - n)) - 1)) : 0;
        for (int i = 0; i < n; i++) v = (v << 8) | u8();
        return v;
    }
};

// ---------------------------------------------------------------------------
// rANS 4x8 (order 0 and 1) — spec section 13 / htslib rANS_static
// ---------------------------------------------------------------------------

// corrupt-size guard: real CRAM blocks are <= a few MB (htslib slices hold
// ~10k records); 256 MB bounds pathological headers without rejecting any
// legitimate file
static const int64_t MAX_BLOCK_RAW = int64_t(1) << 28;

static const uint32_t RANS_LOW = 1u << 23;

struct RansSyms {
    uint16_t fc[256];  // freq
    uint16_t cc[256];  // cumulative
    uint8_t rev[4096];
};

static bool read_freq_table0(Cursor& c, RansSyms& t) {
    memset(t.fc, 0, sizeof(t.fc));
    memset(t.cc, 0, sizeof(t.cc));
    int x = 0, rle = 0;
    int j = c.u8();
    do {
        int f = c.u8();
        if (f >= 128) f = ((f & 127) << 8) | c.u8();
        if (!c.ok || x + f > 4096) return false;
        t.fc[j] = f;
        t.cc[j] = x;
        if (f) memset(&t.rev[x], j, f);
        x += f;
        if (!rle && c.p < c.end && *c.p == j + 1) {
            j = c.u8();
            rle = c.u8();
        } else if (rle) {
            rle--;
            j++;
        } else {
            j = c.u8();
        }
    } while (j && c.ok);
    return c.ok;
}

static bool rans_uncompress(const uint8_t* in, int64_t in_len, std::vector<uint8_t>& out) {
    Cursor c{in, in + in_len};
    int order = c.u8();
    uint32_t comp_sz = c.u32le();
    uint32_t raw_sz = c.u32le();
    (void)comp_sz;
    if (!c.ok || raw_sz > (uint32_t)MAX_BLOCK_RAW) return false;
    out.resize(raw_sz);
    if (raw_sz == 0) return true;

    auto renorm = [&](uint32_t& x) {
        while (x < RANS_LOW && c.p < c.end) x = (x << 8) | c.u8();
    };

    if (order == 0) {
        RansSyms t;
        if (!read_freq_table0(c, t)) return false;
        uint32_t R[4];
        for (int i = 0; i < 4; i++) R[i] = c.u32le();
        if (!c.ok) return false;
        for (uint32_t i = 0; i < raw_sz; i++) {
            uint32_t& x = R[i & 3];
            uint32_t m = x & 0xFFF;
            uint8_t s = t.rev[m];
            out[i] = s;
            x = t.fc[s] * (x >> 12) + m - t.cc[s];
            renorm(x);
        }
        return true;
    }
    if (order == 1) {
        static thread_local std::vector<RansSyms> tables;
        tables.assign(256, RansSyms());
        std::vector<bool> present(256, false);
        int rle = 0;
        int i = c.u8();
        do {
            if (!read_freq_table0(c, tables[i])) return false;
            present[i] = true;
            if (!rle && c.p < c.end && *c.p == i + 1) {
                i = c.u8();
                rle = c.u8();
            } else if (rle) {
                rle--;
                i++;
            } else {
                i = c.u8();
            }
        } while (i && c.ok);
        if (!c.ok) return false;
        uint32_t R[4];
        for (int k = 0; k < 4; k++) R[k] = c.u32le();
        if (!c.ok) return false;
        uint32_t isz4 = raw_sz >> 2;
        uint8_t last[4] = {0, 0, 0, 0};
        for (uint32_t pos = 0; pos < isz4; pos++) {
            for (int k = 0; k < 4; k++) {
                uint32_t& x = R[k];
                RansSyms& t = tables[last[k]];
                uint32_t m = x & 0xFFF;
                uint8_t s = t.rev[m];
                out[pos + k * isz4] = s;
                x = t.fc[s] * (x >> 12) + m - t.cc[s];
                renorm(x);
                last[k] = s;
            }
        }
        // tail bytes with state 3
        for (uint32_t pos = 4 * isz4; pos < raw_sz; pos++) {
            uint32_t& x = R[3];
            RansSyms& t = tables[last[3]];
            uint32_t m = x & 0xFFF;
            uint8_t s = t.rev[m];
            out[pos] = s;
            x = t.fc[s] * (x >> 12) + m - t.cc[s];
            renorm(x);
            last[3] = s;
        }
        return true;
    }
    return false;
}

static bool gzip_inflate_vec(const uint8_t* in, int64_t in_len, std::vector<uint8_t>& out,
                             int64_t raw_size) {
    out.resize(raw_size);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(in);
    zs.avail_in = (uInt)in_len;
    zs.next_out = out.data();
    zs.avail_out = (uInt)out.size();
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END && zs.total_out == (uLong)raw_size;
}

// ---------------------------------------------------------------------------
// blocks
// ---------------------------------------------------------------------------

struct Block {
    int content_type = -1;
    int content_id = -1;
    std::vector<uint8_t> data;
};

static bool read_block(Cursor& c, Block& b) {
    int method = c.u8();
    b.content_type = c.u8();
    b.content_id = c.itf8();
    int32_t comp_size = c.itf8();
    int32_t raw_size = c.itf8();
    if (!c.ok || comp_size < 0 || raw_size < 0 || raw_size > MAX_BLOCK_RAW ||
        c.p + comp_size > c.end)
        return false;
    const uint8_t* payload = c.p;
    c.skip(comp_size);
    c.skip(4);  // CRC32 (v3)
    if (!c.ok) return false;
    switch (method) {
        case 0:  // raw
            b.data.assign(payload, payload + comp_size);
            return true;
        case 1:  // gzip
            return gzip_inflate_vec(payload, comp_size, b.data, raw_size);
        case 4:  // rANS 4x8
            return rans_uncompress(payload, comp_size, b.data) &&
                   (int64_t)b.data.size() == raw_size;
        default:  // bzip2/lzma/3.1 codecs unsupported
            return false;
    }
}

// ---------------------------------------------------------------------------
// encodings
// ---------------------------------------------------------------------------

struct Encoding {
    int codec = 0;  // 0 null, 1 external, 3 huffman, 4 b.a.len, 5 b.a.stop, 6 beta, 9 gamma
    int content_id = -1;
    // huffman: canonical table precomputed once at parse time (decode runs
    // per record x per feature — rebuilding it per symbol would dominate)
    std::vector<int32_t> symbols;
    std::vector<int32_t> lengths;
    std::vector<int32_t> canon_sym;   // sorted (len, sym) order
    std::vector<int32_t> canon_len;
    std::vector<int64_t> canon_code;
    // beta
    int32_t offset = 0;
    int32_t nbits = 0;
    // byte_array_stop
    uint8_t stop = 0;
    // byte_array_len nested (parsed once: [0]=lengths encoding, [1]=values)
    std::vector<Encoding> children;
};

static void build_canonical(Encoding& e) {
    size_t n = e.symbols.size();
    std::vector<size_t> order(n);
    for (size_t i = 0; i < n; i++) order[i] = i;
    // canonical order: ascending code length, ties by symbol value (spec §3.4)
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return e.lengths[a] != e.lengths[b] ? e.lengths[a] < e.lengths[b]
                                            : e.symbols[a] < e.symbols[b];
    });
    e.canon_sym.resize(n);
    e.canon_len.resize(n);
    e.canon_code.resize(n);
    int64_t next_code = 0;
    int prev_len = n ? e.lengths[order[0]] : 0;
    for (size_t i = 0; i < n; i++) {
        e.canon_sym[i] = e.symbols[order[i]];
        e.canon_len[i] = e.lengths[order[i]];
        next_code <<= (e.canon_len[i] - prev_len);
        prev_len = e.canon_len[i];
        e.canon_code[i] = next_code++;
    }
}

struct BitReader {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    int bit = 0;
    bool ok = true;

    int read_bit() {
        if (p >= end) { ok = false; return 0; }
        int v = (*p >> (7 - bit)) & 1;
        if (++bit == 8) { bit = 0; p++; }
        return v;
    }
    int64_t read_bits(int n) {
        int64_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
        return v;
    }
};

struct Slice;  // fwd

struct Streams {
    std::map<int, Cursor> ext;  // content id -> cursor over external block
    BitReader core;
};

static bool parse_encoding(Cursor& c, Encoding& e) {
    e.codec = c.itf8();
    int32_t plen = c.itf8();
    if (!c.ok || c.p + plen > c.end) return false;
    Cursor pc{c.p, c.p + plen};
    c.skip(plen);
    switch (e.codec) {
        case 0:
            return true;
        case 1:  // EXTERNAL
            e.content_id = pc.itf8();
            return pc.ok;
        case 3: {  // HUFFMAN
            int32_t n = pc.itf8();
            if (n < 0 || n > (1 << 20)) return false;
            for (int i = 0; i < n && pc.ok; i++) e.symbols.push_back(pc.itf8());
            int32_t m = pc.itf8();
            if (m != n) return false;
            for (int i = 0; i < m && pc.ok; i++) e.lengths.push_back(pc.itf8());
            if (!pc.ok || e.symbols.size() != e.lengths.size()) return false;
            build_canonical(e);
            return true;
        }
        case 4: {  // BYTE_ARRAY_LEN: nested (lengths encoding, values encoding)
            e.children.resize(2);
            return parse_encoding(pc, e.children[0]) && parse_encoding(pc, e.children[1]);
        }
        case 5:  // BYTE_ARRAY_STOP
            e.stop = pc.u8();
            e.content_id = pc.itf8();
            return pc.ok;
        case 6:  // BETA
            e.offset = pc.itf8();
            e.nbits = pc.itf8();
            return pc.ok;
        case 9:  // GAMMA
            e.offset = pc.itf8();
            return pc.ok;
        default:
            return false;  // golomb/subexp/rice unsupported
    }
}

// canonical huffman decode over the precomputed table (build_canonical)
static bool huffman_decode(const Encoding& e, BitReader& br, int32_t& out) {
    size_t n = e.canon_sym.size();
    if (n == 1 || (n > 0 && e.canon_len[0] == 0)) {  // constant
        out = e.canon_sym[0];
        return true;
    }
    int64_t code = 0;
    int len = 0;
    size_t i = 0;  // table is length-sorted: scan forward as bits accrue
    while (br.ok && len <= 31) {
        code = (code << 1) | br.read_bit();
        len++;
        while (i < n && e.canon_len[i] < len) i++;
        for (size_t j = i; j < n && e.canon_len[j] == len; j++) {
            if (e.canon_code[j] == code) {
                out = e.canon_sym[j];
                return true;
            }
        }
    }
    return false;
}

static bool decode_int(const Encoding& e, Streams& s, int32_t& out);

static bool decode_byte(const Encoding& e, Streams& s, uint8_t& out) {
    switch (e.codec) {
        case 1: {
            auto it = s.ext.find(e.content_id);
            if (it == s.ext.end()) return false;
            out = it->second.u8();
            return it->second.ok;
        }
        case 3: {
            int32_t v;
            if (!huffman_decode(e, s.core, v)) return false;
            out = (uint8_t)v;
            return true;
        }
        case 6: {
            out = (uint8_t)(s.core.read_bits(e.nbits) - e.offset);
            return s.core.ok;
        }
        default:
            return false;
    }
}

static bool decode_int(const Encoding& e, Streams& s, int32_t& out) {
    switch (e.codec) {
        case 1: {  // EXTERNAL: ITF8 from the external stream
            auto it = s.ext.find(e.content_id);
            if (it == s.ext.end()) return false;
            out = it->second.itf8();
            return it->second.ok;
        }
        case 3:
            return huffman_decode(e, s.core, out);
        case 6:
            out = (int32_t)(s.core.read_bits(e.nbits)) - e.offset;
            return s.core.ok;
        case 9: {  // GAMMA
            int zeros = 0;
            while (s.core.ok && s.core.read_bit() == 0) zeros++;
            int64_t v = 1;
            for (int i = 0; i < zeros; i++) v = (v << 1) | s.core.read_bit();
            out = (int32_t)v - e.offset;
            return s.core.ok;
        }
        default:
            return false;
    }
}

static bool decode_byte_array(const Encoding& e, Streams& s, std::vector<uint8_t>& out,
                              int32_t known_len = -1) {
    out.clear();
    switch (e.codec) {
        case 1: {  // EXTERNAL with caller-known length
            if (known_len < 0) return false;
            auto it = s.ext.find(e.content_id);
            if (it == s.ext.end()) return false;
            Cursor& c = it->second;
            if (c.p + known_len > c.end) { c.ok = false; return false; }
            out.assign(c.p, c.p + known_len);
            c.skip(known_len);
            return true;
        }
        case 4: {  // BYTE_ARRAY_LEN (children parsed once at header time)
            if (e.children.size() != 2) return false;
            const Encoding& len_enc = e.children[0];
            const Encoding& val_enc = e.children[1];
            int32_t n;
            if (!decode_int(len_enc, s, n) || n < 0 || n > (1 << 28)) return false;
            if (val_enc.codec == 1) return decode_byte_array(val_enc, s, out, n);
            out.resize(n);
            for (int i = 0; i < n; i++)
                if (!decode_byte(val_enc, s, out[i])) return false;
            return true;
        }
        case 5: {  // BYTE_ARRAY_STOP
            auto it = s.ext.find(e.content_id);
            if (it == s.ext.end()) return false;
            Cursor& c = it->second;
            while (c.p < c.end && *c.p != e.stop) out.push_back(*c.p++);
            if (c.p < c.end) c.p++;  // consume stop
            return true;
        }
        default:
            return false;
    }
}

// ---------------------------------------------------------------------------
// compression header
// ---------------------------------------------------------------------------

struct CompHeader {
    bool ap_delta = true;
    bool rn_preserved = true;
    uint8_t sub[5][4] = {{1, 2, 3, 4}, {0, 2, 3, 4}, {0, 1, 3, 4}, {0, 1, 2, 4}, {0, 1, 2, 3}};
    std::map<uint16_t, Encoding> series;      // 2-char key -> encoding
    std::map<int32_t, Encoding> tag_enc;      // packed tag key -> encoding
    std::vector<std::vector<int32_t>> tag_lines;  // TD: tag ids per line
};

// pileup accumulation target: one contig window, (len, 4) base counts
struct PileupCtx {
    int32_t target_ref;
    int64_t start0;  // 0-based inclusive
    int64_t end0;    // 0-based exclusive
    const uint8_t* ref_seq;  // ASCII bases of the FULL target contig
    int64_t ref_len;
    int32_t* counts;  // (end0-start0, 4) row-major
};

// depth accumulation target: per-contig difference arrays with samtools
// depth -a -J -q -Q -l semantics — the CRAM twin of vctpu_bam_depth.
// Aligned (read-backed) positions pass the per-base quality filter from
// the record's quality array (missing qualities read as 0xFF = pass, as
// samtools treats '*' quals); deletions cover iff include_del; N
// (reference skips) never cover.
struct DepthCtx {
    const int64_t* contig_starts;  // per ref_id offset into diff_flat, -1 skip
    const int64_t* contig_lens;
    int32_t n_refs;
    int32_t* diff_flat;
    int32_t min_bq, min_mapq, min_len;
    int32_t include_del;
    uint32_t exclude_flags;
};

static inline int base_code(uint8_t ch) {
    switch (ch) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 4;
    }
}

static inline void pileup_add(PileupCtx* pc, int64_t ref_pos1, int code) {
    // ref_pos1 is 1-based; count aligned A/C/G/T bases inside the window
    if (code >= 4) return;
    int64_t off = ref_pos1 - 1 - pc->start0;
    if (off < 0 || off >= pc->end0 - pc->start0) return;
    pc->counts[off * 4 + code]++;
}

static uint16_t key2(const char* k) { return ((uint16_t)k[0] << 8) | (uint8_t)k[1]; }

static bool parse_comp_header(const Block& b, CompHeader& h) {
    Cursor c{b.data.data(), b.data.data() + b.data.size()};
    // preservation map
    int32_t psize = c.itf8();
    (void)psize;
    int32_t n = c.itf8();
    for (int i = 0; i < n && c.ok; i++) {
        uint16_t k = ((uint16_t)c.u8() << 8) | c.u8();
        if (k == key2("RN")) h.rn_preserved = c.u8() != 0;
        else if (k == key2("AP")) h.ap_delta = c.u8() != 0;
        else if (k == key2("RR")) c.u8();
        else if (k == key2("SM")) {
            // substitution matrix: one byte per ref base (ACGTN order); the
            // byte holds 2-bit codes for the four other bases in ACGTN
            // order; BS code k selects the alt whose assigned code == k
            for (int ri = 0; ri < 5; ri++) {
                uint8_t b = c.u8();
                int j = 0;
                for (int alt = 0; alt < 5; alt++) {
                    if (alt == ri) continue;
                    uint8_t code = (b >> (6 - 2 * j)) & 3;
                    h.sub[ri][code] = (uint8_t)alt;
                    j++;
                }
            }
        }
        else if (k == key2("TD")) {
            int32_t tdlen = c.itf8();
            const uint8_t* td = c.p;
            c.skip(tdlen);
            // TD: \0-separated lines of 3-byte tag descriptors
            std::vector<int32_t> line;
            for (int32_t j = 0; j < tdlen; j++) {
                if (td[j] == 0) {
                    h.tag_lines.push_back(line);
                    line.clear();
                } else if (j + 2 < tdlen) {
                    line.push_back(((int32_t)td[j] << 16) | ((int32_t)td[j + 1] << 8) | td[j + 2]);
                    j += 2;
                }
            }
        } else {
            return false;  // unknown preservation key: layout unknown
        }
    }
    // data series encodings
    int32_t dsize = c.itf8();
    (void)dsize;
    n = c.itf8();
    for (int i = 0; i < n && c.ok; i++) {
        uint16_t k = ((uint16_t)c.u8() << 8) | c.u8();
        Encoding e;
        if (!parse_encoding(c, e)) return false;
        h.series[k] = e;
    }
    // tag encodings
    int32_t tsize = c.itf8();
    (void)tsize;
    n = c.itf8();
    for (int i = 0; i < n && c.ok; i++) {
        int32_t k = c.itf8();
        Encoding e;
        if (!parse_encoding(c, e)) return false;
        h.tag_enc[k] = e;
    }
    return c.ok;
}

// ---------------------------------------------------------------------------
// record decode
// ---------------------------------------------------------------------------

struct RecOut {
    int32_t* ref_id;
    int64_t* pos;
    int32_t* span;
    int32_t* mapq;
    int32_t* flags;
    int32_t* read_len;
};

static bool get_enc(const CompHeader& h, const char* k, Encoding& e) {
    auto it = h.series.find(key2(k));
    if (it == h.series.end()) return false;
    e = it->second;
    return true;
}

// decode all records of one slice; returns count or -1
static int64_t decode_slice(const CompHeader& h, int container_ref,
                            const std::vector<Block>& blocks, RecOut out, int64_t out_off,
                            int64_t max_records, PileupCtx* pc = nullptr,
                            DepthCtx* dc = nullptr) {
    // slice header is blocks[0]
    Cursor sh{blocks[0].data.data(), blocks[0].data.data() + blocks[0].data.size()};
    int32_t slice_ref = sh.itf8();
    int32_t slice_start = sh.itf8();
    sh.itf8();  // span
    int32_t n_records = sh.itf8();
    sh.ltf8();  // record counter
    sh.itf8();  // n blocks
    int32_t n_ids = sh.itf8();
    for (int i = 0; i < n_ids; i++) sh.itf8();
    sh.itf8();  // embedded ref content id
    if (!sh.ok) return -1;

    Streams s;
    for (size_t i = 1; i < blocks.size(); i++) {
        const Block& b = blocks[i];
        if (b.content_type == 5)  // core
            s.core = BitReader{b.data.data(), b.data.data() + b.data.size(), 0, true};
        else if (b.content_type == 4)
            s.ext[b.content_id] = Cursor{b.data.data(), b.data.data() + b.data.size()};
    }

    Encoding eBF, eCF, eRI, eRL, eAP, eRG, eRN, eMF, eNS, eNP, eTS, eNF, eTL, eFN, eFC, eFP;
    Encoding eDL, eBA, eQS, eBS, eIN, eSC, eHC, ePD, eRS, eMQ, eBB, eQQ;
    bool hBF = get_enc(h, "BF", eBF), hCF = get_enc(h, "CF", eCF);
    bool hRI = get_enc(h, "RI", eRI), hRL = get_enc(h, "RL", eRL);
    bool hAP = get_enc(h, "AP", eAP), hRG = get_enc(h, "RG", eRG);
    bool hRN = get_enc(h, "RN", eRN), hMF = get_enc(h, "MF", eMF);
    bool hNS = get_enc(h, "NS", eNS), hNP = get_enc(h, "NP", eNP);
    bool hTS = get_enc(h, "TS", eTS), hNF = get_enc(h, "NF", eNF);
    bool hTL = get_enc(h, "TL", eTL), hFN = get_enc(h, "FN", eFN);
    bool hFC = get_enc(h, "FC", eFC), hFP = get_enc(h, "FP", eFP);
    bool hDL = get_enc(h, "DL", eDL), hBA = get_enc(h, "BA", eBA);
    bool hQS = get_enc(h, "QS", eQS), hBS = get_enc(h, "BS", eBS);
    bool hIN = get_enc(h, "IN", eIN), hSC = get_enc(h, "SC", eSC);
    bool hHC = get_enc(h, "HC", eHC), hPD = get_enc(h, "PD", ePD);
    bool hRS = get_enc(h, "RS", eRS), hMQ = get_enc(h, "MQ", eMQ);
    bool hBB = get_enc(h, "BB", eBB), hQQ = get_enc(h, "QQ", eQQ);
    if (!(hBF && hCF && hRL && hAP)) return -1;

    int64_t last_pos = slice_start;
    std::vector<uint8_t> scratch;
    // depth bookkeeping (hoisted: cleared per record)
    struct Seg { int64_t ref_start, read_start, len; int kind; };  // kind 1 = deletion
    std::vector<Seg> segs;
    std::vector<uint8_t> squal;
    for (int32_t r = 0; r < n_records; r++) {
        if (out_off + r >= max_records) return -4;  // caller grows the buffers
        int32_t bf, cf, ri = container_ref, rl, ap, v;
        if (!decode_int(eBF, s, bf)) return -1;
        if (!decode_int(eCF, s, cf)) return -1;
        if (container_ref == -2) {
            if (!hRI || !decode_int(eRI, s, ri)) return -1;
        } else {
            ri = (slice_ref != -2) ? slice_ref : container_ref;
        }
        if (!decode_int(eRL, s, rl)) return -1;
        if (!decode_int(eAP, s, ap)) return -1;
        int64_t pos;
        if (h.ap_delta) {
            pos = last_pos + ap;
            last_pos = pos;
        } else {
            pos = ap;
        }
        if (hRG && !decode_int(eRG, s, v)) return -1;
        if (h.rn_preserved) {
            if (!hRN || !decode_byte_array(eRN, s, scratch)) return -1;
        }
        if (cf & 0x2) {  // detached mate
            if (!hMF || !decode_int(eMF, s, v)) return -1;
            if (!h.rn_preserved) {
                if (!hRN || !decode_byte_array(eRN, s, scratch)) return -1;
            }
            if (!hNS || !decode_int(eNS, s, v)) return -1;
            if (!hNP || !decode_int(eNP, s, v)) return -1;
            if (!hTS || !decode_int(eTS, s, v)) return -1;
        } else if (cf & 0x4) {  // mate downstream
            if (!hNF || !decode_int(eNF, s, v)) return -1;
        }
        int32_t tl = -1;
        if (hTL && !decode_int(eTL, s, tl)) return -1;
        if (hTL && tl >= 0 && (size_t)tl < h.tag_lines.size()) {
            for (int32_t tag_key : h.tag_lines[tl]) {
                auto it = h.tag_enc.find(tag_key);
                if (it == h.tag_enc.end()) return -1;
                if (!decode_byte_array(it->second, s, scratch)) return -1;
            }
        }
        int32_t span = rl;
        int32_t mapq = 0;
        if ((bf & 4) == 0) {  // mapped
            int32_t fn;
            if (!decode_int(eFN, s, fn)) return -1;
            int32_t soft = 0, ins = 0, dels = 0, skips = 0, hard = 0;
            // base reconstruction for pileup: bases between features match
            // the reference; X applies the SM substitution matrix
            bool do_pile = pc != nullptr && ri == pc->target_ref && (bf & 0x704) == 0;
            bool do_depth = dc != nullptr && ri >= 0 && ri < dc->n_refs &&
                            dc->contig_starts[ri] >= 0 &&
                            ((uint32_t)bf & dc->exclude_flags) == 0 && rl >= dc->min_len;
            const bool want_q = do_depth && dc->min_bq > 0;
            const bool track = do_pile || do_depth;
            segs.clear();
            if (want_q) squal.assign((size_t)rl, 0xFF);  // missing quals pass -q
            int64_t fabs_pos = 0;  // absolute 1-based in-read feature position
            int64_t rcur = 1;      // next read position to emit
            int64_t refp = pos;    // its reference position (1-based)
            auto ref_char = [&](int64_t p1) -> int {
                return (p1 >= 1 && p1 <= pc->ref_len) ? base_code(pc->ref_seq[p1 - 1]) : 4;
            };
            auto set_q = [&](int64_t read_pos1, uint8_t q) {
                if (want_q && read_pos1 >= 1 && read_pos1 <= rl) squal[read_pos1 - 1] = q;
            };
            auto aligned_run = [&](int64_t n) {  // n read bases consuming ref
                if (n <= 0) return;
                if (do_depth) segs.push_back({refp, rcur, n, 0});
                rcur += n;
                refp += n;
            };
            auto emit_matches = [&](int64_t upto) {
                int64_t n = upto - rcur;
                if (n <= 0) return;
                if (do_pile)
                    for (int64_t t = 0; t < n; t++) pileup_add(pc, refp + t, ref_char(refp + t));
                aligned_run(n);
            };
            for (int32_t f = 0; f < fn; f++) {
                uint8_t fc;
                int32_t fp;
                if (!decode_byte(eFC, s, fc)) return -1;
                if (!decode_int(eFP, s, fp)) return -1;
                fabs_pos += fp;
                if (track) emit_matches(fabs_pos);
                uint8_t bb;
                switch (fc) {
                    case 'B':
                        if (!hBA || !decode_byte(eBA, s, bb)) return -1;
                        if (do_pile) pileup_add(pc, refp, base_code(bb));
                        if (track) aligned_run(1);
                        if (!hQS || !decode_byte(eQS, s, bb)) return -1;
                        set_q(fabs_pos, bb);
                        break;
                    case 'X':
                        if (!hBS || !decode_int(eBS, s, v)) return -1;
                        if (do_pile) {
                            int rc = ref_char(refp);
                            int alt = rc < 4 ? h.sub[rc][v & 3] : 4;
                            pileup_add(pc, refp, alt);
                        }
                        if (track) aligned_run(1);
                        break;
                    case 'I':
                        if (!hIN || !decode_byte_array(eIN, s, scratch)) return -1;
                        ins += (int32_t)scratch.size();
                        if (track) rcur += (int64_t)scratch.size();
                        break;
                    case 'S':
                        if (!hSC || !decode_byte_array(eSC, s, scratch)) return -1;
                        soft += (int32_t)scratch.size();
                        if (track) rcur += (int64_t)scratch.size();
                        break;
                    case 'D':
                        if (!hDL || !decode_int(eDL, s, v)) return -1;
                        dels += v;
                        if (do_depth && dc->include_del && v > 0)
                            segs.push_back({refp, rcur, v, 1});
                        if (track) refp += v;
                        break;
                    case 'i':
                        if (!hBA || !decode_byte(eBA, s, bb)) return -1;
                        ins += 1;
                        if (track) rcur += 1;
                        break;
                    case 'N':  // reference skip: never covers (samtools parity)
                        if (!hRS || !decode_int(eRS, s, v)) return -1;
                        skips += v;
                        if (track) refp += v;
                        break;
                    case 'P':
                        if (!hPD || !decode_int(ePD, s, v)) return -1;
                        break;
                    case 'H':
                        if (!hHC || !decode_int(eHC, s, v)) return -1;
                        hard += v;
                        break;
                    case 'Q':
                        if (!hQS || !decode_byte(eQS, s, bb)) return -1;
                        set_q(fabs_pos, bb);
                        break;
                    case 'b':
                        if (!hBB || !decode_byte_array(eBB, s, scratch)) return -1;
                        if (do_pile)
                            for (size_t t = 0; t < scratch.size(); t++)
                                pileup_add(pc, refp + (int64_t)t, base_code(scratch[t]));
                        if (track) aligned_run((int64_t)scratch.size());
                        break;
                    case 'q':
                        if (!hQQ || !decode_byte_array(eQQ, s, scratch)) return -1;
                        for (size_t t = 0; t < scratch.size(); t++)
                            set_q(fabs_pos + (int64_t)t, scratch[t]);
                        break;
                    default:
                        return -1;
                }
            }
            if (track) emit_matches((int64_t)rl + 1);
            span = rl - soft - ins + dels + skips;
            if (!hMQ || !decode_int(eMQ, s, mapq)) return -1;
            if (cf & 0x1) {  // quality scores stored as array
                for (int32_t q = 0; q < rl; q++) {
                    uint8_t bb;
                    if (!hQS || !decode_byte(eQS, s, bb)) return -1;
                    if (want_q) squal[q] = bb;
                }
            }
            if (do_depth && mapq >= dc->min_mapq) {
                const int64_t base = dc->contig_starts[ri];
                const int64_t clen = dc->contig_lens[ri];
                for (const Seg& sg : segs) {
                    const int64_t ref0 = sg.ref_start - 1;  // 0-based
                    if (ref0 >= clen) continue;
                    if (sg.kind == 1 || dc->min_bq <= 0) {
                        const int64_t s0 = ref0 < 0 ? 0 : ref0;
                        const int64_t e0 = std::min(ref0 + sg.len, clen);
                        if (e0 > s0) {
                            dc->diff_flat[base + s0] += 1;
                            dc->diff_flat[base + e0] -= 1;
                        }
                    } else {
                        // RLE (qual >= min_bq) into diff updates, clamped by
                        // contig and quality-array bounds (vctpu_bam_depth
                        // run-length semantics)
                        int64_t run_s = -1;
                        int64_t max_j = std::min(sg.len, clen - ref0);
                        max_j = std::min(max_j, (int64_t)squal.size() - (sg.read_start - 1));
                        for (int64_t j = 0; j <= max_j; j++) {
                            bool okq = j < max_j && ref0 + j >= 0 &&
                                       (int32_t)squal[sg.read_start - 1 + j] >= dc->min_bq;
                            if (okq && run_s < 0) {
                                run_s = j;
                            } else if (!okq && run_s >= 0) {
                                dc->diff_flat[base + ref0 + run_s] += 1;
                                dc->diff_flat[base + ref0 + j] -= 1;
                                run_s = -1;
                            }
                        }
                    }
                }
            }
        } else {  // unmapped: bases then quals
            for (int32_t q = 0; q < rl; q++) {
                uint8_t bb;
                if (!hBA || !decode_byte(eBA, s, bb)) return -1;
            }
            if (cf & 0x1) {
                for (int32_t q = 0; q < rl; q++) {
                    uint8_t bb;
                    if (!hQS || !decode_byte(eQS, s, bb)) return -1;
                }
            }
        }
        if (out.ref_id != nullptr) {
            out.ref_id[out_off + r] = ri;
            out.pos[out_off + r] = pos;
            out.span[out_off + r] = span;
            out.mapq[out_off + r] = mapq;
            out.flags[out_off + r] = bf;
            out.read_len[out_off + r] = rl;
        }
    }
    return n_records;
}

}  // namespace cram

#include <algorithm>

extern "C" {

// SAM header text of a CRAM file -> out buffer; returns text length or
// negative (-1 malformed, -2 unsupported compression, -3 buffer too small).
static int64_t cram_header_impl(const uint8_t* buf, int64_t len, uint8_t* out, int64_t out_cap) {
    using namespace cram;
    if (len < 26 || memcmp(buf, "CRAM", 4) != 0) return -1;
    if (buf[4] != 3) return -2;  // major version
    Cursor c{buf + 26, buf + len};
    // first container = file header
    c.u32le();  // container length
    c.itf8(); c.itf8(); c.itf8(); c.itf8();  // ref id, start, span, n records
    c.ltf8(); c.ltf8();                      // counter, bases
    int32_t n_blocks = c.itf8();
    int32_t n_landmarks = c.itf8();
    for (int i = 0; i < n_landmarks; i++) c.itf8();
    c.skip(4);  // CRC
    if (!c.ok || n_blocks < 1) return -1;
    Block b;
    if (!read_block(c, b)) return -2;
    if (b.data.size() < 4) return -1;
    // block payload: int32 text length + SAM text
    int32_t text_len = (int32_t)b.data[0] | ((int32_t)b.data[1] << 8) |
                       ((int32_t)b.data[2] << 16) | ((int32_t)b.data[3] << 24);
    if (text_len < 0 || (size_t)text_len + 4 > b.data.size()) return -1;
    if (text_len > out_cap) return -3;
    memcpy(out, b.data.data() + 4, text_len);
    return text_len;
}

int64_t vctpu_cram_header(const uint8_t* buf, int64_t len, uint8_t* out, int64_t out_cap) {
    try {
        return cram_header_impl(buf, len, out, out_cap);
    } catch (...) {
        return -1;
    }
}

// Total record count across containers (header-only walk, no block decode).
// Lets callers allocate exact output buffers for scan. Negative on error.
int64_t vctpu_cram_count(const uint8_t* buf, int64_t len) {
    using namespace cram;
    if (len < 26 || memcmp(buf, "CRAM", 4) != 0) return -1;
    if (buf[4] != 3) return -2;
    Cursor c{buf + 26, buf + len};
    int64_t total = 0;
    bool first = true;
    bool saw_eof = false;
    while (c.ok && c.p < c.end) {
        int32_t cont_len = (int32_t)c.u32le();
        int32_t ref = c.itf8();
        c.itf8();
        c.itf8();
        int32_t n_rec = c.itf8();
        c.ltf8();
        c.ltf8();
        int32_t n_blocks = c.itf8();
        int32_t n_landmarks = c.itf8();
        for (int i = 0; i < n_landmarks; i++) c.itf8();
        c.skip(4);
        if (!c.ok || cont_len < 0 || c.p + cont_len > c.end) break;
        const uint8_t* body = c.p;
        if (ref == -1 && n_rec == 0 && n_blocks <= 1 && c.p + cont_len >= c.end) {
            saw_eof = true;
            break;
        }
        if (!first) total += n_rec;
        first = false;
        c = Cursor{body + cont_len, buf + len};
    }
    // no EOF container => truncated/corrupt stream, not a short file
    return saw_eof ? total : -1;
}

static int64_t cram_scan_impl(const uint8_t* buf, int64_t len, int64_t max_records,
                              int32_t* ref_id, int64_t* pos, int32_t* span, int32_t* mapq,
                              int32_t* flags, int32_t* read_len,
                              cram::PileupCtx* pctx = nullptr,
                              cram::DepthCtx* dctx = nullptr) {
    using namespace cram;
    if (len < 26 || memcmp(buf, "CRAM", 4) != 0) return -1;
    if (buf[4] != 3) return -2;
    Cursor c{buf + 26, buf + len};
    int64_t total = 0;
    bool first = true;
    bool saw_eof = false;
    while (c.ok && c.p < c.end) {
        const uint8_t* cont_start = c.p;
        int32_t cont_len = (int32_t)c.u32le();
        int32_t ref = c.itf8();
        int32_t start = c.itf8();
        (void)start;
        c.itf8();  // span
        int32_t n_rec = c.itf8();
        c.ltf8();  // counter
        c.ltf8();  // bases
        int32_t n_blocks = c.itf8();
        int32_t n_landmarks = c.itf8();
        for (int i = 0; i < n_landmarks; i++) c.itf8();
        c.skip(4);  // CRC
        // corrupt container length must neither rewind the cursor (infinite
        // loop) nor run past the buffer (OOB read)
        if (!c.ok || cont_len < 0 || c.p + cont_len > c.end) break;
        const uint8_t* body = c.p;
        // EOF container: ref -1, no records, 38-byte standard marker
        if (ref == -1 && n_rec == 0 && n_blocks <= 1 && c.p + cont_len >= c.end) {
            saw_eof = true;
            break;
        }
        if (first) {  // file header container
            first = false;
            c = Cursor{body + cont_len, buf + len};
            continue;
        }
        if (n_rec == 0) {  // e.g. multi-container EOF variants
            c = Cursor{body + cont_len, buf + len};
            continue;
        }
        // pileup/depth-only walks skip single-ref containers whose contig
        // contributes nothing — per-region work must not decode the genome
        // (multi-ref containers, ref == -2, still decode)
        if (ref_id == nullptr && ref >= 0) {
            bool skip = pctx != nullptr && dctx == nullptr && ref != pctx->target_ref;
            if (dctx != nullptr && pctx == nullptr &&
                (ref >= dctx->n_refs || dctx->contig_starts[ref] < 0))
                skip = true;
            if (skip) {
                c = Cursor{body + cont_len, buf + len};
                continue;
            }
        }
        Cursor cc{body, body + cont_len};
        Block chb;
        if (!read_block(cc, chb) || chb.content_type != 1) return -2;
        CompHeader h;
        if (!parse_comp_header(chb, h)) return -2;
        // remaining blocks: slices (each: slice header block + data blocks)
        while (cc.ok && cc.p < cc.end) {
            Block shb;
            if (!read_block(cc, shb)) return -2;
            if (shb.content_type != 2) break;
            // slice header tells how many data blocks follow
            Cursor sh{shb.data.data(), shb.data.data() + shb.data.size()};
            sh.itf8(); sh.itf8(); sh.itf8(); sh.itf8();
            sh.ltf8();
            int32_t s_blocks = sh.itf8();
            if (!sh.ok) return -1;
            std::vector<Block> blocks;
            blocks.push_back(shb);
            for (int32_t i = 0; i < s_blocks; i++) {
                Block db;
                if (!read_block(cc, db)) return -2;
                blocks.push_back(std::move(db));
            }
            RecOut out{ref_id, pos, span, mapq, flags, read_len};
            int64_t n = decode_slice(h, ref, blocks, out, total, max_records, pctx, dctx);
            if (n < 0) return n == -4 ? -4 : -1;
            total += n;
        }
        c = Cursor{body + cont_len, buf + len};
        (void)cont_start;
    }
    // a stream without its EOF container was truncated mid-write/transfer
    return saw_eof ? total : -1;
}

// Decode all alignment records. Returns record count, or negative on error.
// Exception barrier: corrupt inputs must produce error codes at the ctypes
// boundary, never C++ exceptions (which would abort the Python process).
int64_t vctpu_cram_scan(const uint8_t* buf, int64_t len, int64_t max_records,
                        int32_t* ref_id, int64_t* pos, int32_t* span, int32_t* mapq,
                        int32_t* flags, int32_t* read_len) {
    try {
        return cram_scan_impl(buf, len, max_records, ref_id, pos, span, mapq, flags, read_len);
    } catch (...) {
        return -1;
    }
}

// Base-level pileup over [start0, end0) of one contig: records are decoded
// (streams are sequential so every record is consumed) and aligned bases
// reconstructed from the reference + SM substitution matrix. ``counts`` is
// (end0-start0, 4) row-major A/C/G/T. Returns records seen, negative on error.
int64_t vctpu_cram_pileup(const uint8_t* buf, int64_t len, int32_t target_ref,
                          int64_t start0, int64_t end0,
                          const uint8_t* ref_seq, int64_t ref_len, int32_t* counts) {
    try {
        cram::PileupCtx ctx{target_ref, start0, end0, ref_seq, ref_len, counts};
        return cram_scan_impl(buf, len, INT64_MAX, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, &ctx);
    } catch (...) {
        return -1;
    }
}

// Per-contig depth difference arrays with samtools depth -a -J -q -Q -l
// semantics (the CRAM twin of vctpu_bam_depth; reference call site
// coverage_analysis.py:674-678 — the `-q` base-quality filter applies to
// aligned read bases from the record's quality array, deletions cover iff
// include_del, N skips never cover). diff_flat holds the selected contigs
// back to back; contig_starts[ref_id] is that contig's (length+1)-long
// region offset or -1 to skip. Returns records seen, negative on error.
int64_t vctpu_cram_depth(const uint8_t* buf, int64_t len,
                         const int64_t* contig_starts, const int64_t* contig_lens,
                         int32_t n_refs, int32_t* diff_flat,
                         int32_t min_bq, int32_t min_mapq, int32_t min_len,
                         int32_t include_del, uint32_t exclude_flags) {
    try {
        cram::DepthCtx ctx{contig_starts, contig_lens, n_refs, diff_flat,
                           min_bq, min_mapq, min_len, include_del, exclude_flags};
        return cram_scan_impl(buf, len, INT64_MAX, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, &ctx);
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
