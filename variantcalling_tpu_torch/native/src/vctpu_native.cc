// Native host engine of the port: BGZF codec, VCF record scanner, verbatim
// record assembly for writeback, FASTA body encode, interval membership,
// BAM depth walker and bedGraph text (the CRAM decoder is vctpu_cram.cc).
//
// A copy of the JAX package's native engine, trimmed to the entry points
// the filter pipeline's GPU path calls, so the port builds and loads it on
// its own. The host stages of that pipeline
// (ingest, host featurize, writeback) run here; every entry point has a
// plain Python version at its call site (io/vcf.py, io/bgzf.py,
// io/fasta.py, ops/intervals.py), byte-identical, which runs with
// VCTPU_NO_NATIVE=1 or where no compiler exists.
//
// Both formats are block-parallel by design (BGZF: independent gzip
// members; VCF: independent record lines), so the hot entry points shard
// across threads (vctpu_threads.h) with byte-identical output to the
// serial path. VCTPU_NATIVE_THREADS caps the fan-out.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC ... -lz
// (variantcalling_tpu_torch/native/__init__.py).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include "vctpu_threads.h"

namespace {

// Parse one gzip member header starting at src[off]; return the BGZF BSIZE
// (total block length) from the BC extra subfield, or -1 if not BGZF-framed.
int64_t bgzf_block_size(const uint8_t* src, int64_t n, int64_t off) {
    if (off + 18 > n) return -1;
    if (src[off] != 0x1f || src[off + 1] != 0x8b) return -1;
    if (!(src[off + 3] & 4)) return -1;  // FEXTRA required for BGZF
    uint16_t xlen = (uint16_t)src[off + 10] | ((uint16_t)src[off + 11] << 8);
    int64_t xoff = off + 12;
    int64_t xend = xoff + xlen;
    if (xend > n) return -1;
    while (xoff + 4 <= xend) {
        uint8_t s1 = src[xoff], s2 = src[xoff + 1];
        uint16_t slen = (uint16_t)src[xoff + 2] | ((uint16_t)src[xoff + 3] << 8);
        if (xoff + 4 + slen > xend) return -1;
        if (s1 == 'B' && s2 == 'C' && slen == 2) {
            int64_t bsize = ((int64_t)src[xoff + 4] | ((int64_t)src[xoff + 5] << 8)) + 1;
            return bsize;
        }
        xoff += 4 + slen;
    }
    return -1;
}

}  // namespace

extern "C" {

// Sum of ISIZE trailers across BGZF blocks (exact uncompressed size).
// Returns -1 when the stream is not pure BGZF framing (caller falls back).
int64_t vctpu_bgzf_uncompressed_size(const uint8_t* src, int64_t n) {
    int64_t off = 0, total = 0;
    while (off < n) {
        int64_t bsize = bgzf_block_size(src, n, off);
        if (bsize < 0 || bsize < 28 || off + bsize > n) return -1;
        uint32_t isize;
        std::memcpy(&isize, src + off + bsize - 4, 4);
        total += isize;
        off += bsize;
    }
    return off == n ? total : -1;
}

// Inflate a concatenated-gzip-member stream (BGZF is one) into dst.
// Returns bytes written, or -1 on error / capacity overflow.
int64_t vctpu_gzip_inflate(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return -1;  // auto gzip header
    int64_t in_off = 0, out_off = 0;
    int ret = Z_OK;
    uint8_t scratch[64];  // overflow detector for zero-output tail members
    while (in_off < n || ret == Z_OK) {
        uInt in_chunk = (uInt)std::min<int64_t>(n - in_off, 1 << 30);
        uInt out_chunk = (uInt)std::min<int64_t>(cap - out_off, 1 << 30);
        bool use_scratch = out_chunk == 0;
        zs.next_in = const_cast<uint8_t*>(src) + in_off;
        zs.avail_in = in_chunk;
        zs.next_out = use_scratch ? scratch : dst + out_off;
        zs.avail_out = use_scratch ? (uInt)sizeof scratch : out_chunk;
        uInt gave = zs.avail_out;
        ret = inflate(&zs, Z_NO_FLUSH);
        in_off += in_chunk - zs.avail_in;
        int64_t produced = (int64_t)(gave - zs.avail_out);
        if (use_scratch && produced > 0) {
            inflateEnd(&zs);
            return -1;  // capacity exhausted: member produced real output
        }
        if (!use_scratch) out_off += produced;
        if (ret == Z_STREAM_END) {
            if (in_off >= n) break;          // done: all members consumed
            if (inflateReset2(&zs, 15 + 32) != Z_OK) {  // next member
                inflateEnd(&zs);
                return -1;
            }
            ret = Z_OK;
            continue;
        }
        if (ret != Z_OK) {
            inflateEnd(&zs);
            return -1;
        }
        if (zs.avail_in == in_chunk && produced == 0) break;  // no progress
    }
    inflateEnd(&zs);
    return out_off;
}

// Block-parallel BGZF inflate: every member's output offset is known up
// front from the ISIZE prefix sum, so blocks decompress concurrently into
// disjoint ranges of dst (raw deflate payload + CRC verification — the
// same integrity check zlib's gzip mode performs on the serial path).
// Returns bytes written; -1 when the stream is not pure BGZF framing or
// cap is too small (caller falls back to vctpu_gzip_inflate); -2 on
// corrupt payload (bad deflate stream, ISIZE, or CRC mismatch).
int64_t vctpu_bgzf_inflate(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) try {
    struct Block { int64_t off, bsize, out_off; uint32_t isize; };
    std::vector<Block> blocks;
    blocks.reserve((size_t)(n / 4096) + 1);
    int64_t off = 0, total = 0;
    while (off < n) {
        int64_t bsize = bgzf_block_size(src, n, off);
        if (bsize < 28 || off + bsize > n) return -1;
        uint32_t isize;
        std::memcpy(&isize, src + off + bsize - 4, 4);
        blocks.push_back({off, bsize, total, isize});
        total += isize;
        off += bsize;
    }
    if (off != n || total > cap) return -1;
    std::atomic<int> failed{0};
    // blocks are heavyweight (~64KB inflate each): shard at fine grain
    vctpu::for_shards((int64_t)blocks.size(), vctpu::nthreads(),
                      [&](int, int64_t lo, int64_t hi) {
        z_stream zs;
        std::memset(&zs, 0, sizeof zs);
        if (inflateInit2(&zs, -15) != Z_OK) {  // raw deflate per member
            failed.store(1);
            return;
        }
        for (int64_t b = lo; b < hi && !failed.load(std::memory_order_relaxed); ++b) {
            const Block& blk = blocks[b];
            uint16_t xlen = (uint16_t)src[blk.off + 10] | ((uint16_t)src[blk.off + 11] << 8);
            int64_t payload = blk.off + 12 + xlen;
            int64_t clen = blk.bsize - 12 - xlen - 8;
            if (clen < 0) { failed.store(1); break; }
            zs.next_in = const_cast<uint8_t*>(src) + payload;
            zs.avail_in = (uInt)clen;
            zs.next_out = dst + blk.out_off;
            zs.avail_out = blk.isize;
            int ret = inflate(&zs, Z_FINISH);
            if (ret != Z_STREAM_END || zs.avail_out != 0) { failed.store(1); break; }
            uint32_t crc_want;
            std::memcpy(&crc_want, src + blk.off + blk.bsize - 8, 4);
            if ((uint32_t)crc32(0L, dst + blk.out_off, blk.isize) != crc_want) {
                failed.store(1);
                break;
            }
            if (inflateReset2(&zs, -15) != Z_OK) { failed.store(1); break; }
        }
        inflateEnd(&zs);
    }, 16);
    return failed.load() ? -2 : total;
} catch (...) {
    return -1;  // bad_alloc / thread-spawn failure must not cross the C ABI
}

// Deflate src into independent BGZF blocks (<=65280B payload each) with the
// BC extra field + canonical EOF sentinel. Chunks are independent, so they
// compress in parallel into fixed-size scratch slots and compact serially —
// output bytes are identical to the serial path. Returns bytes written or -1.
int64_t vctpu_bgzf_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int level) try {
    static const uint8_t EOF_BLOCK[28] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
                                          0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0, 0, 0,
                                          0, 0, 0, 0, 0};
    const int64_t CHUNK = 65280;
    const int64_t SLOT = 66560;  // header + compressBound(65280) + trailer, padded
    const int64_t n_chunks = n > 0 ? (n + CHUNK - 1) / CHUNK : 0;
    // uninitialized scratch: every kept byte is written by deflate below,
    // and a value-initializing vector would memset ~1.02x the input first
    std::unique_ptr<uint8_t[]> scratch(new (std::nothrow) uint8_t[(size_t)(n_chunks * SLOT)]);
    if (n_chunks > 0 && !scratch) return -1;  // caller falls back to Python
    std::vector<int64_t> sizes((size_t)n_chunks, -1);
    vctpu::for_shards(n_chunks, vctpu::nthreads(), [&](int, int64_t lo, int64_t hi) {
        for (int64_t c = lo; c < hi; ++c) {
            const int64_t in_off = c * CHUNK;
            const int64_t len = std::min(CHUNK, n - in_off);
            z_stream zs;
            std::memset(&zs, 0, sizeof zs);
            if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) return;
            uint8_t* h = scratch.get() + c * SLOT;
            zs.next_in = const_cast<uint8_t*>(src) + in_off;
            zs.avail_in = (uInt)len;
            zs.next_out = h + 18;
            zs.avail_out = (uInt)(SLOT - 26);
            int ret = deflate(&zs, Z_FINISH);
            int64_t deflated = (int64_t)(SLOT - 26) - zs.avail_out;
            deflateEnd(&zs);
            if (ret != Z_STREAM_END) return;  // sizes[c] stays -1 -> error
            int64_t bsize = deflated + 26;    // header(18) + crc/isize(8)
            if (bsize > 0xFFFF + 1) return;
            const uint8_t head[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00};
            std::memcpy(h, head, 12);
            h[12] = 'B';
            h[13] = 'C';
            h[14] = 2;
            h[15] = 0;
            uint16_t bs16 = (uint16_t)(bsize - 1);
            std::memcpy(h + 16, &bs16, 2);
            uint32_t crc = (uint32_t)crc32(0L, src + in_off, (uInt)len);
            uint32_t isize = (uint32_t)len;
            std::memcpy(h + 18 + deflated, &crc, 4);
            std::memcpy(h + 22 + deflated, &isize, 4);
            sizes[c] = bsize;
        }
    }, 16);
    int64_t out_off = 0;
    for (int64_t c = 0; c < n_chunks; ++c) {
        if (sizes[c] < 0) return -1;
        if (out_off + sizes[c] > cap) return -1;
        std::memcpy(dst + out_off, scratch.get() + c * SLOT, sizes[c]);
        out_off += sizes[c];
    }
    if (out_off + 28 > cap) return -1;
    std::memcpy(dst + out_off, EOF_BLOCK, 28);
    return out_off + 28;
} catch (...) {
    return -1;  // bad_alloc / thread-spawn failure must not cross the C ABI
}

// The shard count the engine uses (VCTPU_NATIVE_THREADS, else the
// hardware concurrency), so callers can see the knob taken.
int32_t vctpu_native_threads() { return vctpu::nthreads(); }

// Walk uncompressed BAM alignment records (buf starts at the first record,
// i.e. after the header + reference list) and accumulate per-contig depth
// difference arrays with samtools-depth semantics (-a -J -q -Q -l), the
// depth of the coverage_analysis and cnv_calling tools (io/bam.py).
//
// diff_flat holds all selected contigs back to back; contig_starts[ref_id]
// is the offset of that contig's (length+1)-long diff region, or -1 to skip.
// Returns records seen, or -1 on malformed input.
int64_t vctpu_bam_depth(const uint8_t* buf, int64_t n, const int64_t* contig_starts,
                        const int64_t* contig_lens, int32_t n_refs, int32_t* diff_flat,
                        int32_t min_bq, int32_t min_mapq, int32_t min_len, int32_t include_del,
                        uint32_t exclude_flags) {
    int64_t off = 0, count = 0;
    while (off + 4 <= n) {
        int32_t bs;
        std::memcpy(&bs, buf + off, 4);
        if (bs < 32 || off + 4 + bs > n) return -1;
        const uint8_t* r = buf + off + 4;
        off += 4 + bs;
        count++;
        int32_t ref_id, pos, l_seq;
        uint32_t lrn, flag_nc;
        std::memcpy(&ref_id, r, 4);
        std::memcpy(&pos, r + 4, 4);
        std::memcpy(&lrn, r + 8, 4);
        std::memcpy(&flag_nc, r + 12, 4);
        std::memcpy(&l_seq, r + 16, 4);
        uint32_t l_read_name = lrn & 0xff;
        int32_t mapq = (int32_t)((lrn >> 8) & 0xff);
        uint32_t n_cigar = flag_nc & 0xffff;
        uint32_t flag = flag_nc >> 16;
        if ((flag & exclude_flags) || ref_id < 0 || ref_id >= n_refs || pos < 0) continue;
        if (mapq < min_mapq || l_seq < min_len) continue;
        int64_t base = contig_starts[ref_id];
        if (base < 0) continue;
        int64_t clen = contig_lens[ref_id];
        const uint8_t* cig = r + 32 + l_read_name;
        const uint8_t* qual = cig + 4 * (int64_t)n_cigar + (l_seq + 1) / 2;
        if (cig + 4 * (int64_t)n_cigar > buf + off || qual + l_seq > buf + off) return -1;
        int64_t ref_pos = pos, read_pos = 0;
        for (uint32_t i = 0; i < n_cigar; i++) {
            uint32_t c;
            std::memcpy(&c, cig + 4 * (int64_t)i, 4);
            uint32_t op = c & 0xf;
            int64_t len = c >> 4;
            bool match_like = (op == 0 || op == 7 || op == 8);  // M, =, X
            bool covers = match_like || (include_del && op == 2);
            if (covers && ref_pos < clen) {
                if (!match_like || min_bq <= 0) {
                    int64_t s = ref_pos, e = std::min(ref_pos + len, clen);
                    diff_flat[base + s] += 1;
                    diff_flat[base + e] -= 1;
                } else {
                    // run-length encode (qual >= min_bq) into diff updates;
                    // clamp by l_seq too in case the CIGAR overruns the quals
                    int64_t s = -1;
                    int64_t max_j = std::min({len, clen - ref_pos, (int64_t)l_seq - read_pos});
                    for (int64_t j = 0; j <= max_j; j++) {
                        bool ok = (j < max_j) && ((int32_t)qual[read_pos + j] >= min_bq);
                        if (ok && s < 0) {
                            s = j;
                        } else if (!ok && s >= 0) {
                            diff_flat[base + ref_pos + s] += 1;
                            diff_flat[base + ref_pos + j] -= 1;
                            s = -1;
                        }
                    }
                }
            }
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_pos += len;  // ref-consuming
            if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) read_pos += len;  // read-consuming
        }
    }
    return count;
}

// Base counts over [start0, end0) of one contig from uncompressed BAM
// alignment records (buf starts at the first record): every record of
// contig target_ref whose flags miss exclude_flags, that has SEQ and starts
// before end0, adds one to counts[(ref_pos - start0) * 4 + code] for each
// base of its M, = and X ops inside the window whose code is A, C, G or T
// (the pileup of the fingerprinting tools, comparison/pileup_caller.py; the
// bases an op would read past SEQ's end are not counted). Returns records
// seen, or -1 on malformed input.
int64_t vctpu_bam_pileup(const uint8_t* buf, int64_t n, int32_t target_ref, int64_t start0, int64_t end0,
                         uint32_t exclude_flags, int32_t* counts) {
    static const int8_t code_of[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};
    int64_t off = 0, count = 0;
    while (off + 4 <= n) {
        int32_t bs;
        std::memcpy(&bs, buf + off, 4);
        if (bs < 32 || off + 4 + bs > n) return -1;
        const uint8_t* r = buf + off + 4;
        off += 4 + bs;
        count++;
        int32_t ref_id, pos, l_seq;
        uint32_t lrn, flag_nc;
        std::memcpy(&ref_id, r, 4);
        std::memcpy(&pos, r + 4, 4);
        std::memcpy(&lrn, r + 8, 4);
        std::memcpy(&flag_nc, r + 12, 4);
        std::memcpy(&l_seq, r + 16, 4);
        uint32_t l_read_name = lrn & 0xff;
        uint32_t n_cigar = flag_nc & 0xffff;
        uint32_t flag = flag_nc >> 16;
        if (ref_id != target_ref || (flag & exclude_flags) || l_seq <= 0 || pos >= end0) continue;
        const uint8_t* cig = r + 32 + l_read_name;
        const uint8_t* seq = cig + 4 * (int64_t)n_cigar;
        if (seq + (l_seq + 1) / 2 > buf + off) return -1;
        int64_t rpos = pos, qpos = 0;
        for (uint32_t i = 0; i < n_cigar; i++) {
            uint32_t c;
            std::memcpy(&c, cig + 4 * (int64_t)i, 4);
            uint32_t op = c & 0xf;
            int64_t len = c >> 4;
            if (op == 0 || op == 7 || op == 8) {  // M, =, X
                int64_t lo = std::max(rpos, start0), hi = std::min(rpos + len, end0);
                for (int64_t p = lo; p < hi; p++) {
                    int64_t q = qpos + (p - rpos);
                    if (q >= l_seq) break;
                    uint8_t b = seq[q >> 1];
                    int8_t code = code_of[(q & 1) ? (b & 0xf) : (b >> 4)];
                    if (code < 4) counts[(p - start0) * 4 + code]++;
                }
                rpos += len;
                qpos += len;
            } else if (op == 1 || op == 4) {  // I, S
                qpos += len;
            } else if (op == 2 || op == 3) {  // D, N
                rpos += len;
            }
        }
    }
    return count;
}

// bedGraph lines of one contig's runs of equal depth:
// "<contig>\t<start>\t<end>\t<value>\n" each, integers in decimal (the
// reference's write_bedgraph text). Returns the bytes written, or -1 when
// out_cap is too small.
int64_t vctpu_bedgraph_lines(const uint8_t* contig, int64_t contig_len, const int64_t* starts,
                             const int64_t* ends, const int64_t* vals, int64_t n, uint8_t* out,
                             int64_t out_cap) {
    char* p = (char*)out;
    char* const end = p + out_cap;
    for (int64_t i = 0; i < n; i++) {
        if (end - p < contig_len + 3 * 21 + 4) return -1;
        std::memcpy(p, contig, (size_t)contig_len);
        p += contig_len;
        *p++ = '\t';
        p = std::to_chars(p, end, (long long)starts[i]).ptr;
        *p++ = '\t';
        p = std::to_chars(p, end, (long long)ends[i]).ptr;
        *p++ = '\t';
        p = std::to_chars(p, end, (long long)vals[i]).ptr;
        *p++ = '\n';
    }
    return (int64_t)(p - (char*)out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// VCF record scanner: one pass over the uncompressed text buffer producing
// columnar arrays: numeric fields, sample-0 FORMAT numerics, hot INFO keys
// and allele classification come out as flat arrays, so the Python layer
// only materializes strings it actually uses. Records are independent
// lines, so the scan shards across threads: byte ranges aligned at line
// starts, per-shard record counts prefix-summed into disjoint output
// ranges, per-shard CHROM dictionaries merged in shard order
// (first-appearance code order is preserved exactly).
// ---------------------------------------------------------------------------

namespace {

inline int base_code(uint8_t c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 4;
    }
}

double parse_double_slow(const uint8_t* s, int64_t len) {
    char tmp[64];
    int64_t m = len < 63 ? len : 63;
    std::memcpy(tmp, s, m);
    tmp[m] = 0;
    char* end = nullptr;
    double v = strtod(tmp, &end);
    if (end == tmp) return NAN;
    return v;
}

// Fast decimal parse for the overwhelmingly common VCF shape
// [+-]digits[.digits] with <=15 significant digits: an exactly-held
// integer mantissa divided by an exact power of ten is correctly rounded,
// so the result is bit-identical to strtod. Everything else (exponents,
// inf/nan, long digit strings) falls back to strtod.
inline double parse_double(const uint8_t* s, int64_t len) {
    if (len <= 0 || (len == 1 && s[0] == '.')) return NAN;
    static const double P10[16] = {1.0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
                                   1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};
    int64_t i = 0;
    bool neg = false;
    if (s[0] == '-' || s[0] == '+') {
        neg = s[0] == '-';
        i = 1;
    }
    uint64_t mant = 0;
    int digits = 0, frac = 0;
    bool dot = false;
    for (; i < len; ++i) {
        uint8_t c = s[i];
        if (c >= '0' && c <= '9') {
            if (++digits > 15) return parse_double_slow(s, len);
            mant = mant * 10 + (c - '0');
            frac += dot;
        } else if (c == '.' && !dot) {
            dot = true;
        } else {
            return parse_double_slow(s, len);
        }
    }
    if (digits == 0) return parse_double_slow(s, len);
    double v = (double)mant / P10[frac];
    return neg ? -v : v;
}

inline int64_t parse_i64(const uint8_t* s, int64_t len) {
    int64_t v = 0;
    bool neg = false;
    int64_t i = 0;
    if (len > 0 && (s[0] == '-' || s[0] == '+')) { neg = s[0] == '-'; i = 1; }
    for (; i < len; i++) {
        if (s[i] < '0' || s[i] > '9') return -1;
        v = v * 10 + (s[i] - '0');
    }
    return neg ? -v : v;
}

// All output column pointers of the VCF scan, so the per-shard worker and
// the serial path share one record-parsing core.
struct VcfOut {
    int64_t* line_spans;
    int64_t* id_spans;
    int64_t* ref_spans;
    int64_t* alt_spans;
    int64_t* filter_spans;
    int64_t* info_spans;
    int64_t* tail_spans;
    int64_t* pos;
    double* qual;
    int32_t* chrom_codes;
    int8_t* gt;
    uint8_t* gt_phased;
    float* gq;
    float* dpf;
    float* ad;
    uint8_t* aclass;
    int32_t* indel_length;
    int32_t* indel_nuc;
    int32_t* ref_code;
    int32_t* alt_code;
    int32_t* n_alts;
    int32_t* ref_len_out;
    const uint8_t* keys;
    const int32_t* key_lens;
    int32_t n_keys;
    double* info_vals;
    int32_t n_samples;
};

// Parse record lines in buf[start..limit) writing rows [rec_base,
// rec_base+max_rec) of the output columns; CHROM codes go through the
// given dictionary (chrom_uniq: 64B slots, *n_uniq entries, uniq_cap max).
// Returns records parsed, or -1 on malformed input / dictionary overflow.
int64_t vcf_parse_range(const uint8_t* buf, int64_t start, int64_t limit,
                        int64_t rec_base, int64_t max_rec, const VcfOut& o,
                        uint8_t* chrom_uniq, int32_t uniq_cap, int32_t* n_uniq_io) {
    int32_t n_uniq = *n_uniq_io;
    int64_t off = start, parsed = 0;
    while (off < limit && parsed < max_rec) {
        const uint8_t* nl = (const uint8_t*)std::memchr(buf + off, '\n', limit - off);
        int64_t line_end = nl ? (nl - buf) : limit;
        int64_t end = line_end;
        if (end > off && buf[end - 1] == '\r') end--;  // CRLF
        if (end <= off || buf[off] == '#') {
            off = line_end + 1;
            continue;
        }
        const int64_t rec = rec_base + parsed;
        o.line_spans[rec * 2] = off;
        o.line_spans[rec * 2 + 1] = end;

        // tokenize up to 9 tab-separated spans: CHROM POS ID REF ALT QUAL FILTER INFO [FORMAT samples...]
        int64_t fs[9][2];
        int nf = 0;
        int64_t p = off;
        for (; nf < 8 && p <= end; nf++) {
            const uint8_t* tab = (const uint8_t*)std::memchr(buf + p, '\t', end - p);
            int64_t fe = tab ? (tab - buf) : end;
            fs[nf][0] = p;
            fs[nf][1] = fe;
            p = fe + 1;
            if (!tab) { nf++; break; }
        }
        if (nf < 8) return -1;  // malformed record
        int64_t tail_start = p <= end ? p : end;  // FORMAT column onward ('' if absent)

        // CHROM -> dictionary code (linear probe over uniques; contigs are few)
        {
            int64_t cl = fs[0][1] - fs[0][0];
            if (cl > 63) cl = 63;
            int32_t code = -1;
            for (int32_t u = 0; u < n_uniq; u++) {
                const uint8_t* name = chrom_uniq + (int64_t)u * 64;
                if (name[cl] == 0 && std::memcmp(name, buf + fs[0][0], cl) == 0) { code = u; break; }
            }
            if (code < 0) {
                if (n_uniq >= uniq_cap) return -1;
                uint8_t* name = chrom_uniq + (int64_t)n_uniq * 64;
                std::memset(name, 0, 64);
                std::memcpy(name, buf + fs[0][0], cl);
                code = n_uniq++;
            }
            o.chrom_codes[rec] = code;
        }
        o.pos[rec] = parse_i64(buf + fs[1][0], fs[1][1] - fs[1][0]);
        o.qual[rec] = parse_double(buf + fs[5][0], fs[5][1] - fs[5][0]);
        o.id_spans[rec * 2] = fs[2][0];     o.id_spans[rec * 2 + 1] = fs[2][1];
        o.ref_spans[rec * 2] = fs[3][0];    o.ref_spans[rec * 2 + 1] = fs[3][1];
        o.alt_spans[rec * 2] = fs[4][0];    o.alt_spans[rec * 2 + 1] = fs[4][1];
        o.filter_spans[rec * 2] = fs[6][0]; o.filter_spans[rec * 2 + 1] = fs[6][1];
        o.info_spans[rec * 2] = fs[7][0];   o.info_spans[rec * 2 + 1] = fs[7][1];
        o.tail_spans[rec * 2] = tail_start; o.tail_spans[rec * 2 + 1] = end;

        // ---- allele classification (parity: featurize.classify_alleles) ----
        {
            const uint8_t* ref = buf + fs[3][0];
            int64_t rl = fs[3][1] - fs[3][0];
            const uint8_t* alt = buf + fs[4][0];
            int64_t al_full = fs[4][1] - fs[4][0];
            o.ref_len_out[rec] = (int32_t)rl;
            uint8_t cls = 0;
            int32_t ilen = 0, inuc = 4, rc = 4, ac = 4, na = 0;
            if (!(al_full == 0 || (al_full == 1 && alt[0] == '.'))) {
                na = 1;
                for (int64_t i = 0; i < al_full; i++)
                    if (alt[i] == ',') na++;
                const uint8_t* comma = (const uint8_t*)std::memchr(alt, ',', al_full);
                int64_t al = comma ? (comma - alt) : al_full;
                if (al > 0 && alt[0] != '<') {
                    if (rl == 1 && al == 1) {
                        cls |= 1;  // snp
                        rc = base_code(ref[0]);
                        ac = base_code(alt[0]);
                    } else if (rl != al) {
                        cls |= 2;  // indel
                        const uint8_t* diff;
                        int64_t dlen;
                        if (al > rl) {
                            cls |= 4;  // ins
                            bool pref = (al >= rl) && std::memcmp(alt, ref, rl) == 0;
                            if (pref) cls |= 8;
                            diff = pref ? alt + rl : alt + 1;
                            dlen = pref ? al - rl : al - 1;
                        } else {
                            bool pref = (rl >= al) && std::memcmp(ref, alt, al) == 0;
                            if (pref) cls |= 8;
                            diff = pref ? ref + al : ref + 1;
                            dlen = pref ? rl - al : rl - 1;
                        }
                        ilen = (int32_t)(al > rl ? al - rl : rl - al);
                        int u = -2;  // unset
                        for (int64_t i = 0; i < dlen; i++) {
                            int c = base_code(diff[i] >= 'a' ? diff[i] - 32 : diff[i]);
                            if (u == -2) u = c;
                            else if (u != c) { u = -1; break; }
                        }
                        inuc = (u >= 0) ? u : 4;
                    }
                }
            }
            o.aclass[rec] = cls;
            o.indel_length[rec] = ilen;
            o.indel_nuc[rec] = inuc;
            o.ref_code[rec] = rc;
            o.alt_code[rec] = ac;
            o.n_alts[rec] = na;
        }

        // ---- INFO numeric keys ----
        if (o.n_keys > 0) {
            for (int32_t k = 0; k < o.n_keys; k++) o.info_vals[rec * o.n_keys + k] = NAN;
            int64_t ip = fs[7][0], ie = fs[7][1];
            if (!(ie - ip == 1 && buf[ip] == '.')) {
                while (ip < ie) {
                    const uint8_t* semi = (const uint8_t*)std::memchr(buf + ip, ';', ie - ip);
                    int64_t ee = semi ? (semi - buf) : ie;
                    const uint8_t* eq = (const uint8_t*)std::memchr(buf + ip, '=', ee - ip);
                    int64_t klen = eq ? (eq - buf - ip) : (ee - ip);
                    int64_t koff = 0;
                    for (int32_t k = 0; k < o.n_keys; k++) {
                        int32_t kl = o.key_lens[k];
                        if (kl == klen && std::memcmp(o.keys + koff, buf + ip, klen) == 0) {
                            if (!eq) {
                                o.info_vals[rec * o.n_keys + k] = 1.0;  // Flag
                            } else {
                                int64_t vs = ip + klen + 1;
                                const uint8_t* comma = (const uint8_t*)std::memchr(buf + vs, ',', ee - vs);
                                int64_t ve = comma ? (comma - buf) : ee;
                                o.info_vals[rec * o.n_keys + k] = parse_double(buf + vs, ve - vs);
                            }
                            break;
                        }
                        koff += kl;
                    }
                    ip = ee + 1;
                }
            }
        }

        // ---- FORMAT sample-0 numerics (GT / GQ / DP / AD) ----
        o.gt[rec * 2] = -1; o.gt[rec * 2 + 1] = -1; o.gt_phased[rec] = 0;
        o.gq[rec] = NAN; o.dpf[rec] = NAN;
        o.ad[rec * 3] = NAN; o.ad[rec * 3 + 1] = NAN; o.ad[rec * 3 + 2] = NAN;
        if (o.n_samples > 0 && tail_start < end) {
            // FORMAT keys
            const uint8_t* ftab = (const uint8_t*)std::memchr(buf + tail_start, '\t', end - tail_start);
            int64_t fend = ftab ? (ftab - buf) : end;
            int gt_i = -1, gq_i = -1, dp_i = -1, ad_i = -1;
            {
                int idx = 0;
                int64_t kp = tail_start;
                while (kp < fend) {
                    const uint8_t* colon = (const uint8_t*)std::memchr(buf + kp, ':', fend - kp);
                    int64_t ke = colon ? (colon - buf) : fend;
                    int64_t kl = ke - kp;
                    if (kl == 2) {
                        if (buf[kp] == 'G' && buf[kp + 1] == 'T') gt_i = idx;
                        else if (buf[kp] == 'G' && buf[kp + 1] == 'Q') gq_i = idx;
                        else if (buf[kp] == 'D' && buf[kp + 1] == 'P') dp_i = idx;
                        else if (buf[kp] == 'A' && buf[kp + 1] == 'D') ad_i = idx;
                    }
                    idx++;
                    kp = ke + 1;
                }
            }
            if (ftab) {
                int64_t sp = fend + 1;
                const uint8_t* stab = (const uint8_t*)std::memchr(buf + sp, '\t', end - sp);
                int64_t send = stab ? (stab - buf) : end;
                int idx = 0;
                int64_t vp = sp;
                while (vp <= send) {
                    const uint8_t* colon = (const uint8_t*)std::memchr(buf + vp, ':', send - vp);
                    int64_t ve = colon ? (colon - buf) : send;
                    if (idx == gt_i && ve > vp) {
                        // a[/|]b (or haploid a)
                        const uint8_t* s = buf + vp;
                        int64_t l = ve - vp;
                        int64_t sep = -1;
                        for (int64_t i = 0; i < l; i++)
                            if (s[i] == '/' || s[i] == '|') { sep = i; break; }
                        int64_t a_len = sep >= 0 ? sep : l;
                        if (!(a_len == 1 && s[0] == '.')) {
                            int64_t v = parse_i64(s, a_len);
                            if (v >= -128 && v <= 127) o.gt[rec * 2] = (int8_t)v;
                        }
                        if (sep >= 0) {
                            o.gt_phased[rec] = s[sep] == '|';
                            int64_t b_len = l - sep - 1;
                            // second diploid slot only (extra ploidy ignored)
                            const uint8_t* b = s + sep + 1;
                            int64_t b2 = b_len;
                            for (int64_t i = 0; i < b_len; i++)
                                if (b[i] == '/' || b[i] == '|') { b2 = i; break; }
                            if (!(b2 == 1 && b[0] == '.')) {
                                int64_t v = parse_i64(b, b2);
                                if (v >= -128 && v <= 127) o.gt[rec * 2 + 1] = (int8_t)v;
                            }
                        }
                    } else if (idx == gq_i) {
                        o.gq[rec] = (float)parse_double(buf + vp, ve - vp);
                    } else if (idx == dp_i) {
                        o.dpf[rec] = (float)parse_double(buf + vp, ve - vp);
                    } else if (idx == ad_i && ve > vp) {
                        double total = 0;
                        int ai = 0;
                        bool any = false;
                        int64_t ap = vp;
                        while (ap < ve) {
                            const uint8_t* comma = (const uint8_t*)std::memchr(buf + ap, ',', ve - ap);
                            int64_t ae = comma ? (comma - buf) : ve;
                            double v = parse_double(buf + ap, ae - ap);
                            if (v == v) {  // not NaN
                                any = true;
                                if (v > 0) total += v;
                                if (ai < 2) o.ad[rec * 3 + ai] = (float)v;
                            }
                            ai++;
                            ap = ae + 1;
                        }
                        if (any) o.ad[rec * 3 + 2] = (float)total;
                    }
                    idx++;
                    if (!colon || ve >= send) break;
                    vp = ve + 1;
                }
            }
        }
        parsed++;
        off = line_end + 1;
    }
    *n_uniq_io = n_uniq;
    return parsed;
}

// Count record lines (non-empty, not '#') in buf[start..limit).
int64_t count_records_range(const uint8_t* buf, int64_t start, int64_t limit) {
    int64_t off = start, count = 0;
    while (off < limit) {
        const uint8_t* nl = (const uint8_t*)std::memchr(buf + off, '\n', limit - off);
        int64_t end = nl ? (nl - buf) : limit;
        if (end > off && buf[off] != '#') count++;
        off = end + 1;
    }
    return count;
}

}  // namespace

extern "C" {

// Number of record lines (not starting with '#') and offset of the first one.
int64_t vctpu_vcf_count(const uint8_t* buf, int64_t n, int64_t* first_rec_off) {
    int64_t off = 0, count = 0;
    *first_rec_off = n;
    while (off < n) {
        const uint8_t* nl = (const uint8_t*)std::memchr(buf + off, '\n', n - off);
        int64_t end = nl ? (nl - buf) : n;
        if (end > off && buf[off] != '#') {
            if (count == 0) *first_rec_off = off;
            count++;
        }
        off = end + 1;
    }
    return count;
}

// One-pass columnar parse, sharded across threads. All output arrays are
// caller-allocated for n_rec records (from vctpu_vcf_count); each span
// array is an independent contiguous (n_rec, 2) int64 buffer of [start,
// end) byte offsets. Returns records parsed or -1.
//
// aclass bitmask: 1=snp 2=indel 4=ins 8=first-alt-prefixed-by-ref
// gt/gq/dp/ad are sample-0 FORMAT numerics (NaN/-1 when missing);
// ad = (ref_count, alt1_count, total). info_vals = (n_rec, n_keys) doubles
// for the requested INFO keys (first element of comma lists; Flag -> 1).
int64_t vctpu_vcf_parse(
    const uint8_t* buf, int64_t n, int64_t start_off, int64_t n_rec, int32_t n_samples,
    int64_t* line_spans, int64_t* id_spans, int64_t* ref_spans, int64_t* alt_spans,
    int64_t* filter_spans, int64_t* info_spans, int64_t* tail_spans,
    int64_t* pos, double* qual,
    int32_t* chrom_codes, uint8_t* chrom_uniq, int32_t* uniq_inout,
    int8_t* gt, uint8_t* gt_phased, float* gq, float* dpf, float* ad,
    uint8_t* aclass, int32_t* indel_length, int32_t* indel_nuc,
    int32_t* ref_code, int32_t* alt_code, int32_t* n_alts, int32_t* ref_len_out,
    const uint8_t* keys, const int32_t* key_lens, int32_t n_keys, double* info_vals) try {
    const int32_t uniq_cap = *uniq_inout;
    VcfOut o = {line_spans, id_spans, ref_spans, alt_spans, filter_spans, info_spans,
                tail_spans, pos, qual, chrom_codes, gt, gt_phased, gq, dpf, ad,
                aclass, indel_length, indel_nuc, ref_code, alt_code, n_alts,
                ref_len_out, keys, key_lens, n_keys, info_vals, n_samples};

    int t_count = vctpu::nthreads();
    if (t_count > 1 && n_rec >= (int64_t)t_count * 4096) {
        // byte-shard [start_off, n) at line boundaries
        std::vector<int64_t> bounds;
        bounds.push_back(start_off);
        const int64_t span = n - start_off;
        for (int t = 1; t < t_count; ++t) {
            int64_t b = start_off + span * t / t_count;
            if (b < bounds.back()) b = bounds.back();
            const uint8_t* nl = (const uint8_t*)std::memchr(buf + b, '\n', n - b);
            b = nl ? (nl - buf) + 1 : n;
            if (b > bounds.back()) bounds.push_back(b);
        }
        bounds.push_back(n);
        const int shards = (int)bounds.size() - 1;
        std::vector<int64_t> counts(shards), bases(shards + 1, 0);
        vctpu::for_shards((int64_t)shards, shards, [&](int, int64_t lo, int64_t hi) {
            for (int64_t s = lo; s < hi; ++s)
                counts[s] = count_records_range(buf, bounds[s], bounds[s + 1]);
        });
        for (int s = 0; s < shards; ++s) bases[s + 1] = bases[s] + counts[s];
        if (bases[shards] != n_rec) return -1;

        std::vector<std::vector<uint8_t>> uniq(shards);
        std::vector<int32_t> uniq_n(shards, 0);
        std::vector<int64_t> parsed(shards, -1);
        vctpu::for_shards((int64_t)shards, shards, [&](int, int64_t lo, int64_t hi) {
            for (int64_t s = lo; s < hi; ++s) {
                uniq[s].assign((size_t)uniq_cap * 64, 0);
                parsed[s] = vcf_parse_range(buf, bounds[s], bounds[s + 1], bases[s],
                                            counts[s], o, uniq[s].data(), uniq_cap,
                                            &uniq_n[s]);
            }
        });
        // merge per-shard CHROM dictionaries in shard order (preserves
        // global first-appearance code order), then remap shard codes
        int32_t n_uniq = 0;
        std::vector<std::vector<int32_t>> remap(shards);
        for (int s = 0; s < shards; ++s) {
            if (parsed[s] != counts[s]) return -1;
            remap[s].resize(uniq_n[s]);
            for (int32_t u = 0; u < uniq_n[s]; ++u) {
                const uint8_t* name = uniq[s].data() + (int64_t)u * 64;
                int32_t code = -1;
                for (int32_t g = 0; g < n_uniq; ++g) {
                    if (std::memcmp(chrom_uniq + (int64_t)g * 64, name, 64) == 0) {
                        code = g;
                        break;
                    }
                }
                if (code < 0) {
                    if (n_uniq >= uniq_cap) return -1;
                    std::memcpy(chrom_uniq + (int64_t)n_uniq * 64, name, 64);
                    code = n_uniq++;
                }
                remap[s][u] = code;
            }
        }
        vctpu::for_shards((int64_t)shards, shards, [&](int, int64_t lo, int64_t hi) {
            for (int64_t s = lo; s < hi; ++s) {
                bool identity = true;
                for (int32_t u = 0; u < uniq_n[s]; ++u) identity &= remap[s][u] == u;
                if (identity) continue;
                for (int64_t r = bases[s]; r < bases[s + 1]; ++r)
                    chrom_codes[r] = remap[s][chrom_codes[r]];
            }
        });
        *uniq_inout = n_uniq;
        return n_rec;
    }

    int32_t n_uniq = 0;
    int64_t rc = vcf_parse_range(buf, start_off, n, 0, n_rec, o, chrom_uniq, uniq_cap, &n_uniq);
    if (rc < 0) return -1;
    *uniq_inout = n_uniq;
    return rc;
} catch (...) {
    return -1;  // bad_alloc / thread-spawn failure must not cross the C ABI
}

}  // extern "C"

extern "C" {

// Membership of each position in a set of sorted, non-overlapping,
// half-open [start, end) intervals. out[i] = 1 if covered.
void vctpu_interval_membership(const int64_t* starts, const int64_t* ends, int64_t n_iv,
                               const int64_t* pos, int64_t n_pos, uint8_t* out) {
    for (int64_t i = 0; i < n_pos; i++) {
        int64_t p = pos[i];
        // rightmost interval with start <= p
        int64_t lo = 0, hi = n_iv;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (starts[mid] <= p)
                lo = mid + 1;
            else
                hi = mid;
        }
        out[i] = (lo > 0 && p < ends[lo - 1]) ? 1 : 0;
    }
}

}  // extern "C"

namespace {

// Bytes one assembled record will occupy (mirrors assemble_range exactly).
inline int64_t assemble_need(const uint8_t* buf, int64_t i,
                             const int64_t* line_spans, const int64_t* filter_spans,
                             const int64_t* info_spans, const int64_t* tail_spans,
                             const int64_t* filt_offs, const int64_t* sfx_offs) {
    int64_t head = filter_spans[i * 2] - line_spans[i * 2];
    int64_t info_s = info_spans[i * 2], info_e = info_spans[i * 2 + 1];
    int64_t tail = tail_spans[i * 2 + 1] - tail_spans[i * 2];
    int64_t flt = filt_offs[i + 1] - filt_offs[i];
    int64_t sfx = sfx_offs[i + 1] - sfx_offs[i];
    bool info_missing = (info_e - info_s == 1 && buf[info_s] == '.');
    int64_t body = info_missing && sfx > 0 ? sfx - 1 : (info_e - info_s) + sfx;
    return head + flt + 1 + body + (tail > 0 ? 1 + tail : 0) + 1;
}

void assemble_range(const uint8_t* buf, int64_t lo, int64_t hi, int64_t w,
                    const int64_t* line_spans, const int64_t* filter_spans,
                    const int64_t* info_spans, const int64_t* tail_spans,
                    const uint8_t* filt_blob, const int64_t* filt_offs,
                    const uint8_t* sfx_blob, const int64_t* sfx_offs, uint8_t* out) {
    for (int64_t i = lo; i < hi; i++) {
        int64_t head_s = line_spans[i * 2], head_e = filter_spans[i * 2];
        int64_t info_s = info_spans[i * 2], info_e = info_spans[i * 2 + 1];
        int64_t tail_s = tail_spans[i * 2], tail_e = tail_spans[i * 2 + 1];
        int64_t flt_s = filt_offs[i], flt_e = filt_offs[i + 1];
        int64_t sfx_s = sfx_offs[i], sfx_e = sfx_offs[i + 1];
        bool info_missing = (info_e - info_s == 1 && buf[info_s] == '.');
        memcpy(out + w, buf + head_s, head_e - head_s);  // "...QUAL\t"
        w += head_e - head_s;
        memcpy(out + w, filt_blob + flt_s, flt_e - flt_s);
        w += flt_e - flt_s;
        out[w++] = '\t';
        if (info_missing && sfx_e > sfx_s) {
            // "." + ";K=V" -> "K=V" (drop the missing marker and the ';')
            memcpy(out + w, sfx_blob + sfx_s + 1, sfx_e - sfx_s - 1);
            w += sfx_e - sfx_s - 1;
        } else {
            memcpy(out + w, buf + info_s, info_e - info_s);
            w += info_e - info_s;
            memcpy(out + w, sfx_blob + sfx_s, sfx_e - sfx_s);
            w += sfx_e - sfx_s;
        }
        if (tail_e > tail_s) {
            out[w++] = '\t';
            memcpy(out + w, buf + tail_s, tail_e - tail_s);
            w += tail_e - tail_s;
        }
        out[w++] = '\n';
    }
}

}  // namespace

extern "C" {

// Assemble VCF record lines for writeback: the CHROM..QUAL head and the
// FORMAT/sample tail are copied verbatim from the original parse buffer
// (spans from vctpu_vcf_parse); the FILTER column is replaced and an INFO
// suffix spliced in (";K=V" blob per record; replaces a missing "." INFO).
// Two passes, both sharded: exact per-record sizes (prefix-summed into
// shard output offsets), then parallel copies into disjoint ranges.
// Returns bytes written, -1 when out_cap is too small, -2 on bad spans.
int64_t vctpu_vcf_assemble(
    const uint8_t* buf, int64_t buf_len, int64_t n,
    const int64_t* line_spans,    // (n,2) full record line [start,end)
    const int64_t* filter_spans,  // (n,2) original FILTER field
    const int64_t* info_spans,    // (n,2) original INFO field
    const int64_t* tail_spans,    // (n,2) FORMAT..line-end ([s==e] if none)
    const uint8_t* filt_blob, const int64_t* filt_offs,  // n+1 offsets
    const uint8_t* sfx_blob, const int64_t* sfx_offs,    // n+1 offsets
    uint8_t* out, int64_t out_cap) try {
    const int t_count = vctpu::nthreads();
    std::atomic<int> bad{0};
    const int max_shards = (t_count > 1 && n >= 65536) ? t_count : 1;
    std::vector<int64_t> sizes(max_shards, 0);
    int used = vctpu::for_shards(n, max_shards, [&](int t, int64_t lo, int64_t hi) {
        int64_t total = 0;
        for (int64_t i = lo; i < hi; i++) {
            int64_t head_s = line_spans[i * 2], head_e = filter_spans[i * 2];
            if (head_s < 0 || head_e > buf_len || head_e < head_s) {
                bad.store(1, std::memory_order_relaxed);
                return;
            }
            total += assemble_need(buf, i, line_spans, filter_spans, info_spans,
                                   tail_spans, filt_offs, sfx_offs);
        }
        sizes[t] = total;
    });
    if (bad.load()) return -2;
    std::vector<int64_t> w_base(used + 1, 0);
    for (int t = 0; t < used; ++t) w_base[t + 1] = w_base[t] + sizes[t];
    if (w_base[used] > out_cap) return -1;
    vctpu::for_shards(n, max_shards, [&](int t, int64_t lo, int64_t hi) {
        assemble_range(buf, lo, hi, w_base[t], line_spans, filter_spans, info_spans,
                       tail_spans, filt_blob, filt_offs, sfx_blob, sfx_offs, out);
    });
    return w_base[used];
} catch (...) {
    return -1;  // bad_alloc / thread-spawn failure must not cross the C ABI
}

}  // extern "C"

namespace {

struct BaseTable {
    uint8_t t[256];
    BaseTable() {
        for (int i = 0; i < 256; ++i) t[i] = 4;
        t[(int)'A'] = t[(int)'a'] = 0;
        t[(int)'C'] = t[(int)'c'] = 1;
        t[(int)'G'] = t[(int)'g'] = 2;
        t[(int)'T'] = t[(int)'t'] = 3;
    }
};
const BaseTable kBase;

}  // namespace

extern "C" {

// FASTA body 2-bit-class encode: strip the newline framing and map
// ACGTacgt -> 0..3 (anything else 4). ``buf`` points at the first sequence
// byte of one contig (the .fai offset is applied by the caller); the body
// is line_bases content bytes per line_width-byte stride, last line may be
// short. Sharded over OUTPUT positions (pure map, disjoint writes), so the
// result is byte-identical to the serial walk at any thread count.
// Returns 0, or -1 when the framing doesn't cover ``length`` bases.
int64_t vctpu_fasta_encode(const uint8_t* buf, int64_t buf_len,
                           int64_t line_bases, int64_t line_width,
                           int64_t length, uint8_t* out) try {
    if (length <= 0) return length == 0 ? 0 : -1;
    if (line_bases <= 0 || line_width < line_bases) return -1;
    const int64_t last_line = (length - 1) / line_bases;
    const int64_t need =
        last_line * line_width + ((length - 1) - last_line * line_bases) + 1;
    if (need > buf_len) return -1;
    const int64_t gap = line_width - line_bases;
    vctpu::for_shards(length, vctpu::nthreads(), [&](int, int64_t lo, int64_t hi) {
        int64_t line = lo / line_bases;
        int64_t col = lo - line * line_bases;
        const uint8_t* src = buf + line * line_width + col;
        for (int64_t i = lo; i < hi; ++i) {
            out[i] = kBase.t[*src++];
            if (++col == line_bases) {
                col = 0;
                src += gap;
            }
        }
    }, 1 << 16);
    return 0;
} catch (...) {
    return -1;
}

}  // extern "C"

// The serving daemon's coverage reduce (host_coverage_stats), as the
// reference's vctpu_coverage_stats.
extern "C" {

// Fused coverage reduce: per-window mean + clipped depth histogram in ONE
// pass over the depth vector, sharded at window-aligned boundaries with
// per-shard histograms merged at the end. ``from_diffs`` != 0 treats the
// input as a difference array whose running cumsum is the depth (a cheap
// per-shard total pre-pass seeds each shard's running depth).
//
// means_out: ceil(n/window) float32 (the tail window averages its
// remainder, as ops/coverage.binned_mean): each window's exact int64 sum
// rounded once to f32 over the f32 count. hist_out: (max_bin+1) int64,
// depths clipped into [0, max_bin]. Returns 0, -1 on bad args.
int64_t vctpu_coverage_stats(const int32_t* data, int64_t n, int64_t window,
                             int32_t max_bin, int32_t from_diffs,
                             float* means_out, int64_t* hist_out) try {
    if (n < 0 || window <= 0 || max_bin < 0) return -1;
    const int64_t n_win = n ? (n + window - 1) / window : 0;
    const int bins = max_bin + 1;
    for (int b = 0; b < bins; ++b) hist_out[b] = 0;
    if (n == 0) return 0;
    const int t_count = vctpu::nthreads();
    const int max_shards = (t_count > 1 && n_win >= 8) ? t_count : 1;
    std::vector<int64_t> base(max_shards + 1, 0);
    if (from_diffs) {
        // pre-pass: per-shard diff totals -> running-depth offset per shard
        // (shard ranges are identical across both for_shards calls: same
        // n_win / max_shards / min_per_shard)
        std::vector<int64_t> tot(max_shards, 0);
        const int used = vctpu::for_shards(n_win, max_shards,
                                           [&](int t, int64_t wlo, int64_t whi) {
            const int64_t lo = wlo * window, hi = std::min(n, whi * window);
            int64_t s = 0;
            for (int64_t i = lo; i < hi; ++i) s += data[i];
            tot[t] = s;
        }, 1);
        for (int t = 0; t < used; ++t) base[t + 1] = base[t] + tot[t];
    }
    std::vector<std::vector<int64_t>> hists(max_shards);
    vctpu::for_shards(n_win, max_shards, [&](int t, int64_t wlo, int64_t whi) {
        std::vector<int64_t>& h = hists[t];
        h.assign(bins, 0);
        int64_t run = base[t];
        for (int64_t w = wlo; w < whi; ++w) {
            const int64_t lo = w * window, hi = std::min(n, lo + window);
            int64_t sum = 0;
            for (int64_t i = lo; i < hi; ++i) {
                const int64_t d = from_diffs ? (run += data[i]) : data[i];
                sum += d;
                const int64_t b = d < 0 ? 0 : (d > max_bin ? max_bin : d);
                ++h[b];
            }
            // f32/f32 divide: bit-identical to the jitted binned_mean
            // while the exact sum fits f32 (see header comment)
            means_out[w] = (float)sum / (float)(hi - lo);
        }
    }, 1);
    for (auto& h : hists)
        if ((int)h.size() == bins)
            for (int b = 0; b < bins; ++b) hist_out[b] += h[b];
    return 0;
} catch (...) {
    return -1;
}

}  // extern "C"
