// Host window gather and the TREE_SCORE INFO formatter of the native host
// engine (a trimmed copy of the JAX package's vctpu_features.cc).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include "vctpu_threads.h"

extern "C" {

// Reference-window gather for one contig: out[i] = seq[pos0[i]-radius ..
// pos0[i]+radius], out-of-contig positions read as N (code 4) — the
// C++ twin of featurize.gather_windows' padded fancy-index gather.
int64_t vctpu_gather_windows(
    const uint8_t* seq, int64_t seq_len,
    const int64_t* pos0, int64_t n, int32_t radius,
    uint8_t* out)  // (n, 2*radius+1)
{
    if (n < 0 || radius <= 0 || seq_len < 0) return -1;
    const int32_t w = 2 * radius + 1;
    vctpu::for_shards(n, vctpu::nthreads(), [&](int, int64_t r_lo, int64_t r_hi) {
        for (int64_t i = r_lo; i < r_hi; ++i) {
            const int64_t c = pos0[i];
            uint8_t* row = out + (size_t)i * w;
            const int64_t lo = c - radius, hi = c + radius + 1;
            if (lo >= 0 && hi <= seq_len) {  // fully inside: straight copy
                const uint8_t* s = seq + lo;
                for (int32_t j = 0; j < w; ++j) row[j] = s[j];
            } else {
                for (int32_t j = 0; j < w; ++j) {
                    const int64_t p = lo + j;
                    row[j] = (p >= 0 && p < seq_len) ? seq[p] : 4;
                }
            }
        }
    });
    return 0;
}

namespace {

// %g-identical fast formatter for |v| < 100 where v is exactly the
// nearest double to k/10^4 for integer k: at most 6 significant digits,
// fixed notation, trailing zeros trimmed — precisely what printf %g
// emits for this domain. The filter pipeline's TREE_SCORE column
// (np.round(score, 4)) lands here, avoiding ~300ns of snprintf per
// record on the 5M writeback path. Returns length or 0 (use snprintf).
inline int fast_g4(double v, char* out) {
    if (!(v > -100.0 && v < 100.0)) return 0;
    if (v == 0.0 && std::signbit(v)) return 0;  // %g prints -0.0 as "-0"
    const long long k = std::llround(v * 10000.0);
    if ((double)k / 10000.0 != v) return 0;  // not an exact 4-decimal value
    int len = 0;
    long long a = k;
    if (a < 0) {
        out[len++] = '-';
        a = -a;
    }
    const long long ip = a / 10000, fp = a % 10000;
    if (ip >= 10) out[len++] = (char)('0' + ip / 10);
    out[len++] = (char)('0' + ip % 10);
    if (fp) {
        char d[4] = {(char)('0' + fp / 1000), (char)('0' + (fp / 100) % 10),
                     (char)('0' + (fp / 10) % 10), (char)('0' + fp % 10)};
        int last = 3;
        while (d[last] == '0') --last;  // fp != 0 -> terminates
        out[len++] = '.';
        for (int j = 0; j <= last; ++j) out[len++] = d[j];
    }
    return len;
}

}  // namespace

// Per-record ";KEY=<%g>" INFO suffixes for one float column (NaN ->
// empty) — the filter pipeline's TREE_SCORE writeback formatter, printf
// %g exactly like numpy's b"%g" so the byte-splicing output is unchanged.
// DELIBERATELY serial: a provisional-offset sharded variant was measured
// 2x SLOWER at 2 threads (each shard writes into the sparse worst-case
// region of the fresh output buffer and the compaction re-touches it —
// page-fault traffic doubles, dwarfing the ~45ns/row format cost), and
// in the streaming pipeline this call already parallelizes ACROSS chunks
// on the IO pool (ctypes releases the GIL). Returns total bytes written,
// or -1 when cap is too small.
int64_t vctpu_format_float_info(
    const double* vals, int64_t n,
    const uint8_t* prefix, int64_t prefix_len,  // b";KEY="
    uint8_t* out_buf, int64_t cap,
    int64_t* out_offs)                          // (n+1,)
{
    int64_t pos = 0;
    out_offs[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double v = vals[i];
        if (!std::isnan(v)) {
            if (pos + prefix_len + 32 > cap) return -1;
            for (int64_t j = 0; j < prefix_len; ++j) out_buf[pos + j] = prefix[j];
            pos += prefix_len;
            int fl = fast_g4(v, (char*)out_buf + pos);
            pos += fl ? fl : std::snprintf((char*)out_buf + pos, 32, "%g", v);
        }
        out_offs[i + 1] = pos;
    }
    return pos;
}

}  // extern "C"
