"""Native (C++) host engine: VCF scan, verbatim writeback, BGZF, FASTA encode, host gather, GBT fit, BAM/CRAM depth.

Counterpart of the JAX package's ``native`` module, with the same function
names, over a trimmed copy of its C++ sources (``src/``): only the entry
points of the filter pipeline's host stages, the quantile binning and
CPU trainer of the boosted-forest fit (``bin_features``, ``gbt_fit``), and
the depth walkers of the coverage and CNV tools (``bam_depth``; the CRAM
3.0 decoder ``cram_header``, ``cram_count``, ``cram_scan``,
``cram_depth``, which have no plain version: ``io/cram`` raises without
them), ``coverage_analysis``'s bedGraph text (``bedgraph_lines``) and the
comparison's haplotype matcher (``match_contig_native``, a verbatim copy of
the reference's ``vctpu_match.cc``, which ``comparison/matcher`` holds to its
Python specification) and the serving daemon's one-pass coverage reduce
(``coverage_stats``, under ``ops/coverage.host_coverage_stats``). The library is built
with g++ at first use into ``libvctpu_native-<hash>.so`` in the kernels'
build directory (``csrc/build.BUILD_DIR``: the checkout's ``build/``),
keyed by the sources, the flags and the CPU's ``flags`` line, under a file
lock so that one process of many compiles it; nothing builds at import.
It is loaded with ``ctypes``.

Every entry point returns None when the engine is off
(``VCTPU_NO_NATIVE=1``), could not be built or loaded (logged once, with
the compiler's output), or declines the input; the caller then runs its
plain Python version, byte-identical. Each entry point counts its
calls (:data:`CALLS`): served natively, with their seconds, or left to the
plain version. Call sites that decline before they reach an entry point
record that with :func:`note_plain`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import logging
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.csrc.build import BUILD_DIR

log = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = ("vctpu_native.cc", "vctpu_features.cc", "vctpu_gbt.cc", "vctpu_cram.cc", "vctpu_match.cc")
#: included by the sources: hashed into the build key, not compiled alone
HEADERS = ("vctpu_threads.h",)
CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"]

#: the entry points, in the order of the pipeline's stages, then the fit's, then the depth walkers
ENTRY_POINTS = ("bgzf_decompress_array", "vcf_parse", "interval_membership", "fasta_encode",
                "gather_windows_contig", "format_float_info", "vcf_assemble", "bgzf_compress",
                "bin_features", "gbt_fit", "bam_depth", "cram_header", "cram_count", "cram_scan", "cram_depth",
                "bedgraph_lines", "match_contig_native", "bam_pileup", "cram_pileup", "coverage_stats")
#: per entry point: calls served natively, their seconds, and calls left to the plain version
CALLS: dict[str, dict] = {}
#: guards CALLS: the streaming executor's workers call the engine concurrently
_CALLS_LOCK = threading.Lock()

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
#: (buf, n, contig_starts, contig_lens, n_refs, diff_flat, min_bq, min_mapq, min_len, include_del, exclude_flags)
_DEPTH_ARGS = [_u8p, _i64, _i64p, _i64p, _i32, _i32p, _i32, _i32, _i32, _i32, ctypes.c_uint32]


def reset_calls() -> None:
    """Set every entry point's counts to 0."""
    with _CALLS_LOCK:
        CALLS.clear()
        CALLS.update({name: {"native": 0, "native_s": 0.0, "plain": 0} for name in ENTRY_POINTS})


reset_calls()


def note_plain(name: str) -> None:
    """Record that the plain version served one call of entry point ``name``."""
    with _CALLS_LOCK:
        CALLS[name]["plain"] += 1


def _cpu_tag() -> str:
    """The CPU's ``flags`` line, hashed: a ``-march=native`` build is not
    reused by a host that lacks the extensions of the host that built it."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    return platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + _cpu_tag().encode())
    for name in (*SOURCES, *HEADERS):
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libvctpu_native-{h.hexdigest()[:12]}.so"


def build_command(out: Path) -> list[str]:
    """The g++ command line that builds the engine into ``out``."""
    return ["g++", *CXXFLAGS, "-o", str(out), *(str(SRC_DIR / s) for s in SOURCES), "-lz"]


def build() -> Path:
    """Path of the built engine, compiling it first if needed (one process at a
    time: a file lock, a temporary name and ``os.replace``). Raises
    ``RuntimeError`` with the compiler's output when g++ fails, ``OSError``
    when it cannot run."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".libvctpu_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by another process while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(build_command(tmp), capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    sigs = {
        "vctpu_bgzf_uncompressed_size": (_i64, [_u8p, _i64]),
        "vctpu_gzip_inflate": (_i64, [_u8p, _i64, _u8p, _i64]),
        "vctpu_bgzf_inflate": (_i64, [_u8p, _i64, _u8p, _i64]),
        "vctpu_bgzf_compress": (_i64, [_u8p, _i64, _u8p, _i64, ctypes.c_int]),
        "vctpu_native_threads": (_i32, []),
        "vctpu_vcf_count": (_i64, [_u8p, _i64, _i64p]),
        "vctpu_vcf_parse": (_i64, [
            _u8p, _i64, _i64, _i64, _i32,
            _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
            _i64p, _f64p,
            _i32p, _u8p, _i32p,
            _i8p, _u8p, _f32p, _f32p, _f32p,
            _u8p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, _i32p, _i32, _f64p]),
        "vctpu_interval_membership": (None, [_i64p, _i64p, _i64, _i64p, _i64, _u8p]),
        "vctpu_vcf_assemble": (_i64, [_u8p, _i64, _i64, _i64p, _i64p, _i64p, _i64p,
                                      _u8p, _i64p, _u8p, _i64p, _u8p, _i64]),
        "vctpu_fasta_encode": (_i64, [_u8p, _i64, _i64, _i64, _i64, _u8p]),
        "vctpu_gather_windows": (_i64, [_u8p, _i64, _i64p, _i64, _i32, _u8p]),
        "vctpu_format_float_info": (_i64, [_f64p, _i64, _u8p, _i64, _u8p, _i64, _i64p]),
        "vctpu_bin_features": (_i64, [_f32p, _i64, _i32, _f32p, _i32, _u8p]),
        "vctpu_gbt_fit": (_i64, [_u8p, _f32p, _f32p, _i64, _i32, _i32, _i32, _i32,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                 _i32p, _i32p, _f32p]),
        "vctpu_bam_depth": (_i64, _DEPTH_ARGS),
        "vctpu_cram_header": (_i64, [_u8p, _i64, _u8p, _i64]),
        "vctpu_cram_count": (_i64, [_u8p, _i64]),
        "vctpu_cram_scan": (_i64, [_u8p, _i64, _i64, _i32p, _i64p, _i32p, _i32p, _i32p, _i32p]),
        "vctpu_cram_depth": (_i64, _DEPTH_ARGS),
        "vctpu_bedgraph_lines": (_i64, [_u8p, _i64, _i64p, _i64p, _i64p, _i64, _u8p, _i64]),
        "vctpu_bam_pileup": (_i64, [_u8p, _i64, _i32, _i64, _i64, ctypes.c_uint32, _i32p]),
        "vctpu_cram_pileup": (_i64, [_u8p, _i64, _i32, _i64, _i64, _u8p, _i64, _i32p]),
        "vctpu_coverage_stats": (_i64, [_i32p, _i64, _i64, _i32, _i32, _f32p, _i64p]),
        "vctpu_match_contig": (_i64, [_u8p, _i64,
                                      _i64, _i64p, _u8p, _i64p, _u8p, _i64p, _i8p,
                                      _i64, _i64p, _u8p, _i64p, _u8p, _i64p, _i8p,
                                      _i32, _u8p, _u8p, _u8p, _u8p, _i64p, _i64p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def get_lib() -> ctypes.CDLL | None:
    """The loaded engine, built on first use; None when ``VCTPU_NO_NATIVE`` is
    set or the build or load failed (logged once, at warning level)."""
    global _LIB, _FAILED
    if knobs.get_bool("VCTPU_NO_NATIVE"):
        return None
    with _LOCK:
        if _LIB is None and not _FAILED:
            try:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                _LIB = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _FAILED = True
                log.warning("native host engine unavailable, its plain Python versions serve: %s", e)
        return _LIB


def available() -> bool:
    return get_lib() is not None


def engine_name() -> str:
    """``native`` when the engine serves this process, else ``plain``."""
    return "native" if available() else "plain"


def native_threads() -> int | None:
    """The engine's shard count (``VCTPU_NATIVE_THREADS``, else the hardware
    concurrency); None without the engine."""
    lib = get_lib()
    return None if lib is None else int(lib.vctpu_native_threads())


def _entry(fn):
    """An entry point ``fn(lib, ...)``: None (plain version) without the engine;
    counted as served natively, with its seconds, unless it declines (None)."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        lib = get_lib()
        if lib is None:
            note_plain(name)
            return None
        t0 = time.perf_counter()
        out = fn(lib, *args, **kwargs)
        if out is None:
            note_plain(name)
        else:
            dt = time.perf_counter() - t0
            with _CALLS_LOCK:
                CALLS[name]["native"] += 1
                CALLS[name]["native_s"] += dt
        return out

    return wrapper


def _u8view(data) -> np.ndarray:
    """Zero-copy uint8 view over bytes / bytearray / memoryview / ndarray."""
    return data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)


def _p(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


@_entry
def bgzf_decompress_array(lib, data) -> np.ndarray | None:
    """Inflate a whole BGZF (or plain gzip) buffer to a uint8 array."""
    if len(data) == 0:
        return None
    src_arr = np.ascontiguousarray(_u8view(data))
    src = _p(src_arr, _u8p)
    size = lib.vctpu_bgzf_uncompressed_size(src, len(src_arr))
    if size < 0:  # not BGZF-framed: inflate with geometric capacity growth
        cap = max(4 * len(src_arr), 1 << 16)
        for _ in range(8):
            dst = np.empty(cap, dtype=np.uint8)
            n = lib.vctpu_gzip_inflate(src, len(src_arr), _p(dst, _u8p), cap)
            if n >= 0:
                return dst[:n]
            cap *= 4
        return None
    dst = np.empty(max(int(size), 1), dtype=np.uint8)
    # block-parallel first; -2 is a corrupt payload, which the serial gzip
    # walk would refuse too, so only -1 (framing) falls back to it
    n = lib.vctpu_bgzf_inflate(src, len(src_arr), _p(dst, _u8p), int(size))
    if n == -1:
        n = lib.vctpu_gzip_inflate(src, len(src_arr), _p(dst, _u8p), int(size))
    return dst[:n] if n == size else None


@_entry
def bgzf_compress(lib, data, level: int = 6) -> bytes | None:
    """BGZF blocks of at most 65,280 payload bytes each, and the EOF block,
    deflated straight from the caller's buffer."""
    src_arr = np.ascontiguousarray(_u8view(data))
    n_in = len(src_arr)
    src = _p(src_arr, _u8p) if n_in else (ctypes.c_uint8 * 1).from_buffer_copy(b"\x00")
    cap = n_in + (n_in // 65280 + 1) * 128 + 64
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.vctpu_bgzf_compress(src, n_in, _p(dst, _u8p), cap, level)
    return None if n < 0 else dst[:n].tobytes()


# INFO keys extracted during the VCF scan; info_field() serves these from
# the scan's arrays without touching the INFO strings
VCF_INFO_KEYS = ("DP", "SOR", "AF", "QD", "FS", "MQ", "TLOD", "AS_SOR", "DB", "END")


@_entry
def vcf_parse(lib, buf, n_samples: int, info_keys: tuple[str, ...] = VCF_INFO_KEYS) -> dict | None:
    """One-pass columnar parse of an uncompressed VCF text buffer: the byte span
    of each record's line, ID, REF, ALT, FILTER, INFO and FORMAT..end; POS,
    QUAL, CHROM codes; sample 0's GT, GQ, DP and AD; the INFO keys
    ``info_keys`` as numbers (the hot keys by default); the allele classes.
    None on malformed input (the plain reader serves)."""
    src_arr = np.ascontiguousarray(_u8view(buf))
    src = _p(src_arr, _u8p)
    first_off = _i64(0)
    n = int(lib.vctpu_vcf_count(src, len(src_arr), ctypes.byref(first_off)))
    f32, f64, i64, i32 = np.float32, np.float64, np.int64, np.int32
    # each span column is its own contiguous (n, 2) buffer
    out = {"n": n, **{k: np.empty((n, 2), dtype=i64) for k in (
        "line_spans", "id_spans", "ref_spans", "alt_spans", "filter_spans", "info_spans", "tail_spans")}}
    out.update(
        pos=np.empty(n, dtype=i64), qual=np.empty(n, dtype=f64), chrom_codes=np.empty(n, dtype=i32),
        gt=np.empty((n, 2), dtype=np.int8), gt_phased=np.empty(n, dtype=np.uint8), gq=np.empty(n, dtype=f32),
        dp_fmt=np.empty(n, dtype=f32), ad=np.empty((n, 3), dtype=f32), aclass=np.empty(n, dtype=np.uint8),
        indel_length=np.empty(n, dtype=i32), indel_nuc=np.empty(n, dtype=i32), ref_code=np.empty(n, dtype=i32),
        alt_code=np.empty(n, dtype=i32), n_alts=np.empty(n, dtype=i32), ref_len=np.empty(n, dtype=i32),
        info_vals=np.empty((n, len(info_keys)), dtype=f64))
    if n == 0:
        out["chroms"] = []
        return out
    uniq_cap = 4096
    uniq_buf = np.zeros(uniq_cap * 64, dtype=np.uint8)
    uniq_n = (ctypes.c_int32 * 1)(uniq_cap)
    keys = np.frombuffer("".join(info_keys).encode(), dtype=np.uint8)
    key_lens = np.asarray([len(k.encode()) for k in info_keys], dtype=i32)
    rc = lib.vctpu_vcf_parse(
        src, len(src_arr), first_off.value, n, int(n_samples),
        *(_p(out[k], _i64p) for k in ("line_spans", "id_spans", "ref_spans", "alt_spans", "filter_spans",
                                       "info_spans", "tail_spans", "pos")),
        _p(out["qual"], _f64p), _p(out["chrom_codes"], _i32p), _p(uniq_buf, _u8p), uniq_n,
        _p(out["gt"], _i8p), _p(out["gt_phased"], _u8p),
        *(_p(out[k], _f32p) for k in ("gq", "dp_fmt", "ad")),
        _p(out["aclass"], _u8p),
        *(_p(out[k], _i32p) for k in ("indel_length", "indel_nuc", "ref_code", "alt_code", "n_alts", "ref_len")),
        _p(keys, _u8p), _p(key_lens, _i32p), len(info_keys), _p(out["info_vals"], _f64p))
    if rc != n:
        return None
    out["chroms"] = [bytes(uniq_buf[i * 64: (i + 1) * 64]).rstrip(b"\x00").decode() for i in range(uniq_n[0])]
    return out


@_entry
def vcf_assemble(lib, buf: np.ndarray, line_spans: np.ndarray, filter_spans: np.ndarray, info_spans: np.ndarray,
                 tail_spans: np.ndarray, filt_blob, filt_offs: np.ndarray, sfx_blob, sfx_offs: np.ndarray,
                 out: np.ndarray | None = None) -> np.ndarray | None:
    """Record lines for writeback: CHROM..QUAL and FORMAT..end copied from the
    parse buffer, a new FILTER, and an INFO suffix spliced in (``;K=V`` per
    record; one replaces a missing ``.``). Blob offsets are absolute (n + 1
    of them). Returns a view of ``out`` when it is large enough (a chunked
    writer reuses one buffer), else of a new array."""
    n = len(line_spans)
    src = np.ascontiguousarray(_u8view(buf))
    fb = np.ascontiguousarray(_u8view(filt_blob)) if len(filt_blob) else np.zeros(1, np.uint8)
    sb = np.ascontiguousarray(_u8view(sfx_blob)) if len(sfx_blob) else np.zeros(1, np.uint8)
    cap = int((line_spans[:, 1] - line_spans[:, 0]).sum() + len(filt_blob) + len(sfx_blob) + 4 * n + 64)
    if out is None or len(out) < cap or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        out = np.empty(cap, dtype=np.uint8)
    arrs = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (line_spans, filter_spans, info_spans, tail_spans, filt_offs, sfx_offs)]
    w = lib.vctpu_vcf_assemble(
        _p(src, _u8p), len(src), n, *(_p(a, _i64p) for a in arrs[:4]),
        _p(fb, _u8p), _p(arrs[4], _i64p), _p(sb, _u8p), _p(arrs[5], _i64p), _p(out, _u8p), cap)
    return None if w < 0 else out[:w]


@_entry
def interval_membership(lib, starts: np.ndarray, ends: np.ndarray, pos: np.ndarray) -> np.ndarray | None:
    """1/0 membership of each position in sorted, disjoint [start, end)."""
    s, e, p = (np.ascontiguousarray(a, dtype=np.int64) for a in (starts, ends, pos))
    out = np.zeros(len(p), dtype=np.uint8)
    lib.vctpu_interval_membership(_p(s, _i64p), _p(e, _i64p), len(s), _p(p, _i64p), len(p), _p(out, _u8p))
    return out


@_entry
def gather_windows_contig(lib, seq: np.ndarray, pos0: np.ndarray, radius: int,
                          out: np.ndarray | None = None) -> np.ndarray | None:
    """(n, 2r+1) uint8 windows over one encoded contig, positions outside it
    read N (4). ``out``: a contiguous uint8 slice of the caller's window
    array to gather into."""
    s = np.ascontiguousarray(seq, dtype=np.uint8)
    p = np.ascontiguousarray(pos0, dtype=np.int64)
    shape = (len(p), 2 * radius + 1)
    if out is None or out.shape != shape or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        out = np.empty(shape, dtype=np.uint8)
    rc = lib.vctpu_gather_windows(_p(s, _u8p), len(s), _p(p, _i64p), len(p), radius, _p(out, _u8p))
    return out if rc == 0 else None


@_entry
def format_float_info(lib, vals: np.ndarray, prefix: bytes) -> tuple[np.ndarray, np.ndarray] | None:
    """``prefix`` + ``%g`` of each non-NaN value (empty for NaN): the byte
    buffer and its (n + 1,) offsets."""
    v = np.ascontiguousarray(vals, dtype=np.float64)
    n = len(v)
    cap = n * (len(prefix) + 32) + 64
    buf = np.empty(cap, dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    pre = np.frombuffer(prefix, dtype=np.uint8) if prefix else np.zeros(0, np.uint8)
    total = lib.vctpu_format_float_info(_p(v, _f64p), n, _p(pre, _u8p), len(pre), _p(buf, _u8p), cap,
                                        _p(offs, _i64p))
    return None if total < 0 else (buf[:total], offs)


@_entry
def fasta_encode(lib, raw, line_bases: int, line_width: int, length: int,
                 out: np.ndarray | None = None) -> np.ndarray | None:
    """A contig's FASTA body (from its ``.fai`` offset) without its newlines, as
    codes A0 C1 G2 T3 (either case), anything else 4."""
    src = np.ascontiguousarray(_u8view(raw))
    if out is None or len(out) != length or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        out = np.empty(length, dtype=np.uint8)
    rc = lib.vctpu_fasta_encode(_p(src, _u8p), len(src), int(line_bases), int(line_width), int(length),
                                _p(out, _u8p))
    return out if rc == 0 else None


@_entry
def bin_features(lib, x: np.ndarray, edges: np.ndarray) -> np.ndarray | None:
    """searchsorted-left quantile binning at float32 (NaN in the last bin),
    uint8 out; None past 255 edges."""
    if edges.shape[1] > 255:
        return None
    xx = np.ascontiguousarray(x, dtype=np.float32)
    ee = np.ascontiguousarray(edges, dtype=np.float32)
    n, f = xx.shape
    out = np.empty((n, f), dtype=np.uint8)
    rc = lib.vctpu_bin_features(_p(xx, _f32p), n, f, _p(ee, _f32p), ee.shape[1], _p(out, _u8p))
    return out if rc == 0 else None


@_entry
def gbt_fit(lib, binned: np.ndarray, y: np.ndarray, w: np.ndarray | None, n_trees: int, depth: int, n_bins: int,
            learning_rate: float, reg_lambda: float, min_child_weight: float, base_score: float):
    """The native histogram-GBT fit (``src/vctpu_gbt.cc``): (feats, bins,
    leaves) shaped as ``models.boosting._train``'s, or None on bad arguments."""
    bn = np.ascontiguousarray(binned, dtype=np.uint8)
    yy = np.ascontiguousarray(y, dtype=np.float32)
    ww = None if w is None else np.ascontiguousarray(w, dtype=np.float32)
    n, f = bn.shape
    leaves = 1 << depth
    feats = np.empty((n_trees, depth, leaves), dtype=np.int32)
    bins = np.empty((n_trees, depth, leaves), dtype=np.int32)
    vals = np.empty((n_trees, leaves), dtype=np.float32)
    rc = lib.vctpu_gbt_fit(_p(bn, _u8p), _p(yy, _f32p), None if ww is None else _p(ww, _f32p),
                           n, f, n_bins, n_trees, depth, learning_rate, reg_lambda, min_child_weight, base_score,
                           _p(feats, _i32p), _p(bins, _i32p), _p(vals, _f32p))
    return None if rc != 0 else (feats, bins, vals)


def _depth_args(buf, contig_starts, contig_lens, diff_flat, min_bq, min_mapq, min_read_length, include_deletions,
                exclude_flags) -> tuple:
    """The ctypes arguments of ``vctpu_bam_depth`` / ``vctpu_cram_depth``, and
    the arrays they point into (kept alive by the caller)."""
    if diff_flat.dtype != np.int32 or not diff_flat.flags["C_CONTIGUOUS"]:
        raise ValueError(f"diff_flat must be contiguous int32, got {diff_flat.dtype}")
    starts = np.ascontiguousarray(contig_starts, dtype=np.int64)
    lens = np.ascontiguousarray(contig_lens, dtype=np.int64)
    if len(starts) != len(lens):
        raise ValueError(f"{len(starts)} contig starts but {len(lens)} lengths")
    src = np.ascontiguousarray(_u8view(buf))
    args = (_p(src, _u8p), len(src), _p(starts, _i64p), _p(lens, _i64p), len(starts), _p(diff_flat, _i32p),
            int(min_bq), int(min_mapq), int(min_read_length), int(include_deletions), int(exclude_flags))
    return args, (src, starts, lens)


@_entry
def bam_depth(lib, records, contig_starts: np.ndarray, contig_lens: np.ndarray, diff_flat: np.ndarray, *,
              min_bq: int = 0, min_mapq: int = 0, min_read_length: int = 0, include_deletions: bool = True,
              exclude_flags: int = 0x704) -> int | None:
    """Add samtools-depth difference updates (``-a -J -q -Q -l``) of the raw
    BAM records (the inflated stream past the reference list) into
    ``diff_flat``, where contig ``i``'s (length + 1) diffs start at
    ``contig_starts[i]`` (-1: skipped). The records seen, or None on a
    malformed stream (the plain reader serves)."""
    args, _keep = _depth_args(records, contig_starts, contig_lens, diff_flat, min_bq, min_mapq, min_read_length,
                              include_deletions, exclude_flags)
    n = lib.vctpu_bam_depth(*args)
    return None if n < 0 else int(n)


@_entry
def bam_pileup(lib, records, target_ref: int, start0: int, end0: int, exclude_flags: int) -> np.ndarray | None:
    """(end0 - start0, 4) int32 A/C/G/T counts of the aligned bases of contig
    ``target_ref`` over [start0, end0) from the raw BAM records (the inflated
    stream past the reference list): records with SEQ whose flags miss
    ``exclude_flags``, M/=/X bases only. None on a malformed stream (the
    plain reader serves)."""
    src = np.ascontiguousarray(_u8view(records))
    counts = np.zeros((max(end0 - start0, 0), 4), dtype=np.int32)
    n = lib.vctpu_bam_pileup(_p(src, _u8p), len(src), int(target_ref), int(start0), int(end0), int(exclude_flags),
                             _p(counts, _i32p))
    return None if n < 0 else counts


@_entry
def cram_pileup(lib, buf, target_ref: int, start0: int, end0: int, ref_seq: str) -> np.ndarray | None:
    """(end0 - start0, 4) int32 aligned base counts over one contig window of a
    whole CRAM 3.0 file's bytes (``vctpu_cram.cc``): matches from the
    reference, X features through the SM matrix, records flagged 0x704
    skipped. ``ref_seq`` is the whole target contig's sequence. None when
    the stream is malformed or uses an unsupported codec."""
    src = np.ascontiguousarray(_u8view(buf))
    ref = np.frombuffer(ref_seq.encode("ascii", "replace"), dtype=np.uint8)
    counts = np.zeros((max(end0 - start0, 0), 4), dtype=np.int32)
    n = lib.vctpu_cram_pileup(_p(src, _u8p), len(src), int(target_ref), int(start0), int(end0), _p(ref, _u8p),
                              len(ref), _p(counts, _i32p))
    return None if n < 0 else counts


@_entry
def cram_header(lib, buf) -> str | None:
    """SAM header text of a CRAM 3.0 buffer; None when unsupported."""
    src = np.ascontiguousarray(_u8view(buf))
    cap = 1 << 20
    for _ in range(4):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.vctpu_cram_header(_p(src, _u8p), len(src), _p(out, _u8p), cap)
        if n == -3:  # the text is longer than ``cap``
            cap *= 8
            continue
        return None if n < 0 else out[:n].tobytes().decode("utf-8", "replace")
    return None


@_entry
def cram_count(lib, buf) -> int | None:
    """The record count from the container headers (no block decode)."""
    src = np.ascontiguousarray(_u8view(buf))
    n = lib.vctpu_cram_count(_p(src, _u8p), len(src))
    return None if n < 0 else int(n)


@_entry
def cram_scan(lib, buf, max_records: int) -> dict | str | None:
    """Per-record arrays of a CRAM 3.0 buffer: ref_id, pos (1-based), span,
    mapq, flags, read_len; ``"grow"`` past ``max_records``; None when
    unsupported."""
    src = np.ascontiguousarray(_u8view(buf))
    out = {"ref_id": np.empty(max_records, dtype=np.int32), "pos": np.empty(max_records, dtype=np.int64),
           **{k: np.empty(max_records, dtype=np.int32) for k in ("span", "mapq", "flags", "read_len")}}
    n = lib.vctpu_cram_scan(_p(src, _u8p), len(src), max_records, _p(out["ref_id"], _i32p), _p(out["pos"], _i64p),
                            *(_p(out[k], _i32p) for k in ("span", "mapq", "flags", "read_len")))
    if n == -4:
        return "grow"
    return None if n < 0 else {k: v[:n] for k, v in out.items()}


@_entry
def cram_depth(lib, buf, contig_starts: np.ndarray, contig_lens: np.ndarray, diff_flat: np.ndarray, *,
               min_bq: int = 0, min_mapq: int = 0, min_read_length: int = 0, include_deletions: bool = True,
               exclude_flags: int = 0x704) -> int | None:
    """The CRAM twin of :func:`bam_depth` over a whole CRAM 3.0 file's bytes,
    the ``-q`` filter included: the records seen, negative when the stream
    is malformed or uses an unsupported codec (the caller raises)."""
    args, _keep = _depth_args(buf, contig_starts, contig_lens, diff_flat, min_bq, min_mapq, min_read_length,
                              include_deletions, exclude_flags)
    return int(lib.vctpu_cram_depth(*args))


@_entry
def bedgraph_lines(lib, contig: str, starts: np.ndarray, ends: np.ndarray, vals: np.ndarray) -> bytes | None:
    """``f"{contig}\\t{start}\\t{end}\\t{value}\\n"`` for each run (integers)."""
    name = np.frombuffer(contig.encode(), dtype=np.uint8) if contig else np.zeros(1, np.uint8)
    cols = [np.ascontiguousarray(a, dtype=np.int64) for a in (starts, ends, vals)]
    n = len(cols[0])
    cap = n * (len(contig) + 3 * 21 + 4) + 1
    out = np.empty(cap, dtype=np.uint8)
    w = lib.vctpu_bedgraph_lines(_p(name, _u8p), len(contig.encode()), *(_p(c, _i64p) for c in cols), n,
                                 _p(out, _u8p), cap)
    return None if w < 0 else out[:w].tobytes()


def _pack(items) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 blob, (n + 1,) int64 offsets) over the concatenated strings."""
    blob = "".join(items).encode("latin-1")
    offs = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, items), dtype=np.int64, count=len(items)), out=offs[1:])
    return np.frombuffer(blob or b"\x00", dtype=np.uint8), offs


@_entry
def match_contig_native(lib, ref_seq: str, c_pos, c_ref, c_alt, c_gt, t_pos, t_ref, t_alt, t_gt,
                        haplotype_rescue: bool = True):
    """The haplotype matcher of one contig: ``c_ref``/``t_ref`` each record's
    REF, ``c_alt``/``t_alt`` its comma-joined ALTs; (call_tp, call_tp_gt,
    truth_tp, truth_tp_gt, call_truth_idx, (capped clusters, variants in
    them)) as ``comparison.matcher`` returns them; None where the engine
    throws."""
    nc, nt = len(c_pos), len(t_pos)
    seq = np.frombuffer(ref_seq.encode("latin-1") or b"\x00", dtype=np.uint8)
    crb, cro = _pack(list(c_ref))
    cab, cao = _pack(list(c_alt))
    trb, tro = _pack(list(t_ref))
    tab, tao = _pack(list(t_alt))
    cp = np.ascontiguousarray(c_pos, dtype=np.int64)
    tp = np.ascontiguousarray(t_pos, dtype=np.int64)
    cg = np.ascontiguousarray(c_gt, dtype=np.int8)
    tg = np.ascontiguousarray(t_gt, dtype=np.int8)
    call_tp, call_tp_gt = np.zeros(max(nc, 1), dtype=np.uint8), np.zeros(max(nc, 1), dtype=np.uint8)
    truth_tp, truth_tp_gt = np.zeros(max(nt, 1), dtype=np.uint8), np.zeros(max(nt, 1), dtype=np.uint8)
    idx = np.full(max(nc, 1), -1, dtype=np.int64)
    stats = np.zeros(2, dtype=np.int64)
    rc = lib.vctpu_match_contig(
        _p(seq, _u8p), len(ref_seq),
        nc, _p(cp, _i64p), _p(crb, _u8p), _p(cro, _i64p), _p(cab, _u8p), _p(cao, _i64p), _p(cg, _i8p),
        nt, _p(tp, _i64p), _p(trb, _u8p), _p(tro, _i64p), _p(tab, _u8p), _p(tao, _i64p), _p(tg, _i8p),
        1 if haplotype_rescue else 0,
        _p(call_tp, _u8p), _p(call_tp_gt, _u8p), _p(truth_tp, _u8p), _p(truth_tp_gt, _u8p),
        _p(idx, _i64p), _p(stats, _i64p))
    if rc != 0:
        return None
    return (call_tp[:nc].astype(bool), call_tp_gt[:nc].astype(bool),
            truth_tp[:nt].astype(bool), truth_tp_gt[:nt].astype(bool), idx[:nc], stats)


@_entry
def coverage_stats(lib, data: np.ndarray, window: int, max_bin: int = 1000,
                   from_diffs: bool = False) -> tuple[np.ndarray, np.ndarray] | None:
    """One-pass coverage reduce: (per-window float32 means, (max_bin + 1,)
    int64 clipped histogram); ``from_diffs``: ``data`` is a difference array
    whose running sum is the depth. None on bad arguments."""
    d = np.ascontiguousarray(data, dtype=np.int32)
    n = len(d)
    n_win = -(-n // window) if n else 0
    means = np.empty(n_win, dtype=np.float32)
    hist = np.empty(max_bin + 1, dtype=np.int64)
    rc = lib.vctpu_coverage_stats(_p(d, _i32p), n, int(window), int(max_bin), int(bool(from_diffs)),
                                  _p(means, _f32p), _p(hist, _i64p))
    return None if rc != 0 else (means, hist)
