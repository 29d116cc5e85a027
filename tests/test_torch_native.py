"""The port's native host engine (``variantcalling_tpu_torch/native``), entry point by entry point.

Each entry point is held, at tolerance 0, to two things: the port's plain
Python version (what runs with ``VCTPU_NO_NATIVE=1``), and the JAX
package's native engine on the same input, loaded through its own module
as its tests load it. The scan's numbers must equal Python's ``float()``
bit for bit, on hypothesis-drawn decimal strings too (more than 15
significant digits, exponents, ``inf``/``nan``, signs). Also: the knobs
``VCTPU_NO_NATIVE``, ``VCTPU_NATIVE_THREADS`` and
``VCTPU_FASTA_CACHE_BYTES``, the build (one compile for many processes; a
failed build logged once and the plain versions serving) and the call
counters. Skipped, with the reason, where g++ is absent.
"""

import gzip
import logging
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from variantcalling_tpu import native as jnative
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io import bgzf, fasta, vcf
from variantcalling_tpu_torch.ops import intervals

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: the engine cannot be built")

ROOT = Path(__file__).resolve().parents[1]
HEADER = (b"##fileformat=VCFv4.2\n##contig=<ID=chr1,length=5000>\n##contig=<ID=chr2,length=5000>\n"
          b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
#: records the filter pipeline meets: multiallelic, symbolic and ``*`` ALTs,
#: lower case, indels either way, missing and phased and haploid GT, AD with
#: ``.``, an empty INFO, INFO flags, lists, no FORMAT at all, CRLF
RECORDS = [
    b"chr1\t100\trs1\tA\tG\t69.40\tPASS\tDP=12;SOR=1.5;AF=0.5\tGT:GQ:AD\t0/1:99:5,7",
    b"chr1\t110\t.\tA\tAT,G\t24240.00\t.\tDP=7;DB;AS_SOR=0.7,0.2\tGT:AD:GQ\t1|2:3,4,5:12",
    b"chr1\t120\t.\tACG\tA\t.\tLowQual\t.\tGT:GQ\t./.:.",
    b"chr1\t130\t.\tc\tt\t1e3\tPASS\tTLOD=6.25;END=140\tGT\t1",
    b"chr1\t140\t.\tT\t<DEL>\t50\tPASS\tSVTYPE=DEL\tGT:AD\t0/1:.",
    b"chr1\t150\t.\tG\t*\t3.14159265358979323846\tPASS\tQD=12.3456789012345678\tGT:AD\t1/1:0,9",
    b"chr1\t160\t.\tGAAAA\tG\t-0\tPASS\tMQ=60;FS=-1.5e-3\tGT:GQ:AD\t0/1:20:10,0",
    b"chr1\t170\t.\tA\tACCCC\t12\tPASS\tDP=\tGT:GQ\t0/1",
    b"chr2\t10\t.\tA\tC\t7.5\tPASS\tDP=3\r",
    b"chr2\t20\t.\tAT\tAG\tinf\tPASS\tSOR=nan;AF=.,0.3\tGT:GQ:AD\t0|1:7.5:1,2,3",
    b"chr2\t30\t.\tN\t.\t0.00\tPASS\tDP=0\tGT\t0/0",
]


def _text(records=RECORDS, header=HEADER) -> bytes:
    return header + b"\n".join(records) + b"\n"


@pytest.fixture(autouse=True)
def _engine_on(monkeypatch):
    monkeypatch.delenv("VCTPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("VCTPU_NATIVE_THREADS", raising=False)
    assert native.available()


def _plain(monkeypatch):
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_floats(a, b) -> bool:
    """Bit for bit, every NaN counted as one."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b)) and np.array_equal(_bits(a)[~nan], _bits(b)[~nan]))


def _parse_both(data: bytes, n_samples: int = 1):
    buf = np.frombuffer(data, dtype=np.uint8)
    return native.vcf_parse(buf, n_samples), jnative.vcf_parse(buf, n_samples)


# -- the scan --------------------------------------------------------------

def test_vcf_parse_equals_the_reference_engine():
    got, want = _parse_both(_text())
    assert got is not None and want is not None and got["n"] == len(RECORDS)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert _same_floats(got[k], v), k
        elif isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _columns(t: vcf.VariantTable) -> dict:
    return {"chrom": list(t.chrom), "pos": t.pos.tolist(), "vid": list(t.vid), "ref": list(t.ref),
            "alt": list(t.alt), "filters": list(t.filters), "info": list(t.info), "tail": list(t.tail),
            "qual_text": list(t.qual_text), "n_alts": t.n_alts().tolist(), "gt": t.genotypes().tolist()}


@pytest.mark.parametrize("crlf", [False, True])
def test_scanned_table_equals_the_plain_reader(tmp_path, monkeypatch, crlf):
    data = _text()
    (tmp_path / "a.vcf").write_bytes(data.replace(b"\n", b"\r\n") if crlf else data)
    native.reset_calls()
    scanned = vcf.read_vcf(str(tmp_path / "a.vcf"))
    assert scanned.aux is not None and native.CALLS["vcf_parse"]["native"] == 1
    assert native.CALLS["vcf_parse"]["plain"] == 0
    _plain(monkeypatch)
    plain = vcf.read_vcf(str(tmp_path / "a.vcf"))
    assert plain.aux is None and native.CALLS["vcf_parse"]["plain"] == 1
    assert _columns(scanned) == _columns(plain)
    assert _same_floats(scanned.qual, plain.qual)
    for key in ("DP", "SOR", "AF", "QD", "FS", "MQ", "TLOD", "AS_SOR", "END"):
        assert _same_floats(scanned.info_field(key), plain.info_field(key)), key
    for name in ("GQ", "DP"):
        assert _same_floats(scanned.format_numeric(name, max_len=1, missing=np.nan),
                            plain.format_numeric(name, max_len=1, missing=np.nan)), name
    assert scanned.header.lines == plain.header.lines and scanned.header.samples == plain.header.samples


def test_scanned_subset_carries_the_scan(tmp_path, monkeypatch):
    (tmp_path / "a.vcf").write_bytes(_text())
    keep = np.asarray([c == "chr2" for c in vcf.read_vcf(str(tmp_path / "a.vcf")).chrom])
    scanned = vcf.read_vcf(str(tmp_path / "a.vcf")).subset(keep)
    _plain(monkeypatch)
    plain = vcf.read_vcf(str(tmp_path / "a.vcf")).subset(keep)
    assert len(scanned) == int(keep.sum()) == len(scanned.aux.gt) == len(scanned.chrom_codes)
    assert _columns(scanned) == _columns(plain)
    assert _same_floats(scanned.info_field("SOR"), plain.info_field("SOR"))


def test_malformed_record_declines_the_scan(tmp_path):
    """A record of 7 columns: the scan declines, the plain reader serves it."""
    bad = _text(RECORDS[:3] + [b"chr1\t200\t.\tA\tG\t5\tPASS"] + RECORDS[3:])
    assert native.vcf_parse(np.frombuffer(bad, np.uint8), 1) is None
    assert jnative.vcf_parse(np.frombuffer(bad, np.uint8), 1) is None
    (tmp_path / "a.vcf").write_bytes(bad)
    native.reset_calls()
    table = vcf.read_vcf(str(tmp_path / "a.vcf"))
    assert table.aux is None and len(table) == len(RECORDS) + 1 and table.info[3] == "."
    assert native.CALLS["vcf_parse"]["plain"] == 1 and native.CALLS["vcf_parse"]["native"] == 0


_DECIMAL = st.from_regex(r"[+-]?[0-9]{1,24}(\.[0-9]{0,24})?([eE][+-]?[0-9]{1,3})?", fullmatch=True)
_SPECIAL = st.sampled_from(["inf", "-inf", "+inf", "Infinity", "-Infinity", "nan", "NaN", "-nan", "INF",
                            "0", "-0", "+0.0", "1.", ".5", "-.5", "999999999999999", "9999999999999999",
                            "0.1000000000000000055511151231257827", "1e308", "1e309", "4.9e-324", "2e-324"])


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.one_of(_DECIMAL, _SPECIAL), min_size=1, max_size=8))
def test_parse_double_equals_python_float(values):
    """QUAL, an INFO key, GQ and AD: the scan's value is ``float(s)`` (GQ and
    AD: its float32), bit for bit, and the reference engine's."""
    recs = [b"chr1\t%d\t.\tA\tG\t%s\tPASS\tSOR=%s\tGT:GQ:AD\t0/1:%s:%s,%s" % (i + 1, *(s.encode(),) * 5)
            for i, s in enumerate(values)]
    got, want = _parse_both(_text(recs))
    exact = np.asarray([float(s) for s in values])
    assert _same_floats(got["qual"], exact) and _same_floats(got["info_vals"][:, 1], exact)
    with np.errstate(over="ignore"):  # past float32's range: inf, as the C cast gives
        single = exact.astype(np.float32)
    assert _same_floats(got["gq"], single) and _same_floats(got["ad"][:, 0], single)
    for k in ("qual", "info_vals", "gq", "ad"):
        assert _same_floats(got[k], want[k]), k


# -- writeback: the INFO formatter and the record assembly -----------------

@pytest.mark.parametrize("vals", [
    np.round(np.linspace(0, 1, 257, dtype=np.float32), 4),
    np.asarray([np.nan, 0.0, -0.0, 1.0, 0.5, 1e-5, 123456.7, -99.9999, 1e20, 0.12345678, np.inf, -np.inf]),
])
def test_format_float_info_equals_printf_g(vals):
    buf, offs = native.format_float_info(vals, b";TREE_SCORE=")
    f64 = vals.astype(np.float64)
    want = [b"" if np.isnan(v) else b";TREE_SCORE=%g" % v for v in f64]
    got = [bytes(buf[offs[i]: offs[i + 1]]) for i in range(len(vals))]
    assert got == want
    jbuf, joffs = jnative.format_float_info(vals, b";TREE_SCORE=")
    assert np.array_equal(buf, jbuf) and np.array_equal(offs, joffs)


def _tables(tmp_path, monkeypatch, data: bytes):
    (tmp_path / "a.vcf").write_bytes(data)
    scanned = vcf.read_vcf(str(tmp_path / "a.vcf"))
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    plain = vcf.read_vcf(str(tmp_path / "a.vcf"))
    monkeypatch.delenv("VCTPU_NO_NATIVE")
    return scanned, plain


@pytest.mark.parametrize("filters_kind", ["factorized", "object"])
@pytest.mark.parametrize("crlf", [False, True])
def test_assembled_writeback_equals_the_plain_writer(tmp_path, monkeypatch, filters_kind, crlf):
    data = _text()
    scanned, plain = _tables(tmp_path, monkeypatch, data.replace(b"\n", b"\r\n") if crlf else data)
    n = len(scanned)
    codes = np.arange(n) % 3
    uniques = ["PASS", "LOW_SCORE", "COHORT_FP;HPOL_RUN"]
    filters = vcf.FactorizedColumn(codes, uniques) if filters_kind == "factorized" \
        else np.asarray(uniques, dtype=object)[codes]
    score = np.round(np.linspace(0, 1, n, dtype=np.float32), 4)
    score[2] = np.nan  # no key written; record 2's INFO stays "."
    native.reset_calls()
    vcf.write_vcf(str(tmp_path / "native.vcf"), scanned, new_filters=filters, extra_info={"TREE_SCORE": score},
                  verbatim_core=True)
    assert native.CALLS["vcf_assemble"]["native"] == native.CALLS["format_float_info"]["native"] == 1
    vcf.write_vcf(str(tmp_path / "plain.vcf"), plain, new_filters=filters, extra_info={"TREE_SCORE": score},
                  verbatim_core=True)
    assert native.CALLS["vcf_assemble"]["plain"] == 1
    got = (tmp_path / "native.vcf").read_bytes()
    assert got == (tmp_path / "plain.vcf").read_bytes()
    lines = got.split(b"\n")
    assert b"\tLOW_SCORE\tDP=7;DB;AS_SOR=0.7,0.2;TREE_SCORE=" in lines[-11] and b"\t.\tGT:GQ\t./.:." in lines[-10]


def test_vcf_assemble_equals_the_reference_engine_in_chunks(tmp_path, monkeypatch):
    """Blob offsets are absolute: a chunk passes its window of them, and the
    chunks' bytes join to the whole; the reference engine gives the same."""
    scanned, _ = _tables(tmp_path, monkeypatch, _text())
    aux, n = scanned.aux, len(scanned)
    filt, filt_offs = vcf._encode_column_factorized(np.asarray(["PASS"] * n, dtype=object), n)
    sfx, sfx_offs = native.format_float_info(np.linspace(0, 1, n), b";S=")
    args = (aux.buf, aux.line_spans, aux.filter_spans, aux.info_spans, aux.tail_spans, filt, filt_offs, sfx,
            sfx_offs)
    whole = native.vcf_assemble(*args).tobytes()
    assert whole == jnative.vcf_assemble(*args).tobytes()
    parts = b"".join(native.vcf_assemble(aux.buf, *(a[lo:hi] for a in args[1:5]), filt, filt_offs[lo:hi + 1], sfx,
                                         sfx_offs[lo:hi + 1]).tobytes() for lo, hi in ((0, 4), (4, 5), (5, n)))
    assert parts == whole


def test_writeback_without_verbatim_core_renders_columns(tmp_path, monkeypatch):
    """An edited QUAL: the plain writer renders it (verbatim_core is the
    caller's promise that CHROM..QUAL are as read)."""
    scanned, _ = _tables(tmp_path, monkeypatch, _text())
    scanned.qual = scanned.qual.copy()
    scanned.qual[0] = 70.25
    native.reset_calls()
    vcf.write_vcf(str(tmp_path / "o.vcf"), scanned)
    assert native.CALLS["vcf_assemble"] == {"native": 0, "native_s": 0.0, "plain": 0}
    rec = [ln for ln in (tmp_path / "o.vcf").read_text().splitlines() if not ln.startswith("#")][0]
    assert rec.split("\t")[5] == "70.25"


# -- BGZF --------------------------------------------------------------------

def _payload(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join(b"chr1\t%d\t.\tA\tG\t%d\tPASS\tDP=%d\n" % (i, q, d) for i, q, d in
                    zip(range(n), rng.integers(0, 99, n), rng.integers(0, 60, n)))


@pytest.mark.parametrize("size", [0, 1, 65280, 65281, 3 * 65280, 400_000])
def test_bgzf_compress_equals_the_reference_engine_and_inflates(size):
    data = _payload(20_000)[:size]
    got = native.bgzf_compress(data)
    assert got == jnative.bgzf_compress(data)  # one libz serves both
    assert got.endswith(bgzf.BGZF_EOF) and gzip.decompress(got) == data
    spans = bgzf.block_spans(got)
    assert len(spans) == size // bgzf.MAX_BLOCK_DATA + (size % bgzf.MAX_BLOCK_DATA > 0) + 1


def test_bgzf_writer_native_and_plain_give_the_same_payload(tmp_path, monkeypatch):
    """Block for block the same split; the compressed bytes equal only where
    Python's zlib is the same libz, so the payloads are compared."""
    data = _payload(30_000, seed=1)
    for name in ("native", "plain"):
        if name == "plain":
            _plain(monkeypatch)
        native.reset_calls()
        with bgzf.BgzfWriter(str(tmp_path / f"{name}.gz")) as w:
            w.write(data[:1000])
            w.write(memoryview(data)[1000:])
        assert native.CALLS["bgzf_compress"][name] >= 1
    a, b = ((tmp_path / f"{n}.gz").read_bytes() for n in ("native", "plain"))
    assert gzip.decompress(a) == gzip.decompress(b) == data
    assert [s for _, s in bgzf.iter_blocks(str(tmp_path / "native.gz"))] == \
        [s for _, s in bgzf.iter_blocks(str(tmp_path / "plain.gz"))]
    if zlib.ZLIB_RUNTIME_VERSION == zlib.ZLIB_VERSION:
        assert len(a) == len(b)


@pytest.mark.parametrize("kind", ["bgzf", "gzip", "gzip_members"])
def test_bgzf_decompress_array(kind):
    data = _payload(25_000, seed=2)
    comp = {"bgzf": native.bgzf_compress(data) or b"", "gzip": gzip.compress(data),
            "gzip_members": gzip.compress(data[:5000]) + gzip.compress(data[5000:])}[kind]
    got = native.bgzf_decompress_array(comp)
    assert got.tobytes() == data == jnative.bgzf_decompress_array(comp).tobytes()


def test_bgzf_decompress_refuses_corrupt_input():
    comp = bytearray(native.bgzf_compress(_payload(5000)))
    comp[40] ^= 0xFF
    native.reset_calls()
    assert native.bgzf_decompress_array(bytes(comp)) is None
    assert native.bgzf_decompress_array(b"") is None
    assert native.CALLS["bgzf_decompress_array"]["plain"] == 2


@pytest.mark.parametrize("gz", ["bgzf", "gzip"])
def test_gz_input_is_inflated_by_the_engine(tmp_path, monkeypatch, gz):
    data = _text()
    path = tmp_path / "a.vcf.gz"
    path.write_bytes(native.bgzf_compress(data) if gz == "bgzf" else gzip.compress(data))
    native.reset_calls()
    scanned = vcf.read_vcf(str(path))
    assert scanned.aux is not None and native.CALLS["bgzf_decompress_array"]["native"] == 1
    monkeypatch.setattr(vcf, "NATIVE_INFLATE_MAX_BYTES", 10)  # above the cap: the plain reader
    capped = vcf.read_vcf(str(path))
    assert capped.aux is None and native.CALLS["bgzf_decompress_array"]["plain"] == 1
    assert _columns(scanned) == _columns(capped)


# -- the host window gather, FASTA encode, interval membership ---------------

@pytest.mark.parametrize("radius", [1, 20])
def test_gather_windows_contig_equals_the_plain_gather(radius):
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 5, 1000).astype(np.uint8)
    pos0 = np.concatenate([[-50, -1, 0, 5, 999, 1000, 1010, 5000], rng.integers(0, 1000, 500)]).astype(np.int64)
    got = native.gather_windows_contig(seq, pos0, radius)
    padded = np.concatenate([np.full(radius, 4, np.uint8), seq, np.full(radius, 4, np.uint8)])
    idx = (pos0 + radius)[:, None] + np.arange(-radius, radius + 1)[None, :]
    want = np.where((idx >= 0) & (idx < len(padded)), padded[np.clip(idx, 0, len(padded) - 1)], 4)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jnative.gather_windows_contig(seq, pos0, radius))


def _write_fasta(path: Path, contigs: dict[str, bytes], width: int, eol: bytes = b"\n") -> None:
    with open(path, "wb") as fh:
        for name, seq in contigs.items():
            fh.write(b">" + name.encode() + b" desc" + eol)
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + eol)


@pytest.mark.parametrize("width,eol", [(60, b"\n"), (7, b"\n"), (50, b"\r\n"), (10_000, b"\n")])
def test_fasta_encode_equals_the_numpy_encode(tmp_path, monkeypatch, width, eol):
    rng = np.random.default_rng(4)
    contigs = {f"c{i}": bytes(rng.choice(list(b"ACGTacgtNRY"), n).astype(np.uint8))
               for i, n in enumerate((1, 59, 60, 61, 1234))}
    _write_fasta(tmp_path / "g.fa", contigs, width, eol)
    monkeypatch.setenv("VCTPU_GENOME_CACHE", "0")
    native.reset_calls()
    got = {c: fasta.FastaReader(str(tmp_path / "g.fa")).encode_contig(c) for c in contigs}
    assert native.CALLS["fasta_encode"]["native"] == len(contigs)  # a newline ends every line, the last too
    _plain(monkeypatch)
    want = {c: fasta.FastaReader(str(tmp_path / "g.fa")).encode_contig(c) for c in contigs}
    for c, seq in contigs.items():
        assert np.array_equal(got[c], want[c]) and np.array_equal(got[c], fasta.encode_seq(seq.decode())), c


def test_fasta_encode_equals_the_reference_engine():
    rng = np.random.default_rng(5)
    raw = np.frombuffer(b"".join(bytes(rng.choice(list(b"ACGTN"), 60).astype(np.uint8)) + b"\n"
                                 for _ in range(30)), dtype=np.uint8)
    assert np.array_equal(native.fasta_encode(raw, 60, 61, 1790), jnative.fasta_encode(raw, 60, 61, 1790))
    assert native.fasta_encode(raw, 60, 61, 10_000) is None  # the framing does not cover the length


def test_interval_membership_equals_the_plain_join(monkeypatch):
    rng = np.random.default_rng(6)
    starts = np.sort(rng.choice(1_000_000, 400, replace=False)).astype(np.int64)
    ends = starts + rng.integers(1, 2000, 400)
    ends = np.minimum(ends, np.concatenate([starts[1:], [2_000_000]]))
    gpos = rng.integers(-5, 1_100_000, intervals.NATIVE_MIN_POSITIONS + 7)
    native.reset_calls()
    got = intervals.membership(gpos, starts, ends)
    assert native.CALLS["interval_membership"]["native"] == 1
    _plain(monkeypatch)
    want = intervals.membership(gpos, starts, ends)
    assert native.CALLS["interval_membership"]["plain"] == 1
    assert got.dtype == want.dtype == bool and np.array_equal(got, want) and 0 < got.sum() < len(got)
    monkeypatch.delenv("VCTPU_NO_NATIVE")
    pos = np.maximum(gpos, 0)
    assert np.array_equal(native.interval_membership(starts, ends, pos), jnative.interval_membership(starts, ends, pos))


# -- knobs, build, counters --------------------------------------------------

def test_no_native_turns_every_entry_point_off(monkeypatch):
    _plain(monkeypatch)
    native.reset_calls()
    assert not native.available() and native.engine_name() == "plain" and native.native_threads() is None
    assert native.vcf_parse(np.frombuffer(_text(), np.uint8), 1) is None
    assert native.bgzf_compress(b"abc") is None and native.format_float_info(np.zeros(3), b";K=") is None
    assert {k: v["plain"] for k, v in native.CALLS.items() if v["plain"]} == \
        {"vcf_parse": 1, "bgzf_compress": 1, "format_float_info": 1}
    monkeypatch.delenv("VCTPU_NO_NATIVE")
    assert native.available() and native.engine_name() == "native"


def _many_records(n: int) -> bytes:
    rng = np.random.default_rng(7)
    return _text([b"chr%d\t%d\t.\tA\tG\t%.2f\tPASS\tDP=%d;SOR=%.3f\tGT:GQ:AD\t0/1:%d:%d,%d" % (
        1 + i * 3 // n, i, q, d, s, g, a, b) for i, q, d, s, g, a, b in zip(
        range(n), rng.uniform(0, 100, n), rng.integers(0, 90, n), rng.uniform(0, 5, n), rng.integers(0, 99, n),
        rng.integers(0, 30, n), rng.integers(0, 30, n))])


@pytest.mark.parametrize("threads", ["1", "3", "8"])
def test_native_threads_is_honoured_and_changes_no_byte(monkeypatch, threads):
    """The scan shards at 4,096 records a thread; every fan-out gives the
    single thread's arrays (CHROM codes in order of first appearance)."""
    data = _many_records(40_000)
    monkeypatch.setenv("VCTPU_NATIVE_THREADS", "1")
    one = native.vcf_parse(np.frombuffer(data, np.uint8), 1)
    monkeypatch.setenv("VCTPU_NATIVE_THREADS", threads)
    assert native.native_threads() == int(threads)
    got = native.vcf_parse(np.frombuffer(data, np.uint8), 1)
    for k, v in one.items():
        assert (_same_floats(got[k], v) if isinstance(v, np.ndarray) and v.dtype.kind == "f" else
                np.array_equal(got[k], v) if isinstance(v, np.ndarray) else got[k] == v), k
    assert one["chroms"] == ["chr1", "chr2", "chr3"]
    assert native.bgzf_compress(data) == jnative.bgzf_compress(data)


@pytest.mark.parametrize("budget,cached", [("0", []), ("1300", ["c1"]), (None, ["c0", "c1"])])
def test_fasta_cache_bytes_bounds_the_encoded_contigs(tmp_path, monkeypatch, budget, cached):
    contigs = {"c0": b"ACGT" * 300, "c1": b"GGCA" * 310}
    _write_fasta(tmp_path / "g.fa", contigs, 60)
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(tmp_path / "venc"))
    if budget is not None:
        monkeypatch.setenv("VCTPU_FASTA_CACHE_BYTES", budget)
    reader = fasta.FastaReader(str(tmp_path / "g.fa"))
    for c, seq in contigs.items():
        assert np.array_equal(reader.fetch_encoded(c), fasta.encode_seq(seq.decode()))
    assert list(reader._encoded) == cached
    # the sidecar needs every contig in the cache
    assert (tmp_path / "venc").exists() == (budget is None)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory of the test's own, and the loaded engine forgotten."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_FAILED", False)
    return tmp_path / "build"


def test_a_failed_build_is_logged_once_and_the_plain_versions_serve(fresh_build, monkeypatch, caplog):
    monkeypatch.setattr(native, "CXXFLAGS", [*native.CXXFLAGS, "-DVCTPU_BROKEN", "-include", "no_such_header.h"])
    caplog.set_level(logging.WARNING, logger="variantcalling_tpu_torch.native")
    native.reset_calls()
    assert native.get_lib() is None and native.get_lib() is None
    assert native.vcf_parse(np.frombuffer(_text(), np.uint8), 1) is None
    assert native.CALLS["vcf_parse"]["plain"] == 1
    warnings = [r.getMessage() for r in caplog.records]
    assert len(warnings) == 1 and "g++ failed" in warnings[0] and "no_such_header.h" in warnings[0]
    assert not list(fresh_build.glob("*.so")) and not list(fresh_build.glob("*.tmp"))


def test_concurrent_processes_compile_once(fresh_build):
    """Four processes ask for the engine at once: one compiles, all load it."""
    code = ("import sys; from pathlib import Path; from variantcalling_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); print(native.get_lib() is not None)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(fresh_build)], cwd=ROOT, stdout=subprocess.PIPE,
                              text=True) for _ in range(4)]
    assert [p.communicate(timeout=600)[0].strip() for p in procs] == ["True"] * 4
    assert [p.name for p in fresh_build.glob("*.so")] == [native.library_path().name]
    assert not list(fresh_build.glob("*.tmp"))
