"""The port's CRAM 3.0 reader against the JAX package's, on the CPU.

Files written by ``tests/cram_fixtures.write_cram`` (raw, gzip and rANS-4x8
blocks): the header, the record arrays, depth under every filter equal to
the JAX package's and to the BAM of the same reads (``-q`` over mixed
qualities included), the ``.cram`` dispatch of ``io/bam``, and a corrupt
file or an engine turned off raising ``ValueError``.
"""

import numpy as np
import pytest

from tests import fixtures
from tests.cram_fixtures import GZIP, RANS, RAW, write_cram
from variantcalling_tpu.io import bam as jbam
from variantcalling_tpu.io import cram as jcram
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io import bam as tbam
from variantcalling_tpu_torch.io import cram as tcram

HEADER = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:3000\n@SQ\tSN:chr2\tLN:500\n"
FILTERS = [{}, {"min_bq": 20}, {"min_mapq": 20}, {"min_read_length": 40}, {"include_deletions": False},
           {"min_bq": 25, "include_deletions": False, "min_mapq": 10}]


def _reads(seed: int, n: int = 300):
    """The same reads as CRAM records and as BAM reads (CIGARs from the
    CRAM features), in coordinate order, on chr1."""
    rng = np.random.default_rng(seed)
    cram, bam = [], []
    for i, pos in enumerate(np.sort(rng.integers(1, 2900, n))):
        kind = int(rng.integers(5))
        quals = rng.integers(2, 41, 48).tolist()
        flag = int(rng.choice([0, 0, 0x10, 0x400, 0x100]))
        mapq = int(rng.integers(0, 61))
        feats, cigar = {0: ([], [("M", 48)]),
                        1: ([("D", 21, 4)], [("M", 20), ("D", 4), ("M", 28)]),
                        2: ([("S", 1, b"ACGTA")], [("S", 5), ("M", 43)]),
                        3: ([("I", 11, b"GG")], [("M", 10), ("I", 2), ("M", 36)]),
                        4: ([("N", 31, 30)], [("M", 30), ("N", 30), ("M", 18)])}[kind]
        cram.append({"flag": flag, "pos": int(pos), "read_len": 48, "mapq": mapq, "name": f"r{i}",
                     "features": feats, "quals": quals})
        bam.append({"contig": "chr1", "pos": int(pos) - 1, "cigar": cigar, "mapq": mapq, "flag": flag,
                    "quals": quals, "name": f"r{i}"})
    return cram, bam


@pytest.fixture(scope="module", params=[RAW, GZIP, RANS], ids=["raw", "gzip", "rans"])
def world(tmp_path_factory, request):
    if not native.available():
        pytest.skip("CRAM decoding needs the native host engine (g++)")
    d = tmp_path_factory.mktemp("cram")
    cram, bam = _reads(7)
    cram_p, bam_p = str(d / "reads.cram"), str(d / "reads.bam")
    write_cram(cram_p, HEADER, cram, method=request.param)
    fixtures.write_bam(bam_p, {"chr1": 3000, "chr2": 500}, bam)
    return cram_p, bam_p


def test_header_equals_the_reference(world):
    got, want = tcram.read_cram_header(world[0]), jcram.read_cram_header(world[0])
    assert (got.text, got.references, got.lengths) == (want.text, want.references, want.lengths)
    assert got.lengths == {"chr1": 3000, "chr2": 500}


def test_records_equal_the_reference(world):
    (gh, got), (_, want) = tcram.cram_records(world[0]), jcram.cram_records(world[0])
    assert gh.references == ["chr1", "chr2"] and list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want) and len(got["pos"]) == 300


@pytest.mark.parametrize("kwargs", FILTERS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_depth_equals_the_reference_and_the_bam(world, kwargs):
    cram_p, bam_p = world
    _, got = tcram.depth_diff_arrays(cram_p, **kwargs)
    _, want = jcram.depth_diff_arrays(cram_p, **kwargs)
    _, from_bam = tbam.depth_diff_arrays(bam_p, **kwargs)
    assert list(got) == list(want) == list(from_bam)
    for c in want:
        assert np.array_equal(got[c], want[c]) and np.array_equal(got[c], from_bam[c]), c


def test_q_filter_acts_as_on_the_bam(world):
    """``-q 20`` drops the low-quality bases' coverage from the CRAM as from the BAM."""
    cram_p, bam_p = world
    _, a = tbam.depth_diff_arrays(cram_p)  # the .cram dispatch of io/bam
    _, b = tbam.depth_diff_arrays(cram_p, min_bq=20)
    _, c = jbam.depth_diff_arrays(bam_p, min_bq=20)
    assert not np.array_equal(a["chr1"], b["chr1"]) and np.array_equal(b["chr1"], c["chr1"])


def test_regions_and_counts(world):
    native.reset_calls()
    _, got = tcram.depth_diff_arrays(world[0], regions=["chr2"])
    assert list(got) == ["chr2"] and not got["chr2"].any()
    assert native.CALLS["cram_depth"]["native"] == 1 and native.CALLS["cram_header"]["native"] == 1


@pytest.mark.parametrize("damage", ["truncated", "garbage", "not_cram"])
def test_corrupt_file_raises_value_error(world, tmp_path, damage):
    data = open(world[0], "rb").read()
    bad = {"truncated": data[: len(data) // 2], "garbage": data[:26] + bytes(range(256)) * 4,
           "not_cram": b"BAM\x01" + bytes(100)}[damage]
    path = tmp_path / "bad.cram"
    path.write_bytes(bad)
    with pytest.raises(ValueError):
        tcram.depth_diff_arrays(str(path))
    with pytest.raises(ValueError):
        jcram.depth_diff_arrays(str(path))


def test_engine_off_raises_value_error(world, monkeypatch):
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    with pytest.raises(ValueError, match="native engine unavailable"):
        tcram.depth_diff_arrays(world[0])


# -- C5: the 100 kbp CRAM that both packages refuse ------------------------------------------------------------

C5_CUT = 100_000


def _ltf8_spec(v: int) -> bytes:
    """LTF8 by the CRAM 3.0 specification (section 2.3): the count of leading
    1 bits of the first byte says how many bytes follow; a 3-byte form holds
    21 bits, a 4-byte form 28 (the longer forms are not needed here)."""
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    assert v < 0x10000000
    return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])


def _read_ltf8(buf: bytes, i: int = 0) -> tuple[int, int]:
    """(value, bytes used) of the LTF8 at ``buf[i]``, read by the specification."""
    b0 = buf[i]
    n = 0
    while n < 8 and b0 & (0x80 >> n):
        n += 1
    value = b0 & (0xFF >> (n + 1)) if n < 7 else 0
    for k in range(n):
        value = (value << 8) | buf[i + 1 + k]
    return value, n + 1


@pytest.fixture(scope="module")
def c5_reads():
    from variantcalling_tpu_torch import synthetic

    if not native.available():
        pytest.skip("CRAM decoding needs the native host engine (g++)")
    reads = synthetic.coverage_reads(2028, [("chr20", C5_CUT)], 30.0, ())
    return reads, synthetic.coverage_cram_records(reads)


def test_c5_the_writer_breaks_ltf8_in_the_container_base_count(c5_reads):
    """The fault of the 100 kbp file is the writer's: the data container's
    header field "number of bases" (an LTF8, CRAM 3.0 section 7.1) holds
    2,995,200, which needs 22 bits; ``tests/cram_fixtures.ltf8`` writes it in
    the 3-byte form, which holds 21, so bit 21 lands in the first byte's
    prefix (0xED: the 4-byte form) and a reader consumes one byte too many,
    shifting every field after it. The 150 and 200 kbp cuts' counts have bit
    21 clear, so their prefixes stay 3-byte (their values are cut, but no
    reader uses this count) and they decode."""
    from tests import cram_fixtures

    _, records = c5_reads
    n_bases = sum(r["read_len"] for r in records)
    assert (len(records), n_bases) == (19_968, 2_995_200)
    written = cram_fixtures.ltf8(n_bases)
    assert written == bytes.fromhex("edb400")
    value, used = _read_ltf8(written + b"\x00" * 8)
    assert used == 4 != len(written)  # the 4-byte form's prefix on a 3-byte field
    assert _ltf8_spec(n_bases) == bytes.fromhex("e02db400") and _read_ltf8(_ltf8_spec(n_bases)) == (n_bases, 4)
    for cut, bases in ((150_000, 4_492_800), (200_000, 5_995_200)):
        prefix = cram_fixtures.ltf8(bases)[0]
        assert prefix >> 5 == 0b110, cut  # a 3-byte prefix: these decode


def test_c5_the_port_decodes_the_file_written_to_the_specification(c5_reads, tmp_path, monkeypatch):
    """Written with the field to the specification, the same 19,968 reads
    decode, and their depth equals the BAM's of the same reads; written by
    the fixture as it is, the port refuses the file as the reference does."""
    from tests import cram_fixtures
    from variantcalling_tpu_torch import synthetic

    reads, records = c5_reads
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr20\tLN:{C5_CUT}\n"
    bam_p, bad_p, good_p = (str(tmp_path / n) for n in ("reads.bam", "as_written.cram", "to_spec.cram"))
    synthetic.write_coverage_bam(bam_p, reads)
    cram_fixtures.write_cram(bad_p, header, records, method=GZIP)
    with pytest.raises(ValueError, match="malformed stream"):
        tcram.depth_diff_arrays(bad_p)
    with pytest.raises(ValueError):
        jcram.depth_diff_arrays(bad_p)
    monkeypatch.setattr(cram_fixtures, "ltf8", _ltf8_spec)
    cram_fixtures.write_cram(good_p, header, records, method=GZIP)
    _, got = tcram.depth_diff_arrays(good_p)
    _, want = tbam.depth_diff_arrays(bam_p)
    assert list(got) == list(want) == ["chr20"] and np.array_equal(got["chr20"], want["chr20"])
    assert np.cumsum(got["chr20"]).max() > 0
