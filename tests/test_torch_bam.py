"""The port's BAM reader and depth walk against the JAX package's, on the CPU.

``io/bam.depth_diff_arrays`` (the native engine's ``bam_depth`` by default,
the pure-Python ``BamReader`` walk under ``VCTPU_NO_NATIVE=1``) against
``variantcalling_tpu.io.bam.depth_diff_arrays`` at tolerance 0: flags,
MAPQ, ``-l``, ``-q`` over mixed base qualities, deletions with and without
``-J``, N skips, regions; the records ``BamReader`` yields; the engine's
call counts.
"""

import numpy as np
import pytest

from tests import torch_worlds
from variantcalling_tpu.io import bam as jbam
from variantcalling_tpu_torch import native
from variantcalling_tpu_torch.io import bam as tbam

CONTIGS = {"chr1": 4000, "chr2": 2500, "chrM": 300}
FILTERS = [
    {},
    {"min_bq": 20},
    {"min_bq": 35},
    {"min_mapq": 20},
    {"min_read_length": 45},
    {"include_deletions": False},
    {"min_bq": 20, "include_deletions": False},
    {"min_bq": 15, "min_mapq": 30, "min_read_length": 30},
    {"regions": ["chr2"]},
    {"regions": ["chr1:100-900", "chrM"]},
]


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    return torch_worlds.write_alignment_world(str(tmp_path_factory.mktemp("bam") / "reads.bam"), seed=11,
                                              contigs=CONTIGS, n_reads=900)


def _assert_same(port, ref):
    (th, td), (jh, jd) = port, ref
    assert th.references == jh.references and th.lengths == jh.lengths and th.text == jh.text
    assert list(td) == list(jd)
    for c in jd:
        assert td[c].dtype == np.int32 and np.array_equal(td[c], jd[c]), c


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("kwargs", FILTERS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_depth_diffs_equal_the_reference(bam_path, kwargs, plain, monkeypatch):
    if plain:
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    _assert_same(tbam.depth_diff_arrays(bam_path, **kwargs), jbam.depth_diff_arrays(bam_path, **kwargs))


def test_native_walk_is_counted_and_the_plain_twin_too(bam_path, monkeypatch):
    if not native.available():
        pytest.skip("needs the native host engine (g++)")
    native.reset_calls()
    tbam.depth_diff_arrays(bam_path, min_bq=20)
    assert native.CALLS["bam_depth"]["native"] == 1 and native.CALLS["bam_depth"]["plain"] == 0
    assert native.CALLS["bgzf_decompress_array"]["native"] == 1
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    native.reset_calls()
    tbam.depth_diff_arrays(bam_path)
    assert native.CALLS["bam_depth"] == {"native": 0, "native_s": 0.0, "plain": 1}


def test_the_filters_act(bam_path):
    """The world's reads make every filter change the depth."""
    _, base = tbam.depth_diff_arrays(bam_path)
    for kwargs in FILTERS[1:8]:
        _, got = tbam.depth_diff_arrays(bam_path, **kwargs)
        assert any(not np.array_equal(got[c], base[c]) for c in base), kwargs


def test_depth_vectors_are_the_cumsum(bam_path):
    header, diffs = tbam.depth_diff_arrays(bam_path)
    got = tbam.depth_vectors(header, diffs)
    want = jbam.depth_vectors(*jbam.depth_diff_arrays(bam_path))
    assert list(got) == list(want) and all(np.array_equal(got[c], want[c]) for c in want)
    assert all(len(got[c]) == CONTIGS[c] for c in CONTIGS)


@pytest.mark.parametrize("decode", [(False, False), (True, True)], ids=["plain", "seq_and_tags"])
def test_reader_yields_the_reference_records(bam_path, decode):
    with tbam.BamReader(bam_path, decode_seq=decode[0], decode_tags=decode[1]) as t, \
            jbam.BamReader(bam_path, decode_seq=decode[0], decode_tags=decode[1]) as j:
        assert (t.header.text, t.header.references, t.header.lengths) == \
            (j.header.text, j.header.references, j.header.lengths)
        n = 0
        for a, b in zip(t, j, strict=True):
            n += 1
            assert (a.ref_id, a.pos, a.mapq, a.flag, a.cigar, a.read_len, a.tags) == \
                (b.ref_id, b.pos, b.mapq, b.flag, b.cigar, b.read_len, b.tags)
            assert np.array_equal(a.qual, b.qual) and (a.seq is None) == (b.seq is None)
            if a.seq is not None:
                assert np.array_equal(a.seq, b.seq)
        assert n == 900


@pytest.mark.parametrize("kwargs", [{}, {"min_bq": 20}, {"include_deletions": False}], ids=["default", "q20", "noJ"])
def test_reads_past_the_contig_end(tmp_path, kwargs, monkeypatch):
    """Reads running past their contig's end: the port's plain walk gives the
    native walk's depth, which is the reference's native walk's (the
    reference's own Python walk raises ``IndexError`` on them)."""
    path = torch_worlds.write_alignment_world(str(tmp_path / "over.bam"), seed=5, contigs={"chr1": 300, "chr2": 200},
                                              n_reads=200, overhang=True)
    ref = jbam.depth_diff_arrays(path, **kwargs)
    if native.available():
        _assert_same(tbam.depth_diff_arrays(path, **kwargs), ref)
    monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    _assert_same(tbam.depth_diff_arrays(path, **kwargs), ref)


def test_not_a_bam_raises(tmp_path):
    """The engine declines a stream without the BAM magic; the plain reader raises."""
    import gzip

    bad = tmp_path / "bad.bam"
    with gzip.open(bad, "wb") as fh:
        fh.write(b"XXXX" + bytes(64))
    with pytest.raises(ValueError, match="not a BAM"):
        tbam.depth_diff_arrays(str(bad))
