"""The port's ``.venc`` genome sidecar against the JAX package's.

The sidecar holds the encoded genome beside the FASTA (or under
``VCTPU_GENOME_CACHE_DIR``): the port must write the reference's bytes,
each package must read the other's, a FASTA rewritten since (another mtime
or size) or a cut-short sidecar is ignored with a warning and re-encoded,
``VCTPU_GENOME_CACHE=0`` reads and writes nothing, and the resident genome
of the filter pipeline fills from the sidecar ("sidecar" in ``GENOME_LOG``)
with the codes of an encode.
"""

import logging
import os

import numpy as np
import pytest
import torch

from tests import fixtures
from variantcalling_tpu.io.fasta import FastaReader as JFastaReader
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch.io.fasta import FastaReader


@pytest.fixture
def fasta(tmp_path, monkeypatch):
    """A three-contig FASTA with lowercase and N runs; no cache settings."""
    monkeypatch.delenv("VCTPU_GENOME_CACHE", raising=False)
    monkeypatch.delenv("VCTPU_GENOME_CACHE_DIR", raising=False)
    rng = np.random.default_rng(4)
    genome = fixtures.make_genome(rng, {"chr1": 5000, "chr2": 777, "chrM": 61})
    genome["chr2"] = genome["chr2"][:100].lower() + "N" * 50 + genome["chr2"][150:]
    path = tmp_path / "ref.fa"
    fixtures.write_fasta(str(path), genome)
    return path


def _codes(reader) -> dict[str, np.ndarray]:
    return {c: np.asarray(reader.fetch_encoded(c)) for c in reader.references}


def test_sidecar_bytes_equal_the_reference(fasta, tmp_path, monkeypatch):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(port_dir))
    port = FastaReader(str(fasta))
    port.encode_all()
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(ref_dir))
    ref = JFastaReader(str(fasta))
    ref.encode_all()
    (name,) = os.listdir(port_dir)
    assert os.listdir(ref_dir) == [name]
    got, want = (port_dir / name).read_bytes(), (ref_dir / name).read_bytes()
    assert got == want
    assert got.startswith(b"VCENC1\n{\"key\": {\"path\": ")
    assert len(got) == len(b"VCENC1\n") + got.index(b"\n", 7) - 7 + 1 + 5000 + 777 + 61


def test_each_package_reads_the_others_sidecar(fasta, monkeypatch):
    ref = JFastaReader(str(fasta))
    ref.encode_all()  # the reference writes <fasta>.venc
    want = _codes(ref)
    assert os.path.exists(f"{fasta}.venc")
    port = FastaReader(str(fasta))
    assert port.has_sidecar
    assert all(np.array_equal(port.fetch_encoded(c), want[c]) for c in want)
    os.remove(f"{fasta}.venc")
    port = FastaReader(str(fasta))
    assert not port.has_sidecar
    port.encode_all()
    ref = JFastaReader(str(fasta))
    assert ref._venc is not None
    assert all(np.array_equal(ref.fetch_encoded(c), want[c]) for c in want)


def test_venc_path_under_the_cache_dir_matches_the_reference(fasta, tmp_path, monkeypatch):
    assert FastaReader(str(fasta))._venc_path() == JFastaReader(str(fasta))._venc_path() == f"{fasta}.venc"
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(tmp_path / "cache"))
    got = FastaReader(str(fasta))._venc_path()
    assert got == JFastaReader(str(fasta))._venc_path()
    assert os.path.dirname(got) == str(tmp_path / "cache") and got.endswith(".venc")


@pytest.mark.parametrize("change", ["mtime", "size"])
def test_a_rewritten_fasta_is_encoded_again(fasta, caplog, change):
    FastaReader(str(fasta)).encode_all()
    old = open(f"{fasta}.venc", "rb").read()
    st = os.stat(fasta)
    if change == "size":
        with open(fasta, "a") as fh:
            fh.write(">chrX\nACGTNacgt\n")
        os.remove(f"{fasta}.fai")
    else:
        os.utime(fasta, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    caplog.set_level(logging.WARNING)
    port = FastaReader(str(fasta))
    assert not port.has_sidecar and "stale genome cache" in caplog.text
    want = _codes(JFastaReader(str(fasta)))
    port.encode_all()
    assert all(np.array_equal(port.fetch_encoded(c), want[c]) for c in want)
    assert open(f"{fasta}.venc", "rb").read() != old
    assert FastaReader(str(fasta)).has_sidecar


@pytest.mark.parametrize("cut", [10, -100])
def test_a_cut_short_sidecar_is_ignored_with_a_warning(fasta, caplog, cut):
    FastaReader(str(fasta)).encode_all()
    data = open(f"{fasta}.venc", "rb").read()
    open(f"{fasta}.venc", "wb").write(data[:cut])
    caplog.set_level(logging.WARNING)
    port = FastaReader(str(fasta))
    assert not port.has_sidecar and "ignoring" in caplog.text and str(fasta) in caplog.text
    want = _codes(JFastaReader(str(fasta)))
    assert all(np.array_equal(port.fetch_encoded(c), want[c]) for c in want)


def test_genome_cache_off_reads_and_writes_nothing(fasta, tmp_path, monkeypatch):
    FastaReader(str(fasta)).encode_all()
    before = os.stat(f"{fasta}.venc").st_mtime_ns
    monkeypatch.setenv("VCTPU_GENOME_CACHE", "0")
    port = FastaReader(str(fasta))
    assert not port.has_sidecar
    port.encode_all()
    assert os.stat(f"{fasta}.venc").st_mtime_ns == before
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(tmp_path / "empty"))
    FastaReader(str(fasta)).encode_all()
    assert not (tmp_path / "empty").exists()


def test_an_unwritable_cache_dir_skips_the_sidecar(fasta, tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("VCTPU_GENOME_CACHE_DIR", str(blocker / "sub"))
    port = FastaReader(str(fasta))
    port.encode_all()  # the OSError is logged, not raised
    assert not port.has_sidecar and blocker.read_text() == "not a directory"


def test_resident_genome_fills_from_the_sidecar(fasta, monkeypatch, caplog):
    """The first build encodes and writes the sidecar; a later reader's build
    memory-maps it; the flat codes are equal."""
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    caplog.set_level(logging.INFO, logger="variantcalling_tpu_torch")
    cpu = torch.device("cpu")
    first = tfeat.device_genome(FastaReader(str(fasta)), cpu)
    assert first.source == "encoded" and os.path.exists(f"{fasta}.venc")
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    second = tfeat.device_genome(FastaReader(str(fasta)), cpu)
    assert second.source == "sidecar"
    assert torch.equal(first.codes, second.codes) and first.offsets == second.offsets
    sources = [r.args[2] for r in caplog.records if r.msg == tfeat.GENOME_LOG]
    assert sources == ["encoded", "sidecar"]
    assert JFastaReader(str(fasta))._venc is not None
