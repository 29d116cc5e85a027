"""The port's device-resident genome against the JAX package's window gathers.

One FASTA of three contigs (1.2 Mbp in all, so that the reference's blocked
layout has a 2^20 block boundary inside a contig) and a VCF whose records
sit at random positions, at contig starts and ends, within the radius past
an end (the N gap between contigs), beyond it, and on a contig the FASTA
lacks. The port's windows (resident genome, packed 4-byte positions,
gathered in torch on the CPU) must equal the reference's host
``gather_windows`` and its ``windows_from_packed``, in its flat layout and
in its blocked one (``_FLAT_MAX`` patched small in the test). Also: the
padding fill and packed values at and past 2^31 read all N, positions
below 1 read all N as on the reference's device path, ``genome_packable``
answers as the reference's, and the cache serves a second run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import fixtures
from variantcalling_tpu import featurize as jfeat
from variantcalling_tpu.io.fasta import FastaReader as JFastaReader
from variantcalling_tpu.io.vcf import read_vcf as jread_vcf
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch.io.fasta import FastaReader
from variantcalling_tpu_torch.io.vcf import read_vcf

R = tfeat.WINDOW_RADIUS
CONTIGS = {"chr1": 700_000, "chr2": 500_000, "chrM": 300}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("torch_genome")
    genome = fixtures.make_genome(rng, CONTIGS)
    genome["chr2"] = genome["chr2"][:1000] + "N" * 50 + "acgtn" * 10 + genome["chr2"][1100:]  # N and soft-masked
    fixtures.write_fasta(str(tmp / "ref.fa"), genome)
    # chr2 crosses the reference's first 2^20 block boundary at this 0-based position
    boundary = (1 << 20) - (2 * R + CONTIGS["chr1"] + 2 * R)
    pos: dict[str, list[int]] = {}
    for c, n in CONTIGS.items():
        edges = [1, 2, R, R + 1, n - R, n - 1, n, n + 1, n + R - 1, n + R, n + R + 1, n + 3 * R]
        pos[c] = sorted(set(edges) | set(rng.integers(1, n, 300 if n > 1000 else 20).tolist()))
    pos["chr2"] = sorted(set(pos["chr2"]) | set(range(boundary - 25, boundary + 27)))
    pos["chrUn"] = [5, 100, 5000]  # not in the FASTA
    lines = ["##fileformat=VCFv4.2",
             *[f"##contig=<ID={c},length={n}>" for c, n in CONTIGS.items()],
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for c, ps in pos.items():
        lines += [f"{c}\t{p}\t.\tA\tC\t50\tPASS\tDP=10" for p in ps]
    (tmp / "calls.vcf").write_text("\n".join(lines) + "\n")
    return tmp


def _port_windows(tmp, table=None) -> np.ndarray:
    table = read_vcf(str(tmp / "calls.vcf")) if table is None else table
    genome = tfeat.device_genome(FastaReader(str(tmp / "ref.fa")), CPU)
    packed = tfeat.pack_global_positions(tfeat.globalize_positions(table, genome), genome)
    assert packed.dtype == np.uint32
    return tfeat.windows_from_packed(genome.codes, torch.from_numpy(packed.view(np.int32)), R).numpy()


def _reference_packed_windows(tmp) -> np.ndarray:
    fasta = JFastaReader(str(tmp / "ref.fa"))
    table = jread_vcf(str(tmp / "calls.vcf"))
    genome = jfeat.device_genome(fasta)
    blk, off = jfeat.globalize_positions(table, genome)
    packed = jfeat.pack_global_positions(blk, off, genome)
    return np.asarray(jfeat.windows_from_packed(genome.blocks, jnp.asarray(packed))), genome


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.setattr(tfeat, "_DEVICE_GENOME_CACHE", {})
    monkeypatch.setattr(jfeat, "_DEVICE_GENOME_CACHE", {})


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_windows_equal_reference_device_gather(world, monkeypatch, layout):
    if layout == "blocked":
        monkeypatch.setattr(jfeat, "_FLAT_MAX", 1000)
    want, genome = _reference_packed_windows(world)
    assert genome.flat == (layout == "flat")
    got = _port_windows(world)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_windows_equal_host_gather(world):
    """Contig edges, the N gap within the radius past an end, positions beyond
    it and an unknown contig: the resident genome reads what the host gather
    reads, the reference's and the port's."""
    got = _port_windows(world)
    table = read_vcf(str(world / "calls.vcf"))
    np.testing.assert_array_equal(got, tfeat.gather_windows(table, FastaReader(str(world / "ref.fa"))))
    want = jfeat.gather_windows(jread_vcf(str(world / "calls.vcf")), JFastaReader(str(world / "ref.fa")))
    np.testing.assert_array_equal(got, want)
    chrom = np.asarray(table.chrom)
    assert (got[chrom == "chrUn"] == 4).all()
    past = (chrom == "chrM") & (table.pos >= CONTIGS["chrM"] + R + 1)
    assert past.sum() >= 2 and (got[past] == 4).all()
    in_gap = (chrom == "chr1") & (table.pos == CONTIGS["chr1"] + R - 1)
    assert (got[in_gap][0, :2] < 4).all() and (got[in_gap][0, 2:] == 4).all()


def test_fill_and_wide_packed_values_read_all_n(world):
    genome = tfeat.device_genome(FastaReader(str(world / "ref.fa")), CPU)
    fill = tfeat.packed_position_fill(genome)
    last = genome.offsets["chrM"] + genome.lengths["chrM"] - 1  # the genome's last base
    packed = np.asarray([fill, last, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)
    as_i32 = torch.from_numpy(packed.view(np.int32))
    assert (as_i32.to(torch.int64) & 0xFFFFFFFF).tolist() == packed.tolist()  # the round trip
    w = tfeat.windows_from_packed(genome.codes, as_i32, R).numpy()
    assert (w[[0, 2, 3, 4]] == 4).all()
    seq = FastaReader(str(world / "ref.fa")).fetch_encoded("chrM")
    np.testing.assert_array_equal(w[1], np.concatenate([seq[-R - 1:], np.full(R, 4, np.uint8)]))


def test_positions_below_one_read_all_n(world, tmp_path):
    """POS 0 reads all N on the resident path, as on the reference's device path."""
    text = (world / "calls.vcf").read_text().replace("chr1\t1\t.", "chr1\t0\t.", 1)
    (tmp_path / "zero.vcf").write_text(text)
    got = _port_windows(world, read_vcf(str(tmp_path / "zero.vcf")))
    fasta, table = JFastaReader(str(world / "ref.fa")), jread_vcf(str(tmp_path / "zero.vcf"))
    genome = jfeat.device_genome(fasta)
    packed = jfeat.pack_global_positions(*jfeat.globalize_positions(table, genome), genome)
    np.testing.assert_array_equal(got, np.asarray(jfeat.windows_from_packed(genome.blocks, jnp.asarray(packed))))
    assert (got[table.pos == 0] == 4).all()


class _Lengths:
    """A FASTA stand-in that has only contig lengths."""

    def __init__(self, lengths: list[int]):
        self.references = [f"c{i}" for i in range(len(lengths))]
        self._lengths = dict(zip(self.references, lengths))

    def get_reference_length(self, c: str) -> int:
        return self._lengths[c]


def test_genome_packable_answers_as_reference():
    gap = 2 * R
    top = (1 << 32) - 3 * (1 << 20)  # the most bases (gaps included) that still pack
    cases = [[1000], [3_100_000_000], [(1 << 31) - 5 * (1 << 20)], [top - 2 * gap], [top - 2 * gap + 1],
             [2_000_000_000, 2_000_000_000], [4_300_000_000], [250_000_000] * 17, [260_000_000] * 17]
    answers = [tfeat.genome_packable(_Lengths(c)) for c in cases]
    assert answers == [jfeat.genome_packable(_Lengths(c)) for c in cases]
    assert answers == [True, True, True, True, False, True, False, True, False]


def test_cache_serves_a_second_run(world):
    fasta = FastaReader(str(world / "ref.fa"))
    table = read_vcf(str(world / "calls.vcf"))
    assert len(table) < tfeat.GENOME_RESIDENT_MIN_VARIANTS
    assert not tfeat._genome_resident_worthwhile(table, fasta, CPU)
    first = tfeat.device_genome(fasta, CPU)
    assert first.nbytes == 2 * R + sum(n + 2 * R for n in CONTIGS.values())
    again = tfeat.device_genome(FastaReader(str(world / "ref.fa")), CPU)
    assert again is first
    assert tfeat._genome_resident_worthwhile(table, FastaReader(str(world / "ref.fa")), CPU)
    assert not tfeat._genome_resident_worthwhile(table, fasta, CPU, radius=R + 1)
