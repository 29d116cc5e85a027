"""``find_runs_bed`` of the port against the JAX package's, on the CPU.

The runs world (``synthetic.write_runs_world``: contigs whose own runs are
at most 4 bases, planted runs of 5-60 bp, N blocks, runs at both ends of
every contig) and hand-made FASTAs (runs of N, a run of exactly
``--min_length``, lowercase bases, several contigs, an empty selection):
the BED byte-equal to the JAX tool's, and equal to the planted runs and to
an independent walk of the sequence. ``ops/runs`` alone against the
reference's scan on random codes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from variantcalling_tpu.ops import runs as jruns
from variantcalling_tpu.pipelines.misc import find_runs_bed as jtool
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.ops import runs as truns
from variantcalling_tpu_torch.pipelines.misc import find_runs_bed as ttool


def _both(tmp_path: Path, argv: list[str]) -> tuple[str, str]:
    out = {}
    for pkg, run in (("jax", jtool.run), ("torch", ttool.run)):
        bed = tmp_path / f"{pkg}.bed"
        assert run([*argv, "--output_bed", str(bed)] + (["--backend", "cpu"] if pkg == "torch" else [])) == 0
        out[pkg] = bed.read_text()
    return out["torch"], out["jax"]


def _walk(seq: str, min_length: int) -> list[tuple[int, int]]:
    """(start, end) of every run of one real base of at least ``min_length``, a base at a time."""
    out, i = [], 0
    up = seq.upper()
    while i < len(up):
        j = i
        while j < len(up) and up[j] == up[i]:
            j += 1
        if j - i >= min_length and up[i] in "ACGT":
            out.append((i, j))
        i = j
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return synthetic.write_runs_world(str(tmp_path_factory.mktemp("runs")), seed=11,
                                      contigs=(("chr20", 400_000), ("chrM", 16_569)), n_runs=3_000, n_blocks=6)


@pytest.mark.parametrize("min_length", [5, 10, 37])
def test_runs_world(world, tmp_path, min_length):
    got, want = _both(tmp_path, ["--reference", world["fasta"], "--min_length", str(min_length)])
    assert got == want
    planted = [f"{c}\t{s}\t{s + n}\n" for c, s, n in world["planted"] if n >= min_length]
    assert got == "".join(planted) and len(planted) > 20


def test_contig_selection_and_halo(world, tmp_path):
    got, want = _both(tmp_path, ["--reference", world["fasta"], "--contigs", "chrM", "--halo", "12"])
    assert got == want and got.startswith("chrM\t0\t23\n") and "chr20" not in got


def test_hand_made_fasta(tmp_path):
    seqs = {"c1": "AAAAACCCCCNNNNNNNNNNGGGGGGGGGGTTTTTTTTTTTaaaaaaaaaaC",
            "c2": "NNNNNNNNNNNNACGTACGTTTTTTTTTT",
            "c3": "ACGT",
            "c4": "CCCCCCCCCC"}
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">{k}\n" + "\n".join(v[i:i + 7] for i in range(0, len(v), 7)) + "\n"
                          for k, v in seqs.items()))
    for min_length in (1, 5, 10, 11):
        got, want = _both(tmp_path, ["--reference", str(fa), "--min_length", str(min_length)])
        assert got == want
        assert got == "".join(f"{c}\t{s}\t{e}\n" for c, v in seqs.items() for s, e in _walk(v, min_length))


@pytest.mark.parametrize("n", [1, 2, 97, 10_000])
def test_scan_against_the_reference(n):
    rng = np.random.default_rng(n)
    codes = np.repeat(rng.integers(0, 5, n).astype(np.uint8), rng.integers(1, 15, n))
    for min_length in (1, 3, 10):
        s, ln = truns.find_runs(codes, min_length, "cpu")
        js, jl = jruns.find_runs(codes, min_length)
        assert np.array_equal(s, js) and np.array_equal(ln, jl)
        starts, lengths = truns.run_starts_lengths(torch.from_numpy(codes))
        assert int(lengths.sum()) == len(codes) and starts.dtype == torch.int64


def test_empty_contig_codes():
    s, ln = truns.find_runs(np.zeros(0, np.uint8), 3, "cpu")
    assert len(s) == 0 and len(ln) == 0
