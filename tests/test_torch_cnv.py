"""``cnv_calling`` of the port against the JAX package's, on the CPU.

The Viterbi's plain version (what a CPU tensor gets; the card's kernel is
held to it in ``tests/test_torch_cuda.py``) against
``variantcalling_tpu.cnv.caller.viterbi_segment`` at tolerance 0 on planted
segments, noise, near-ties and one-bin sequences, several sequences in one
call; the HMM's constants; ``binned_depth`` and ``gc_per_bin``; the CLI's
BED and VCF bytes with and without ``--reference``, against the JAX
package's CLI; ``--backend gpu`` without a card exits 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests import fixtures
from variantcalling_tpu.cnv import caller as jcaller
from variantcalling_tpu.io.fasta import FastaReader as JFasta
from variantcalling_tpu.pipelines import cnv_calling as jcnv
from variantcalling_tpu_torch.cnv import caller as tcaller
from variantcalling_tpu_torch.cnv import viterbi_cuda
from variantcalling_tpu_torch.io.fasta import FastaReader as TFasta
from variantcalling_tpu_torch.pipelines import cnv_calling as tcnv
from variantcalling_tpu_torch.synthetic import _genome, _write_fasta


def _obs(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.4, n).astype(np.float32)
    for _ in range(4):
        s = int(rng.integers(0, n))
        x[s: s + int(rng.integers(1, 300))] += np.float32(rng.choice([-3.0, -1.0, 0.585, 1.0]))
    return x


@pytest.mark.parametrize("sigma", [0.35, 0.2, 0.6])
@pytest.mark.parametrize("seed,n", [(1, 1), (2, 2), (3, 50), (4, 2000), (5, 7777)])
def test_viterbi_states_equal_the_reference(seed, n, sigma):
    x = _obs(seed, n)
    got = tcaller.viterbi_segment(x, sigma=sigma, device="cpu")
    want = jcaller.viterbi_segment(x, sigma=sigma)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["midpoints", "constant", "state_means", "floor"])
def test_viterbi_near_ties_equal_the_reference(kind):
    """Observations that put candidates at or near ties: the first index
    wins on both sides, and the float32 arithmetic matches."""
    means = jcaller.state_means().astype(np.float32)
    mids = ((means[1:] + means[:-1]) / 2).astype(np.float32)
    x = {"midpoints": np.tile(mids, 300), "constant": np.full(1000, mids[2], np.float32),
         "state_means": np.repeat(means, 200), "floor": np.full(500, -3.0, np.float32)}[kind]
    got = tcaller.viterbi_segment(x, device="cpu")
    assert np.array_equal(got, jcaller.viterbi_segment(x))


def test_one_call_of_many_sequences_is_each_alone():
    seqs = [_obs(10 + i, n) if n else np.zeros(0, np.float32) for i, n in enumerate((1, 500, 0, 1300, 3))]
    together = tcaller.segment_states(seqs, device="cpu")
    for s, got in zip(seqs, together):
        alone = tcaller.viterbi_segment(s, device="cpu") if len(s) else np.zeros(0, np.int32)
        assert np.array_equal(got, alone)
        if len(s):
            assert np.array_equal(got, jcaller.viterbi_segment(s))


def test_hmm_constants_are_the_references():
    p = viterbi_cuda.hmm_params(0.35, 0.999)
    k = 5
    want_lt = np.asarray(jnp.log(jnp.where(jnp.eye(k, dtype=bool), 0.999, (1.0 - 0.999) / (k - 1)))
                         .astype(jnp.float32))
    assert np.array_equal(p["log_trans"], want_lt)
    assert np.array_equal(p["log_init"], np.asarray(jnp.log(jnp.full((k,), 1.0 / k))))
    assert np.array_equal(p["means"], np.asarray(jnp.asarray(jcaller.state_means(), dtype=jnp.float32)))
    assert p["inv_sigma"] == np.float32(1.0) / np.float32(0.35)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    obs = torch.zeros(10)
    with pytest.raises(ValueError, match="the card"):
        viterbi_cuda.viterbi_launch(obs, torch.tensor([0, 10]), viterbi_cuda.hmm_params())
    with pytest.raises(ValueError, match="offsets"):
        viterbi_cuda.viterbi_states(obs, torch.tensor([0, 9]), viterbi_cuda.hmm_params())
    with pytest.raises(ValueError, match="float32"):
        viterbi_cuda.viterbi_states(obs.double(), torch.tensor([0, 10]), viterbi_cuda.hmm_params())


def test_normalize_and_segments_equal_the_reference():
    rng = np.random.default_rng(4)
    depth = {c: rng.poisson(30, n).astype(np.float32) for c, n in (("chr1", 900), ("chr2", 400))}
    depth["chr1"][100:200] = 15
    depth["chr2"][50:90] = 0
    gc = {c: rng.random(len(v)).astype(np.float32) for c, v in depth.items()}
    for g in (None, gc):
        got = tcaller.call_cnvs(depth, 1000, g, device="cpu")
        want = jcaller.call_cnvs(depth, 1000, g)
        assert [vars(s) for s in got] == [vars(s) for s in want] and got


@pytest.mark.parametrize("n,bin_size", [(10_000, 1000), (10_999, 1000), (999, 1000), (12_345, 7)])
def test_binned_depth_is_the_references(n, bin_size):
    d = np.random.default_rng(n).integers(0, 2000, n).astype(np.int32)
    got = tcnv.binned_depth(torch.from_numpy(d), bin_size)
    assert got.dtype == np.float32 and np.array_equal(got, jcnv.binned_depth(d, bin_size))


def test_gc_per_bin_is_the_references(tmp_path):
    rng = np.random.default_rng(9)
    _write_fasta(str(tmp_path / "ref.fa"), [("chr1", _genome(rng, 5003)), ("chr2", _genome(rng, 777))])
    text = (tmp_path / "ref.fa").read_text()
    (tmp_path / "mixed.fa").write_text(text.replace("ACG", "acN").replace("TT", "tS"))
    for name in ("ref.fa", "mixed.fa"):
        t, j = TFasta(str(tmp_path / name)), JFasta(str(tmp_path / name))
        for contig, n_bins, size in (("chr1", 5, 1000), ("chr1", 6, 1000), ("chr2", 3, 300), ("chr2", 100, 7)):
            assert np.array_equal(tcnv.gc_per_bin(t, contig, n_bins, size), jcnv.gc_per_bin(j, contig, n_bins, size))


@pytest.fixture(scope="module")
def cnv_world(tmp_path_factory):
    """A BAM with a deletion, a duplication and a loss of both copies planted on chr1."""
    d = tmp_path_factory.mktemp("cnv")
    rng = np.random.default_rng(3)
    contigs = {"chr1": 60_000, "chr2": 40_000, "chr3": 3000}
    reads = []
    for c, n in contigs.items():
        cov = np.full(n, 20.0)
        if c == "chr1":
            cov[10_000:16_000], cov[30_000:36_000], cov[50_000:52_000] = 10, 40, 0
        k = int(cov.sum() / 100)
        for p in np.sort(rng.choice(n - 100, size=k, p=cov[: n - 100] / cov[: n - 100].sum())):
            reads.append({"contig": c, "pos": int(p), "cigar": [("M", 100)], "mapq": int(rng.choice([0, 60, 60]))})
    fixtures.write_bam(str(d / "cnv.bam"), contigs, reads)
    _write_fasta(str(d / "ref.fa"), [(c, _genome(rng, n - (500 if c == "chr2" else 0))) for c, n in contigs.items()])
    return d


@pytest.mark.parametrize("vcf", ["calls.vcf", "calls.vcf.gz", None])
@pytest.mark.parametrize("gc", [False, True], ids=["no_reference", "reference"])
def test_cli_bytes_equal_the_reference(cnv_world, tmp_path, gc, vcf):
    d = cnv_world
    argv = ["--input_bam", str(d / "cnv.bam"), "--bin_size", "500", "--min_contig_length", "10000"]
    if gc:
        argv += ["--reference", str(d / "ref.fa")]
    outs = {}
    for who, run, extra in (("port", tcnv.run, ["--backend", "cpu"]), ("ref", jcnv.run, [])):
        bed = tmp_path / f"{who}.bed"
        more = ["--output_vcf", str(tmp_path / f"{who}.{vcf}")] if vcf else []
        assert run([*argv, "--output_bed", str(bed), *more, *extra]) == 0
        outs[who] = [bed.read_bytes()] + ([(tmp_path / f"{who}.{vcf}").read_bytes()] if vcf else [])
    assert outs["port"] == outs["ref"]
    cns = [line.split(b"\t")[3] for line in outs["port"][0].splitlines()]
    assert cns == [b"CN1", b"CN4", b"CN0"]


def test_cli_backend_gpu_without_a_card_exits_2(cnv_world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcnv.run(["--input_bam", str(cnv_world / "cnv.bam"), "--output_bed", str(tmp_path / "x.bed")]) == 2
    assert not (tmp_path / "x.bed").exists()
