"""The port's window features against the JAX package's, with tolerance 0.

Same numpy inputs through ``variantcalling_tpu.ops.features`` (plain jnp)
and ``variantcalling_tpu_torch.ops.features`` (plain torch, on the CPU):
random windows, windows with N bases, contig-edge windows (N padding on one
side), and the flow orders TGCA and ACGT. Values and dtypes must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import fixtures
from variantcalling_tpu import featurize as jfeat
from variantcalling_tpu.io.fasta import FastaReader as JFastaReader
from variantcalling_tpu.io.fasta import encode_seq as j_encode_seq
from variantcalling_tpu.io.vcf import read_vcf as jread_vcf
from variantcalling_tpu.ops import features as jops
from variantcalling_tpu_torch import featurize as tfeat
from variantcalling_tpu_torch.io.fasta import FastaReader, encode_seq
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.ops import features as tops

CENTER = 20
W = 41


def _windows(kind: str, n: int = 600, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, size=(n, W), dtype=np.uint8)
    # homopolymer runs through the anchor so the run-length paths are exercised
    runs = rng.random(n) < 0.4
    run_len = rng.integers(1, 20, size=n)
    cols = np.arange(W)[None, :]
    in_run = runs[:, None] & (cols > CENTER) & (cols <= CENTER + run_len[:, None])
    w = np.where(in_run, w[:, CENTER + 1][:, None], w)
    if kind == "with_n":
        w[rng.random((n, W)) < 0.08] = 4
    elif kind == "contig_edge":
        edge = rng.integers(0, CENTER + 6, size=n)
        left = rng.random(n) < 0.5
        pad_left = left[:, None] & (cols < edge[:, None])
        pad_right = ~left[:, None] & (cols >= W - edge[:, None])
        w[pad_left | pad_right] = 4
    return w


def _alleles(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    is_snp = rng.random(n) < 0.6
    is_indel = ~is_snp & (rng.random(n) < 0.8)
    indel_nuc = np.where(is_indel, rng.integers(0, 5, n), 4).astype(np.int32)
    ref_code = np.where(is_snp, rng.integers(0, 5, n), 4).astype(np.int32)
    alt_code = np.where(is_snp, rng.integers(0, 5, n), 4).astype(np.int32)
    return is_indel, indel_nuc, ref_code, alt_code, is_snp


def _eq(t: torch.Tensor, j) -> None:
    got, want = t.numpy(), np.asarray(j)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


KINDS = ("random", "with_n", "contig_edge")


@pytest.mark.parametrize("kind", KINDS)
def test_gc_content(kind):
    w = _windows(kind)
    _eq(tops.gc_content(torch.from_numpy(w), CENTER), jops.gc_content(jnp.asarray(w), CENTER))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("start", [CENTER + 1, 0, W - 3])
def test_run_length_at(kind, start):
    w = _windows(kind)
    _eq(tops.run_length_at(torch.from_numpy(w), start), jops.run_length_at(jnp.asarray(w), start))


@pytest.mark.parametrize("kind", KINDS)
def test_hmer_indel_features(kind):
    w = _windows(kind)
    is_indel, indel_nuc, *_ = _alleles(len(w))
    got = tops.hmer_indel_features(torch.from_numpy(w), CENTER, torch.from_numpy(is_indel),
                                   torch.from_numpy(indel_nuc))
    want = jops.hmer_indel_features(jnp.asarray(w), CENTER, jnp.asarray(is_indel), jnp.asarray(indel_nuc))
    for g, r in zip(got, want):
        _eq(g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_motif_codes(kind):
    w = _windows(kind)
    for g, r in zip(tops.motif_codes(torch.from_numpy(w), CENTER), jops.motif_codes(jnp.asarray(w), CENTER)):
        _eq(g, r)


@pytest.mark.parametrize("flow_order", ["TGCA", "ACGT"])
@pytest.mark.parametrize("kind", KINDS)
def test_flow_signature_and_cycle_skip(kind, flow_order):
    w = _windows(kind)
    _, _, ref_code, alt_code, is_snp = _alleles(len(w))
    hap = np.concatenate([w[:, CENTER - 4:CENTER], ref_code[:, None].astype(np.uint8),
                          w[:, CENTER + 1:CENTER + 5]], axis=1).astype(np.int32)
    fo = [{"A": 0, "C": 1, "G": 2, "T": 3}[c] for c in flow_order]
    got = tops._flow_signature(torch.from_numpy(hap), torch.tensor(fo, dtype=torch.int32))
    want = jops._flow_signature(jnp.asarray(hap), jnp.asarray(fo, dtype=jnp.int32))
    for g, r in zip(got, want):
        _eq(g, r)
    _eq(tops.cycle_skip_status(torch.from_numpy(w), CENTER, torch.from_numpy(ref_code),
                               torch.from_numpy(alt_code), torch.from_numpy(is_snp), flow_order=flow_order),
        jops.cycle_skip_status(jnp.asarray(w), CENTER, jnp.asarray(ref_code), jnp.asarray(alt_code),
                               jnp.asarray(is_snp), flow_order=flow_order))


@pytest.mark.parametrize("flow_order", ["TGCA", "ACGT"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_feature_dict(kind, flow_order):
    w = _windows(kind, n=1000, seed=5)
    args = _alleles(len(w), seed=6)
    got = tfeat.device_feature_dict(torch.from_numpy(w), *(torch.from_numpy(a) for a in args),
                                    center=CENTER, flow_order=flow_order)
    want = jfeat.device_feature_dict(jnp.asarray(w), *(jnp.asarray(a) for a in args),
                                     center=CENTER, flow_order=flow_order)
    assert list(got) == list(want) == list(tfeat.DEVICE_FEATURES)
    for k in want:
        _eq(got[k], want[k])


def test_encode_seq():
    seq = "ACGTNacgtnRYKM-*" * 5
    np.testing.assert_array_equal(encode_seq(seq), j_encode_seq(seq))


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("torch_feat")
    contigs = {"chr1": 6000, "chr2": 3000}
    genome = fixtures.make_genome(rng, contigs)
    fixtures.write_fasta(str(tmp / "ref.fa"), genome)
    recs = fixtures.synth_variants(rng, genome, 300)
    for i, r in enumerate(recs):
        r["gq"] = int(rng.integers(10, 90))
        r["ad"] = [int(rng.integers(0, 30)), int(rng.integers(1, 30))]
        if i % 7 == 0:  # multiallelic records
            r["alts"] = r["alts"] + ["T" if r["alts"][0] != "T" else "G"]
            r["ad"].append(int(rng.integers(1, 9)))
    # records near both contig ends: windows padded with N
    recs.append({"chrom": "chr1", "pos": 3, "ref": genome["chr1"][2], "alts": ["A" if genome["chr1"][2] != "A" else "C"],
                 "qual": 33.0, "gt": (0, 1)})
    recs.append({"chrom": "chr2", "pos": 2999, "ref": genome["chr2"][2998], "alts": ["G" if genome["chr2"][2998] != "G" else "T"],
                 "qual": 44.5, "gt": (1, 1)})
    recs.sort(key=lambda r: (r["chrom"], r["pos"]))
    fixtures.write_vcf(str(tmp / "calls.vcf"), recs, contigs)
    return tmp


@pytest.mark.parametrize("flow_order", ["TGCA", "ACGT"])
def test_host_featurize_and_materialize_match_reference(small_world, flow_order):
    """Every column of the full feature matrix (host columns from the port's
    Python VCF reader, window features in torch) equals the reference's."""
    vcf, fa = str(small_world / "calls.vcf"), str(small_world / "ref.fa")
    jt, jf = jread_vcf(vcf), JFastaReader(fa)
    jhf = jfeat.host_featurize(jt, jf)
    want = jfeat.materialize_features(jhf, flow_order=flow_order)
    hf = tfeat.host_featurize(read_vcf(vcf), FastaReader(fa))
    np.testing.assert_array_equal(hf.windows, jhf.windows)
    got = tfeat.materialize_features(hf, flow_order=flow_order, device="cpu")
    assert got.feature_names == want.feature_names
    for name in want.feature_names:
        g, r = np.asarray(got.columns[name]), np.asarray(want.columns[name])
        np.testing.assert_array_equal(g.astype(np.float32), r.astype(np.float32), err_msg=name)
    np.testing.assert_array_equal(got.matrix(), want.matrix())
