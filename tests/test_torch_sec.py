"""The port's SEC against the JAX package's, on the CPU.

Inputs made from a seed with numpy: count tables for ``ops/stats``, and a
small SEC world (``synthetic.write_sec_world``: a cohort of 6 callsets on
a 2 Mbp contig, a held-out callset and its truth). Bars:

- ``ops/stats``: the log-pmf to 64 float32 ulps of ``gammaln(n + 1)``
  (``torch.lgamma`` is not XLA's ``gammaln``), the likelihood ratio to a
  relative 5e-4 (``tests/torch_sec_compare.RTOL``; the test prints the
  largest it measured), the other functions to float32 rounding or
  exactly;
- ``SecDb`` files load in the other package (keys, counts, contigs and
  ``n_samples`` equal), ``merge_sample_counts`` exactly;
- ``observed_allele_counts`` exactly, on the native scan's fast path and
  on the text, over AD with missing, negative and odd values and 1 to 6
  alts;
- the CLIs: DB files exactly (default, ``--relevant_coords``,
  ``--min_samples`` with duplicate keys in one sample, ``--use_mesh``);
  corrected VCFs and sweeps under ``tests/torch_sec_compare``; the
  assessment's frames exactly.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.scipy.special import gammaln

from tests import torch_sec_compare
from tests.fixtures import write_vcf
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.io.vcf import read_vcf as j_read_vcf
from variantcalling_tpu.ops import stats as jstats
from variantcalling_tpu.sec import caller as jcaller
from variantcalling_tpu.sec import db as jdb
from variantcalling_tpu.utils.h5_utils import read_hdf as j_read_hdf
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.io.vcf import read_vcf as t_read_vcf
from variantcalling_tpu_torch.ops import stats as tstats
from variantcalling_tpu_torch.sec import aggregate as tagg
from variantcalling_tpu_torch.sec import caller as tcaller
from variantcalling_tpu_torch.sec import db as tdb

ULPS = 64 * float(np.finfo(np.float32).eps)


def _counts(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(observed (n, 5), noise (n, 5)) float32: AD up to 2,000 with a few
    alt slots, noise counts up to 200,000 with zeros."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((n, 5), np.float32)
    depth = rng.integers(1, 2001, n)
    obs[:, 1] = rng.binomial(depth, rng.uniform(0, 1, n))
    obs[:, 0] = depth - obs[:, 1]
    obs[:, 2:] = rng.binomial(depth[:, None] // 10, 0.1, (n, 3))
    noise = (rng.integers(0, 200_001, (n, 5)) * (rng.random((n, 5)) < 0.8)).astype(np.float32)
    return obs, noise


def _t(a):
    return torch.from_numpy(np.array(a))


def test_log_pmf_and_ratio_against_jax():
    obs, noise = _counts(7, 50_000)
    p = np.asarray(jstats.correct_multinomial_frequencies(jnp.asarray(noise)))
    want = np.asarray(jstats.multinomial_log_pmf(jnp.asarray(obs), jnp.asarray(p)))
    got = tstats.multinomial_log_pmf(_t(obs), _t(p)).numpy()
    scale = np.asarray(gammaln(obs.sum(1).astype(np.float64) + 1)) + 1
    err = np.abs(got - want) / scale
    print(f"log-pmf: largest |torch - jax| / (gammaln(n + 1) + 1) = {err.max():.3g} (bar {ULPS:.3g})")
    assert err.max() <= ULPS
    jl, jr = (np.asarray(a) for a in jstats.multinomial_likelihood_ratio(jnp.asarray(obs), jnp.asarray(noise)))
    tl, tr = (a.numpy() for a in tstats.multinomial_likelihood_ratio(_t(obs), _t(noise)))
    for name, got, want in (("likelihood", tl, jl), ("ratio", tr, jr)):
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        live = want > 1e-30
        print(f"{name}: largest relative difference {rel[live].max():.3g} over {int(live.sum())} rows above 1e-30")
        assert rel[live].max() <= torch_sec_compare.RTOL
        assert np.abs(got - want)[~live].max(initial=0) <= 1e-30
    small_obs, small_noise = obs[:, :] % 50, noise % 300  # the likelihood itself, where it does not underflow
    want = np.asarray(jstats.multinomial_likelihood(jnp.asarray(small_obs), jnp.asarray(small_noise)))
    got = tstats.multinomial_likelihood(_t(small_obs), _t(small_noise)).numpy()
    live = want > 1e-30
    assert (np.abs(got - want)[live] / want[live]).max() <= torch_sec_compare.RTOL


def test_noise_likelihood_ratio_is_the_reference_ratio():
    obs, noise = _counts(8, 5_000)
    want = np.asarray(jcaller.noise_likelihood_ratio(jnp.asarray(obs), jnp.asarray(noise)))
    got = tcaller.noise_likelihood_ratio(_t(obs), _t(noise)).numpy()
    live = want > 1e-30
    assert (np.abs(got - want)[live] / want[live]).max() <= torch_sec_compare.RTOL


def _close(got, want, atol: float = 0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if atol:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["correct_multinomial_frequencies", "scale_contingency_table", "precision_from_counts",
                                  "recall_from_counts", "f1_from_pr", "confusion_counts",
                                  "precision_recall_curve_dense", "safe_divide"])
def test_other_stats_against_jax(name):
    from variantcalling_tpu.ops import math as jmath

    rng = np.random.default_rng(11)
    obs, _ = _counts(9, 4_000)
    eps = float(np.finfo(np.float32).eps)
    if name == "correct_multinomial_frequencies":
        _close(tstats.correct_multinomial_frequencies(_t(obs)).numpy(),
               jstats.correct_multinomial_frequencies(jnp.asarray(obs)), atol=4 * eps)
    elif name == "scale_contingency_table":
        table = rng.integers(0, 50, (3_000, 5)).astype(np.float32)
        table[:10] = 0
        n = rng.integers(1, 500, 3_000).astype(np.float32)
        _close(tstats.scale_contingency_table(_t(table), _t(n)).numpy(),
               jstats.scale_contingency_table(jnp.asarray(table), jnp.asarray(n)))
    elif name in ("precision_from_counts", "recall_from_counts"):
        a, b = rng.integers(0, 20, 3_000).astype(np.float32), rng.integers(0, 20, 3_000).astype(np.float32)
        a[:50] = b[:50] = 0
        for fill in (1.0, 0.0, 0.25):
            _close(getattr(tstats, name)(_t(a), _t(b), fill=fill).numpy(),
                   getattr(jstats, name)(jnp.asarray(a), jnp.asarray(b), fill=fill), atol=2 * eps)
    elif name == "f1_from_pr":
        p, r = rng.random(3_000).astype(np.float32), rng.random(3_000).astype(np.float32)
        p[:20] = r[:20] = 0
        _close(tstats.f1_from_pr(_t(p), _t(r)).numpy(), jstats.f1_from_pr(jnp.asarray(p), jnp.asarray(r)),
               atol=2 * eps)
    elif name == "confusion_counts":
        call, true = rng.random(3_000) < 0.5, rng.random(3_000) < 0.4
        got = tstats.confusion_counts(_t(call), _t(true), fn_extra=7)
        want = jstats.confusion_counts(jnp.asarray(call), jnp.asarray(true), fn_extra=7)
        assert [int(v) for v in got] == [int(v) for v in want]
    elif name == "precision_recall_curve_dense":
        labels = rng.random(2_000) < 0.6
        scores = np.round(rng.random(2_000), 2).astype(np.float32)  # ties
        valid = rng.random(2_000) < 0.9
        for v in (None, valid):
            got = tstats.precision_recall_curve_dense(_t(labels), _t(scores), fn_count=13,
                                                      valid=None if v is None else _t(v))
            want = jstats.precision_recall_curve_dense(jnp.asarray(labels), jnp.asarray(scores), fn_count=13,
                                                       valid=None if v is None else jnp.asarray(v))
            assert set(got) == set(want)
            for key in ("threshold", "tp", "fp", "valid"):
                _close(got[key].numpy(), want[key])
            for key in ("precision", "recall", "f1"):
                _close(got[key].numpy(), want[key], atol=2 * eps)
    else:
        a, b = rng.random(1_000).astype(np.float32), rng.integers(0, 3, 1_000).astype(np.float32)
        _close(tstats.safe_divide(_t(a), _t(b), fill=-1.0).numpy(),
               jmath.safe_divide(jnp.asarray(a), jnp.asarray(b), fill=-1.0))


# -- the database -------------------------------------------------------------------------


def _db(seed: int, n: int, contigs=("chr1", "chr2", "chrX")) -> tuple[list, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    keys = np.unique((rng.integers(0, len(contigs), n).astype(np.int64) << 40) | rng.integers(1, 10**8, n))
    return list(contigs), keys, rng.integers(0, 5000, (len(keys), 5)).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 3_000])
def test_db_files_load_in_the_other_package(tmp_path, n):
    contigs, keys, counts = _db(3, n)
    tdb.SecDb(contigs, keys, counts, 17).save(str(tmp_path / "port.h5"))
    jdb.SecDb(contigs, keys, counts, 17).save(str(tmp_path / "jax.h5"))
    for made_by, loaded in (("port", jdb.SecDb.load(str(tmp_path / "port.h5"))),
                            ("jax", tdb.SecDb.load(str(tmp_path / "jax.h5")))):
        assert loaded.contigs == contigs and loaded.n_samples == 17, made_by
        np.testing.assert_array_equal(loaded.keys, keys)
        np.testing.assert_array_equal(np.asarray(loaded.counts).reshape(-1, 5), counts)
        assert np.asarray(loaded.keys).dtype == np.int64 and np.asarray(loaded.counts).dtype == np.float32


def test_merge_pack_and_lookup_against_jax():
    rng = np.random.default_rng(5)
    contigs = ["chr1", "chr2", "chr3"]
    per_sample = []
    for _ in range(5):
        n = int(rng.integers(0, 400))
        chrom = rng.choice(contigs, n).astype(object)
        pos = rng.integers(1, 2_000, n)
        k = jdb.pack_keys(contigs, chrom, pos)
        np.testing.assert_array_equal(tdb.pack_keys(contigs, chrom, pos), k)
        c = rng.integers(0, 60, (n, 5)).astype(np.float32)
        order = np.argsort(k)
        per_sample.append((k[order], c[order]))  # duplicate keys within a sample included
    got, want = tdb.merge_sample_counts(contigs, per_sample), jdb.merge_sample_counts(contigs, per_sample)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.n_samples == want.n_samples and got.contigs == want.contigs
    chrom = rng.choice(["chr1", "chr2", "chr3", "chrUn"], 3_000).astype(object)
    pos = rng.integers(1, 2_000, 3_000)
    for a, b in zip(got.lookup(chrom, pos), want.lookup(chrom, pos)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        tdb.pack_keys(contigs, np.asarray(["chrUn"], dtype=object), np.asarray([5]))


def test_aggregate_on_device_is_the_exact_sum():
    rng = np.random.default_rng(2)
    dense = rng.integers(0, 1000, (7, 500, 5)).astype(np.float32)
    np.testing.assert_array_equal(tagg.aggregate_on_device(dense, torch.device("cpu")), dense.sum(axis=0))
    padded = tagg.pad_samples_to_devices(dense, 4)
    assert padded.shape == (8, 500, 5) and not padded[7:].any()
    big = np.full((2, 3, 5), 2.0 ** 23, dtype=np.float32)
    with pytest.raises(ValueError, match="2\\^24"):
        tagg.aggregate_on_device(big, torch.device("cpu"))


# -- allele counts --------------------------------------------------------------------------

_AD_RECORDS = [
    # (ALT, FORMAT, sample): missing, negative, odd text and 1 to 6 alts
    ("C", "GT:AD:DP", "0/1:12,3:15"), ("C", "GT:AD:DP", "0/1:.,3:15"), ("C", "GT:AD:DP", "0/1:12,.:15"),
    ("C", "GT:AD:DP", "0/1:.:15"), ("C", "GT:AD:DP", "0/1:-1,4:15"), ("C", "GT:AD:DP", "0/1:7,-3:15"),
    ("C,G", "GT:AD:DP", "1/2:5,3,2:10"), ("C,G,T", "GT:AD", "1/2:5,3,2,1"), ("C,G,T,CA", "GT:AD", "1/2:5,3,2,1,9"),
    ("C,G,T,CA,CT", "GT:AD", "1/2:5,3,2,1,9,4"), ("C,G,T,CA,CT,CG", "GT:AD", "1/2:1,1,1,1,1,1,7"),
    ("C", "GT", "0/1"), ("C", "GT:AD", "0/1"), ("C", "AD:GT", "12,3:0/1"), ("C", "GT:DP:AD", "0/1:15:12,3"),
    ("C", "GT:AD:AD", "0/1:12,3:4,5"), ("C", "GT:AD", "0/1:12,3,0"), ("C", "GT:AD", "0/1:007,3"),
    ("C", "GT:AD", "0/1:1.5,2"), ("C", "GT:AD", "0/1:3abc,2"), ("C", "GT:AD", "0/1:1.0.0,2"),
    ("C", "GT:AD", "0/1:+4,2"), ("C", "GT:AD", "0/1:1e1,2"), ("C", "GT:AD", "0/1:12,3x"), ("C", "GT:AD", "0/1:,3"),
    ("C", "GT:AD", "0/1:12,"), ("C", "GT:AD", "0/1:99999999,1"), ("C", "GT:AD:DP", "0/1:12,3"),
]


def _odd_vcf(path: str, n_copies: int = 3) -> None:
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1,length=100000>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]
    for k in range(n_copies):
        for i, (alt, fmt, sample) in enumerate(_AD_RECORDS):
            lines.append(f"chr1\t{1000 * k + 10 * i + 5}\t.\tA\t{alt}\t30\tPASS\t.\t{fmt}\t{sample}")
    lines.append("chr1\t99000\t.\tA\tC\t30\tPASS\t.")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("no_native", [False, True], ids=["scan", "text"])
def test_observed_allele_counts_against_jax(tmp_path, monkeypatch, no_native):
    path = str(tmp_path / "odd.vcf")
    _odd_vcf(path)
    want = jcaller.observed_allele_counts(j_read_vcf(path))
    if no_native:
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    table = t_read_vcf(path)
    assert (table.aux is None) == no_native
    got = tcaller.observed_allele_counts(table)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_the_fast_path_serves_plain_ad_and_equals_the_loop(sec_world):
    """Every cohort record with a two-value AD is read from the scan, and the
    scan's counts equal the reference's loop on the same table."""
    table = t_read_vcf(sec_world["samples"][0])
    fast = tcaller._scan_rows(table)
    two = np.asarray([t.split("\t")[1].split(":")[1].count(",") == 1 for t in table.tail])
    np.testing.assert_array_equal(fast, two)
    assert fast.mean() > 0.9
    np.testing.assert_array_equal(tcaller.observed_allele_counts(table), tcaller._counts_from_text(table, 3))
    np.testing.assert_array_equal(tcaller.observed_allele_counts(table),
                                  jcaller.observed_allele_counts(j_read_vcf(sec_world["samples"][0])))


# -- the tools ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sec_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sec_world")
    return synthetic.write_sec_world(str(d), seed=5, length=2_000_000, n_pool=1_500, n_samples=6, n_private=150,
                                     n_heldout=2_000)


@pytest.fixture(scope="module")
def jax_db(sec_world, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sec_db") / "jax.h5")
    assert jax_main(["sec_training", "--inputs", *sec_world["samples"], "--output_file", path]) == 0
    return path


def _both(tool: str, argv_jax: list[str], argv_torch: list[str]) -> None:
    assert jax_main([tool, *argv_jax]) == 0
    assert torch_main([tool, *argv_torch, "--backend", "cpu"]) == 0


def _same_db(a: str, b: str) -> None:
    x, y = jdb.SecDb.load(a), jdb.SecDb.load(b)
    assert x.contigs == y.contigs and x.n_samples == y.n_samples
    np.testing.assert_array_equal(x.keys, y.keys)
    np.testing.assert_array_equal(x.counts, y.counts)


def _duplicate_cohort(tmp_path, sec_world) -> list[str]:
    """The cohort, plus a sample whose callset repeats loci (a key counted twice within one sample)."""
    rng = np.random.default_rng(4)
    table = j_read_vcf(sec_world["samples"][0])
    pick = np.sort(rng.choice(len(table), 40, replace=False))
    recs = []
    for i in pick:
        for copy in range(2):
            recs.append({"chrom": table.chrom[i], "pos": int(table.pos[i]), "ref": table.ref[i],
                         "alts": table.alt[i].split(","), "qual": 30.0, "gt": (0, 1), "ad": (20 + copy, 3)})
    path = str(tmp_path / "dups.vcf")
    write_vcf(path, recs, {"chr20": 2_000_000})
    return [*sec_world["samples"][1:3], path]


@pytest.mark.parametrize("case", ["default", "relevant_coords", "min_samples_duplicates", "use_mesh"])
def test_sec_training_against_jax(sec_world, tmp_path, case):
    inputs = sec_world["samples"]
    extra = {"default": [], "relevant_coords": ["--relevant_coords", sec_world["pool"]],
             "min_samples_duplicates": ["--min_samples", "2"], "use_mesh": ["--use_mesh", "--min_samples", "1"]}[case]
    if case == "min_samples_duplicates":
        inputs = _duplicate_cohort(tmp_path, sec_world)
    _both("sec_training", ["--inputs", *inputs, "--output_file", str(tmp_path / "j.h5"), *extra],
          ["--inputs", *inputs, "--output_file", str(tmp_path / "t.h5"), *extra])
    _same_db(str(tmp_path / "j.h5"), str(tmp_path / "t.h5"))
    assert len(jdb.SecDb.load(str(tmp_path / "t.h5"))) > 0
    if case == "use_mesh":  # the device sum equals the host merge
        assert torch_main(["sec_training", "--inputs", *inputs, "--output_file", str(tmp_path / "m.h5"),
                           "--min_samples", "1", "--backend", "cpu"]) == 0
        _same_db(str(tmp_path / "t.h5"), str(tmp_path / "m.h5"))


@pytest.mark.parametrize("env", [{"VCTPU_RANK": "1", "VCTPU_NUM_PROCESSES": "2"}, {"VCTPU_NUM_PROCESSES": "4"}])
def test_sec_training_refuses_more_than_one_rank(sec_world, tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "t.h5"
    assert torch_main(["sec_training", "--inputs", *sec_world["samples"][:2], "--output_file", str(out),
                       "--backend", "cpu"]) == 2
    assert not out.exists()


def _read(path: str) -> bytes:
    return (gzip.open if path.endswith(".gz") else open)(path, "rb").read()


@pytest.mark.parametrize("suffix,threshold", [(".vcf", None), (".vcf.gz", None), (".vcf", "0.5")])
def test_correct_systematic_errors_against_jax(sec_world, jax_db, tmp_path, suffix, threshold):
    extra = ["--noise_ratio_threshold", threshold] if threshold else []
    j, t = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    _both("correct_systematic_errors", ["--model", jax_db, "--gvcf", sec_world["heldout"], "--output_file", j, *extra],
          ["--model", jax_db, "--gvcf", sec_world["heldout"], "--output_file", t, *extra])
    n = torch_sec_compare.differing_records(_read(t), _read(j), float(threshold or 0.1))
    print(f"{n} records differ in SEC_RATIO or FILTER within the tolerance")
    if suffix.endswith(".gz"):
        assert (tmp_path / "t.vcf.gz.tbi").exists()
    # the planted noise is corrected, the planted real variants at noise loci are not
    out = t_read_vcf(t)
    sec = np.asarray(["SEC" in str(f).split(";") for f in out.filters])
    noise, real = np.isin(out.pos, sec_world["noise_pos"]), np.isin(out.pos, sec_world["real_pool_pos"])
    if threshold is None:
        assert sec[noise].mean() >= 0.9 and sec[real].mean() <= 0.05


def _system_cohort(tmp_path, rng):
    """tests/system/test_sec.py's cohort: a low-AF artifact at chr1:500 in every sample."""
    contigs = {"chr1": 2000}
    paths = []
    for s in range(4):
        recs = [{"chrom": "chr1", "pos": 500, "ref": "A", "alts": ["G"], "qual": 15.0, "gt": (0, 1),
                 "ad": (38 + int(rng.integers(0, 5)), 3 + int(rng.integers(0, 2)))},
                {"chrom": "chr1", "pos": 800 + s * 7, "ref": "C", "alts": ["T"], "qual": 50.0, "gt": (0, 1),
                 "ad": (20, 19)}]
        p = str(tmp_path / f"s{s}.vcf")
        write_vcf(p, recs, contigs)
        paths.append(p)
    return paths, contigs


@pytest.mark.parametrize("calls,want", [
    ([{"chrom": "chr1", "pos": 500, "ref": "A", "alts": ["G"], "qual": 20.0, "gt": (0, 1), "ad": (40, 4)},
      {"chrom": "chr1", "pos": 900, "ref": "C", "alts": ["T"], "qual": 60.0, "gt": (1, 1), "ad": (1, 45)}],
     ["SEC", "PASS"]),
    ([{"chrom": "chr1", "pos": 500, "ref": "A", "alts": ["G"], "qual": 60.0, "gt": (1, 1), "ad": (2, 44)}], ["PASS"]),
], ids=["noise_locus_gets_sec", "hom_alt_at_noise_locus_stays_pass"])
def test_the_system_cases(tmp_path, calls, want):
    paths, contigs = _system_cohort(tmp_path, np.random.default_rng(0))
    db = str(tmp_path / "sec.h5")
    assert torch_main(["sec_training", "--inputs", *paths, "--output_file", db, "--min_samples", "3",
                       "--backend", "cpu"]) == 0
    assert len(tdb.SecDb.load(db)) == 1 and tdb.SecDb.load(db).n_samples == 4
    in_vcf, out_vcf, ref_vcf = (str(tmp_path / f) for f in ("calls.vcf", "out.vcf", "ref.vcf"))
    write_vcf(in_vcf, calls, contigs)
    assert torch_main(["correct_systematic_errors", "--model", db, "--gvcf", in_vcf, "--output_file", out_vcf,
                       "--backend", "cpu"]) == 0
    out = t_read_vcf(out_vcf)
    assert list(out.filters) == want
    if want[0] == "SEC":
        assert out.info_field("SEC_RATIO")[0] > 0.1
    assert jax_main(["correct_systematic_errors", "--model", db, "--gvcf", in_vcf, "--output_file", ref_vcf]) == 0
    torch_sec_compare.differing_records(_read(out_vcf), _read(ref_vcf), 0.1)


def test_sec_validation_against_jax(sec_world, jax_db, tmp_path):
    argv = ["--model", jax_db, "--sample_vcf", sec_world["heldout"], "--truth_vcf", sec_world["truth"],
            "--thresholds", "0.01", "0.1", "0.5", "1.0", "2.0", "5.0"]
    _both("sec_validation", [*argv, "--output_file", str(tmp_path / "j.csv")],
          [*argv, "--output_file", str(tmp_path / "t.csv")])
    db = tdb.SecDb.load(jax_db)
    table = t_read_vcf(sec_world["heldout"])
    hit, rows = db.lookup(table.chrom, table.pos)
    ratios = tcaller.hit_ratios(table, db, hit, rows, "cpu")
    n = torch_sec_compare.differing_sweep_rows((tmp_path / "t.csv").read_text(), (tmp_path / "j.csv").read_text(),
                                               ratios)
    print(f"{n} sweep rows differ within the tolerance")
    frame = pd.read_csv(tmp_path / "t.csv")
    assert list(frame["threshold"]) == [0.01, 0.1, 0.5, 1.0, 2.0, 5.0] and frame["suppressed"].iloc[0] > 0


def test_sec_validation_without_a_hit_writes_the_header(sec_world, tmp_path):
    empty = str(tmp_path / "empty.h5")
    jdb.SecDb(["chr20"], np.zeros(0, np.int64), np.zeros((0, 5), np.float32), 3).save(empty)
    argv = ["--model", empty, "--sample_vcf", sec_world["heldout"], "--truth_vcf", sec_world["truth"]]
    _both("sec_validation", [*argv, "--output_file", str(tmp_path / "j.csv")],
          [*argv, "--output_file", str(tmp_path / "t.csv")])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_assess_sec_concordance_against_jax(sec_world, jax_db, tmp_path):
    h5, corrected = str(tmp_path / "cmp.h5"), str(tmp_path / "cor.vcf")
    assert jax_main(["run_comparison_pipeline", "--input_prefix", sec_world["heldout"], "--gtr_vcf", sec_world["truth"],
                     "--highconf_intervals", sec_world["hcr"], "--reference", sec_world["fasta"],
                     "--output_file", h5, "--output_interval", str(tmp_path / "cmp.bed")]) == 0
    assert jax_main(["correct_systematic_errors", "--model", jax_db, "--gvcf", sec_world["heldout"],
                     "--output_file", corrected]) == 0
    argv = ["--concordance_h5", h5, "--corrected_vcf", corrected]
    _both("assess_sec_concordance", [*argv, "--output_file", str(tmp_path / "j.h5")],
          [*argv, "--output_file", str(tmp_path / "t.h5")])
    for key in ("without_sec", "with_sec", "delta"):
        want, got = j_read_hdf(str(tmp_path / "j.h5"), key=key), j_read_hdf(str(tmp_path / "t.h5"), key=key)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert j_read_hdf(str(tmp_path / "t.h5"), key="delta")["fp_removed"].sum() > 0
