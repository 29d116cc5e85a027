"""The port's genotype math against the JAX package's, on the CPU.

``ops/math`` (``phred``, ``unphred``, ``safe_divide``), ``ops/genotypes``
and ``ops/imputation``, on inputs made from seeds with numpy: the 1,000-row
integer grid ``(0, k/2, k)``, random rows for 1-3 alts with PL spans past
the 350 clamp, the underflow cases of the reference's own tests, and ties.
The port computes ``exp`` and ``log`` as XLA's CPU backend does, so the bar
``tests/torch_genotype_compare`` states is met with equality here: every
float32 value and every integer PL, GQ and GT equal. The helper itself is
held to its rules on hand-made records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_genotype_compare as cmp
from variantcalling_tpu.ops import genotypes as jg
from variantcalling_tpu.ops import imputation as ji
from variantcalling_tpu.ops import math as jm
from variantcalling_tpu_torch.ops import genotypes as tg
from variantcalling_tpu_torch.ops import imputation as ti
from variantcalling_tpu_torch.ops import math as tm


def _np(xs):
    return [np.asarray(x) for x in xs]


def test_phred_and_unphred_equal_xla_bit_for_bit():
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.uniform(0, 350, 200_000), np.arange(0, 351.0), rng.uniform(0, 2, 5_000)]).astype(np.float32)
    assert np.array_equal(tm.unphred(torch.from_numpy(q)).numpy(), np.asarray(jax.jit(jm.unphred)(q)))
    p = np.concatenate([np.exp(-rng.uniform(0, 85, 200_000)), rng.uniform(0, 1, 50_000),
                        [0.0, 1.0, 1e-37, 1.2e-38]]).astype(np.float32)
    assert np.array_equal(tm.phred(torch.from_numpy(p)).numpy(), np.asarray(jax.jit(jm.phred)(p)))


@pytest.mark.parametrize("fn", ["exp", "log"])
def test_exp_and_log_over_a_sweep_of_float32(fn):
    """Every 1,009th float32 of the domain the genotype math reaches: exp of
    [-88, 0] (denormal results flush to 0, as XLA flushes them), log of the
    normal floats up to 1."""
    bits = np.arange(0x00800000, 0x3F800000, 1009, dtype=np.int64).astype(np.int32)
    x = bits.view(np.float32)
    if fn == "exp":
        x = -x * np.float32(88.0)
        got, want = tm.exp_f32(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.exp)(x))
    else:
        got, want = tm.log_f32(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.log)(x))
    assert np.array_equal(got, want)


def test_log_edges():
    x = np.asarray([0.0, np.inf, -1.0, np.nan, 1.0], np.float32)
    got = tm.log_f32(torch.from_numpy(x)).numpy()
    assert got[0] == -np.inf and got[1] == np.inf and np.isnan(got[2]) and np.isnan(got[3]) and got[4] == 0


def test_safe_divide():
    a = np.asarray([1.0, 2.0, 0.0, 5.0], np.float32)
    b = np.asarray([0.0, 4.0, 0.0, 2.0], np.float32)
    got = tm.safe_divide(torch.from_numpy(a), torch.from_numpy(b), fill=-1.0).numpy()
    assert np.array_equal(got, np.asarray(jm.safe_divide(jnp.asarray(a), jnp.asarray(b), fill=-1.0)))


@pytest.mark.parametrize("num_alt", [0, 1, 2, 3, 5])
def test_genotype_ordering_and_index(num_alt):
    assert np.array_equal(tg.genotype_ordering(num_alt), jg.genotype_ordering(num_alt))
    assert tg.n_genotypes(num_alt) == jg.n_genotypes(num_alt)
    j, k = np.meshgrid(np.arange(num_alt + 1), np.arange(num_alt + 1))
    got = tg.genotype_index(torch.from_numpy(j), torch.from_numpy(k)).numpy()
    assert np.array_equal(got, np.asarray(jg.genotype_index(jnp.asarray(j), jnp.asarray(k))))


def _random_pls(seed: int, num_alt: int, n: int, span: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = (num_alt + 1) * (num_alt + 2) // 2
    pl = rng.integers(0, span, (n, g)).astype(np.float64)
    pl[np.arange(n), rng.integers(0, g, n)] = 0
    return pl


@pytest.mark.parametrize("num_alt", [1, 2, 3])
def test_pl_to_gq_gt_and_normalize_pl(num_alt):
    pl = _random_pls(num_alt, num_alt, 20_000, 30)  # small PLs: many ties
    g = pl.shape[1]
    valid = np.random.default_rng(0).random((len(pl), g)) < 0.9
    valid[:, :2] = True
    for v in (None, valid):
        tv = None if v is None else torch.from_numpy(v)
        jv = None if v is None else jnp.asarray(v)
        gq, gt = (x.numpy() for x in tg.pl_to_gq_gt(torch.from_numpy(pl), tv))
        jgq, jgt = _np(jg.pl_to_gq_gt(jnp.asarray(pl), jv))
        assert np.array_equal(gq, jgq) and np.array_equal(gt, jgt)
        assert np.array_equal(tg.normalize_pl(torch.from_numpy(pl + 0.5), tv).numpy(),
                              np.asarray(jg.normalize_pl(jnp.asarray(pl + 0.5), jv)))


def _haploid_equal(pl: np.ndarray, num_alt: int) -> None:
    got = [x.numpy() for x in tg.diploid_pl_to_haploid(torch.from_numpy(pl), num_alt)]
    want = _np(jg.diploid_pl_to_haploid(pl, num_alt))
    for name, a, b in zip(("PL", "GQ", "GT"), got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_haploid_on_the_integer_grid():
    """(0, k/2, k) for k < 1,000: 20 of these rows part a plain float32 torch
    version from XLA; the port's arithmetic parts none."""
    k = np.arange(1000.0)
    _haploid_equal(np.stack([np.zeros_like(k), k / 2, k], 1), 1)
    _haploid_equal(np.stack([k, k / 2, np.zeros_like(k)], 1), 1)


@pytest.mark.parametrize("num_alt,span", [(1, 2_000), (2, 2_000), (3, 2_000), (1, 40), (3, 40)])
def test_haploid_random_rows(num_alt, span):
    _haploid_equal(_random_pls(10 + num_alt, num_alt, 100_000, span), num_alt)


def test_haploid_underflow_and_ties():
    """PL spans past 350 (the reference's underflow case) and tied homozygous PLs."""
    _haploid_equal(np.asarray([[990.0, 60.0, 0.0], [0.0, 500.0, 5000.0], [0.0, 3.0, 0.0], [7.0, 0.0, 7.0]]), 1)
    _haploid_equal(np.asarray([[0.0, 10, 0, 10, 10, 0], [400.0, 3, 2000, 0, 9, 0]]), 2)
    hpl, gq, gt = (x.numpy() for x in tg.diploid_pl_to_haploid(torch.tensor([[990.0, 60.0, 0.0]]), 1))
    assert gt.tolist() == [1] and 0 < int(gq[0]) <= 10000 and np.all(np.abs(hpl) < 100000)


@pytest.mark.parametrize("num_alt", [1, 2, 3])
def test_genotype_priors(num_alt):
    rng = np.random.default_rng(num_alt)
    ds = rng.uniform(0, 2, (5_000, num_alt)).astype(np.float32)
    ds[rng.random(ds.shape) < 0.1] = np.nan
    got = ti.genotype_priors(torch.from_numpy(ds), num_alt, 0.01).numpy()
    table = jnp.asarray(jg.genotype_ordering(num_alt))
    want = np.asarray(jax.vmap(lambda d: ji.genotype_priors(d, table, 0.01))(jnp.asarray(ds)))
    assert np.array_equal(got, want)


def _imputation_equal(pl, ds, cur, num_alt, epsilon=0.01) -> None:
    got = [x.numpy() for x in ti.modify_stats_with_imp_batch(torch.from_numpy(pl), torch.from_numpy(ds),
                                                               torch.from_numpy(cur), num_alt, epsilon)]
    want = _np(ji.modify_stats_with_imp_batch(jnp.asarray(pl), jnp.asarray(ds), jnp.asarray(cur), num_alt, epsilon))
    for name, a, b in zip(("PL", "GQ", "GT index"), got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("num_alt,span,epsilon", [(1, 2_000, 0.01), (2, 2_000, 0.01), (3, 2_000, 0.01),
                                                  (1, 30, 0.01), (2, 30, 0.01), (3, 30, 0.01), (2, 400, 0.2)])
def test_imputation_random_rows(num_alt, span, epsilon):
    """Random rows; small spans make many ties (the current GT kept where its
    new PL equals the minimum), and all-missing DS rows among them."""
    rng = np.random.default_rng(100 + num_alt + span)
    n = 100_000
    pl = _random_pls(200 + num_alt + span, num_alt, n, span)
    ds = np.round(rng.uniform(0, 2, (n, num_alt)), 3)
    ds[rng.random((n, num_alt)) < 0.1] = np.nan
    cur = rng.integers(0, pl.shape[1], n).astype(np.int32)
    _imputation_equal(pl, ds, cur, num_alt, epsilon)


def test_imputation_underflow_flip_and_tie():
    """The reference's cases: spans past 380 stay finite (hom-alt stays under
    a hom dosage), a weak het flips to hom-alt, an agreeing dosage keeps a tie."""
    _imputation_equal(np.asarray([[990.0, 60.0, 0.0]]), np.asarray([[2.0]]), np.asarray([2], np.int32), 1)
    npl, _, nidx = (x.numpy() for x in ti.modify_stats_with_imp_batch(
        torch.tensor([[990.0, 60.0, 0.0], [30.0, 0.0, 5.0], [40.0, 0.0, 40.0], [60.0, 0.0, 80.0]]),
        torch.tensor([[2.0], [2.0], [1.0], [2.0]]), torch.tensor([2, 1, 1, 1], dtype=torch.int32), 1))
    assert nidx.tolist() == [2, 2, 1, 1] and np.all(np.abs(npl) < 100000) and npl[2, 1] == 0
    _imputation_equal(np.asarray([[30.0, 0.0, 5.0], [40.0, 0.0, 40.0], [0.0, 0.0, 0.0]]),
                      np.asarray([[2.0], [1.0], [np.nan]]), np.asarray([1, 1, 0], np.int32), 1)


def test_gt_to_index():
    gts = np.asarray([[0, 1], [-1, 1], [1, 1], [2, 0], [1, -1], [3, 3]])
    for a in (1, 2, 3):
        assert np.array_equal(ti.gt_to_index(gts, a), ji.gt_to_index(gts, a))


# -- the bar's helper, on hand-made records --------------------------------------------------------------------

_HEAD = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"


def _vcf(*records: str) -> bytes:
    return (_HEAD + "".join(r + "\n" for r in records)).encode()


def test_haploid_helper_admits_a_near_integer_and_refuses_the_rest(tmp_path):
    # PL (0, 30, k): the hom-alt share's phred lies within 1e-3 of an integer for k = 130
    k = next(k for k in range(2, 2000) if abs(cmp.haploid_pre_trunc(np.array([0.0, 30, k]))[1] - round(
        cmp.haploid_pre_trunc(np.array([0.0, 30, k]))[1])) <= cmp.TOL and cmp.haploid_pre_trunc(
        np.array([0.0, 30, k]))[1] >= 2)
    v = int(np.trunc(cmp.haploid_pre_trunc(np.array([0.0, 30, k]))[1]))
    src = tmp_path / "in.vcf"
    src.write_bytes(_vcf(f"chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0/0:30:0,30,{k}"))
    a = _vcf(f"chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0:{v}:0,{v}")
    b = _vcf(f"chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0:{v + 1}:0,{v + 1}")
    assert cmp.differing_haploid_records(a, b, src) == 1
    assert cmp.differing_haploid_records(a, a, src) == 0
    with pytest.raises(AssertionError):  # GQ not as the PL implies
        cmp.differing_haploid_records(a, _vcf(f"chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0:{v + 2}:0,{v + 1}"), src)
    with pytest.raises(AssertionError):  # a difference of 2
        cmp.differing_haploid_records(a, _vcf(f"chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0:{v + 2}:0,{v + 2}"), src)
    src.write_bytes(_vcf("chrX\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0/0:30:0,30,3"))
    with pytest.raises(AssertionError):  # far from an integer
        cmp.differing_haploid_records(a, b, src)


def test_imputation_helper_admits_a_near_tie_and_refuses_the_rest(tmp_path):
    src = tmp_path / "in.vcf"
    src.write_bytes(_vcf("chr1\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL:DS\t0/1:20:40,0,20:2.0"))
    pre = cmp.imputation_pre_rint(np.array([40.0, 0, 20]), np.array([2.0]))
    near_tie = abs(np.sort(pre)[1] - np.sort(pre)[0]) <= cmp.TOL
    assert not near_tie
    a = _vcf("chr1\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL:DS\t0/1:1:40,0,1:2.0")
    b = _vcf("chr1\t10\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL:DS\t1/1:1:40,1,0:2.0")
    with pytest.raises(AssertionError):  # a GT change away from any tie
        cmp.differing_imputation_records(a, b, src)
    with pytest.raises(AssertionError):  # a header line differs
        cmp.differing_imputation_records(a, a.replace(b"VCFv4.2", b"VCFv4.3"), src)
    assert cmp.differing_imputation_records(a, a, src) == 0
    cmp.same_counters(b"variant_type,pass\nsnp,1\n", b"variant_type,pass\nsnp,1\n")
    with pytest.raises(AssertionError):
        cmp.same_counters(b"variant_type,pass\nsnp,1\n", b"variant_type,pass\nsnp,2\n")
