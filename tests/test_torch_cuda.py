"""The kernels on the card against their plain versions, bit for bit.

The forest kernels, and the boosted-forest fit's histogram kernel
(``gbt_hist``) at every level of a fit, with the fit on the card against
the same torch program on the CPU. Also the card's own torch programs that
must be exact or reproducible: the concordance tally (int64 counts with no
integer matrix product, which CUDA lacks) against the CPU's, and DAN
training steps twice on the card, bit for bit; and the SEC likelihood
ratio on the card against the CPU's, within its stated tolerance; the genotype
programs (haploid conversion, imputation update), the runs scan and the
report tools' programs (the eval tables' masked counts, the hmer and motif
bincounts, the float32 AF histogram, the SNV gate) on the card against the
CPU, bit for bit; the signature fit within its stated relative bar; and the
single-read SNV, MRD, LPR, bridging and methylation tools on the card
against the CPU, their files equal.

Needs a CUDA device, nvcc and the kernel's build; skips without a device.
Imports only the port (no JAX), so it runs on the machine with the card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from variantcalling_tpu_torch.models import forest as fmod
from variantcalling_tpu_torch.models import forest_cuda
from variantcalling_tpu_torch.synthetic import synthetic_forest


@pytest.mark.cuda
@pytest.mark.parametrize("depth,n_trees,dleft", [
    (3, 7, False), (7, 100, False), (9, 10, False), (7, 9, False), (7, 100, True), (9, 10, True),
    (9, 100, True),  # 100 trees of 256 leaves: over the shared memory, streamed in chunks
    (12, 10, False),  # 10 trees of 2,048 leaves (explicit wide): chunks cut inside a group of four
])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_kernel_matches_plain_version_on_card(depth, n_trees, dleft, n):
    """The wide kernel, with and without default_left (NaN inputs only with it),
    on forests resident in shared memory and on one that streams in chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(depth * 1000 + n)
    forest = synthetic_forest(rng, n_trees=n_trees, depth=depth, n_features=19)
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.WideForestKernel(forest, 19, "cuda")
    if (depth, n_trees) in ((9, 100), (12, 10)):
        assert kernel.tables.n_chunks > 1
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.LAUNCHES == before + 1
    assert torch.equal(got, kernel.plain(xt))
    assert torch.equal(got, fmod.predict_margin(forest, xt))


@pytest.mark.cuda
@pytest.mark.parametrize("depths,dleft", [((7, 14, 7), True), ((16, 9), False)])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_wide_kernel_walks_large_trees_from_device_memory(depths, dleft, n):
    """Trees past the chunk buffers (16,383 and 65,535 nodes) under an explicit
    ``wide``: global chunks, bit for bit the gather walk on the card (the
    plain version's wide encoding would take gigabytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(sum(depths) * 1000 + n)
    parts = [synthetic_forest(rng, n_trees=2, depth=d, n_features=19) for d in depths]
    m = max(pt.feature.shape[1] for pt in parts)
    arrays = {k: np.concatenate([np.pad(getattr(pt, k), ((0, 0), (0, m - pt.feature.shape[1])),
                                        constant_values=fmod.LEAF if k == "feature" else 0) for pt in parts])
              for k in ("feature", "threshold", "left", "right", "value")}
    forest = fmod.FlatForest(**arrays, max_depth=max(depths))
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.WideForestKernel(forest, 19, "cuda")
    assert kernel.tables.chunk_global.any()
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.LAUNCHES == before + 1
    assert torch.equal(got, fmod.predict_margin(forest, xt))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,n_trees,dleft", [(3, 7, False), (7, 100, False), (7, 100, True), (9, 10, True),
                                                 (11, 3, False), (11, 2, True), (1, 3, False), (12, 2, True)])
@pytest.mark.parametrize("n", [1, 513, 70_001])
def test_tree_step_kernel_matches_plain_version_on_card(depth, n_trees, dleft, n):
    """The per-tree kernel, with and without default_left (NaN inputs only with
    it), from stumps up to trees of 2,048 leaves (32 passes of 64 leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(depth * 1000 + n)
    forest = synthetic_forest(rng, n_trees=n_trees, depth=depth, n_features=19)
    x = rng.uniform(0, 50, (n, 19)).astype(np.float32)
    if dleft:
        forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
        x[rng.random(x.shape) < 0.1] = np.nan
    kernel = forest_cuda.TreeStepKernel(fmod.to_gemm(forest, 19), "cuda")
    xt = torch.from_numpy(x).cuda()
    before = forest_cuda.TREE_STEP_LAUNCHES
    got = kernel(xt)
    torch.cuda.synchronize()
    assert forest_cuda.TREE_STEP_LAUNCHES == before + 1
    assert torch.equal(got, kernel.plain(xt))
    assert torch.equal(got, fmod.predict_margin(forest, xt))


def _fit_inputs(seed: int, n: int, f: int):
    rng = np.random.default_rng(seed)
    x = rng.random((n, f)).astype(np.float32)
    x[:, -1] = np.round(x[:, -1] * 2)  # a feature of three values: skewed bins, colliding adds
    y = (3 * (x[:, 0] - 0.5) + 2 * (x[:, 1] - 0.5) + rng.normal(0, 0.5, n) > 0).astype(np.float32)
    w = np.where(y > 0.5, 2.0, 1.0).astype(np.float32)
    return x, y, w


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,n_bins,depth", [(1, 3, 8, 3), (1000, 19, 64, 6), (70_001, 20, 64, 6),
                                              (20_000, 40, 256, 5)])
def test_gbt_hist_kernel_matches_plain_version_at_every_level(n, f, n_bins, depth):
    """One tree grown on the card: at each level the kernel's int64 sums
    equal the plain version's on the same inputs (``torch.equal``), and the
    launch count grows by one a level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from variantcalling_tpu_torch.models import boosting, gbt_hist

    x, y, w = _fit_inputs(n, n, f)
    cfg = boosting.BoostConfig(n_trees=1, depth=depth, n_bins=n_bins)
    binned = torch.from_numpy(boosting.bin_features(x, boosting.quantile_bin_edges(x, n_bins))).cuda()
    g = torch.from_numpy(w * (0.5 - y)).cuda()
    h = torch.from_numpy(w * 0.25).cuda()
    levels = []

    def both(binned_, node_id, ghq, n_nodes, b):
        before = gbt_hist.LAUNCHES
        got = gbt_hist.gbt_hist(binned_, node_id, ghq, n_nodes, b)
        want = gbt_hist.hist_plain(binned_, node_id, ghq, n_nodes, b)
        torch.cuda.synchronize()
        assert gbt_hist.LAUNCHES == before + 1
        levels.append(torch.equal(got, want))
        return got

    boosting._grow_tree(binned, g, h, cfg, hist=both)
    assert levels == [True] * depth


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_on_the_card_equals_the_cpu_torch_program(weighted, monkeypatch):
    """The fit on the card against the same program on the CPU
    (``VCTPU_NATIVE_GBT=0``): features and thresholds equal, values to 1e-5,
    scores to 1e-6; 6 launches a tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from variantcalling_tpu_torch.models import boosting, gbt_hist

    monkeypatch.setenv("VCTPU_NATIVE_GBT", "0")
    x, y, w = _fit_inputs(7, 30_000, 19)
    cfg = boosting.BoostConfig(n_trees=12)
    before = gbt_hist.LAUNCHES
    gpu = boosting.fit(x, y, sample_weight=w if weighted else None, cfg=cfg, device="cuda")
    assert gbt_hist.LAUNCHES == before + 12 * 6
    cpu = boosting.fit(x, y, sample_weight=w if weighted else None, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(gpu.feature, cpu.feature)
    np.testing.assert_array_equal(gpu.threshold, cpu.threshold)
    np.testing.assert_allclose(gpu.value, cpu.value, rtol=1e-5)
    xt = torch.from_numpy(x)
    sg = fmod.finalize_margin(fmod.predict_margin(gpu, xt).numpy(), gpu)
    sc = fmod.finalize_margin(fmod.predict_margin(cpu, xt).numpy(), cpu)
    np.testing.assert_allclose(sg, sc, atol=1e-6)


@pytest.mark.cuda
def test_threshold_fit_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch.models import threshold

    x, y, w = _fit_inputs(9, 80_000, 5)
    names = ["qual", "sor", "a", "b", "c"]
    gpu = threshold.fit_threshold_model(x, y, names, candidate_features=["qual", "sor"], sample_weight=w,
                                        device="cuda")
    cpu = threshold.fit_threshold_model(x, y, names, candidate_features=["qual", "sor"], sample_weight=w,
                                        device="cpu")
    for field in ("thresholds", "signs", "scales"):
        np.testing.assert_array_equal(getattr(gpu, field), getattr(cpu, field))


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups", [(1, 8), (70_001, 8), (5_000_000, 8), (100_000, 300)])
def test_concordance_tally_on_card_equals_cpu(n, groups):
    """``grouped_confusion`` on CUDA tensors: int64 counts equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch.ops import concordance as oc

    rng = np.random.default_rng(n + groups)
    masks = torch.from_numpy(rng.random((groups, n)) < 0.4)
    tp = torch.from_numpy(rng.random(n) < 0.5)
    fp = ~tp & torch.from_numpy(rng.random(n) < 0.5)
    fn = ~tp & ~fp
    pf = torch.from_numpy(rng.random(n) < 0.9)
    got = oc.grouped_confusion(*(t.cuda() for t in (masks, tp, fp, fn, pf)))
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(), oc.grouped_confusion(masks, tp, fp, fn, pf))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dan_train_steps_on_card_are_reproducible(dtype):
    """30 ``train_step``s at ``train_dan``'s widths, twice on the card from the
    same weights and batches: bit-equal parameters, Adam state and losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch.models import dan

    cfg = dan.DanConfig(n_numeric=20, dtype=dtype)
    rng = np.random.default_rng(7)
    n = 50_000
    data = {"numeric": torch.from_numpy(rng.normal(size=(n, 20)).astype(np.float32)).cuda(),
            "motif_left": torch.from_numpy(rng.integers(0, dan.MOTIF_VOCAB, n)).cuda(),
            "motif_right": torch.from_numpy(rng.integers(0, dan.MOTIF_VOCAB, n)).cuda(),
            "label": torch.from_numpy((rng.random(n) < 0.6).astype(np.float32)).cuda(),
            "weight": torch.ones(n, device="cuda")}
    idx = torch.from_numpy(rng.integers(0, n, (30, 16_384))).cuda()
    runs = []
    for _ in range(2):
        params = dan.init_params(cfg, seed=0, device="cuda")
        state = dan.adamw_init(params)
        losses = []
        for j in range(len(idx)):
            batch = {k: v.index_select(0, idx[j]) for k, v in data.items()}
            params, state, loss = dan.train_step(cfg, params, state, batch)
            losses.append(loss)
        runs.append((params, state, torch.stack(losses)))
    (p1, s1, l1), (p2, s2, l2) = runs
    assert torch.equal(l1, l2) and int(s1.count) == int(s2.count) == 30
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.mu[k], s2.mu[k]) and torch.equal(s1.nu[k], s2.nu[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(1,), (2,), (33, 0, 4097), (64_444,), (3000,) * 24, (9000, 1, 70_001)])
@pytest.mark.parametrize("sigma", [0.35, 0.2])
def test_cnv_viterbi_kernel_matches_plain_version(lens, sigma):
    """The Viterbi kernel: one block a sequence (empty ones included, tiles
    of the backtrace cut inside a sequence), states ``torch.equal`` to the
    plain version on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from variantcalling_tpu_torch.cnv import viterbi_cuda

    rng = np.random.default_rng(sum(lens))
    obs = rng.normal(0, 0.5, sum(lens)).astype(np.float32)
    obs[rng.random(len(obs)) < 0.01] = -3.0
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    params = viterbi_cuda.hmm_params(sigma)
    x = torch.from_numpy(obs).cuda()
    before = viterbi_cuda.LAUNCHES
    got = viterbi_cuda.viterbi_states(x, offsets, params)
    torch.cuda.synchronize()
    assert viterbi_cuda.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), viterbi_cuda.viterbi_plain(x, offsets, params).cpu())
    assert torch.equal(got.cpu(), viterbi_cuda.viterbi_plain(x.cpu(), offsets, params))


@pytest.mark.cuda
def test_coverage_and_cnv_on_the_card_equal_the_cpu(tmp_path):
    """``coverage_analysis`` (both subcommands) and ``cnv_calling`` on a small
    BAM, ``--backend gpu`` against ``--backend cpu``: equal files; the CNV
    run launches the Viterbi kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hashlib

    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.cnv import viterbi_cuda
    from variantcalling_tpu_torch.pipelines import cnv_calling, coverage_analysis

    w = synthetic.write_coverage_world(str(tmp_path / "w"), seed=4, contigs=[("chr20", 1_500_000), ("chrM", 16_569)],
                                       events=((200_000, 400_000, 15), (600_000, 900_000, 45), (1_100_000, 1_150_000, 0)),
                                       n_exome=300)
    digest = {}
    for backend in ("gpu", "cpu"):
        out = tmp_path / backend
        out.mkdir()
        assert coverage_analysis.run(["full_analysis", "-i", w["bam"], "-o", str(out / "f"), "-c", w["categories"],
                                      "--backend", backend]) == 0
        assert coverage_analysis.run(["collect_coverage", "-i", w["bam"], "-o", str(out / "c.bedgraph.gz"),
                                      "--backend", backend]) == 0
        before = viterbi_cuda.LAUNCHES
        assert cnv_calling.run(["--input_bam", w["bam"], "--output_bed", str(out / "cnv.bed"), "--output_vcf",
                                str(out / "cnv.vcf"), "--reference", w["fasta"], "--backend", backend]) == 0
        assert viterbi_cuda.LAUNCHES - before == (1 if backend == "gpu" else 0)
        digest[backend] = {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(out.iterdir())
                           if not p.name.endswith((".h5", ".gz"))}
    assert digest["gpu"] == digest["cpu"] and len(digest["gpu"]) == 7
    assert (tmp_path / "gpu" / "cnv.bed").read_text().count("\n") >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4_097, 1_000_000])
def test_sec_lrt_on_the_card_equals_the_cpu(n):
    """The SEC likelihood ratio (``sec.caller.noise_likelihood_ratio``: CUDA's
    ``lgammaf``) on the card against the CPU's, within the stated relative
    tolerance; the cohort's dense sum on the card equal to numpy's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tests.torch_sec_compare import RTOL
    from variantcalling_tpu_torch.sec import aggregate, caller

    rng = np.random.default_rng(n)
    depth = rng.integers(1, 2001, n)
    obs = np.zeros((n, 5), np.float32)
    obs[:, 1] = rng.binomial(depth, rng.uniform(0, 1, n))
    obs[:, 0] = depth - obs[:, 1]
    obs[:, 2:] = rng.binomial(depth[:, None] // 10, 0.1, (n, 3))
    noise = (rng.integers(0, 200_001, (n, 5)) * (rng.random((n, 5)) < 0.8)).astype(np.float32)
    got = caller.noise_likelihood_ratio(torch.from_numpy(obs).cuda(), torch.from_numpy(noise).cuda()).cpu().numpy()
    want = caller.noise_likelihood_ratio(torch.from_numpy(obs), torch.from_numpy(noise)).numpy()
    live = want > 1e-30
    assert (np.abs(got - want)[live] / want[live]).max(initial=0) <= RTOL
    assert np.abs(got - want)[~live].max(initial=0) <= 1e-30
    dense = rng.integers(0, 3000, (9, min(n, 50_000), 5)).astype(np.float32)
    assert np.array_equal(aggregate.aggregate_on_device(dense, torch.device("cuda")), dense.sum(axis=0))


def _pls(rng: np.random.Generator, num_alt: int, n: int, span: int) -> np.ndarray:
    g = (num_alt + 1) * (num_alt + 2) // 2
    pl = rng.integers(0, span, (n, g)).astype(np.float64)
    pl[np.arange(n), rng.integers(0, g, n)] = 0
    return pl


@pytest.mark.cuda
@pytest.mark.parametrize("num_alt", [1, 2, 3])
@pytest.mark.parametrize("span", [40, 2_000])
def test_genotype_programs_on_the_card_equal_the_cpu(num_alt, span):
    """The haploid conversion and the imputation update on the card, bit for
    bit the CPU's (``ops/math`` calls no library exp or log: its float32
    steps and float64-emulated fused multiply-adds round alike on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch.ops import genotypes, imputation

    rng = np.random.default_rng(num_alt * 10 + span)
    n = 200_000
    pl = _pls(rng, num_alt, n, span)
    ds = np.round(rng.uniform(0, 2, (n, num_alt)), 3)
    ds[rng.random(ds.shape) < 0.1] = np.nan
    cur = rng.integers(0, pl.shape[1], n).astype(np.int32)
    t = [torch.from_numpy(a) for a in (pl, ds, cur)]
    for fn, args in ((genotypes.diploid_pl_to_haploid, (t[0], num_alt)),
                     (imputation.modify_stats_with_imp_batch, (*t, num_alt))):
        want = fn(*args)
        got = fn(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5_000, 3_000_000])
def test_runs_scan_on_the_card_equals_the_cpu(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch.ops import runs

    rng = np.random.default_rng(n)
    codes = np.repeat(rng.integers(0, 5, n).astype(np.uint8), rng.integers(1, 20, n))
    for min_length in (1, 10):
        got, want = runs.find_runs(codes, min_length, "cuda"), runs.find_runs(codes, min_length, "cpu")
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_records", [300, 20_000])
def test_report_programs_on_the_card_equal_the_cpu(tmp_path, n_records):
    """The eval tables' masked counts, the hmer and motif bincounts, the float32
    AF histogram and the SNV gate on the card, equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tests import torch_report_compare as rc
    from variantcalling_tpu_torch import synthetic_reports
    from variantcalling_tpu_torch.comparison.pileup_caller import call_snvs
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.reports import no_gt_stats as st
    from variantcalling_tpu_torch.reports.variant_eval import compute_eval_tables

    w = synthetic_reports.write_report_world(str(tmp_path), seed=5, length=5_000_000, n_records=n_records,
                                             control_records=10, n_extra_dbsnp=10)
    table = read_vcf(w["case"])
    known = np.random.default_rng(1).random(len(table)) < 0.4
    card, cpu = (compute_eval_tables(table, known=known, device=d) for d in ("cuda", "cpu"))
    for name in cpu:
        assert not rc.frame_problems(card[name], cpu[name], name)
    out = {}
    for d in ("cuda", "cpu"):
        cols, windows, hl, hn = st._annotate(table, w["fasta"], d)
        vt = st.variant_type_labels(cols, hl)
        out[d] = (st.insertion_deletion_statistics(table, cols, hl, hn, device=d),
                  st.snp_statistics(table, cols, windows, device=d), st.allele_freq_hist(table, vt, device=d))
    assert all(np.array_equal(out["cuda"][0][z], out["cpu"][0][z]) for z in ("homo", "hete"))
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    assert not rc.frame_problems(out["cuda"][2], out["cpu"][2], "af_hist")
    rng = np.random.default_rng(n_records)
    counts = rng.integers(0, 40, (100_000, 4)).astype(np.int32)
    refs = rng.integers(0, 5, 100_000).astype(np.int8)
    for min_af in (0.03, 0.1, 1 / 3):
        got, want = call_snvs(counts, refs, min_af, "cuda"), call_snvs(counts, refs, min_af, "cpu")
        assert all(np.array_equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_signature_fit_on_the_card_within_the_bar(seed):
    """500 float32 KL updates on the card against the CPU's, within the stated relative bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tests import torch_report_compare as rc
    from variantcalling_tpu_torch import synthetic_reports
    from variantcalling_tpu_torch.reports.signatures import fit_signatures

    for _labels, _names, cat in synthetic_reports.report_catalogs(seed).values():
        rng = np.random.default_rng(seed)
        expo = np.zeros((3, cat.shape[1]))
        for s in range(3):
            expo[s, rng.choice(cat.shape[1], 4, replace=False)] = rng.uniform(100, 20_000, 4)
        counts = rng.poisson(expo @ cat.T).astype(np.float64)
        got, want = fit_signatures(counts, cat, device="cuda"), fit_signatures(counts, cat, device="cpu")
        big = want / want.sum(axis=1, keepdims=True) >= 1e-3
        assert np.all(np.abs(got - want)[big] <= rc.EXPOSURE_RTOL * np.abs(want)[big])


def _bytes(path) -> bytes:
    import gzip

    data = open(path, "rb").read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


@pytest.mark.cuda
def test_slice_tools_on_the_card_equal_the_cpu(tmp_path, monkeypatch):
    """The single-read SNV, MRD, LPR, bridging and methylation tools on the
    card against the CPU at a small size: the card's fit against the CPU torch
    program (equal trees), scoring with one model pickle (equal bytes, on
    ``cuda-wide`` and pinned to ``gemm``), equal MRD, LPR, bridging and
    methylation outputs; the kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from variantcalling_tpu_torch import synthetic_featuremap as sfm
    from variantcalling_tpu_torch.models import gbt_hist, registry
    from variantcalling_tpu_torch.pipelines import calibrate_bridging_snvs, mrd_analysis
    from variantcalling_tpu_torch.pipelines.lpr import filter_vcf_with_lib_prep_recalibration_model as lfilter
    from variantcalling_tpu_torch.pipelines.lpr import train_lib_prep_recalibration_model as ltrain
    from variantcalling_tpu_torch.pipelines.methylation import process_merge_context, process_per_read
    from variantcalling_tpu_torch.pipelines.srsnv import srsnv_inference, srsnv_training

    fm = sfm.write_featuremap_world(str(tmp_path / "fm"), seed=3, length=500_000, n_tp=5_000, n_fp=5_000,
                                    n_cfdna=20_000, n_signature=200, tumor_fraction=2e-2, n_lpr_loci=300,
                                    lpr_reads=6_000, n_calls=2_000)
    train = ["--tp_featuremap", fm["tp"], "--fp_featuremap", fm["fp"], "--n_trees", "20", "--max_depth", "5"]
    gbt_hist.LAUNCHES = forest_cuda.LAUNCHES = 0
    assert srsnv_training.run([*train, "--output_model", str(tmp_path / "card.pkl")]) == 0
    assert gbt_hist.LAUNCHES == 20 * 5 and forest_cuda.LAUNCHES >= 1
    monkeypatch.setenv("VCTPU_NATIVE_GBT", "0")
    assert srsnv_training.run([*train, "--output_model", str(tmp_path / "cpu.pkl"), "--backend", "cpu"]) == 0
    a, b = (registry.load_model(str(tmp_path / f"{n}.pkl"), "srsnv_model") for n in ("card", "cpu"))
    assert np.array_equal(a.feature, b.feature) and np.array_equal(a.threshold, b.threshold)
    np.testing.assert_allclose(a.value, b.value, rtol=0, atol=1e-5)
    model = str(tmp_path / "card.pkl")
    outs = {}
    for label, backend, strategy in (("card", "gpu", None), ("gemm", "gpu", "gemm"), ("cpu", "cpu", None)):
        if strategy:
            monkeypatch.setenv("VCTPU_FOREST_STRATEGY", strategy)
        out = str(tmp_path / f"scored_{label}.vcf")
        assert srsnv_inference.run(["--featuremap", fm["cfdna"], "--model", model, "--output_featuremap", out,
                                    "--backend", backend]) == 0
        monkeypatch.delenv("VCTPU_FOREST_STRATEGY", raising=False)
        outs[label] = _bytes(out)
        mrd = str(tmp_path / f"mrd_{label}.h5")
        assert mrd_analysis.run(["--signature_vcf", fm["signature"], "--featuremap", out, "--coverage_per_locus",
                                 "30", "--output_h5", mrd, "--backend", backend]) == 0
        outs[f"mrd_{label}"] = open(mrd, "rb").read()
    assert outs["card"] == outs["cpu"] == outs["gemm"] and outs["mrd_card"] == outs["mrd_cpu"]
    for backend in ("gpu", "cpu"):
        d = str(tmp_path / f"lpr_{backend}")
        assert ltrain.run(["--out_dir", d, "--ref_fasta", fm["fasta"], "--featuremap_vcf", fm["lpr_featuremap"],
                           "--calls_vcf", fm["lpr_calls"], "--n_trees", "10", "--depth", "4",
                           "--backend", backend]) == 0
        assert lfilter.run(["--out_dir", d, "--ref_fasta", fm["fasta"], "--lib_prep_model_file",
                            str(tmp_path / "lpr_gpu" / "lib_prep_model.npz"), "--calls_vcf", fm["lpr_calls"],
                            "--featuremap_vcf", fm["lpr_featuremap"], "--backend", backend]) == 0
    for name in ("labeled_featuremap_training_set.parquet", "scored_alleles.parquet", "recalibrated.vcf.gz"):
        assert _bytes(tmp_path / "lpr_gpu" / name) == _bytes(tmp_path / "lpr_cpu" / name), name
    br = sfm.write_bridging_world(str(tmp_path / "br"), seed=3, length=500_000, n_records=3_000, n_rescue=30,
                                  n_tandem=10, n_high_normal=10)
    me = sfm.write_methyl_world(str(tmp_path / "me"), seed=3, length=500_000, n_cpg_sites=20_000, n_chh=20_000,
                                n_reads=20_000, n_alt_rows=10)
    for backend in ("gpu", "cpu"):
        assert calibrate_bridging_snvs.run(["--vcf", br["vcf"], "--reference", br["fasta"], "--output",
                                            str(tmp_path / f"br_{backend}.vcf"), "--backend", backend]) == 0
        assert process_merge_context.run(["--input", me["cpg"], "--output", str(tmp_path / f"mc_{backend}.h5"),
                                          "--merged_bedgraph", str(tmp_path / f"mc_{backend}.bg"),
                                          "--backend", backend]) == 0
        assert process_per_read.run(["--input", me["per_read"], "--output", str(tmp_path / f"pr_{backend}.h5"),
                                     "--backend", backend]) == 0
    for name in ("br_{}.vcf", "mc_{}.h5", "mc_{}.bg", "pr_{}.h5"):
        assert _bytes(tmp_path / name.format("gpu")) == _bytes(tmp_path / name.format("cpu")), name


@pytest.mark.cuda
def test_obs_on_filter_run_and_device_trace_on_the_card(tmp_path, monkeypatch):
    """The filter on the card with the run telemetry on (profile, CPU
    sampler, device trace): the bytes of the obs-off run, one complete trace
    a chunk, the ``cost_analysis`` event naming ``cuda-wide``, and the
    device trace's ``forest_wide`` kernel events as many as the launch
    counter counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import json
    import os

    from variantcalling_tpu_torch import obs, synthetic
    from variantcalling_tpu_torch.obs import critical, export
    from variantcalling_tpu_torch.obs import profile as obs_profile
    from variantcalling_tpu_torch.pipelines import filter_variants as tfv

    for k in [k for k in os.environ if k.startswith("VCTPU_")]:
        monkeypatch.delenv(k)
    w = synthetic.write_world(str(tmp_path / "w"), seed=44, n_variants=20_000, n_trees=20, depth=6)
    monkeypatch.setenv("VCTPU_STREAM_CHUNK_BYTES", str(256 << 10))

    def argv(out):
        return ["--input_file", w["vcf"], "--model_file", w["model"], "--model_name", w["model_name"],
                "--reference_file", w["fasta"], "--output_file", str(out), "--backend", "gpu"]

    assert tfv.run(argv(tmp_path / "off.vcf")) == 0
    for k, v in (("VCTPU_OBS", "1"), ("VCTPU_OBS_CPUPROF", "1"), ("VCTPU_OBS_JAXPROF", "1")):
        monkeypatch.setenv(k, v)
    before = forest_cuda.LAUNCHES
    assert tfv.run(argv(tmp_path / "on.vcf")) == 0
    launches = forest_cuda.LAUNCHES - before
    assert (tmp_path / "on.vcf").read_bytes() == (tmp_path / "off.vcf").read_bytes()
    log = str(tmp_path / "on.vcf.obs.jsonl")
    events = export.read_run(log)
    committed = [e for e in events if e["kind"] == "journal" and e["name"] == "committed"][-1]
    assert critical.critical_path(events)["chunks"] == committed["chunks"] == launches > 1
    (cost,) = [e for e in events if e["kind"] == "profile" and e["name"] == "cost_analysis"]
    assert cost["strategy"] == "cuda-wide" and cost["roofline_vps_h100"] > 0
    summary = obs_profile.device_trace_summary(os.path.join(log + ".jaxprof", obs.DEVICE_TRACE_FILE))
    assert sum(k for name, k in summary["kernels"].items() if "forest_wide_margin_kernel" in name) == launches
    assert 0 < summary["busy_s"] <= [e for e in events if e["kind"] == "run_end"][-1]["dur"]
    assert json.loads(open(log).readline())["topology"]["backend"] == "gpu"
