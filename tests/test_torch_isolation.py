"""The port stands alone: no ``jax``, nothing of ``variantcalling_tpu``; no silent CPU.

- an AST scan of ``variantcalling_tpu_torch/`` and ``chip_smoke.py`` finds
  no import of either, nor of optax, orbax, pandas, h5py, pyarrow or
  matplotlib, which the card's machine does not have (the registry's pickle
  name mapping is a string), nor of scipy, whose functions the port computes
  itself, but for the HTML report's optional matplotlib, imported inside a
  ``try`` whose handler skips the figure (:data:`OPTIONAL`);
- a subprocess run of the port's CLI with ``--backend cpu`` ends with none
  of those packages in ``sys.modules`` (the report tools that draw figures:
  none but matplotlib, and none at all where matplotlib does not import);
- without a CUDA device and without ``--backend cpu`` the CLI exits 2
  with a message and writes nothing, and the API raises;
- the native host engine (``variantcalling_tpu_torch/native/``) names no
  path of ``variantcalling_tpu/`` in any source, and its build command reads
  files of the port only.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "variantcalling_tpu", "pandas", "h5py", "pyarrow", "matplotlib",
             "scipy")
#: a forbidden package a module may still import, inside a ``try`` with a handler:
#: the HTML report draws its figures where matplotlib imports and skips them elsewhere
OPTIONAL = {"variantcalling_tpu_torch/reports/html.py": ("matplotlib",)}


def _port_sources() -> list[Path]:
    files = sorted((ROOT / "variantcalling_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _guarded_imports(tree: ast.AST) -> set[int]:
    """The ids of the import nodes in the body of a ``try`` that has a handler."""
    return {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try) and t.handlers
            for stmt in t.body for n in ast.walk(stmt) if isinstance(n, (ast.Import, ast.ImportFrom))}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    optional = OPTIONAL.get(str(path.relative_to(ROOT)), ())
    guarded = _guarded_imports(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)
               and not (id(node) in guarded and n.split(".")[0] in optional)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_the_streaming_modules_are_scanned():
    """The streaming executor's modules are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "utils/faults", "utils/degrade", "parallel/pipeline", "io/identity", "io/journal", "io/chunk_cache",
        "io/bgzf", "io/vcf", "pipelines/filter_variants")} <= scanned


def test_the_training_modules_are_scanned():
    """The training slice's modules are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "models/boosting", "models/gbt_hist", "models/threshold", "models/registry", "io/hdf5", "utils/h5_utils",
        "concordance/concordance_utils", "ops/concordance", "featurize", "pipelines/train_models",
        "pipelines/training_prep")} <= scanned


def test_the_dan_training_and_evaluation_modules_are_scanned():
    """The modules of ``train_dan`` and ``evaluate_concordance`` are among the
    sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "models/dan", "models/convert", "io/checkpoint", "io/bed", "utils/stats_utils",
        "concordance/concordance_utils", "ops/concordance", "pipelines/train_dan",
        "pipelines/evaluate_concordance")} <= scanned


def test_the_coverage_and_cnv_modules_are_scanned():
    """The modules of ``coverage_analysis`` and ``cnv_calling`` are among the
    sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "io/bam", "io/cram", "io/bigwig", "io/parquet", "ops/coverage", "cnv/caller", "cnv/viterbi_cuda",
        "pipelines/coverage_analysis", "pipelines/cnv_calling", "synthetic")} <= scanned


def test_the_sec_and_comparison_modules_are_scanned():
    """The modules of the SEC tools, ``run_comparison_pipeline`` and
    ``vcfeval_flavors`` are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "ops/stats", "sec/db", "sec/caller", "sec/aggregate", "pipelines/sec/sec_training",
        "pipelines/sec/correct_systematic_errors", "pipelines/sec/sec_validation",
        "pipelines/sec/assess_sec_concordance", "comparison/matcher", "pipelines/run_comparison",
        "pipelines/vcfeval_flavors")} <= scanned


def _run_cli(args: list[str], tmp_path: Path, block: tuple[str, ...] = ()) -> subprocess.CompletedProcess:
    """The port's CLI in a subprocess; its last line the exit code and the
    forbidden modules it loaded. ``block``: packages made unimportable first."""
    code = (
        "import json, sys\n"
        f"sys.modules.update(dict.fromkeys({block!r}))\n"
        "from variantcalling_tpu_torch.__main__ import main\n"
        "rc = main(sys.argv[1:])\n"
        "print(json.dumps({'rc': rc, 'loaded': sorted(m for m, mod in sys.modules.items() "
        f"if m.split('.')[0] in {FORBIDDEN!r} and mod is not None)}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("iso")
    return synthetic.write_world(str(d), seed=1, length=30_000, n_variants=300, n_trees=4)


def _argv(w: dict, out: Path) -> list[str]:
    return ["filter_variants_pipeline", "--input_file", w["vcf"], "--model_file", w["model"],
            "--model_name", w["model_name"], "--reference_file", w["fasta"], "--output_file", str(out)]


def test_cli_cpu_run_loads_neither_jax_nor_reference(small_world, tmp_path):
    out = tmp_path / "out.vcf"
    proc = _run_cli([*_argv(small_world, out), "--backend", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "loaded": []}
    text = out.read_text()
    assert "##vctpu_engine=torch-cpu" in text and "TREE_SCORE=" in text


def test_cli_without_cuda_exits_2_and_never_falls_back(small_world, tmp_path):
    out = tmp_path / "out.vcf"
    proc = _run_cli(_argv(small_world, out), tmp_path)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["rc"] == 2
    assert "no CUDA device" in proc.stderr
    assert not out.exists()


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.utils.h5_utils import write_frames

    path = tmp_path_factory.mktemp("iso_train") / "concordance.h5"
    write_frames(str(path), synthetic.train_world(4, 400, contigs=(("chr1", 10_000), ("chr20", 5_000))))
    return str(path)


def test_training_cli_cpu_runs_load_neither_jax_nor_reference(train_world, tmp_path):
    prep = _run_cli(["training_prep_pipeline", "--input_file", train_world, "--output_prefix", "p"], tmp_path)
    train = _run_cli(["train_models_pipeline", "--input_file", train_world, "--output_file_prefix", "m",
                      "--n_trees", "2", "--tree_depth", "2", "--evaluate_concordance", "--backend", "cpu"], tmp_path)
    for proc in (prep, train):
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
    assert (tmp_path / "p.labels.h5").exists() and (tmp_path / "m.pkl").exists() and (tmp_path / "m.h5").exists()


def test_training_cli_without_cuda_exits_2_and_never_falls_back(train_world, tmp_path):
    proc = _run_cli(["train_models_pipeline", "--input_file", train_world, "--output_file_prefix", "m"], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not (tmp_path / "m.pkl").exists()


def test_dan_and_evaluation_cli_cpu_runs_load_neither_jax_nor_reference(train_world, tmp_path):
    from variantcalling_tpu_torch.utils.h5_utils import read_hdf, write_hdf

    scored = read_hdf(train_world, "chr20")  # a scored concordance frame: indel flags and a tree_score
    scored["indel"] = np.asarray(scored["is_indel"], dtype=bool)
    scored["tree_score"] = np.linspace(0, 1, len(scored))
    write_hdf(scored, str(tmp_path / "scored.h5"), "all", mode="w")
    dan = _run_cli(["train_dan", "--input_file", train_world, "--output_file_prefix", "d", "--n_steps", "3",
                    "--hidden", "8", "--embed_dim", "2", "--checkpoint_dir", "ck", "--checkpoint_every", "2",
                    "--backend", "cpu"], tmp_path)
    ev = _run_cli(["evaluate_concordance", "--input_file", "scored.h5", "--output_prefix", "e", "--output_bed",
                   "--backend", "cpu"], tmp_path)
    for proc in (dan, ev):
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
    assert (tmp_path / "d.pkl").exists() and (tmp_path / "e.h5").exists() and (tmp_path / "e_tp.bed").exists()


@pytest.mark.parametrize("tool", ["train_dan", "evaluate_concordance"])
def test_dan_and_evaluation_cli_without_cuda_exit_2(tool, train_world, tmp_path):
    out = "--output_file_prefix" if tool == "train_dan" else "--output_prefix"
    proc = _run_cli([tool, "--input_file", train_world, out, "x"], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not list(tmp_path.glob("x*"))


@pytest.fixture(scope="module")
def coverage_bam(tmp_path_factory):
    from tests import torch_worlds

    path = tmp_path_factory.mktemp("iso_cov") / "reads.bam"
    return torch_worlds.write_alignment_world(str(path), seed=3, contigs={"chr1": 5000, "chr2": 2000}, n_reads=300)


def test_coverage_and_cnv_cli_cpu_runs_load_none_of_them(coverage_bam, tmp_path):
    runs = [_run_cli(["coverage_analysis", "full_analysis", "-i", coverage_bam, "-o", "f", "--backend", "cpu"],
                     tmp_path),
            _run_cli(["coverage_analysis", "collect_coverage", "-i", coverage_bam, "-o", "c", "--backend", "cpu"],
                     tmp_path),
            _run_cli(["cnv_calling", "--input_bam", coverage_bam, "--output_bed", "x.bed", "--output_vcf", "x.vcf",
                      "--min_contig_length", "1000", "--bin_size", "100", "--backend", "cpu"], tmp_path)]
    for proc in runs:
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}
    assert {"f.w100.parquet", "f.coverage_stats.h5", "c.bedgraph.gz", "c.bw", "x.bed", "x.vcf"} <= \
        {p.name for p in tmp_path.iterdir()}


@pytest.mark.parametrize("argv", [["coverage_analysis", "full_analysis"], ["coverage_analysis", "collect_coverage"],
                                  ["cnv_calling"]], ids=["full_analysis", "collect_coverage", "cnv_calling"])
def test_coverage_and_cnv_cli_without_cuda_exit_2(coverage_bam, tmp_path, argv):
    io = ["--input_bam", coverage_bam, "--output_bed", "x.bed"] if argv[0] == "cnv_calling" else \
        ["-i", coverage_bam, "-o", "x"]
    proc = _run_cli([*argv, *io], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not list(tmp_path.glob("x*"))


def test_api_defaults_to_the_card_and_never_falls_back(small_world, monkeypatch):
    """``materialize_features`` without a device asks for the card: on a host
    without one it raises instead of running on the CPU."""
    import torch

    from variantcalling_tpu_torch import device, featurize
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hf = featurize.host_featurize(read_vcf(small_world["vcf"]), FastaReader(small_world["fasta"]))
    with pytest.raises(device.DeviceUnavailable):
        featurize.materialize_features(hf)
    from variantcalling_tpu_torch.models import boosting, threshold

    x, y = np.zeros((20, 2), np.float32), (np.arange(20) % 2).astype(np.float32)
    with pytest.raises(device.DeviceUnavailable):
        boosting.fit(x, y, cfg=boosting.BoostConfig(n_trees=1, depth=1, n_bins=4))
    with pytest.raises(device.DeviceUnavailable):
        threshold.fit_threshold_model(x, y, ["qual", "sor"], candidate_features=["qual", "sor"])
    assert featurize.materialize_features(hf, device="cpu").matrix().shape == (300, len(hf.names))


NATIVE = ROOT / "variantcalling_tpu_torch" / "native"


@pytest.mark.parametrize("path", sorted(p for p in NATIVE.rglob("*") if p.is_file() and "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_name_no_reference_path(path):
    text = path.read_text()
    assert "variantcalling_tpu/" not in text and "variantcalling_tpu." not in text
    assert "variantcalling_tpu\\" not in text


def test_native_build_reads_only_files_of_the_port(tmp_path):
    """Every file the g++ command names lies in the port's ``native/src``
    (or is the output); the sources it includes lie there too."""
    from variantcalling_tpu_torch import native

    out = tmp_path / "lib.so"
    cmd = native.build_command(out)
    files = [Path(a) for a in cmd[1:] if a.endswith((".cc", ".h", ".cpp"))]
    assert files and all(f.resolve().parent == NATIVE / "src" for f in files)
    assert all(not a.startswith(("-I", "-L", "-include")) for a in cmd), cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    for src in (NATIVE / "src").iterdir():
        for line in src.read_text().splitlines():
            if line.startswith("#include \""):
                assert (NATIVE / "src" / line.split('"')[1]).exists(), line



@pytest.fixture(scope="module")
def sec_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("iso_sec")
    return synthetic.write_sec_world(str(d), seed=3, length=1_000_000, n_pool=800, n_samples=3, n_private=60,
                                     n_heldout=1_000)


def _sec_tools(w: dict, out: str) -> list[list[str]]:
    """Each new tool's arguments, its outputs named ``out``-something."""
    return [
        ["sec_training", "--inputs", *w["samples"], "--output_file", f"{out}.db.h5", "--use_mesh"],
        ["correct_systematic_errors", "--model", f"{out}.db.h5", "--gvcf", w["heldout"], "--output_file",
         f"{out}.cor.vcf"],
        ["sec_validation", "--model", f"{out}.db.h5", "--sample_vcf", w["heldout"], "--truth_vcf", w["truth"],
         "--output_file", f"{out}.val.csv"],
        ["run_comparison_pipeline", "--input_prefix", w["heldout"], "--gtr_vcf", w["truth"], "--highconf_intervals",
         w["hcr"], "--reference", w["fasta"], "--output_file", f"{out}.cmp.h5", "--output_interval", f"{out}.cmp.bed"],
        ["assess_sec_concordance", "--concordance_h5", f"{out}.cmp.h5", "--corrected_vcf", f"{out}.cor.vcf",
         "--output_file", f"{out}.as.h5"],
        ["vcfeval_flavors", "-b", w["truth"], "-c", w["heldout"], "-t", w["fasta"], "-o", f"{out}.flavors"],
    ]


def test_sec_and_comparison_cli_cpu_runs_load_none_of_them(sec_world, tmp_path):
    for argv in _sec_tools(sec_world, "o"):
        proc = _run_cli([*argv, "--backend", "cpu"], tmp_path)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}, argv[0]
    assert {"o.db.h5", "o.cor.vcf", "o.val.csv", "o.cmp.h5", "o.cmp.bed", "o.as.h5", "o.flavors"} <= \
        {p.name for p in tmp_path.iterdir()}


@pytest.mark.parametrize("tool", ["sec_training", "correct_systematic_errors", "sec_validation",
                                  "run_comparison_pipeline", "assess_sec_concordance", "vcfeval_flavors"])
def test_sec_and_comparison_cli_without_cuda_exit_2(sec_world, tmp_path, tool):
    from variantcalling_tpu_torch.sec.db import SecDb

    SecDb(["chr20"], np.zeros(0, np.int64), np.zeros((0, 5), np.float32), 1).save(str(tmp_path / "x.db.h5"))
    (tmp_path / "x.cor.vcf").write_bytes(open(sec_world["heldout"], "rb").read())
    argv = next(a for a in _sec_tools(sec_world, "x") if a[0] == tool)
    before = {p.name for p in tmp_path.iterdir()}
    proc = _run_cli(argv, tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr
    assert {p.name for p in tmp_path.iterdir()} == before


def test_the_genotype_gvcf_and_runs_modules_are_scanned():
    """The modules of the genotype, imputation, gVCF and runs tools are among
    the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "ops/math", "ops/genotypes", "ops/imputation", "ops/runs", "joint/__init__", "joint/gvcf",
        "joint/denovo_refinement", "pipelines/imputation_stages", "pipelines/correct_genotypes_by_imputation",
        "pipelines/convert_haploid_regions", "pipelines/compress_gvcf", "pipelines/cleanup_gvcf_before_calling",
        "pipelines/gvcf_hcr", "pipelines/denovo_recalibrated_qualities", "pipelines/misc/__init__",
        "pipelines/misc/find_runs_bed")} <= scanned


@pytest.fixture(scope="module")
def genotype_worlds(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("iso_geno")
    return {"impute": synthetic.write_impute_world(str(d / "imp"), seed=3, length=1_000_000, n_records=300,
                                                   n_flips=10, chain_records=50),
            "haploid": synthetic.write_haploid_world(str(d / "hap"), seed=3, n_x=300, n_y=30),
            "gvcf": synthetic.write_gvcf_world(str(d / "gvcf"), seed=3, length=50_000, n_variants=100),
            "trio": synthetic.write_trio_world(str(d / "trio"), seed=3, length=1_000_000, n_sites=1_000,
                                               n_somatic=200),
            "runs": synthetic.write_runs_world(str(d / "runs"), seed=3, contigs=(("c1", 20_000), ("c2", 3_000)),
                                               n_runs=100, n_blocks=1)}


def _genotype_tools(w: dict) -> list[list[str]]:
    """Each new tool's arguments (the three device tools first), outputs named ``x``-something."""
    return [
        ["correct_genotypes_by_imputation", "--beagle_annotated_vcf", w["impute"]["annotated"], "--output_vcf",
         "x.imp.vcf"],
        ["convert_haploid_regions", "--input_vcf", w["haploid"]["vcf"], "--output_vcf", "x.hap.vcf",
         "--haploid_regions", "hg38_non_par"],
        ["find_runs_bed", "--reference", w["runs"]["fasta"], "--output_bed", "x.runs.bed"],
        ["compress_gvcf", "--input_path", w["gvcf"]["gvcf"], "--output_path", "x.c.g.vcf"],
        ["cleanup_gvcf_before_calling", w["gvcf"]["gvcf"], "x.k.g.vcf"],
        ["gvcf_hcr", "--gvcf", w["gvcf"]["gvcf"], "--output_bed", "x.hcr.bed"],
        ["denovo_recalibrated_qualities", w["trio"]["trio"], "x.dn.vcf", w["trio"]["maternal_json"],
         w["trio"]["paternal_json"]],
    ]


def test_genotype_gvcf_and_runs_cli_cpu_runs_load_none_of_them(genotype_worlds, tmp_path):
    """The three device tools with ``--backend cpu``, the four host tools as
    the reference runs them: none loads JAX or the reference."""
    for i, argv in enumerate(_genotype_tools(genotype_worlds)):
        proc = _run_cli([*argv, "--backend", "cpu"] if i < 3 else argv, tmp_path)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}, argv[0]
    assert {"x.imp.vcf", "x.imp_counts.csv", "x.hap.vcf", "x.runs.bed", "x.c.g.vcf", "x.k.g.vcf", "x.hcr.bed",
            "x.dn.vcf"} <= {p.name for p in tmp_path.iterdir()}


@pytest.mark.parametrize("tool", ["correct_genotypes_by_imputation", "convert_haploid_regions", "find_runs_bed"])
def test_genotype_device_tools_without_cuda_exit_2(genotype_worlds, tmp_path, tool):
    argv = next(a for a in _genotype_tools(genotype_worlds) if a[0] == tool)
    proc = _run_cli(argv, tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not list(tmp_path.glob("x*"))


@pytest.mark.parametrize("tool", ["compress_gvcf", "cleanup_gvcf_before_calling", "gvcf_hcr",
                                  "denovo_recalibrated_qualities"])
def test_host_genotype_tools_take_no_backend(genotype_worlds, tmp_path, tool):
    """The host-only tools take exactly the reference's arguments: ``--backend`` is refused."""
    argv = next(a for a in _genotype_tools(genotype_worlds) if a[0] == tool)
    proc = _run_cli([*argv, "--backend", "cpu"], tmp_path)
    assert proc.returncode == 2 and "unrecognized arguments: --backend" in proc.stderr


def test_the_report_and_fingerprinting_modules_are_scanned():
    """The modules of the report and fingerprinting tools are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "reports/__init__", "reports/html", "reports/variant_eval", "reports/no_gt_stats", "reports/signatures",
        "pipelines/run_no_gt_report", "pipelines/joint_calling_report", "pipelines/substitution_error_rate_report",
        "comparison/pileup_caller", "comparison/quick_fingerprinter", "pipelines/quick_fingerprinting",
        "pipelines/training_set_consistency_check", "synthetic_reports")} <= scanned


@pytest.fixture(scope="module")
def report_worlds(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic_reports

    d = tmp_path_factory.mktemp("iso_reports")
    report = synthetic_reports.write_report_world(str(d / "rep"), seed=3, length=500_000, n_records=400,
                                                  control_records=100, n_extra_dbsnp=100)
    fp = synthetic_reports.write_fingerprint_world(str(d / "fp"), seed=3, length=100_000, region=(40_000, 44_000),
                                                   snv_every=200)
    fp["confs"] = synthetic_reports.fingerprint_confs(fp, str(d / "fp"), formats=("bam",))
    motifs = str(d / "motifs.h5")
    synthetic_reports.write_motif_h5(motifs, 3)
    return {"report": report, "fp": fp, "motifs": motifs}


def _report_tools(w: dict) -> list[list[str]]:
    """Each new tool's arguments (the device tools first), outputs named ``x``-something."""
    r, fp = w["report"], w["fp"]
    return [
        ["run_no_gt_report", "full_analysis", "--input_file", r["case"], "--dbsnp", r["dbsnp"], "--reference",
         r["fasta"], "--output_prefix", "x_full"],
        ["run_no_gt_report", "variant_eval", "--input_file", r["case"], "--dbsnp", r["dbsnp"], "--reference",
         r["fasta"], "--output_prefix", "x_eval"],
        ["run_no_gt_report", "somatic_analysis", "--input_file", r["case"], "--reference", r["fasta"],
         "--signatures_file", r["catalog_SBS96"], "--control_vcfs", r["control1"], "--output_prefix", "x_som"],
        ["joint_calling_report", "--input_vcf", r["case"], "--h5_output", "x_joint.h5", "--html_output",
         "x_joint.html"],
        ["quick_fingerprinting", "--json_conf", fp["confs"]["qf"], "--region_str", fp["region_str"], "--out_dir",
         "x_qf"],
        ["training_set_consistency_check", "--training_json_conf", fp["confs"]["tscc"], "--region_str",
         fp["region_str"], "--out_dir", "x_tscc"],
        ["substitution_error_rate_report", "--h5_substitution_error_rate", w["motifs"], "--h5_output", "x_sub.h5",
         "--html_output", "x_sub.html"],
    ]


def test_report_and_fingerprinting_cli_cpu_runs_load_none_of_them(report_worlds, tmp_path):
    """The device tools with ``--backend cpu``, the host tool as the reference
    runs it, where matplotlib does not import (as on the card's machine): none
    loads JAX, the reference or pandas, and the figures are skipped. Where it
    imports, the two tools that draw load it and nothing else forbidden, and
    embed their figures. The fingerprinting worlds plant mismatches, so those
    two raise their error list."""
    for i, argv in enumerate(_report_tools(report_worlds)):
        proc = _run_cli([*argv, "--backend", "cpu"] if i < 6 else argv, tmp_path, block=("matplotlib",))
        if argv[0] in ("quick_fingerprinting", "training_set_consistency_check"):
            assert proc.returncode == 1 and "RuntimeError" in proc.stderr, proc.stderr
            continue
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}, argv[0]
    assert {"x_full.h5", "x_eval.h5", "x_som.h5", "x_som.SBS96.all", "x_joint.h5", "x_joint.html", "x_qf",
            "x_tscc", "x_sub.h5", "x_sub.html"} <= {p.name for p in tmp_path.iterdir()}
    assert "<img" not in (tmp_path / "x_joint.html").read_text() + (tmp_path / "x_sub.html").read_text()
    for i, html in ((3, "x_joint.html"), (6, "x_sub.html")):
        argv = _report_tools(report_worlds)[i]
        proc = _run_cli([*argv, "--backend", "cpu"] if i < 6 else argv, tmp_path)
        assert proc.returncode == 0, proc.stderr
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])["loaded"]
        assert loaded and {m.split(".")[0] for m in loaded} == {"matplotlib"}, loaded
        assert (tmp_path / html).read_text().count("<img") >= 3


@pytest.mark.parametrize("i", range(6), ids=["full_analysis", "variant_eval", "somatic_analysis",
                                             "joint_calling_report", "quick_fingerprinting",
                                             "training_set_consistency_check"])
def test_report_device_tools_without_cuda_exit_2(report_worlds, tmp_path, i):
    proc = _run_cli(_report_tools(report_worlds)[i], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not list(tmp_path.glob("x*"))


def test_substitution_report_takes_no_backend(report_worlds, tmp_path):
    proc = _run_cli([*_report_tools(report_worlds)[6], "--backend", "cpu"], tmp_path)
    assert proc.returncode == 2 and "unrecognized arguments: --backend" in proc.stderr


TOOLS_OF_PR15 = {
    "filter_variants_pipeline", "train_models_pipeline", "training_prep_pipeline", "train_dan", "evaluate_concordance",
    "coverage_analysis", "cnv_calling", "sec_training", "correct_systematic_errors", "sec_validation",
    "assess_sec_concordance", "run_comparison_pipeline", "vcfeval_flavors", "correct_genotypes_by_imputation",
    "convert_haploid_regions", "compress_gvcf", "cleanup_gvcf_before_calling", "gvcf_hcr",
    "denovo_recalibrated_qualities", "find_runs_bed", "run_no_gt_report", "joint_calling_report",
    "substitution_error_rate_report", "quick_fingerprinting", "training_set_consistency_check"}
#: the tools of the single-read SNV, MRD, LPR, bridging and methylation slice; True: a device program
#: runs (the tool takes --backend)
NEW_TOOLS = {"srsnv_training": True, "srsnv_inference": True, "mrd_analysis": True,
             "train_lib_prep_recalibration_model": True, "filter_vcf_with_lib_prep_recalibration_model": True,
             "calibrate_bridging_snvs": True, "concat_methyldackel_csvs": False, "process_mbias": False,
             "process_merge_context": True, "process_merge_context_no_cp_g": True, "process_per_read": True}


def test_cli_lists_25_tools(tmp_path):
    """The 25 tools of the earlier slices are listed."""
    proc = _run_cli(["--help"], tmp_path)
    tools = [ln.strip() for ln in proc.stdout.splitlines() if ln.startswith("  ")]
    assert len(TOOLS_OF_PR15) == 25 and TOOLS_OF_PR15 <= set(tools)


def test_cli_lists_36_tools(tmp_path):
    """The 36 tools of the slices up to the single-read SNV one are listed."""
    proc = _run_cli(["--help"], tmp_path)
    tools = [ln.strip() for ln in proc.stdout.splitlines() if ln.startswith("  ")]
    assert len(TOOLS_OF_PR15 | set(NEW_TOOLS)) == 36 and TOOLS_OF_PR15 | set(NEW_TOOLS) <= set(tools)


def test_cli_lists_37_tools(tmp_path):
    """The 37 tools of the slices up to the serving daemon are listed."""
    proc = _run_cli(["--help"], tmp_path)
    tools = [ln.strip() for ln in proc.stdout.splitlines() if ln.startswith("  ")]
    earlier = TOOLS_OF_PR15 | set(NEW_TOOLS) | {"serve"}
    assert len(earlier) == 37 and earlier <= set(tools)


#: the telemetry and somatic slice's tools; True: a device program runs (the tool takes --backend)
TELEMETRY_TOOLS = {"knobs": False, "obs": False, "run_somatic_comparison_and_graphs": True,
                   "detailed_var_report": True}


def test_cli_lists_41_tools(tmp_path):
    proc = _run_cli(["--help"], tmp_path)
    tools = [ln.strip() for ln in proc.stdout.splitlines() if ln.startswith("  ")]
    assert len(tools) == 41 and set(tools) == TOOLS_OF_PR15 | set(NEW_TOOLS) | {"serve"} | set(TELEMETRY_TOOLS)


def test_the_featuremap_mrd_lpr_bridging_and_methylation_modules_are_scanned():
    """The 13 modules of the slice (and its world writer) are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "io/featuremap", "pipelines/srsnv/srsnv_training", "pipelines/srsnv/srsnv_inference",
        "pipelines/mrd_analysis", "pipelines/lpr/train_lib_prep_recalibration_model",
        "pipelines/lpr/filter_vcf_with_lib_prep_recalibration_model", "pipelines/calibrate_bridging_snvs",
        "methyl", "pipelines/methylation/concat_methyldackel_csvs", "pipelines/methylation/process_mbias",
        "pipelines/methylation/process_merge_context", "pipelines/methylation/process_merge_context_no_cp_g",
        "pipelines/methylation/process_per_read", "utils/frame_ops", "synthetic_featuremap")} <= scanned


def _parser_options(run, argv=("--help",)) -> set[str]:
    """The option strings of the parser ``run`` builds, caught at its ``parse_args``."""
    import argparse

    seen = []
    real = argparse.ArgumentParser.parse_args

    def catch(self, *args, **kwargs):
        seen.append(self)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(SystemExit):
            run(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return {o for a in seen[0]._actions for o in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("tool", list(NEW_TOOLS))
def test_new_tools_take_the_reference_options(tool):
    """Each tool's options are the reference parser's, plus ``--backend`` where a device program runs."""
    import importlib

    from variantcalling_tpu.__main__ import TOOLS as JTOOLS
    from variantcalling_tpu_torch.__main__ import TOOLS

    assert TOOLS[tool].replace("variantcalling_tpu_torch.", "variantcalling_tpu.") == JTOOLS[tool]  # same module name
    want = _parser_options(importlib.import_module(JTOOLS[tool]).run)
    got = _parser_options(importlib.import_module(TOOLS[tool]).run)
    assert got == want | ({"--backend"} if NEW_TOOLS[tool] else set())


@pytest.fixture(scope="module")
def slice_worlds(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic_featuremap as sfm

    d = tmp_path_factory.mktemp("iso_slice")
    fm = sfm.write_featuremap_world(str(d / "fm"), seed=2, length=200_000, n_tp=300, n_fp=300, n_cfdna=400,
                                    n_signature=40, tumor_fraction=0.05, n_lpr_loci=60, lpr_reads=800, n_calls=200)
    br = sfm.write_bridging_world(str(d / "br"), seed=2, length=200_000, n_records=400, n_rescue=10, n_tandem=5,
                                  n_high_normal=5)
    me = sfm.write_methyl_world(str(d / "me"), seed=2, length=200_000, n_cpg_sites=2_000, n_shards=2, n_chh=2_000,
                                n_reads=2_000, n_alt_rows=5)
    return {"fm": fm, "br": br, "me": me}


def _slice_tools(w: dict) -> list[list[str]]:
    """Each tool of the slice, in an order whose outputs feed the next (``x``-something)."""
    fm, br, me = w["fm"], w["br"], w["me"]
    return [
        ["srsnv_training", "--tp_featuremap", fm["tp"], "--fp_featuremap", fm["fp"], "--output_model", "x_m.pkl",
         "--n_trees", "3", "--max_depth", "3"],
        ["srsnv_inference", "--featuremap", fm["cfdna"], "--model", "x_m.pkl", "--output_featuremap", "x_s.vcf"],
        ["mrd_analysis", "--signature_vcf", fm["signature"], "--featuremap", "x_s.vcf", "--coverage_per_locus", "30",
         "--output_h5", "x_mrd.h5"],
        ["train_lib_prep_recalibration_model", "--out_dir", "x_lpr", "--ref_fasta", fm["fasta"], "--featuremap_vcf",
         fm["lpr_featuremap"], "--calls_vcf", fm["lpr_calls"], "--n_trees", "3", "--depth", "3"],
        ["filter_vcf_with_lib_prep_recalibration_model", "--out_dir", "x_lpr", "--ref_fasta", fm["fasta"],
         "--lib_prep_model_file", "x_lpr/lib_prep_model.npz", "--calls_vcf", fm["lpr_calls"], "--featuremap_vcf",
         fm["lpr_featuremap"]],
        ["calibrate_bridging_snvs", "--vcf", br["vcf"], "--reference", br["fasta"], "--output", "x_br.vcf"],
        ["process_merge_context", "--input", me["cpg"], "--output", "x_mc.h5", "--merged_bedgraph", "x_mc.bg"],
        ["process_merge_context_no_cp_g", "--input", me["chh"], "--output", "x_chh.h5"],
        ["process_per_read", "--input", me["per_read"], "--output", "x_pr.h5"],
        ["concat_methyldackel_csvs", "--inputs", *me["shards"], "--output", "x_cat.csv"],
        ["process_mbias", "--input", me["mbias"], "--output", "x_mb.h5"],
    ]


def test_slice_cli_cpu_runs_load_none_of_them(slice_worlds, tmp_path):
    """The eleven tools one after the other in one process (the device tools
    with ``--backend cpu``): each exits 0 and, at the end, none of the
    forbidden packages is loaded."""
    steps = [[*argv, "--backend", "cpu"] if NEW_TOOLS[argv[0]] else argv for argv in _slice_tools(slice_worlds)]
    code = (
        "import json, sys\n"
        "from variantcalling_tpu_torch.__main__ import main\n"
        f"rcs = [main(a) for a in {steps!r}]\n"
        "print(json.dumps({'rc': rcs, 'loaded': sorted(m for m, mod in sys.modules.items() "
        f"if m.split('.')[0] in {FORBIDDEN!r} and mod is not None)}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": [0] * 11, "loaded": []}
    assert {"x_m.pkl", "x_s.vcf", "x_mrd.h5", "x_lpr", "x_br.vcf", "x_mc.h5", "x_mc.bg", "x_chh.h5", "x_pr.h5",
            "x_cat.csv", "x_mb.h5"} <= {p.name for p in tmp_path.iterdir()}


@pytest.mark.parametrize("tool", [t for t in NEW_TOOLS if NEW_TOOLS[t]])
def test_slice_device_tools_without_cuda_exit_2(slice_worlds, tmp_path, tool, monkeypatch):
    """Without ``--backend cpu`` and without a card each device tool exits 2
    and writes nothing: no fallback to the CPU."""
    import importlib

    import torch

    from variantcalling_tpu_torch.__main__ import TOOLS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = next(a for a in _slice_tools(slice_worlds) if a[0] == tool)
    if argv[0] in ("srsnv_inference", "mrd_analysis", "filter_vcf_with_lib_prep_recalibration_model"):
        steps = _slice_tools(slice_worlds)
        for prep in (steps[0], steps[1], steps[3]):  # the model and the scored map they read, on the CPU
            assert importlib.import_module(TOOLS[prep[0]]).run([*prep[1:], "--backend", "cpu"]) == 0
    before = {p.name for p in tmp_path.rglob("*")}
    assert importlib.import_module(TOOLS[argv[0]]).run(argv[1:]) == 2
    assert {p.name for p in tmp_path.rglob("*")} == before


# -- the serving daemon ------------------------------------------------------------------


def test_the_serving_modules_are_scanned():
    """The daemon's modules, its scopes, its obs stream and the caches it reads
    are among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "serve/__init__", "serve/daemon", "serve/state", "serve/admission", "serve/metrics", "serve/cli",
        "obs/__init__", "obs/metrics", "obs/prom", "utils/cancellation", "utils/keyed_cache", "utils/faults",
        "knobs", "engine", "ops/coverage", "io/chunk_cache", "pipelines/filter_variants")} <= scanned


def test_serve_takes_the_reference_options():
    """``serve``'s options are the reference parser's (``variantcalling_tpu/serve/cli.py``),
    option by option; the one difference is ``--backend``'s choices, ``gpu|cpu``
    (default ``gpu``) in place of ``tpu|cpu`` (default ``cpu``)."""
    from variantcalling_tpu.__main__ import TOOLS as JTOOLS
    from variantcalling_tpu.serve import cli as jcli
    from variantcalling_tpu_torch.__main__ import TOOLS
    from variantcalling_tpu_torch.serve import cli as tcli

    assert TOOLS["serve"].replace("variantcalling_tpu_torch.", "variantcalling_tpu.") == JTOOLS["serve"]
    assert _parser_options(tcli.run) == _parser_options(jcli.run)

    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type, a.const)
                for a in parser._actions if a.dest != "help"}

    got, want = actions(tcli.get_parser()), actions(jcli.get_parser())
    assert got.pop("backend") == (("--backend",), "gpu", ["gpu", "cpu"], None, None, None)
    assert want.pop("backend") == (("--backend",), "cpu", ["tpu", "cpu"], None, None, None)
    assert got == want


def test_serve_cpu_daemon_loads_neither_jax_nor_reference(small_world, tmp_path):
    """A daemon on the CPU started, warmed, asked to filter and drained, in a
    process of its own: none of the forbidden packages is loaded."""
    code = (
        "import json, sys, urllib.request\n"
        "from variantcalling_tpu_torch.serve import Server\n"
        "s = Server(port=0, device='cpu')\n"
        "s.start()\n"
        f"body = {{'input': {small_world['vcf']!r}, 'model': {small_world['model']!r}, "
        f"'model_name': {small_world['model_name']!r}, 'reference': {small_world['fasta']!r}, "
        f"'output': {str(tmp_path / 'served.vcf')!r}}}\n"
        "req = urllib.request.Request(s.address + '/v1/filter', data=json.dumps(body).encode())\n"
        "status = urllib.request.urlopen(req, timeout=120).status\n"
        "s.drain('test')\n"
        "print(json.dumps({'status': status, 'loaded': sorted(m for m, mod in sys.modules.items() "
        f"if m.split('.')[0] in {FORBIDDEN!r} and mod is not None)}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and not k.startswith("VCTPU_")}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"status": 200, "loaded": []}
    assert "##vctpu_engine=torch-cpu" in (tmp_path / "served.vcf").read_text()


@pytest.mark.parametrize("argv", [[], ["--backend", "gpu"]], ids=["default", "gpu"])
def test_serve_without_cuda_exits_2_and_never_falls_back(tmp_path, argv):
    proc = _run_cli(["serve", "--port", "0", "--ready-file", str(tmp_path / "ready.json"), *argv], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not (tmp_path / "ready.json").exists()


@pytest.mark.parametrize("flags", [["--fabric"], ["--fabric-backend"], ["--fabric", "--fabric-backend"],
                                   ["--fabric", "--backends", "http://127.0.0.1:1"]])
def test_serve_fabric_flags_exit_2(tmp_path, flags):
    """The fabric is not ported: its flags exit 2 with a message, before any
    device or socket is touched, and never start the plain daemon."""
    proc = _run_cli(["serve", "--backend", "cpu", "--port", "0", "--ready-file", str(tmp_path / "ready.json"),
                     *flags], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "fabric" in proc.stderr and "not ported" in proc.stderr and not (tmp_path / "ready.json").exists()


# -- the run telemetry and the somatic composites ----------------------------------------


def test_the_telemetry_and_somatic_modules_are_scanned():
    """The telemetry's modules, the two composites and the report loader are
    among the sources the scan above reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"variantcalling_tpu_torch/{m}.py" for m in (
        "obs/__init__", "obs/schema", "obs/manifest", "obs/profile", "obs/sampler", "obs/critical", "obs/export",
        "obs/cli", "obs/prom", "utils/jsonio", "utils/trace", "utils/stages", "reports/report_data_loader",
        "pipelines/run_somatic_comparison_and_graphs", "pipelines/detailed_var_report")} <= scanned


@pytest.mark.parametrize("tool", list(TELEMETRY_TOOLS))
def test_telemetry_and_somatic_tools_take_the_reference_options(tool):
    """Each tool's options are the reference parser's, plus ``--backend`` where a device program runs."""
    import importlib

    from variantcalling_tpu.__main__ import TOOLS as JTOOLS
    from variantcalling_tpu_torch.__main__ import TOOLS

    assert TOOLS[tool].replace("variantcalling_tpu_torch.", "variantcalling_tpu.") == JTOOLS[tool]
    want = _parser_options(importlib.import_module(JTOOLS[tool]).run)
    got = _parser_options(importlib.import_module(TOOLS[tool]).run)
    assert got == want | ({"--backend"} if TELEMETRY_TOOLS[tool] else set())


@pytest.fixture(scope="module")
def somatic_world(tmp_path_factory):
    from variantcalling_tpu_torch import synthetic

    d = tmp_path_factory.mktemp("iso_somatic")
    return synthetic.write_sec_world(str(d), seed=4, length=300_000, n_pool=300, n_samples=1, n_private=20,
                                     n_heldout=400)


def _somatic_tools(w: dict) -> list[list[str]]:
    return [["run_somatic_comparison_and_graphs", "--somatic_vcf", w["heldout"], "--gt_vcf", w["truth"],
             "--highconf_bed", w["hcr"], "--reference", w["fasta"], "--output_folder", "x_som",
             "--call_sample_name", "sm1", "--truth_sample_name", "HG001", "--make_plots"],
            ["detailed_var_report", "--h5_concordance_file", "x_som/somatic_comparison.h5", "--h5_output",
             "x_det.h5", "--html_output", "x_det.html"]]


def test_telemetry_and_somatic_cli_cpu_runs_load_none_of_them(small_world, somatic_world, tmp_path):
    """Where matplotlib does not import (as on the card's machine): a filter
    run with obs, the CPU sampler and the device trace on, the ``obs`` and
    ``knobs`` tools over its stream, and the two composites with ``--backend
    cpu``, in one process: each exits 0 and none of the forbidden packages is
    loaded."""
    log = str(tmp_path / "f.vcf.obs.jsonl")
    steps = [[*_argv(small_world, tmp_path / "f.vcf"), "--backend", "cpu"],
             ["obs", "summary", log], ["obs", "bottleneck", log], ["obs", "critical-path", log],
             ["obs", "export", log, "-o", str(tmp_path / "x.trace.json")], ["obs", "prom", log],
             ["knobs", "--json"]] + [[*a, "--backend", "cpu"] for a in _somatic_tools(somatic_world)]
    code = (
        "import json, sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from variantcalling_tpu_torch.__main__ import main\n"
        f"rcs = [main(a) for a in {steps!r}]\n"
        "print(json.dumps({'rc': rcs, 'loaded': sorted(m for m, mod in sys.modules.items() "
        f"if m.split('.')[0] in {FORBIDDEN!r} and mod is not None)}}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and not k.startswith("VCTPU_")}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", VCTPU_OBS="1", VCTPU_OBS_CPUPROF="1",
               VCTPU_OBS_JAXPROF="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": [0] * len(steps), "loaded": []}
    assert (tmp_path / "f.vcf.obs.jsonl.jaxprof").is_dir() and (tmp_path / "x_det.h5").exists()


@pytest.mark.parametrize("i", range(2), ids=["run_somatic_comparison_and_graphs", "detailed_var_report"])
def test_somatic_tools_without_cuda_exit_2(somatic_world, tmp_path, i):
    proc = _run_cli(_somatic_tools(somatic_world)[i], tmp_path)
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rc"] == 2
    assert "no CUDA device" in proc.stderr and not list(tmp_path.glob("x*"))
