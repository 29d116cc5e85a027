"""``correct_genotypes_by_imputation`` of the port against the JAX package's, on the CPU.

Both modes, on worlds written from a seed (``synthetic.write_impute_world``
at a small size: a beagle-annotated chr20 callset with planted flips, and a
two-contig cut for the ``--input_vcf`` stage chain with the stub of beagle
it writes), and on the reference's own hand-made records (half-missing
GTs, FORMAT without GQ, the rerun on the tool's own output). Every output
is held with ``tests/torch_genotype_compare`` (which counts differing
records and holds each to the float32 bar; the counts here are 0: the port
computes the JAX package's bits on the CPU), the counters CSV and every
stage file byte for byte.
"""

import gzip
import json
import sys
from pathlib import Path

import pytest

from tests import torch_genotype_compare as cmp
from variantcalling_tpu.pipelines import correct_genotypes_by_imputation as jtool
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.io.vcf import read_vcf
from variantcalling_tpu_torch.pipelines import correct_genotypes_by_imputation as ttool


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("impute")
    return synthetic.write_impute_world(str(d), seed=5, length=3_000_000, n_records=4_000, n_flips=150,
                                        chain_records=300)


def _both(tmp_path: Path, argv, out_name: str, chain: bool = False) -> dict:
    """Run both packages' tools; each writes under its own directory."""
    outs = {}
    for pkg, run in (("jax", jtool.run), ("torch", ttool.run)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        args = [a.replace("{d}", str(d)) for a in argv] + (["--backend", "cpu"] if pkg == "torch" else [])
        assert run(args) == 0
        outs[pkg] = d / out_name
    return outs


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_annotated_mode(world, tmp_path, suffix):
    outs = _both(tmp_path, ["--beagle_annotated_vcf", world["annotated"], "--output_vcf", "{d}/out" + suffix],
                 "out" + suffix)
    n = cmp.differing_imputation_records(outs["torch"].read_bytes(), outs["jax"].read_bytes(), world["annotated"])
    print(f"records differing from the JAX package's: {n}")
    assert n == 0
    counts = {p: (o.parent / "out_counts.csv").read_text() for p, o in outs.items()}
    cmp.same_counters(counts["torch"].encode(), counts["jax"].encode())
    changed = sum(int(line.split(",")[4]) for line in counts["torch"].splitlines()[1:])
    assert changed == world["flips"]
    if suffix == ".vcf.gz":
        assert Path(str(outs["torch"]) + ".tbi").exists()


def test_annotated_mode_stats_file_and_epsilon(world, tmp_path):
    outs = _both(tmp_path, ["--beagle_annotated_vcf", world["annotated"], "--output_vcf", "{d}/o.vcf",
                            "--epsilon", "0.2", "--stats_file", "{d}/s.csv"], "o.vcf")
    assert cmp.differing_imputation_records(outs["torch"].read_bytes(), outs["jax"].read_bytes(),
                                            world["annotated"], epsilon=0.2) == 0
    cmp.same_counters((tmp_path / "torch" / "s.csv").read_bytes(), (tmp_path / "jax" / "s.csv").read_bytes())


def test_rerun_on_own_output_changes_no_genotype(world, tmp_path):
    """A rerun on the tool's own output: the JAX package's bytes, GT0/GQ0/PL0
    replaced and not repeated, the header's new lines not repeated, and no
    genotype changed (the planted flips flipped in the first run; the
    conflicting calls' margins hold twice)."""
    first = _both(tmp_path, ["--beagle_annotated_vcf", world["annotated"], "--output_vcf", "{d}/a.vcf"], "a.vcf")
    second = {}
    for pkg, run in (("jax", jtool.run), ("torch", ttool.run)):
        out = tmp_path / pkg / "b.vcf"
        assert run(["--beagle_annotated_vcf", str(first[pkg]), "--output_vcf", str(out)]
                   + (["--backend", "cpu"] if pkg == "torch" else [])) == 0
        second[pkg] = out
    assert cmp.differing_imputation_records(second["torch"].read_bytes(), second["jax"].read_bytes(),
                                            first["torch"]) == 0
    counts = (tmp_path / "torch" / "b_counts.csv").read_text().splitlines()[1:]
    assert sum(int(line.split(",")[4]) for line in counts) == 0
    t = read_vcf(str(second["torch"]))
    fmt, _ = t.format_columns()
    assert all(f.split(":").count("GT0") <= 1 and f.split(":").count("PL0") <= 1 for f in fmt)
    assert sum(line.startswith("##FORMAT=<ID=GT0") for line in t.header.lines) == 1
    assert [ln for ln in first["torch"].read_text().splitlines() if ln.startswith("#")] == \
        [ln for ln in second["torch"].read_text().splitlines() if ln.startswith("#")]


_HEAD = (
    "##fileformat=VCFv4.2\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n'
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="g">\n'
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">\n'
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">\n'
    '##FORMAT=<ID=DS,Number=A,Type=Float,Description="ds">\n'
    "##contig=<ID=chr1,length=100000>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
)

_ROWS = [
    "chr1\t100\t.\tA\tG\t50\tPASS\t.\tGT:GQ:DP:PL:DS\t./1:30:20:30,0,60:1.0",  # half-missing: untouched
    "chr1\t200\t.\tA\tG\t50.50\tPASS\t.\tGT:GQ:DP:PL:DS\t0/1:30:20:30,0,60:2.0",
    "chr1\t300\t.\tA\tG\t50\tPASS\t.\tGT:PL:DS\t0/1:30,0,5:2.0",  # no GQ in FORMAT: written after GT
    "chr1\t400\t.\tA\tG\t50\tPASS\t.\tGT:DS:PL\t0/1:1.99:30,0,9",  # DS before PL
    "chr1\t500\t.\tA\tG,T\t50\tPASS\t.\tGT:GQ:DP:PL:DS\t1/2:10:20:90,40,60,30,0,20:1.0,.",  # a missing DS value
    "chr1\t600\t.\tA\tG\t50\tLowQual\t.\tGT:GQ:DP:PL:DS\t0/1:30:20:30,0,5:2.0",  # not PASS
    "chr1\t700\t.\tA\tG\t50\tPASS\t.\tGT:GQ:DP:PL:DS\t1:30:20:30,0:2.0",  # haploid
    "chr1\t800\t.\tA\tG\t50\tPASS\t.\tGT:GQ:DP:PL\t0/1:30:20:30,0,5",  # no DS
    "chr1\t900\t.\tA\tG\t50\tPASS\t.\tGT:GQ:DP:PL:DS\t0/1:30:20:.:2.0",  # no PL value
    "chr1\t950\t.\tAT\tA\t50\t.\t.\tGT:GQ:DP:PL:DS\t0/1:5:20:3,0,4:1.99",  # an indel, FILTER .
]


def test_reference_edge_records(tmp_path):
    src = tmp_path / "in.vcf"
    src.write_text(_HEAD + "\n".join(_ROWS) + "\n")
    outs = _both(tmp_path, ["--beagle_annotated_vcf", str(src), "--output_vcf", "{d}/o.vcf"], "o.vcf")
    assert cmp.differing_imputation_records(outs["torch"].read_bytes(), outs["jax"].read_bytes(), src) == 0
    cmp.same_counters((tmp_path / "torch" / "o_counts.csv").read_bytes(),
                      (tmp_path / "jax" / "o_counts.csv").read_bytes())
    t = read_vcf(str(outs["torch"]))
    fmt, samples = t.format_columns()
    assert samples[0, 0] == "./1:30:20:30,0,60:1.0"
    assert fmt[2] == "GT:GQ:PL:DS:GT0:GQ0:PL0"


def _chain_argv(world, single: bool) -> list[str]:
    cohort, plink = (json.loads(Path(world[k]).read_text()) for k in ("cohort_json", "plink_json"))
    maps = (["--single_chrom", "chr21", "--single_cohort_vcf", cohort["chr21"], "--single_genomic_map_plink",
             plink["chr21"]] if single else
            ["--chrom_to_cohort_vcfs_json", world["cohort_json"], "--chrom_to_plink_json", world["plink_json"]])
    return ["--input_vcf", world["chain"], *maps, "--temp_dir", "{d}/work",
            "--beagle_cmd", f"{sys.executable} {world['beagle_stub']}", "--output_vcf", "{d}/chain.vcf.gz"]


@pytest.mark.parametrize("single", [False, True], ids=["json_maps", "single_chrom"])
def test_stage_chain_with_a_stub_beagle(world, tmp_path, single):
    outs = _both(tmp_path, _chain_argv(world, single), "chain.vcf.gz")
    work = {p: tmp_path / p / "work" for p in outs}
    parts = sorted(str(p) for p in work["torch"].glob("beagle_anno.*.vcf.gz"))
    assert cmp.differing_imputation_records(outs["torch"].read_bytes(), outs["jax"].read_bytes(), parts) == 0
    cmp.same_counters((tmp_path / "torch" / "chain_counts.csv").read_bytes(),
                      (tmp_path / "jax" / "chain_counts.csv").read_bytes())
    chroms = ["chr21"] if single else ["chr20", "chr21"]
    for stage in ("subset", "high_gq", "beagle", "beagle_collapsed", "beagle_anno", "add_imp"):
        for c in chroms:
            got, want = (gzip.decompress((work[p] / f"{stage}.{c}.vcf.gz").read_bytes()) for p in ("torch", "jax"))
            assert got == want, (stage, c)
    rewritten = sum(";".join(ln.split("\t")[8:9]).count("GT0") for ln in
                    gzip.decompress(outs["torch"].read_bytes()).decode().splitlines() if not ln.startswith("#"))
    assert rewritten > 0


def test_errors_as_the_reference_raises_them(world, tmp_path):
    for run in (jtool.run, ttool.run):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            run(["--input_vcf", "x.vcf", "--beagle_annotated_vcf", "y.vcf", "--output_vcf", "o.vcf"])
        with pytest.raises(SystemExit, match="provide --beagle_annotated_vcf"):
            run(["--output_vcf", "o.vcf"])
    argv = [a.replace("{d}", str(tmp_path)) for a in _chain_argv(world, False)]
    argv[argv.index("--beagle_cmd") + 1] = "definitely_not_beagle_xyz"
    for run, extra in ((jtool.run, []), (ttool.run, ["--backend", "cpu"])):
        with pytest.raises(RuntimeError, match="beagle executable"):
            run(argv + extra)


def test_a_failing_beagle_and_its_timeout(world, tmp_path, monkeypatch):
    """A beagle that exits 1, and one that outlives ``VCTPU_SUBPROC_TIMEOUT_S``."""
    for name, body in (("fails", "import sys\nsys.stderr.write('boom')\nsys.exit(1)\n"),
                       ("sleeps", "import time\ntime.sleep(30)\n")):
        stub = tmp_path / f"{name}.py"
        stub.write_text(body)
        argv = [a.replace("{d}", str(tmp_path / name)) for a in _chain_argv(world, True)]
        argv[argv.index("--beagle_cmd") + 1] = f"{sys.executable} {stub}"
        monkeypatch.setenv("VCTPU_SUBPROC_TIMEOUT_S", "2")
        match = "beagle failed rc=1: boom" if name == "fails" else "beagle timed out after 2s"
        with pytest.raises(RuntimeError, match=match):
            ttool.run(argv + ["--backend", "cpu"])
