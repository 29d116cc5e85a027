"""The port's gVCF tools, ``convert_haploid_regions`` and ``denovo_recalibrated_qualities``
against the JAX package's, on the CPU.

Worlds written from a seed at a small size (``synthetic.write_gvcf_world``:
reference blocks, PASS and RefCall variants with six PLs, called deletions
with the uncalled blocks inside them that the cleanup drops;
``write_haploid_world``; ``write_trio_world``), the published compression
shape of the reference's test (4,438 records to 1,184), and hand-made edge
records. Each output is held to the JAX tool's bytes: exactly for
``compress_gvcf``, ``cleanup_gvcf_before_calling``, ``gvcf_hcr`` and
``denovo_recalibrated_qualities``, through ``tests/torch_genotype_compare``
for ``convert_haploid_regions`` (0 records differ: the port computes the
JAX package's bits on the CPU). ``.vcf`` and ``.vcf.gz`` (compared
inflated: both write BGZF), with the native host engine and with
``VCTPU_NO_NATIVE=1``. Also the new parts of ``io/vcf`` (``ensure_format``,
``alt_lists``, ``format_columns`` and ``join_tails``, the writer's
``tails`` and object INFO columns, ``drop_format``) against the JAX
package's writer.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest

from tests import torch_genotype_compare as cmp
from variantcalling_tpu.__main__ import TOOLS as JTOOLS
from variantcalling_tpu.io import vcf as jvcf
from variantcalling_tpu_torch import synthetic
from variantcalling_tpu_torch.__main__ import TOOLS as TTOOLS
from variantcalling_tpu_torch.io import vcf as tvcf
from variantcalling_tpu_torch.joint import gvcf as tgvcf


def _run(tool: str, pkg: str, argv: list[str]) -> None:
    import importlib

    rc = importlib.import_module((JTOOLS if pkg == "jax" else TTOOLS)[tool]).run(argv)
    assert rc in (0, None)


def _bytes(path: Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if str(path).endswith(".gz") else data


def _both(tool: str, tmp_path: Path, argv, outs: list[str], backend: bool = False) -> dict:
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        args = [a.replace("{d}", str(d)) for a in argv] + (["--backend", "cpu"] if backend and pkg == "torch" else [])
        _run(tool, pkg, args)
        got[pkg] = {o: _bytes(d / o) for o in outs}
    return got


@pytest.fixture(scope="module")
def gvcf_world(tmp_path_factory):
    return synthetic.write_gvcf_world(str(tmp_path_factory.mktemp("gvcf")), seed=7, length=400_000, n_variants=900)


@pytest.fixture(params=["native", "no_native"])
def engine(request, monkeypatch):
    if request.param == "no_native":
        monkeypatch.setenv("VCTPU_NO_NATIVE", "1")
    return request.param


def _input(world: dict, tmp_path: Path, gz: bool) -> str:
    if not gz:
        return world["gvcf"]
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter

    path = tmp_path / "in.g.vcf.gz"
    with BgzfWriter(str(path)) as out:
        out.write(Path(world["gvcf"]).read_bytes())
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["vcf", "vcf_gz"])
@pytest.mark.parametrize("thresholds", [[], ["--refcall_gq_threshold", "30", "--merge_gq_threshold", "4"]],
                         ids=["defaults", "tight"])
def test_compress_gvcf(gvcf_world, tmp_path, engine, gz, thresholds):
    out = "c.g.vcf.gz" if gz else "c.g.vcf"
    got = _both("compress_gvcf", tmp_path, ["--input_path", _input(gvcf_world, tmp_path, gz), "--output_path",
                                             "{d}/" + out, *thresholds], [out])
    assert got["torch"][out] == got["jax"][out]
    n_out = sum(1 for ln in got["torch"][out].splitlines() if not ln.startswith(b"#"))
    assert n_out < gvcf_world["n_records"] // 2


@pytest.mark.parametrize("gz", [False, True], ids=["vcf", "vcf_gz"])
def test_cleanup_gvcf_before_calling(gvcf_world, tmp_path, engine, gz):
    out = "c.g.vcf.gz" if gz else "c.g.vcf"
    got = _both("cleanup_gvcf_before_calling", tmp_path, [_input(gvcf_world, tmp_path, gz), "{d}/" + out], [out])
    assert got["torch"][out] == got["jax"][out]
    n_out = sum(1 for ln in got["torch"][out].splitlines() if not ln.startswith(b"#"))
    assert gvcf_world["n_records"] - n_out == gvcf_world["planted_drops"] > 0


@pytest.mark.parametrize("below", [False, True])
@pytest.mark.parametrize("threshold", ["20", "45"])
def test_gvcf_hcr(gvcf_world, tmp_path, engine, below, threshold):
    got = _both("gvcf_hcr", tmp_path, ["--gvcf", gvcf_world["gvcf"], "--output_bed", "{d}/h.bed", "--gq_threshold",
                                        threshold] + (["--below"] if below else []), ["h.bed"])
    assert got["torch"]["h.bed"] == got["jax"]["h.bed"] and got["torch"]["h.bed"].count(b"\n") > 10
    assert not list((tmp_path / "torch").glob("*.raw.tmp"))


def test_published_gvcf_compression_shape(tmp_path):
    """4,438 gVCF records to 1,184 (the reference's test_compress_gvcf.py:12),
    built as the JAX package's own published-goldens test builds them."""
    header = ("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=100000000>\n"
              '##INFO=<ID=END,Number=1,Type=Integer,Description="e">\n'
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n'
              '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">\n'
              '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">\n'
              '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">\n'
              '##FILTER=<ID=RefCall,Description="r">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    lines, pos, n_var = [], 100, 0
    group_sizes = [4] * 1082 + [5] * 2
    every = len(group_sizes) // 100
    for gi, size in enumerate(group_sizes):
        gq = 30 if gi % 2 == 0 else 45
        for _ in range(size):
            end = pos + 49
            lines.append(f"chr1\t{pos}\t.\tA\t<*>\t0\tRefCall\tEND={end}\tGT:GQ:DP:PL\t0/0:{gq}:25:0,{gq},{10 * gq}")
            pos = end + 1
        if gi % every == 0 and n_var < 100:
            lines.append(f"chr1\t{pos}\t.\tA\tG\t50\tPASS\t.\tGT:GQ:DP:PL\t0/1:50:30:50,0,500")
            pos += 1
            n_var += 1
    src = tmp_path / "in.g.vcf"
    src.write_text(header + "\n".join(lines) + "\n")
    got = _both("compress_gvcf", tmp_path, ["--input_path", str(src), "--output_path", "{d}/o.g.vcf"], ["o.g.vcf"])
    assert got["torch"]["o.g.vcf"] == got["jax"]["o.g.vcf"]
    assert len(lines) == 4438
    assert sum(1 for ln in got["torch"]["o.g.vcf"].splitlines() if not ln.startswith(b"#")) == 1184


_GVCF_HEAD = ("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=100000>\n"
              '##INFO=<ID=END,Number=1,Type=Integer,Description="e">\n'
              '##FILTER=<ID=RefCall,Description="r">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
_GVCF_ROWS = [
    "chr1\t100\t.\tA\t<*>\t0\t.\tEND=140\tGT:GQ:MIN_DP:PL\t0/0:30:20:0,30,300",
    "chr1\t141\t.\tACGT\tA,<*>\t45.5\tPASS\t.\tGT:GQ:DP:PL\t0/1:40:30:45,0,50,60,70,110",
    "chr1\t142\t.\tC\t<*>\t0\t.\tEND=142\tGT:GQ:MIN_DP:PL\t./.:0:0:0,0,0",
    "chr1\t143\t.\tG\tT,<*>\t3.25\tRefCall\t.\tGT:GQ:DP:PL\t./.:12:30:0,12,40,50,60,70",
    "chr1\t145\t.\tA\t<*>\t0\t.\tEND=180\tGT:GQ:MIN_DP:PL\t0/0:3:2:0,3,30",
    "chr1\t181\t.\tAT\tA,<*>\t0\tRefCall\t.\tGT:GQ:DP:PL\t0/0:25:30:0,25,40,50,60,70",
    "chr1\t183\t.\tA\t<*>\t0\t.\tEND=200\tGT:GQ:PL\t0/0:31:0,31,310",
    "chr1\t201\t.\tA\t<*>\t0\t.\tEND=230\tGT:GQ:MIN_DP:PL\t0/0:.:12:0,.,99",
    "chr1\t231\t.\tC\tT,G\t12\tLowQual\t.\tGT:GQ:DP:PL\t1/2:7:30:99,50,60,40,0,35",
    "chr1\t232\t.\tAGG\t<*>\t0\t.\tEND=240\tGT:PL\t./.:0,0,0",
    "chr1\t241\t.\tA\t<*>\t0\t.\tEND=260\tGT:GQ:MIN_DP:PL\t0/0:33:21:0,33,330",
]


def test_gvcf_tools_on_edge_records(tmp_path, engine):
    """A deletion with an uncalled block inside it and a RefCall after it,
    low-GQ RefCall records, a block without MIN_DP (DP used), GQ ``.``,
    a record without GQ, a two-alt LowQual record, a deletion-like block."""
    src = tmp_path / "in.g.vcf"
    src.write_text(_GVCF_HEAD + "\n".join(_GVCF_ROWS) + "\n")
    for tool, argv, out in (("compress_gvcf", ["--input_path", str(src), "--output_path", "{d}/c.vcf"], "c.vcf"),
                            ("cleanup_gvcf_before_calling", [str(src), "{d}/k.vcf"], "k.vcf"),
                            ("gvcf_hcr", ["--gvcf", str(src), "--output_bed", "{d}/h.bed"], "h.bed"),
                            ("gvcf_hcr", ["--gvcf", str(src), "--output_bed", "{d}/b.bed", "--below"], "b.bed")):
        got = _both(tool, tmp_path, argv, [out])
        assert got["torch"][out] == got["jax"][out], tool


@pytest.fixture(scope="module")
def haploid_world(tmp_path_factory):
    return synthetic.write_haploid_world(str(tmp_path_factory.mktemp("hap")), seed=8, n_x=4_000, n_y=400)


@pytest.mark.parametrize("regions", ["hg38_non_par", "bed"])
@pytest.mark.parametrize("gz", [False, True], ids=["vcf", "vcf_gz"])
def test_convert_haploid_regions(haploid_world, tmp_path, engine, regions, gz):
    out = "h.vcf.gz" if gz else "h.vcf"
    reg = haploid_world["bed"] if regions == "bed" else regions
    got = _both("convert_haploid_regions", tmp_path, ["--input_vcf", haploid_world["vcf"], "--output_vcf",
                                                       "{d}/" + out, "--haploid_regions", reg], [out], backend=True)
    n = cmp.differing_haploid_records(got["torch"][out], got["jax"][out], haploid_world["vcf"])
    print(f"records differing from the JAX package's: {n}")
    assert n == 0
    src = [ln for ln in Path(haploid_world["vcf"]).read_bytes().splitlines() if not ln.startswith(b"#")]
    res = [ln for ln in got["torch"][out].splitlines() if not ln.startswith(b"#")]
    changed = sum(a != b for a, b in zip(src, res))
    assert 0 < changed < len(src)  # records outside the regions keep their bytes


def test_convert_haploid_edge_records(tmp_path):
    head = ("##fileformat=VCFv4.2\n##contig=<ID=chrX,length=156040895>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\tT\n")
    rows = ["chrX\t3000000\t.\tA\tG\t34.30\tPASS\t.\tGT:GQ:PL\t0/1:40:40,0,990\t0/0:1:0,1,2",
            "chrX\t3000001\t.\tA\tG,T\t5\tPASS\t.\tGT:PL:GQ\t./.:0,5,10,990,20,30:9\t./.",
            "chrX\t3000002\t.\tA\t.\t5\tPASS\t.\tGT:GQ:PL\t0/0:3:0\t0/0",
            "chrX\t3000003\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t1:30:30,0\t.",
            "chrX\t3000004\t.\tA\tG\t5\tPASS\t.\tGT:GQ\t0/1:30\t.",
            "chrX\t3000005\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL:DP\t0|1:30:7,0,7\t.",
            "chrX\t100\t.\tA\tG\t5\tPASS\t.\tGT:GQ:PL\t0/1:30:30,0,99\t."]
    src = tmp_path / "x.vcf"
    src.write_text(head + "\n".join(rows) + "\n")
    got = _both("convert_haploid_regions", tmp_path, ["--input_vcf", str(src), "--output_vcf", "{d}/o.vcf",
                                                       "--haploid_regions", "hg38_non_par"], ["o.vcf"], backend=True)
    assert cmp.differing_haploid_records(got["torch"]["o.vcf"], got["jax"]["o.vcf"], src) == 0


@pytest.fixture(scope="module")
def trio_world(tmp_path_factory):
    return synthetic.write_trio_world(str(tmp_path_factory.mktemp("trio")), seed=9, length=2_000_000, n_sites=6_000,
                                      n_somatic=900)


@pytest.mark.parametrize("gz", [False, True], ids=["vcf", "vcf_gz"])
def test_denovo_recalibrated_qualities(trio_world, tmp_path, engine, gz):
    out = "d.vcf.gz" if gz else "d.vcf"
    w = trio_world
    got = _both("denovo_recalibrated_qualities", tmp_path, [w["trio"], "{d}/" + out, w["maternal_json"],
                                                             w["paternal_json"]], [out])
    assert got["torch"][out] == got["jax"][out]
    vals = {}
    for ln in got["torch"][out].decode().splitlines():
        f = ln.split("\t")
        if not ln.startswith("#") and "DENOVO_QUAL=" in f[7]:
            vals[int(f[1])] = float(f[7].split("DENOVO_QUAL=")[1].split(";")[0])
    assert sorted(vals) == w["denovo_pos"].tolist()
    assert [vals[p] for p in w["denovo_pos"].tolist()] == [float(f"{q:g}") for q in w["denovo_qual"]]


def test_denovo_without_overlap_raises(trio_world, tmp_path):
    empty = tmp_path / "empty.vcf"
    empty.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    maps = tmp_path / "m.json"
    maps.write_text(json.dumps({"OTHER": str(empty)}))
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="No denovo calls"):
            _run("denovo_recalibrated_qualities", pkg, [trio_world["trio"], str(tmp_path / "o.vcf"), str(maps),
                                                         str(maps)])


# -- the new parts of io/vcf ------------------------------------------------------------------------------------

_VCF = ("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n"
        "chr1\t10\trs1\tA\tG,T\t34.30\tPASS\tDP=3\tGT:GQ\t0/1:30\t1/1:20\n"
        "chr1\t20\t.\tC\t.\t.\tLowQual\t.\tGT\t0/0\t./.\n"
        "chr1\t30\t.\tG\tA\t7\tPASS\tX=1\tGT:GQ:PL\t1/1:3:30,3,0\t0/1\n")


def test_io_vcf_rewrite_against_the_jax_writer(tmp_path, engine):
    """``ensure_format``, ``alt_lists``, ``format_columns``/``join_tails``
    with a rewritten FORMAT and sample 0 through ``tails``, object INFO
    columns (a flag and a value) beside a float one, and ``qual_as_read=False``:
    the JAX package's ``write_vcf(fmt_override=, sample_overrides=,
    extra_info=)`` bytes, for ``.vcf`` and ``.vcf.gz``."""
    src = tmp_path / "in.vcf"
    src.write_text(_VCF)
    for out in ("o.vcf", "o.vcf.gz"):
        t, j = tvcf.read_vcf(str(src)), jvcf.read_vcf(str(src))
        assert t.alt_lists() == j.alt_lists()
        fmt, samples = t.format_columns()
        j.materialize_format()
        assert fmt.tolist() == list(j.fmt_keys) and samples.tolist() == j.sample_cols.tolist()
        assert tvcf.join_tails(fmt, samples).tolist() == list(t.tail)
        for h in (t.header, j.header):
            h.ensure_format("DS", "A", "Float", "Dosage")
            h.ensure_format("GT", "1", "String", "ignored: GT is there")
        fmt[0], samples[0, 0] = "GT:GQ:DS", "0/1:30:1.5"
        jf, js = np.array(j.fmt_keys, dtype=object), np.array(j.sample_cols[:, 0], dtype=object)
        jf[0], js[0] = "GT:GQ:DS", "0/1:30:1.5"
        flag = np.asarray([True, None, True], dtype=object)
        word = np.asarray(["a", None, "b"], dtype=object)
        num = np.asarray([0.5, np.nan, 2.0])
        tvcf.write_vcf(str(tmp_path / f"t{out}"), t, extra_info={"F": flag, "W": word, "N": num}, qual_as_read=False,
                       tails=tvcf.join_tails(fmt, samples))
        jvcf.write_vcf(str(tmp_path / f"j{out}"), j, extra_info={"F": flag, "W": word, "N": num}, fmt_override=jf,
                       sample_overrides={0: js})
        assert _bytes(tmp_path / f"t{out}") == _bytes(tmp_path / f"j{out}")


def test_read_vcf_drop_format(tmp_path, engine):
    src = tmp_path / "in.vcf"
    src.write_text(_VCF)
    t, j = tvcf.read_vcf(str(src), drop_format=True), jvcf.read_vcf(str(src), drop_format=True)
    assert t.chrom.tolist() == list(j.chrom) and t.pos.tolist() == list(j.pos)
    assert np.array_equal(t.qual, j.qual, equal_nan=True) and list(t.info) == list(j.info)
    assert t.aux is None and all(x == "" for x in t.tail) and (t.genotypes() == -1).all()
    assert t.header.samples == j.header.samples


def test_gvcf_helpers_against_the_jax_package(gvcf_world, engine):
    from variantcalling_tpu.joint import gvcf as jgvcf

    t, j = tvcf.read_vcf(gvcf_world["gvcf"]), jvcf.read_vcf(gvcf_world["gvcf"])
    for name in ("GQ", "DP", "MIN_DP"):
        assert np.array_equal(tgvcf.int_format_field(t, name), jgvcf._int_format_field(j, name)), name
    n_alts = np.maximum(t.n_alts(), 1)
    pl = tvcf.number_lists(t.format_field("PL"), 6, np.inf)
    assert np.array_equal(pl, j.format_numeric("PL", max_len=6, missing=np.inf))
    assert np.array_equal(tgvcf.compress_pl_to_3(pl, n_alts), jgvcf.compress_pl_to_3(pl, n_alts))
    odd = ["1,2", ".", None, "3,.,x", "", "4,5,6,7,8,9,10"]
    assert np.array_equal(tvcf.number_lists(odd, 6, -1.0), np.asarray(
        [[1, 2, -1, -1, -1, -1], [-1] * 6, [-1] * 6, [3, -1, -1, -1, -1, -1], [-1] * 6, [4, 5, 6, 7, 8, 9]], float))
