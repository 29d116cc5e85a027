"""Worlds and fixture files for the port's tests and its smoke run on the card.

- :func:`write_gatk_world`: a small world whose QUAL column is written as
  GATK writes it (two decimals, values of 10,000 and more, and ``.``), a
  CRLF copy of its callset, and a blacklist of some of its loci as ``.bed``
  and as ``.h5`` in both layouts that ``utils/h5_utils`` reads;
- :func:`write_pytables_frame`: a pandas ``to_hdf(format="fixed")`` frame
  built by hand with h5py in the layout pytables writes (the object block
  in a chunked VLArray of one pickled ndarray);
- the committed blacklists ``tests/torch_data/blacklist_{vctpu,pytables}.h5``:
  ``BLACKLIST_LOCI`` loci of the smoke run's forest-pickle world
  (``synthetic.write_world`` with seed ``BLACKLIST_WORLD_SEED`` at chr20
  scale) drawn with seed ``BLACKLIST_SEED``. Rewrite them with
  ``python -m tests.torch_worlds`` (needs h5py and pandas).

- :func:`write_training_vcf_world` and :func:`write_training_h5_world`:
  the inputs of ``training_prep_pipeline`` and ``train_models_pipeline``, a
  callset with dbSNP IDs, a blacklist, hpol runs and an annotation, and a
  labeled concordance h5 (both written by the port alone).
- the committed SV statistics pickle ``tests/torch_data/sv_stats_reference.pkl``:
  the JAX package's ``sv_stats_collect`` (pandas 3 with its Arrow strings)
  on ``synthetic_tools.write_sv_world(**SV_REFERENCE_WORLD)`` with its
  concordance h5 (:func:`write_sv_reference_pickle`; rewrite it with
  ``python -m tests.torch_worlds``);
- :func:`write_pod_world`: the rank-partitioned and elastic pods' world, a
  two-contig callset as ``.vcf``, BGZF ``.vcf.gz`` and plain single-member
  gzip, and a forest pickle saved by the JAX package that both packages load;
- :func:`write_alignment_world`: a small BAM of mixed reads (every CIGAR
  op, flags, MAPQ, mixed base qualities, several contigs) through
  ``tests/fixtures.write_bam``, and :func:`forest_bar`, the bar between two
  trained forests on a held-out callset.

h5py, pandas and the JAX package are imported only by the writers, so that
the smoke run on a machine without them can read the constants.
"""

from __future__ import annotations

import gzip
import os
import pickle
from pathlib import Path

import numpy as np

from tests import fixtures

TORCH_DATA = Path(__file__).resolve().parent / "torch_data"
BLACKLIST_WORLD_SEED = 2026  # chip_smoke.py's forest-pickle world
BLACKLIST_SEED = 606
BLACKLIST_LOCI = 300
BLACKLIST_CONTIG = "chr20"
BLACKLIST_FILES = {"vctpu": TORCH_DATA / "blacklist_vctpu.h5", "pytables": TORCH_DATA / "blacklist_pytables.h5"}


def gatk_qual_strings(rng: np.random.Generator, n: int) -> list[str]:
    """QUAL as GATK writes it: two decimals; about 10 % of the values at
    10,000 and more (a quarter of those whole, "24240.00"); 5 % missing."""
    q = np.round(rng.uniform(10, 90, n), 2)
    big = rng.random(n) < 0.10
    q[big] = np.round(rng.uniform(10_000, 30_000, int(big.sum())), 2)
    whole = big & (rng.random(n) < 0.25)
    q[whole] = np.round(q[whole])
    out = [f"{v:.2f}" for v in q]
    for i in np.flatnonzero(rng.random(n) < 0.05):
        out[i] = "."
    return out


def _set_qual(text: str, quals: list[str]) -> str:
    lines = text.split("\n")
    k = 0
    for i, ln in enumerate(lines):
        if ln and not ln.startswith("#"):
            parts = ln.split("\t")
            parts[5] = quals[k]
            lines[i] = "\t".join(parts)
            k += 1
    assert k == len(quals)
    return "\n".join(lines)


def write_pytables_frame(path: str, key: str, columns: dict[str, np.ndarray], mode: str = "a") -> None:
    """A frame in the layout of pandas ``to_hdf(format="fixed")`` through
    pytables, built with h5py: ``axis0`` the column names, ``axis1`` the row
    numbers, one block of every numeric column (values transposed), one block
    of every object column stored as one pickled (n_rows, n_items) ndarray in
    a chunked VLArray (``PSEUDOATOM``), pandas' and pytables' attributes. An
    empty frame stores (1, 1) placeholder blocks, as pandas does."""
    import h5py

    names = list(columns)
    n = len(next(iter(columns.values()))) if columns else 0
    numeric = [c for c in names if columns[c].dtype != object]
    objects = [c for c in names if columns[c].dtype == object]
    with h5py.File(path, mode) as f:
        g = f.create_group(key)
        for k, v in {"CLASS": b"GROUP", "TITLE": b"", "VERSION": b"1.0", "pandas_type": b"frame",
                     "pandas_version": b"0.15.2", "encoding": b"UTF-8", "errors": b"strict",
                     "axis0_variety": b"regular", "axis1_variety": b"regular"}.items():
            g.attrs[k] = np.bytes_(v)
        g.attrs["ndim"] = np.int64(2)
        blocks = [b for b in (numeric, objects) if b]
        g.attrs["nblocks"] = np.int64(len(blocks))

        def array(name: str, data: np.ndarray, transposed: bool = False):
            ds = g.create_dataset(name, data=data)
            for k, v in {"CLASS": b"ARRAY", "VERSION": b"2.4", "TITLE": b"", "FLAVOR": b"numpy"}.items():
                ds.attrs[k] = np.bytes_(v)
            if transposed:
                ds.attrs["transposed"] = True
            return ds

        array("axis0", np.asarray([c.encode() for c in names], dtype=f"S{max(map(len, names), default=1)}"))
        array("axis1", np.arange(n, dtype=np.int64))
        for b, items in enumerate(blocks):
            g.attrs[f"block{b}_items_variety"] = np.bytes_(b"regular")
            array(f"block{b}_items", np.asarray([c.encode() for c in items]))
            if items is numeric:
                vals = np.stack([columns[c] for c in items]) if n else np.zeros((len(items), 1))
                array(f"block{b}_values", np.ascontiguousarray(vals.T), transposed=True)
                continue
            vals = np.empty((n, len(items)) if n else (1, 1), dtype=object)
            for j, c in enumerate(items):
                if n:
                    vals[:, j] = columns[c]
            blob = np.frombuffer(pickle.dumps(vals, protocol=4), dtype=np.uint8)
            ds = g.create_dataset(f"block{b}_values", shape=(1,), maxshape=(None,), chunks=(64,),
                                  dtype=h5py.vlen_dtype(np.uint8))
            ds[0] = blob
            for k, v in {"CLASS": b"VLARRAY", "VERSION": b"1.4", "TITLE": b"", "PSEUDOATOM": b"object"}.items():
                ds.attrs[k] = np.bytes_(v)
            ds.attrs["transposed"] = True


def blacklist_columns() -> dict[str, np.ndarray]:
    """The committed blacklists' columns: the loci :data:`BLACKLIST_SEED` draws."""
    from variantcalling_tpu_torch.synthetic import blacklist_loci

    pos = blacklist_loci(BLACKLIST_WORLD_SEED, BLACKLIST_SEED, BLACKLIST_LOCI)
    chrom = np.empty(len(pos), dtype=object)
    chrom[:] = BLACKLIST_CONTIG
    return {"chrom": chrom, "pos": pos.astype(np.int64)}


def write_blacklist_fixtures(out: Path = TORCH_DATA) -> None:
    import pandas as pd

    from variantcalling_tpu.utils.h5_utils import write_hdf

    out.mkdir(parents=True, exist_ok=True)
    cols = blacklist_columns()
    for p in BLACKLIST_FILES.values():
        if p.exists():
            p.unlink()
    write_hdf(pd.DataFrame(cols), str(out / BLACKLIST_FILES["vctpu"].name), "blacklist")
    write_pytables_frame(str(out / BLACKLIST_FILES["pytables"].name), "blacklist", cols)


def write_gatk_world(d: Path, seed: int = 31) -> dict:
    """Genome ``ref.fa`` (chr1 20 kb, chr2 10 kb), 400 records with GATK-style
    QUAL in ``calls.vcf`` and ``calls.vcf.gz``, their CRLF copies
    ``calls_crlf.vcf{,.gz}``, a forest pickle ``model.pkl`` (a random forest
    and a gradient-boosted forest fitted on the reference's features) and a
    blacklist of 12 of the records as ``blacklist.bed``,
    ``blacklist_vctpu.h5`` and ``blacklist_pytables.h5``."""
    import pandas as pd
    from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier

    from variantcalling_tpu.featurize import featurize
    from variantcalling_tpu.io.fasta import FastaReader
    from variantcalling_tpu.io.vcf import read_vcf
    from variantcalling_tpu.models import registry
    from variantcalling_tpu.models.forest import from_sklearn
    from variantcalling_tpu.utils.h5_utils import write_hdf

    rng = np.random.default_rng(seed)
    contigs = {"chr1": 20000, "chr2": 10000}
    genome = fixtures.make_genome(rng, contigs)
    fixtures.write_fasta(str(d / "ref.fa"), genome)
    recs = fixtures.synth_variants(rng, genome, 400)
    for r in recs:
        r["gq"] = int(rng.integers(10, 90))
        r["ad"] = [int(rng.integers(5, 30)), int(rng.integers(1, 30))]
    fixtures.write_vcf(str(d / "plain.vcf"), recs, contigs)
    text = _set_qual((d / "plain.vcf").read_text(), gatk_qual_strings(rng, len(recs)))
    os.remove(d / "plain.vcf")
    crlf = text.replace("\n", "\r\n")
    for name, body in (("calls", text), ("calls_crlf", crlf)):
        (d / f"{name}.vcf").write_bytes(body.encode())
        (d / f"{name}.vcf.gz").write_bytes(gzip.compress(body.encode()))

    fs = featurize(read_vcf(str(d / "calls.vcf")), FastaReader(str(d / "ref.fa")))
    x = fs.matrix()
    y = (x[:, fs.feature_names.index("qual")] > 50).astype(int)
    rf = RandomForestClassifier(n_estimators=8, max_depth=5, random_state=0).fit(x, y)
    gbt = GradientBoostingClassifier(n_estimators=10, max_depth=3, random_state=0).fit(x, y)
    registry.save_models(str(d / "model.pkl"), {
        "rf_model_ignore_gt_incl_hpol_runs": from_sklearn(rf, feature_names=fs.feature_names),
        "xgb_model_ignore_gt_incl_hpol_runs": from_sklearn(gbt, feature_names=fs.feature_names),
    })

    pick = np.sort(rng.choice(len(recs), size=12, replace=False))
    chrom = np.empty(len(pick), dtype=object)
    chrom[:] = [recs[i]["chrom"] for i in pick]
    pos = np.asarray([recs[i]["pos"] for i in pick], dtype=np.int64)
    (d / "blacklist.bed").write_text("".join(f"{c}\t{p - 1}\t{p}\n" for c, p in zip(chrom, pos)))
    write_hdf(pd.DataFrame({"chrom": chrom, "pos": pos}), str(d / "blacklist_vctpu.h5"), "loci")
    write_pytables_frame(str(d / "blacklist_pytables.h5"), "loci", {"chrom": chrom, "pos": pos})
    return {"dir": d, "n_records": len(recs), "blacklisted": len(pick)}


def write_training_vcf_world(d: Path, seed: int, n_variants: int = 3000,
                             contigs=(("chr19", 150_000), ("chr20", 100_000)), **world) -> dict:
    """A ``synthetic.write_world`` callset (``ref.fa``, ``calls.vcf``) for
    approximate-GT training: 60 % of the records with a dbSNP ID, 10 % of
    the loci in ``blacklist.bed`` (some of them also in dbSNP), every 97th
    base run of ``runs.bed`` around a record, and ``LCR-test.bed`` over the
    first third of each contig. Returns the paths."""
    from variantcalling_tpu_torch import synthetic

    w = synthetic.write_world(str(d), seed, n_variants=n_variants, contigs=list(contigs), **world)
    synthetic.add_dbsnp_ids(w["vcf"], seed)
    rng = np.random.default_rng(seed)
    recs = [line.split("\t", 2)[:2] for line in Path(w["vcf"]).read_text().splitlines()
            if line and not line.startswith("#")]
    pick = np.sort(rng.choice(len(recs), size=max(1, len(recs) // 10), replace=False))
    (d / "blacklist.bed").write_text("".join(f"{recs[i][0]}\t{int(recs[i][1]) - 1}\t{recs[i][1]}\n" for i in pick))
    (d / "runs.bed").write_text("".join(f"{recs[i][0]}\t{int(recs[i][1]) - 5}\t{int(recs[i][1]) + 8}\n"
                                        for i in range(0, len(recs), 97)))
    (d / "LCR-test.bed").write_text("".join(f"{c}\t0\t{n // 3}\n" for c, n in contigs))
    return {**w, "blacklist": str(d / "blacklist.bed"), "runs": str(d / "runs.bed"),
            "annotate": str(d / "LCR-test.bed")}


def write_training_h5_world(path: Path, seed: int, n_rows: int, chr20_rows: int, mutect: bool = False) -> str:
    """``synthetic.train_world`` over chr1, chr2 and chr20 (``chr20_rows`` of
    them), with an ``exome_target`` column (a feature, for
    ``--exome_weight``) and with ``mutect`` a ``tlod`` column, one key a
    contig, written by the port's ``write_frames``."""
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.utils.h5_utils import write_frames

    contigs = (("chr1", 248_956_422), ("chr2", 242_193_529), ("chr20", 64_444_167))
    frames = synthetic.train_world(seed, n_rows, contigs=contigs, chr20_rows=chr20_rows)
    rng = np.random.default_rng(seed + 1)
    for f in frames.values():
        f.data["exome_target"] = rng.random(len(f)) < 0.3
        if mutect:
            f.data["tlod"] = rng.uniform(0, 40, len(f)).astype(np.float32)
    write_frames(str(path), frames)
    return str(path)


#: the committed pickle of the JAX package's sv_stats_collect
SV_REFERENCE_PICKLE = TORCH_DATA / "sv_stats_reference.pkl"


def write_sv_reference_pickle(path: Path = SV_REFERENCE_PICKLE, world_dir: str | None = None) -> dict:
    """The JAX package's ``sv_stats_collect`` pickle of the seeded SV world
    (``synthetic_tools.SV_REFERENCE_WORLD``, written under ``world_dir`` or a
    temporary directory) with its concordance h5. Returns the world."""
    import tempfile

    from variantcalling_tpu.pipelines import sv_stats_collect
    from variantcalling_tpu_torch import synthetic_tools

    with tempfile.TemporaryDirectory() as tmp:
        w = synthetic_tools.write_sv_world(world_dir or tmp, **synthetic_tools.SV_REFERENCE_WORLD)
        assert sv_stats_collect.run([w["vcf"], str(path), "--concordance_h5", w["concordance_h5"]]) == 0
    return w


if __name__ == "__main__":
    write_blacklist_fixtures()
    write_sv_reference_pickle()
    for p in [*BLACKLIST_FILES.values(), SV_REFERENCE_PICKLE]:
        print(p, p.stat().st_size, "bytes")


#: CIGARs of :func:`write_alignment_world`'s reads (every op the depth walk reads)
ALIGNMENT_CIGARS = ([("M", 50)], [("M", 20), ("D", 4), ("M", 30)], [("S", 5), ("M", 30), ("I", 3), ("M", 12)],
                    [("M", 10), ("N", 40), ("M", 25)], [("=", 15), ("X", 2), ("=", 20), ("H", 5)],
                    [("M", 12), ("P", 2), ("D", 1), ("M", 9), ("S", 4)])


def write_pod_world(d: Path, seed: int = 61, n_variants: int = 2500) -> dict:
    """A callset of ``n_variants`` on chr1 and chr2 (``synthetic.write_world``)
    as ``calls.vcf``, ``calls.vcf.gz`` (BGZF) and ``plain.vcf.gz`` (one gzip
    member), with its forest (12 trees of depth 5) saved by the JAX package's
    registry as ``jmodel.pkl``. Paths by key, and the model's name."""
    import dataclasses

    from variantcalling_tpu.models import registry as jregistry
    from variantcalling_tpu.models.forest import FlatForest as JFlatForest
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter
    from variantcalling_tpu_torch.models import registry as tregistry

    w = synthetic.write_world(str(d), seed=seed, n_variants=n_variants, n_trees=12, depth=5,
                              contigs=[("chr1", 150_000), ("chr2", 100_000)])
    forest = tregistry.load_model(w["model"], w["model_name"])
    jmodel = str(Path(d) / "jmodel.pkl")
    jregistry.save_models(jmodel, {w["model_name"]: JFlatForest(**{f.name: getattr(forest, f.name)
                                                                   for f in dataclasses.fields(JFlatForest)})})
    text = Path(w["vcf"]).read_bytes()
    with BgzfWriter(str(Path(d) / "calls.vcf.gz")) as out:
        out.write(text)
    with gzip.open(Path(d) / "plain.vcf.gz", "wb") as out:
        out.write(text)
    return {"dir": str(d), "vcf": w["vcf"], "vcf_gz": str(Path(d) / "calls.vcf.gz"),
            "plain_gz": str(Path(d) / "plain.vcf.gz"), "fasta": w["fasta"], "model": jmodel,
            "model_name": w["model_name"], "n": n_variants}


def write_alignment_world(path: str, seed: int, contigs: dict[str, int], n_reads: int = 600,
                          flags: tuple = (0, 0, 0, 0x10, 0x400, 0x100, 0x200, 0x4), overhang: bool = False) -> str:
    """A BAM of ``n_reads`` reads on ``contigs``, in coordinate order:
    CIGARs drawn from :data:`ALIGNMENT_CIGARS`, flags from ``flags``, MAPQ
    0-60, base qualities 2-40; every read within its contig, or with
    ``overhang`` some running past the contig's end."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    reads = []
    for i in range(n_reads):
        c = names[int(rng.integers(len(names)))]
        cigar = ALIGNMENT_CIGARS[int(rng.integers(len(ALIGNMENT_CIGARS)))]
        read_len = sum(n for op, n in cigar if op in "MIS=X")
        last = contigs[c] - (20 if overhang else 80)
        reads.append({"contig": c, "pos": int(rng.integers(0, max(1, last))), "cigar": cigar,
                      "mapq": int(rng.integers(0, 61)), "flag": int(flags[int(rng.integers(len(flags)))]),
                      "quals": rng.integers(2, 41, read_len).tolist(), "name": f"q{i}"})
    reads.sort(key=lambda r: (names.index(r["contig"]), r["pos"]))
    fixtures.write_bam(path, contigs, reads)
    return path


#: the bar between two trained forests on a held-out callset: TREE_SCORE as written (4 decimals) within
#: FOREST_SCORE_ULP (one unit of the fourth decimal, as float32 holds it) where the forests split alike;
#: where they part at a near-tie of two splits' gains (as the JAX package's own jit fit and native trainer
#: part), the mean TREE_SCORE gap within FOREST_MEAN_GAP and FILTER equal on at least
#: FOREST_FILTER_SHARE of the records
FOREST_SCORE_ULP, FOREST_MEAN_GAP, FOREST_FILTER_SHARE = 1.5e-4, 0.05, 0.95


def forest_bar(got, want, x: np.ndarray, device: str = "cpu") -> dict:
    """How forest ``got`` agrees with ``want`` (two port ``FlatForest``s) on
    the held-out rows ``x``: TREE_SCORE as the filter writes it
    (``np.round(score, 4)``), FILTER as PASS at ``pass_threshold``; whether
    the bar above holds (``held``). The margins are the gather walk's on
    ``device`` (the same bits on the card and the CPU)."""
    import torch

    from variantcalling_tpu_torch.models import forest as fmod

    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    sg, sw = (np.round(fmod.finalize_margin(fmod.predict_margin(f, xt).cpu().numpy(), f), 4) for f in (got, want))
    gap = np.abs(sg - sw)
    same_filter = (sg >= got.pass_threshold) == (sw >= want.pass_threshold)
    splits_equal = bool(np.array_equal(got.feature, want.feature))
    out = {"rows": len(x), "splits_equal": splits_equal, "max_score_gap": float(gap.max()) if len(x) else 0.0,
           "mean_score_gap": float(gap.mean()) if len(x) else 0.0,
           "filter_equal_share": float(same_filter.mean()) if len(x) else 1.0}
    if splits_equal:
        out["held"] = out["max_score_gap"] <= FOREST_SCORE_ULP
    else:
        out["held"] = out["mean_score_gap"] <= FOREST_MEAN_GAP and out["filter_equal_share"] >= FOREST_FILTER_SHARE
    return out
