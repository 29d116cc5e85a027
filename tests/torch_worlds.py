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


if __name__ == "__main__":
    write_blacklist_fixtures()
    for p in BLACKLIST_FILES.values():
        print(p, p.stat().st_size, "bytes")
