"""The port's bigWig writer and reader against the JAX package's, on the CPU.

Both are numpy, struct and zlib: the port's file is the JAX package's byte
for byte (several contigs, an empty one, one R-tree leaf and two levels,
compressed and not, from per-base arrays and from runs), and its reader
gives the JAX package's reader's values, sizes and stats.
"""

import numpy as np
import pytest

from variantcalling_tpu.io import bigwig as jbw
from variantcalling_tpu_torch.io import bigwig as tbw


def _values(seed: int, sizes: dict[str, int], run: int, dtype) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for c, n in sizes.items():
        steps = rng.integers(0, 60, max(1, n // run + 1)).astype(dtype)
        out[c] = np.repeat(steps, run)[:n]
    return out


WORLDS = {
    "int_depth": (1, {"chr1": 5000, "chr2": 777, "chrM": 40}, 7, np.int32),
    "float_values": (2, {"chrA": 3000}, 3, np.float32),
    "empty_contig": (3, {"chr1": 2000, "chrE": 0, "chr3": 10}, 5, np.int32),
    "two_level_rtree": (4, {"chr1": 300_000}, 1, np.int32),  # 300,000 runs: 293 sections, 2 R-tree leaves
}


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_bytes_equal_the_reference(world, compress, tmp_path):
    seed, sizes, run, dtype = WORLDS[world]
    vals = _values(seed, sizes, run, dtype)
    a, b = tmp_path / "port.bw", tmp_path / "ref.bw"
    tbw.write_bigwig(str(a), vals, compress=compress)
    jbw.write_bigwig(str(b), vals, compress=compress)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("world", list(WORLDS))
def test_runs_writer_writes_the_same_file(world, tmp_path):
    seed, sizes, run, dtype = WORLDS[world]
    vals = _values(seed, sizes, run, dtype)
    tbw.write_bigwig(str(tmp_path / "a.bw"), vals)
    tbw.write_bigwig_runs(str(tmp_path / "b.bw"), {c: tbw._runlength(v) for c, v in vals.items()},
                          {c: len(v) for c, v in vals.items()})
    assert (tmp_path / "a.bw").read_bytes() == (tmp_path / "b.bw").read_bytes()


@pytest.mark.parametrize("world", list(WORLDS))
def test_reader_values_equal_the_reference(world, tmp_path):
    seed, sizes, run, dtype = WORLDS[world]
    vals = _values(seed, sizes, run, dtype)
    path = str(tmp_path / "x.bw")
    jbw.write_bigwig(path, vals)
    with tbw.BigWigReader(path) as t, jbw.BigWigReader(path) as j:
        assert t.chroms() == j.chroms() == {c: len(v) for c, v in vals.items()}
        for c, v in vals.items():
            got = t.values(c, 0, len(v))
            assert np.array_equal(got, j.values(c, 0, len(v)), equal_nan=True)
            assert np.array_equal(got, v.astype(np.float32).astype(np.float64))
            lo, hi = len(v) // 3, len(v) // 3 + 17
            assert np.array_equal(t.values(c, lo, hi), j.values(c, lo, hi), equal_nan=True)
            if len(v):
                assert t.stats(c) == j.stats(c)
        assert np.isnan(t.values("chrNone", 0, 5)).all()
