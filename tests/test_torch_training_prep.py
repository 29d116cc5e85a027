"""``training_prep_pipeline`` of the port against the JAX package's CLI.

Both labeling modes on the same inputs: exact ground truth from a
concordance h5 (per-contig keys, stacked by ``key="all"``, or one key by
``--dataset_key``) and approximate ground truth from a dbSNP-annotated
callset with a blacklist (``.bed`` and ``.h5``). The port's
``<prefix>.labels.h5`` must hold the JAX package's keys, each read by the
JAX package's ``read_hdf`` as a frame equal to its own output (dtypes and
index included), and open in h5py.
"""

import h5py
import numpy as np
import pandas as pd
import pytest

from tests import torch_worlds
from variantcalling_tpu.__main__ import main as jax_main
from variantcalling_tpu.utils import h5_utils as jh5
from variantcalling_tpu_torch.__main__ import main as torch_main
from variantcalling_tpu_torch.pipelines import training_prep as ttp
from variantcalling_tpu_torch.utils import h5_utils as th5


@pytest.fixture(scope="module")
def h5_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tprep_h5")
    return torch_worlds.write_training_h5_world(d / "concordance.h5", seed=5, n_rows=3000, chr20_rows=400)


@pytest.fixture(scope="module")
def vcf_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tprep_vcf")
    w = torch_worlds.write_training_vcf_world(d, seed=6, n_variants=1500, n_trees=4, depth=3)
    loci = pd.read_csv(w["blacklist"], sep="\t", header=None)
    jh5.write_hdf(pd.DataFrame({"chrom": loci[0].to_numpy(dtype=object), "pos": loci[2].to_numpy()}),
                  str(d / "blacklist.h5"), "loci", mode="w")
    return {**w, "blacklist_h5": str(d / "blacklist.h5")}


def _run_both(tmp_path, argv: list[str]) -> tuple[str, str]:
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert torch_main(["training_prep_pipeline", *argv, "--output_prefix", port]) == 0
    assert jax_main(["training_prep_pipeline", *argv, "--output_prefix", ref]) == 0
    return port + ".labels.h5", ref + ".labels.h5"


def _assert_same_labels(port: str, ref: str) -> list[str]:
    keys = jh5.list_keys(ref)
    assert keys and jh5.list_keys(port) == keys == th5.list_keys(port)
    with h5py.File(port) as f:
        assert sorted(f.keys()) == keys
    for key in keys:
        pd.testing.assert_frame_equal(jh5.read_hdf(port, key), jh5.read_hdf(ref, key))
    return keys


@pytest.mark.parametrize("dataset_key", [None, "chr2"])
def test_exact_gt_labels_equal_the_reference(h5_world, tmp_path, dataset_key):
    argv = ["--input_file", h5_world] + (["--dataset_key", dataset_key] if dataset_key else [])
    port, ref = _run_both(tmp_path, argv)
    keys = _assert_same_labels(port, ref)
    assert keys == (["chr1", "chr2", "chr20"] if dataset_key is None else ["chr2"])
    got = jh5.read_hdf(port, keys[-1])
    assert list(got.columns[-2:]) == ["label", "label_gt"] and "classify" not in got.columns
    assert got["label"].dtype == np.int8 and (got["label"] != got["label_gt"]).any()


def test_exact_gt_from_an_all_key(tmp_path):
    """An ``all`` key is read alone; rows stay in order, the index as pandas keeps it."""
    from variantcalling_tpu_torch import synthetic

    frames = synthetic.train_world(8, 600, contigs=(("chr3", 1000), ("chr1", 900)))
    th5.write_frames(str(tmp_path / "all.h5"), {"all": th5.concat_frames(list(frames.values())),
                                               "concordance": frames["chr1"]})
    port, ref = _run_both(tmp_path, ["--input_file", str(tmp_path / "all.h5")])
    assert _assert_same_labels(port, ref) == ["chr1", "chr3"]


@pytest.mark.parametrize("blacklist", ["bed", "h5", None])
def test_approximate_gt_labels_equal_the_reference(vcf_world, tmp_path, blacklist):
    argv = ["--input_file", vcf_world["vcf"]]
    if blacklist:
        argv += ["--blacklist", vcf_world["blacklist" if blacklist == "bed" else "blacklist_h5"]]
    port, ref = _run_both(tmp_path, argv)
    keys = _assert_same_labels(port, ref)
    assert keys == ["chr19", "chr20"]
    labels = pd.concat([jh5.read_hdf(port, k) for k in keys])
    assert set(labels["label"]) == ({0, 1} if blacklist else {1})


def test_helpers_equal_the_reference():
    from variantcalling_tpu.pipelines import training_prep as jtp

    rng = np.random.default_rng(2)
    chrom = rng.choice(["chr1", "chr2", "chrX"], 500).astype(object)
    pos = rng.integers(1, 1000, 500)
    bl_c, bl_p = chrom[::7], pos[::7]
    np.testing.assert_array_equal(ttp.blacklist_membership(chrom, pos, bl_c, bl_p),
                                  jtp.blacklist_membership(chrom, pos, bl_c, bl_p))
    assert not ttp.blacklist_membership(chrom, pos, bl_c[:0], bl_p[:0]).any()
    dbsnp, bl = rng.random(500) < 0.5, rng.random(500) < 0.2
    for a, b in zip(ttp.labels_from_approximate_gt(chrom, pos, dbsnp, bl),
                    jtp.labels_from_approximate_gt(chrom, pos, dbsnp, bl)):
        np.testing.assert_array_equal(a, b)


def test_unreadable_input_exits_2(tmp_path):
    bad = tmp_path / "latest.h5"
    with h5py.File(bad, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    assert torch_main(["training_prep_pipeline", "--input_file", str(bad), "--output_prefix",
                       str(tmp_path / "o")]) == 2
    assert not (tmp_path / "o.labels.h5").exists()
