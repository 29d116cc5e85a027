"""Synthetic models and a vectorised writer of a whole filter world from a seed.

Counterpart of ``variantcalling_tpu/synthetic.py`` (``synthetic_forest``,
``synthetic_dan``) and of ``bench.make_fixtures_fast`` (a callset written
with numpy byte arrays, no per-record Python): a reference genome (``.fa``
+ ``.fai``), a called VCF with SNPs, hmer and non-hmer indels and
multiallelics, and a forest model — a pickle, or an xgboost 2.x JSON model
with missing-value routing over a callset where some records lack SOR and
GQ — all from one ``numpy`` seed. :func:`add_family_models` adds a
threshold model and a DAN to a world's pickle, as the reference's
``train_models_pipeline`` writes several families into one file.
:func:`train_world` makes the labeled concordance frames
``train_models_pipeline`` trains on, and :func:`add_dbsnp_ids` marks a
world's callset for approximate-GT labels.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from variantcalling_tpu_torch.featurize import BASE_FEATURES
from variantcalling_tpu_torch.models.dan import MOTIF_VOCAB, DanConfig, DanModel
from variantcalling_tpu_torch.models.forest import LEAF, FlatForest
from variantcalling_tpu_torch.models.registry import load_models, save_models
from variantcalling_tpu_torch.models.threshold import ThresholdModel

N_HOT_FEATURES = 12
_BASES = np.frombuffer(b"ACGT", dtype="S1")

#: value range of each BASE_FEATURES column in :func:`write_world`'s callsets,
#: used to spread the synthetic forest's thresholds over real values
FEATURE_RANGES = {
    "qual": (10, 90), "dp": (10, 60), "sor": (0, 3), "af": (0, 1), "gq": (10, 99),
    "is_het": (0, 1), "is_snp": (0, 1), "is_indel": (0, 1), "is_ins": (0, 1),
    "indel_length": (0, 3), "hmer_indel_length": (0, 8), "hmer_indel_nuc": (0, 4),
    "gc_content": (0, 1), "cycleskip_status": (-1, 2), "left_motif": (0, 3124),
    "right_motif": (0, 3124), "ref_code": (0, 4), "alt_code": (0, 4), "n_alts": (1, 2),
}


def synthetic_forest(rng: np.random.Generator, n_trees: int = 40, depth: int = 12,
                     n_features: int = N_HOT_FEATURES) -> FlatForest:
    """Random, structurally valid forest of complete binary trees with
    2^(depth-1) - 1 internal nodes and 2^(depth-1) leaves each (the same
    arrays as the reference's ``synthetic_forest`` for the same generator)."""
    m = 2**depth
    feature = rng.integers(0, n_features, size=(n_trees, m)).astype(np.int32)
    left = np.minimum(2 * np.arange(m) + 1, m - 1).astype(np.int32)
    right = np.minimum(2 * np.arange(m) + 2, m - 1).astype(np.int32)
    is_leaf = np.arange(m) >= (m // 2 - 1)
    feature[:, is_leaf] = -1
    return FlatForest(
        feature=feature,
        threshold=rng.uniform(0, 50, size=(n_trees, m)).astype(np.float32),
        left=np.broadcast_to(np.where(is_leaf, np.arange(m), left), (n_trees, m)).astype(np.int32),
        right=np.broadcast_to(np.where(is_leaf, np.arange(m), right), (n_trees, m)).astype(np.int32),
        value=rng.uniform(0, 1, size=(n_trees, m)).astype(np.float32),
        max_depth=depth,
    )


def filter_forest(rng: np.random.Generator, n_trees: int, depth: int,
                  aggregation: str = "logit_sum") -> FlatForest:
    """A :func:`synthetic_forest` over BASE_FEATURES whose thresholds fall inside
    each feature's value range and whose scores spread over (0, 1)."""
    forest = synthetic_forest(rng, n_trees=n_trees, depth=depth, n_features=len(BASE_FEATURES))
    lo = np.asarray([FEATURE_RANGES[f][0] for f in BASE_FEATURES], dtype=np.float64)
    hi = np.asarray([FEATURE_RANGES[f][1] for f in BASE_FEATURES], dtype=np.float64)
    f = np.maximum(forest.feature, 0)
    forest.threshold = (lo[f] + forest.threshold / 50.0 * (hi[f] - lo[f])).astype(np.float32)
    if aggregation == "logit_sum":
        forest.value = ((forest.value - 0.5) * 0.4).astype(np.float32)
    forest.aggregation = aggregation
    forest.feature_names = list(BASE_FEATURES)
    return forest


def synthetic_dan(rng: np.random.Generator, feature_names: list[str], embed_dim: int = 4,
                  hidden: int = 16, n_layers: int = 2) -> DanModel:
    """A random, structurally valid DAN over ``feature_names`` (the numeric block
    is every feature but the motif codes), its weights drawn from ``rng`` with
    the reference's ``init_params`` scales and a non-zero output head, so the
    scores vary. Each numeric feature is normalised onto [-1, 1] over its
    :data:`FEATURE_RANGES` range (mean 0, sd 10 where it has none, as the
    reference's ``synthetic_dan``), so the scores spread on both sides of
    0.5. ``train_dan``'s defaults: embed 16, hidden 256, 2 layers."""
    numeric = [f for f in feature_names if f not in ("left_motif", "right_motif")]
    cfg = DanConfig(n_numeric=len(numeric), embed_dim=embed_dim, hidden=hidden, n_layers=n_layers)
    in_dim = cfg.n_numeric + 2 * embed_dim

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"motif_embed": normal(MOTIF_VOCAB, embed_dim, scale=0.02),
              "w_in": normal(in_dim, hidden, scale=1 / np.sqrt(in_dim)),
              "b_in": np.zeros(hidden, np.float32),
              "w_out": normal(hidden, 1, scale=1 / np.sqrt(hidden)),
              "b_out": np.zeros(1, np.float32)}
    for i in range(n_layers - 1):
        params[f"w_{i}"] = normal(hidden, hidden, scale=1 / np.sqrt(hidden))
        params[f"b_{i}"] = np.zeros(hidden, np.float32)
    model = DanModel.from_params(cfg, params, feature_names=list(feature_names), numeric_features=numeric)
    lo, hi = np.asarray([FEATURE_RANGES.get(f, (-10, 10)) for f in numeric], dtype=np.float32).T
    model.norm_mu = (lo + hi) / 2
    model.norm_sd = (hi - lo) / 2
    return model


def synthetic_threshold(rng: np.random.Generator, feature_names: list[str],
                        used: tuple[str, ...] = ("qual", "sor")) -> ThresholdModel:
    """A threshold model over ``used`` (higher qual is better, lower sor): each
    threshold drawn from the middle half of the feature's range in
    :data:`FEATURE_RANGES`, each scale a twentieth of the range."""
    lo = np.asarray([FEATURE_RANGES[f][0] for f in used], dtype=np.float64)
    hi = np.asarray([FEATURE_RANGES[f][1] for f in used], dtype=np.float64)
    return ThresholdModel(
        feature_names=list(used),
        thresholds=(lo + (hi - lo) * rng.uniform(0.25, 0.75, len(used))).astype(np.float32),
        signs=np.asarray([-1.0 if f == "sor" else 1.0 for f in used], dtype=np.float32),
        scales=((hi - lo) / 20).astype(np.float32),
        pass_threshold=0.25,
        all_feature_names=list(feature_names))


#: model names :func:`add_family_models` writes
DAN_MODEL_NAME = "dan_model_ignore_gt_incl_hpol_runs"
THRESHOLD_MODEL_NAME = "threshold_model_ignore_gt_incl_hpol_runs"


def add_family_models(model_path: str, seed: int, embed_dim: int = 16, hidden: int = 256,
                      n_layers: int = 2) -> dict[str, str]:
    """Add a :func:`synthetic_threshold` model over qual and sor and a
    :func:`synthetic_dan` over BASE_FEATURES (``train_dan``'s default widths
    unless given) to the pickle at ``model_path``. Returns family -> model name."""
    rng = np.random.default_rng(seed)
    models = load_models(model_path)
    models[THRESHOLD_MODEL_NAME] = synthetic_threshold(rng, BASE_FEATURES)
    models[DAN_MODEL_NAME] = synthetic_dan(rng, BASE_FEATURES, embed_dim, hidden, n_layers)
    save_models(model_path, models)
    return {"threshold": THRESHOLD_MODEL_NAME, "dan": DAN_MODEL_NAME}


def xgboost_json(forest: FlatForest, default_left: np.ndarray, base_prob: float) -> dict:
    """The xgboost 2.x JSON model (``Booster.save_model`` format) of a
    ``binary:logistic`` forest of :func:`synthetic_forest`'s complete,
    heap-ordered trees — the inverse of :func:`models.xgb.from_xgboost_json`.

    xgboost sends ``x < split_condition`` left, so each threshold is written
    as the next float32 above it; leaves carry their value in
    ``split_conditions``. The padding node past the last leaf is dropped.
    """
    t, m = forest.feature.shape
    n = m - 1
    trees = []
    for ti in range(t):
        leaf = forest.feature[ti, :n] == LEAF
        left = np.where(leaf, -1, forest.left[ti, :n])
        right = np.where(leaf, -1, forest.right[ti, :n])
        cond = np.where(leaf, forest.value[ti, :n],
                        np.nextafter(forest.threshold[ti, :n], np.float32(np.inf))).astype(np.float32)
        parents = np.full(n, 2147483647, dtype=np.int64)
        parents[left[~leaf]] = np.nonzero(~leaf)[0]
        parents[right[~leaf]] = np.nonzero(~leaf)[0]
        trees.append({
            "base_weights": [0.0] * n, "categories": [], "categories_nodes": [],
            "categories_segments": [], "categories_sizes": [],
            "default_left": (default_left[ti, :n] & ~leaf).astype(int).tolist(), "id": ti,
            "left_children": left.tolist(), "loss_changes": [0.0] * n, "parents": parents.tolist(),
            "right_children": right.tolist(), "split_conditions": [float(c) for c in cond],
            "split_indices": np.where(leaf, 0, forest.feature[ti, :n]).tolist(),
            "split_type": [0] * n, "sum_hessian": [1.0] * n,
            "tree_param": {"num_deleted": "0", "num_feature": str(len(forest.feature_names)),
                           "num_nodes": str(n), "size_leaf_vector": "1"},
        })
    return {
        "learner": {
            "attributes": {}, "feature_names": list(forest.feature_names),
            "feature_types": ["float"] * len(forest.feature_names),
            "gradient_booster": {
                "model": {"gbtree_model_param": {"num_parallel_tree": "1", "num_trees": str(t)},
                          "iteration_indptr": list(range(t + 1)), "tree_info": [0] * t,
                          "trees": trees},
                "name": "gbtree"},
            "learner_model_param": {"base_score": f"{base_prob:E}", "boost_from_average": "1",
                                    "num_class": "0", "num_feature": str(len(forest.feature_names)),
                                    "num_target": "1"},
            "objective": {"name": "binary:logistic", "reg_loss_param": {"scale_pos_weight": "1"}},
        },
        "version": [2, 1, 2],
    }


def _genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """uint8 codes: random bases with homopolymer runs of 3-14 injected every ~200 bp."""
    arr = rng.integers(0, 4, size=length, dtype=np.uint8)
    n_runs = length // 200
    starts = rng.integers(0, max(1, length - 20), size=n_runs)
    lens = rng.integers(3, 15, size=n_runs)
    offs = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    arr[np.repeat(starts, lens) + offs] = np.repeat(arr[starts], lens)
    return arr


def _write_fasta(path: str, contigs: list[tuple[str, np.ndarray]]) -> None:
    """``contigs`` (name, codes) as a FASTA of 60-base lines, and its ``.fai``."""
    fai = []
    with open(path, "wb") as fh:
        for name, codes in contigs:
            seq = _BASES[codes].view(np.uint8)
            k = len(seq) // 60
            fh.write(f">{name}\n".encode())
            fai.append(f"{name}\t{len(codes)}\t{fh.tell()}\t60\t61\n")
            fh.write(np.concatenate([seq[: k * 60].reshape(k, 60),
                                     np.full((k, 1), ord("\n"), np.uint8)], axis=1).tobytes())
            tail = seq[k * 60:]
            if len(tail):
                fh.write(tail.tobytes() + b"\n")
    with open(path + ".fai", "wt") as fh:
        fh.write("".join(fai))


def _cat(*parts) -> np.ndarray:
    acc = parts[0]
    for p in parts[1:]:
        acc = np.char.add(acc, p)
    return acc


def _decimal(values) -> np.ndarray:
    """``np.char.mod(b"%d", values)`` of non-negative integers, from their
    digits by array arithmetic (the same bytes, without a Python call each)."""
    v = np.asarray(values, dtype=np.int64)
    if not len(v):
        return np.char.mod(b"%d", v)
    width = len(str(int(v.max())))
    digits = (v[:, None] // 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)) % 10 + ord("0")
    n_digits = np.searchsorted(10 ** np.arange(1, width, dtype=np.int64), v, side="right") + 1
    col = np.arange(width) + (width - n_digits)[:, None]  # each value's digits moved to the left
    out = np.where(col < width, np.take_along_axis(digits, np.minimum(col, width - 1), axis=1), 0)
    return out.astype(np.uint8).view(f"S{width}").ravel()


def _fixed(values, decimals: int) -> np.ndarray:
    """``np.char.mod(b"%.{decimals}f", values)`` of non-negative floats: the
    scaled values rounded by array arithmetic, where the product's rounding
    error cannot reach a half; ``np.char.mod`` itself for any value within
    1e-6 of one."""
    v = np.asarray(values, dtype=np.float64)
    scaled = v * 10 ** decimals
    units = np.floor(scaled + 0.5).astype(np.int64)
    frac = _decimal(units % 10 ** decimals + 10 ** decimals).view(np.uint8).reshape(len(v), -1)[:, 1:]
    out = np.char.add(np.char.add(_decimal(units // 10 ** decimals), b"."), frac.copy().view(f"S{decimals}").ravel())
    near = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-6
    if near.any():
        exact = np.char.mod(f"%.{decimals}f".encode(), v[near])
        out = out.astype(f"S{max(out.itemsize, exact.itemsize)}")
        out[near] = exact
    return out


def _world_genome_positions(rng: np.random.Generator, length: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The world's genome codes and its variants' sorted distinct 0-based
    positions, the first draws of :func:`write_world`'s generator."""
    genome = _genome(rng, length)
    cand = np.unique(rng.integers(100, length - 100, size=n + n // 16 + 64))
    while len(cand) < n:
        cand = np.unique(np.concatenate([cand, rng.integers(100, length - 100, size=n)]))
    return genome, np.sort(cand[np.sort(rng.choice(len(cand), size=n, replace=False))])


def blacklist_loci(world_seed: int, seed: int, n_loci: int, length: int = 64_444_167,
                   n_variants: int = 104_000) -> np.ndarray:
    """Sorted 1-based positions of ``n_loci`` distinct variants of the world
    that :func:`write_world` writes with ``world_seed`` (and the same
    ``length`` and ``n_variants``), drawn with ``seed``: loci that a
    blacklist of that world marks."""
    _, pos0 = _world_genome_positions(np.random.default_rng(world_seed), length, n_variants)
    return np.sort(np.random.default_rng(seed).choice(pos0, size=n_loci, replace=False)) + 1


#: GRCh38's chr20, chr21 and chr22 (name, length in bases)
GRCH38_CHR20_22 = (("chr20", 64_444_167), ("chr21", 46_709_983), ("chr22", 50_818_468))


def write_world(d: str, seed: int, contig: str = "chr20", length: int = 64_444_167,
                n_variants: int = 104_000, n_trees: int = 100, depth: int = 7,
                aggregation: str = "logit_sum", model_name: str = "rf_model_ignore_gt_incl_hpol_runs",
                xgboost: bool = False, contigs: list[tuple[str, int]] | None = None) -> dict:
    """Write ``ref.fa`` (+ ``.fai``), ``calls.vcf`` and ``model.pkl`` under ``d``.

    The callset: 65% SNPs, 5% multiallelic SNPs, 15% insertions (half of them
    hmer insertions of the next reference base) and 15% deletions of 1-3 bases,
    at distinct sorted positions, with QUAL written as GATK writes it (two
    decimals; 1% of the records at 10,000 and more). Returns the paths and
    the model name.

    ``contigs``: (name, length) of each contig, in order, in place of
    ``contig`` and ``length``; the variants are shared out in proportion to
    the lengths (the last contig takes the rest). One contig writes the same
    bytes as ``contig`` and ``length``.

    ``xgboost=True`` writes ``model.json`` instead: an xgboost JSON model
    (:func:`xgboost_json`, ``binary:logistic``, ``default_left`` and
    ``base_score`` drawn from the seed; ``aggregation`` and ``model_name``
    do not apply, the registry names a bare JSON model ``model``), and
    about 10% of the records lack SOR in INFO and GQ in FORMAT, so NaN
    reaches the forest.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    contigs = list(contigs) if contigs else [(contig, length)]
    total = sum(ln for _, ln in contigs)
    counts = [n_variants * ln // total for _, ln in contigs[:-1]]
    counts.append(n_variants - sum(counts))
    genomes, pos_parts, offset = [], [], 0
    for (_, ln), k in zip(contigs, counts):
        g, p = _world_genome_positions(rng, ln, k)
        genomes.append(g)
        pos_parts.append(p + offset)  # positions into the contigs' concatenation
        offset += ln
    fasta = os.path.join(d, "ref.fa")
    _write_fasta(fasta, [(name, g) for (name, _), g in zip(contigs, genomes)])
    genome = genomes[0] if len(genomes) == 1 else np.concatenate(genomes)
    gpos = np.concatenate(pos_parts)

    n = n_variants
    kind = rng.random(n)
    multi = (kind >= 0.65) & (kind < 0.70)
    ins, dele = (kind >= 0.70) & (kind < 0.85), kind >= 0.85
    ref_c = genome[gpos]
    shift = rng.integers(1, 4, size=n).astype(np.uint8)
    shift2 = (shift % 3 + 1).astype(np.uint8)  # another nonzero shift
    k = rng.integers(1, 4, size=n)
    anchor = _BASES[ref_c]
    alt = _BASES[(ref_c + shift) % 4].astype("S8")
    alt[multi] = _cat(alt[multi], b",", _BASES[(ref_c[multi] + shift2[multi]) % 4])
    hmer = rng.random(n) < 0.5
    ins_codes = np.where(hmer[:, None], genome[gpos + 1][:, None],
                         rng.integers(0, 4, size=(n, 3), dtype=np.uint8))
    ins_s = anchor.astype("S8")
    ref = anchor.astype("S8")
    for j in range(3):
        ins_s = np.where(k > j, _cat(ins_s, _BASES[ins_codes[:, j]]), ins_s)
        ref = np.where(dele & (k > j), _cat(ref, _BASES[genome[gpos + 1 + j]]), ref)
    alt[ins] = ins_s[ins]
    alt[dele] = anchor[dele]

    missing = rng.random(n) < 0.1 if xgboost else np.zeros(n, dtype=bool)
    q = rng.uniform(10, 90, n)
    q = np.where(q > 89.2, 10_000 + (q - 89.2) * 25_000, q)  # 1 % at 10,000-30,000
    qual = _fixed(q, 2)  # GATK's two decimals
    info = _cat(b"DP=", _decimal(rng.integers(10, 60, n)))
    info = np.where(missing, info, _cat(info, b";SOR=", _fixed(rng.uniform(0, 3, n), 3)))
    gt = np.where(multi, b"1/2", np.where(rng.random(n) < 0.6, b"0/1", b"1/1"))
    ad = _cat(_decimal(rng.integers(0, 40, n)), b",", _decimal(rng.integers(1, 40, n))).astype("S12")
    ad[multi] = _cat(ad[multi], b",", _decimal(rng.integers(1, 40, int(multi.sum()))))
    gq = _decimal(rng.integers(10, 99, n))
    sample = np.where(missing, _cat(gt, b":", ad), _cat(gt, b":", gq, b":", ad))
    fmt = np.where(missing, b"GT:AD", b"GT:GQ:AD")
    tab = b"\t"
    chrom = np.repeat(np.asarray([name.encode() for name, _ in contigs]), counts)
    pos1 = np.concatenate([p + 1 for p in pos_parts]) - np.repeat(
        np.cumsum([0] + [ln for _, ln in contigs[:-1]]), counts)
    rec = _cat(chrom, tab, _decimal(pos1), tab, b".", tab,
               ref, tab, alt, tab, qual, tab, b"PASS", tab, info, tab, fmt, tab, sample)
    header = [
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##INFO=<ID=SOR,Number=1,Type=Float,Description="Symmetric odds ratio">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
        *(f"##contig=<ID={name},length={ln}>" for name, ln in contigs),
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tHG002",
    ]
    vcf = os.path.join(d, "calls.vcf")
    with open(vcf, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        fh.write(b"\n".join(rec.tolist()) + b"\n")

    if xgboost:
        forest = filter_forest(rng, n_trees, depth)
        dump = xgboost_json(forest, rng.random(forest.feature.shape) < 0.5, float(rng.uniform(0.3, 0.7)))
        model, model_name = os.path.join(d, "model.json"), "model"
        with open(model, "w") as fh:
            json.dump(dump, fh)
    else:
        model = os.path.join(d, "model.pkl")
        save_models(model, {model_name: filter_forest(rng, n_trees, depth, aggregation)})
    return {"fasta": fasta, "vcf": vcf, "model": model, "model_name": model_name}


#: GRCh38's autosomes (name, length in bases)
GRCH38_AUTOSOMES = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559), ("chr4", 190_214_555),
    ("chr5", 181_538_259), ("chr6", 170_805_979), ("chr7", 159_345_973), ("chr8", 145_138_636),
    ("chr9", 138_394_717), ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189), ("chr16", 90_338_345),
    ("chr17", 83_257_441), ("chr18", 80_373_285), ("chr19", 58_617_616), ("chr20", 64_444_167),
    ("chr21", 46_709_983), ("chr22", 50_818_468))
_TRAIN_INT_FEATURES = {"indel_length", "hmer_indel_length", "hmer_indel_nuc", "cycleskip_status", "left_motif",
                       "right_motif", "ref_code", "alt_code", "n_alts"}
_TRAIN_BOOL_FEATURES = {"is_het", "is_snp", "is_indel", "is_ins"}


def train_world(seed: int, n_rows: int, contigs=GRCH38_AUTOSOMES, chr20_rows: int | None = None,
                fn_share: float = 0.02, gt_flip: float = 0.03) -> dict:
    """Labeled concordance frames of a callset, one per contig (name ->
    :class:`utils.h5_utils.Frame`), as ``run_comparison`` writes them and
    ``train_models_pipeline`` reads them: ``chrom``, sorted ``pos``, the 19
    non-somatic features of ``BASE_FEATURES`` (floats, bools and ints within
    :data:`FEATURE_RANGES`), ``hpol_run``, and ``classify``/``classify_gt``:
    tp with the probability of a seeded logistic model of the features, else
    fp; ``fn_share`` of the rows fn; ``classify_gt`` differing from
    ``classify`` on ``gt_flip`` of the tp/fp rows. ``chr20_rows`` pins chr20's
    share; the other contigs share the rest by length."""
    from variantcalling_tpu_torch.utils.h5_utils import Frame

    rng = np.random.default_rng(seed)
    names = list(contigs)
    rest = [c for c in names if c[0] != "chr20"] if chr20_rows is not None else names
    left = n_rows - (chr20_rows or 0)
    total = sum(ln for _, ln in rest)
    counts = {c: left * ln // total for c, ln in rest}
    counts[rest[-1][0]] += left - sum(counts.values())
    if chr20_rows is not None:
        counts["chr20"] = chr20_rows
    n = n_rows
    cols: dict[str, np.ndarray] = {}
    for f in BASE_FEATURES:
        lo, hi = FEATURE_RANGES[f]
        if f in _TRAIN_BOOL_FEATURES:
            cols[f] = rng.random(n) < 0.5
        elif f in _TRAIN_INT_FEATURES:
            cols[f] = rng.integers(lo, hi + 1, n).astype(np.int64 if f.endswith("motif") else np.int32)
        else:
            cols[f] = (lo + rng.random(n) * (hi - lo)).astype(np.float32)
    coef = rng.normal(0, 1, len(BASE_FEATURES)) * 3
    z = sum(c * (np.asarray(cols[f], dtype=np.float64) - FEATURE_RANGES[f][0])
            / (FEATURE_RANGES[f][1] - FEATURE_RANGES[f][0]) for c, f in zip(coef, BASE_FEATURES))
    z = z - np.median(z) + 0.8
    tp = rng.random(n) < 1.0 / (1.0 + np.exp(-z))
    classify = np.where(tp, "tp", "fp").astype(object)
    fn = rng.random(n) < fn_share
    classify[fn] = "fn"
    flip = ~fn & (rng.random(n) < gt_flip)
    classify_gt = classify.copy()
    classify_gt[flip] = np.where(classify[flip] == "tp", "fp", "tp")
    hpol = rng.random(n) < 0.1
    frames, lo = {}, 0
    for name, _ in names:
        k = counts[name]
        sl = slice(lo, lo + k)
        lo += k
        chrom = np.empty(k, dtype=object)
        chrom[:] = name
        pos = np.sort(rng.choice(dict(names)[name] - 1, size=k, replace=False)).astype(np.int64) + 1
        frames[name] = Frame({"chrom": chrom, "pos": pos, **{f: cols[f][sl] for f in BASE_FEATURES},
                              "hpol_run": hpol[sl], "classify": classify[sl], "classify_gt": classify_gt[sl]})
    return frames


def add_dbsnp_ids(vcf: str, seed: int, share: float = 0.6) -> None:
    """Give ``share`` of the records of a world's ``calls.vcf`` an ``rs`` ID
    (dbSNP members, label 1 under approximate-GT labeling), in place."""
    with open(vcf, "rb") as fh:
        lines = fh.read().split(b"\n")
    body = [i for i, line in enumerate(lines) if line and not line.startswith(b"#")]
    rng = np.random.default_rng(seed)
    for i in np.asarray(body)[rng.random(len(body)) < share]:
        parts = lines[i].split(b"\t", 3)
        parts[2] = b"rs%d" % (1000 + i)
        lines[i] = b"\t".join(parts)
    with open(vcf, "wb") as fh:
        fh.write(b"\n".join(lines))


# -- the coverage world: an aligned BAM of a 30x chr20 ------------------------------------------------

#: read shapes of the coverage world, 150 read bases each: (name, CIGAR as (op code, length)); the
#: records cycle through :data:`COVERAGE_SHAPE_CYCLE` in coordinate order
COVERAGE_SHAPES = (
    ("150M", ((0, 150),)),
    ("70M2I78M", ((0, 70), (1, 2), (0, 78))),
    ("60M3D90M", ((0, 60), (2, 3), (0, 90))),
    ("5S145M", ((4, 5), (0, 145))),
    ("8S90M2D52M", ((4, 8), (0, 90), (2, 2), (0, 52))),
)
COVERAGE_SHAPE_CYCLE = (0,) * 26 + (1, 1, 2, 2, 3, 4)
COVERAGE_READ_LEN = 150
#: binned base qualities (as Illumina's binned scale), in 256ths: 2 %, 6 %, 12 % and 80 %
#: (-q 20 drops 8 % of the bases)
COVERAGE_QUALS = np.repeat(np.array([2, 12, 23, 37], np.uint8), (5, 15, 31, 205))
#: planted copy-number events of chr20: (start, end, depth); the rest at the world's depth
COVERAGE_EVENTS = ((20_000_000, 20_500_000, 15), (35_000_000, 36_000_000, 45), (50_000_000, 50_100_000, 0))
_BAM_NIBBLE = np.array([1, 2, 4, 8, 15], np.uint8)  # codes A C G T N -> BAM 4-bit bases
#: records a chunk of the writer (a multiple of the shape cycle)
_COVERAGE_CHUNK = 1 << 20
_COVERAGE_WRITERS = 4  # threads building BAM record chunks


def coverage_reads(seed: int, contigs: list[tuple[str, int]], depth: float = 30.0,
                   events: tuple = COVERAGE_EVENTS, chrm_depth: float = 300.0) -> dict:
    """The coverage world's alignments, sorted by contig and position: read
    starts drawn uniformly over each stretch of constant depth (the events
    cut the first contig; a contig named chrM at ``chrm_depth``), 3 %
    duplicates (0x400), 1 % secondary (0x100), a quarter of the rest
    reverse (0x10), MAPQ 0 on 4 %, else 60, and a shape from
    :data:`COVERAGE_SHAPES` by the record's place in the cycle (the last
    records dropped to whole cycles). Also each contig's genome codes
    (:func:`_genome`, the first draws of the seed)."""
    rng = np.random.default_rng(seed)
    genomes = [_genome(rng, ln) for _, ln in contigs]
    ref_id, pos = [], []
    span = 160  # a read's reference span is at most 153
    for rid, (name, ln) in enumerate(contigs):
        d = chrm_depth if name == "chrM" else depth
        cuts = [(0, ln, d)] if rid or not events else []
        if rid == 0 and events:
            edge = 0
            for s, e, dd in events:
                cuts += [(edge, s, depth), (s, e, dd)]
                edge = e
            cuts.append((edge, ln, depth))
        for s, e, dd in cuts:
            hi = min(e, ln - span)
            n = int(round(dd * (hi - s) / COVERAGE_READ_LEN)) if hi > s else 0
            pos.append(rng.integers(s, hi, n))
            ref_id.append(np.full(n, rid, np.int32))
    ref_id, pos = np.concatenate(ref_id), np.concatenate(pos)
    order = np.lexsort((pos, ref_id))
    order = order[: len(order) - len(order) % len(COVERAGE_SHAPE_CYCLE)]  # whole cycles of shapes
    ref_id, pos = ref_id[order], pos[order].astype(np.int32)
    n = len(pos)
    kind = rng.random(n)
    flag = np.where(kind < 0.03, 0x400, np.where(kind < 0.04, 0x100, 0)).astype(np.uint16)
    flag[(flag == 0) & (rng.random(n) < 0.25)] = 0x10
    mapq = np.where(rng.random(n) < 0.04, 0, 60).astype(np.uint8)
    shape = np.asarray(COVERAGE_SHAPE_CYCLE, np.uint8)[np.arange(n) % len(COVERAGE_SHAPE_CYCLE)]
    return {"seed": seed, "contigs": list(contigs), "genomes": genomes, "ref_id": ref_id, "pos": pos,
            "flag": flag, "mapq": mapq, "shape": shape}


def coverage_quals(reads: dict, lo: int, hi: int) -> np.ndarray:
    """(hi - lo, 150) base qualities of records [lo, hi); ``lo`` a multiple of
    the writer's chunk, so that every writer draws the same values."""
    rng = np.random.default_rng((reads["seed"], lo // _COVERAGE_CHUNK))
    draws = np.frombuffer(rng.bytes((hi - lo) * COVERAGE_READ_LEN), np.uint8)
    return COVERAGE_QUALS[draws].reshape(hi - lo, COVERAGE_READ_LEN)


def _put(buf: np.ndarray, col: int, values: np.ndarray, dtype: str) -> int:
    """Little-endian ``values`` into columns ``col..`` of the byte matrix; the next column."""
    raw = np.ascontiguousarray(values, dtype=dtype).view(np.uint8).reshape(len(values), -1)
    buf[:, col: col + raw.shape[1]] = raw
    return col + raw.shape[1]


def _bam_records(reads: dict, lo: int, hi: int) -> np.ndarray:
    """The BAM records [lo, hi) (``hi - lo`` a multiple of the shape cycle):
    one byte row a cycle of records, each field written as a column."""
    cyc = len(COVERAGE_SHAPE_CYCLE)
    quals = coverage_quals(reads, lo, hi)
    sizes = [4 + 32 + 12 + 4 * len(COVERAGE_SHAPES[s][1]) + COVERAGE_READ_LEN // 2 + COVERAGE_READ_LEN
             for s in COVERAGE_SHAPE_CYCLE]
    rows = (hi - lo) // cyc
    buf = np.empty((rows, sum(sizes)), np.uint8)
    col = 0
    windows = [np.lib.stride_tricks.sliding_window_view(_BAM_NIBBLE[g], COVERAGE_READ_LEN) for g in reads["genomes"]]
    for slot, (s, size) in enumerate(zip(COVERAGE_SHAPE_CYCLE, sizes)):
        idx = np.arange(lo + slot, hi, cyc)
        ops = COVERAGE_SHAPES[s][1]
        col = _put(buf, col, np.full(rows, size - 4), "<i4")
        col = _put(buf, col, reads["ref_id"][idx], "<i4")
        col = _put(buf, col, reads["pos"][idx], "<i4")
        # bin 4680 for every record (the depth walks do not read it), MAPQ, a 12-byte name
        col = _put(buf, col, (4680 << 16) | (reads["mapq"][idx].astype(np.uint32) << 8) | 12, "<u4")
        col = _put(buf, col, (reads["flag"][idx].astype(np.uint32) << 16) | len(ops), "<u4")
        col = _put(buf, col, np.full(rows, COVERAGE_READ_LEN), "<i4")
        col = _put(buf, col, np.tile(np.array([-1, -1, 0], np.int32), (rows, 1)), "<i4")
        digits = (idx[:, None] // 10 ** np.arange(10, dtype=np.int64)[::-1]) % 10
        buf[:, col] = ord("r")
        buf[:, col + 1: col + 11] = digits + ord("0")
        buf[:, col + 11] = 0
        col += 12
        cigar = np.array([(length << 4) | op for op, length in ops], np.uint32)
        col = _put(buf, col, np.tile(cigar, (rows, 1)), "<u4")
        seq = np.empty((rows, COVERAGE_READ_LEN), np.uint8)
        for rid, win in enumerate(windows):
            on = reads["ref_id"][idx] == rid
            seq[on] = win[reads["pos"][idx][on]]
        buf[:, col: col + COVERAGE_READ_LEN // 2] = (seq[:, 0::2] << 4) | seq[:, 1::2]
        col += COVERAGE_READ_LEN // 2
        buf[:, col: col + COVERAGE_READ_LEN] = quals[idx - lo]
        col += COVERAGE_READ_LEN
    return buf.reshape(-1)


def write_coverage_bam(path: str, reads: dict, level: int = 1) -> int:
    """Write the reads as a BGZF BAM (deflated at ``level`` by the native
    engine where it serves); the uncompressed bytes."""
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter
    from variantcalling_tpu_torch.parallel.pipeline import IoPool, imap_ordered

    contigs = reads["contigs"]
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in contigs)
    head = bytearray(b"BAM\x01") + np.int32(len(text)).tobytes() + text.encode() + np.int32(len(contigs)).tobytes()
    for c, ln in contigs:
        head += np.int32(len(c) + 1).tobytes() + c.encode() + b"\x00" + np.int32(ln).tobytes()
    n = len(reads["pos"])
    total = len(head)
    pool = IoPool(_COVERAGE_WRITERS, name="coverage-world")
    try:
        with BgzfWriter(path, level=level) as out:
            out.write(bytes(head))
            # chunks built on the pool (numpy lets go of the GIL), written in order
            bodies = imap_ordered(pool, lambda lo: _bam_records(reads, lo, min(n, lo + _COVERAGE_CHUNK)),
                                  range(0, n, _COVERAGE_CHUNK), window=_COVERAGE_WRITERS)
            for body in bodies:
                total += len(body)
                out.write(memoryview(body))
    finally:
        pool.shutdown()
    return total


def coverage_cram_records(reads: dict) -> list[dict]:
    """The reads (of one contig, in coordinate order) as the records
    ``tests/cram_fixtures.write_cram`` takes: 1-based positions, the CIGAR's
    I, D and S ops as read features, full quality arrays."""
    if len(set(reads["ref_id"].tolist())) > 1:
        raise ValueError("a CRAM of the fixture writer holds one contig")
    n = len(reads["pos"])
    quals = np.concatenate([coverage_quals(reads, lo, min(n, lo + _COVERAGE_CHUNK))
                            for lo in range(0, n, _COVERAGE_CHUNK)]) if n else np.zeros((0, COVERAGE_READ_LEN))
    out = []
    for i in range(n):
        feats, rp = [], 1
        for op, length in COVERAGE_SHAPES[reads["shape"][i]][1]:
            if op == 1:
                feats.append(("I", rp, b"A" * length))
            elif op == 2:
                feats.append(("D", rp, length))
            elif op == 4:
                feats.append(("S", rp, b"N" * length))
            if op in (0, 1, 4):
                rp += length
        out.append({"flag": int(reads["flag"][i]), "pos": int(reads["pos"][i]) + 1, "read_len": COVERAGE_READ_LEN,
                    "mapq": int(reads["mapq"][i]), "name": f"r{i:010d}", "features": feats,
                    "quals": quals[i].tolist()})
    return out


def write_coverage_world(d: str, seed: int, contigs: list[tuple[str, int]] | None = None, depth: float = 30.0,
                         events: tuple = COVERAGE_EVENTS, n_exome: int = 20_000) -> dict:
    """Write the coverage world under ``d``: ``ref.fa`` (+ ``.fai``), the
    aligned ``reads.bam`` (:func:`coverage_reads`), and for ``-c`` an
    exome-like BED of ``n_exome`` intervals of 150-300 bp on the first
    contig, a BED of the planted events, and ``categories.tsv`` naming both.
    Returns the paths, the reads and the uncompressed BAM's bytes."""
    os.makedirs(d, exist_ok=True)
    contigs = list(contigs or [("chr20", 64_444_167), ("chrM", 16_569)])
    reads = coverage_reads(seed, contigs, depth, events)
    fasta = os.path.join(d, "ref.fa")
    _write_fasta(fasta, [(c, g) for (c, _), g in zip(contigs, reads["genomes"])])
    bam = os.path.join(d, "reads.bam")
    nbytes = write_coverage_bam(bam, reads)
    rng = np.random.default_rng(seed + 1)
    first, ln = contigs[0]
    starts = np.sort(rng.choice(ln - 400, size=min(n_exome, (ln - 400) // 400), replace=False))
    ends = starts + rng.integers(150, 301, len(starts))
    exome = os.path.join(d, "exome.bed")
    with open(exome, "w") as fh:
        fh.write("".join(f"{first}\t{s}\t{e}\n" for s, e in zip(starts, ends)))
    planted = os.path.join(d, "events.bed")
    with open(planted, "w") as fh:
        fh.write("".join(f"{first}\t{s}\t{e}\n" for s, e, _ in events if e <= ln))
    cats = os.path.join(d, "categories.tsv")
    with open(cats, "w") as fh:
        fh.write(f"exome\t{exome}\nplanted\t{planted}\n")
    return {"fasta": fasta, "bam": bam, "categories": cats, "reads": reads, "bam_bytes": nbytes}


#: the SEC world of ``chip_smoke.py`` phase 12: BASELINE config 5 (a 100-sample cohort's
#: noise DB) cut to one contig, the filter world's chr20
SEC_WORLD = dict(seed=2031, length=64_444_167, n_pool=60_000, n_samples=100, n_private=10_000, n_heldout=104_000)
#: of the held-out callset: noise records at pool loci, real variants at pool loci
SEC_NOISE_SHARE, SEC_REAL_POOL_SHARE = 34 / 104, 6 / 104
SEC_MULTI_SHARE = 0.05  # records with 2-4 alts
SEC_REPR_SHARE = 0.02  # truth variants written in another form
SEC_ISOLATION = 200  # bp between a planted representation difference and any other variant


def _distinct_positions(rng: np.random.Generator, lo: int, hi: int, n: int, taken: np.ndarray) -> np.ndarray:
    """``n`` sorted distinct positions in [lo, hi), none of them in ``taken`` (sorted)."""
    out = np.zeros(0, dtype=np.int64)
    while len(out) < n:
        cand = np.unique(np.concatenate([out, rng.integers(lo, hi, size=n + n // 8 + 16)]))
        out = cand[~np.isin(cand, taken)]
    return np.sort(rng.choice(out, size=n, replace=False))


def _snv_alt(codes: np.ndarray, shift) -> np.ndarray:
    return _BASES[(codes + shift) % 4]


@functools.cache
def _text_tables() -> tuple[np.ndarray, np.ndarray]:
    """Decimal text of 0..999 and the two-digit fractions 00..99: counts and QUALs by table lookup."""
    return np.char.mod(b"%d", np.arange(1000)), np.char.mod(b"%02d", np.arange(100))


def _int_text(values: np.ndarray) -> np.ndarray:
    """Decimal text of non-negative integers below 1,000."""
    return _text_tables()[0][values]


def _ad_text(ad: np.ndarray, n_alts: np.ndarray) -> np.ndarray:
    """``ref,alt1[,alt2...]`` of each row of ``ad`` (n, 5), ``n_alts`` alts a row."""
    out = _cat(_int_text(ad[:, 0]), b",", _int_text(ad[:, 1])).astype("S40")
    for j in range(2, 5):
        m = n_alts >= j
        if m.any():
            out[m] = _cat(out[m], b",", _int_text(ad[m, j]))
    return out


def _sec_records(rng: np.random.Generator, genome: np.ndarray, pos0: np.ndarray, ref: np.ndarray, alt: np.ndarray,
                 noise_af: np.ndarray | None, hom: np.ndarray, contig: bytes,
                 multi_share: float = SEC_MULTI_SHARE, pos_text: np.ndarray | None = None) -> np.ndarray:
    """VCF record lines (``GT:AD:DP``, about 30x) at ``pos0`` (``pos_text``:
    their 1-based text, where the caller has it): noise where ``noise_af``
    is given (ref-dominant AD, an alt trickle at that AF, GT 0/1), else real
    variants (het or, where ``hom``, hom-alt AD); ``multi_share`` of them
    with 2-4 alts (SNV alts, the fourth an insertion), ``1/2``."""
    n = len(pos0)
    depth = np.clip(rng.poisson(30, n), 8, 999)
    n_alts = np.ones(n, dtype=np.int64)
    multi = rng.random(n) < multi_share
    n_alts[multi] = rng.integers(2, 5, int(multi.sum()))
    ad = np.zeros((n, 5), dtype=np.int64)
    if noise_af is not None:
        ad[:, 1] = np.maximum(rng.binomial(depth, noise_af), 1)
        for j in range(2, 5):
            ad[:, j] = np.where(n_alts >= j, rng.binomial(depth, noise_af / 2), 0)
        gt = np.full(n, b"0/1", dtype="S3")
    else:
        ad[:, 1] = np.where(hom, depth - rng.binomial(depth, 0.02), np.clip(rng.binomial(depth, 0.5), 3, None))
        for j in range(2, 5):
            ad[:, j] = np.where(n_alts >= j, rng.binomial(depth, 0.5 if j == 2 else 0.03), 0)
        gt = np.where(hom, b"1/1", b"0/1").astype("S3")
    ad[:, 0] = np.maximum(depth - ad[:, 1:].sum(axis=1), 0)
    gt[multi] = b"1/2"
    ref, alt = ref.copy(), alt.copy()
    if multi.any():
        base = genome[pos0[multi]]
        ref[multi] = _BASES[base]
        m_alt = _cat(_snv_alt(base, 1), b",", _snv_alt(base, 2))
        k = n_alts[multi]
        m_alt = np.where(k >= 3, _cat(m_alt, b",", _snv_alt(base, 3)), m_alt)
        m_alt = np.where(k >= 4, _cat(m_alt, b",", _BASES[base], _snv_alt(base, 1)), m_alt)
        alt = alt.astype("S16")
        alt[multi] = m_alt
    hundredths = rng.integers(500, 4000, n) if noise_af is not None else rng.integers(3000, 9000, n)
    qual = _cat(_int_text(hundredths // 100), b".", _text_tables()[1][hundredths % 100])  # GATK's two decimals
    dp = _int_text(depth)
    tab = b"\t"
    if pos_text is None:
        pos_text = np.char.mod(b"%d", pos0 + 1)
    return _cat(contig, tab, pos_text, tab, b".", tab, ref, tab, alt, tab, qual, tab, b"PASS",
                tab, b"DP=", dp, tab, b"GT:AD:DP", tab, gt, b":", _ad_text(ad, n_alts), b":", dp)


def _sec_header(contig: str, length: int, sample: str, fmt: bool = True) -> bytes:
    lines = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
             '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">']
    if fmt:
        lines += ['##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
                  '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">']
    lines += [f"##contig=<ID={contig},length={length}>", f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}"]
    return ("\n".join(lines) + "\n").encode()


def _write_lines(path: str, header: bytes, pos0: np.ndarray, lines: np.ndarray) -> None:
    order = np.argsort(pos0, kind="stable")
    with open(path, "wb") as fh:
        fh.write(header)
        if len(lines):
            fh.write(b"\n".join(lines[order].tolist()) + b"\n")


def _pool_alleles(rng: np.random.Generator, genome: np.ndarray, pos0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """REF and ALT of SNVs (75 %) and 1-bp insertions and deletions (12.5 % each)."""
    n = len(pos0)
    kind = rng.random(n)
    base = genome[pos0]
    ref = _BASES[base].astype("S2")
    alt = _snv_alt(base, rng.integers(1, 4, n)).astype("S2")
    ins, dele = (kind >= 0.75) & (kind < 0.875), kind >= 0.875
    alt[ins] = _cat(_BASES[base[ins]], _BASES[rng.integers(0, 4, int(ins.sum()))])
    ref[dele] = _cat(_BASES[base[dele]], _BASES[genome[pos0[dele] + 1]])
    alt[dele] = _BASES[base[dele]]
    return ref, alt


def write_sec_world(d: str, seed: int, length: int = 64_444_167, n_pool: int = 60_000, n_samples: int = 100,
                    n_private: int = 10_000, n_heldout: int = 104_000, contig: str = "chr20") -> dict:
    """Write the SEC world under ``d``: ``ref.fa`` (+ ``.fai``), a cohort of
    ``n_samples`` callsets ``cohort_NNN.vcf`` (``GT:AD:DP`` at about 30x),
    each holding about 70 % of a pool of ``n_pool`` noise loci (SNVs and
    1-bp indels, each locus with its own noise AF of 2-8 %: ref-dominant AD
    and an alt trickle) and ``n_private`` real variants of its own (het or
    hom AD), 5 % of all records with 2-4 alts; a held-out callset
    ``heldout.vcf`` of ``n_heldout`` records (34/104 noise at pool loci,
    6/104 real variants at other pool loci, the rest real variants
    elsewhere) and its truth ``truth.vcf``: the held-out sample's real
    variants, 2 % of them written in another form (a deletion or insertion
    shifted along its homopolymer run, a two-alt record split into two
    records, an MNP split into SNVs: each at least ``SEC_ISOLATION`` bp from
    any other variant), and 3 % more that the callset misses; ``hcr.bed``
    (95 % of the contig), ``exome.bed`` (intervals to annotate) and
    ``pool.bed`` (the pool's loci, for ``--relevant_coords``).

    Returns the paths, the cohort's count of distinct loci, and, 1-based,
    the positions of the planted noise records, the planted real variants
    at pool loci and the planted representation differences (their call
    records' positions)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    genome = _genome(rng, length)
    fasta = os.path.join(d, "ref.fa")
    _write_fasta(fasta, [(contig, genome)])
    cb = contig.encode()
    lo, hi = 100, length - 100

    pool = _distinct_positions(rng, lo, hi, n_pool, np.zeros(0, np.int64))
    pool_ref, pool_alt = _pool_alleles(rng, genome, pool)
    pool_af = rng.uniform(0.02, 0.08, n_pool)
    pool_text = np.char.mod(b"%d", pool + 1)

    samples, loci = [], [pool]
    for s in range(n_samples):
        sel = np.flatnonzero(rng.random(n_pool) < 0.7)
        priv = _distinct_positions(rng, lo, hi, n_private, pool)
        p_ref, p_alt = _pool_alleles(rng, genome, priv)
        noise = _sec_records(rng, genome, pool[sel], pool_ref[sel], pool_alt[sel], pool_af[sel],
                             np.zeros(len(sel), bool), cb, pos_text=pool_text[sel])
        real = _sec_records(rng, genome, priv, p_ref, p_alt, None, rng.random(n_private) < 0.4, cb)
        path = os.path.join(d, f"cohort_{s:03d}.vcf")
        _write_lines(path, _sec_header(contig, length, f"S{s:03d}"), np.concatenate([pool[sel], priv]),
                     np.concatenate([noise, real]))
        samples.append(path)
        loci.append(priv)

    # the held-out sample
    n_noise, n_real_pool = int(round(n_heldout * SEC_NOISE_SHARE)), int(round(n_heldout * SEC_REAL_POOL_SHARE))
    if n_noise + n_real_pool > n_pool:
        raise ValueError(f"a held-out callset of {n_heldout} records needs a pool of {n_noise + n_real_pool} loci")
    at_pool = rng.permutation(n_pool)[: n_noise + n_real_pool]
    noise_i, real_i = np.sort(at_pool[:n_noise]), np.sort(at_pool[n_noise:])
    n_priv = n_heldout - n_noise - n_real_pool
    n_repr = max(3, int(round((n_real_pool + n_priv) * SEC_REPR_SHARE)))
    priv = _distinct_positions(rng, lo, hi, n_priv - n_repr, pool)
    n_fn = int(round((n_real_pool + n_priv) * 0.03))
    fn_pos = _distinct_positions(rng, lo, hi, n_fn, np.union1d(pool, priv))

    # hcr: 95 % of the contig, a gap of 5 % in each of its segments
    n_seg = max(1, length // 64_000)
    edges = np.linspace(0, length, n_seg + 1).astype(np.int64)
    gap_len = (np.diff(edges) * 0.05).astype(np.int64)
    gap_start = edges[:-1] + (rng.random(n_seg) * (np.diff(edges) - gap_len)).astype(np.int64)
    hcr = np.stack([np.concatenate([edges[:-1], gap_start + gap_len]),
                    np.concatenate([gap_start, edges[1:]])], axis=1)
    hcr = hcr[np.argsort(hcr[:, 0])]
    hcr = hcr[hcr[:, 1] > hcr[:, 0]]

    # the planted representation differences: isolated, inside the hcr
    taken = np.unique(np.concatenate([pool, priv, fn_pos]))
    runs = np.flatnonzero((genome[1:-3] != genome[:-4]) & (genome[1:-3] == genome[2:-2])
                          & (genome[1:-3] == genome[3:-1]) & (genome[1:-3] == genome[4:])) + 1  # run starts, length >= 4
    runs = runs[(runs > lo + 1) & (runs < hi - 8)]

    def isolated(cand: np.ndarray) -> np.ndarray:
        at = np.searchsorted(taken, cand)
        near = np.minimum(np.abs(cand - taken[np.clip(at - 1, 0, len(taken) - 1)]),
                          np.abs(taken[np.clip(at, 0, len(taken) - 1)] - cand))
        h = np.searchsorted(hcr[:, 0], cand, side="right") - 1
        in_hcr = (h >= 0) & (cand + 4 < hcr[np.maximum(h, 0), 1]) & (cand - 1 >= hcr[np.maximum(h, 0), 0])
        return cand[(near >= SEC_ISOLATION) & in_hcr]

    k_shift = n_repr // 3
    shift_at = np.sort(rng.choice(isolated(runs - 1), size=k_shift, replace=False))  # the base before the run
    taken = np.union1d(taken, shift_at)
    rest = np.zeros(0, dtype=np.int64)
    for _ in range(64):  # isolated draws, pairwise too
        rest = np.unique(np.concatenate([rest, isolated(rng.integers(lo, hi - 8, size=8 * n_repr + 64))]))
        gaps = np.diff(rest)
        rest = rest[np.concatenate([[True], gaps >= SEC_ISOLATION]) & np.concatenate([gaps >= SEC_ISOLATION, [True]])]
        if len(rest) >= n_repr - k_shift:
            break
    k_split = (n_repr - k_shift) // 2
    pick = rng.choice(len(rest), size=n_repr - k_shift, replace=False)
    split_at, mnp_at = np.sort(rest[pick[:k_split]]), np.sort(rest[pick[k_split:]])

    # the held-out callset's records
    h_lines, h_pos = [], []
    h_lines.append(_sec_records(rng, genome, pool[noise_i], pool_ref[noise_i], pool_alt[noise_i], pool_af[noise_i],
                                np.zeros(n_noise, bool), cb))
    h_pos.append(pool[noise_i])
    real_hom = rng.random(n_real_pool) < 0.4
    h_lines.append(_sec_records(rng, genome, pool[real_i], pool_ref[real_i], pool_alt[real_i], None, real_hom, cb,
                                multi_share=0.0))
    h_pos.append(pool[real_i])
    p_ref, p_alt = _pool_alleles(rng, genome, priv)
    p_hom = rng.random(len(priv)) < 0.4
    h_lines.append(_sec_records(rng, genome, priv, p_ref, p_alt, None, p_hom, cb, multi_share=0.0))
    h_pos.append(priv)
    # planted: a deletion of one run base anchored before the run (call) and inside it (truth); an
    # insertion of the run base the same way for every other one
    shift_ins = np.arange(k_shift) % 2 == 1
    a, run_base = genome[shift_at], genome[shift_at + 1]
    s_ref = np.where(shift_ins, _BASES[a], _cat(_BASES[a], _BASES[run_base]))
    s_alt = np.where(shift_ins, _cat(_BASES[a], _BASES[run_base]), _BASES[a])
    t_ref = np.where(shift_ins, _BASES[run_base], _cat(_BASES[run_base], _BASES[run_base]))
    t_alt = np.where(shift_ins, _cat(_BASES[run_base], _BASES[run_base]), _BASES[run_base])
    s_hom = rng.random(k_shift) < 0.4
    h_lines.append(_sec_records(rng, genome, shift_at, s_ref, s_alt, None, s_hom, cb, multi_share=0.0))
    h_pos.append(shift_at)
    sb = genome[split_at]
    split_rec = _cat(cb, b"\t", np.char.mod(b"%d", split_at + 1), b"\t.\t", _BASES[sb], b"\t",
                     _snv_alt(sb, 1), b",", _snv_alt(sb, 2), b"\t50.00\tPASS\tDP=30\tGT:AD:DP\t1/2:2,14,14:30")
    h_lines.append(split_rec)
    h_pos.append(split_at)
    mb0, mb1 = genome[mnp_at], genome[mnp_at + 1]
    mnp_rec = _cat(cb, b"\t", np.char.mod(b"%d", mnp_at + 1), b"\t.\t", _BASES[mb0], _BASES[mb1], b"\t",
                   _snv_alt(mb0, 1), _snv_alt(mb1, 2), b"\t50.00\tPASS\tDP=30\tGT:AD:DP\t1/1:1,29:30")
    h_lines.append(mnp_rec)
    h_pos.append(mnp_at)
    heldout = os.path.join(d, "heldout.vcf")
    _write_lines(heldout, _sec_header(contig, length, "HG001"), np.concatenate(h_pos), np.concatenate(h_lines))

    # its truth: the real variants as called (GT only), the planted ones in their other form, and the misses
    def truth_lines(pos0, ref, alt, gt):
        return _cat(cb, b"\t", np.char.mod(b"%d", pos0 + 1), b"\t.\t", ref, b"\t", alt, b"\t50\tPASS\t.\tGT\t", gt)

    hom_gt = lambda hom: np.where(hom, b"1/1", b"0/1")  # noqa: E731
    t_pos, t_lines = [pool[real_i], priv], []
    t_lines.append(truth_lines(pool[real_i], pool_ref[real_i], pool_alt[real_i], hom_gt(real_hom)))
    t_lines.append(truth_lines(priv, p_ref, p_alt, hom_gt(p_hom)))
    t_pos.append(shift_at + 1)
    t_lines.append(truth_lines(shift_at + 1, t_ref, t_alt, hom_gt(s_hom)))
    for j in (1, 2):
        t_pos.append(split_at)
        t_lines.append(truth_lines(split_at, _BASES[sb], _snv_alt(sb, j), np.full(len(sb), b"0/1")))
    for off, code, j in ((0, mb0, 1), (1, mb1, 2)):
        t_pos.append(mnp_at + off)
        t_lines.append(truth_lines(mnp_at + off, _BASES[code], _snv_alt(code, j), np.full(len(mnp_at), b"1/1")))
    f_ref, f_alt = _pool_alleles(rng, genome, fn_pos)
    t_pos.append(fn_pos)
    t_lines.append(truth_lines(fn_pos, f_ref, f_alt, hom_gt(rng.random(n_fn) < 0.4)))
    truth = os.path.join(d, "truth.vcf")
    _write_lines(truth, _sec_header(contig, length, "HG001", fmt=False), np.concatenate(t_pos),
                 np.concatenate(t_lines))

    paths = {name: os.path.join(d, f"{name}.bed") for name in ("hcr", "exome", "pool")}
    with open(paths["hcr"], "w") as fh:
        fh.write("".join(f"{contig}\t{s}\t{e}\n" for s, e in hcr.tolist()))
    starts = np.sort(rng.choice(length - 400, size=min(20_000, (length - 400) // 400), replace=False))
    with open(paths["exome"], "w") as fh:
        fh.write("".join(f"{contig}\t{s}\t{e}\n" for s, e in zip(starts.tolist(),
                                                                (starts + rng.integers(150, 301, len(starts))).tolist())))
    with open(paths["pool"], "w") as fh:
        fh.write("".join(f"{contig}\t{p}\t{p + 1}\n" for p in pool.tolist()))
    return {"fasta": fasta, "samples": samples, "heldout": heldout, "truth": truth, **paths,
            "noise_pos": pool[noise_i] + 1, "real_pool_pos": pool[real_i] + 1,
            "repr_pos": np.sort(np.concatenate([shift_at, split_at, mnp_at])) + 1,
            "cohort_loci": len(np.unique(np.concatenate(loci)))}


# -- the genotype, imputation, gVCF and runs worlds of ``chip_smoke.py`` phase 13 ---------------------------------

#: a beagle-annotated 30x chr20 callset at the filter world's density, with planted imputation flips,
#: and the two-contig cut of the ``--input_vcf`` stage chain
IMPUTE_WORLD = dict(seed=2033, length=64_444_167, n_records=104_000, n_flips=2_000, chain_records=3_000)
#: a male 30x callset: chrX and chrY records inside and outside hg38's non-PAR spans
HAPLOID_WORLD = dict(seed=2034, n_x=150_000, n_y=5_000)
#: a single-sample 30x gVCF of chr20: reference blocks of about 40 bp and the variant records
GVCF_WORLD = dict(seed=2035, length=64_444_167, n_variants=104_000, mean_block=40)
#: a joint trio callset of chr20, about 1 % de novo, and two child-against-parent somatic callsets
TRIO_WORLD = dict(seed=2036, length=64_444_167, n_sites=104_000, n_somatic=20_000)
#: a FASTA of chr20's length and a short second contig, with planted homopolymer runs
RUNS_WORLD = dict(seed=2037, contigs=(("chr20", 64_444_167), ("chrM", 16_569)), n_runs=60_000)

GRCH38_CHRX, GRCH38_CHRY = 156_040_895, 57_227_415
_ACGTN = np.frombuffer(b"ACGTN", dtype="S1")


def _text(values) -> np.ndarray:
    """Decimal text of non-negative integers, by table lookup a group of three digits."""
    v = np.asarray(values, dtype=np.int64)
    out = _text_tables()[0][v % 1000].astype("S20")
    big = v >= 1000
    if big.any():
        out[big] = _cat(_text(v[big] // 1000), _padded3()[v[big] % 1000])
    return out


@functools.cache
def _padded3() -> np.ndarray:
    return np.char.mod(b"%03d", np.arange(1000))


def _join_ints(m: np.ndarray) -> np.ndarray:
    """``a,b,c`` text of each row of an int matrix."""
    out = _text(m[:, 0]).astype("S64")
    for j in range(1, m.shape[1]):
        out = _cat(out, b",", _text(m[:, j]))
    return out


def _genotype_pls(rng: np.random.Generator, n_alts: int, best: np.ndarray, span: int) -> np.ndarray:
    """(n, G) integer PLs: 0 at each row's ``best`` genotype index, the others
    drawn up to ``span`` (the second smallest at least 1)."""
    g = (n_alts + 1) * (n_alts + 2) // 2
    n = len(best)
    pl = rng.integers(1, span + 1, (n, g))
    near = rng.random(n) < 0.3  # a third of the calls with a close second genotype
    pl[near] = rng.integers(1, 60, (int(near.sum()), g))
    pl[np.arange(n), best] = 0
    return pl


def _gq_of(pl: np.ndarray) -> np.ndarray:
    srt = np.sort(pl, axis=1)
    return np.minimum(srt[:, 1] - srt[:, 0], 99)


def _impute_records(rng: np.random.Generator, contig: bytes, pos0: np.ndarray, n_flips: int,
                    with_ds: bool = True) -> tuple[np.ndarray, int]:
    """Record lines (``GT:GQ:DP:AD:PL:DS``; ``GT:GQ:DP:AD:PL`` without DS) of
    the imputation world, and how many planted flips they hold."""
    n = len(pos0)
    n_alts = np.where(rng.random(n) < 0.85, 1, np.where(rng.random(n) < 0.67, 2, 3))
    ref_c = rng.integers(0, 4, n)
    alt = _BASES[(ref_c + 1) % 4].astype("S8")
    for j in (2, 3):
        m = n_alts >= j
        alt[m] = _cat(alt[m], b",", _BASES[(ref_c[m] + j) % 4])
    kind = rng.random(n)
    # genotypes: het 0/1 (or 1/2 with more alts), hom-alt, hom-ref, no-call, half-missing, haploid
    gt = np.where(n_alts > 1, b"1/2", b"0/1").astype("S4")
    gt[(kind >= 0.55) & (kind < 0.87)] = b"1/1"
    gt[(kind >= 0.87) & (kind < 0.92)] = b"0/0"
    gt[(kind >= 0.92) & (kind < 0.94)] = b"./."
    gt[(kind >= 0.94) & (kind < 0.96)] = b"./1"
    gt[(kind >= 0.96) & (kind < 0.98)] = b"1"
    best = np.zeros(n, dtype=np.int64)  # genotype index of the smallest PL
    best[gt == b"0/1"] = 1
    best[gt == b"1/1"] = 2
    best[gt == b"1/2"] = 4
    ds = np.zeros((n, 3))
    ds[:, 0] = np.where(gt == b"1/1", rng.uniform(1.9, 2.0, n), rng.uniform(0.9, 1.1, n))
    ds[:, 1:] = rng.uniform(0.9, 1.1, (n, 2))
    ds[gt == b"0/0", 0] = rng.uniform(0.0, 0.1, int((gt == b"0/0").sum()))
    # planted flips: biallelic het calls whose hom-alt PL lies 1-12 above theirs and a hom dosage
    het = np.flatnonzero((gt == b"0/1") & (n_alts == 1))
    flips = np.sort(rng.choice(het, size=min(n_flips, len(het) // 4), replace=False)) if with_ds else het[:0]
    # conflicting but strong: het calls with a hom dosage and a hom-alt margin of 60 or more
    strong = np.setdiff1d(het, flips)[: len(flips)]
    pl_text = np.empty(n, dtype="S64")
    gq_text = np.empty(n, dtype="S4")
    for a in (1, 2, 3):
        m = np.flatnonzero(n_alts == a)
        pl = _genotype_pls(rng, a, best[m], 2_000)
        if a == 1:
            in_m = np.searchsorted(m, flips)
            pl[in_m, 2] = rng.integers(1, 13, len(flips))
            pl[in_m, 0] = rng.integers(40, 2_000, len(flips))
            in_s = np.searchsorted(m, strong)
            pl[in_s, 2] = rng.integers(60, 2_000, len(strong))
        pl_text[m] = _join_ints(pl)
        gq_text[m] = _text(_gq_of(pl))
    ds[flips, 0] = rng.uniform(1.97, 2.0, len(flips))
    ds[strong, 0] = rng.uniform(1.97, 2.0, len(strong))
    dp = rng.integers(15, 60, n)
    ad_ref = rng.binomial(dp, 0.5)
    ad = _cat(_text(ad_ref), b",", _text(dp - ad_ref)).astype("S32")
    for j in (2, 3):
        m = n_alts >= j
        ad[m] = _cat(ad[m], b",", _text(rng.integers(0, 20, int(m.sum()))))
    ds_text = np.char.mod(b"%.3f", ds[:, 0]).astype("S32")
    for j in (2, 3):
        m = n_alts >= j
        ds_text[m] = _cat(ds_text[m], b",", np.char.mod(b"%.3f", ds[m, j - 1]))
    no_ds = (rng.random(n) < 0.2) | (not with_ds)
    no_ds[flips] = no_ds[strong] = False
    fmt = np.where(no_ds, b"GT:GQ:DP:AD:PL", b"GT:GQ:DP:AD:PL:DS")
    sample = _cat(gt, b":", gq_text, b":", _text(dp), b":", ad, b":", pl_text)
    sample = np.where(no_ds, sample, _cat(sample, b":", ds_text))
    filt = np.where(rng.random(n) < 0.05, b"LowQual", b"PASS")
    filt[flips] = filt[strong] = b"PASS"
    qual = np.char.mod(b"%.1f", rng.uniform(20, 900, n))
    tab = b"\t"
    lines = _cat(contig, tab, _text(pos0 + 1), tab, b".", tab, _BASES[ref_c], tab, alt, tab, qual, tab, filt, tab,
                 b"DP=", _text(dp), tab, fmt, tab, sample)
    return lines, len(flips)


def _impute_header(contigs: list[tuple[str, int]], with_ds: bool = True) -> bytes:
    lines = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
             '##FILTER=<ID=LowQual,Description="Low quality">',
             '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
             '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
             '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">']
    if with_ds:
        lines.append('##FORMAT=<ID=DS,Number=A,Type=Float,Description="Genotype dosage from beagle">')
    lines += [f"##contig=<ID={c},length={ln}>" for c, ln in contigs]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tHG002")
    return ("\n".join(lines) + "\n").encode()


#: the stub of beagle for the ``--input_vcf`` stage chain: it reads ``gt=``, and writes ``out=``.vcf.gz with
#: phased GTs, a dosage a record (hom-alt where the 1-based position is a multiple of 3, else het) and DR2/IMP
BEAGLE_STUB = """#!/usr/bin/env python3
import gzip, sys
kw = dict(a.split('=', 1) for a in sys.argv[1:] if '=' in a)
opener = gzip.open if kw['gt'].endswith('.gz') else open
out = []
with opener(kw['gt'], 'rt') as fh:
    for line in fh:
        if line.startswith('##'):
            out.append(line)
        elif line.startswith('#'):
            out.append('##FORMAT=<ID=DS,Number=A,Type=Float,Description="d">\\n')
            out.append('##INFO=<ID=DR2,Number=1,Type=Float,Description="r">\\n')
            out.append('##INFO=<ID=IMP,Number=0,Type=Flag,Description="i">\\n')
            out.append(line)
        else:
            f = line.rstrip('\\n').split('\\t')
            hom = int(f[1]) % 3 == 0
            f[7] = 'DR2=0.%02d' % (int(f[1]) % 100) + (';IMP' if int(f[1]) % 2 else '')
            f[8] = 'GT:DS'
            f[9] = ('1|1:1.98' if hom else '0|1:1.01')
            out.append('\\t'.join(f) + '\\n')
with gzip.open(kw['out'] + '.vcf.gz', 'wt') as fh:
    fh.writelines(out)
"""


def write_impute_world(d: str, seed: int, length: int = 64_444_167, n_records: int = 104_000, n_flips: int = 2_000,
                       chain_records: int = 3_000) -> dict:
    """Write the imputation world under ``d``.

    ``annotated.vcf``: ``n_records`` chr20 records (``GT:GQ:DP:AD:PL:DS``,
    1-3 alts in 85/10/5 %, PLs drawn up to 2,000 so that spans pass the
    350 clamp, GQ from the PLs), about 5 % LowQual, 20 % without DS, and
    no-call, half-missing (``./1``) and haploid GTs among them; ``n_flips``
    planted biallelic het calls with a hom-alt PL 1-12 above theirs and a
    dosage of 1.97-2.0, which the rewrite must flip to 1/1, and as many
    conflicting calls with a margin of 60 or more, which it must not flip
    (nor a rerun). ``chain.vcf``: a two-contig cut without DS (chr20 and
    chr21, ``chain_records`` each) for the ``--input_vcf`` stage chain, its
    JSON maps, fake cohort and map files, and ``beagle_stub.py``
    (:data:`BEAGLE_STUB`). Returns the paths and the planted flips."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    pos0 = _distinct_positions(rng, 100, length - 100, n_records, np.zeros(0, np.int64))
    lines, flips = _impute_records(rng, b"chr20", pos0, n_flips)
    annotated = os.path.join(d, "annotated.vcf")
    _write_lines(annotated, _impute_header([("chr20", length)]), pos0, lines)

    chain_contigs = [("chr20", min(length, 2_000_000)), ("chr21", 2_000_000)]
    parts, positions = [], []
    for c, ln in chain_contigs:
        p = _distinct_positions(rng, 100, ln - 100, chain_records, np.zeros(0, np.int64))
        recs, _ = _impute_records(rng, c.encode(), p, 0, with_ds=False)
        parts.append(recs[np.argsort(p)])
        positions.append(p)
    chain = os.path.join(d, "chain.vcf")
    with open(chain, "wb") as fh:
        fh.write(_impute_header(chain_contigs, with_ds=False))
        fh.write(b"\n".join(np.concatenate(parts).tolist()) + b"\n")
    stub = os.path.join(d, "beagle_stub.py")
    with open(stub, "w") as fh:
        fh.write(BEAGLE_STUB)
    maps = {}
    for name in ("cohort", "plink"):
        maps[name] = {}
        for c, _ in chain_contigs:
            path = os.path.join(d, f"{name}.{c}" + (".vcf.gz" if name == "cohort" else ".map"))
            with open(path, "wb") as fh:
                fh.write(b"placeholder: the stub of beagle reads neither cohort nor map\n")
            maps[name][c] = path
        with open(os.path.join(d, f"{name}.json"), "w") as fh:
            json.dump(maps[name], fh)
    return {"annotated": annotated, "flips": flips, "n_records": n_records, "chain": chain, "beagle_stub": stub,
            "cohort_json": os.path.join(d, "cohort.json"), "plink_json": os.path.join(d, "plink.json")}


def write_haploid_world(d: str, seed: int, n_x: int = 150_000, n_y: int = 5_000) -> dict:
    """Write a male callset ``calls.vcf`` (``GT:GQ:DP:PL``) of ``n_x`` chrX and
    ``n_y`` chrY records at GRCh38's lengths, inside and outside hg38's
    non-PAR spans (the PARs and the spans' edges included): 1-3 alts, PL
    spans drawn up to 2,000 (past the 350 clamp), no-calls, records without
    GQ, and records already haploid (GT ``1``, two PLs); QUAL as ``%g``
    writes it, so that a record the tool leaves alone keeps its bytes. And
    ``regions.bed``: 40 intervals of 0.5-2 Mbp on both contigs. Returns the paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    lines, positions, chroms = [], [], []
    edges = {"chrX": [10_001, 2_781_479, 155_701_383, 156_030_895, 156_040_895], "chrY": [10_001, 2_781_479, 56_887_903]}
    for contig, ln, n in (("chrX", GRCH38_CHRX, n_x), ("chrY", GRCH38_CHRY, n_y)):
        at_edges = np.asarray([e + k for e in edges[contig] for k in (-1, 0, 1) if 100 <= e + k < ln - 100]) - 1
        pos0 = _distinct_positions(rng, 100, ln - 100, n - len(at_edges), at_edges)
        pos0 = np.sort(np.concatenate([pos0, at_edges]))
        m = len(pos0)
        n_alts = np.where(rng.random(m) < 0.85, 1, np.where(rng.random(m) < 0.67, 2, 3))
        ref_c = rng.integers(0, 4, m)
        alt = _BASES[(ref_c + 1) % 4].astype("S8")
        for j in (2, 3):
            mm = n_alts >= j
            alt[mm] = _cat(alt[mm], b",", _BASES[(ref_c[mm] + j) % 4])
        kind = rng.random(m)
        gt = np.where(n_alts > 1, b"1/2", np.where(kind < 0.5, b"1/1", b"0/1")).astype("S4")
        gt[(kind >= 0.9) & (kind < 0.95)] = b"./."
        best = np.where(gt == b"1/1", 2, np.where(gt == b"1/2", 4, np.where(gt == b"0/1", 1, 0)))
        pl_text = np.empty(m, dtype="S64")
        gq_text = np.empty(m, dtype="S4")
        for a in (1, 2, 3):
            mm = np.flatnonzero(n_alts == a)
            pl = _genotype_pls(rng, a, best[mm], 2_000)
            pl_text[mm] = _join_ints(pl)
            gq_text[mm] = _text(_gq_of(pl))
        haploid = (kind >= 0.95) & (n_alts == 1)  # already haploid: GT 1 and two PLs
        gt[haploid] = b"1"
        pl_text[haploid] = _cat(_text(rng.integers(20, 900, int(haploid.sum()))), b",0")
        dp = _text(rng.integers(15, 60, m))
        no_gq = rng.random(m) < 0.05
        fmt = np.where(no_gq, b"GT:DP:PL", b"GT:GQ:DP:PL")
        sample = np.where(no_gq, _cat(gt, b":", dp, b":", pl_text), _cat(gt, b":", gq_text, b":", dp, b":", pl_text))
        q = rng.integers(200, 9000, m)
        qual = np.where(q % 10 == 0, _text(q // 10), _cat(_text(q // 10), b".", _text(q % 10)))
        tab = b"\t"
        lines.append(_cat(contig.encode(), tab, _text(pos0 + 1), tab, b".", tab, _BASES[ref_c], tab, alt, tab, qual,
                          tab, b"PASS", tab, b"DP=", dp, tab, fmt, tab, sample))
        positions.append(pos0)
        chroms.append(contig)
    header = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
              '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
              '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
              '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
              '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
              f"##contig=<ID=chrX,length={GRCH38_CHRX}>", f"##contig=<ID=chrY,length={GRCH38_CHRY}>",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tHG002"]
    vcf = os.path.join(d, "calls.vcf")
    with open(vcf, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        fh.write(b"\n".join(np.concatenate(lines).tolist()) + b"\n")
    bed = os.path.join(d, "regions.bed")
    with open(bed, "w") as fh:
        for contig, ln, k in (("chrX", GRCH38_CHRX, 30), ("chrY", GRCH38_CHRY, 10)):
            starts = np.sort(rng.choice(ln // 2_500_000, size=k, replace=False)) * 2_500_000
            for s in starts.tolist():
                fh.write(f"{contig}\t{s}\t{s + int(rng.integers(500_000, 2_000_001))}\n")
    return {"vcf": vcf, "bed": bed, "n": n_x + n_y}


def _gvcf_header(contig: str, length: int, sample: str = "HG002") -> bytes:
    lines = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
             '##FILTER=<ID=RefCall,Description="Genotyping model thinks this site is reference.">',
             '##INFO=<ID=END,Number=1,Type=Integer,Description="End position (for use with symbolic alleles)">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Conditional genotype quality">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
             '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP observed within the GVCF block.">',
             '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Read depth for each allele">',
             '##FORMAT=<ID=VAF,Number=A,Type=Float,Description="Variant allele fractions.">',
             '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
             f"##contig=<ID={contig},length={length}>",
             f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}"]
    return ("\n".join(lines) + "\n").encode()


def write_gvcf_world(d: str, seed: int, length: int = 64_444_167, n_variants: int = 104_000,
                     mean_block: int = 40, contig: str = "chr20") -> dict:
    """Write ``sample.g.vcf``, a single-sample 30x gVCF of a synthetic chr20
    (the filter world's genome model), as DeepVariant writes one.

    Reference blocks (``<*>``, ``END=``, ``GT:GQ:MIN_DP:PL``) tile every
    base no variant covers, cut at random points about ``mean_block`` bp
    apart; their GQ wanders (a random walk of step 0-4 in 1-99), 2 % are
    uncalled (``./.``, GQ 0). ``n_variants`` variant records on a 16-bp
    grid (``GT:GQ:DP:AD:VAF:PL``, six PLs: ``ALT,<*>`` or, for 10 %, two
    real alts): 80 % PASS SNVs, insertions and deletions of 1-4 bp (called
    0/1, 1/1 or 1/2), 20 % RefCall (``./.`` or ``0/0``, GQ 0-40), a third
    of those deletions. After each called deletion, one or two uncalled
    ``./.`` blocks inside its span: the records ``cleanup_gvcf_before_calling``
    must drop. Returns the path, the record count and the planted drops."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    genome = _genome(rng, length)
    slots = np.sort(rng.choice((length - 2_000) // 16, size=n_variants, replace=False))
    vpos = 1_000 + slots * 16 + rng.integers(0, 8, n_variants)  # 0-based
    n = n_variants
    refcall = rng.random(n) < 0.2
    kind = rng.random(n)
    dele = np.where(refcall, kind < 0.33, kind >= 0.85)
    ins = ~dele & ~refcall & (kind >= 0.75)
    dlen = np.where(dele, rng.integers(1, 5, n), 0)
    base = genome[vpos]
    ref = _BASES[base].astype("S8")
    for j in range(1, 5):
        m = dlen >= j
        ref[m] = _cat(ref[m], _BASES[genome[vpos[m] + j]])
    shift = rng.integers(1, 4, n)
    alt = _BASES[(base + shift) % 4].astype("S16")
    alt[dele] = _BASES[base[dele]]
    alt[ins] = _cat(_BASES[base[ins]], _BASES[rng.integers(0, 4, int(ins.sum()))])
    two_real = ~refcall & ~dele & ~ins & (rng.random(n) < 0.1)
    alts = _cat(alt, b",", np.where(two_real, _BASES[(base + shift % 3 + 1) % 4], b"<*>"))
    gt = np.where(refcall, np.where(rng.random(n) < 0.5, b"./.", b"0/0"),
                  np.where(two_real, b"1/2", np.where(rng.random(n) < 0.6, b"0/1", b"1/1"))).astype("S4")
    best = np.select([gt == b"0/1", gt == b"1/1", gt == b"1/2"], [1, 2, 4], 0)
    pl = _genotype_pls(rng, 2, best, 990)
    gq = np.where(refcall, rng.integers(0, 41, n), _gq_of(pl))
    dp = rng.integers(15, 60, n)
    ad_alt = np.where(gt == b"1/1", dp - rng.integers(0, 3, n), rng.binomial(dp, 0.5))
    ad_alt = np.where(refcall, rng.integers(0, 4, n), ad_alt)
    ad = _cat(_text(dp - ad_alt), b",", _text(ad_alt), b",0")
    vaf = np.char.mod(b"%.6g", ad_alt / dp)
    vaf = np.where(two_real, _cat(vaf, b",", np.char.mod(b"%.6g", np.zeros(n))), _cat(vaf, b",0"))
    q = np.where(refcall, 0, rng.integers(30, 900, n))
    qual = np.where(q % 10 == 0, _text(q // 10), _cat(_text(q // 10), b".", _text(q % 10)))
    filt = np.where(refcall, b"RefCall", b"PASS")
    tab = b"\t"
    cb = contig.encode()
    var_lines = _cat(cb, tab, _text(vpos + 1), tab, b".", tab, ref, tab, alts, tab, qual, tab, filt, tab, b".", tab,
                     b"GT:GQ:DP:AD:VAF:PL", tab, gt, b":", _text(gq), b":", _text(dp), b":", ad, b":", vaf, b":",
                     _join_ints(pl))

    # the planted uncalled blocks inside each called deletion's span
    called_del = dele & ~refcall
    k_planted = np.where(called_del, np.minimum(dlen, rng.integers(1, 3, n)), 0)
    p_pos = np.concatenate([vpos[k_planted >= j] + j for j in (1, 2)])
    p_lines = _cat(cb, tab, _text(p_pos + 1), tab, b".", tab, _BASES[genome[p_pos]], tab, b"<*>", tab, b"0", tab, b".",
                   tab, b"END=", _text(p_pos + 1), tab, b"GT:GQ:MIN_DP:PL", tab, b"./.:0:0:0,0,0")

    # reference blocks over every base no variant covers, cut at random points
    covered = np.zeros(length, dtype=bool)
    reflen = dlen + 1
    for j in range(5):
        m = reflen > j
        covered[vpos[m] + j] = True
    cut = np.zeros(length, dtype=bool)
    cut[rng.integers(0, length, length // mean_block)] = True
    free = ~covered
    start_mask = free.copy()
    start_mask[1:] &= cut[1:] | covered[:-1]
    b_start = np.flatnonzero(start_mask)
    end_mask = free.copy()
    end_mask[:-1] &= start_mask[1:] | covered[1:]
    b_end = np.flatnonzero(end_mask)
    del covered, cut, free, start_mask, end_mask
    nb = len(b_start)
    steps = rng.integers(-4, 5, nb)
    b_gq = np.clip(45 + np.cumsum(steps) % 160 - 80, 1, 99)  # a walk folded into 1-99
    uncalled = rng.random(nb) < 0.02
    b_gq = np.where(uncalled, 0, b_gq)
    b_dp = np.where(uncalled, 0, rng.integers(10, 50, nb))
    b_pl = np.where(uncalled[:, None], 0, np.stack([np.zeros(nb, np.int64), b_gq, b_gq * 10 + rng.integers(0, 30, nb)], 1))
    b_lines = _cat(cb, tab, _text(b_start + 1), tab, b".", tab, _BASES[genome[b_start]], tab, b"<*>", tab, b"0", tab,
                   b".", tab, b"END=", _text(b_end + 1), tab, b"GT:GQ:MIN_DP:PL", tab,
                   np.where(uncalled, b"./.", b"0/0"), b":", _text(b_gq), b":", _text(b_dp), b":", _join_ints(b_pl))
    path = os.path.join(d, "sample.g.vcf")
    pos_all = np.concatenate([vpos, p_pos, b_start])
    _write_lines(path, _gvcf_header(contig, length), pos_all, np.concatenate([var_lines, p_lines, b_lines]))
    return {"gvcf": path, "n_records": len(pos_all), "planted_drops": int(k_planted.sum()), "n_blocks": nb,
            "n_variants": n, "contig": contig, "length": length}


def write_trio_world(d: str, seed: int, length: int = 64_444_167, n_sites: int = 104_000, n_somatic: int = 20_000,
                     child: str = "HG002") -> dict:
    """Write a joint trio callset ``trio.vcf`` (child, mother, father;
    ``GT:GQ:DP``) of ``n_sites`` chr20 sites, about 1 % of them de novo in
    the child (INFO ``hiConfDeNovo`` or ``loConfDeNovo``), and the
    child-against-mother and child-against-father somatic callsets of
    ``n_somatic`` records each, holding about 90 % of the de novo loci (a
    few with QUAL ``.``) and other loci, with their JSON maps. Returns the
    paths and, for each de novo record, its position and the expected
    ``DENOVO_QUAL``: the smaller of the two somatic QUALs, 0 for a callset
    that lacks the locus or has no QUAL."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    pos0 = _distinct_positions(rng, 100, length - 100, n_sites, np.zeros(0, np.int64))
    n = n_sites
    ref_c = rng.integers(0, 4, n)
    denovo = rng.random(n) < 0.01
    hi = denovo & (rng.random(n) < 0.6)
    info = np.where(hi, _cat(b"hiConfDeNovo=", child.encode()),
                    np.where(denovo, _cat(b"loConfDeNovo=", child.encode()), b"DP=30"))
    gts = np.where(denovo[:, None], np.array([b"0/1", b"0/0", b"0/0"]),
                   np.array([b"0/1", b"0/1", b"0/0"])[rng.permutation(3)][None, :])
    samples = [_cat(gts[:, k], b":", _text(rng.integers(10, 99, n)), b":", _text(rng.integers(15, 60, n)))
               for k in range(3)]
    qual = np.char.mod(b"%.2f", rng.uniform(20, 900, n))
    tab = b"\t"
    lines = _cat(b"chr20", tab, _text(pos0 + 1), tab, b".", tab, _BASES[ref_c], tab, _BASES[(ref_c + 1) % 4], tab,
                 qual, tab, b"PASS", tab, info, tab, b"GT:GQ:DP", tab, samples[0], tab, samples[1], tab, samples[2])
    header = ["##fileformat=VCFv4.2", '##FILTER=<ID=PASS,Description="All filters passed">',
              '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
              '##INFO=<ID=hiConfDeNovo,Number=.,Type=String,Description="High confidence de novo samples">',
              '##INFO=<ID=loConfDeNovo,Number=.,Type=String,Description="Low confidence de novo samples">',
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
              '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
              '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
              f"##contig=<ID=chr20,length={length}>",
              f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{child}\tHG004\tHG003"]
    trio = os.path.join(d, "trio.vcf")
    with open(trio, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        fh.write(b"\n".join(lines.tolist()) + b"\n")

    dn = np.flatnonzero(denovo)
    expected = {}
    paths = {}
    for parent in ("mother", "father"):
        held = dn[rng.random(len(dn)) < 0.9]
        others = np.setdiff1d(np.arange(n), dn)
        rest = np.sort(rng.choice(others, size=max(0, n_somatic - len(held)), replace=False))
        idx = np.sort(np.concatenate([held, rest]))
        q = rng.uniform(1, 60, len(idx))
        q_text = np.char.mod(b"%.2f", q)
        no_q = rng.random(len(idx)) < 0.01
        q_text[no_q] = b"."
        expected[parent] = {i: (0.0 if t == b"." else float(t)) for i, t in zip(idx.tolist(), q_text.tolist())}
        som = _cat(b"chr20", tab, _text(pos0[idx] + 1), tab, b".", tab, _BASES[ref_c[idx]], tab,
                   _BASES[(ref_c[idx] + 1) % 4], tab, q_text, tab, b"PASS", tab, b"TLOD=10.0", tab, b"GT:AD", tab,
                   b"0/1:20,8", tab, b"0/0:30,0")
        paths[parent] = os.path.join(d, f"somatic_{parent}.vcf")
        with open(paths[parent], "wb") as fh:
            fh.write(b"##fileformat=VCFv4.2\n##contig=<ID=chr20,length=%d>\n" % length)
            fh.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{child}\tPARENT\n".encode())
            fh.write(b"\n".join(som.tolist()) + b"\n")
    for parent in ("mother", "father"):
        with open(os.path.join(d, f"{parent}.json"), "w") as fh:
            json.dump({child: paths[parent]}, fh)
    want = np.array([min(expected["mother"].get(i, 0.0), expected["father"].get(i, 0.0)) for i in dn.tolist()])
    return {"trio": trio, "maternal_json": os.path.join(d, "mother.json"),
            "paternal_json": os.path.join(d, "father.json"), "denovo_pos": pos0[dn] + 1, "denovo_qual": want}


def write_runs_world(d: str, seed: int, contigs=(("chr20", 64_444_167), ("chrM", 16_569)), n_runs: int = 60_000,
                     n_blocks: int = 200) -> dict:
    """Write ``ref.fa`` (+ ``.fai``): each contig a sequence whose own runs
    are at most 4 bases long, with ``n_runs`` homopolymer runs of 5-60 bp
    planted (shared out by length; each one's neighbours other bases), a
    run at each contig's first and last base, and ``n_blocks`` blocks of
    N (50-5,000 bp). Returns the path and the planted runs: (contig,
    0-based start, length) in contig and position order."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    total = sum(ln for _, ln in contigs)
    out, planted = [], []
    for ci, (name, ln) in enumerate(contigs):
        k = max(4, n_runs * ln // total)
        lens = rng.integers(1, 5, ln // 2 + 8)
        bases = np.cumsum(rng.integers(1, 4, len(lens))) % 4  # each run's base differs from the previous one
        codes = np.repeat(bases.astype(np.uint8), lens)[:ln].copy()
        # N blocks in 10-kbp cells; runs in 80-bp slots clear of them and of the contig's ends
        cells = np.sort(rng.choice(max(1, ln // 10_000 - 1), size=min(n_blocks if ci == 0 else 1,
                                                                        max(1, ln // 10_000 - 1)), replace=False))
        blk_start = cells * 10_000 + 200
        blk_len = rng.integers(50, 5_001, len(cells))
        blocked = np.zeros(ln // 80 + 1, dtype=bool)
        for s, L in zip(blk_start.tolist(), blk_len.tolist()):
            codes[s:s + L] = 4
            blocked[max(0, s // 80 - 1): (s + L) // 80 + 2] = True
        free = np.flatnonzero(~blocked[1: ln // 80 - 1]) + 1
        slots = np.sort(rng.choice(free, size=min(k, len(free)), replace=False))
        starts = slots * 80 + rng.integers(1, 10, len(slots))
        run_len = rng.integers(5, 61, len(slots))
        starts = np.concatenate([[0], starts, [ln - 37]])
        run_len = np.concatenate([[23], run_len, [37]])
        for s, L in zip(starts.tolist(), run_len.tolist()):
            left = codes[s - 1] if s > 0 else 5
            right = codes[s + L] if s + L < ln else 5
            c = next(b for b in rng.permutation(4).tolist() if b != left and b != right)
            codes[s:s + L] = c
        out.append((name, codes))
        planted += [(name, int(s), int(L)) for s, L in zip(starts.tolist(), run_len.tolist())]
    fasta = os.path.join(d, "ref.fa")
    fai = []
    with open(fasta, "wb") as fh:
        for name, codes in out:
            seq = _ACGTN[codes].view(np.uint8)
            full = len(seq) // 60
            fh.write(f">{name}\n".encode())
            fai.append(f"{name}\t{len(codes)}\t{fh.tell()}\t60\t61\n")
            fh.write(np.concatenate([seq[: full * 60].reshape(full, 60),
                                     np.full((full, 1), ord("\n"), np.uint8)], axis=1).tobytes())
            if len(seq) > full * 60:
                fh.write(seq[full * 60:].tobytes() + b"\n")
    with open(fasta + ".fai", "w") as fh:
        fh.write("".join(fai))
    return {"fasta": fasta, "planted": planted}
