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
    qual = np.char.mod(b"%.2f", q)  # GATK's two decimals
    info = _cat(b"DP=", np.char.mod(b"%d", rng.integers(10, 60, n)))
    info = np.where(missing, info, _cat(info, b";SOR=", np.char.mod(b"%.3f", rng.uniform(0, 3, n))))
    gt = np.where(multi, b"1/2", np.where(rng.random(n) < 0.6, b"0/1", b"1/1"))
    ad = _cat(np.char.mod(b"%d", rng.integers(0, 40, n)), b",",
              np.char.mod(b"%d", rng.integers(1, 40, n))).astype("S12")
    ad[multi] = _cat(ad[multi], b",", np.char.mod(b"%d", rng.integers(1, 40, int(multi.sum()))))
    gq = np.char.mod(b"%d", rng.integers(10, 99, n))
    sample = np.where(missing, _cat(gt, b":", ad), _cat(gt, b":", gq, b":", ad))
    fmt = np.where(missing, b"GT:AD", b"GT:GQ:AD")
    tab = b"\t"
    chrom = np.repeat(np.asarray([name.encode() for name, _ in contigs]), counts)
    pos1 = np.concatenate([p + 1 for p in pos_parts]) - np.repeat(
        np.cumsum([0] + [ln for _, ln in contigs[:-1]]), counts)
    rec = _cat(chrom, tab, np.char.mod(b"%d", pos1), tab, b".", tab,
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

    contigs = reads["contigs"]
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in contigs)
    head = bytearray(b"BAM\x01") + np.int32(len(text)).tobytes() + text.encode() + np.int32(len(contigs)).tobytes()
    for c, ln in contigs:
        head += np.int32(len(c) + 1).tobytes() + c.encode() + b"\x00" + np.int32(ln).tobytes()
    n = len(reads["pos"])
    total = len(head)
    with BgzfWriter(path, level=level) as out:
        out.write(bytes(head))
        for lo in range(0, n, _COVERAGE_CHUNK):
            body = _bam_records(reads, lo, min(n, lo + _COVERAGE_CHUNK))
            total += len(body)
            out.write(memoryview(body))
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
