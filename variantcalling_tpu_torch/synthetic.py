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
