"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: build, kernel parity, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final result line is not printed):

1. card: name and power limit (nvidia-smi), torch/CUDA versions; fails
   without a CUDA device;
2. build: compiles both kernel sources, ``variantcalling_tpu_torch/csrc/
   forest_wide.cu`` and ``forest_tree_step.cu``, with nvcc for sm_90a, the
   two nvcc runs started together, and prints each build's seconds;
3. kernels, each against its plain torch version on the card, bit for bit
   (``torch.equal``), timed with CUDA events (median after warm-up) beside
   its bound, at the main path's shape (104,000 rows), at one 262,144-row
   chunk and, where marked, at 5,000,000 rows in 262,144-row chunks (parity
   at every chunk):
   - the wide-block kernel: the train_models default forest (100 trees, 63
     internal nodes / 64 leaves, logit_sum; 5 M) and an sklearn-RF-shaped
     mean forest (100 trees, 256 leaves; 5 M);
   - the per-tree kernel: the same two forests (the 64-leaf one with 5 M),
     the 64-leaf forest with seeded default_left on inputs with about 10 %
     NaN cells (5 M), and 10 trees of 1,024 leaves (depth 11), which only
     an explicit ``gemm`` request sends to the card;
4. pipeline: ``filter_variants_pipeline`` through ``run(argv)`` on two
   synthetic chr20-scale worlds (64,444,167 bp, 104,000 variants), each run
   with every kernel's launch count set to 0 just before it and read just
   after:
   - the 100-tree logit_sum forest pickle: ``--backend gpu`` (``auto`` ->
     ``cuda-wide``), ``--backend cpu``, and ``--backend gpu`` with
     ``VCTPU_FOREST_STRATEGY=gemm`` (-> ``cuda-gemm``);
   - an xgboost JSON model (100 trees of depth 6, default_left) over a
     callset where about 10 % of the records lack SOR and GQ:
     ``--backend gpu`` (``auto`` -> ``cuda-gemm``) and ``--backend cpu``;
   each GPU run must launch its kernel and only its kernel, and write the
   CPU run's bytes outside the ``##vctpu_*`` lines.

The last two lines of standard output are a JSON object with the kernel
numbers and the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNEL_ROWS = 262_144  # one pipeline CHUNK
NORTH_STAR_ROWS = 5_000_000
WORLD = dict(contig="chr20", length=64_444_167, n_variants=104_000, n_trees=100, depth=7,
             aggregation="logit_sum")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card() -> str:
    check(torch.cuda.is_available(), "torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    return card


def phase_build() -> dict[str, float]:
    """Build every kernel source, one nvcc each, all started together."""
    from variantcalling_tpu_torch.csrc import build

    def one(name: str) -> float:
        t0 = time.perf_counter()
        build.build(name, verbose=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        seconds = dict(zip(build.KERNELS, pool.map(one, build.KERNELS)))
    for name, sec in seconds.items():
        print(f"build: {build.library_path(name).name} in {sec:.2f} s", flush=True)
    return seconds


def _features(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 19) float32 features, each column uniform over its BASE_FEATURES range."""
    from variantcalling_tpu_torch.featurize import BASE_FEATURES
    from variantcalling_tpu_torch.synthetic import FEATURE_RANGES

    lo = np.asarray([FEATURE_RANGES[f][0] for f in BASE_FEATURES], dtype=np.float32)
    hi = np.asarray([FEATURE_RANGES[f][1] for f in BASE_FEATURES], dtype=np.float32)
    return lo + rng.random((n, len(BASE_FEATURES)), dtype=np.float32) * (hi - lo)


def _bound(n: int, n_features: int, table_bytes: int, plen: np.ndarray) -> tuple[float, str, dict]:
    """(least ms, "bytes"|"operations", detail) for scoring ``n`` rows with a
    forest whose trees have the real-leaf path lengths ``plen`` (T, L): each
    input byte read once (features, the kernel's tables), each margin written
    once; operations are the threshold compares a row needs (complete trees:
    depth per tree) and the adds of the tree sum, at the float32 rate outside
    the tensor cores. Both kernels compute this same function."""
    nbytes = n * n_features * 4 + table_bytes + n * 4
    depths = [int(p[p >= 0].max()) for p in plen]
    check(all(int(p[p >= 0].min()) == d for p, d in zip(plen, depths)), "bound assumes complete trees")
    ops = n * (sum(depths) + len(depths))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops}
    return (t_bytes, "bytes", detail) if t_bytes >= t_ops else (t_ops, "operations", detail)


def _chunked(kernel_fn, x: torch.Tensor, chunk: int) -> list[torch.Tensor]:
    return [kernel_fn(x[lo: lo + chunk]) for lo in range(0, x.shape[0], chunk)]


def _measure(name: str, kernel, x_all: torch.Tensor, main_rows: int, north_star: bool, bound, info: dict
             ) -> tuple[dict, float]:
    """Parity (``torch.equal``) and CUDA-event times of ``kernel.launch`` against
    ``kernel.plain`` at the main path's rows, one chunk and, with
    ``north_star``, 5 M rows in chunks (parity at every chunk).
    ``bound(n)`` -> (ms, by, detail). Returns (rows -> numbers, max abs error)."""
    max_err = 0.0
    spans = [(lo, KERNEL_ROWS) for lo in range(0, NORTH_STAR_ROWS, KERNEL_ROWS)] if north_star else []
    spans += [(0, main_rows), (0, KERNEL_ROWS)]
    for lo, size in spans:
        xc = x_all[lo: lo + size]
        got, want = kernel.launch(xc), kernel.plain(xc)
        torch.cuda.synchronize()
        err = float((got - want).abs().nan_to_num(nan=math.inf).max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name}: kernel != plain at rows {lo}..{lo + size} (max abs err {err})")
    rows = {}
    for n in (main_rows, KERNEL_ROWS):
        xn = x_all[:n]
        bound_ms, bound_by, detail = bound(n)
        ms = cuda_ms(lambda xn=xn: kernel.launch(xn))
        rows[n] = {"ms": ms, "plain_ms": cuda_ms(lambda xn=xn: kernel.plain(xn), reps=5),
                   "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms, **detail}
    if north_star:
        bound_ms, bound_by, detail = bound(NORTH_STAR_ROWS)
        ms = cuda_ms(lambda: _chunked(kernel.launch, x_all, KERNEL_ROWS), reps=5, warmup=1)
        rows[NORTH_STAR_ROWS] = {
            "ms": ms, "plain_ms": cuda_ms(lambda: _chunked(kernel.plain, x_all, KERNEL_ROWS), reps=2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms, **detail,
            "launches": math.ceil(NORTH_STAR_ROWS / KERNEL_ROWS)}
    for n, r in rows.items():
        print("KERNEL_DETAIL " + json.dumps({"forest": name, "rows": n, **info, **r}), flush=True)
    return rows, max_err


def phase_kernel(main_rows: int) -> dict:
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.synthetic import filter_forest

    torch.backends.cuda.matmul.allow_tf32 = False  # stated: the plain versions' products stay float32
    rng = np.random.default_rng(20)
    x_all = torch.from_numpy(_features(rng, NORTH_STAR_ROWS)).cuda()
    # the same rows with about 10 % of the cells missing, for the default_left forest
    gen = torch.Generator(device="cuda").manual_seed(21)
    x_nan = x_all.masked_fill(torch.rand(x_all.shape, generator=gen, device="cuda") < 0.1, math.nan)
    cuda = torch.device("cuda")
    wide, tree_step = {}, {}
    wide_err = tree_err = 0.0
    finite = {"train_models_default_100x64": filter_forest(np.random.default_rng(7), 100, 7, "logit_sum"),
              "sklearn_rf_shaped_100x256": filter_forest(np.random.default_rng(9), 100, 9, "mean")}
    for name, forest in finite.items():
        check(fmod.resolve_strategy(forest, cuda) == "cuda-wide", f"{name}: not on the wide kernel")
        kernel = forest_cuda.WideForestKernel(forest, x_all.shape[1], "cuda")
        wf = kernel.wide()
        table_bytes = (kernel.nodes.numel() + kernel.leaf_val.numel() + kernel.roots.numel()) * 4
        plen = wf.plen.reshape(-1, kernel.n_leaf)[: wf.n_trees]
        wide[name], err = _measure(name, kernel, x_all, main_rows, True,
                                   lambda n: _bound(n, kernel.n_features, table_bytes, plen),
                                   {"kernel": "forest_wide", "blocks": kernel.n_blocks,
                                    "tree_block": kernel.tree_block})
        wide_err = max(wide_err, err)

    dleft = filter_forest(np.random.default_rng(77), n_trees=100, depth=7)
    dleft.default_left = (np.random.default_rng(78).random(dleft.feature.shape) < 0.5) \
        & (dleft.feature != fmod.LEAF)
    deep = filter_forest(np.random.default_rng(11), n_trees=10, depth=11)
    os.environ[fmod.FOREST_STRATEGY_ENV] = "gemm"
    check(fmod.resolve_strategy(deep, cuda) == "cuda-gemm", "explicit gemm does not reach the per-tree kernel")
    del os.environ[fmod.FOREST_STRATEGY_ENV]
    check(fmod.resolve_strategy(deep, cuda) == "gather", "auto sends trees of 1,024 leaves to a kernel")
    check(fmod.resolve_strategy(dleft, cuda) == "cuda-gemm", "auto does not send default_left to cuda-gemm")
    for name, forest, x, north_star in (
            ("train_models_default_100x64", finite["train_models_default_100x64"], x_all, True),
            ("sklearn_rf_shaped_100x256", finite["sklearn_rf_shaped_100x256"], x_all, False),
            ("xgboost_default_left_100x64", dleft, x_nan, True),
            ("explicit_gemm_10x1024", deep, x_all, False)):
        gf = fmod.to_gemm(forest, x.shape[1])
        kernel = forest_cuda.TreeStepKernel(gf, "cuda")
        tables = [kernel.nodes, kernel.masks, kernel.values] + ([] if kernel.dleft is None else [kernel.dleft])
        table_bytes = sum(t.numel() * t.element_size() for t in tables)
        t, _, i = gf.a.shape

        def bound(n: int) -> tuple[float, str, dict]:
            ms, by, detail = _bound(n, kernel.n_features, table_bytes, gf.plen)
            # the routing contraction's own count, N*T*I*L, for the later redesign
            return ms, by, {**detail, "contraction_ops": n * t * i * gf.n_leaves}

        tree_step[name], err = _measure(
            name, kernel, x, main_rows, north_star, bound,
            {"kernel": "forest_tree_step", "trees": t, "internal": i, "leaves": gf.n_leaves,
             "words": kernel.n_words, "default_left": kernel.dleft is not None})
        tree_err = max(tree_err, err)
    del x_all, x_nan
    torch.cuda.empty_cache()
    return {"forest_wide": {"results": wide, "max_abs_err": wide_err},
            "forest_tree_step": {"results": tree_step, "max_abs_err": tree_err}}


class _StageTimes(logging.Handler):
    """Collects the pipeline's per-stage timing records (``STAGE_LOG``)."""

    def __init__(self, fmt: str):
        super().__init__(logging.INFO)
        self.fmt = fmt
        self.stages: dict[str, float] = {}

    def emit(self, record: logging.LogRecord) -> None:
        if record.msg == self.fmt:
            name, seconds = record.args
            self.stages[name] = self.stages.get(name, 0.0) + seconds


def _strip(data: bytes) -> bytes:
    return b"\n".join(ln for ln in data.split(b"\n") if not ln.startswith(b"##vctpu_"))


def _drive(world: dict, out: Path, backend: str, card: str, label: str, strategy: str | None = None) -> dict:
    """One ``filter_variants_pipeline`` run through ``run(argv)``; every kernel's
    launch count is set to 0 just before it and read just after."""
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.pipelines import filter_variants

    argv = ["--input_file", world["vcf"], "--model_file", world["model"], "--model_name", world["model_name"],
            "--reference_file", world["fasta"], "--output_file", str(out), "--backend", backend]
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    times = _StageTimes(filter_variants.STAGE_LOG)
    plog.addHandler(times)
    if strategy is not None:
        os.environ[fmod.FOREST_STRATEGY_ENV] = strategy
    torch.cuda.synchronize()
    forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc = filter_variants.run(argv)
    finally:
        seconds = time.perf_counter() - t0
        launches = {"forest_wide": forest_cuda.LAUNCHES, "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES}
        os.environ.pop(fmod.FOREST_STRATEGY_ENV, None)
        plog.removeHandler(times)
    check(rc == 0, f"{label} --backend {backend} run exited {rc}")
    n = WORLD["n_variants"]
    print(f"pipeline {label} --backend {backend}: {seconds:.2f} s, {n / seconds:.0f} variants/s, "
          f"launches {launches} ({card})", flush=True)
    print("PIPELINE_STAGES " + json.dumps({"world": label, "backend": backend, "total_s": seconds,
                                           "launches": launches, **times.stages}), flush=True)
    return {"bytes": out.read_bytes(), "seconds": seconds, "launches": launches}


def _check_same(gpu: dict, cpu: dict, strategy: str, kernel: str, label: str) -> None:
    """The GPU run wrote the CPU run's bytes outside ##vctpu_*, recorded its
    engine and strategy, launched ``kernel`` and no other kernel; the scores
    are in [0, 1] and split the records between PASS and LOW_SCORE."""
    check(_strip(gpu["bytes"]) == _strip(cpu["bytes"]), f"{label}: GPU and CPU outputs differ outside ##vctpu_*")
    lines = gpu["bytes"].decode().splitlines()
    check("##vctpu_engine=cuda" in lines and f"##vctpu_forest_strategy={strategy}" in lines,
          f"{label}: GPU output does not record the cuda engine and the {strategy} strategy")
    check(gpu["launches"][kernel] > 0, f"{label}: the GPU run never launched {kernel}")
    check(all(v == 0 for k, v in gpu["launches"].items() if k != kernel), f"{label}: other kernels launched")
    records = [ln for ln in lines if not ln.startswith("#")]
    check(len(records) == WORLD["n_variants"], f"{label}: {len(records)} records written")
    scores = np.asarray([float(ln.split("TREE_SCORE=")[1].split(";")[0].split("\t")[0]) for ln in records])
    check(bool(np.all(np.isfinite(scores)) and scores.min() >= 0 and scores.max() <= 1), "scores out of [0, 1]")
    n_pass = sum(ln.split("\t")[6].startswith("PASS") for ln in records)
    check(0 < n_pass < len(records), f"{label}: all records share one FILTER")
    print(f"pipeline {label}: GPU ({strategy}) and CPU outputs identical outside ##vctpu_*; "
          f"{n_pass} PASS of {len(records)}; {kernel} launches in the GPU run: {gpu['launches'][kernel]}",
          flush=True)


def phase_pipeline(tmp: Path, card: str) -> dict:
    from variantcalling_tpu_torch import synthetic

    runs = {}
    for label, seed, xgboost in (("forest_pickle", 2026, False), ("xgboost_json", 2027, True)):
        t0 = time.perf_counter()
        world = synthetic.write_world(str(tmp / label), seed=seed, xgboost=xgboost, **WORLD)
        print(f"world {label}: {WORLD['n_variants']} variants on {WORLD['length']} bp in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cpu = _drive(world, tmp / f"{label}_cpu.vcf", "cpu", card, label)
        if xgboost:
            records = [ln for ln in cpu["bytes"].decode().splitlines() if not ln.startswith("#")]
            missing = sum(";SOR=" not in ln for ln in records)
            check(0.05 * len(records) < missing < 0.15 * len(records), f"{missing} records lack SOR")
            gpu = _drive(world, tmp / f"{label}_gpu.vcf", "gpu", card, label)
            _check_same(gpu, cpu, "cuda-gemm", "forest_tree_step", label)
            runs["xgboost_gpu"] = gpu
        else:
            gpu = _drive(world, tmp / f"{label}_gpu.vcf", "gpu", card, label)
            _check_same(gpu, cpu, "cuda-wide", "forest_wide", label)
            gemm = _drive(world, tmp / f"{label}_gpu_gemm.vcf", "gpu", card, label + "_gemm", strategy="gemm")
            _check_same(gemm, cpu, "cuda-gemm", "forest_tree_step", label + " (gemm)")
            runs["wide_gpu"], runs["gemm_gpu"] = gpu, gemm
    return runs


def main() -> int:
    card = phase_card()
    build_s = phase_build()
    kern = phase_kernel(main_rows=WORLD["n_variants"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe = phase_pipeline(Path(tmp), card)
    n = WORLD["n_variants"]
    rows = {  # each kernel's numbers at the main path's shape, on the forest its main path scores
        "forest_wide": kern["forest_wide"]["results"]["train_models_default_100x64"][n],
        "forest_tree_step": kern["forest_tree_step"]["results"]["xgboost_default_left_100x64"][n],
    }
    meta = {
        "forest_wide": ("variantcalling_tpu_torch/csrc/forest_wide.cu",
                        "variantcalling_tpu/models/forest_pallas.py:105", pipe["wide_gpu"]),
        "forest_tree_step": ("variantcalling_tpu_torch/csrc/forest_tree_step.cu",
                             "variantcalling_tpu/models/forest_pallas.py:51", pipe["xgboost_gpu"]),
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": run["launches"][name], "max_abs_err": kern[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        # no single PyTorch call computes a decision forest
        "library_ms": None,
        "build_s": build_s[name],
    } for name, (source, replaces, run) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
