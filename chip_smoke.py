"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: build, kernel parity, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final result line is not printed):

1. card: name and power limit (nvidia-smi), torch/CUDA versions; fails
   without a CUDA device;
2. build: compiles both kernel sources, ``variantcalling_tpu_torch/csrc/
   forest_wide.cu`` and ``forest_tree_step.cu``, with nvcc for sm_90a, and
   the native host engine (``variantcalling_tpu_torch/native/src``) with
   g++, the three builds started together, and prints each build's seconds;
3. kernels, each against its plain torch version on the card, bit for bit
   (``torch.equal``), timed with CUDA events beside its bound (``ms``:
   single launches, as the main path makes them; ``device_ms``: launches
   queued back to back, the card's time alone; ``host_ms``: the wrapper's
   host time), at the main path's shape (104,000 rows), at one 262,144-row
   chunk and, where marked, at 5,000,000 rows in 262,144-row chunks (parity
   at every chunk):
   - the wide-block kernel: the train_models default forest (100 trees, 63
     internal nodes / 64 leaves, logit_sum; 5 M), an sklearn-RF-shaped
     mean forest (100 trees, 256 leaves, streamed through shared memory in
     chunks; 5 M), and the 64-leaf forest with seeded default_left on
     inputs with about 10 % NaN cells (the xgboost shape; 5 M);
   - the per-tree kernel (int8 routing on the tensor cores): the same three
     forests and 10 trees of 1,024 leaves (depth 11), which only an explicit
     ``gemm`` request sends to the card, all at 5 M rows too; beside its
     bound, ``mma_ms``, the dense routing contraction's time at the int8
     tensor-core peak, and ``k_blocks``, the 32-node blocks of ``m2`` its
     tables keep (the kernel skips the all-zero ones);
   - the wide-block kernel on trees too large for its shared memory (of
     16,383 and 65,535 nodes, walked from device memory) under an explicit
     ``wide``, against the gather walk ``forest.predict_margin`` on the
     card (the plain version's wide encoding would take gigabytes);
4. pipeline: ``filter_variants_pipeline`` through ``run(argv)`` on two
   synthetic chr20-scale worlds (64,444,167 bp, 104,000 variants), each run
   with every kernel's launch count and every native host engine entry
   point's count set to 0 just before it and read just after, each printing
   its window path, the bytes it sent to the device per variant, where it
   built one, the resident genome's encode and upload seconds and bytes,
   and the host engine's calls and seconds (``HOST_ENGINE``): every GPU run
   of this script, in every phase, must have been served by the engine
   (the scan, the INFO formatter and the record assembly; the BGZF codec
   and the host gather where its path reaches them) and by no plain
   version. At 104,000 variants every run gathers its windows from the
   genome resident on its device, as the reference does:
   - the forest pickle, which also holds a threshold model and a DAN (the
     mixed pickle of the reference's ``train_models_pipeline``), with its
     100-tree logit_sum forest: ``--backend cpu``, ``--backend gpu``
     (``auto`` -> ``cuda-wide``), the same with ``VCTPU_NO_NATIVE=1`` (the
     plain host versions: equal bytes, the host stages of both in
     ``HOST_ENGINE_TWINS``), ``--backend gpu`` with
     ``VCTPU_FOREST_STRATEGY=gemm`` (-> ``cuda-gemm``), and ``--backend gpu``
     on the host window gather (``featurize.GENOME_RESIDENT_MIN_VARIANTS``
     set past the table in process, the genome cache hidden), reading a
     BGZF copy of the callset and writing ``.vcf.gz``: its ``.tbi`` must
     exist and a region read through the port's ``TabixIndex`` must return
     the plain output's records;
   - an xgboost JSON model (100 trees of depth 6, default_left) over a
     callset where about 10 % of the records lack SOR and GQ:
     ``--backend cpu``, ``--backend gpu`` (``auto`` -> ``cuda-wide``), its
     ``VCTPU_NO_NATIVE=1`` twin, and ``--backend gpu`` with
     ``VCTPU_FOREST_STRATEGY=gemm`` (-> ``cuda-gemm``);
   each GPU run must launch its kernel and only its kernel, and write the
   CPU run's bytes outside the ``##vctpu_*`` lines; every GPU run of this
   script must write back each record's QUAL text as the input has it
   (two decimals, as GATK writes them, 1 % of them 10,000 and more);
5. families, on the forest pickle world's callset: the DAN at
   ``train_dan``'s widths (hidden 256, 2 layers, embed 16) and the threshold
   model over qual and sor, each through the CLI on ``--backend gpu`` and
   ``--backend cpu`` (no kernel launched; records differing only as
   ``tests/torch_vcf_compare.py`` allows, counted) and through the API on
   the world's features: GPU against CPU scores within 1e-5 (DAN) and 1e-6
   (threshold); the DAN's scores of 104,000 rows in one call ``torch.equal``
   to its scores in chunks of 1,000, and to a call made with
   ``torch.backends.cuda.matmul.allow_tf32 = True`` set globally; the
   forward's CUDA-event time beside its float32 FLOP count and bound
   (``FAMILY_DETAIL``);
6. blacklists, on the forest pickle world: the committed h5 blacklists
   (``tests/torch_data/blacklist_{vctpu,pytables}.h5``, 300 loci of the
   world drawn with a stated seed, read by the port's own HDF5 parser),
   each on ``--backend gpu`` (``auto`` -> ``cuda-wide``, one launch), the
   same loci as a ``.bed`` on the card, and the first h5 on ``--backend
   cpu``: all four outputs equal outside ``##vctpu_*``, every locus's
   record marked COHORT_FP;
7. the ``.venc`` genome sidecar under a fresh ``VCTPU_GENOME_CACHE_DIR``,
   the process's resident-genome cache cleared before each run: a GPU run
   encodes and writes it (its size checked), a second memory-maps it (both
   runs' ``genome`` stage and ``GENOME_LOG`` printed, bytes equal),
   ``VCTPU_GENOME_CACHE=0`` reads and writes none, and
   ``VCTPU_GENOME_CACHE=maybe`` exits 2 before any ingest;
8. the streaming executor, the port's default path (``phase_streaming``;
   phases 4-7 pin ``VCTPU_STREAM=0``, the serial path whose stages,
   window path and transfers they check): on ``WORLD_STREAM``, the xgboost
   JSON model over 5,000,000 variants on chr20, chr21 and chr22 at GRCh38's
   lengths, the default run (streaming, pooled, 8 MiB chunks),
   ``VCTPU_IO_THREADS=1`` and ``VCTPU_STREAM=0``, each in a process of its
   own (forked by a ``forkserver``) for its peak RSS: equal outputs, every
   table on the resident genome, ``forest_wide`` launches equal to the 262,144-row
   pieces of the tables that reached the card, every run served by the
   host engine, the streaming runs' peak RSS below the serial run's; on
   the forest pickle world in 1 MiB chunks, ``.vcf.gz`` streaming against
   serial (container and ``.tbi`` bytes), a run failed by
   ``io.writeback:0+3`` resumed to the clean bytes, ``VCTPU_CACHE=1`` twice
   (the second all hits, no launch, equal bytes), and the DAN and threshold
   models streaming against their serial GPU runs. A ``STREAM_DETAIL`` line
   per run: layout, chunks, window paths, launches, wall seconds,
   variants/s, peak host RSS (5 M runs) and peak card memory.

The last two lines of standard output are a JSON object with the kernel
numbers and the device line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-kernel {wide,tree_step} CHECKOUT_ROOT

times only one kernel of the checkout at CHECKOUT_ROOT (``.`` for this one;
an older one unpacked under the ignored ``build/``), on the same forests and
rows as phase 3: run in turns for two checkouts in one call on one card, it
compares their kernels (:func:`time_kernel`).
"""

from __future__ import annotations

import gzip
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
INT8_OPS_PER_S = 1.979e15  # dense, tensor cores

KERNEL_ROWS = 262_144  # one pipeline CHUNK
HOST_ENGINE = "host_engine"  # the native (g++) host engine, in phase_build beside the kernels
#: entry points of the native host engine every pipeline run reaches (ingest, writeback)
HOST_ENGINE_PATH = ("vcf_parse", "format_float_info", "vcf_assemble")
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


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds the host spends in ``fn``, which returns once its
    launch is queued; the card is synchronized between calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card alone: ``reps`` calls enqueued
    while the card spins (``torch.cuda._sleep``) for longer than the host takes
    to enqueue them, then timed between one pair of CUDA events, so that the
    wrapper's host time hides behind the card's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # an upper bound on one call's host time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 1.5 * reps * host_s) * 2e9))  # cycles at about 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    """Build every kernel source, one nvcc each, and the native host engine
    (g++), all started together; a failed build fails the smoke."""
    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.csrc import build

    def one(name: str) -> float:
        t0 = time.perf_counter()
        if name == HOST_ENGINE:
            native.build()
        else:
            build.build(name, verbose=True)
        return time.perf_counter() - t0

    names = (*build.KERNELS, HOST_ENGINE)
    with ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(zip(names, pool.map(one, names)))
    for name, sec in seconds.items():
        path = native.library_path() if name == HOST_ENGINE else build.library_path(name)
        print(f"build: {path.name} in {sec:.2f} s", flush=True)
    check(native.available(), "the native host engine was built but does not load")
    gxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"host engine: {native.library_path().name}, g++ {gxx}, {native.native_threads()} threads on "
          f"{os.cpu_count()} host cores", flush=True)
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


def _launch_times(launch, x_all: torch.Tensor, n: int) -> dict:
    """The three times of ``launch`` over the first ``n`` rows (in 262,144-row
    chunks past one chunk): ``ms``, the median of single launches each
    between its own pair of events, which is what one launch of the main
    path costs, the wrapper's host time included where the card waits for
    it; ``device_ms``, the card's time alone (:func:`device_ms`); ``host_ms``,
    the wrapper's host time (:func:`host_ms`)."""
    if n <= KERNEL_ROWS:
        xn = x_all[:n]
        fn, reps = (lambda: launch(xn)), 20
    else:
        fn, reps = (lambda: _chunked(launch, x_all[:n], KERNEL_ROWS)), 5
    return {"ms": cuda_ms(fn, reps=reps), "device_ms": device_ms(fn, reps=reps), "host_ms": host_ms(fn, reps=reps)}


def _measure(name: str, kernel, x_all: torch.Tensor, main_rows: int, north_star: bool, bound, info: dict
             ) -> tuple[dict, float]:
    """Parity (``torch.equal``) and CUDA-event times (:func:`_launch_times`) of
    ``kernel.launch`` against ``kernel.plain`` at the main path's rows, one
    chunk and, with ``north_star``, 5 M rows in chunks (parity at every
    chunk). ``bound(n)`` -> (ms, by, detail). Returns (rows -> numbers, max
    abs error)."""
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
    for n in (main_rows, KERNEL_ROWS) + ((NORTH_STAR_ROWS,) if north_star else ()):
        bound_ms, bound_by, detail = bound(n)
        times = _launch_times(kernel.launch, x_all, n)
        if n <= KERNEL_ROWS:
            plain_ms = cuda_ms(lambda xn=x_all[:n]: kernel.plain(xn), reps=5)
        else:
            plain_ms = cuda_ms(lambda: _chunked(kernel.plain, x_all, KERNEL_ROWS), reps=2, warmup=1)
        rows[n] = {**times, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / times["ms"], "device_bound_share": bound_ms / times["device_ms"],
                   **detail, "launches": math.ceil(n / KERNEL_ROWS)}
    for n, r in rows.items():
        print("KERNEL_DETAIL " + json.dumps({"forest": name, "rows": n, **info, **r}), flush=True)
    return rows, max_err


def _inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """5 M rows of seeded features on the card, and the same rows with about
    10 % of the cells missing (NaN), for the default_left forest."""
    x_all = torch.from_numpy(_features(np.random.default_rng(20), NORTH_STAR_ROWS)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(21)
    x_nan = x_all.masked_fill(torch.rand(x_all.shape, generator=gen, device="cuda") < 0.1, math.nan)
    return x_all, x_nan


def _wide_forests(x_all: torch.Tensor, x_nan: torch.Tensor) -> dict:
    """name -> (forest, its input rows): the three forests of the wide kernel's
    numbers, seeded; the xgboost-shaped one is the production shape."""
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.synthetic import filter_forest

    dleft = filter_forest(np.random.default_rng(77), n_trees=100, depth=7)
    dleft.default_left = (np.random.default_rng(78).random(dleft.feature.shape) < 0.5) \
        & (dleft.feature != fmod.LEAF)
    return {"train_models_default_100x64": (filter_forest(np.random.default_rng(7), 100, 7, "logit_sum"), x_all),
            "sklearn_rf_shaped_100x256": (filter_forest(np.random.default_rng(9), 100, 9, "mean"), x_all),
            "xgboost_default_left_100x64": (dleft, x_nan)}


def _tree_step_forests(forests: dict, x_all: torch.Tensor) -> dict:
    """name -> (forest, its input rows): the per-tree kernel's four forests,
    the wide kernel's three and 10 trees of 1,024 leaves (depth 11)."""
    from variantcalling_tpu_torch.synthetic import filter_forest

    deep = filter_forest(np.random.default_rng(11), n_trees=10, depth=11)
    return {**forests, "explicit_gemm_10x1024": (deep, x_all)}


def _large_tree_forest():
    """64-leaf trees around two trees of 16,383 nodes and one of 65,535
    (depths 14 and 16), default_left seeded: larger than any chunk buffer, so
    their chunk is walked from device memory."""
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.synthetic import synthetic_forest

    rng = np.random.default_rng(12)
    parts = [synthetic_forest(rng, n_trees=k, depth=d, n_features=19) for k, d in ((4, 7), (2, 14), (1, 16), (4, 7))]
    m = max(pt.feature.shape[1] for pt in parts)

    def cat(key: str, fill) -> np.ndarray:
        return np.concatenate([np.pad(getattr(pt, key), ((0, 0), (0, m - pt.feature.shape[1])), constant_values=fill)
                               for pt in parts])

    forest = fmod.FlatForest(feature=cat("feature", fmod.LEAF), threshold=cat("threshold", 0), left=cat("left", 0),
                             right=cat("right", 0), value=cat("value", 0), max_depth=16, aggregation="logit_sum")
    forest.default_left = (rng.random(forest.feature.shape) < 0.5) & (forest.feature != fmod.LEAF)
    return forest


def phase_large_trees(x_nan: torch.Tensor, main_rows: int) -> dict:
    """Explicit ``wide`` on trees past the chunk buffers: resolved to the wide
    kernel on the card, bit for bit the gather walk on the card."""
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda

    forest = _large_tree_forest()
    os.environ[fmod.FOREST_STRATEGY_ENV] = "wide"
    try:
        check(fmod.resolve_strategy(forest, torch.device("cuda")) == "cuda-wide",
              "explicit wide does not send trees of 65,535 nodes to the wide kernel")
    finally:
        del os.environ[fmod.FOREST_STRATEGY_ENV]
    kernel = fmod.make_margin_predictor(forest, 19, "cuda-wide", torch.device("cuda"))
    tables = kernel.tables
    check(bool(tables.chunk_global.any()) and not bool(tables.chunk_global.all()),
          "the large-tree forest does not mix global chunks and chunks in shared memory")
    max_err, out = 0.0, {}
    for n in (main_rows, KERNEL_ROWS):
        xn = x_nan[:n]
        got, want = kernel(xn), fmod.predict_margin(forest, xn)
        torch.cuda.synchronize()
        err = float((got - want).abs().nan_to_num(nan=math.inf).max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"large trees: wide kernel != gather walk at {n} rows (max abs err {err})")
        out[n] = {**_launch_times(kernel.launch, x_nan, n),
                  "gather_ms": cuda_ms(lambda: fmod.predict_margin(forest, xn), reps=3, warmup=1)}
        print("KERNEL_DETAIL " + json.dumps({"forest": "explicit_wide_large_trees", "kernel": "forest_wide",
                                             "rows": n, "trees": forest.n_trees,
                                             "nodes": (2 * (forest.feature != fmod.LEAF).sum(axis=1) + 1).tolist(),
                                             "chunks": tables.n_chunks, "global_chunks": int(tables.chunk_global.sum()),
                                             "chunk_records": tables.chunk_records, **out[n]}), flush=True)
    return {"results": out, "max_abs_err": max_err}


def phase_kernel(main_rows: int) -> dict:
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda

    torch.backends.cuda.matmul.allow_tf32 = False  # stated: the plain versions' products stay float32
    x_all, x_nan = _inputs()
    cuda = torch.device("cuda")
    wide, tree_step = {}, {}
    wide_err = tree_err = 0.0
    forests = _wide_forests(x_all, x_nan)
    for name, (forest, x) in forests.items():
        check(fmod.resolve_strategy(forest, cuda) == "cuda-wide", f"{name}: auto does not send it to cuda-wide")
        kernel = forest_cuda.WideForestKernel(forest, x.shape[1], "cuda")
        tables = kernel.tables
        wf = kernel.wide()
        table_bytes = sum(t.numel() * t.element_size() for t in (kernel.records, kernel.tree_info, kernel.chunk_tree,
                                                                 kernel.chunk_rec, kernel.chunk_global))
        plen = wf.plen.reshape(-1, wf.value.shape[2])[: wf.n_trees]
        wide[name], err = _measure(name, kernel, x, main_rows, True,
                                   lambda n: _bound(n, kernel.n_features, table_bytes, plen),
                                   {"kernel": "forest_wide", "chunks": tables.n_chunks,
                                    "chunk_records": tables.chunk_records,
                                    "default_left": forest.default_left is not None})
        wide_err = max(wide_err, err)
    large = phase_large_trees(x_nan, main_rows)
    wide_err = max(wide_err, large["max_abs_err"])

    tree_forests = _tree_step_forests(forests, x_all)
    deep = tree_forests["explicit_gemm_10x1024"][0]
    os.environ[fmod.FOREST_STRATEGY_ENV] = "gemm"
    check(fmod.resolve_strategy(deep, cuda) == "cuda-gemm", "explicit gemm does not reach the per-tree kernel")
    del os.environ[fmod.FOREST_STRATEGY_ENV]
    check(fmod.resolve_strategy(deep, cuda) == "gather", "auto sends trees of 1,024 leaves to a kernel")
    for name, (forest, x) in tree_forests.items():
        gf = fmod.to_gemm(forest, x.shape[1])
        kernel = forest_cuda.TreeStepKernel(gf, "cuda")
        tables = kernel.tables
        table_bytes = sum(t.numel() * t.element_size() for t in (kernel.blob, kernel.units))
        t, _, i = gf.a.shape
        dense = t * (-(-i // 32) * 32) * (-(-gf.n_leaves // 8) * 8)  # int8 MACs a row: I to 32, L to 8

        def bound(n: int) -> tuple[float, str, dict]:
            ms, by, detail = _bound(n, kernel.n_features, table_bytes, gf.plen)
            # the dense routing contraction at the int8 tensor-core peak
            return ms, by, {**detail, "mma_ms": 2 * n * dense / INT8_OPS_PER_S * 1e3}

        tree_step[name], err = _measure(
            name, kernel, x, main_rows, True, bound,
            {"kernel": "forest_tree_step", "trees": t, "internal": i, "leaves": gf.n_leaves,
             "units": len(tables.units), "stages": len(tables.stages),
             "k_blocks": int((tables.units[:, 1] & 0xFFFF).sum()),
             "dense_k_blocks": t * -(-i // forest_cuda.K_BLOCK) * -(-gf.n_leaves // forest_cuda.PASS_LEAVES),
             "stage_bytes": tables.stage_bytes,
             "default_left": gf.dleft is not None})
        tree_err = max(tree_err, err)
    del x_all, x_nan
    torch.cuda.empty_cache()
    return {"forest_wide": {"results": wide, "large_trees": large["results"], "max_abs_err": wide_err},
            "forest_tree_step": {"results": tree_step, "max_abs_err": tree_err}}


class _RunLog(logging.Handler):
    """Collects a pipeline run's stage times (``STAGE_LOG``, summed over a
    streaming run's chunks), its window path (``WINDOW_LOG``: the last one,
    and the count of tables on each), the bytes it sent to the device
    (``TRANSFER_LOG``, summed, with the variant count of each table that
    reached the device), a resident genome's build (``GENOME_LOG``) and a
    streaming run's summary (``STREAM_LOG``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages: dict[str, float] = {}
        self.window_path = None
        self.window_paths: dict[str, int] = {}
        self.sent = None
        self.tables: list[int] = []
        self.genome = None
        self.stream = None

    def emit(self, record: logging.LogRecord) -> None:
        from variantcalling_tpu_torch import featurize
        from variantcalling_tpu_torch.pipelines import filter_variants as fv

        if record.msg == fv.STAGE_LOG:
            name, seconds = record.args
            self.stages[name] = self.stages.get(name, 0.0) + seconds
        elif record.msg == fv.WINDOW_LOG:
            self.window_path = record.args[0]
            self.window_paths[self.window_path] = self.window_paths.get(self.window_path, 0) + 1
        elif record.msg == fv.TRANSFER_LOG:
            self.tables.append(record.args[1])
            nbytes = record.args[0] + (self.sent["bytes"] if self.sent else 0)
            self.sent = {"bytes": nbytes, "variants": sum(self.tables),
                         "bytes_per_variant": nbytes / max(sum(self.tables), 1)}
        elif record.msg == fv.STREAM_LOG:
            keys = ("output", "layout", "chunks", "resumed", "quarantined", "records", "cache_hits",
                    "peak_device_bytes")
            self.stream = dict(zip(keys, record.args))
        elif record.msg == featurize.GENOME_LOG:
            device, nbytes, source, encode_s, upload_s = record.args
            self.genome = {"device": str(device), "bytes": nbytes, "source": source, "encode_s": encode_s,
                           "upload_s": upload_s}


def _strip(data: bytes) -> bytes:
    return b"\n".join(ln for ln in data.split(b"\n") if not ln.startswith(b"##vctpu_"))


def _qual_column(data: bytes) -> list[bytes]:
    return [ln.split(b"\t", 6)[5] for ln in data.split(b"\n") if ln and not ln.startswith(b"#")]


def _check_qual(world: dict, data: bytes, label: str) -> int:
    """The output's QUAL column is the input's, record for record (the text as
    read: "69.40" stays "69.40", as the reference writes it). Returns the count."""
    if "quals" not in world:
        world["quals"] = _qual_column(Path(world["vcf"]).read_bytes())
    got = _qual_column(data)
    bad = sum(g != w for g, w in zip(got, world["quals"]))
    check(len(got) == len(world["quals"]) and bad == 0,
          f"{label}: {bad} of {len(got)} QUAL values differ from the input's")
    return len(got)


def _drive(world: dict, out: Path, backend: str, card: str, label: str, strategy: str | None = None,
           model_name: str | None = None, extra: list[str] | None = None, rc_expected: int = 0,
           env: dict[str, str] | None = None, host_path: tuple[str, ...] = (), input_vcf: str | None = None,
           raises: type | None = None, served: tuple[str, ...] = HOST_ENGINE_PATH) -> dict:
    """One ``filter_variants_pipeline`` run through ``run(argv)``; every kernel's
    launch count and every host engine entry point's count are set to 0 just
    before it and read just after (a ``HOST_ENGINE`` line). A GPU run's QUAL
    column must be its input's (:func:`_check_qual`), and, unless ``env``
    turns the engine off, the native host engine must have served
    ``served`` (default :data:`HOST_ENGINE_PATH`) and ``host_path`` and no
    call of the plain versions. ``extra``: more arguments; ``env``: variables set for the run,
    over ``VCTPU_STREAM=0`` (the serial path, whose stages, window path and
    transfers the earlier phases check; ``phase_streaming`` sets it to 1);
    ``input_vcf``: another input than the world's; ``rc_expected``: the exit
    code the run must give (a run that must fail returns before any output
    is read); ``raises``: the exception the run must raise instead, with no
    output written."""
    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.pipelines import filter_variants

    argv = ["--input_file", input_vcf or world["vcf"], "--model_file", world["model"],
            "--model_name", model_name or world["model_name"],
            "--reference_file", world["fasta"], "--output_file", str(out), "--backend", backend, *(extra or [])]
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    times = _RunLog()
    plog.addHandler(times)
    env = {"VCTPU_STREAM": "0", **(env or {}), **({fmod.FOREST_STRATEGY_ENV: strategy} if strategy is not None else {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.synchronize()
    forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    native.reset_calls()
    t0 = time.perf_counter()
    try:
        rc = filter_variants.run(argv)
    except Exception as e:
        if raises is None or not isinstance(e, raises):
            raise
        rc = e
    finally:
        seconds = time.perf_counter() - t0
        launches = {"forest_wide": forest_cuda.LAUNCHES, "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES}
        host = {k: dict(v) for k, v in native.CALLS.items() if v["native"] or v["plain"]}
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        plog.removeHandler(times)
    if raises is not None:
        check(isinstance(rc, raises) and not out.exists(), f"{label}: the run did not raise {raises.__name__} "
              f"with no output ({rc!r}, {out} exists: {out.exists()})")
        print(f"pipeline {label} --backend {backend}: raised {rc!r} as it must, no output", flush=True)
        return {"raised": rc, "stream": times.stream}
    check(rc == rc_expected, f"{label} --backend {backend} run exited {rc}, not {rc_expected}")
    if rc != 0:
        check(not out.exists(), f"{label}: the run that exited {rc} wrote {out}")
        print(f"pipeline {label} --backend {backend}: exited {rc} as it must, no output, stages run: "
              f"{sorted(times.stages)}", flush=True)
        return {"rc": rc, "stages": times.stages}
    no_native = env.get("VCTPU_NO_NATIVE") == "1"
    print("HOST_ENGINE " + json.dumps({"world": label, "backend": backend, "no_native": no_native,
                                       "entry_points": host}), flush=True)
    if no_native:
        check(all(v["native"] == 0 for v in host.values()), f"{label}: the engine served with VCTPU_NO_NATIVE=1")
    elif backend == "gpu":
        missed = [k for k in (*served, *host_path) if host.get(k, {}).get("native", 0) == 0]
        plain = [k for k, v in host.items() if v["plain"]]
        check(not missed and not plain, f"{label}: the host engine did not serve {missed}; plain versions "
              f"served {plain}")
    n = WORLD["n_variants"]
    print(f"pipeline {label} --backend {backend}: {seconds:.2f} s, {n / seconds:.0f} variants/s, "
          f"launches {launches}, windows: {times.window_path}, "
          f"{times.sent['bytes_per_variant'] if times.sent else 0.0:.2f} bytes a variant sent to the device "
          f"({card})", flush=True)
    if times.genome is not None:
        print(f"pipeline {label} --backend {backend}: resident genome built: {times.genome}", flush=True)
    print("PIPELINE_STAGES " + json.dumps({"world": label, "backend": backend, "no_native": no_native,
                                           "total_s": seconds, "launches": launches,
                                           "window_path": times.window_path, "sent": times.sent,
                                           "genome_build": times.genome, **times.stages}), flush=True)
    data = out.read_bytes()
    data = gzip.decompress(data) if str(out).endswith(".gz") else data
    if backend == "gpu":
        print(f"pipeline {label}: QUAL of all {_check_qual(world, data, label)} records as in the input", flush=True)
    return {"bytes": data, "seconds": seconds, "launches": launches, "window_path": times.window_path,
            "window_paths": times.window_paths, "tables": times.tables, "stream": times.stream,
            "stages": times.stages, "genome": times.genome, "host": host}


def _check_same(gpu: dict, cpu: dict, strategy: str, kernel: str, label: str) -> None:
    """The GPU run wrote the CPU run's bytes outside ##vctpu_*, recorded its
    engine and strategy, launched ``kernel`` and no other kernel; the scores
    are in [0, 1] and split the records between PASS and LOW_SCORE."""
    check(_strip(gpu["bytes"]) == _strip(cpu["bytes"]), f"{label}: GPU and CPU outputs differ outside ##vctpu_*")
    check(gpu["window_path"] == cpu["window_path"] == "genome-resident",
          f"{label}: windows not from the resident genome ({gpu['window_path']}, {cpu['window_path']})")
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


def _host_gather_run(world: dict, tmp: Path, card: str, resident_gpu: dict) -> dict:
    """The forest pickle world on the card with windows from the host gather
    (the resident-genome threshold set past the table, the genome cache hidden
    for the run), read from a BGZF copy of its callset and written as
    ``.vcf.gz``, each through the native host engine, as is the gather: the
    resident GPU run's records, a ``.tbi`` beside it, and a region read through
    the port's index that returns the plain output's records of the region."""
    from variantcalling_tpu_torch import featurize
    from variantcalling_tpu_torch.io import tabix

    from variantcalling_tpu_torch.io.bgzf import BgzfWriter

    out = tmp / "forest_pickle_gpu_host_gather.vcf.gz"
    vcf_gz = tmp / "forest_pickle_calls.vcf.gz"
    with BgzfWriter(str(vcf_gz)) as fh:
        fh.write(Path(world["vcf"]).read_bytes())
    saved = featurize.GENOME_RESIDENT_MIN_VARIANTS, featurize._DEVICE_GENOME_CACHE
    featurize.GENOME_RESIDENT_MIN_VARIANTS, featurize._DEVICE_GENOME_CACHE = WORLD["n_variants"] + 1, {}
    try:
        run = _drive(world, out, "gpu", card, "forest_pickle_host_gather", input_vcf=str(vcf_gz),
                     host_path=("bgzf_decompress_array", "gather_windows_contig", "bgzf_compress"))
    finally:
        featurize.GENOME_RESIDENT_MIN_VARIANTS, featurize._DEVICE_GENOME_CACHE = saved
    check(run["window_path"] == "host gather", f"the host-gather run took {run['window_path']}")
    check(run["launches"]["forest_wide"] > 0, "the host-gather run never launched forest_wide")
    check(_strip(run["bytes"]) == _strip(resident_gpu["bytes"]),
          "host-gather and genome-resident GPU runs differ outside ##vctpu_*")
    tbi = Path(f"{out}.tbi")
    check(tbi.exists(), "no .tbi beside the .vcf.gz output")
    beg, end = 20_000_000, 20_500_000
    got = list(tabix.read_region_lines(str(out), WORLD["contig"], beg, end, tabix.TabixIndex.load(str(tbi))))
    want = [ln for ln in resident_gpu["bytes"].decode().splitlines() if not ln.startswith("#")
            and beg < int(ln.split("\t")[1]) + len(ln.split("\t")[3]) and int(ln.split("\t")[1]) - 1 < end]
    check(len(want) > 100 and got == want, f"region read: {len(got)} records, the plain output has {len(want)}")
    print(f"pipeline forest_pickle_host_gather: bytes equal the genome-resident GPU run's; .tbi "
          f"{tbi.stat().st_size} bytes; {WORLD['contig']}:{beg}-{end} through the index: {len(got)} records, "
          f"as in the plain output", flush=True)
    return run


def phase_pipeline(tmp: Path, card: str) -> dict:
    from variantcalling_tpu_torch import synthetic

    runs = {}
    for label, seed, xgboost in (("forest_pickle", 2026, False), ("xgboost_json", 2027, True)):
        t0 = time.perf_counter()
        world = {**synthetic.write_world(str(tmp / label), seed=seed, xgboost=xgboost, **WORLD), "seed": seed}
        if not xgboost:  # the threshold model and the DAN share the forest's pickle
            world["families"] = synthetic.add_family_models(world["model"], seed=seed + 100)
        print(f"world {label}: {WORLD['n_variants']} variants on {WORLD['length']} bp in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cpu = _drive(world, tmp / f"{label}_cpu.vcf", "cpu", card, label)
        if xgboost:
            records = [ln for ln in cpu["bytes"].decode().splitlines() if not ln.startswith("#")]
            missing = sum(";SOR=" not in ln for ln in records)
            check(0.05 * len(records) < missing < 0.15 * len(records), f"{missing} records lack SOR")
        # auto: every forest within GEMM_MAX_LEAVES, default_left or not, on the wide kernel
        gpu = _drive(world, tmp / f"{label}_gpu.vcf", "gpu", card, label)
        _check_same(gpu, cpu, "cuda-wide", "forest_wide", label)
        twin = _drive(world, tmp / f"{label}_gpu_no_native.vcf", "gpu", card, label + "_no_native",
                      env={"VCTPU_NO_NATIVE": "1"})
        check(twin["bytes"] == gpu["bytes"] and twin["launches"] == gpu["launches"],
              f"{label}: the VCTPU_NO_NATIVE=1 run differs from the native run")
        print("HOST_ENGINE_TWINS " + json.dumps({"world": label, **{
            stage: {"native": gpu["stages"].get(stage), "no_native": twin["stages"].get(stage)}
            for stage in ("ingest", "host_featurize", "writeback")}}), flush=True)
        gemm = _drive(world, tmp / f"{label}_gpu_gemm.vcf", "gpu", card, label + "_gemm", strategy="gemm")
        _check_same(gemm, cpu, "cuda-gemm", "forest_tree_step", label + " (gemm)")
        runs[label] = {"world": world, "wide_gpu": gpu, "wide_gpu_no_native": twin, "gemm_gpu": gemm}
        if not xgboost:
            runs[label]["host_gather_gpu"] = _host_gather_run(world, tmp, card, gpu)
    return runs


def _family_cli(world: dict, tmp: Path, card: str, family: str, tol: float) -> dict:
    """One family's model through the CLI on the card and on the CPU: no kernel
    launched, the family recorded, the records differing only as
    ``tests/torch_vcf_compare.py`` allows (counted)."""
    from tests.torch_vcf_compare import differing_records
    from variantcalling_tpu_torch.models import registry

    name = world["families"][family]
    model = registry.load_model(world["model"], name)
    label = f"forest_pickle_{family}"
    gpu = _drive(world, tmp / f"{label}_gpu.vcf", "gpu", card, label, model_name=name)
    cpu = _drive(world, tmp / f"{label}_cpu.vcf", "cpu", card, label, model_name=name)
    check(all(v == 0 for v in gpu["launches"].values()), f"{label}: a forest kernel was launched")
    check(gpu["window_path"] == cpu["window_path"] == "genome-resident", f"{label}: windows not resident")
    lines = gpu["bytes"].decode().splitlines()
    check(f"##vctpu_model_family={family}" in lines and "##vctpu_forest_strategy=torch" in lines
          and "##vctpu_engine=cuda" in lines, f"{label}: the GPU output does not record cuda, torch and {family}")
    n_diff = differing_records(gpu["bytes"], cpu["bytes"], model.pass_threshold, tol)
    records = [ln for ln in lines if not ln.startswith("#")]
    n_pass = sum(ln.split("\t")[6] in ("PASS", "HPOL_RUN") for ln in records)
    check(len(records) == WORLD["n_variants"] and 0 < n_pass < len(records), f"{label}: {n_pass} PASS")
    print(f"pipeline {label}: GPU and CPU outputs: {n_diff} of {len(records)} records differ, each within "
          f"{tol:g} of the rule; {n_pass} PASS", flush=True)
    return {"cli_differing_records": n_diff, "records": len(records), "pass": n_pass,
            "gpu_s": gpu["seconds"], "cpu_s": cpu["seconds"]}


def phase_families(world: dict, tmp: Path, card: str) -> dict:
    """The threshold and DAN families on the forest pickle world's callset:
    through the CLI (:func:`_family_cli`), then through the API on the
    world's feature matrix: GPU against CPU, the DAN's row invariance and
    its indifference to a global TF32 request, and their CUDA-event times."""
    from variantcalling_tpu_torch.featurize import host_featurize, materialize_features
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.models import dan, registry, threshold

    out = {"dan": _family_cli(world, tmp, card, "dan", 1e-5),
           "threshold": _family_cli(world, tmp, card, "threshold", 1e-6)}
    with FastaReader(world["fasta"]) as fasta:
        hf = host_featurize(read_vcf(world["vcf"]), fasta)
    fs = materialize_features(hf, device="cuda")
    names = fs.feature_names
    x_cpu = torch.from_numpy(fs.matrix())
    x = x_cpu.cuda()
    n = x.shape[0]

    torch.backends.cuda.matmul.allow_tf32 = False
    model = registry.load_model(world["model"], world["families"]["dan"])
    cfg = model.cfg
    check((cfg.hidden, cfg.n_layers, cfg.embed_dim, cfg.n_numeric) == (256, 2, 16, 17), f"DAN widths {cfg}")
    scorer = dan.make_score_predictor(model, names, "cuda")
    s_gpu = scorer(x)
    s_cpu = dan.make_score_predictor(model, names, "cpu")(x_cpu)
    err = float((s_gpu.cpu() - s_cpu).abs().max())
    check(err <= 1e-5, f"DAN: GPU and CPU scores differ by {err}")
    chunks = torch.cat([scorer(x[lo: lo + 1000]) for lo in range(0, n, 1000)])
    check(torch.equal(chunks, s_gpu), "DAN: scores in chunks of 1,000 differ from one call's")
    with dan.full_float32(), torch.no_grad():  # cuBLAS at the caller's shapes, without the row blocks
        whole = scorer.logits(x)
        parts = torch.cat([scorer.logits(x[lo: lo + 1000]) for lo in range(0, n, 1000)])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        s_tf32 = scorer(x)
        check(torch.backends.cuda.matmul.allow_tf32, "DAN: the scorer left the caller's TF32 request changed")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(s_tf32, s_gpu), "DAN: a global TF32 request changed the scores")
    in_dim = cfg.n_numeric + 2 * cfg.embed_dim
    flops = 2 * n * (in_dim * cfg.hidden + (cfg.n_layers - 1) * cfg.hidden ** 2 + cfg.hidden)
    nbytes = x.numel() * 4 + sum(v.size * 4 for v in model.params_np.values()) + n * 4
    dan_detail = {
        "rows": n, "max_abs_err_gpu_cpu": err, "row_invariant_chunks_1000": True, "tf32_request_equal": True,
        "unblocked_row_invariant": bool(torch.equal(whole, parts)),
        "unblocked_max_abs_logit_diff": float((whole - parts).abs().max()),
        "ms": cuda_ms(lambda: scorer(x)), "unblocked_ms": cuda_ms(lambda: scorer.logits(x)),
        "flops": flops, "bytes": nbytes, "bound_ms": max(flops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / FP32_OPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"}
    t0 = time.perf_counter()
    dan.make_score_predictor(model, names, "cpu")(x_cpu)
    dan_detail["cpu_host_ms"] = (time.perf_counter() - t0) * 1e3

    tmodel = registry.load_model(world["model"], world["families"]["threshold"])
    tscore = threshold.make_score_predictor(tmodel, names, torch.device("cuda"))
    t_gpu = tscore(x)
    terr = float((t_gpu.cpu() - threshold.make_score_predictor(tmodel, names, torch.device("cpu"))(x_cpu)).abs().max())
    check(terr <= 1e-6, f"threshold: GPU and CPU scores differ by {terr}")
    threshold_detail = {"rows": n, "max_abs_err_gpu_cpu": terr, "ms": cuda_ms(lambda: tscore(x)),
                        "features": tmodel.feature_names}
    out["dan"].update(dan_detail)
    out["threshold"].update(threshold_detail)
    for fam, detail in out.items():
        print("FAMILY_DETAIL " + json.dumps({"family": fam, "card": card, **detail}), flush=True)
    print(f"families: DAN GPU vs CPU max abs err {err:.3g} (<= 1e-5), one call == chunks of 1,000, TF32 request "
          f"changed nothing, {dan_detail['ms']:.3f} ms for {n} rows (bound {dan_detail['bound_ms']:.3f} ms); "
          f"threshold max abs err {terr:.3g} (<= 1e-6)", flush=True)
    return out


def _cohort_fp(data: bytes) -> int:
    return sum(ln.split(b"\t", 7)[6].startswith(b"COHORT_FP") for ln in data.split(b"\n")
               if ln and not ln.startswith(b"#"))


def phase_blacklists(world: dict, tmp: Path, card: str) -> dict:
    """The forest pickle world with the committed h5 blacklists
    (``tests/torch_data/``: the JAX package's layout and a pytables fixed
    frame whose object block is a chunked VLArray), read by the port's own
    HDF5 parser: ``--backend gpu`` (``auto`` -> ``cuda-wide``) with each, and
    with the same loci as a ``.bed``; ``--backend cpu`` with the first. The
    loci are those the stated seeds draw from the world's positions; all four
    outputs are equal outside ``##vctpu_*`` and mark as many records
    COHORT_FP as there are loci in the world."""
    from tests import torch_worlds
    from variantcalling_tpu_torch.synthetic import blacklist_loci
    from variantcalling_tpu_torch.utils import h5_utils

    want = blacklist_loci(torch_worlds.BLACKLIST_WORLD_SEED, torch_worlds.BLACKLIST_SEED, torch_worlds.BLACKLIST_LOCI,
                          WORLD["length"], WORLD["n_variants"])
    check(world["seed"] == torch_worlds.BLACKLIST_WORLD_SEED, "the blacklists are of another world")
    for layout, path in torch_worlds.BLACKLIST_FILES.items():
        frame = h5_utils.read_hdf(str(path), key=h5_utils.list_keys(str(path))[0])
        check(np.array_equal(frame["pos"], want) and set(frame["chrom"]) == {WORLD["contig"]},
              f"the {layout} blacklist does not hold the seeded loci")
    bed = tmp / "blacklist.bed"
    bed.write_text("".join(f"{WORLD['contig']}\t{p - 1}\t{p}\n" for p in want))
    world_pos = {int(ln.split(b"\t", 2)[1]) for ln in Path(world["vcf"]).read_bytes().split(b"\n")
                 if ln and not ln.startswith(b"#")}
    present = len(world_pos & set(want.tolist()))
    check(present > 0, "no blacklist locus is a variant of the world")
    runs = {}
    for name, path, backend in (("h5_vctpu", torch_worlds.BLACKLIST_FILES["vctpu"], "gpu"),
                                ("h5_pytables", torch_worlds.BLACKLIST_FILES["pytables"], "gpu"),
                                ("bed", bed, "gpu"), ("h5_vctpu", torch_worlds.BLACKLIST_FILES["vctpu"], "cpu")):
        label = f"forest_pickle_blacklist_{name}"
        runs[f"{name}_{backend}"] = run = _drive(world, tmp / f"{label}_{backend}.vcf", backend, card, label,
                                                 extra=["--blacklist", str(path)])
        marked = _cohort_fp(run["bytes"])
        check(marked == present,
              f"{label} --backend {backend}: {marked} records COHORT_FP, {present} loci in the world")
        if backend == "gpu":
            check(run["launches"] == {"forest_wide": 1, "forest_tree_step": 0}, f"{label}: launches {run['launches']}")
    base = _strip(runs["h5_vctpu_cpu"]["bytes"])
    for key, run in runs.items():
        check(_strip(run["bytes"]) == base, f"blacklist {key}: output differs from the CPU run with the h5 file")
    print(f"blacklists: the h5 (vctpu layout), h5 (pytables layout) and .bed GPU runs and the h5 CPU run write "
          f"the same bytes outside ##vctpu_*; {present} of {len(want)} loci in the world, {present} records "
          f"COHORT_FP in each; launches {runs['h5_pytables_gpu']['launches']}", flush=True)
    return {k: {"seconds": r["seconds"], "launches": r["launches"], "cohort_fp": present} for k, r in runs.items()}


def phase_sidecar(world: dict, tmp: Path, card: str) -> dict:
    """The ``.venc`` genome sidecar under a fresh ``VCTPU_GENOME_CACHE_DIR``,
    with the process's resident-genome cache cleared before each run: a GPU
    run encodes the genome and writes the sidecar (its size: the magic, the
    JSON line and the contig's bytes); a second memory-maps it; their bytes
    are equal; ``VCTPU_GENOME_CACHE=0`` reads and writes none; and
    ``VCTPU_GENOME_CACHE=maybe`` exits 2 before any ingest."""
    from variantcalling_tpu_torch import featurize

    cache = tmp / "venc"
    saved = {k: os.environ.get(k) for k in ("VCTPU_GENOME_CACHE", "VCTPU_GENOME_CACHE_DIR")}
    saved_cache = featurize._DEVICE_GENOME_CACHE
    os.environ["VCTPU_GENOME_CACHE_DIR"] = str(cache)
    out = {}
    try:
        for label, setting in (("sidecar_written", "1"), ("sidecar_read", "1"), ("sidecar_off", "0"),
                               ("sidecar_malformed", "maybe")):
            os.environ["VCTPU_GENOME_CACHE"] = setting
            featurize._DEVICE_GENOME_CACHE = {}
            before = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()} if cache.exists() else {}
            run = _drive(world, tmp / f"forest_pickle_{label}.vcf", "gpu", card, f"forest_pickle_{label}",
                         rc_expected=2 if setting == "maybe" else 0)
            after = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()} if cache.exists() else {}
            out[label] = run
            if setting == "maybe":
                check("ingest" not in run["stages"] and after == before, "VCTPU_GENOME_CACHE=maybe ran or wrote")
                continue
            check(run["launches"]["forest_wide"] > 0 and run["window_path"] == "genome-resident",
                  f"{label}: launches {run['launches']}, windows {run['window_path']}")
            genome = run["genome"]
            print(f"pipeline forest_pickle_{label}: genome stage {run['stages']['genome']:.4f} s; "
                  f"GENOME_LOG {genome}", flush=True)
            if label == "sidecar_written":
                (name,) = after
                data = (cache / name).read_bytes()
                head = data.index(b"\n", 7) + 1
                check(genome["source"] == "encoded" and data[:7] == b"VCENC1\n"
                      and len(data) == head + WORLD["length"],
                      f"sidecar {name}: {len(data)} bytes, source {genome['source']}")
                print(f"sidecar {name}: {len(data)} bytes = 7 (magic) + {head - 7} (JSON line) + "
                      f"{WORLD['length']} (codes)", flush=True)
            elif label == "sidecar_read":
                check(genome["source"] == "sidecar" and after == before, f"{label}: {genome['source']}, files changed")
            else:
                check(genome["source"] == "encoded" and after == before, f"{label}: {genome['source']}, files changed")
            check(_strip(run["bytes"]) == _strip(out["sidecar_written"]["bytes"]),
                  f"{label}: output differs from the run that wrote the sidecar")
    finally:
        featurize._DEVICE_GENOME_CACHE = saved_cache
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("sidecar: written, then memory-mapped, then unused with VCTPU_GENOME_CACHE=0, bytes equal; "
          "VCTPU_GENOME_CACHE=maybe exits 2 before ingest", flush=True)
    return {k: {"genome_stage_s": r["stages"].get("genome"), "genome": r.get("genome")} for k, r in out.items()}


#: the streaming phase's world: GRCh38's chr20, chr21 and chr22 at 5 M variants
#: (a 30x WGS callset's record count), the xgboost JSON model
WORLD_STREAM = dict(n_variants=5_000_000, n_trees=100, depth=7)
#: the 104,000-variant world's chunk size in the streaming phase: 8 chunks
STREAM_SMALL_CHUNK = 1 << 20


def _sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(16 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _stream_child(spec: dict, results) -> None:
    """One CLI run in a process of its own, for its own peak RSS: ``spec``
    holds ``argv`` and ``env``; ``argv`` None runs nothing past the imports
    and the card's context (the baseline the runs' peaks stand on). Every
    kernel's and engine entry point's count set to 0 just before the run and
    read just after; the numbers go to ``results`` (a queue)."""
    import resource

    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.pipelines import filter_variants

    os.environ.update(spec["env"])
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    times = _RunLog()
    plog.addHandler(times)
    torch.cuda.init()
    forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    native.reset_calls()
    t0 = time.perf_counter()
    if spec["argv"] is None:
        torch.zeros(1, device="cuda").add_(1).cpu()
        rc = 0
    else:
        rc = filter_variants.run(spec["argv"])
    seconds = time.perf_counter() - t0
    results.put({
        "rc": rc, "seconds": seconds,
        "launches": {"forest_wide": forest_cuda.LAUNCHES, "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES},
        "host": {k: dict(v) for k, v in native.CALLS.items() if v["native"] or v["plain"]},
        "window_paths": times.window_paths, "tables": times.tables, "stream": times.stream,
        "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "stages": times.stages})


def _forked(spec: dict, label: str) -> dict:
    """:func:`_stream_child` in a process forked by a ``forkserver``: a child
    started otherwise keeps this process's peak in its ``ru_maxrss``."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("forkserver")
    results = ctx.Queue()
    proc = ctx.Process(target=_stream_child, args=(spec, results), name=label)
    proc.start()
    run = None
    deadline = time.monotonic() + 900
    while run is None and time.monotonic() < deadline and (proc.is_alive() or not results.empty()):
        try:
            run = results.get(timeout=1)
        except queue.Empty:
            pass
    proc.join(timeout=60)
    if proc.is_alive():
        proc.kill()
        proc.join()
    check(run is not None and proc.exitcode == 0, f"{label}: the run's process exited {proc.exitcode}")
    return run


def _stream_subprocess(world: dict, out: Path, card: str, label: str, env: dict[str, str]) -> dict:
    """One 5 M-variant CLI run (``--backend gpu``) in a process of its own
    (:func:`_forked`): served by the host engine, every table that reached
    the card on the resident genome, one ``forest_wide`` launch a
    262,144-row piece of each, and a ``STREAM_DETAIL`` line."""
    argv = ["--input_file", world["vcf"], "--model_file", world["model"], "--model_name", world["model_name"],
            "--reference_file", world["fasta"], "--output_file", str(out), "--backend", "gpu"]
    run = _forked({"argv": argv, "env": env}, label)
    check(run["rc"] == 0, f"{label}: exit {run['rc']}")
    host = run["host"]
    missed = [k for k in HOST_ENGINE_PATH if host.get(k, {}).get("native", 0) == 0]
    plain = [k for k, v in host.items() if v["plain"]]
    check(not missed and not plain, f"{label}: the host engine did not serve {missed}; plain: {plain}")
    check(set(run["window_paths"]) == {"genome-resident"}, f"{label}: window paths {run['window_paths']}")
    want = sum(-(-n // KERNEL_ROWS) for n in run["tables"])
    check(run["launches"] == {"forest_wide": want, "forest_tree_step": 0},
          f"{label}: launches {run['launches']}, {want} expected from {len(run['tables'])} tables")
    n = WORLD_STREAM["n_variants"]
    check(sum(run["tables"]) == n, f"{label}: {sum(run['tables'])} variants reached the card")
    stream = run["stream"] or {}
    detail = {"world": "stream_5m", "run": label, "card": card, "layout": stream.get("layout", "serial"),
              "chunks": stream.get("chunks", 1), "window_paths": run["window_paths"],
              "forest_wide_launches": run["launches"]["forest_wide"], "wall_s": run["seconds"],
              "variants_per_s": n / run["seconds"], "peak_rss_bytes": run["peak_rss_bytes"],
              "peak_device_bytes": run["peak_device_bytes"],
              "host_engine_s": {k: v["native_s"] for k, v in host.items()}, "stages": run["stages"]}
    print("STREAM_DETAIL " + json.dumps(detail), flush=True)
    return {**detail, "sha256": _sha256(out)}


def _stream_detail(run: dict, label: str, card: str, n: int) -> None:
    stream = run.get("stream") or {}
    print("STREAM_DETAIL " + json.dumps({
        "world": "forest_pickle_104k", "run": label, "card": card, "layout": stream.get("layout", "serial"),
        "chunks": stream.get("chunks", 1), "resumed": stream.get("resumed", 0),
        "cache_hits": stream.get("cache_hits", 0), "window_paths": run.get("window_paths"),
        "forest_wide_launches": run["launches"]["forest_wide"], "wall_s": run["seconds"],
        "variants_per_s": n / run["seconds"], "peak_device_bytes": stream.get("peak_device_bytes")}), flush=True)


def phase_streaming(tmp: Path, card: str, pickle_world: dict) -> dict:
    """The streaming executor, the port's default path, on the card.

    1. ``WORLD_STREAM``: the xgboost JSON model over 5 M variants on chr20,
       chr21 and chr22 at GRCh38's lengths: the default run (streaming, the
       pooled layout, 8 MiB chunks), ``VCTPU_IO_THREADS=1`` and
       ``VCTPU_STREAM=0`` (serial), each in its own process
       (:func:`_stream_subprocess`); the three outputs equal; the streaming
       runs' peak RSS below the serial run's.
    2. The forest pickle world (104,000 variants on chr20) in 1 MiB chunks:
       into ``.vcf.gz``, streaming against serial (container and ``.tbi``
       bytes); a run failed by ``io.writeback:0+3`` (partial and journal
       kept, no output) resumed to the clean bytes; ``VCTPU_CACHE=1`` twice
       under a fresh directory, the second all hits with no launch and equal
       bytes; the pickle's DAN and threshold models streaming against their
       serial GPU runs, within the tolerance rule.
    """
    from tests.torch_vcf_compare import differing_records
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.io import journal
    from variantcalling_tpu_torch.models import registry
    from variantcalling_tpu_torch.utils import faults

    out: dict = {}
    # -- 1. the 5 M world ---------------------------------------------------
    t0 = time.perf_counter()
    world = synthetic.write_world(str(tmp / "stream_5m"), seed=2028, xgboost=True,
                                  contigs=list(synthetic.GRCH38_CHR20_22), **WORLD_STREAM)
    print(f"world stream_5m: {WORLD_STREAM['n_variants']} variants on "
          f"{', '.join(f'{c} ({n} bp)' for c, n in synthetic.GRCH38_CHR20_22)}, "
          f"{os.path.getsize(world['vcf'])} bytes of VCF, in {time.perf_counter() - t0:.1f} s", flush=True)
    base = _forked({"argv": None, "env": {}}, "stream_5m_baseline")
    print("STREAM_DETAIL " + json.dumps({"world": "stream_5m", "run": "baseline", "card": card,
                                         "peak_rss_bytes": base["peak_rss_bytes"],
                                         "peak_device_bytes": base["peak_device_bytes"]}), flush=True)
    runs = {label: _stream_subprocess(world, tmp / f"stream_5m_{label}.vcf", card, f"stream_5m_{label}", env)
            for label, env in (("default", {}), ("io_threads_1", {"VCTPU_IO_THREADS": "1"}),
                               ("serial", {"VCTPU_STREAM": "0"}))}
    check(runs["default"]["layout"] == "pooled" and runs["io_threads_1"]["layout"] == "serial-io"
          and runs["serial"]["layout"] == "serial", f"layouts {[r['layout'] for r in runs.values()]}")
    check(len({r["sha256"] for r in runs.values()}) == 1, "the 5 M outputs differ between the runs")
    check(all(runs[k]["peak_rss_bytes"] < runs["serial"]["peak_rss_bytes"] for k in ("default", "io_threads_1")),
          f"peak RSS: {[r['peak_rss_bytes'] for r in runs.values()]}")
    print(f"streaming 5M: default, VCTPU_IO_THREADS=1 and serial outputs identical "
          f"({runs['default']['chunks']} chunks); peak RSS "
          f"{[runs[k]['peak_rss_bytes'] >> 20 for k in runs]} MiB ({card})", flush=True)
    for f in tmp.glob("stream_5m_*.vcf"):
        f.unlink()
    out["stream_5m"] = runs

    # -- 2. the 104,000-variant world in 1 MiB chunks --------------------------
    w = pickle_world
    n = WORLD["n_variants"]
    stream_env = {"VCTPU_STREAM": "1", "VCTPU_STREAM_CHUNK_BYTES": str(STREAM_SMALL_CHUNK)}
    gz_stream = _drive(w, tmp / "stream_104k.vcf.gz", "gpu", card, "stream_104k_gz", env=stream_env,
                       host_path=("bgzf_compress",))
    gz_serial = _drive(w, tmp / "serial_104k.vcf.gz", "gpu", card, "serial_104k_gz", host_path=("bgzf_compress",))
    check(gz_stream["stream"]["chunks"] >= 7 and set(gz_stream["window_paths"]) == {"genome-resident"},
          f"stream_104k_gz: {gz_stream['stream']}, {gz_stream['window_paths']}")
    check((tmp / "stream_104k.vcf.gz").read_bytes() == (tmp / "serial_104k.vcf.gz").read_bytes()
          and (tmp / "stream_104k.vcf.gz.tbi").read_bytes() == (tmp / "serial_104k.vcf.gz.tbi").read_bytes(),
          "streaming and serial .vcf.gz or .tbi bytes differ")
    check(gz_stream["launches"]["forest_wide"] == gz_stream["stream"]["chunks"],
          f"stream_104k_gz: launches {gz_stream['launches']} for {gz_stream['stream']['chunks']} chunks")
    _stream_detail(gz_stream, "stream_vcf_gz", card, n)
    print(f"streaming 104k .vcf.gz: container and .tbi bytes equal the serial run's, "
          f"{gz_stream['stream']['chunks']} chunks", flush=True)

    clean = _drive(w, tmp / "stream_104k_clean.vcf", "gpu", card, "stream_104k_clean", env=stream_env)
    target = tmp / "stream_104k_resumed.vcf"
    for spec in faults.parse_spec("io.writeback:0+3"):
        faults.arm(spec[0], times=spec[1], seconds=spec[2], after=spec[3])
    try:
        failed = _drive(w, target, "gpu", card, "stream_104k_interrupted", env=stream_env, raises=OSError)
    finally:
        faults.reset()
    kept = journal.ChunkJournal.load(str(target))
    check(kept is not None and len(kept[1]) >= 1 and len(list(tmp.glob(target.name + ".partial.*"))) == 1,
          "the interrupted run left no journal with a chunk and no partial")
    resumed = _drive(w, target, "gpu", card, "stream_104k_resumed", env=stream_env)
    check(resumed["stream"]["resumed"] >= 1 and resumed["bytes"] == clean["bytes"],
          f"resume: {resumed['stream']}, bytes equal: {resumed['bytes'] == clean['bytes']}")
    check(not Path(journal.journal_path(str(target))).exists() and not list(tmp.glob(target.name + ".partial*")),
          "the resumed run left its journal or partial")
    _stream_detail(clean, "stream_vcf_clean", card, n)
    _stream_detail(resumed, "stream_vcf_resumed", card, n)
    print(f"streaming 104k resume: the run failed at writeback ({failed['raised']!r}) with {len(kept[1])} "
          f"chunks journaled, the next "
          f"resumed {resumed['stream']['resumed']} of {resumed['stream']['chunks']} chunks, bytes equal the clean "
          f"run's", flush=True)

    cache_env = {**stream_env, "VCTPU_CACHE": "1", "VCTPU_CACHE_DIR": str(tmp / "chunk_cache")}
    cold = _drive(w, tmp / "stream_104k_cache_cold.vcf", "gpu", card, "stream_104k_cache_cold", env=cache_env)
    warm = _drive(w, tmp / "stream_104k_cache_warm.vcf", "gpu", card, "stream_104k_cache_warm", env=cache_env,
                  served=())
    check(warm["stream"]["cache_hits"] == warm["stream"]["chunks"] == cold["stream"]["chunks"]
          and cold["stream"]["cache_hits"] == 0, f"cache: cold {cold['stream']}, warm {warm['stream']}")
    check(warm["launches"] == {"forest_wide": 0, "forest_tree_step": 0} and warm["bytes"] == cold["bytes"]
          == clean["bytes"], f"cache: warm launches {warm['launches']} or bytes differ")
    _stream_detail(cold, "stream_cache_cold", card, n)
    _stream_detail(warm, "stream_cache_warm", card, n)
    print(f"streaming 104k cache: the second run hit all {warm['stream']['chunks']} chunks with no launch, "
          f"bytes equal", flush=True)

    families = {}
    for family, tol in (("dan", 1e-5), ("threshold", 1e-6)):
        name = w["families"][family]
        model = registry.load_model(w["model"], name)
        st = _drive(w, tmp / f"stream_104k_{family}.vcf", "gpu", card, f"stream_104k_{family}", model_name=name,
                    env=stream_env)
        se = _drive(w, tmp / f"serial_104k_{family}.vcf", "gpu", card, f"serial_104k_{family}", model_name=name)
        n_diff = differing_records(st["bytes"], se["bytes"], model.pass_threshold, tol)
        check(all(v == 0 for v in st["launches"].values()), f"{family}: a forest kernel was launched")
        families[family] = {"differing_records": n_diff, "chunks": st["stream"]["chunks"]}
        _stream_detail(st, f"stream_{family}", card, n)
        print(f"streaming 104k {family}: {n_diff} of {n} records differ from the serial GPU run, within "
              f"{tol:g}", flush=True)
    out["stream_104k"] = {"families": families}
    return out


def time_kernel(kind: str, root: str) -> int:
    """``--time-kernel {wide,tree_step} ROOT``: one kernel of the checkout at
    ROOT (this one, or an older one unpacked beside it) on phase 3's forests
    for that kernel at the main path's rows, one chunk and 5 M rows, with
    :func:`_launch_times`, after a parity check against its plain version. A
    kernel that refuses a forest is reported so, with no times. Two
    checkouts timed in turns in one run on one card compare their kernels.
    One ``KERNEL_TIME`` JSON line per forest and row count."""
    sys.path.insert(0, str(Path(root).resolve()))
    card = phase_card()
    phase_build()
    import variantcalling_tpu_torch
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda

    print(f"timing the {kind} kernel of {Path(variantcalling_tpu_torch.__file__).parent}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    x_all, x_nan = _inputs()
    n_main = WORLD["n_variants"]
    forests = _wide_forests(x_all, x_nan)
    if kind == "tree_step":
        forests = _tree_step_forests(forests, x_all)
    for name, (forest, x) in forests.items():
        line = {"kernel": kind, "root": root, "forest": name, "card": card}
        try:
            kernel = forest_cuda.WideForestKernel(forest, x.shape[1], "cuda") if kind == "wide" \
                else forest_cuda.TreeStepKernel(fmod.to_gemm(forest, x.shape[1]), "cuda")
        except NotImplementedError as e:
            print("KERNEL_TIME " + json.dumps({**line, "served": False, "error": str(e)}), flush=True)
            continue
        got, want = kernel.launch(x[:n_main]), kernel.plain(x[:n_main])
        check(torch.equal(got, want), f"{name}: kernel != plain")
        for n in (n_main, KERNEL_ROWS, NORTH_STAR_ROWS):
            print("KERNEL_TIME " + json.dumps({**line, "served": True, "rows": n,
                                               **_launch_times(kernel.launch, x, n)}), flush=True)
    return 0


def main() -> int:
    card = phase_card()
    build_s = phase_build()
    kern = phase_kernel(main_rows=WORLD["n_variants"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe = phase_pipeline(Path(tmp), card)
        phase_families(pipe["forest_pickle"]["world"], Path(tmp), card)
        phase_blacklists(pipe["forest_pickle"]["world"], Path(tmp), card)
        phase_sidecar(pipe["forest_pickle"]["world"], Path(tmp), card)
        stream = phase_streaming(Path(tmp), card, pipe["forest_pickle"]["world"])
    n = WORLD["n_variants"]
    rows = {  # each kernel's numbers at the main path's shape, on the production (xgboost) forest
        "forest_wide": kern["forest_wide"]["results"]["xgboost_default_left_100x64"][n],
        "forest_tree_step": kern["forest_tree_step"]["results"]["xgboost_default_left_100x64"][n],
    }
    meta = {  # launches: the 5 M world's default (streaming) run, and the xgboost world's run pinned to gemm
        "forest_wide": ("variantcalling_tpu_torch/csrc/forest_wide.cu",
                        "variantcalling_tpu/models/forest_pallas.py:105",
                        stream["stream_5m"]["default"]["forest_wide_launches"]),
        "forest_tree_step": ("variantcalling_tpu_torch/csrc/forest_tree_step.cu",
                             "variantcalling_tpu/models/forest_pallas.py:51",
                             pipe["xgboost_json"]["gemm_gpu"]["launches"]["forest_tree_step"]),
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": kern[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        # the card's time alone, and the wrapper's host time, beside the single launch's ms
        "device_ms": rows[name]["device_ms"], "host_ms": rows[name]["host_ms"],
        # no single PyTorch call computes a decision forest
        "library_ms": None,
        "build_s": build_s[name],
    } for name, (source, replaces, launches) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--time-kernel" and sys.argv[2] in ("wide", "tree_step"):
        sys.exit(time_kernel(sys.argv[2], sys.argv[3]))
    check(len(sys.argv) == 1, "usage: python3 chip_smoke.py [--time-kernel {wide,tree_step} CHECKOUT_ROOT]")
    sys.exit(main())
