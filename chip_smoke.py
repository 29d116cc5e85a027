"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: build, kernel parity, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final result line is not printed):

1. card: name and power limit (nvidia-smi), torch/CUDA versions; fails
   without a CUDA device;
2. build: compiles ``variantcalling_tpu_torch/csrc/forest_wide.cu`` with
   nvcc for sm_90a and prints the build seconds;
3. kernel: the wide-block forest kernel against its plain torch version on
   the card, bit for bit (``torch.equal``), for the train_models default
   forest (100 trees, 63 internal nodes / 64 leaves, logit_sum) and an
   sklearn-RF-shaped mean forest (100 trees, 256 leaves), at the main
   path's shape (104,000 rows), at one 262,144-row chunk and at 5,000,000
   rows in chunks;
   times with CUDA events (median after warm-up) beside the bound;
4. pipeline: ``filter_variants_pipeline`` on a synthetic chr20-scale world
   (64,444,167 bp, 104,000 variants, the 100-tree logit_sum forest) through
   ``run(argv)`` with ``--backend gpu`` and then ``--backend cpu``; the
   kernel's launch count must rise during the GPU run and the two outputs
   must be byte-identical outside the ``##vctpu_*`` lines.

The last two lines of standard output are a JSON object with the kernel
numbers and the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import time
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


def phase_build() -> float:
    from variantcalling_tpu_torch.csrc import build

    t0 = time.perf_counter()
    path = build.build("forest_wide", verbose=True)
    seconds = time.perf_counter() - t0
    print(f"build: {path.name} in {seconds:.2f} s", flush=True)
    return seconds


def _features(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 19) float32 features, each column uniform over its BASE_FEATURES range."""
    from variantcalling_tpu_torch.featurize import BASE_FEATURES
    from variantcalling_tpu_torch.synthetic import FEATURE_RANGES

    lo = np.asarray([FEATURE_RANGES[f][0] for f in BASE_FEATURES], dtype=np.float32)
    hi = np.asarray([FEATURE_RANGES[f][1] for f in BASE_FEATURES], dtype=np.float32)
    return lo + rng.random((n, len(BASE_FEATURES)), dtype=np.float32) * (hi - lo)


def _bound(kernel, n: int) -> tuple[float, str, dict]:
    """(least ms, "bytes"|"operations", detail) for scoring ``n`` rows: each input
    byte read once (features, tables), each margin written once; operations are
    the threshold compares the walk makes (complete trees: depth per tree) and
    the adds of the tree sum, at the float32 rate outside the tensor cores."""
    wf = kernel.wide()
    nbytes = n * kernel.n_features * 4 + kernel.nodes.numel() * 4 + kernel.leaf_val.numel() * 4 \
        + kernel.roots.numel() * 4 + n * 4
    plen = wf.plen.reshape(-1, kernel.n_leaf)[: wf.n_trees]
    depths = [int(p[p >= 0].max()) for p in plen]
    check(all(int(p[p >= 0].min()) == d for p, d in zip(plen, depths)), "bound assumes complete trees")
    ops = n * (sum(depths) + wf.n_trees)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops}
    return (t_bytes, "bytes", detail) if t_bytes >= t_ops else (t_ops, "operations", detail)


def _chunked(kernel_fn, x: torch.Tensor, chunk: int) -> list[torch.Tensor]:
    return [kernel_fn(x[lo: lo + chunk]) for lo in range(0, x.shape[0], chunk)]


def phase_kernel(main_rows: int) -> dict:
    from variantcalling_tpu_torch.models import forest as fmod
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.synthetic import filter_forest

    torch.backends.cuda.matmul.allow_tf32 = False  # stated: the plain version's products stay float32
    rng = np.random.default_rng(20)
    x_all = torch.from_numpy(_features(rng, NORTH_STAR_ROWS)).cuda()
    results = {}
    max_err = 0.0
    for name, depth, agg in (("train_models_default_100x64", 7, "logit_sum"),
                             ("sklearn_rf_shaped_100x256", 9, "mean")):
        forest = filter_forest(np.random.default_rng(depth), n_trees=100, depth=depth, aggregation=agg)
        check(fmod.resolve_strategy(forest, torch.device("cuda")) == "cuda-wide", f"{name}: not on the kernel")
        kernel = forest_cuda.WideForestKernel(forest, x_all.shape[1], "cuda")
        plain = kernel.plain
        # parity: every chunk of the north-star callset, bit for bit
        for lo in range(0, NORTH_STAR_ROWS, KERNEL_ROWS):
            xc = x_all[lo: lo + KERNEL_ROWS]
            got, want = kernel.launch(xc), plain(xc)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want), f"{name}: kernel != plain at rows {lo}.. (max abs err {err})")
        rows = {}
        for n in (main_rows, KERNEL_ROWS):
            xn = x_all[:n].contiguous()
            check(torch.equal(kernel.launch(xn), plain(xn)), f"{name}: kernel != plain at {n} rows")
            bound_ms, bound_by, detail = _bound(kernel, n)
            ms = cuda_ms(lambda xn=xn: kernel.launch(xn))
            rows[n] = {"ms": ms, "plain_ms": cuda_ms(lambda xn=xn: plain(xn), reps=5),
                       "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms, **detail}
        bound_ms, bound_by, detail = _bound(kernel, NORTH_STAR_ROWS)
        ms = cuda_ms(lambda: _chunked(kernel.launch, x_all, KERNEL_ROWS), reps=5, warmup=1)
        rows[NORTH_STAR_ROWS] = {
            "ms": ms, "plain_ms": cuda_ms(lambda: _chunked(plain, x_all, KERNEL_ROWS), reps=2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms, **detail,
            "launches": math.ceil(NORTH_STAR_ROWS / KERNEL_ROWS)}
        for n, r in rows.items():
            print("KERNEL_DETAIL " + json.dumps({"forest": name, "rows": n, "blocks": kernel.n_blocks,
                                                 "tree_block": kernel.tree_block, **r}), flush=True)
        results[name] = rows
    del x_all
    torch.cuda.empty_cache()
    return {"results": results, "max_abs_err": max_err}


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


def phase_pipeline(tmp: Path, card: str) -> dict:
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.models import forest_cuda
    from variantcalling_tpu_torch.pipelines import filter_variants

    t0 = time.perf_counter()
    world = synthetic.write_world(str(tmp), seed=2026, **WORLD)
    print(f"world: {WORLD['n_variants']} variants on {WORLD['length']} bp in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = ["--input_file", world["vcf"], "--model_file", world["model"], "--model_name", world["model_name"],
            "--reference_file", world["fasta"]]
    outs = {}
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    for backend in ("gpu", "cpu"):
        out = tmp / f"out_{backend}.vcf"
        times = _StageTimes(filter_variants.STAGE_LOG)
        plog.addHandler(times)
        if backend == "gpu":
            forest_cuda.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = filter_variants.run([*base, "--output_file", str(out), "--backend", backend])
        seconds = time.perf_counter() - t0
        plog.removeHandler(times)
        check(rc == 0, f"--backend {backend} run exited {rc}")
        if backend == "gpu":
            launches = forest_cuda.LAUNCHES
            check(launches > 0, "the GPU run never launched the forest kernel")
        outs[backend] = (out.read_bytes(), seconds)
        print(f"pipeline --backend {backend}: {seconds:.2f} s, "
              f"{WORLD['n_variants'] / seconds:.0f} variants/s ({card})", flush=True)
        print("PIPELINE_STAGES " + json.dumps({"backend": backend, "total_s": seconds, **times.stages}),
              flush=True)
    gpu, cpu = outs["gpu"][0], outs["cpu"][0]
    check(_strip(gpu) == _strip(cpu), "GPU and CPU outputs differ outside ##vctpu_* lines")
    lines = gpu.decode().splitlines()
    check("##vctpu_engine=cuda" in lines and "##vctpu_forest_strategy=cuda-wide" in lines,
          "GPU output does not record the cuda engine and the cuda-wide strategy")
    records = [ln for ln in lines if not ln.startswith("#")]
    check(len(records) == WORLD["n_variants"], f"{len(records)} records written")
    scores = np.asarray([float(ln.split("TREE_SCORE=")[1].split(";")[0].split("\t")[0]) for ln in records])
    check(bool(np.all(np.isfinite(scores)) and scores.min() >= 0 and scores.max() <= 1), "scores out of [0, 1]")
    n_pass = sum(ln.split("\t")[6].startswith("PASS") for ln in records)
    check(0 < n_pass < len(records), "all records share one FILTER")
    print(f"pipeline: outputs identical outside ##vctpu_*; {n_pass} PASS of {len(records)}; "
          f"kernel launches in the GPU run: {launches}", flush=True)
    return {"launches": launches, "gpu_s": outs["gpu"][1], "cpu_s": outs["cpu"][1]}


def main() -> int:
    card = phase_card()
    build_s = phase_build()
    kern = phase_kernel(main_rows=WORLD["n_variants"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe = phase_pipeline(Path(tmp), card)
    main_row = kern["results"]["train_models_default_100x64"][WORLD["n_variants"]]
    print(json.dumps({"kernels": [{
        "name": "forest_wide_margin", "route": "cuda",
        "source": "variantcalling_tpu_torch/csrc/forest_wide.cu",
        "replaces": "variantcalling_tpu/models/forest_pallas.py:105",
        "launches": pipe["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        # no single PyTorch call computes a decision forest
        "library_ms": None,
        "build_s": build_s,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
