"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: build, kernel parity, main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final result line is not printed):

1. card: name and power limit (nvidia-smi), torch/CUDA versions; fails
   without a CUDA device;
2. build: compiles the four kernel sources, ``variantcalling_tpu_torch/
   csrc/forest_wide.cu``, ``forest_tree_step.cu``, ``gbt_hist.cu`` and
   ``cnv_viterbi.cu``, with nvcc for sm_90a, and the native host engine
   (``variantcalling_tpu_torch/native/src``) with g++, the five builds
   started together, and prints each build's seconds;
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
   variants/s, peak host RSS (5 M runs) and peak card memory;
9. training (``phase_training``): ``TRAIN_WORLD``, 5,000,000 labeled
   concordance rows on GRCh38's 22 autosomes (chr20 at 104,000), written by
   the port's own HDF5 writer, through ``train_models_pipeline
   --evaluate_concordance --evaluate_concordance_contig chr20`` at the
   default 100 trees, depth 6, 64 bins, once, and 200,000 of its rows
   twice, each run in a process of its own with the kernels' counts
   set to 0 just before it: 2,400 ``gbt_hist`` launches and 5
   ``forest_wide`` launches a run, the pair's pickles and ``.h5`` frames
   equal (``TRAIN_DETAIL``: wall, seconds by stage, launches, peak
   RSS and card memory); those 200,000 rows on the card against
   ``--backend cpu`` (the native float32 trainer; the threshold models
   equal, the forests' agreement reported: ``TRAIN_NATIVE_DETAIL``), and
   ``boosting.fit`` of one model on an eighth of those rows on the card against
   the CPU torch program (``VCTPU_NATIVE_GBT=0``): equal trees, values to
   1e-5, scores to 1e-6 (``TRAIN_FIT_DETAIL``); the histogram of one tree at
   5 M rows level by level, ``torch.equal`` to its plain version, timed
   beside its bound and the bf16 one-hot ``torch.matmul``
   (``GBT_HIST_DETAIL``); ``training_prep_pipeline`` and
   ``train_models_pipeline`` in VCF mode on the 104,000-variant chr20 world
   with dbSNP IDs, a blacklist, hpol runs and an annotation, the trained
   forest then filtering it on ``cuda-wide`` to the CPU run's bytes, its
   pickle naming only the reference's classes, numpy and builtins;
10. the DAN trainer and the evaluation (``phase_dan_eval``), each run with
   every kernel's count set to 0 just before it and read just after (no
   kernel lies on these paths: none may launch): ``train_dan`` at its
   defaults (hidden 256, 2 layers, embed 16, 2,000 steps of 16,384 rows)
   on ``TRAIN_WORLD`` (22 keys: 22 journaled ingest chunks) in a process of
   its own; on 200,000 of its rows (2 keys) two pairs of ``--n_steps 400``
   then ``--n_steps 800`` on one checkpoint directory, each run a process of
   its own, the second run of each resuming 2 of 2 chunks and step 199, the
   pairs byte-equal
   (``DAN_TRAIN_DETAIL``: wall, stages, steps and rows a second, peaks, the
   logged losses); one step at those widths timed, and profiled for its
   kernels and the card's busy share (``DAN_STEP_DETAIL``); 50 steps on 200,000 of its rows on the card and on the
   CPU, losses within 1 % and scores within 5e-3 (``DAN_CPU_DETAIL``); a
   DAN trained on the 104,000-variant world's labels (its own features)
   filtering that world with ``VCTPU_MODEL_FAMILY=dan``, card against CPU
   to the DAN rule, the pickle naming only ``variantcalling_tpu.models.dan``
   classes, numpy and builtins; ``evaluate_concordance --output_bed`` on
   the 5 M rows scored by the trained DAN on the card, and on 200,000 of
   them on the card and the CPU, every file byte-equal (``EVAL_DETAIL``);
11. coverage and CNV calling (``phase_coverage``) on ``COVERAGE_WORLD``:
   the filter world's synthetic chr20 and chrM at 30x of 150-bp reads
   (about 12.9 M records with SEQ and QUAL, 3 % duplicates, 1 % secondary,
   4 % MAPQ 0, I/D/S CIGARs) with planted events at 15x, 45x and 0x,
   written by ``synthetic.write_coverage_world``; each run a process of its
   own, the counts set to 0 just before it and read just after: on the card
   at full size ``full_analysis`` (default windows, ``-c`` with a
   20,000-interval exome-like BED and the events), ``collect_coverage`` and
   ``cnv_calling --reference`` (every planted event called with its copy
   number, one ``cnv_viterbi`` launch); on a 500 kbp cut, the card against
   the CPU (``full_analysis`` with ``-c`` and with ``-q 20 -Q 20 -l 100``:
   parquets sha256-equal,
   histograms and percentiles equal, near-ties counted, stats to 1e-6; the
   inflated bedGraph and the ``.bw`` bytes equal; CNV BED and VCF bytes
   equal), a ``VCTPU_NO_NATIVE=1`` twin on that cut and a CRAM twin of a
   100 kbp cut (equal outputs), and the Viterbi kernel alone at chr20 and
   GRCh38 at 1 kb, ``torch.equal`` to its plain version (at GRCh38 on each
   contig's first 20,000 bins), beside its latency
   bound (``COVERAGE_DETAIL``, ``CNV_DETAIL``, ``CNV_KERNEL_DETAIL``,
   ``HOST_ENGINE`` lines). Phase 9's ``TRAIN_NATIVE_DETAIL`` holds the card's
   forests to the native trainer's on the held-out chr20 rows
   (``tests/torch_worlds.forest_bar``);
12. SEC and the comparison (``phase_sec``) on ``SEC_WORLD``
   (``synthetic.write_sec_world``: BASELINE config 5 cut to one contig, a
   100-sample cohort of about 52,000 records each over a pool of 60,000
   noise loci on the filter world's chr20, a 104,000-record held-out
   callset and its truth with planted representation differences); each run
   a process of its own, the counts set to 0 just before it and read just
   after (no kernel lies on this path: none may launch): ``sec_training``
   (``--use_mesh`` on the card, the host merge on the CPU: equal DBs;
   ``--relevant_coords``), ``correct_systematic_errors`` and
   ``sec_validation`` GPU against CPU (``tests/torch_sec_compare``; the
   planted noise corrected, the planted real variants kept),
   ``run_comparison_pipeline`` GPU against CPU (equal frames and BED, every
   planted representation difference ``tp``, the native matcher serving; a
   ``VCTPU_NO_NATIVE=1`` twin on a 2 Mbp cut; ``GC``),
   ``assess_sec_concordance`` and ``vcfeval_flavors`` GPU against CPU, and
   the LRT alone beside its bytes bound (``SEC_DETAIL``,
   ``COMPARISON_DETAIL``, ``SEC_LRT_DETAIL``, ``HOST_ENGINE`` lines);
13. genotypes, imputation, the gVCF tools and the runs scan
   (``phase_genotypes_gvcf``), each run a process of its own, the counts set
   to 0 just before it and read just after (no kernel lies on these paths:
   none may launch), one run after another, so each wall is its own:
   ``IMPUTE_WORLD`` (a beagle-annotated 30x chr20 callset of 104,000
   records, 1-3 alts, PL spans to 2,000, planted flips) through
   ``correct_genotypes_by_imputation`` on the card and the CPU (records
   differing only as ``tests/torch_genotype_compare`` admits, counted;
   ``changed_gt`` equal to the planted flips), a rerun on the card's output
   (no genotype changed), and the ``--input_vcf`` stage chain with a stub
   of beagle on a two-contig cut; ``HAPLOID_WORLD`` (155,000 chrX/chrY
   records) through ``convert_haploid_regions`` with ``hg38_non_par`` and a
   BED, card against CPU, every record outside the regions as the input has
   it; ``GVCF_WORLD`` cut to half of chr20 (:data:`GVCF_SMOKE_WORLD`, a 30x
   gVCF of about 0.9 M records) through
   ``compress_gvcf``, ``cleanup_gvcf_before_calling`` (the planted drops)
   and ``gvcf_hcr`` (both ``--below`` settings), each byte-equal to its
   ``VCTPU_NO_NATIVE=1`` twin on a 2 Mbp cut; ``TRIO_WORLD`` through
   ``denovo_recalibrated_qualities`` (every planted ``DENOVO_QUAL``);
   ``RUNS_WORLD`` (chr20's length and chrM) through ``find_runs_bed`` on the
   card and the CPU, equal to the planted runs and a numpy walk, and the
   scan alone (``GENOTYPE_DETAIL``, ``GVCF_DETAIL``, ``RUNS_DETAIL``,
   ``RUNS_KERNEL_DETAIL``, ``HOST_ENGINE`` lines);
14. the report tools and pileup fingerprinting (``phase_reports``), each
   run a process of its own, one after another, the counts set to 0 just
   before it and read just after (no kernel lies on these paths: none may
   launch), each card run against its CPU twin under
   ``tests/torch_report_compare``'s bars: ``REPORT_WORLD`` (a 30x chr20
   callset of 104,000 records, ``GT:GQ:DP:AD:VAF``, 1-3 alts, hmer and
   non-hmer indels, adjacent-SNV doublets and runs of three, a dbSNP of 40 %
   of its sites and 250,000 others, a callable BED, two control callsets
   of 20,000 records, seeded catalogs of COSMIC v3.3's shapes) through
   ``run_no_gt_report`` ``full_analysis``, ``variant_eval`` and
   ``somatic_analysis`` (the planted hmer tables, doublets, indel classes
   and motifs found, the planted mixture recovered); ``joint_calling_report``
   on phase 13's ``TRIO_WORLD`` joint VCF with its dbSNP;
   ``substitution_error_rate_report`` on a seeded motif h5;
   ``FINGERPRINT_WORLD`` (four samples over a 200 kbp region of chr20 at
   30x, as BAM and as CRAM: two match their truth, one matches none, one
   is a normal-in-tumor mix) through ``quick_fingerprinting`` and
   ``training_set_consistency_check`` (the expected error lists), and the
   pileup of every sample by the engine's BAM walk against its
   ``VCTPU_NO_NATIVE=1`` plain walk and the CRAM decoder (``REPORT_DETAIL``,
   ``FINGERPRINT_DETAIL``, ``PILEUP_DETAIL``, ``HOST_ENGINE`` lines; each
   detail line counts the figures its run skipped: the card's machine has
   no plotting library);
15. the single-read SNV and MRD chain, the LPR pair, bridging SNVs and
   methylation (``phase_featuremaps``), each run a process of its own, one
   after another, the counts set to 0 just before it and read just after:
   ``FEATUREMAP_WORLD`` (``synthetic_featuremap``: TP and FP featuremaps of
   500,000 reads, a cfDNA featuremap of 1,000,000 reads over 2,000 signature
   SNVs at a planted tumor fraction of 1e-3 and its control, an LPR
   featuremap of 300,000 reads on 12,000 loci and a calls VCF of 104,000
   records) through ``srsnv_training`` (the held-out AUC, ``gbt_hist`` and
   ``forest_wide`` launched; the card's fit against the CPU torch program on a
   cut), ``srsnv_inference`` (``forest_wide``; the CPU and ``gemm``,
   ``forest_tree_step``, byte-equal on a cut), ``mrd_analysis`` (card against
   CPU, the planted tumor fraction inside the interval and detected, not on
   the control) and the LPR pair (parquets and VCF byte-equal);
   ``BRIDGING_WORLD`` through ``calibrate_bridging_snvs`` (exactly the planted
   rescues); ``METHYL_WORLD`` through the five methylation tools (card files
   equal to the CPU's, the planted M-bias found) (``FEATUREMAP_DETAIL``,
   ``MRD_DETAIL``, ``LPR_DETAIL``, ``BRIDGING_DETAIL``, ``METHYL_DETAIL``,
   ``HOST_ENGINE`` lines).

16. the resident daemon (``phase_serve``) on phase 4's forest pickle world:
   an in-process ``Server`` on the card (2 requests in flight, 2 queued)
   warmed, a cold filter request, then 4 more 2 at a time, each equal
   outside ``##vctpu_*`` to phase 4's GPU output, ``forest_wide`` launched 4
   times the cold run's count, one launch a table that reached the card,
   the model loaded and the predictor built once; a request scoped to
   ``gemm`` (``forest_tree_step``), ``/v1/score`` against a CPU
   ``score_table``, ``/v1/coverage`` of 1,000,000 positions against the
   plain numpy twin; a poisoned request (500) beside a clean one, a request
   held past its deadline (504), 2 requests shed (503) with both slots held
   and 2 queued, no partial or journal left, ``/v1/status`` and
   ``/v1/metrics`` counting what was sent, the drain closing the obs stream;
   then ``python -m variantcalling_tpu_torch serve --backend gpu`` as a
   process of its own: one request, SIGTERM, exit 0, no leaked thread, no
   process left (``SERVE_DETAIL`` lines: the cold request's seconds and the
   warm ones' median among them).
17. the run telemetry and the somatic composites (``phase_telemetry``): phase
   8's 5 M-variant streaming run again with ``VCTPU_OBS=1`` and the CPU
   sampler, the same output hash, a schema-valid stream with one complete
   trace a chunk and the forest kernel's ``cost_analysis`` event, and every
   ``obs`` subcommand exiting 0 on it (``OBS_DETAIL``: both walls, the
   overhead, the dominant p95 edge, the limiting stage); the 104,000-variant
   world streamed with the device trace (``torch.profiler``), its
   ``forest_wide`` kernel events equal to the launch counter
   (``DEVICE_BUSY``: the card's busy share of the run's wall); ``train_dan``
   with obs on, a ``step`` event a step; ``run_somatic_comparison_and_graphs``
   and ``detailed_var_report`` on phase 12's world, card against CPU
   (``SOMATIC_DETAIL``, figures skipped counted); ``knobs --json``.
18. the report chain and the QC metrics tools (``phase_report_chain``), on
   the files phases 12, 14 and 15 wrote, each tool twice in two directories
   side by side (the two runs' files byte-equal): ``create_var_report`` at
   verbosity 2 on phase 12's card comparison h5 (its counts the
   comparison's own), ``create_somatic_gt_file`` on a tumor/normal pair
   planted on phase 12's truth (the planted records back exactly, no
   planted problematic position in the BED; its GT VCF and BED then through
   ``run_somatic_comparison_and_graphs --backend gpu``), ``report_wo_gt`` on
   phase 14's ``full_analysis`` h5, ``mrd_data_analysis`` on phase 15's
   summary, scored cfDNA map and signature with a read and a signature
   query (the filtered tables equal to a numpy selection), and the six QC
   tools chained on two seeded samples, ``convert_h5_to_json`` holding every
   key of ``create_qc_report``'s h5; figures skipped counted
   (``REPORT_CHAIN_DETAIL`` lines: wall, peak RSS, how many ran side by side).
   Independent runs of phases 13-15 (the CPU twins beside the card runs,
   the gVCF tools, the methylation tools) also run side by side since then.
19. the last twelve host-only tools (``phase_host_tools``), each twice in two
   directories side by side (the two runs' files byte-equal), on seeded
   worlds of ``synthetic_tools`` and phase 4's chr20 world:
   ``sv_stats_collect`` (25,000 SV records and a concordance h5: the
   histograms and counts as planted) and ``create_sv_report`` on its pickle
   and on the committed JAX-written pickle (equal to the port's own on that
   world: the pandas 3 reader on a machine without pandas), ``ppmseq_qc``,
   ``find_adapter_coords`` and ``add_ml_tags_bam`` on 500,000 and 20,000
   reads (the crosstab as drawn, samples as the plain per-read specs, the
   planted adapters found), ``collect_hpol_table``, ``annotate_contig``,
   ``intersect_bed_regions``, ``index_vcf_file``, ``remove_vcf_duplicates``,
   ``remove_empty_files`` and ``cloud_sync`` (a stub ``gsutil``, no network),
   each held to a numpy check (``HOST_TOOLS_DETAIL`` lines).
20. the rank-partitioned and elastic filter pods (``phase_scaleout``): three
   pods of the port's launcher side by side, their merged bytes the
   single-rank runs' (``SCALEOUT_DETAIL`` lines).
21. the serving fabric (``phase_fabric``): two fleets of two backends on the
   card and a router each (``parallel/podrun.start_fabric``); phase 4's and
   phase 8's worlds streamed through the routers at 1, 2 and 4 spans, cold,
   warm and scoped to ``gemm``, with the batch bytes outside ``##vctpu_*``;
   tokens and the quota on a second router; a backend SIGKILLed mid-request
   (a re-span, the same bytes), then ``backend_lost``; clean drains, nothing
   left, the router off the card, each backend's launches from its log
   (``FABRIC_DETAIL``).

A ``PHASE_SECONDS`` line follows every phase (wall seconds of the phase),
and one for the whole run before the result lines.

The script is a child subreaper, so a process that a child leaves behind
becomes its own. Before the result lines it stops ``multiprocessing``'s
forkserver and resource tracker, waits for them, and fails if any other
process it started still runs; on every exit it kills and reaps what is left
(:func:`stop_processes`).

The last two lines of standard output are a JSON object with the kernel
numbers and the device line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-kernel {wide,tree_step} CHECKOUT_ROOT

times only one kernel of the checkout at CHECKOUT_ROOT (``.`` for this one;
an older one unpacked under the ignored ``build/``), on the same forests and
rows as phase 3: run in turns for two checkouts in one call on one card, it
compares their kernels (:func:`time_kernel`).
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1.979e15  # dense, tensor cores
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores

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
    forest whose trees have the real-leaf path lengths ``plen`` (T, L): the
    port's one count, ``forest_cuda.scoring_work`` (each input byte read once,
    each margin written once; the threshold compares of complete trees and the
    adds of the tree sum, at the float32 rate outside the tensor cores). Both
    kernels compute this same function."""
    from variantcalling_tpu_torch.models.forest_cuda import scoring_work

    depths = [int(p[p >= 0].max()) for p in plen]
    check(all(int(p[p >= 0].min()) == d for p, d in zip(plen, depths)), "bound assumes complete trees")
    w = scoring_work(n, n_features, table_bytes, depths)
    detail = {"bytes": w["bytes"], "ops": w["ops"], "bytes_ms": w["bytes_ms"], "ops_ms": w["ops_ms"]}
    return w["bound_ms"], w["bound_by"], detail


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
    n_north = len(spans)
    spans += [(0, main_rows), (0, KERNEL_ROWS)]
    plain_north_ms = 0.0  # the plain version over the 5 M rows: its chunks' times in this parity pass
    if north_star:  # one call first, so that the timed pass is warm as the medians below are
        kernel.plain(x_all[:KERNEL_ROWS])
        torch.cuda.synchronize()
    for i, (lo, size) in enumerate(spans):
        xc = x_all[lo: lo + size]
        got = kernel.launch(xc)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = kernel.plain(xc)
        end.record()
        torch.cuda.synchronize()
        if i < n_north:
            plain_north_ms += start.elapsed_time(end)
        err = float((got - want).abs().nan_to_num(nan=math.inf).max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name}: kernel != plain at rows {lo}..{lo + size} (max abs err {err})")
    rows = {}
    for n in (main_rows, KERNEL_ROWS) + ((NORTH_STAR_ROWS,) if north_star else ()):
        bound_ms, bound_by, detail = bound(n)
        times = _launch_times(kernel.launch, x_all, n)
        if n <= KERNEL_ROWS:
            plain_ms = cuda_ms(lambda xn=x_all[:n]: kernel.plain(xn), reps=3, warmup=1)
        else:  # one warm pass in chunks, timed during the parity pass above (a second pass would add seconds)
            plain_ms = plain_north_ms
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
        self.notes: dict = {}

    def emit(self, record: logging.LogRecord) -> None:
        from variantcalling_tpu_torch import featurize
        from variantcalling_tpu_torch.pipelines import filter_variants as fv
        from variantcalling_tpu_torch.utils.stages import STAGE_LOG

        if record.msg == STAGE_LOG:
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
        elif record.msg == "held-out AUC = %.4f (%d reads)":  # srsnv_training.AUC_LOG
            self.notes["auc"], self.notes["heldout_reads"] = record.args
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


def _stripped_sha256(path: Path) -> str:
    """sha256 of ``path`` without its ``##vctpu_*`` lines (:func:`_strip`'s bytes)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for line in fh:
            if not line.startswith(b"##vctpu_"):
                h.update(line)
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


#: modules the forkserver imports once, before it forks any child: a child then starts in milliseconds,
#: where it took seconds to import torch and the port itself (none of them touches the card on import)
FORKSERVER_PRELOAD = ["__main__", "torch", "numpy", *(f"variantcalling_tpu_torch.{m}" for m in (
    "native", "featurize", "models.forest_cuda", "models.gbt_hist", "cnv.viterbi_cuda", "pipelines.filter_variants",
    "pipelines.train_models", "pipelines.training_prep", "pipelines.train_dan", "pipelines.evaluate_concordance",
    "pipelines.coverage_analysis", "pipelines.cnv_calling", "pipelines.sec.sec_training",
    "pipelines.sec.correct_systematic_errors", "pipelines.sec.sec_validation",
    "pipelines.sec.assess_sec_concordance", "pipelines.run_comparison", "pipelines.vcfeval_flavors",
    "pipelines.correct_genotypes_by_imputation", "pipelines.imputation_stages", "pipelines.convert_haploid_regions",
    "pipelines.compress_gvcf", "pipelines.cleanup_gvcf_before_calling", "pipelines.gvcf_hcr",
    "pipelines.denovo_recalibrated_qualities", "pipelines.misc.find_runs_bed", "pipelines.run_no_gt_report",
    "pipelines.joint_calling_report", "pipelines.substitution_error_rate_report", "pipelines.quick_fingerprinting",
    "pipelines.training_set_consistency_check", "pipelines.srsnv.srsnv_training", "pipelines.srsnv.srsnv_inference",
    "pipelines.mrd_analysis", "pipelines.lpr.train_lib_prep_recalibration_model",
    "pipelines.lpr.filter_vcf_with_lib_prep_recalibration_model", "pipelines.calibrate_bridging_snvs",
    "pipelines.methylation.concat_methyldackel_csvs", "pipelines.methylation.process_mbias",
    "pipelines.methylation.process_merge_context", "pipelines.methylation.process_merge_context_no_cp_g",
    "pipelines.methylation.process_per_read", "pipelines.run_somatic_comparison_and_graphs",
    "pipelines.detailed_var_report", "obs.cli", "pipelines.sv_stats_collect", "pipelines.create_sv_report",
    "pipelines.ppmseq_qc", "pipelines.find_adapter_coords", "pipelines.add_ml_tags_bam",
    "pipelines.collect_hpol_table", "pipelines.vcfbed.annotate_contig", "pipelines.vcfbed.intersect_bed_regions",
    "pipelines.misc.index_vcf_file", "pipelines.misc.remove_vcf_duplicates", "pipelines.misc.remove_empty_files",
    "pipelines.misc.cloud_sync"))]


def _forked(spec: dict, label: str, target=None) -> dict:
    """``target`` (default :func:`_stream_child`) in a process forked by a
    ``forkserver`` (:data:`FORKSERVER_PRELOAD` imported in it once): a child
    started otherwise keeps this process's peak in its ``ru_maxrss``."""
    return _forked_all({label: spec}, target or _stream_child)[label]


def _forked_all(specs: dict[str, dict], target) -> dict[str, dict]:
    """:func:`_forked` of every ``label: spec`` at once, each in its own
    process (the walls are then taken side by side, under each other's
    load); the runs by label."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
    started = {}
    for label, spec in specs.items():
        results = ctx.Queue()
        proc = ctx.Process(target=target, args=(spec, results), name=label)
        proc.start()
        started[label] = (proc, results)
    runs, deadline = {}, time.monotonic() + 900
    for label, (proc, results) in started.items():
        run = None
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
        runs[label] = run
    return runs


def _adopt_orphans() -> None:
    """Make this process a child subreaper (Linux ``prctl``): a process that
    a child leaves behind when it exits is then reparented to this one, where
    :func:`stop_processes` finds it, and not to init."""
    import ctypes

    PR_SET_CHILD_SUBREAPER = 36
    check(ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
          f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def _descendants() -> dict[int, str]:
    """Every process below this one that is still running (not a zombie):
    pid to command line, read from ``/proc``."""
    parent, command = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
            cmdline = Path(f"/proc/{entry}/cmdline").read_bytes()
        except OSError:  # ended while it was read
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state != "Z":
            parent[int(entry)] = int(ppid)
            command[int(entry)] = cmdline.replace(b"\0", b" ").decode(errors="replace").strip()[:200]
    below, me = {}, os.getpid()
    for pid in parent:
        up = parent[pid]
        while up not in (me, 0, 1) and up in parent:
            up = parent[up]
        if up == me:
            below[pid] = command[pid]
    return below


def stop_processes(kill: bool = False) -> dict[int, str]:
    """Stop every process this one started, and return those still running
    (killed, and reaped, when ``kill``). ``multiprocessing``'s forkserver and
    resource tracker end on the EOF of a pipe that closes only when this
    process exits, so they would outlive it by a moment: each is closed and
    waited for here, after any child left."""
    if "multiprocessing" in sys.modules:
        import multiprocessing

        for proc in multiprocessing.active_children():
            proc.kill()
            proc.join()
        for module, helper in (("multiprocessing.forkserver", "_forkserver"),
                               ("multiprocessing.resource_tracker", "_resource_tracker")):
            stop = getattr(getattr(sys.modules.get(module), helper, None), "_stop", None)
            if stop is not None:
                stop()
    left = pending = _descendants()
    deadline = time.monotonic() + 10
    while kill and pending and time.monotonic() < deadline:
        for pid in pending:
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
        time.sleep(0.05)
        _reap()
        pending = _descendants()  # a killed process's orphans are this one's now
    return left


def _reap() -> None:
    """Wait for every child of this process that has ended, the adopted orphans among them."""
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


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
    # phase 21's fabric answers are held to this outside ##vctpu_*
    runs["default"]["stripped_sha256"] = _stripped_sha256(tmp / "stream_5m_default.vcf")
    for f in tmp.glob("stream_5m_*.vcf"):
        f.unlink()
    out["stream_5m"] = runs
    out["world_5m"] = world  # phase 17's obs-on twin reads it again

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
    out["stream_104k"] = {"families": families, "clean_sha256": hashlib.sha256(clean["bytes"]).hexdigest()}
    return out


#: the training phase's world: a 30x WGS callset's tp+fp count (one GIAB sample of BASELINE.json's
#: config 3), on GRCh38's 22 autosomes, chr20 (the held-out contig) at 104,000 rows
TRAIN_WORLD = dict(seed=2029, n_rows=5_000_000, chr20_rows=104_000)
#: rows of the GPU-against-CPU comparison: chr1's first 96,000 and chr20's 104,000
TRAIN_CPU_ROWS = 200_000
#: boosting.fit on the card against the torch program on the CPU: every 8th row of TRAIN_CPU_ROWS (about 24,500)
TRAIN_FIT_STRIDE = 8
#: gbt_hist launches of the default grid: 100 trees x depth 6 x the four rf cells
TRAIN_GRID_LAUNCHES = 100 * 6 * 4


def _train_run(argv: list[str], env: dict[str, str] | None = None) -> dict:
    """One ``train_models_pipeline`` run through ``run(argv)`` in this process:
    the kernels' launch counts set to 0 just before it and read just after,
    its stages (``STAGE_LOG``, through :class:`_RunLog`), wall seconds and
    peak card memory."""
    from variantcalling_tpu_torch.models import forest_cuda, gbt_hist
    from variantcalling_tpu_torch.pipelines import train_models

    os.environ.update(env or {})
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    stages = _RunLog()
    plog.addHandler(stages)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gbt_hist.LAUNCHES = forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc = train_models.run(argv)
    finally:
        plog.removeHandler(stages)
    return {"rc": rc, "seconds": time.perf_counter() - t0, "stages": stages.stages,
            "launches": {"gbt_hist": gbt_hist.LAUNCHES, "forest_wide": forest_cuda.LAUNCHES,
                         "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES},
            "peak_device_bytes": torch.cuda.max_memory_allocated() if torch.cuda.is_available() else -1}


def _train_child(spec: dict, results) -> None:
    """:func:`_train_run` in a process of its own, for its peak RSS."""
    import resource

    torch.cuda.init()
    run = _train_run(spec["argv"], spec["env"])
    results.put({**run, "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})


def _pickle_globals(data: bytes) -> set[tuple[str, str]]:
    """The (module, name) of every global a pickle names, read by an
    unpickler that resolves only numpy's and builtins' and stands in for the
    rest (this machine has no JAX package to resolve the model classes)."""
    import io
    import pickle

    seen = set()

    class StandIn:
        pass

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            if module.split(".")[0] in ("numpy", "builtins", "copyreg"):
                return super().find_class(module, name)
            return StandIn

    Recorder(io.BytesIO(data)).load()
    return seen


def _check_fit_bar(got, want, label: str, x: np.ndarray) -> dict:
    """``got`` against ``want`` (two FlatForests of the same torch program,
    on the card and on the CPU): split features and thresholds equal, leaf
    values to 1e-5, scores on ``x`` to 1e-6; the largest gaps."""
    from variantcalling_tpu_torch.models import forest as fmod

    check(np.array_equal(got.feature, want.feature), f"{label}: split features differ "
          f"({int((got.feature != want.feature).sum())} nodes)")
    check(np.array_equal(got.threshold, want.threshold), f"{label}: thresholds differ")
    check(np.allclose(got.value, want.value, rtol=1e-5, atol=0.0), f"{label}: leaf values differ "
          f"(max {float(np.abs(got.value - want.value).max())})")
    xt = torch.from_numpy(x)
    sg = fmod.finalize_margin(fmod.predict_margin(got, xt).numpy(), got)
    sw = fmod.finalize_margin(fmod.predict_margin(want, xt).numpy(), want)
    score_gap = float(np.abs(sg - sw).max())
    check(score_gap <= 1e-6, f"{label}: scores differ by {score_gap}")
    return {"max_value_gap": float(np.abs(got.value - want.value).max()), "max_score_gap": score_gap,
            "values_equal": bool(np.array_equal(got.value, want.value))}


def _native_agreement(got, want, x: np.ndarray) -> dict:
    """How a forest fitted on the card (exact sums) agrees with the native
    CPU trainer's (float32 sums, sibling subtraction): whether every split
    feature is equal (the JAX package's native-vs-jit bar, which float32
    sums can miss at a near-tie of two splits' gains), the first tree that
    differs, the share of split nodes equal, and the largest score gap on
    ``x``. Reported, not held: the card is held to the CPU torch program."""
    from variantcalling_tpu_torch.models import forest as fmod

    split = got.feature != fmod.LEAF
    differ = np.flatnonzero((got.feature != want.feature).any(axis=1))
    xt = torch.from_numpy(x).cuda()  # the gather walk: the same bits on the card and the CPU
    sg = fmod.finalize_margin(fmod.predict_margin(got, xt).cpu().numpy(), got)
    sw = fmod.finalize_margin(fmod.predict_margin(want, xt).cpu().numpy(), want)
    first = int(differ[0]) if len(differ) else None
    before = slice(0, first)  # the trees before the first that differs
    return {"features_equal": not len(differ), "first_differing_tree": first, "differing_trees": len(differ),
            "split_nodes_equal_share": float((got.feature == want.feature)[split].mean()),
            "thresholds_equal_before_it": bool(np.allclose(got.threshold[before], want.threshold[before],
                                                           rtol=1e-6)),
            "max_value_gap_before_it": float(np.abs(got.value[before] - want.value[before]).max())
            if first != 0 else None,
            "max_score_gap": float(np.abs(sg - sw).max()), "mean_score_gap": float(np.abs(sg - sw).mean())}


def _hist_levels(x: np.ndarray, card: str) -> dict:
    """The histogram of one full-width tree on ``x``, level by level on the
    card: the kernel ``torch.equal`` to its plain version at every level, and
    per level its single-launch ``ms``, ``device_ms`` and ``host_ms``, the
    plain version's ms, the bytes bound, and at levels 0 and 5 the bf16
    one-hot product of the reference's accelerator formulation
    (``torch.matmul``, not bit-equal: the ``library_ms`` yardstick)."""
    from variantcalling_tpu_torch.models import boosting, gbt_hist

    n, f = x.shape
    cfg = boosting.BoostConfig(n_trees=1)
    b = cfg.n_bins
    binned = torch.from_numpy(boosting.bin_features(x, boosting.quantile_bin_edges(x, b))).cuda()
    rng = np.random.default_rng(31)
    y = torch.from_numpy((rng.random(n) < 0.6).astype(np.float32)).cuda()
    p = torch.full((n,), 0.5, device="cuda")
    g, h = p - y, p * (1 - p)
    levels = {}

    def both(binned_, node_id, ghq, n_nodes, n_bins):
        got = gbt_hist.hist_launch(binned_, node_id, ghq, n_nodes, n_bins)
        want = gbt_hist.hist_plain(binned_, node_id, ghq, n_nodes, n_bins)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gbt_hist != plain at level {len(levels)} ({n} rows)")
        nbytes = n * f + 4 * n + 16 * n + n_nodes * f * n_bins * 16
        ops = 2 * n * f  # int64 adds
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        launch = lambda: gbt_hist.hist_launch(binned_, node_id, ghq, n_nodes, n_bins)  # noqa: E731
        row = {"level": len(levels), "nodes": n_nodes, "rows": n, "features": f, "bins": n_bins, "card": card,
               "ms": cuda_ms(launch, reps=10), "device_ms": device_ms(launch, reps=10),
               "host_ms": host_ms(launch, reps=10),
               "plain_ms": cuda_ms(lambda: gbt_hist.hist_plain(binned_, node_id, ghq, n_nodes, n_bins), reps=3,
                                   warmup=1),
               "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": 0.0,
               "library_ms": None}
        if len(levels) in (0, 5):
            col = torch.arange(f, device="cuda", dtype=torch.int64) * n_bins
            rhs = torch.zeros(n, f * n_bins, dtype=torch.bfloat16, device="cuda")
            rhs.scatter_(1, binned_.long() + col, 1.0)
            lhs = torch.zeros(2 * n_nodes, n, dtype=torch.bfloat16, device="cuda")
            rows = torch.arange(n, device="cuda")
            lhs[node_id.long(), rows] = g.bfloat16()
            lhs[n_nodes + node_id.long(), rows] = h.bfloat16()
            row["library_ms"] = cuda_ms(lambda: torch.matmul(lhs, rhs), reps=5, warmup=1)
            del lhs, rhs
            torch.cuda.empty_cache()
        print("GBT_HIST_DETAIL " + json.dumps(row), flush=True)
        levels[len(levels)] = row
        return got

    boosting._grow_tree(binned, g, h, cfg, hist=both)
    check(len(levels) == cfg.depth, f"{len(levels)} levels timed")
    return levels


def phase_training(tmp: Path, card: str) -> dict:
    """``train_models_pipeline`` and ``training_prep_pipeline`` on the card.

    1. ``TRAIN_WORLD`` (5 M labeled rows, 22 autosomes, written by the port's
       own ``write_frames``) through ``train_models_pipeline
       --evaluate_concordance --evaluate_concordance_contig chr20`` at the
       default 100 trees, depth 6, 64 bins, in a process of its own:
       ``gbt_hist`` launched 2,400 times and ``forest_wide`` once a forest
       scored.
    2. ``TRAIN_CPU_ROWS`` of the same world: the CLI on the card twice (the
       same launches; the pair's pickles and ``.h5`` frames equal) and
       against ``--backend cpu`` (the native float32 trainer): the threshold models
       equal, the forests' agreement reported (:func:`_native_agreement`);
       ``boosting.fit`` of one
       model on every 8th of those rows (:data:`TRAIN_FIT_STRIDE`) on the card
       against the torch program on the CPU (``VCTPU_NATIVE_GBT=0``):
       features and thresholds equal, values to 1e-5, scores to 1e-6, and
       whether the pickles came out byte-equal.
    3. The histogram of one full-width tree at 5 M rows, level by level,
       ``torch.equal`` to its plain version, timed (:func:`_hist_levels`).
    4. Train -> filter: the 104,000-variant chr20 world with dbSNP IDs, a
       blacklist, hpol runs and an annotation: ``training_prep_pipeline``,
       ``train_models_pipeline`` in VCF mode on the card, and the trained
       forest through ``filter_variants_pipeline`` on ``cuda-wide`` and on
       the CPU: equal bytes; the pickle names only the reference's model
       classes, numpy and builtins.
    """
    from tests import torch_worlds
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.models import boosting, registry
    from variantcalling_tpu_torch.pipelines import train_models, training_prep
    from variantcalling_tpu_torch.utils import h5_utils

    out: dict = {}
    # -- 1. the 5 M world on the card; 200,000 of its rows twice on the card and once on the CPU
    t0 = time.perf_counter()
    frames = synthetic.train_world(TRAIN_WORLD["seed"], TRAIN_WORLD["n_rows"], chr20_rows=TRAIN_WORLD["chr20_rows"])
    world = tmp / "train_5m.h5"
    h5_utils.write_frames(str(world), frames)
    print(f"world train_5m: {TRAIN_WORLD['n_rows']} rows on {len(frames)} contigs ({TRAIN_WORLD['chr20_rows']} on "
          f"chr20), {os.path.getsize(world)} bytes of h5 written by the port in {time.perf_counter() - t0:.1f} s",
          flush=True)
    grid = ["--evaluate_concordance", "--evaluate_concordance_contig", "chr20"]
    small = {"chr1": frames["chr1"].take(np.arange(len(frames["chr1"])) < TRAIN_CPU_ROWS - TRAIN_WORLD["chr20_rows"]),
             "chr20": frames["chr20"]}
    del frames
    small_path = tmp / "train_200k.h5"
    h5_utils.write_frames(str(small_path), small)
    # the 5 M run; then on 200,000 rows a pair on the card that proves two runs write the same files, and the
    # CPU; the pair's second run and the CPU's side by side (their walls taken under each other's load)
    runs = {}
    jobs = {label: (path, backend) for label, path, backend in (
        ("train_5m_gpu", world, "gpu"), ("train_200k_gpu", small_path, "gpu"),
        ("train_200k_gpu_again", small_path, "gpu"), ("train_200k_cpu", small_path, "cpu"))}
    specs = {label: {"argv": ["--input_file", str(path), "--output_file_prefix", str(tmp / label), *grid,
                              "--backend", backend], "env": {}} for label, (path, backend) in jobs.items()}
    done = {label: _forked(specs[label], label, _train_child) for label in ("train_5m_gpu", "train_200k_gpu")}
    done.update(_forked_all({label: specs[label] for label in ("train_200k_gpu_again", "train_200k_cpu")},
                            _train_child))
    for label, (path, backend) in jobs.items():
        run = done[label]
        check(run["rc"] == 0, f"{label}: exit {run['rc']}")
        if backend == "gpu":
            check(run["launches"]["gbt_hist"] == TRAIN_GRID_LAUNCHES and run["launches"]["forest_wide"] == 5
                  and run["launches"]["forest_tree_step"] == 0, f"{label}: launches {run['launches']}")
        detail = {"world": path.stem, "run": label, "card": card, "wall_s": run["seconds"],
                  "stages": run["stages"], "launches": run["launches"], "peak_rss_bytes": run["peak_rss_bytes"],
                  "peak_device_bytes": run["peak_device_bytes"]}
        print("TRAIN_DETAIL " + json.dumps(detail), flush=True)
        runs[label] = detail
    pair = ("train_200k_gpu", "train_200k_gpu_again")
    pkl = [(tmp / f"{label}.pkl").read_bytes() for label in pair]
    h5 = [(tmp / f"{label}.h5").read_bytes() for label in pair]
    check(pkl[0] == pkl[1], "two GPU training runs wrote different pickles")
    keys = h5_utils.list_keys(str(tmp / "train_5m_gpu.h5"))
    check(keys == ["optimal_recall_precision", "training_results"], f"h5 keys {keys}")
    for key in keys:
        a, b = (h5_utils.read_hdf(str(tmp / f"{label}.h5"), key) for label in pair)
        check(a.columns == b.columns and all(np.array_equal(a[c], b[c]) for c in a.columns),
              f"two GPU training runs wrote different {key} frames")
    models = registry.load_models(str(tmp / "train_5m_gpu.pkl"))
    check(sorted(models) == sorted(registry.standard_model_names()), f"models {sorted(models)}")
    results = h5_utils.read_hdf(str(tmp / "train_5m_gpu.h5"), "training_results")
    acc = h5_utils.read_hdf(str(tmp / "train_5m_gpu.h5"), "optimal_recall_precision")
    check(all(0.5 < v <= 1 for v in results["f1"][::2]), f"rf F1 {list(results['f1'])}")
    print(f"training 5M on the card; two GPU runs on {TRAIN_CPU_ROWS} of its rows wrote equal pickles "
          f"({len(pkl[0])} bytes) and .h5 files (bytes equal: {h5[0] == h5[1]}); rf F1 "
          f"{[float(v) for v in results['f1'][::2]]}, held-out chr20 SNP precision/recall "
          f"{float(acc['precision'][0])}/{float(acc['recall'][0])} ({card})", flush=True)
    out["train_5m"] = {k: v for k, v in runs.items() if k == "train_5m_gpu"}

    # -- 2. GPU against CPU on 200,000 rows of the same world ------------------------
    pair = {backend: registry.load_models(str(tmp / f"train_200k_{backend}.pkl")) for backend in ("gpu", "cpu")}
    args = train_models.parse_args(["--input_file", str(small_path), "--output_file_prefix", "unused"])
    x, names, label_, _, weight, _, contig = train_models._ingest(args, torch.device("cpu"))
    native = {}
    for name, want in pair["cpu"].items():
        got = pair["gpu"][name]
        if name.startswith("rf"):
            # the bar held: the held-out chr20 rows' TREE_SCORE and FILTER (tests/torch_worlds.forest_bar)
            bar = torch_worlds.forest_bar(got, want, x[contig == "chr20"], device="cuda")
            native[name] = {**_native_agreement(got, want, x), "heldout_bar": bar}
            print("TRAIN_NATIVE_DETAIL " + json.dumps({"model": name, "card": card, **native[name]}), flush=True)
            check(bar["held"], f"{name}: the card's forest misses the forest bar against the native trainer: {bar}")
        else:
            check(all(np.array_equal(getattr(got, k), getattr(want, k)) for k in ("thresholds", "signs", "scales"))
                  and got.feature_names == want.feature_names, f"{name}: GPU and CPU threshold fits differ")
    print(f"training 200k: the CLI on the card against --backend cpu (native float32 trainer): split features "
          f"equal in {sum(v['features_equal'] for v in native.values())} of {len(native)} forests, the held-out "
          f"forest bar held by all; threshold models equal ({card})", flush=True)
    cfg = boosting.BoostConfig()
    # the torch program on the CPU takes seconds a 10,000 rows: every TRAIN_FIT_STRIDE-th row of both contigs
    xf, yf, wf = (np.ascontiguousarray(a[::TRAIN_FIT_STRIDE]) for a in (x, label_, weight))
    t0 = time.perf_counter()
    gpu_fit = boosting.fit(xf, yf, sample_weight=wf, cfg=cfg, feature_names=names, device="cuda")
    gpu_s = time.perf_counter() - t0
    os.environ["VCTPU_NATIVE_GBT"] = "0"
    try:
        t0 = time.perf_counter()
        cpu_fit = boosting.fit(xf, yf, sample_weight=wf, cfg=cfg, feature_names=names, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        del os.environ["VCTPU_NATIVE_GBT"]
    one = _check_fit_bar(gpu_fit, cpu_fit, "boosting.fit GPU vs CPU torch program", xf)
    same_bytes = registry.dumps_models({"m": gpu_fit}) == registry.dumps_models({"m": cpu_fit})
    print("TRAIN_FIT_DETAIL " + json.dumps({"rows": len(xf), "features": len(names), "card": card, "gpu_s": gpu_s,
                                            "cpu_torch_s": cpu_s, "pickles_byte_equal": same_bytes, **one}),
          flush=True)
    out["train_200k"] = {"native": native, "fit": {**one, "pickles_byte_equal": same_bytes}}

    # -- 3. the histogram kernel level by level at 5 M rows --------------------------
    args = train_models.parse_args(["--input_file", str(world), "--output_file_prefix", "unused"])
    x5 = train_models._ingest(args, torch.device("cpu"))[0]
    out["gbt_hist"] = _hist_levels(x5, card)
    del x5
    torch.cuda.empty_cache()

    # -- 4. train -> filter on the 104,000-variant chr20 world -----------------------
    d = tmp / "train_vcf"
    d.mkdir()
    w = torch_worlds.write_training_vcf_world(d, seed=2026, n_variants=WORLD["n_variants"],
                                              contigs=((WORLD["contig"], WORLD["length"]),))
    check(training_prep.run(["--input_file", w["vcf"], "--blacklist", w["blacklist"],
                             "--output_prefix", str(d / "prep")]) == 0, "training_prep_pipeline failed")
    labels = h5_utils.read_hdf(str(d / "prep.labels.h5"), "chr20")
    n_neg = int((labels["label"] == 0).sum())
    check(0 < n_neg < len(labels), f"labels: {n_neg} of {len(labels)} negative")
    run = _train_run(["--input_file", w["vcf"], "--reference", w["fasta"], "--runs_intervals", w["runs"],
                      "--annotate_intervals", w["annotate"], "--blacklist", w["blacklist"],
                      "--output_file_prefix", str(d / "trained"), "--backend", "gpu"])
    check(run["rc"] == 0 and run["launches"]["gbt_hist"] == TRAIN_GRID_LAUNCHES,
          f"VCF-mode training: exit {run['rc']}, launches {run['launches']}")
    print("TRAIN_DETAIL " + json.dumps({"world": "train_vcf_104k", "run": "train_vcf_gpu", "card": card,
                                        "wall_s": run["seconds"], "stages": run["stages"],
                                        "launches": run["launches"], "labels": len(labels),
                                        "negative": n_neg}), flush=True)
    data = (d / "trained.pkl").read_bytes()
    globs = _pickle_globals(data)
    modules = {m for m, _ in globs}
    check(modules <= {"variantcalling_tpu.models.forest", "variantcalling_tpu.models.threshold", "numpy",
                      "numpy._core.multiarray", "numpy.core.multiarray", "builtins"}
          and ("variantcalling_tpu.models.forest", "FlatForest") in globs, f"pickle globals {sorted(globs)}")
    trained = {"vcf": w["vcf"], "fasta": w["fasta"], "model": str(d / "trained.pkl"),
               "model_name": "rf_model_ignore_gt_incl_hpol_runs"}
    extra = ["--annotate_intervals", w["annotate"], "--runs_file", w["runs"]]
    gpu = _drive(trained, d / "filtered_gpu.vcf", "gpu", card, "trained_forest", extra=extra)
    cpu = _drive(trained, d / "filtered_cpu.vcf", "cpu", card, "trained_forest", extra=extra)
    _check_same(gpu, cpu, "cuda-wide", "forest_wide", "trained_forest")
    print(f"train -> filter: {len(labels)} labeled variants ({n_neg} blacklisted), trained on the card in "
          f"{run['seconds']:.1f} s, filtered on cuda-wide to the CPU run's bytes; pickle globals "
          f"{sorted(modules)}", flush=True)
    out["train_vcf"] = {"seconds": run["seconds"], "launches": run["launches"]}
    # the inputs phase 10 trains and evaluates on
    out["files"] = {"world": str(world), "small": str(small_path), "vcf_world": w, "labels": str(d / "prep.labels.h5")}
    return out


#: train_dan's defaults, at which phase 10 trains on TRAIN_WORLD: 2,000 steps of 16,384 rows
DAN_STEPS, DAN_BATCH = 2000, 1 << 14
#: each run of a resumed pair: this many steps, then as many again from its checkpoint
DAN_RESUME_STEPS = 200
#: train -> filter on the 104,000-variant world: a quarter of the default steps, still about 125 passes
#: over its 66,651 labeled rows
DAN_VCF_STEPS = 500
#: GPU against CPU: steps on TRAIN_CPU_ROWS, a loss logged every DAN_CPU_LOG of them
DAN_CPU_STEPS, DAN_CPU_LOG = 50, 10
#: the CPU tests' bf16 bar (tests/test_torch_dan_train.py): each logged loss within 1 %, scores within 5e-3
DAN_LOSS_RTOL, DAN_SCORE_ATOL = 1e-2, 5e-3


class _DanLog(_RunLog):
    """:class:`_RunLog` plus a ``train_dan`` run's logged losses (``STEP_LOG``),
    its ingest resume (``RESUMED_LOG``: chunks read back, chunks) and its
    checkpoint resume (``RESUME_STEP_LOG``)."""

    def __init__(self):
        super().__init__()
        self.losses: list[list] = []
        self.resumed_chunks = None
        self.resume_step = None

    def emit(self, record: logging.LogRecord) -> None:
        from variantcalling_tpu_torch.pipelines import train_dan

        if record.msg == train_dan.STEP_LOG:
            self.losses.append([record.args[0], record.args[1]])
        elif record.msg == train_dan.RESUMED_LOG:
            self.resumed_chunks = list(record.args)
        elif record.msg == train_dan.RESUME_STEP_LOG:
            self.resume_step = record.args[0]
        else:
            super().emit(record)


def _tool_run(tool: str, argv: list[str], env: dict[str, str] | None = None) -> dict:
    """One ``train_dan`` or ``evaluate_concordance`` run through ``run(argv)``
    in this process: every kernel's launch count set to 0 just before it and
    read just after (no kernel lies on these paths), its stages and logged
    losses (:class:`_DanLog`), wall seconds and peak card memory."""
    from variantcalling_tpu_torch.models import forest_cuda, gbt_hist
    from variantcalling_tpu_torch.pipelines import evaluate_concordance, train_dan

    module = {"train_dan": train_dan, "evaluate_concordance": evaluate_concordance}[tool]
    os.environ.update(env or {})
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    log = _DanLog()
    plog.addHandler(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gbt_hist.LAUNCHES = forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc = module.run(argv)
    finally:
        plog.removeHandler(log)
    return {"rc": rc, "seconds": time.perf_counter() - t0, "stages": log.stages, "losses": log.losses,
            "resumed_chunks": log.resumed_chunks, "resume_step": log.resume_step,
            "launches": {"gbt_hist": gbt_hist.LAUNCHES, "forest_wide": forest_cuda.LAUNCHES,
                         "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES},
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def _dan_child(spec: dict, results) -> None:
    """:func:`_tool_run` of ``train_dan`` in a process of its own, for its peak RSS."""
    import resource

    torch.cuda.init()
    run = _tool_run("train_dan", spec["argv"], spec["env"])
    results.put({**run, "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})


def _dan_train(tmp: Path, label: str, card: str, argv: list[str], steps: int, rows: int) -> dict:
    """``train_dan`` with ``argv`` in a forked process: exit 0, no kernel
    launched; a ``DAN_TRAIN_DETAIL`` line (wall, stages, steps and rows a
    second through the train stage, peaks, the logged losses)."""
    return _dan_trains(tmp, {label: argv}, card, steps, rows)[label]


def _dan_trains(tmp: Path, argvs: dict[str, list[str]], card: str, steps: int, rows: int) -> dict[str, dict]:
    """:func:`_dan_train` of each ``label: argv`` at once, side by side."""
    runs = _forked_all({label: {"argv": [*argv, "--output_file_prefix", str(tmp / label)], "env": {}}
                        for label, argv in argvs.items()}, _dan_child)
    return {label: _dan_detail(label, card, run, steps, rows) for label, run in runs.items()}


def _dan_detail(label: str, card: str, run: dict, steps: int, rows: int) -> dict:
    check(run["rc"] == 0, f"{label}: exit {run['rc']}")
    check(not any(run["launches"].values()), f"{label}: a kernel was launched ({run['launches']})")
    train_s = run["stages"].get("train", float("nan"))
    detail = {"run": label, "card": card, "wall_s": run["seconds"], "stages": run["stages"], "steps": steps,
              "rows_per_step": rows, "steps_per_s": steps / train_s, "rows_per_s": steps * rows / train_s,
              "peak_device_bytes": run["peak_device_bytes"], "peak_rss_bytes": run["peak_rss_bytes"],
              "resumed_chunks": run["resumed_chunks"], "resume_step": run["resume_step"], "losses": run["losses"]}
    print("DAN_TRAIN_DETAIL " + json.dumps(detail), flush=True)
    return detail


def _dan_step_profile(card: str, n_numeric: int, steps: int = 50) -> dict:
    """``train_step`` at ``train_dan``'s defaults (16,384 rows, hidden 256, 2
    layers, embed 16, bf16) on random inputs on the card: the host clock a
    step (synchronized), and under ``torch.profiler`` the CUDA kernels a step
    and their summed time, whose share of the step is the card's busy share;
    beside them the step's bf16 FLOP count and its time at the dense bf16
    peak (the profile is ``None`` where the profiler records no kernel)."""
    from torch.autograd import DeviceType

    from variantcalling_tpu_torch.models import dan

    cfg = dan.DanConfig(n_numeric=n_numeric)
    g = torch.Generator(device="cuda").manual_seed(5)
    n = 1 << 20
    data = {"numeric": torch.randn(n, n_numeric, device="cuda", generator=g),
            "motif_left": torch.randint(0, dan.MOTIF_VOCAB, (n,), device="cuda", generator=g),
            "motif_right": torch.randint(0, dan.MOTIF_VOCAB, (n,), device="cuda", generator=g),
            "label": (torch.rand(n, device="cuda", generator=g) < 0.6).float(), "weight": torch.ones(n, device="cuda")}
    idx = torch.randint(0, n, (steps, DAN_BATCH), device="cuda", generator=g)
    params = dan.init_params(cfg, seed=0, device="cuda")
    state = dan.adamw_init(params)

    def run(k: int):
        nonlocal params, state
        for j in range(k):
            batch = {key: v.index_select(0, idx[j % steps]) for key, v in data.items()}
            params, state, _ = dan.train_step(cfg, params, state, batch)

    run(20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    in_dim = n_numeric + 2 * cfg.embed_dim
    flops = 3 * 2 * DAN_BATCH * (in_dim * cfg.hidden + cfg.hidden * cfg.hidden + cfg.hidden)
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps if kernels else None
    detail = {"card": card, "rows": DAN_BATCH, "step_ms": step_ms, "flops": flops,
              "bf16_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
              "device_events_per_step": len(kernels) / steps if kernels else None, "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / step_ms if device_ms is not None else None}
    print("DAN_STEP_DETAIL " + json.dumps(detail), flush=True)
    return detail


def _scored_eval_world(world: str, model, out: Path) -> int:
    """``world``'s frames with the DAN's TREE_SCORE (scored on the card in f32,
    the filter's scorer), ``indel`` (from ``is_indel``) and FILTER at the
    model's pass threshold, one key a contig as there; the row count."""
    from variantcalling_tpu_torch.models import dan
    from variantcalling_tpu_torch.utils import h5_utils

    scorer = dan.make_score_predictor(model, model.feature_names, "cuda")
    frames = {}
    for key in h5_utils.list_keys(world):
        f = h5_utils.read_hdf(world, key)
        x = np.stack([np.nan_to_num(np.asarray(f[c], dtype=np.float32)) for c in model.feature_names], axis=1)
        score = scorer(torch.from_numpy(x).cuda()).cpu().numpy()
        f["tree_score"] = score
        f["indel"] = np.asarray(f["is_indel"], dtype=bool)
        f["filter"] = np.where(score >= model.pass_threshold, "PASS", "LOW_SCORE").astype(object)
        frames[key] = f
    h5_utils.write_frames(str(out), frames)
    return sum(len(f) for f in frames.values())


def _vcf_concordance(w: dict, labels_path: str, out: Path) -> int:
    """A concordance h5 of the 104,000-variant world's labeled records: the
    filter's own features of each (``featurize.featurize`` on the card, the
    world's annotation), ``classify`` tp where ``training_prep_pipeline``
    labeled 1, else fp; the row count."""
    from variantcalling_tpu_torch.featurize import featurize
    from variantcalling_tpu_torch.io import bed as bedio
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.pipelines.filter_variants import _interval_name
    from variantcalling_tpu_torch.utils import h5_utils

    table = read_vcf(w["vcf"])
    annotate = {_interval_name(w["annotate"]): bedio.read_intervals(w["annotate"])}
    with FastaReader(w["fasta"]) as fasta:
        fs = featurize(table, fasta, annotate_intervals=annotate, device=torch.device("cuda"))
    labels = h5_utils.read_hdf(labels_path, WORLD["contig"])
    keep = np.isin(table.pos, labels["pos"])
    check(np.array_equal(table.pos[keep], labels["pos"]), "labels and records do not line up")
    x = fs.matrix()[keep]
    chrom = np.empty(int(keep.sum()), dtype=object)
    chrom[:] = WORLD["contig"]
    cols = {"chrom": chrom, "pos": table.pos[keep], **{n: x[:, i] for i, n in enumerate(fs.feature_names)},
            "classify": np.where(np.asarray(labels["label"]) == 1, "tp", "fp").astype(object)}
    h5_utils.write_frames(str(out), {WORLD["contig"]: h5_utils.Frame(cols)})
    return len(chrom)


def phase_dan_eval(tmp: Path, card: str, files: dict) -> dict:
    """``train_dan`` and ``evaluate_concordance`` on the card.

    1. ``TRAIN_WORLD`` (5 M rows, 22 keys: the ingest's ``keys`` mode, 22
       journaled chunks) through ``train_dan`` at its defaults (hidden 256,
       2 layers, embed 16, 2,000 steps of 16,384 rows, learning rate 1e-3)
       with ``--checkpoint_every 200``, in a process of its own: the newest
       two checkpoints kept. Then, on ``TRAIN_CPU_ROWS`` of it (two keys),
       ``--n_steps 200`` and ``--n_steps 400`` (:data:`DAN_RESUME_STEPS`) on
       one checkpoint directory, twice, each run a process of its own: the
       second run of a pair resumes 2 of 2 chunks from the ingest cache and
       from step 199, and the two pairs' pickles are byte-equal (two runs of
       the card write the same model). One step at those widths timed and
       profiled (:func:`_dan_step_profile`).
    2. ``TRAIN_CPU_ROWS`` of the world, 50 steps on the card and with
       ``--backend cpu``: each logged loss within 1 %, the two models' scores
       of those rows within 5e-3 (the CPU tests' bf16 bar); the largest gaps.
    3. Train -> filter: a DAN trained (``DAN_VCF_STEPS`` steps) on the
       104,000-variant chr20 world's ``training_prep_pipeline`` labels (the
       filter's own features), then
       that world's VCF filtered with ``VCTPU_MODEL_FAMILY=dan`` on the card
       and on the CPU, held to the DAN rule (``tests/torch_vcf_compare.py``,
       1e-5); the pickle names only ``variantcalling_tpu.models.dan``'s
       classes, numpy and builtins.
    4. ``evaluate_concordance --output_bed`` on ``TRAIN_WORLD`` scored by the
       5 M-row DAN on the card, and on ``TRAIN_CPU_ROWS`` of it on the card
       and on the CPU: every output file byte-equal (``EVAL_DETAIL``).
    """
    from tests.torch_vcf_compare import differing_records
    from variantcalling_tpu_torch.io import checkpoint
    from variantcalling_tpu_torch.models import dan, registry
    from variantcalling_tpu_torch.pipelines import train_dan
    from variantcalling_tpu_torch.utils import h5_utils

    out: dict = {}
    world = files["world"]
    # -- 1. the 5 M world at train_dan's defaults; two resumed pairs on 200,000 of its rows ------------
    base = ["--input_file", world, "--checkpoint_every", "200", "--backend", "gpu"]
    runs = {}
    label = "dan_5m_gpu"
    ck = tmp / f"{label}_ck"
    runs[label] = _dan_train(tmp, label, card, [*base, "--checkpoint_dir", str(ck)], DAN_STEPS, DAN_BATCH)
    check(checkpoint.steps(str(ck)) == [DAN_STEPS - 201, DAN_STEPS - 1], f"{label}: checkpoints "
          f"{checkpoint.steps(str(ck))}")
    check(runs[label]["resumed_chunks"] is None, f"{label}: a fresh run read a cache")
    pairs = []
    half = DAN_RESUME_STEPS
    n_keys = len(h5_utils.list_keys(files["small"]))
    small = ["--input_file", files["small"], "--checkpoint_every", "200", "--backend", "gpu"]
    # the two pairs side by side: both first runs at once, then both second runs
    ck = {pair: ["--checkpoint_dir", str(tmp / f"dan_resume_{pair}_ck")] for pair in ("a", "b")}
    first = _dan_trains(tmp, {f"dan_resume_{pair}_{half}": [*small, *ck[pair], "--n_steps", str(half)]
                              for pair in ck}, card, half, DAN_BATCH)
    second = _dan_trains(tmp, {f"dan_resume_{pair}_{2 * half}": [*small, *ck[pair], "--n_steps", str(2 * half)]
                               for pair in ck}, card, half, DAN_BATCH)
    for pair in ck:
        a, b = first[f"dan_resume_{pair}_{half}"], second[f"dan_resume_{pair}_{2 * half}"]
        check(a["resume_step"] is None and b["resume_step"] == half - 1 and b["resumed_chunks"] == [n_keys, n_keys],
              f"pair {pair}: resumed from step {b['resume_step']}, chunks {b['resumed_chunks']}")
        pairs.append((tmp / f"dan_resume_{pair}_{2 * half}.pkl").read_bytes())
    check(pairs[0] == pairs[1], "two resumed train_dan pairs wrote different pickles")
    model = registry.load_model(str(tmp / "dan_5m_gpu.pkl"), train_dan.MODEL_NAME)
    losses = runs["dan_5m_gpu"]["losses"]
    check(losses[-1][1] < losses[0][1], f"the loss did not fall: {losses}")
    print(f"train_dan 5M: {DAN_STEPS} steps; two resumed pairs on {TRAIN_CPU_ROWS} rows ({half} + {half} steps, "
          f"{n_keys} of {n_keys} chunks from the cache) wrote equal pickles ({len(pairs[0])} bytes); loss "
          f"{losses[0][1]:.4f} -> {losses[-1][1]:.4f}; {runs['dan_5m_gpu']['steps_per_s']:.1f} steps/s ({card})",
          flush=True)
    out["dan_5m"] = {**runs, "resumed": pairs[0] == pairs[1]}
    out["dan_step"] = _dan_step_profile(card, len(model.numeric_features))

    # -- 2. the card against the CPU on 200,000 rows -----------------------------------
    pair = {}
    for backend in ("gpu", "cpu"):
        label = f"dan_200k_{backend}"
        argv = ["--input_file", files["small"], "--n_steps", str(DAN_CPU_STEPS), "--log_every", str(DAN_CPU_LOG),
                "--backend", backend]
        pair[backend] = _dan_train(tmp, label, card, argv, DAN_CPU_STEPS, DAN_BATCH)
    lg, lc = (np.asarray([v for _, v in pair[b]["losses"]]) for b in ("gpu", "cpu"))
    check(len(lg) == len(lc) == DAN_CPU_STEPS // DAN_CPU_LOG, f"logged losses {len(lg)} / {len(lc)}")
    loss_gap = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    args = train_dan.parse_args(["--input_file", files["small"], "--output_file_prefix", "unused"])
    x, names, _, _ = train_dan.ingest_streaming(args)
    xt = torch.from_numpy(x).cuda()
    scores = {b: dan.make_score_predictor(registry.load_model(str(tmp / f"dan_200k_{b}.pkl"), train_dan.MODEL_NAME),
                                          names, "cuda")(xt).cpu().numpy() for b in ("gpu", "cpu")}
    gap = np.abs(scores["gpu"] - scores["cpu"])
    detail = {"rows": len(x), "steps": DAN_CPU_STEPS, "card": card, "max_loss_rel_gap": loss_gap,
              "max_score_gap": float(gap.max()), "mean_score_gap": float(gap.mean()),
              "gpu_train_s": pair["gpu"]["stages"]["train"], "cpu_train_s": pair["cpu"]["stages"]["train"]}
    print("DAN_CPU_DETAIL " + json.dumps(detail), flush=True)
    check(loss_gap <= DAN_LOSS_RTOL, f"GPU and CPU losses part by {loss_gap:.4g} (relative)")
    check(float(gap.max()) <= DAN_SCORE_ATOL, f"GPU and CPU DAN scores part by {float(gap.max()):.4g}")
    out["dan_200k"] = detail
    del xt
    torch.cuda.empty_cache()

    # -- 3. train -> filter on the 104,000-variant chr20 world ---------------------------
    w = files["vcf_world"]
    d = tmp / "dan_vcf"
    d.mkdir()
    n_labeled = _vcf_concordance(w, files["labels"], d / "concordance.h5")
    run = _tool_run("train_dan", ["--input_file", str(d / "concordance.h5"), "--output_file_prefix", str(d / "dan"),
                                  "--checkpoint_dir", str(d / "ck"), "--n_steps", str(DAN_VCF_STEPS),
                                  "--backend", "gpu"])
    check(run["rc"] == 0 and not any(run["launches"].values()), f"train_dan on the VCF world: exit {run['rc']}, "
          f"launches {run['launches']}")
    globs = _pickle_globals((d / "dan.pkl").read_bytes())
    modules = {m for m, _ in globs}
    check(modules <= {"variantcalling_tpu.models.dan", "numpy", "numpy._core.multiarray", "numpy.core.multiarray",
                      "builtins"} and ("variantcalling_tpu.models.dan", "DanModel") in globs,
          f"pickle globals {sorted(globs)}")
    trained = {"vcf": w["vcf"], "fasta": w["fasta"], "model": str(d / "dan.pkl"), "model_name": train_dan.MODEL_NAME}
    extra = ["--annotate_intervals", w["annotate"], "--runs_file", w["runs"]]
    family = {"VCTPU_MODEL_FAMILY": "dan"}
    gpu = _drive(trained, d / "filtered_gpu.vcf", "gpu", card, "trained_dan", extra=extra, env=family)
    cpu = _drive(trained, d / "filtered_cpu.vcf", "cpu", card, "trained_dan", extra=extra, env=family)
    check(not any(gpu["launches"].values()), f"trained_dan: a forest kernel was launched ({gpu['launches']})")
    lines = gpu["bytes"].decode().splitlines()
    check("##vctpu_model_family=dan" in lines, "trained_dan: the output does not record the dan family")
    n_diff = differing_records(gpu["bytes"], cpu["bytes"], 0.5, 1e-5)
    records = [ln for ln in lines if not ln.startswith("#")]
    n_pass = sum(ln.split("\t")[6] in ("PASS", "HPOL_RUN") for ln in records)
    check(0 < n_pass < len(records), f"trained_dan: {n_pass} of {len(records)} PASS")
    print("DAN_TRAIN_DETAIL " + json.dumps({"run": "dan_vcf_104k", "card": card, "wall_s": run["seconds"],
                                            "stages": run["stages"], "rows": n_labeled, "losses": run["losses"],
                                            "peak_device_bytes": run["peak_device_bytes"]}), flush=True)
    print(f"train_dan -> filter: {n_labeled} labeled variants, trained on the card in {run['seconds']:.1f} s; "
          f"GPU and CPU filter outputs: {n_diff} of {len(records)} records differ within 1e-5 of the DAN rule, "
          f"{n_pass} PASS; pickle globals {sorted(modules)}", flush=True)
    out["dan_vcf"] = {"seconds": run["seconds"], "differing_records": n_diff, "pass": n_pass}

    # -- 4. evaluate_concordance at full width on the card; card against CPU on 200,000 rows ------
    t0 = time.perf_counter()
    n_rows = _scored_eval_world(world, model, tmp / "eval_5m.h5")
    build_s = time.perf_counter() - t0
    n_small = _scored_eval_world(files["small"], model, tmp / "eval_200k.h5")
    evals = {}
    for label, backend, rows in (("eval_5m_gpu", "gpu", n_rows), ("eval_200k_gpu", "gpu", n_small),
                                 ("eval_200k_cpu", "cpu", n_small)):
        prefix = tmp / label
        # the BED files only where they are held card against CPU (200,000 rows)
        bed = [] if label == "eval_5m_gpu" else ["--output_bed"]
        run = _tool_run("evaluate_concordance", ["--input_file", str(tmp / f"{label.rsplit('_', 1)[0]}.h5"),
                                                 "--output_prefix", str(prefix), *bed, "--backend", backend])
        check(run["rc"] == 0 and not any(run["launches"].values()), f"evaluate_concordance {label}: exit "
              f"{run['rc']}, launches {run['launches']}")
        evals[label] = run
        print("EVAL_DETAIL " + json.dumps({"run": label, "backend": backend, "rows": rows, "card": card,
                                           "wall_s": run["seconds"], "stages": run["stages"],
                                           "peak_device_bytes": run["peak_device_bytes"],
                                           "world_build_s": build_s}), flush=True)
    suffixes = (".h5", ".stats.csv", ".thresholds.csv", "_fp.bed", "_fn.bed", "_tp.bed")
    for suffix in suffixes:
        a, b = (_sha256(Path(f"{tmp / label}{suffix}")) for label in ("eval_200k_gpu", "eval_200k_cpu"))
        check(a == b, f"evaluate_concordance: {suffix} differs between the card and the CPU")
    stats = (tmp / "eval_5m_gpu.stats.csv").read_text().splitlines()
    check(len(stats) == 9 and stats[0] == "group;tp;fp;fn;precision;recall;f1", f"stats.csv {stats[:2]}")
    print(f"evaluate_concordance: {n_rows} rows on the card; {n_small} rows, card and CPU outputs byte-equal "
          f"({', '.join(suffixes)}); {stats[1]} ({card})", flush=True)
    out["eval_5m"] = {b: {"seconds": r["seconds"], "stages": r["stages"]} for b, r in evals.items()}
    return out


#: phase 11's world (BASELINE config 4, "30x WGS CRAM, 1kb windows", cut to one contig): the filter
#: world's synthetic chr20 (seed 2026) and chrM at GRCh38's lengths, 30x of 150-bp reads with the planted
#: events of synthetic.COVERAGE_EVENTS; the no-native twin's and the CRAM twin's cuts of chr20
COVERAGE_WORLD = dict(seed=2026, contigs=(("chr20", 64_444_167), ("chrM", 16_569)), depth=30.0,
                      plain_cut=500_000, cram_cut=100_000)
#: copy numbers the planted events must be called with (15x, 45x and 0x of a 30x genome)
COVERAGE_EVENT_CN = (1, 3, 0)
#: cnv_calling's --min_contig_length on the cut, whose chr20 is shorter than the default 1 Mbp
COVERAGE_CUT_MIN_CONTIG = 100_000
#: the cut's planted event: 45x over 100 kbp of its 500 kbp chr20 (called CN3)
COVERAGE_CUT_EVENT = (200_000, 300_000, 45)
#: the Viterbi kernel alone: chr20 at 1 kb, and GRCh38's 24 chromosomes at 1 kb (3,088,269 bins)
CNV_CHR20_BINS = 64_444
#: the GRCh38 Viterbi case is held to its plain version on each sequence's first this many bins
VITERBI_PLAIN_CUT = 20_000
GRCH38_MB = (248.956422, 242.193529, 198.295559, 190.214555, 181.538259, 170.805979, 159.345973, 145.138636,
             138.394717, 133.797422, 135.086622, 133.275309, 114.364328, 107.043718, 101.991189, 90.338345,
             83.257441, 80.373285, 58.617616, 64.444167, 46.709983, 50.818468, 156.040895, 57.227415)
#: dependent FP32 operations a Viterbi step chains (an add, the 5-way max's compare, an add), 4 cycles each
CNV_STEP_CYCLES = 3 * 4


def _tool_child(spec: dict, results) -> None:
    """One tool of phases 11-14 (``spec["tool"]``, a name of the port's
    CLI) in a process of its own: every kernel's count and every host engine entry
    point's count set to 0 just before it and read just after; stages, wall
    seconds, peak RSS and peak card memory to ``results``, and the figures it
    skipped; with ``spec["raises"]`` its standard output and the text of the
    ``RuntimeError`` it raised (exit 1)."""
    import importlib
    import resource

    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.__main__ import TOOLS
    from variantcalling_tpu_torch.cnv import viterbi_cuda
    from variantcalling_tpu_torch.models import forest_cuda, gbt_hist

    os.environ.update(spec["env"])
    if spec.get("cwd"):  # relative outputs: two runs in two directories write the same bytes
        os.chdir(spec["cwd"])
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    times = _RunLog()
    plog.addHandler(times)
    module = importlib.import_module(TOOLS[spec["tool"]])
    gpu = "gpu" in spec["argv"]
    if gpu:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    viterbi_cuda.LAUNCHES = gbt_hist.LAUNCHES = forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
    native.reset_calls()
    from variantcalling_tpu_torch.utils import degrade

    degrade.clear_for_tests()
    stdout, error = io.StringIO(), None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout) if spec.get("raises") else contextlib.nullcontext():
        try:
            rc = module.run(spec["argv"])
        except RuntimeError as e:  # the fingerprinting tools raise their error list
            if not spec.get("raises"):
                raise
            rc, error = 1, str(e)
    seconds = time.perf_counter() - t0
    results.put({
        "stdout": stdout.getvalue() if spec.get("raises") else None, "error": error,
        "figures_skipped": len(degrade.events_for("reports.figure")),
        "rc": rc if isinstance(rc, int) else 0, "seconds": seconds, "stages": times.stages, "notes": times.notes,
        "launches": {"cnv_viterbi": viterbi_cuda.LAUNCHES, "gbt_hist": gbt_hist.LAUNCHES,
                     "forest_wide": forest_cuda.LAUNCHES, "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES},
        "host": {k: dict(v) for k, v in native.CALLS.items() if v["native"] or v["plain"]},
        "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "peak_device_bytes": torch.cuda.max_memory_allocated() if gpu else None})


def _cov_run(tool: str, argv: list[str], label: str, card: str, positions: int, env: dict | None = None,
             served_by: str | None = "bam_depth") -> dict:
    """``tool`` with ``argv`` in a forked process (:func:`_forked`): exit 0;
    on the card, served by the host engine's ``served_by`` walk and no plain
    version; a ``COVERAGE_DETAIL`` line (or ``CNV_DETAIL`` for
    ``cnv_calling``) with stages, wall, positions a second and peaks, and a
    ``HOST_ENGINE`` line."""
    run = _forked({"tool": tool, "argv": argv, "env": env or {}}, label, _tool_child)
    check(run["rc"] == 0, f"{label}: exit {run['rc']}")
    host = run["host"]
    if served_by and "gpu" in argv:
        plain = [k for k, v in host.items() if v["plain"]]
        check(host.get(served_by, {}).get("native", 0) >= 1 and not plain,
              f"{label}: the host engine did not serve {served_by}; plain: {plain}")
    others = {k: v for k, v in run["launches"].items() if k != "cnv_viterbi"}
    check(not any(others.values()), f"{label}: a kernel of another path was launched ({others})")
    detail = {"run": label, "card": card, "wall_s": run["seconds"], "stages": run["stages"],
              "positions": positions, "positions_per_s": positions / run["seconds"],
              "launches": run["launches"], "peak_rss_bytes": run["peak_rss_bytes"],
              "peak_device_bytes": run["peak_device_bytes"]}
    print(("CNV_DETAIL " if tool == "cnv_calling" else "COVERAGE_DETAIL ") + json.dumps(detail), flush=True)
    print("HOST_ENGINE " + json.dumps({"run": label, "calls": host}), flush=True)
    return run


def _full_outputs(prefix: str, windows=(100, 1000, 10000, 100000)) -> dict:
    """The sha256 of each parquet, and the h5 frames read back by the port's ``read_hdf``."""
    from variantcalling_tpu_torch.utils import h5_utils

    h5 = f"{prefix}.coverage_stats.h5"
    return {"parquet": {w: _sha256(Path(f"{prefix}.w{w}.parquet")) for w in windows},
            "frames": {k: h5_utils.read_hdf(h5, k) for k in ("histogram", "stats", "percentiles")}}


def _check_full_same(a: dict, b: dict, label: str) -> dict:
    """Parquets sha256-equal, ``histogram`` equal, ``percentiles`` equal but
    where the histogram's cdf lies within 1e-6 of the backed-off q (counted),
    ``stats`` to 1e-6 relative; returns the largest stat gap and the count."""
    check(a["parquet"] == b["parquet"], f"{label}: parquets differ")
    ha, hb = a["frames"]["histogram"], b["frames"]["histogram"]
    check(ha.columns == hb.columns and all(np.array_equal(ha[c], hb[c]) for c in ha.columns),
          f"{label}: histograms differ")
    sa, sb = a["frames"]["stats"], b["frames"]["stats"]
    check(list(sa["stat"]) == list(sb["stat"]) and sa.columns == sb.columns, f"{label}: stats frames differ in shape")
    gap = max(float(np.max(np.abs(sa[c] - sb[c]) / np.maximum(np.abs(sb[c]), 1e-30))) for c in sa.columns[1:])
    check(gap <= 1e-6, f"{label}: stats differ by {gap} relative")
    pa, pb = a["frames"]["percentiles"], b["frames"]["percentiles"]
    # the quantiles as percentiles_from_histogram backs them off: q (1 - 1e-6) in float32, at least 1e-9
    qs = np.maximum(np.float32(np.arange(0, 101, 5) / 100.0) * np.float32(1.0 - 1e-6), np.float32(1e-9))
    near = 0
    for c in pa.columns[1:]:
        cdf = np.cumsum(ha[c]) / max(float(np.sum(ha[c])), 1.0)
        for q, x, y in zip(qs.astype(np.float64), pa[c], pb[c]):
            if x != y:
                lo, hi = int(min(x, y)), int(max(x, y))
                check(min(abs(cdf[lo] - q), abs(cdf[hi - 1] - q)) <= 1e-6, f"{label}: {c} Q{q} {x} != {y}")
                near += 1
    return {"max_stats_rel_gap": gap, "percentile_near_ties": near}


def _inflated_sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with gzip.open(path, "rb") as fh:
        for block in iter(lambda: fh.read(16 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _viterbi_alone(card: str, sm_clock_hz: float, run_launches: int) -> dict:
    """The Viterbi kernel alone: chr20 at 1 kb (one sequence) and GRCh38 at
    1 kb (24 sequences, one launch), ``torch.equal`` to its plain version on
    the same card tensors; timed (``ms`` single launch, ``device_ms``,
    ``host_ms``, the plain version's ms once) beside its bound: the larger of
    the bytes (obs in, states out, at HBM rate) and the latency of the
    longest sequence's dependent steps (:data:`CNV_STEP_CYCLES` at the SM's
    top clock). ``CNV_KERNEL_DETAIL`` lines, with ``run_launches``, the
    launches of the ``cnv_calling`` run on the card."""
    from variantcalling_tpu_torch.cnv import viterbi_cuda

    out = {}
    params = viterbi_cuda.hmm_params()
    for label, lens in (("chr20_1kb", [CNV_CHR20_BINS]), ("grch38_1kb", [int(mb * 1000) for mb in GRCH38_MB])):
        rng = np.random.default_rng(len(lens))
        total = sum(lens)
        obs = rng.normal(0.0, 0.15, total).astype(np.float32)
        for s in rng.integers(0, total - 2000, 40):
            obs[s: s + int(rng.integers(5, 2000))] += np.float32(rng.choice([-3.0, -1.0, 0.585, 1.0]))
        offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
        x = torch.from_numpy(obs).cuda()
        launches = viterbi_cuda.LAUNCHES
        # the plain version walks its longest sequence bin by bin (GRCh38's chr1: about 26 s on an H100), so there
        # the kernel is held to it on each sequence's first VITERBI_PLAIN_CUT bins (24 sequences, one launch)
        cut = [min(n, VITERBI_PLAIN_CUT) for n in lens] if label == "grch38_1kb" else lens
        xc = torch.cat([x[o: o + n] for o, n in zip(offsets[:-1].tolist(), cut)])
        offc = torch.as_tensor(np.concatenate([[0], np.cumsum(cut)]).astype(np.int64))
        got = viterbi_cuda.viterbi_launch(xc, offc, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = viterbi_cuda.viterbi_plain(xc, offc, params)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = torch.equal(got, want)
        check(equal, f"cnv_viterbi {label}: kernel != plain ({int((got != want).sum())} bins)")
        run = lambda: viterbi_cuda.viterbi_launch(x, offsets, params)  # noqa: E731
        ms, dev_ms, h_ms = cuda_ms(run, reps=5, warmup=1), device_ms(run, reps=5, warmup=1), host_ms(run, reps=5,
                                                                                                       warmup=1)
        viterbi_cuda.LAUNCHES = launches  # the comparison's launches do not count
        bytes_ms = 8 * total / HBM_BYTES_PER_S * 1e3
        latency_ms = max(lens) * CNV_STEP_CYCLES / sm_clock_hz * 1e3
        ops_ms = total * (2 * 25 + 5 * 5) / FP32_OPS_PER_S * 1e3  # cand adds and compares, emission and add
        bound = max(bytes_ms, latency_ms, ops_ms)
        detail = {"kernel": "cnv_viterbi", "case": label, "card": card, "bins": total, "sequences": len(lens),
                  "longest": max(lens), "ms": ms, "device_ms": dev_ms, "host_ms": h_ms, "plain_ms": plain_ms,
                  "plain_bins": int(sum(cut)),
                  "bound_ms": bound, "bound_by": "operations" if latency_ms >= bytes_ms else "bytes",
                  "bytes_bound_ms": bytes_ms, "latency_bound_ms": latency_ms, "sm_clock_mhz": sm_clock_hz / 1e6,
                  "bound_share": bound / ms, "states_equal": equal, "cnv_calling_launches": run_launches}
        print("CNV_KERNEL_DETAIL " + json.dumps(detail), flush=True)
        out[label] = {**detail, "max_abs_err": 0.0}
    return out


def phase_coverage(tmp: Path, card: str, world_spec: dict = COVERAGE_WORLD) -> dict:
    """``coverage_analysis`` and ``cnv_calling`` on the card (phase 11).

    ``COVERAGE_WORLD`` written by ``synthetic.write_coverage_world`` (the
    port's native ``bgzf_compress``), then, each run a process of its own:
    1. on the card at full size: ``full_analysis`` at the default windows
       with ``-c`` (an exome-like BED of 20,000 intervals and the planted
       events), ``collect_coverage`` to
       ``.bedgraph.gz`` and its ``.bw``, and ``cnv_calling --reference``:
       each planted event called with its copy number, one ``cnv_viterbi``
       launch;
    2. on a 500 kbp cut (a world of its own), the card against the CPU:
       ``full_analysis`` with ``-c`` and with ``-q 20 -Q 20 -l 100`` (the
       four parquets sha256-equal,
       ``histogram`` and ``percentiles`` equal, near-ties counted, ``stats``
       to 1e-6), ``collect_coverage`` (the inflated bedGraph and the ``.bw``
       bytes equal) and ``cnv_calling`` (BED and VCF bytes equal, the cut's
       planted 45x event called CN3, one launch on the card, none on the
       CPU);
    3. the twins: ``VCTPU_NO_NATIVE=1`` (the pure-Python ``BamReader``) on
       the 500 kbp cut against the native run, and a CRAM of a 100 kbp cut
       (``tests/cram_fixtures.write_cram``, its container's base count in
       the specification's LTF8: :func:`_ltf8`) against the BAM of the same
       reads: equal outputs;
    4. the Viterbi kernel alone (:func:`_viterbi_alone`; the GRCh38 case
       held to its plain version on each contig's first
       :data:`VITERBI_PLAIN_CUT` bins).
    """
    from tests import cram_fixtures
    from variantcalling_tpu_torch import synthetic

    out: dict = {}
    seed, contigs = world_spec["seed"], [tuple(c) for c in world_spec["contigs"]]
    length = sum(n for _, n in contigs)
    events = tuple(e for e in synthetic.COVERAGE_EVENTS if e[1] <= contigs[0][1])
    t0 = time.perf_counter()
    w = synthetic.write_coverage_world(str(tmp / "coverage"), seed, contigs, world_spec["depth"], events)
    n_reads = len(w["reads"]["pos"])
    print(f"world coverage: {n_reads} reads of 150 bp on {contigs} at {world_spec['depth']}x, events {events}; "
          f"BAM {os.path.getsize(w['bam'])} bytes ({w['bam_bytes']} inflated), written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["world"] = {"reads": n_reads, "bam_bytes": os.path.getsize(w["bam"]), "write_s": time.perf_counter() - t0}

    # -- full_analysis, collect_coverage and cnv_calling at full size on the card ----------------
    d = tmp / "cov_out"
    d.mkdir()
    full_args = {"full": ["-c", w["categories"]], "full_q20": ["-q", "20", "-Q", "20", "-l", "100"]}
    # the read filters (-q -Q -l) are held on the cut below, card against CPU
    run = _cov_run("coverage_analysis", ["full_analysis", "-i", w["bam"], "-o", str(d / "full_gpu"),
                                         *full_args["full"], "--backend", "gpu"], "full_gpu", card, length)
    out["full"] = {"gpu_s": run["seconds"], "peak_device_bytes": run["peak_device_bytes"]}
    _cov_run("coverage_analysis", ["collect_coverage", "-i", w["bam"], "-o", str(d / "collect_gpu.bedgraph.gz"),
                                   "--backend", "gpu"], "collect_gpu", card, length)
    run = _cov_run("cnv_calling", ["--input_bam", w["bam"], "--output_bed", str(d / "cnv_gpu.bed"), "--output_vcf",
                                   str(d / "cnv_gpu.vcf"), "--reference", w["fasta"], "--backend", "gpu"],
                   "cnv_gpu", card, length)
    launches = run["launches"]["cnv_viterbi"]
    check(launches == 1, f"cnv_viterbi launches {launches}")
    segs = [line.split("\t") for line in (d / "cnv_gpu.bed").read_text().splitlines()]
    called = []
    for (s, e, _), cn in zip(events, COVERAGE_EVENT_CN):
        hits = [g for g in segs if g[0] == contigs[0][0] and int(g[1]) < e and int(g[2]) > s
                and g[3] == f"CN{cn}" and min(int(g[2]), e) - max(int(g[1]), s) >= 0.8 * (e - s)]
        check(hits, f"cnv_calling: the planted event {s}-{e} was not called as CN{cn}; segments {segs}")
        called.append({"event": [s, e], "cn": cn, "segment": hits[0][:4]})
    print(f"cnv_calling: {len(segs)} segments on the card, every planted event called {called} ({card})", flush=True)
    out["cnv"] = {"segments": len(segs), "called": called, "launches": launches, "gpu_s": run["seconds"]}

    # -- the card against the CPU, and the twins, on cuts of the world --------------------------------
    plain_contigs = [(contigs[0][0], world_spec["plain_cut"]), contigs[-1]]
    pw = synthetic.write_coverage_world(str(tmp / "cov_plain"), seed + 1, plain_contigs, world_spec["depth"],
                                        (COVERAGE_CUT_EVENT,), n_exome=500)
    cut_len = sum(n for _, n in plain_contigs)
    twins = {}
    for label, extra, backend, env, served in (
            ("plain_cut_native", ["-c", pw["categories"]], "gpu", {}, "bam_depth"),
            ("plain_cut_no_native", ["-c", pw["categories"]], "gpu", {"VCTPU_NO_NATIVE": "1"}, None),
            ("plain_cut_cpu", ["-c", pw["categories"]], "cpu", {}, "bam_depth"),
            ("plain_cut_q20_gpu", full_args["full_q20"], "gpu", {}, "bam_depth"),
            ("plain_cut_q20_cpu", full_args["full_q20"], "cpu", {}, "bam_depth")):
        run = _cov_run("coverage_analysis", ["full_analysis", "-i", pw["bam"], "-o", str(d / label), *extra,
                                             "--backend", backend], label, card, cut_len, env, served)
        twins[label] = _full_outputs(str(d / label))
        if not served:
            check(run["host"].get("bam_depth", {}).get("plain", 0) == 1, f"{label}: the plain reader did not serve")
    _check_full_same(twins["plain_cut_native"], twins["plain_cut_no_native"], "no-native twin")
    for tag, gpu_label, cpu_label in (("full", "plain_cut_native", "plain_cut_cpu"),
                                      ("full_q20", "plain_cut_q20_gpu", "plain_cut_q20_cpu")):
        same = _check_full_same(twins[gpu_label], twins[cpu_label], f"{tag} GPU vs CPU on the cut")
        print(f"{tag} on the {world_spec['plain_cut']} bp cut: GPU and CPU wrote equal parquets and histograms; "
              f"stats within {same['max_stats_rel_gap']:.3g} relative, {same['percentile_near_ties']} percentile "
              f"near-ties ({card})", flush=True)
        out.setdefault(tag, {}).update(same)
    sums = {}
    for backend in ("gpu", "cpu"):
        label = f"plain_cut_collect_{backend}"
        _cov_run("coverage_analysis", ["collect_coverage", "-i", pw["bam"], "-o", str(d / f"{label}.bedgraph.gz"),
                                       "--backend", backend], label, card, cut_len)
        sums[backend] = (_inflated_sha256(d / f"{label}.bedgraph.gz"), _sha256(d / f"{label}.bw"))
    check(sums["gpu"] == sums["cpu"], f"collect_coverage: GPU and CPU outputs differ {sums}")
    cnv = {}
    for backend in ("gpu", "cpu"):
        label = f"plain_cut_cnv_{backend}"
        run = _cov_run("cnv_calling", ["--input_bam", pw["bam"], "--output_bed", str(d / f"{label}.bed"),
                                       "--output_vcf", str(d / f"{label}.vcf"), "--reference", pw["fasta"],
                                       "--min_contig_length", str(COVERAGE_CUT_MIN_CONTIG), "--backend", backend],
                       label, card, cut_len)
        cnv[backend] = {"launches": run["launches"]["cnv_viterbi"], "bed": (d / f"{label}.bed").read_bytes(),
                        "vcf": (d / f"{label}.vcf").read_bytes()}
    check(cnv["gpu"]["bed"] == cnv["cpu"]["bed"] and cnv["gpu"]["vcf"] == cnv["cpu"]["vcf"],
          "cnv_calling: GPU and CPU BED/VCF bytes differ on the cut")
    start, end, _ = COVERAGE_CUT_EVENT
    check(cnv["gpu"]["bed"].decode().startswith(f"{contigs[0][0]}\t{start}\t{end}\tCN3\t"),
          f"cnv_calling: the cut's planted event was not called as CN3: {cnv['gpu']['bed'][:200]!r}")
    check(cnv["gpu"]["launches"] == 1 and cnv["cpu"]["launches"] == 0, f"cnv_viterbi launches on the cut {cnv}")
    print(f"collect_coverage and cnv_calling on the {world_spec['plain_cut']} bp cut: GPU and CPU bedGraph "
          f"(inflated), .bw, BED and VCF bytes equal ({card})", flush=True)
    cram_reads = synthetic.coverage_reads(seed + 2, [(contigs[0][0], world_spec["cram_cut"])], world_spec["depth"], ())
    cw = tmp / "cov_cram"
    cw.mkdir()
    synthetic.write_coverage_bam(str(cw / "reads.bam"), cram_reads)
    t0 = time.perf_counter()
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contigs[0][0]}\tLN:{world_spec['cram_cut']}\n"
    writer_ltf8, cram_fixtures.ltf8 = cram_fixtures.ltf8, _ltf8  # the container's base count to the specification
    try:
        cram_fixtures.write_cram(str(cw / "reads.cram"), header, synthetic.coverage_cram_records(cram_reads),
                                 method=cram_fixtures.GZIP)
    finally:
        cram_fixtures.ltf8 = writer_ltf8
    cram_write_s = time.perf_counter() - t0
    for label, src, served in (("cram_cut_bam", "reads.bam", "bam_depth"), ("cram_cut_cram", "reads.cram",
                                                                             "cram_depth")):
        _cov_run("coverage_analysis", ["full_analysis", "-i", str(cw / src), "-o", str(d / label), "-q", "20",
                                       "--backend", "gpu"], label, card, world_spec["cram_cut"], None, served)
        twins[label] = _full_outputs(str(d / label))
    _check_full_same(twins["cram_cut_bam"], twins["cram_cut_cram"], "CRAM twin")
    print(f"twins: VCTPU_NO_NATIVE=1 on {len(pw['reads']['pos'])} reads and a CRAM of {len(cram_reads['pos'])} reads "
          f"(written in {cram_write_s:.1f} s) gave the native BAM runs' outputs ({card})", flush=True)
    del twins

    # -- 6. the kernel alone ------------------------------------------------------------------------
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        clock = float(smi.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, ValueError, IndexError):
        clock = 1.98e9  # the H100 SXM's top SM clock
    out["viterbi"] = _viterbi_alone(card, clock, launches)
    return out


#: phase 12's cut of the comparison for its VCTPU_NO_NATIVE=1 twin (bp of chr20 from its start)
SEC_PLAIN_CUT = 2_000_000
#: the cohort cut (its first callsets) on which sec_training's CPU twin and pool run are held to the card's
SEC_CUT_SAMPLES = 25
#: the SEC LRT's bytes a row: observed and noise counts (5 float32 each) in, the float32 ratio out
SEC_LRT_ROW_BYTES = 44


def _sec_run(tool: str, argv: list[str], label: str, card: str, env: dict | None = None,
             served_by: tuple[str, ...] = ("vcf_parse",)) -> dict:
    """``tool`` with ``argv`` in a forked process (:func:`_forked`): exit 0, no
    kernel launched (none lies on these paths); on the card served by the
    host engine's ``served_by`` entry points and no plain version (unless
    ``env`` turns the engine off); a ``SEC_DETAIL`` line (``COMPARISON_DETAIL``
    for ``run_comparison_pipeline`` and ``vcfeval_flavors``) and a
    ``HOST_ENGINE`` line."""
    run = _forked({"tool": tool, "argv": argv, "env": env or {}}, label, _tool_child)
    return _sec_checked(tool, argv, label, card, run, env, served_by)


def _sec_checked(tool: str, argv: list[str], label: str, card: str, run: dict, env: dict | None,
                 served_by: tuple[str, ...]) -> dict:
    """:func:`_sec_run`'s checks and lines for a run already made."""
    check(run["rc"] == 0, f"{label}: exit {run['rc']}")
    check(not any(run["launches"].values()), f"{label}: a kernel was launched ({run['launches']})")
    host = run["host"]
    if "gpu" in argv and not (env or {}).get("VCTPU_NO_NATIVE"):
        plain = [k for k, v in host.items() if v["plain"]]
        missed = [k for k in served_by if host.get(k, {}).get("native", 0) == 0]
        check(not missed and not plain, f"{label}: the host engine did not serve {missed}; plain: {plain}")
    detail = {"run": label, "tool": tool, "card": card, "wall_s": run["seconds"], "stages": run["stages"],
              "peak_rss_bytes": run["peak_rss_bytes"], "peak_device_bytes": run["peak_device_bytes"]}
    name = "COMPARISON_DETAIL " if tool in ("run_comparison_pipeline", "vcfeval_flavors") else "SEC_DETAIL "
    print(name + json.dumps(detail), flush=True)
    print("HOST_ENGINE " + json.dumps({"run": label, "calls": host}), flush=True)
    return run


def _same_frames(a: str, b: str, label: str) -> int:
    """Every key of two h5 files equal, column for column (floats exactly,
    NaN where NaN); returns the rows compared."""
    from variantcalling_tpu_torch.utils import h5_utils

    keys = h5_utils.list_keys(a)
    check(keys and keys == h5_utils.list_keys(b), f"{label}: keys {keys} != {h5_utils.list_keys(b)}")
    rows = 0
    for key in keys:
        x, y = h5_utils.read_hdf(a, key), h5_utils.read_hdf(b, key)
        check(x.columns == y.columns and len(x) == len(y), f"{label}: {key} differs in shape")
        for c in x.columns:
            u, v = np.asarray(x[c]), np.asarray(y[c])
            if u.dtype == v.dtype == object and any(isinstance(a, np.ndarray) for a in v):
                # a ragged column (the evaluation's curves): array cells, value for value
                same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(u, v))
            else:
                same = u.dtype == v.dtype and (np.array_equal(u, v, equal_nan=True) if u.dtype.kind == "f"
                                               else np.array_equal(u, v))
            check(same, f"{label}: {key}.{c} differs")
        rows += len(x)
    return rows


def _ltf8(v: int) -> bytes:
    """LTF8 by the CRAM 3.0 specification (section 2.3), up to 28 bits.
    ``tests/cram_fixtures.ltf8`` writes every value from 0x4000 up in the
    3-byte form, which holds 21 bits: a data container's base count of 2^21
    or more with bit 21 set then breaks the stream (ROADMAP C5), so the CRAM
    twin's writer takes this one."""
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    check(v < 0x10000000, f"LTF8 of {v}: past the 4-byte form")
    return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])


def _hbm_rate() -> float:
    """The card's copy rate in bytes a second: a 1 GiB device-to-device copy
    (read and write counted), median of 5, by CUDA events."""
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=5, warmup=2)
    del src, dst
    return 2 * (1 << 30) / (ms * 1e-3)


def phase_sec(tmp: Path, card: str) -> dict:
    """SEC and the comparison on the card (phase 12), each run a process of its own.

    ``SEC_WORLD`` written by ``synthetic.write_sec_world``: BASELINE config 5
    (a 100-sample cohort's noise DB) cut to one contig, the filter world's
    chr20; a held-out callset of 104,000 records and its truth. Then:
    1. ``sec_training``: ``--backend gpu --use_mesh`` (the dense (S, L, A)
       sum on the card) on the 100 callsets, the DB the later steps read; on
       the first :data:`SEC_CUT_SAMPLES` callsets the same, ``--backend cpu``
       (the host merge) and ``--backend gpu --relevant_coords`` (the pool's
       loci): the card's DB equal to the CPU's (keys, counts, ``n_samples``),
       the pool DB equal to the CPU DB's rows at the pool's loci;
    2. ``correct_systematic_errors`` on the held-out callset, GPU and CPU:
       records differ only as ``tests/torch_sec_compare`` allows (counted);
       at least 90 % of the planted noise records carry SEC, at most 5 % of
       the planted real variants at pool loci do;
    3. ``sec_validation``, GPU and CPU: sweep rows equal but where a ratio
       lies within the tolerance of the row's threshold (counted);
    4. ``run_comparison_pipeline`` against the truth, GPU and CPU: every h5
       key equal column for column, the BED bytes equal, every planted
       representation difference ``tp``, the matcher served by the native
       engine; a ``VCTPU_NO_NATIVE=1`` twin on a 2 Mbp cut equal to the
       native run on the same cut; one ``--concordance_tool GC`` run;
    5. ``assess_sec_concordance`` on step 4's h5 and step 2's VCF, GPU and
       CPU: equal frames;
    6. ``vcfeval_flavors``, GPU and CPU: equal result files;
    7. the LRT alone on the card at the dense run's locus union, by CUDA
       events, beside its bytes bound at the published and the measured
       HBM rates (``SEC_LRT_DETAIL``).
    """
    from tests import torch_sec_compare
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.sec import caller
    from variantcalling_tpu_torch.sec.db import SecDb
    from variantcalling_tpu_torch.utils import h5_utils

    out: dict = {}
    spec = synthetic.SEC_WORLD
    t0 = time.perf_counter()
    w = synthetic.write_sec_world(str(tmp / "sec"), **spec)
    n_cohort = sum(int(np.count_nonzero(np.frombuffer(Path(p).read_bytes(), np.uint8) == 10)) for p in w["samples"])
    write_s = time.perf_counter() - t0
    print(f"world sec: {spec['n_samples']} cohort callsets ({n_cohort} lines with headers) over a pool of "
          f"{spec['n_pool']} noise loci on chr20 ({spec['length']} bp), a held-out callset of {spec['n_heldout']} "
          f"records, written in {write_s:.1f} s", flush=True)
    out["world"] = {"write_s": write_s, "cohort_lines": n_cohort}
    d = tmp / "sec_out"
    d.mkdir()

    # -- 1. sec_training --------------------------------------------------------------------
    train = {}
    cut = w["samples"][:SEC_CUT_SAMPLES]
    argvs = {label: ["--inputs", *samples, "--output_file", str(d / f"{label}.h5"), *extra, "--backend", backend]
             for label, samples, backend, extra in (
                 ("train_mesh_gpu", w["samples"], "gpu", ["--use_mesh"]),
                 ("train_cut_mesh_gpu", cut, "gpu", ["--use_mesh"]), ("train_cpu", cut, "cpu", []),
                 ("train_pool_gpu", cut, "gpu", ["--relevant_coords", w["pool"]]))}
    # the 100-callset run alone (its wall is the headline); the three runs on the cut side by side
    runs = {"train_mesh_gpu": _sec_run("sec_training", argvs["train_mesh_gpu"], "train_mesh_gpu", card)}
    side = _forked_all({label: {"tool": "sec_training", "argv": argvs[label], "env": {}}
                        for label in ("train_cut_mesh_gpu", "train_cpu", "train_pool_gpu")}, _tool_child)
    runs.update({label: _sec_checked("sec_training", argvs[label], label, card, run, None, ("vcf_parse",))
                 for label, run in side.items()})
    for label, run in runs.items():
        train[label] = {"run": run, "db": SecDb.load(str(d / f"{label}.h5"))}
    full_db, gpu_db, cpu_db, pool_db = (train[k]["db"] for k in ("train_mesh_gpu", "train_cut_mesh_gpu", "train_cpu",
                                                                  "train_pool_gpu"))
    check(full_db.n_samples == spec["n_samples"] and len(full_db) >= len(gpu_db),
          f"sec_training: the cohort DB holds {full_db.n_samples} samples")
    check(np.array_equal(gpu_db.keys, cpu_db.keys) and np.array_equal(gpu_db.counts, cpu_db.counts)
          and gpu_db.n_samples == cpu_db.n_samples == SEC_CUT_SAMPLES and gpu_db.contigs == cpu_db.contigs,
          "sec_training: the card's DB (--use_mesh) differs from the CPU's")
    at_pool = np.isin(cpu_db.keys, pool_db.keys)
    check(len(pool_db) > 0 and np.array_equal(cpu_db.keys[at_pool], pool_db.keys)
          and np.array_equal(cpu_db.counts[at_pool], pool_db.counts),
          "sec_training: the --relevant_coords DB is not the cohort DB at the pool's loci")
    print(f"sec_training: the cohort DB of {full_db.n_samples} samples ({len(full_db)} loci) on the card; on "
          f"{SEC_CUT_SAMPLES} of them the card's dense sum and the CPU's host merge wrote equal DBs ({len(gpu_db)} "
          f"loci); the pool DB holds {len(pool_db)} of them ({card})", flush=True)
    out["train"] = {k: {"seconds": v["run"]["seconds"], "loci": len(v["db"]),
                        "peak_device_bytes": v["run"]["peak_device_bytes"]} for k, v in train.items()}
    db_path = str(d / "train_mesh_gpu.h5")

    # -- 2. correct_systematic_errors -------------------------------------------------------------
    for backend in ("gpu", "cpu"):
        _sec_run("correct_systematic_errors", ["--model", db_path, "--gvcf", w["heldout"], "--output_file",
                                               str(d / f"corrected_{backend}.vcf"), "--backend", backend],
                 f"correct_{backend}", card, served_by=("vcf_parse",))
    corrected = {b: (d / f"corrected_{b}.vcf").read_bytes() for b in ("gpu", "cpu")}
    n_diff = torch_sec_compare.differing_records(corrected["gpu"], corrected["cpu"], caller.DEFAULT_NOISE_RATIO)
    table = read_vcf(str(d / "corrected_gpu.vcf"))
    sec = np.asarray(["SEC" in str(f).split(";") for f in table.filters])
    noise_share = float(sec[np.isin(table.pos, w["noise_pos"])].mean())
    real_share = float(sec[np.isin(table.pos, w["real_pool_pos"])].mean())
    check(noise_share >= 0.9 and real_share <= 0.05,
          f"correct_systematic_errors: {noise_share:.4f} of the planted noise and {real_share:.4f} of the planted "
          "real variants at noise loci carry SEC")
    print(f"correct_systematic_errors: {int(sec.sum())} of {len(table)} records SEC; planted noise {noise_share:.4f}, "
          f"planted real variants at noise loci {real_share:.4f}; GPU and CPU: {n_diff} records differ within "
          f"{torch_sec_compare.RTOL} of the ratio ({card})", flush=True)
    out["correct"] = {"differing_records": n_diff, "noise_share": noise_share, "real_share": real_share}

    # -- 3. sec_validation -----------------------------------------------------------------------
    for backend in ("gpu", "cpu"):
        _sec_run("sec_validation", ["--model", db_path, "--sample_vcf", w["heldout"], "--truth_vcf", w["truth"],
                                    "--output_file", str(d / f"sweep_{backend}.csv"), "--backend", backend],
                 f"validation_{backend}", card)
    held = read_vcf(w["heldout"])
    hit, rows = full_db.lookup(held.chrom, held.pos)
    ratios = caller.hit_ratios(held, full_db, hit, rows, "cpu")
    n_rows = torch_sec_compare.differing_sweep_rows((d / "sweep_gpu.csv").read_text(),
                                                    (d / "sweep_cpu.csv").read_text(), ratios)
    print(f"sec_validation: GPU and CPU sweeps, {n_rows} rows differ within the tolerance of their threshold; "
          f"{(d / 'sweep_gpu.csv').read_text().splitlines()[4]} ({card})", flush=True)
    out["validation"] = {"differing_rows": n_rows}

    # -- 4. run_comparison_pipeline ----------------------------------------------------------------
    base = ["--input_prefix", w["heldout"], "--gtr_vcf", w["truth"], "--highconf_intervals", w["hcr"],
            "--reference", w["fasta"], "--annotate_intervals", w["exome"]]
    for backend in ("gpu", "cpu"):
        _sec_run("run_comparison_pipeline", [*base, "--output_file", str(d / f"cmp_{backend}.h5"),
                                             "--output_interval", str(d / f"cmp_{backend}.bed"), "--backend",
                                             backend], f"comparison_{backend}", card,
                 served_by=("vcf_parse", "match_contig_native"))
    n_cmp = _same_frames(str(d / "cmp_gpu.h5"), str(d / "cmp_cpu.h5"), "run_comparison_pipeline GPU vs CPU")
    check((d / "cmp_gpu.bed").read_bytes() == (d / "cmp_cpu.bed").read_bytes(), "run_comparison: BEDs differ")
    frame = h5_utils.read_hdf(str(d / "cmp_gpu.h5"), "all")
    cls = np.asarray(frame["classify"], dtype=object)
    planted = np.isin(frame["pos"], w["repr_pos"]) & (np.asarray(frame["call"], dtype=object) != "NA")
    check(planted.sum() == len(w["repr_pos"]) and (cls[planted] == "tp").all(),
          f"run_comparison: {int((cls[planted] == 'tp').sum())} of {len(w['repr_pos'])} planted representation "
          "differences classified tp")
    counts = {c: int((cls == c).sum()) for c in ("tp", "fp", "fn")}
    with open(d / "cut.bed", "w") as fh:
        fh.write(f"chr20\t0\t{SEC_PLAIN_CUT}\n")
    for label, env, served in (("comparison_cut_native", {}, ("vcf_parse", "match_contig_native")),
                               ("comparison_cut_no_native", {"VCTPU_NO_NATIVE": "1"}, ())):
        run = _sec_run("run_comparison_pipeline", [*base, "--cmp_intervals", str(d / "cut.bed"), "--output_file",
                                                   str(d / f"{label}.h5"), "--output_interval",
                                                   str(d / f"{label}.bed"), "--backend", "gpu"],
                       label, card, env=env, served_by=served)
        if env:
            check(run["host"].get("match_contig_native", {}).get("plain", 0) >= 1,
                  f"{label}: the Python matcher did not serve")
    n_cut = _same_frames(str(d / "comparison_cut_native.h5"), str(d / "comparison_cut_no_native.h5"),
                         "run_comparison no-native twin")
    _sec_run("run_comparison_pipeline", [*base, "--concordance_tool", "GC", "--output_file", str(d / "cmp_gc.h5"),
                                         "--output_interval", str(d / "cmp_gc.bed"), "--backend", "gpu"],
             "comparison_gc_gpu", card)
    gc = np.asarray(h5_utils.read_hdf(str(d / "cmp_gc.h5"), "all")["classify"], dtype=object)
    gc_counts = {c: int((gc == c).sum()) for c in ("tp", "fp", "fn")}
    print(f"run_comparison_pipeline: GPU and CPU wrote equal frames ({n_cmp} rows, {counts}) and BEDs; "
          f"{int(planted.sum())} of {len(w['repr_pos'])} planted representation differences tp; the no-native twin "
          f"equal on the {SEC_PLAIN_CUT} bp cut ({n_cut} rows); GC {gc_counts} ({card})", flush=True)
    out["comparison"] = {"rows": n_cmp, "classes": counts, "planted_tp": int(planted.sum()), "cut_rows": n_cut,
                         "gc_classes": gc_counts, "gpu_h5": str(d / "cmp_gpu.h5")}
    out["paths"] = {k: w[k] for k in ("heldout", "truth", "hcr", "fasta")}

    # -- 5. assess_sec_concordance -----------------------------------------------------------------
    for backend in ("gpu", "cpu"):
        _sec_run("assess_sec_concordance", ["--concordance_h5", str(d / "cmp_gpu.h5"), "--corrected_vcf",
                                            str(d / "corrected_gpu.vcf"), "--output_file",
                                            str(d / f"assess_{backend}.h5"), "--backend", backend],
                 f"assess_{backend}", card)
    _same_frames(str(d / "assess_gpu.h5"), str(d / "assess_cpu.h5"), "assess_sec_concordance GPU vs CPU")
    delta = h5_utils.read_hdf(str(d / "assess_gpu.h5"), "delta")
    fp_removed, tp_lost = int(delta["fp_removed"][0]), int(delta["tp_lost"][0])
    print(f"assess_sec_concordance: GPU and CPU frames equal; SNP: {fp_removed} fps removed, {tp_lost} tps lost "
          f"({card})", flush=True)
    out["assess"] = {"snp_fp_removed": fp_removed, "snp_tp_lost": tp_lost}

    # -- 6. vcfeval_flavors ----------------------------------------------------------------------------
    for backend in ("gpu", "cpu"):
        _sec_run("vcfeval_flavors", ["-b", w["truth"], "-c", w["heldout"], "-t", w["fasta"], "-e", w["hcr"],
                                     "-o", str(d / f"flavors_{backend}"), "--backend", backend],
                 f"flavors_{backend}", card, served_by=("vcf_parse", "match_contig_native"))
    res = [(d / f"flavors_{b}" / "vcfeval_flavors_results.txt").read_bytes() for b in ("gpu", "cpu")]
    check(res[0] == res[1], "vcfeval_flavors: GPU and CPU results differ")
    print(f"vcfeval_flavors: GPU and CPU results equal: {res[0].decode().strip().splitlines()} ({card})", flush=True)

    # -- 7. the LRT alone at the dense run's locus union ---------------------------------------------
    n = w["cohort_loci"]
    rng = np.random.default_rng(spec["seed"])
    depth = rng.integers(8, 60, n)
    obs = np.zeros((n, 5), np.float32)
    obs[:, 1] = rng.binomial(depth, 0.05)
    obs[:, 0] = depth - obs[:, 1]
    noise = rng.integers(0, 3000, (n, 5)).astype(np.float32)
    o, z = torch.from_numpy(obs).cuda(), torch.from_numpy(noise).cuda()
    got = caller.noise_likelihood_ratio(o, z).cpu().numpy()
    want = caller.noise_likelihood_ratio(torch.from_numpy(obs), torch.from_numpy(noise)).numpy()
    live = want > 1e-30
    rel = float((np.abs(got - want)[live] / want[live]).max(initial=0))
    check(rel <= torch_sec_compare.RTOL, f"SEC LRT: card and CPU ratios part by {rel:.3g} (relative)")
    ms = cuda_ms(lambda: caller.noise_likelihood_ratio(o, z), reps=20, warmup=3)
    t0 = time.perf_counter()
    caller.noise_likelihood_ratio(torch.from_numpy(obs), torch.from_numpy(noise))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rate = _hbm_rate()
    detail = {"rows": n, "card": card, "ms": ms, "cpu_ms": cpu_ms, "bytes": SEC_LRT_ROW_BYTES * n,
              "bound_ms": SEC_LRT_ROW_BYTES * n / HBM_BYTES_PER_S * 1e3,
              "measured_hbm_bytes_per_s": rate, "measured_bound_ms": SEC_LRT_ROW_BYTES * n / rate * 1e3,
              "bound_share": SEC_LRT_ROW_BYTES * n / rate * 1e3 / ms, "max_rel_err_vs_cpu": rel}
    print("SEC_LRT_DETAIL " + json.dumps(detail), flush=True)
    out["lrt"] = detail
    del o, z
    torch.cuda.empty_cache()
    return out


#: phase 13: the gVCF twins' cut (bp of chr20), the runs' minimum length
GVCF_PLAIN_CUT = 2_000_000
RUNS_MIN_LENGTH = 10
#: bytes of code each base of the runs scan reads, and of the (start, length) int64 pair each selected run writes
RUNS_SCAN_BYTES = (1, 16)


def _tool_jobs(jobs: list[tuple[str, list[str], str, dict | None]], card: str, kind: str,
               served_by: tuple[str, ...] = ("vcf_parse",), plain_ok: tuple[str, ...] = (),
               raises: bool = False, side_by_side: bool = False) -> dict[str, dict]:
    """Phase 13's and 14's runs ``(tool, argv, label, env)``, each in a process
    of its own (:func:`_forked`), one after another, or with ``side_by_side``
    all at once (:func:`_forked_all`: independent runs): exit 0 (with ``raises``:
    the ``RuntimeError`` of the fingerprinting tools' error list, exit 1, its
    text and the run's standard output kept), no kernel launched (none lies
    on these paths); served by the host engine's ``served_by`` entry points
    and no plain version, but in a run whose env turns the engine off and
    for ``plain_ok`` (the stub of beagle writes plain gzip); a ``<kind>_DETAIL``
    line (wall, stages, peak RSS and card memory, figures skipped) and a
    ``HOST_ENGINE`` line for each."""
    out = {}
    specs = {label: {"tool": tool, "argv": argv, "env": env or {}, "raises": raises} for tool, argv, label, env in jobs}
    together = _forked_all(specs, _tool_child) if side_by_side else {}
    for tool, argv, label, env in jobs:
        run = together[label] if side_by_side else _forked(specs[label], label, _tool_child)
        check(run["rc"] == int(raises) and (run["error"] is not None) == raises,
              f"{label}: exit {run['rc']}, error {run['error']!r}")
        check(not any(run["launches"].values()), f"{label}: a kernel was launched ({run['launches']})")
        host = run["host"]
        if not (env or {}).get("VCTPU_NO_NATIVE"):
            plain = [k for k, v in host.items() if v["plain"] and k not in plain_ok]
            missed = [k for k in served_by if host.get(k, {}).get("native", 0) == 0]
            check(not missed and not plain, f"{label}: the host engine did not serve {missed}; plain: {plain}")
        detail = {"run": label, "tool": tool, "card": card, "wall_s": run["seconds"], "stages": run["stages"],
                  "peak_rss_bytes": run["peak_rss_bytes"], "peak_device_bytes": run["peak_device_bytes"],
                  "figures_skipped": run["figures_skipped"], "side_by_side": len(jobs) if side_by_side else 1}
        print(f"{kind}_DETAIL " + json.dumps(detail), flush=True)
        print("HOST_ENGINE " + json.dumps({"run": label, "calls": host}), flush=True)
        out[label] = run
    return out


def _records(path: Path) -> list[bytes]:
    data = path.read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return [ln for ln in data.split(b"\n") if ln and not ln.startswith(b"#")]


def _csv_column(path: Path, name: str) -> int:
    rows = path.read_text().splitlines()
    col = rows[0].split(",").index(name)
    return sum(int(r.split(",")[col]) for r in rows[1:])


def _fasta_codes(path: str) -> dict[str, np.ndarray]:
    """Each contig's uint8 codes (A C G T either case 0-3, anything else 4),
    read with numpy alone: the runs world's independent check."""
    data = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    table = np.full(256, 4, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        table[b] = table[b + 32] = i
    heads = np.flatnonzero((data == ord(">")) & np.concatenate([[True], data[:-1] == ord("\n")]))
    out = {}
    for k, h in enumerate(heads.tolist()):
        eol = h + int(np.argmax(data[h:] == ord("\n")))
        body = data[eol + 1: heads[k + 1] if k + 1 < len(heads) else len(data)]
        out[bytes(data[h + 1: eol]).decode().split()[0]] = table[body[body != ord("\n")]]
    return out


def _walk_runs(codes: np.ndarray, min_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of the runs of one real base of at least ``min_length``, by numpy."""
    edges = np.concatenate([[0], np.flatnonzero(np.diff(codes.astype(np.int16)) != 0) + 1, [len(codes)]])
    starts, lengths = edges[:-1], np.diff(edges)
    keep = (lengths >= min_length) & (codes[starts] < 4)
    return starts[keep], lengths[keep]


def _runs_scan_alone(codes: np.ndarray, card: str) -> dict:
    """The runs scan of one contig alone on the card (``ops/runs``, by CUDA
    events), its peak card memory, and the bytes the function must move (its
    codes read once, its selected runs written once) against the card's
    published rate. ``intermediate_bytes`` counts, apart from the bound, the
    (start, length) pairs of every run of equal codes that this
    implementation writes on the way."""
    from variantcalling_tpu_torch.ops import runs as truns

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = torch.from_numpy(codes).cuda()
    scan = lambda: truns.select_runs(t, *truns.run_starts_lengths(t), RUNS_MIN_LENGTH)  # noqa: E731
    n_runs = len(truns.run_starts_lengths(t)[0])
    n_selected = len(scan()[0])
    ms = cuda_ms(scan, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() - before
    nbytes = RUNS_SCAN_BYTES[0] * len(codes) + RUNS_SCAN_BYTES[1] * n_selected
    detail = {"bases": len(codes), "runs_all": n_runs, "runs_selected": n_selected, "card": card, "ms": ms,
              "peak_device_bytes": peak, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms, "intermediate_bytes": RUNS_SCAN_BYTES[1] * n_runs}
    del t
    torch.cuda.empty_cache()
    return detail


def phase_genotypes_gvcf(tmp: Path, card: str, worlds: dict | None = None) -> dict:
    """Genotypes, imputation, the gVCF tools and the runs scan (phase 13),
    each run a process of its own, one after another.

    The worlds (``synthetic``; ``worlds`` overrides their sizes):
    1. ``IMPUTE_WORLD``: ``correct_genotypes_by_imputation
       --beagle_annotated_vcf`` GPU and CPU (records differing only as
       ``tests/torch_genotype_compare`` admits, counted; counters equal;
       ``changed_gt`` equal to the planted flips), a rerun on the card's
       output (no GT changed, no key or header line repeated), and the
       ``--input_vcf`` stage chain on the two-contig cut with the stub of
       beagle, GPU against CPU;
    2. ``HAPLOID_WORLD``: ``convert_haploid_regions`` with ``hg38_non_par``
       and with a BED, GPU against CPU under the bar, every record outside
       the regions byte-equal to the input;
    3. ``GVCF_WORLD``: ``compress_gvcf``, ``cleanup_gvcf_before_calling``
       (the planted drops, exactly) and ``gvcf_hcr`` (both ``--below``
       settings); each of them on a ``GVCF_PLAIN_CUT`` bp cut with the native
       engine and with ``VCTPU_NO_NATIVE=1``, equal bytes;
    4. ``TRIO_WORLD``: ``denovo_recalibrated_qualities``, every planted de
       novo record's ``DENOVO_QUAL`` the world's minimum;
    5. ``RUNS_WORLD``: ``find_runs_bed`` GPU and CPU, equal bytes, equal to
       the planted runs and to a numpy walk of the FASTA; the scan of chr20
       alone on the card (``RUNS_KERNEL_DETAIL``).
    """
    from tests import torch_genotype_compare as gcmp
    from variantcalling_tpu_torch import synthetic
    from variantcalling_tpu_torch.pipelines.convert_haploid_regions import HG38_NON_PAR, in_regions_mask

    spec = {"impute": synthetic.IMPUTE_WORLD, "haploid": synthetic.HAPLOID_WORLD, "gvcf": synthetic.GVCF_WORLD,
            "trio": synthetic.TRIO_WORLD, "runs": synthetic.RUNS_WORLD, **(worlds or {})}
    d = tmp / "geno"
    t0 = time.perf_counter()
    imp = synthetic.write_impute_world(str(d / "impute"), **spec["impute"])
    hap = synthetic.write_haploid_world(str(d / "haploid"), **spec["haploid"])
    gv = synthetic.write_gvcf_world(str(d / "gvcf"), **spec["gvcf"])
    trio = synthetic.write_trio_world(str(d / "trio"), **spec["trio"])
    rw = synthetic.write_runs_world(str(d / "runs"), **spec["runs"])
    write_s = time.perf_counter() - t0
    print(f"worlds genotypes and gVCF: {imp['n_records']} annotated records ({imp['flips']} planted flips), "
          f"{hap['n']} chrX/chrY records, a gVCF of {gv['n_records']} records ({gv['n_blocks']} blocks, "
          f"{gv['planted_drops']} planted drops), a trio of {spec['trio']['n_sites']} sites, a FASTA of "
          f"{sum(n for _, n in spec['runs']['contigs'])} bp with {len(rw['planted'])} planted runs; written in "
          f"{write_s:.1f} s", flush=True)
    out: dict = {"world": {"write_s": write_s}}
    o = d / "out"
    o.mkdir()

    # -- 1 and 2, the device tools: imputation and haploid, GPU and CPU runs together ------------------------------
    chain = ["--input_vcf", imp["chain"], "--chrom_to_cohort_vcfs_json", imp["cohort_json"], "--chrom_to_plink_json",
             imp["plink_json"], "--beagle_cmd", f"{sys.executable} {imp['beagle_stub']}"]
    jobs = []
    for b in ("gpu", "cpu"):
        jobs.append(("correct_genotypes_by_imputation", ["--beagle_annotated_vcf", imp["annotated"], "--output_vcf",
                                                        str(o / f"imp_{b}.vcf"), "--backend", b], f"impute_{b}", None))
        for label, regions in (("non_par", "hg38_non_par"), ("bed", hap["bed"])):
            jobs.append(("convert_haploid_regions", ["--input_vcf", hap["vcf"], "--output_vcf",
                                                     str(o / f"hap_{label}_{b}.vcf"), "--haploid_regions", regions,
                                                     "--backend", b], f"haploid_{label}_{b}", None))
    runs = _tool_jobs(jobs, card, "GENOTYPE", side_by_side=True)
    n_imp = gcmp.differing_imputation_records((o / "imp_gpu.vcf").read_bytes(), (o / "imp_cpu.vcf").read_bytes(),
                                              imp["annotated"])
    gcmp.same_counters((o / "imp_gpu_counts.csv").read_bytes(), (o / "imp_cpu_counts.csv").read_bytes())
    changed = _csv_column(o / "imp_gpu_counts.csv", "changed_gt")
    check(changed == imp["flips"], f"imputation: {changed} genotypes changed, {imp['flips']} flips planted")
    chain_runs = _tool_jobs(
        [("correct_genotypes_by_imputation", ["--beagle_annotated_vcf", str(o / "imp_gpu.vcf"), "--output_vcf",
                                              str(o / "rerun_gpu.vcf"), "--backend", "gpu"], "impute_rerun_gpu", None)]
        + [("correct_genotypes_by_imputation", [*chain, "--temp_dir", str(o / f"chain_{b}"), "--output_vcf",
                                                str(o / f"chain_{b}.vcf.gz"), "--backend", b], f"impute_chain_{b}",
            None) for b in ("gpu", "cpu")], card, "GENOTYPE", plain_ok=("vcf_parse", "bgzf_decompress_array"),
        side_by_side=True)
    runs.update(chain_runs)
    check(_csv_column(o / "rerun_gpu_counts.csv", "changed_gt") == 0, "imputation rerun: a genotype changed")
    first, second = (o / "imp_gpu.vcf").read_bytes(), (o / "rerun_gpu.vcf").read_bytes()
    heads = [[ln for ln in x.split(b"\n") if ln.startswith(b"#")] for x in (first, second)]
    check(heads[0] == heads[1], "imputation rerun: the header changed")
    check(all(ln.split(b"\t")[8].split(b":").count(b"GT0") <= 1 for ln in _records(o / "rerun_gpu.vcf")),
          "imputation rerun: GT0 repeated")
    parts = sorted(str(p) for p in (o / "chain_gpu").glob("beagle_anno.*.vcf.gz"))
    n_chain = gcmp.differing_imputation_records((o / "chain_gpu.vcf.gz").read_bytes(),
                                                (o / "chain_cpu.vcf.gz").read_bytes(), parts)
    gcmp.same_counters((o / "chain_gpu_counts.csv").read_bytes(), (o / "chain_cpu_counts.csv").read_bytes())
    print(f"correct_genotypes_by_imputation: GPU and CPU {n_imp} records differ within the bar; {changed} genotypes "
          f"changed of {imp['flips']} planted flips; the rerun changed none; the stage chain on "
          f"{2 * spec['impute']['chain_records']} records GPU and CPU, {n_chain} differ "
          f"({_csv_column(o / 'chain_gpu_counts.csv', 'has_non_ref_imp')} rewritten) ({card})", flush=True)
    out["impute"] = {"differing": n_imp, "changed_gt": changed, "chain_differing": n_chain}

    src = _records(Path(hap["vcf"]))
    src_f = [ln.split(b"\t", 2) for ln in src]
    chrom = np.asarray([f[0].decode() for f in src_f], dtype=object)
    pos = np.asarray([int(f[1]) for f in src_f], dtype=np.int64)
    from variantcalling_tpu_torch.io.bed import read_bed

    bed = read_bed(hap["bed"])
    hap_out = {}
    for label, regions in (("non_par", HG38_NON_PAR),
                           ("bed", [(str(c), int(s), int(e)) for c, s, e in zip(bed.chrom, bed.start, bed.end)])):
        n_diff = gcmp.differing_haploid_records((o / f"hap_{label}_gpu.vcf").read_bytes(),
                                                (o / f"hap_{label}_cpu.vcf").read_bytes(), hap["vcf"])
        inside = in_regions_mask(chrom, pos, regions)
        got = _records(o / f"hap_{label}_gpu.vcf")
        check(len(got) == len(src) and all(got[i] == src[i] for i in np.flatnonzero(~inside).tolist()),
              f"convert_haploid_regions {label}: a record outside the regions changed")
        n_conv = sum(got[i] != src[i] for i in np.flatnonzero(inside).tolist())
        hap_out[label] = {"differing": n_diff, "in_regions": int(inside.sum()), "rewritten": n_conv}
    print(f"convert_haploid_regions: GPU and CPU within the bar {hap_out}; every record outside the regions "
          f"byte-equal to the input ({card})", flush=True)
    out["haploid"] = hap_out

    # -- 3 and 4, the host tools: the gVCF at full size and its cut with and without the engine; the trio -----------
    cut = d / "gvcf_cut.g.vcf"
    with open(gv["gvcf"], "rb") as fh, open(cut, "wb") as dst:
        for line in fh:
            if not line.startswith(b"#") and int(line.split(b"\t", 2)[1]) > GVCF_PLAIN_CUT:
                break
            dst.write(line)

    def gvcf_jobs(src: str, tag: str, env: dict | None) -> list:
        return [("compress_gvcf", ["--input_path", src, "--output_path", str(o / f"{tag}_compress.g.vcf")],
                 f"{tag}_compress", env),
                ("cleanup_gvcf_before_calling", [src, str(o / f"{tag}_cleanup.g.vcf")], f"{tag}_cleanup", env),
                ("gvcf_hcr", ["--gvcf", src, "--output_bed", str(o / f"{tag}_hcr.bed")], f"{tag}_hcr", env),
                ("gvcf_hcr", ["--gvcf", src, "--output_bed", str(o / f"{tag}_hcr_below.bed"), "--below"],
                 f"{tag}_hcr_below", env)]

    dn = ("denovo_recalibrated_qualities", [trio["trio"], str(o / "denovo.vcf"), trio["maternal_json"],
                                             trio["paternal_json"]], "denovo", None)
    runs.update(_tool_jobs([*gvcf_jobs(gv["gvcf"], "gvcf", None), dn], card, "GVCF", side_by_side=True))
    runs.update(_tool_jobs([*gvcf_jobs(str(cut), "cut", None), *gvcf_jobs(str(cut), "cut_plain",
                                                                             {"VCTPU_NO_NATIVE": "1"})], card, "GVCF",
                           side_by_side=True))
    n_in = len(_records(Path(gv["gvcf"])))
    kept = len(_records(o / "gvcf_cleanup.g.vcf"))
    check(n_in - kept == gv["planted_drops"], f"cleanup: {n_in - kept} dropped, {gv['planted_drops']} planted")
    n_comp = len(_records(o / "gvcf_compress.g.vcf"))
    check(0 < n_comp < n_in, f"compress_gvcf: {n_comp} records of {n_in}")
    beds = {k: (o / f"gvcf_{k}.bed").read_bytes().count(b"\n") for k in ("hcr", "hcr_below")}
    check(min(beds.values()) > 0, f"gvcf_hcr: empty BED {beds}")
    for name in ("compress.g.vcf", "cleanup.g.vcf", "hcr.bed", "hcr_below.bed"):
        check((o / f"cut_{name}").read_bytes() == (o / f"cut_plain_{name}").read_bytes(),
              f"{name}: the VCTPU_NO_NATIVE=1 twin differs on the cut")
    print(f"gVCF tools: {n_in} records compressed to {n_comp}; cleanup dropped {n_in - kept} of "
          f"{gv['planted_drops']} planted; gvcf_hcr {beds['hcr']} intervals at GQ >= 20 and {beds['hcr_below']} "
          f"below; the {GVCF_PLAIN_CUT} bp cut byte-equal native and VCTPU_NO_NATIVE=1 ({card})", flush=True)
    out["gvcf"] = {"records": n_in, "compressed": n_comp, "dropped": n_in - kept, "hcr_intervals": beds}

    got = {}
    for ln in _records(o / "denovo.vcf"):
        f = ln.decode().split("\t")
        if "DENOVO_QUAL=" in f[7]:
            got[int(f[1])] = float(f[7].split("DENOVO_QUAL=")[1].split(";")[0])
    want = dict(zip(trio["denovo_pos"].tolist(), (float(f"{q:g}") for q in trio["denovo_qual"])))
    check(got == want, f"denovo: {len(got)} DENOVO_QUAL values against {len(want)} planted, or values differ")
    print(f"denovo_recalibrated_qualities: {len(got)} DENOVO_QUAL values, each the planted minimum ({card})",
          flush=True)
    out["denovo"] = {"annotated": len(got)}

    # -- 5, the runs scan ------------------------------------------------------------------------------------------
    runs.update(_tool_jobs([("find_runs_bed", ["--reference", rw["fasta"], "--output_bed", str(o / f"runs_{b}.bed"),
                                               "--backend", b], f"runs_{b}", None) for b in ("gpu", "cpu")],
                           card, "RUNS", served_by=("fasta_encode",)))
    bed_gpu = (o / "runs_gpu.bed").read_bytes()
    check(bed_gpu == (o / "runs_cpu.bed").read_bytes(), "find_runs_bed: GPU and CPU BEDs differ")
    codes = _fasta_codes(rw["fasta"])
    walk = "".join(f"{c}\t{s}\t{s + n}\n" for c, v in codes.items()
                   for s, n in zip(*(x.tolist() for x in _walk_runs(v, RUNS_MIN_LENGTH))))
    planted = "".join(f"{c}\t{s}\t{s + n}\n" for c, s, n in rw["planted"] if n >= RUNS_MIN_LENGTH)
    check(bed_gpu.decode() == walk == planted, "find_runs_bed: the BED differs from the planted runs or the walk")
    scan = _runs_scan_alone(codes[spec["runs"]["contigs"][0][0]], card)
    print("RUNS_KERNEL_DETAIL " + json.dumps(scan), flush=True)
    print(f"find_runs_bed: GPU and CPU BEDs equal, {planted.count(chr(10))} runs of {RUNS_MIN_LENGTH} bp and more, "
          f"as planted and as a numpy walk finds them; the scan of {scan['bases']} bases alone {scan['ms']:.3f} ms, "
          f"peak card memory {scan['peak_device_bytes']} bytes ({card})", flush=True)
    out["runs"] = {"runs": planted.count("\n"), "scan": scan}
    out["walls"] = {k: v["seconds"] for k, v in runs.items()}
    out["files"] = {"trio": trio["trio"]}
    return out


def _tsv_column(path: str, name: str) -> np.ndarray:
    rows = [line.rstrip("\r\n").split("\t") for line in Path(path).read_text().splitlines()]
    j = rows[0].index(name)
    return np.array([int(r[j]) for r in rows[1:]], dtype=np.int64)


def phase_reports(tmp: Path, card: str, trio_vcf: str | None = None, worlds: dict | None = None) -> dict:
    """The report tools and pileup fingerprinting (phase 14), each run a
    process of its own, one after another, each card run against its CPU twin.

    1. ``REPORT_WORLD`` (``synthetic_reports``): ``run_no_gt_report
       full_analysis`` (with the callable BED), ``variant_eval`` and
       ``somatic_analysis`` (the three seeded catalogs, their metadata, two
       controls), card and CPU: every h5 frame equal, the ``.all`` matrices
       byte-equal, the exposures under ``tests/torch_report_compare``'s bar
       (counted); the planted hmer tables, doublets (DBS78), one-base ID83
       channels, indel and SNV totals and SBS96 counts found exactly, and the
       planted SBS96 mixture recovered (each planted signature's fraction
       within 0.03, the others under 5 % together).
    2. ``joint_calling_report`` on phase 13's ``TRIO_WORLD`` joint VCF with a
       dbSNP of 40 % of its sites and 250,000 others, card and CPU: equal h5
       frames and HTML.
    3. ``substitution_error_rate_report`` (host code) on a seeded motif h5:
       96 folded channels, the keys of the reference.
    4. ``FINGERPRINT_WORLD``: ``quick_fingerprinting`` and
       ``training_set_consistency_check`` on the BAMs and CRAMs, card and
       CPU: the same printed lines and error lists, the expected errors; the
       pileup of every sample by the engine's BAM walk equal to its
       ``VCTPU_NO_NATIVE=1`` plain walk and to the CRAM decoder's, timed.
    """
    from tests import cram_fixtures
    from tests import torch_report_compare as rc
    from variantcalling_tpu_torch import synthetic, synthetic_reports
    from variantcalling_tpu_torch.comparison import pileup_caller
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.reports.no_gt_stats import HMER_CLASSES
    from variantcalling_tpu_torch.utils import h5_utils

    spec = {"report": synthetic_reports.REPORT_WORLD, "fingerprint": synthetic_reports.FINGERPRINT_WORLD,
            "trio": synthetic.TRIO_WORLD, **(worlds or {})}
    d = tmp / "reports"
    o = d / "out"
    o.mkdir(parents=True)
    t0 = time.perf_counter()
    rw = synthetic_reports.write_report_world(str(d / "report"), **spec["report"])
    report_s = time.perf_counter() - t0
    if trio_vcf is None:
        trio_vcf = synthetic.write_trio_world(str(d / "trio"), **spec["trio"])["trio"]
    t1 = time.perf_counter()
    trio = read_vcf(trio_vcf, drop_format=True)
    trio_dbsnp = str(d / "trio_dbsnp.vcf")
    n_trio_db = synthetic_reports.write_dbsnp(trio_dbsnp, 2040, "chr20", spec["trio"]["length"],
                                              list(zip(trio.pos.tolist(), trio.ref.tolist(), trio.alt.tolist())),
                                              n_extra=spec["report"]["n_extra_dbsnp"])
    motifs = str(d / "motifs.h5")
    synthetic_reports.write_motif_h5(motifs, 2041)
    t2 = time.perf_counter()
    fw = synthetic_reports.write_fingerprint_world(
        str(d / "fingerprint"), **spec["fingerprint"],
        cram_writer=lambda path, header, recs: cram_fixtures.write_cram(path, header, recs,
                                                                        method=cram_fixtures.GZIP))
    confs = synthetic_reports.fingerprint_confs(fw, str(d / "fingerprint"))
    t3 = time.perf_counter()
    planted = rw["planted"]["case"]
    print(f"worlds reports and fingerprints: a case of {planted['records']} records ({planted['n_snv_records']} SNV "
          f"records, {planted['n_indels']} indels, {int(planted['dbs'].sum())} doublets), two controls, a dbSNP of "
          f"{rw['dbsnp_records']} records, written in {report_s:.1f} s; the trio's dbSNP of {n_trio_db} records and "
          f"the motif h5 in {t2 - t1:.1f} s; four samples at {spec['fingerprint']['depth']}x over "
          f"{fw['region_str']} as BAM and CRAM in {t3 - t2:.1f} s", flush=True)
    out: dict = {"world": {"report_s": report_s, "dbsnp_motifs_s": t2 - t1, "fingerprint_s": t3 - t2}}

    # -- 1. run_no_gt_report ---------------------------------------------------------------------------------
    somatic = ["--signatures_file", rw["catalog_SBS96"], "--id_signatures_file", rw["catalog_ID83"],
               "--dbs_signatures_file", rw["catalog_DBS78"], "--signatures_metadata", rw["metadata"],
               "--control_vcfs", rw["control1"], rw["control2"]]
    jobs = []
    for b in ("gpu", "cpu"):
        (o / b).mkdir()
        jobs += [("run_no_gt_report", ["full_analysis", "--input_file", rw["case"], "--dbsnp", rw["dbsnp"],
                                       "--reference", rw["fasta"], "--callable_region", rw["callable"],
                                       "--output_prefix", str(o / b / "full"), "--backend", b],
                  f"full_analysis_{b}", None),
                 ("run_no_gt_report", ["variant_eval", "--input_file", rw["case"], "--dbsnp", rw["dbsnp"],
                                       "--reference", rw["fasta"], "--output_prefix", str(o / b / "eval"),
                                       "--backend", b], f"variant_eval_{b}", None),
                 ("run_no_gt_report", ["somatic_analysis", "--input_file", rw["case"], "--reference", rw["fasta"],
                                       *somatic, "--output_prefix", str(o / b / "case"), "--backend", b],
                  f"somatic_analysis_{b}", None)]
    runs = _tool_jobs(jobs, card, "REPORT", side_by_side=True)
    for name in ("full", "eval"):
        problems = rc.h5_problems(str(o / "gpu" / f"{name}.h5"), str(o / "cpu" / f"{name}.h5"))
        check(not problems, f"run_no_gt_report {name}: the card's h5 differs from the CPU's: {problems[:3]}")
    counts = rc.compare_somatic(str(o / "gpu" / "case"), str(o / "cpu" / "case"))
    full = str(o / "gpu" / "full.h5")
    for z in ("hete", "homo"):
        f = h5_utils.read_hdf(full, f"ins_del_{z}")
        check(np.array_equal(np.stack([f[c] for c in HMER_CLASSES]), planted["hmer"][z]),
              f"full_analysis: the {z} hmer table is not the planted one")
    id83 = h5_utils.read_hdf(full, "id83_channels")["size"]
    check(int(id83.sum()) == planted["n_indels"] and np.array_equal(id83[:24], planted["id_1bp"]),
          "full_analysis: the ID83 spectrum misses the planted indel classes")
    check(np.array_equal(h5_utils.read_hdf(full, "dbs78_channels")["size"], planted["dbs"]),
          "full_analysis: the DBS78 spectrum is not the planted doublets")
    check(int(h5_utils.read_hdf(full, "snp_motifs")["size"].sum()) == planted["n_snv_records"],
          "full_analysis: the SNP motifs miss planted SNV records")
    prefix = str(o / "gpu" / "case")
    for key, cs in (("case", planted), *((c, rw["planted"][c]) for c in ("control1", "control2"))):
        check(np.array_equal(_tsv_column(prefix + ".SBS96.all", key), cs["sbs"])
              and np.array_equal(_tsv_column(prefix + ".DBS78.all", key), cs["dbs"])
              and int(_tsv_column(prefix + ".ID83.all", key).sum()) == cs["n_indels"],
              f"somatic_analysis: the {key} matrices are not the planted counts")
    exp = h5_utils.read_hdf(prefix + ".h5", "signature_exposures")
    case = {g: f for c, n, g, f in zip(exp["catalog"], exp["sample"], exp["signature"], exp["fraction"])
            if c == "SBS96" and n == "case"}
    sigs, weights = synthetic_reports.CASE_MIXTURE
    recovered = {f"SBS{k + 1}": case.get(f"SBS{k + 1}", 0.0) for k in sigs}
    others = sum(v for k, v in case.items() if k not in recovered)
    check(all(abs(recovered[f"SBS{k + 1}"] - w) < 0.03 for k, w in zip(sigs, weights)) and others < 0.05,
          f"somatic_analysis: the planted mixture {dict(zip(sigs, weights))} not recovered: {case}")
    print(f"run_no_gt_report: card and CPU h5 frames equal (full_analysis, variant_eval), .all matrices byte-equal; "
          f"exposures {counts['rows']} rows, max relative error {counts['max_rel_err']:.3g} (bar "
          f"{rc.EXPOSURE_RTOL}), near the cut {counts['near_cut']}, order flips {counts['order_flips']}; the planted "
          f"hmer tables, {int(planted['dbs'].sum())} doublets, {planted['n_indels']} indels and SBS96 counts found; "
          f"the case's mixture {recovered} (others {others:.4f}) ({card})", flush=True)
    out["files"] = {"full_h5": full}
    out["no_gt"] = {"exposures": {k: v for k, v in counts.items() if k != "near_cut_groups"}, "mixture": recovered,
                    "others": others}

    # -- 2 and 3. joint_calling_report; substitution_error_rate_report -------------------------------------------
    jobs = [("joint_calling_report", ["--input_vcf", trio_vcf, "--dbsnp", trio_dbsnp, "--h5_output",
                                      str(o / b / "joint.h5"), "--html_output", str(o / b / "joint.html"),
                                      "--backend", b], f"joint_calling_report_{b}", None) for b in ("gpu", "cpu")]
    runs.update(_tool_jobs(jobs, card, "REPORT", side_by_side=True))
    sub = ["--h5_substitution_error_rate", motifs, "--h5_output", str(o / "sub.h5"), "--html_output",
           str(o / "sub.html")]
    runs.update(_tool_jobs([("substitution_error_rate_report", sub, "substitution_error_rate_report", None)], card,
                           "REPORT", served_by=()))
    problems = rc.h5_problems(str(o / "gpu" / "joint.h5"), str(o / "cpu" / "joint.h5"))
    check(not problems, f"joint_calling_report: the card's h5 differs from the CPU's: {problems[:3]}")
    check((o / "gpu" / "joint.html").read_text() == (o / "cpu" / "joint.html").read_text(),
          "joint_calling_report: the card's HTML differs from the CPU's")
    per_sample = h5_utils.read_hdf(str(o / "gpu" / "joint.h5"), "per_sample")
    check(len(per_sample) == 3, f"joint_calling_report: {len(per_sample)} per-sample rows")
    keys = h5_utils.list_keys(str(o / "sub.h5"))
    check(keys == ["asymmetry", "average_error_rate", "by_mut_type", "by_position", "folded_motifs"]
          and len(h5_utils.read_hdf(str(o / "sub.h5"), "folded_motifs")) == 96, f"substitution report: keys {keys}")
    print(f"joint_calling_report on {len(trio)} trio sites: card and CPU h5 and HTML equal; substitution report: "
          f"96 folded channels, keys {keys} ({card})", flush=True)

    # -- 4. fingerprinting ---------------------------------------------------------------------------------------
    jobs = []
    for b in ("gpu", "cpu"):
        jobs += [("quick_fingerprinting", ["--json_conf", confs["qf"], "--region_str", fw["region_str"], "--out_dir",
                                           str(o / b / "qf"), "--backend", b], f"quick_fingerprinting_{b}", None),
                 ("training_set_consistency_check", ["--training_json_conf", confs["tscc"], "--region_str",
                                                     fw["region_str"], "--out_dir", str(o / b / "tscc"), "--backend",
                                                     b], f"training_set_consistency_check_{b}", None)]
    fp = _tool_jobs(jobs, card, "FINGERPRINT", served_by=("bam_pileup", "cram_pileup"), raises=True,
                    side_by_side=True)
    runs.update(fp)
    for tool, key in (("quick_fingerprinting", "qf_errors"), ("training_set_consistency_check", "tscc_errors")):
        g, c = fp[f"{tool}_gpu"], fp[f"{tool}_cpu"]
        check(g["error"] == c["error"] and g["stdout"] == c["stdout"],
              f"{tool}: the card's lines differ from the CPU's")
        lines = g["error"].strip().split("\n")
        want = confs[key]
        check(len(lines) == len(want) and all(ln.startswith(start) for ln, (_, start) in zip(lines, want)),
              f"{tool}: errors {lines} against the expected {[s for _, s in want]}")
    for name in sorted(p.name for p in (o / "cpu" / "qf").iterdir()):
        check((o / "gpu" / "qf" / name).read_bytes() == (o / "cpu" / "qf" / name).read_bytes(),
              f"quick_fingerprinting: {name} differs between the card and the CPU")
    lo, hi = spec["fingerprint"]["region"]
    pile = {}
    for sample in ("A", "B", "C", "D"):
        t0 = time.perf_counter()
        got = pileup_caller.pileup_counts(fw["bam"][sample], "chr20", lo, hi)
        t1 = time.perf_counter()
        cram = pileup_caller.pileup_counts(fw["cram"][sample], "chr20", lo, hi, ref_path=fw["fasta"])
        t2 = time.perf_counter()
        os.environ["VCTPU_NO_NATIVE"] = "1"
        try:
            plain = pileup_caller.pileup_counts(fw["bam"][sample], "chr20", lo, hi)
        finally:
            del os.environ["VCTPU_NO_NATIVE"]
        t3 = time.perf_counter()
        check(np.array_equal(got, plain) and np.array_equal(got, cram),
              f"pileup of {sample}: the engine's BAM walk, its plain version and the CRAM decoder differ")
        pile[sample] = {"bases": int(got.sum()), "bam_s": t1 - t0, "cram_s": t2 - t1, "plain_s": t3 - t2}
    print("PILEUP_DETAIL " + json.dumps({"card": card, "region": fw["region_str"], "samples": pile}), flush=True)
    print(f"fingerprinting: card and CPU lines and error lists equal, the expected errors "
          f"({len(confs['qf_errors'])} quick, {len(confs['tscc_errors'])} training-set); the native BAM pileup equal "
          f"to its VCTPU_NO_NATIVE=1 walk and to the CRAM decoder for every sample ({card})", flush=True)
    out["pileup"] = pile
    out["walls"] = {k: v["seconds"] for k, v in runs.items()}
    out["figures_skipped"] = {k: v["figures_skipped"] for k, v in runs.items() if v["figures_skipped"]}
    return out


def _slice_runs(jobs: list[tuple], card: str) -> dict[str, dict]:
    """Runs of phase 15 ``(tool, argv, label, kind, env, served_by)``, all at
    once, each in a process of its own (:func:`_forked_all`, the counts set to
    0 just before each and read just after; independent runs only): exit 0; a
    card run served by the host engine's ``served_by`` entry points; a
    ``<kind>_DETAIL`` line (wall, stages, launches, peak RSS and card memory,
    how many ran side by side) and a ``HOST_ENGINE`` line a run."""
    runs = _forked_all({label: {"tool": tool, "argv": argv, "env": env or {}}
                        for tool, argv, label, _, env, _ in jobs}, _tool_child)
    for tool, argv, label, kind, _, served_by in jobs:
        run = runs[label]
        check(run["rc"] == 0, f"{label}: exit {run['rc']}")
        host = run["host"]
        if "gpu" in argv:
            missed = [k for k in served_by if host.get(k, {}).get("native", 0) == 0]
            check(not missed, f"{label}: the host engine did not serve {missed}")
        detail = {"run": label, "tool": tool, "card": card, "wall_s": run["seconds"], "stages": run["stages"],
                  "launches": run["launches"], "notes": run["notes"], "peak_rss_bytes": run["peak_rss_bytes"],
                  "peak_device_bytes": run["peak_device_bytes"], "side_by_side": len(jobs)}
        print(f"{kind}_DETAIL " + json.dumps(detail), flush=True)
        print("HOST_ENGINE " + json.dumps({"run": label, "calls": host}), flush=True)
    return runs


def _slice_run(tool: str, argv: list[str], label: str, card: str, kind: str, env: dict | None = None,
               served_by: tuple[str, ...] = ("vcf_parse",)) -> dict:
    """One run of phase 15 in a process of its own (:func:`_slice_runs`)."""
    return _slice_runs([(tool, argv, label, kind, env, served_by)], card)[label]


def _vcf_body(path: str) -> bytes:
    """A VCF's text without its ``##vctpu_*`` lines (a ``.gz`` inflated)."""
    data = Path(path).read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return _strip(data)


#: trees of phase 15's fits held card against CPU (the cut's srsnv fits, the LPR pair); the full-size srsnv fit
#: has the tool's default 100
CUT_TREES = 50


def phase_featuremaps(tmp: Path, card: str, worlds: dict | None = None) -> dict:
    """The single-read SNV and MRD chain, the LPR pair, ``calibrate_bridging_snvs``
    and the five methylation tools (phase 15), each run a process of its own,
    one after another, the counts set to 0 just before it and read just after;
    every card run against a CPU run of the port, scoring with one model
    pickle (the card's), so that each comparison holds the scoring and not
    the fit.

    1. ``FEATUREMAP_WORLD`` (``synthetic_featuremap``): ``srsnv_training`` on the
       TP and FP featuremaps (500,000 reads each) on the card: the held-out
       AUC over 0.9, ``gbt_hist`` launched trees x levels times, ``forest_wide``
       at least once; on their twentieth cuts, :data:`CUT_TREES` trees, the
       card's fit against the CPU torch program (``VCTPU_NATIVE_GBT=0``: equal
       trees, values to 1e-5, scores to 1e-6) and the native trainer's
       agreement (reported).
    2. ``srsnv_inference`` with the card's model on the cfDNA featuremap
       (1,000,000 reads) and its control on the card; its tenth cut (the
       first 100,000 reads) on the CPU and with ``VCTPU_FOREST_STRATEGY=gemm``
       (``forest_tree_step``) byte-equal to the head of the card's output.
    3. ``mrd_analysis`` of the scored cfDNA on the card and the CPU (equal
       frames; the planted tumor fraction inside the interval, detected) and
       of the scored control (not detected).
    4. The LPR pair (300,000 reads on 12,000 loci, a calls VCF of 104,000
       records; :data:`CUT_TREES` trees) on the card and the CPU: labeled
       parquets byte-equal; the filter with the card's model: scored parquets
       and VCFs byte-equal.
    5. ``BRIDGING_WORLD`` through ``calibrate_bridging_snvs``: card and CPU
       bytes equal, exactly the planted records rescued.
    6. ``METHYL_WORLD`` through the five methylation tools: card files equal
       to the CPU's (the CpG tool on the first shard, with its merged
       bedGraph, its strands merged; the concat on the first two shards; the
       others in full), the planted M-bias found by the inclusion bounds.
    ``FEATUREMAP_DETAIL``, ``MRD_DETAIL``, ``LPR_DETAIL``, ``BRIDGING_DETAIL``,
    ``METHYL_DETAIL`` and ``HOST_ENGINE`` lines."""
    from variantcalling_tpu_torch import synthetic_featuremap as sfm
    from variantcalling_tpu_torch.models import registry
    from variantcalling_tpu_torch.pipelines.srsnv.srsnv_training import build_training_frame
    from variantcalling_tpu_torch.utils import h5_utils

    spec = {"featuremap": sfm.FEATUREMAP_WORLD, "bridging": sfm.BRIDGING_WORLD, "methyl": sfm.METHYL_WORLD,
            **(worlds or {})}
    d = tmp / "featuremaps"
    o = d / "out"
    o.mkdir(parents=True)
    t0 = time.perf_counter()

    def timed(fn, *args, **kwargs):
        t = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - t

    with ThreadPoolExecutor(3) as pool:  # numpy's string operations run outside the GIL: the three worlds overlap
        jobs = [pool.submit(timed, sfm.write_featuremap_world, str(d / "fm"), **spec["featuremap"]),
                pool.submit(timed, sfm.write_bridging_world, str(d / "br"), **spec["bridging"]),
                pool.submit(timed, sfm.write_methyl_world, str(d / "me"), **spec["methyl"])]
        (fm, fm_s), (br, br_s), (me, me_s) = (j.result() for j in jobs)
    f = spec["featuremap"]
    print(f"worlds featuremaps: TP and FP of {f['n_tp']} and {f['n_fp']} reads, a cfDNA map of {f['n_cfdna']} reads "
          f"with {fm['n_tumor_reads']} tumor reads at {f['n_signature']} signature loci and its control, an LPR "
          f"map of {fm['lpr_reads']} reads on {f['n_lpr_loci']} loci ({fm_s:.1f} s); the bridging world "
          f"({br_s:.1f} s); the methylation world, {me['n_cpg_rows']} CpG rows ({me_s:.1f} s): written on three "
          f"threads in {time.perf_counter() - t0:.1f} s", flush=True)
    out: dict = {"world": {"featuremap_s": fm_s, "bridging_s": br_s, "methyl_s": me_s,
                           "all_s": time.perf_counter() - t0}}
    runs: dict = {}

    # -- 1. srsnv_training --------------------------------------------------------------------------------------
    depth, n_trees = 6, 100
    card_model = str(o / "srsnv_card.pkl")
    run = _slice_run("srsnv_training", ["--tp_featuremap", fm["tp"], "--fp_featuremap", fm["fp"], "--output_model",
                                        card_model, "--backend", "gpu"], "srsnv_training_gpu", card, "FEATUREMAP")
    runs["srsnv_training_gpu"] = run
    check(run["launches"]["gbt_hist"] == n_trees * depth and run["launches"]["forest_wide"] >= 1,
          f"srsnv_training: launches {run['launches']}")
    check(run["notes"].get("auc", 0) > 0.9, f"srsnv_training: held-out AUC {run['notes']}")
    fits = (("gpu", "gpu", {}), ("cpu_torch", "cpu", {"VCTPU_NATIVE_GBT": "0"}), ("cpu_native", "cpu", {}))
    runs.update(_slice_runs([("srsnv_training", [
        "--tp_featuremap", fm["tp_cut"], "--fp_featuremap", fm["fp_cut"], "--output_model",
        str(o / f"srsnv_cut_{label}.pkl"), "--n_trees", str(CUT_TREES), "--backend", backend],
        f"srsnv_training_cut_{label}", "FEATUREMAP", env, ("vcf_parse",)) for label, backend, env in fits], card))
    cut = {label: registry.load_model(str(o / f"srsnv_cut_{label}.pkl"), "srsnv_model") for label, _, _ in fits}
    x_cut, _, _ = build_training_frame(fm["tp_cut"], fm["fp_cut"], None, None)
    fit = _check_fit_bar(cut["gpu"], cut["cpu_torch"], "srsnv_training GPU vs CPU torch program", x_cut)
    print("TRAIN_FIT_DETAIL " + json.dumps({"run": "srsnv_training_cut", "rows": len(x_cut), "card": card, **fit}),
          flush=True)
    native = _native_agreement(cut["gpu"], cut["cpu_native"], x_cut)
    print("TRAIN_NATIVE_DETAIL " + json.dumps({"run": "srsnv_training_cut", "card": card, **native}), flush=True)
    out["srsnv_training"] = {"auc": run["notes"]["auc"], "fit": fit, "native": native}

    # -- 2. srsnv_inference ---------------------------------------------------------------------------------------
    scored = {name: str(o / f"scored_{name}.vcf") for name in ("cfdna", "control")}
    runs.update(_slice_runs([("srsnv_inference", ["--featuremap", fm[name], "--model", card_model,
                                                  "--output_featuremap", scored[name], "--backend", "gpu"],
                              f"srsnv_inference_{name}_gpu", "FEATUREMAP", None, ("vcf_parse",)) for name in scored],
                            card))
    for name in scored:
        run = runs[f"srsnv_inference_{name}_gpu"]
        check(run["launches"]["forest_wide"] >= 1 and run["launches"]["forest_tree_step"] == 0,
              f"srsnv_inference {name}: launches {run['launches']}")
    reads = f["n_cfdna"]
    wall = runs["srsnv_inference_cfdna_gpu"]["seconds"]
    print(f"srsnv_inference: {reads} reads on the card in {wall:.2f} s ({reads / wall:.0f} reads/s), "
          f"forest_wide launches {runs['srsnv_inference_cfdna_gpu']['launches']['forest_wide']} ({card})", flush=True)
    # the cut is the cfDNA map's first records, and each read is scored alone: the CPU's and gemm's outputs
    # of the cut are held to the head of the card's output of the whole map
    pins = (("cpu", "cpu", {}), ("gemm", "gpu", {"VCTPU_FOREST_STRATEGY": "gemm"}))
    runs.update(_slice_runs([("srsnv_inference", ["--featuremap", fm["cfdna_cut"], "--model", card_model,
                                                  "--output_featuremap", str(o / f"scored_cut_{label}.vcf"),
                                                  "--backend", backend],
                              f"srsnv_inference_cut_{label}", "FEATUREMAP", env, ("vcf_parse",))
                             for label, backend, env in pins], card))
    bodies = {label: _vcf_body(str(o / f"scored_cut_{label}.vcf")) for label, _, _ in pins}
    card_head = _vcf_body(scored["cfdna"])[:len(bodies["cpu"])]
    check(runs["srsnv_inference_cut_gemm"]["launches"]["forest_tree_step"] >= 1
          and runs["srsnv_inference_cut_gemm"]["launches"]["forest_wide"] == 0,
          f"srsnv_inference gemm: launches {runs['srsnv_inference_cut_gemm']['launches']}")
    check(card_head == bodies["cpu"] == bodies["gemm"] and card_head.endswith(b"\n"),
          "srsnv_inference: card, CPU and gemm bytes differ")

    # -- 3. mrd_analysis ------------------------------------------------------------------------------------------
    mrd = {}
    cases = (("gpu", "gpu", "cfdna"), ("cpu", "cpu", "cfdna"), ("control_gpu", "gpu", "control"))
    runs.update(_slice_runs([("mrd_analysis", [
        "--signature_vcf", fm["signature"], "--featuremap", scored[name], "--coverage_per_locus", str(f["depth"]),
        "--output_h5", str(o / f"mrd_{label}.h5"), "--backend", backend], f"mrd_{label}", "MRD", None, ("vcf_parse",))
        for label, backend, name in cases], card))
    for label, _, _ in cases:
        frame = h5_utils.read_hdf(str(o / f"mrd_{label}.h5"), "mrd_summary")
        mrd[label] = {c: frame[c][0].item() for c in frame.columns}
    check(mrd["gpu"] == mrd["cpu"], f"mrd_analysis: the card's frame {mrd['gpu']} differs from the CPU's {mrd['cpu']}")
    tf = f["tumor_fraction"]
    check(mrd["gpu"]["tf_ci_low"] <= tf <= mrd["gpu"]["tf_ci_high"] and mrd["gpu"]["mrd_detected"],
          f"mrd_analysis: the planted tumor fraction {tf} not found: {mrd['gpu']}")
    check(not mrd["control_gpu"]["mrd_detected"], f"mrd_analysis: MRD detected on the control: {mrd['control_gpu']}")
    print(f"mrd_analysis: card and CPU frames equal; {mrd['gpu']['n_supporting_reads']} supporting reads of "
          f"{fm['n_tumor_reads']} planted, tf {mrd['gpu']['tumor_fraction']:.3g} in [{mrd['gpu']['tf_ci_low']:.3g}, "
          f"{mrd['gpu']['tf_ci_high']:.3g}] (planted {tf}), detected; the control {mrd['control_gpu']} ({card})",
          flush=True)
    out["mrd"] = mrd
    out["files"] = {"mrd_h5": str(o / "mrd_gpu.h5"), "scored": scored["cfdna"], "signature": fm["signature"]}

    # -- 4. the LPR pair ------------------------------------------------------------------------------------------
    lpr_model = str(o / "lpr_gpu" / "lib_prep_model.npz")
    runs.update(_slice_runs([("train_lib_prep_recalibration_model", [
        "--out_dir", str(o / f"lpr_{backend}"), "--ref_fasta", fm["fasta"], "--featuremap_vcf", fm["lpr_featuremap"],
        "--calls_vcf", fm["lpr_calls"], "--balance_tp_fp", "--n_trees", str(CUT_TREES), "--backend", backend],
        f"lpr_train_{backend}", "LPR", None, ("vcf_parse",)) for backend in ("gpu", "cpu")], card))
    check(runs["lpr_train_gpu"]["launches"]["gbt_hist"] == CUT_TREES * depth,
          f"lpr train: launches {runs['lpr_train_gpu']['launches']}")
    runs.update(_slice_runs([("filter_vcf_with_lib_prep_recalibration_model", [
        "--out_dir", str(o / f"lpr_{backend}"), "--ref_fasta", fm["fasta"], "--lib_prep_model_file", lpr_model,
        "--calls_vcf", fm["lpr_calls"], "--featuremap_vcf", fm["lpr_featuremap"], "--backend", backend],
        f"lpr_filter_{backend}", "LPR", None, ("vcf_parse",)) for backend in ("gpu", "cpu")], card))
    check(runs["lpr_filter_gpu"]["launches"]["forest_wide"] >= 1, f"lpr filter: {runs['lpr_filter_gpu']['launches']}")
    for name in ("labeled_featuremap_training_set.parquet", "scored_alleles.parquet"):
        check((o / "lpr_gpu" / name).read_bytes() == (o / "lpr_cpu" / name).read_bytes(),
              f"LPR: {name} differs between the card and the CPU")
    check(len({_vcf_body(str(o / f"lpr_{b}" / "recalibrated.vcf.gz")) for b in ("gpu", "cpu")}) == 1,
          "LPR: the recalibrated VCF differs between the card and the CPU")

    # -- 5. calibrate_bridging_snvs -------------------------------------------------------------------------------
    runs.update(_slice_runs([("calibrate_bridging_snvs", [
        "--vcf", br["vcf"], "--reference", br["fasta"], "--output", str(o / f"bridging_{backend}.vcf.gz"), "--backend",
        backend], f"bridging_{backend}", "BRIDGING", None, ("vcf_parse",)) for backend in ("gpu", "cpu")], card))
    body = _vcf_body(str(o / "bridging_gpu.vcf.gz"))
    check(body == _vcf_body(str(o / "bridging_cpu.vcf.gz")), "calibrate_bridging_snvs: card and CPU bytes differ")
    before = {ln.split(b"\t")[1]: ln.split(b"\t")[6] for ln in _vcf_body(br["vcf"]).split(b"\n") if ln[:1] == b"c"}
    rescued = sorted(int(ln.split(b"\t")[1]) for ln in body.split(b"\n")
                     if ln[:1] == b"c" and ln.split(b"\t")[6] == b"PASS" and before[ln.split(b"\t")[1]] != b"PASS")
    check(rescued == sorted(br["rescue"].tolist()),
          f"calibrate_bridging_snvs: {len(rescued)} rescued against {len(br['rescue'])} planted")
    print(f"calibrate_bridging_snvs: card and CPU bytes equal; exactly the {len(rescued)} planted records rescued "
          f"({card})", flush=True)

    # -- 6. methylation ------------------------------------------------------------------------------------------
    methyl = []  # the eight runs at once: the shard's runs write the merged bedGraph
    for tool, src, name, bedgraph in (("process_merge_context", me["shards"][0], "cpg_shard", True),
                                      ("process_merge_context_no_cp_g", me["chh"], "chh", False),
                                      ("process_per_read", me["per_read"], "per_read", False)):
        for backend in ("gpu", "cpu"):
            label = f"{name}_{backend}"
            extra = ["--merged_bedgraph", str(o / f"{label}.bg")] if bedgraph else []
            methyl.append((tool, ["--input", src, "--output", str(o / f"{label}.h5"), *extra, "--backend", backend],
                           label, "METHYL", None, ()))
    methyl += [("concat_methyldackel_csvs", ["--inputs", *me["shards"][:2], "--output", str(o / "concat.csv")],
                "concat", "METHYL", None, ()),
               ("process_mbias", ["--input", me["mbias"], "--output", str(o / "mbias.h5")], "mbias", "METHYL", None,
                ())]
    runs.update(_slice_runs(methyl, card))
    for name in ("cpg_shard_{}.h5", "cpg_shard_{}.bg", "chh_{}.h5", "per_read_{}.h5"):
        check((o / name.format("gpu")).read_bytes() == (o / name.format("cpu")).read_bytes(),
              f"methylation: {name.format('*')} differs between the card and the CPU")
    bounds = h5_utils.read_hdf(str(o / "mbias.h5"), "inclusion_bounds")
    check(len(bounds) == 8 and (bounds["inclusion_start"] == me["bias_5p"] + 1).all()
          and (bounds["inclusion_end"] == 150 - me["bias_3p"]).all(),
          f"process_mbias: the planted bias not found: {bounds['inclusion_start']}, {bounds['inclusion_end']}")
    summary = h5_utils.read_hdf(str(o / "cpg_shard_gpu.h5"), "summary")
    with open(me["shards"][0], "rb") as fh:
        shard_rows = sum(1 for ln in fh if not ln.startswith(b"track"))
    check(int(summary["n_sites"][0]) < shard_rows, "process_merge_context: no strands merged")
    print(f"methylation: card files equal the CPU's; inclusion bounds {me['bias_5p'] + 1}-{150 - me['bias_3p']} "
          f"as planted; {int(summary['n_sites'][0])} merged CpG sites of the first shard's {shard_rows} rows "
          f"({card})", flush=True)
    kernel_free = [k for k, r in runs.items() if k.startswith(("mrd", "bridging", "cpg", "chh", "per_read", "concat",
                                                               "mbias")) and any(r["launches"].values())]
    check(not kernel_free, f"a kernel was launched on a path without one: {kernel_free}")
    out["walls"] = {k: v["seconds"] for k, v in runs.items()}
    out["launches"] = {k: v["launches"] for k, v in runs.items()}
    return out


#: the coverage request's depth vector: one million positions, 1 kb windows
SERVE_COVERAGE = dict(positions=1_000_000, window=1000, seed=2043)
#: the scoped fault that holds a request at its first chunk until the hangs are released
SERVE_HANG = "pipeline.stage_hang:1@120"


def _http(address: str, path: str, body=None, timeout: float = 300) -> tuple[int, object]:
    """One request to a daemon: (status, JSON payload), or the text of ``GET /v1/metrics``."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(address + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, raw.decode() if path == "/v1/metrics" else json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_for(cond, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"serve: {what} not reached in {timeout:.0f} s")
        time.sleep(0.02)


def _prom_values(text: str) -> dict[str, float]:
    """``name{labels}`` -> value of a Prometheus text exposition's samples."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, value = ln.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _serve_droppings(d: Path) -> list[str]:
    return sorted(p.name for p in d.iterdir() if ".partial" in p.name or p.name.endswith((".journal", ".quarantine")))


def phase_serve(tmp: Path, card: str, pipe: dict) -> dict:
    """16. The resident daemon (``serve``) on the card, on phase 4's forest
    pickle world (104,000 variants, chr20 scale):

    1. an in-process ``Server(port=0)`` on the card with
       ``VCTPU_SERVE_MAX_INFLIGHT=2`` and ``VCTPU_SERVE_QUEUE_DEPTH=2`` and an
       obs stream: ``/v1/warm`` of the model and the reference, a cold filter
       request alone, then 4 filter requests 2 at a time, each output equal
       outside ``##vctpu_*`` to phase 4's ``run(argv)`` GPU output; the
       ``forest_wide`` count around the 4 requests 4 times the cold one's, and
       each equal to the tables that reached the card (no plain version
       served); the model cache 1 miss and the rest hits, the predictor
       cache one build (``SERVE_DETAIL``: the cold request's seconds, the
       warm ones' median);
    2. a request scoped to ``VCTPU_FOREST_STRATEGY=gemm`` (``forest_tree_step``
       launched, the same bytes, its own predictor); ``/v1/score`` against a
       CPU ``score_table`` of the same table; ``/v1/coverage`` of a
       1,000,000-position depth vector against the plain numpy twin;
    3. isolation: a request poisoned at every chunk answers 500 beside a
       concurrent clean one with equal bytes; a request held past its
       deadline at its first chunk answers 504; with both slots held and 2
       requests queued, 2 more are shed with 503; no partial, journal or
       quarantine file is left; ``/v1/status`` and ``/v1/metrics`` count the
       requests sent; the drain closes the obs stream with status ``drain``;
    4. ``python -m variantcalling_tpu_torch serve --backend gpu --port 0`` as a
       subprocess: one filter request (equal bytes), then SIGTERM: exit 0, a
       status file that says ``drained`` with no leaked thread, no process
       left.
    """
    import signal
    import threading

    from variantcalling_tpu_torch import native
    from variantcalling_tpu_torch.io.fasta import FastaReader
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.models import forest_cuda, registry
    from variantcalling_tpu_torch.ops import coverage as cov
    from variantcalling_tpu_torch.pipelines import filter_variants as fv
    from variantcalling_tpu_torch.serve import Server
    from variantcalling_tpu_torch.utils import faults

    world = pipe["forest_pickle"]["world"]
    want = _strip(pipe["forest_pickle"]["wide_gpu"]["bytes"])
    d = tmp / "serve"
    d.mkdir()
    out: dict = {}
    def body(name: str, **kw) -> dict:
        return {"input": world["vcf"], "model": world["model"], "model_name": world["model_name"],
                "reference": world["fasta"], "output": str(d / name), **kw}

    env = {"VCTPU_SERVE_MAX_INFLIGHT": "2", "VCTPU_SERVE_QUEUE_DEPTH": "2"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    plog = logging.getLogger("variantcalling_tpu_torch")
    plog.setLevel(logging.INFO)
    obs_log = d / "serve.obs.jsonl"
    server = Server(port=0, device="gpu", obs_log=str(obs_log))
    server.start()
    sent: dict[str, int] = {}

    def count(endpoint: str, status: str, n: int = 1) -> None:
        sent[f"{endpoint}:{status}"] = sent.get(f"{endpoint}:{status}", 0) + n

    def launches() -> dict:
        return {"forest_wide": forest_cuda.LAUNCHES, "forest_tree_step": forest_cuda.TREE_STEP_LAUNCHES}

    def filtered(code: int, payload: dict, name: str, label: str, strategy: str = "cuda-wide") -> None:
        check(code == 200 and payload["status"] == "ok" and payload["engine"] == "cuda",
              f"serve {label}: {code} {payload}")
        data = (d / name).read_bytes()
        check(f"##vctpu_forest_strategy={strategy}".encode() in data and _strip(data) == want,
              f"serve {label}: the output differs from phase 4's GPU output outside ##vctpu_*")

    try:
        # -- 1. warm, the cold request, 4 requests 2 at a time --------------------------------------------
        code, payload = _http(server.address, "/v1/warm", {"model": world["model"], "model_name": world["model_name"],
                                                           "reference": world["fasta"]})
        check(code == 200 and payload["warmed"] == ["model", "reference"], f"serve warm: {code} {payload}")
        count("warm", "ok")
        builds0 = fv.predictor_cache_stats()["misses"]
        times = _RunLog()
        plog.addHandler(times)
        torch.cuda.synchronize()
        forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
        t0 = time.perf_counter()
        code, payload = _http(server.address, "/v1/filter", body("cold.vcf"))
        cold_s = time.perf_counter() - t0
        plog.removeHandler(times)
        filtered(code, payload, "cold.vcf", "cold")
        count("filter", "ok")
        per_run = launches()
        chunks = times.stream["chunks"] if times.stream else None
        check(per_run["forest_wide"] == len(times.tables) == chunks > 0 and per_run["forest_tree_step"] == 0,
              f"serve cold: launches {per_run} for {len(times.tables)} tables, {chunks} chunks")
        check(fv.predictor_cache_stats()["misses"] - builds0 == 1, "serve cold: not one predictor build")
        times = _RunLog()
        plog.addHandler(times)
        forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
        warm: dict = {}

        def call(i: int) -> None:
            t = time.perf_counter()
            warm[i] = (*_http(server.address, "/v1/filter", body(f"warm{i}.vcf")), time.perf_counter() - t)

        for pair in ((0, 1), (2, 3)):
            threads = [threading.Thread(target=call, args=(i,)) for i in pair]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        plog.removeHandler(times)
        for i in range(4):
            filtered(warm[i][0], warm[i][1], f"warm{i}.vcf", f"warm {i}")
        count("filter", "ok", 4)
        four = launches()
        check(four["forest_wide"] == 4 * per_run["forest_wide"] == len(times.tables) and four["forest_tree_step"] == 0,
              f"serve: 4 requests launched {four}, one run {per_run}, {len(times.tables)} tables")
        resident = server.status_payload()["resident"]
        check(resident["models"]["misses"] == 1 and resident["models"]["hits"] == 5
              and resident["genomes"]["misses"] == 1, f"serve: resident caches {resident}")
        check(fv.predictor_cache_stats()["misses"] - builds0 == 1, "serve: a warm request built a predictor")
        warm_s = [warm[i][2] for i in range(4)]
        detail = {"run": "filter", "card": card, "variants": WORLD["n_variants"], "cold_s": cold_s,
                  "warm_median_s": statistics.median(warm_s), "warm_s": warm_s, "chunks": chunks,
                  "launches_one_run": per_run, "launches_four": four, "resident": resident,
                  "predictor_builds": fv.predictor_cache_stats()["misses"] - builds0}
        print("SERVE_DETAIL " + json.dumps(detail), flush=True)
        out["filter"] = detail

        # -- 2. gemm scoped, score, coverage -------------------------------------------------------------
        forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
        t0 = time.perf_counter()
        code, payload = _http(server.address, "/v1/filter", body("gemm.vcf", knobs={"VCTPU_FOREST_STRATEGY": "gemm"}))
        gemm_s = time.perf_counter() - t0
        filtered(code, payload, "gemm.vcf", "gemm", "cuda-gemm")
        count("filter", "ok")
        gemm = launches()
        check(gemm["forest_tree_step"] == per_run["forest_wide"] and gemm["forest_wide"] == 0,
              f"serve gemm: launches {gemm}")
        check(fv.predictor_cache_stats()["misses"] - builds0 == 2, "serve gemm: not its own predictor build")
        forest_cuda.LAUNCHES = forest_cuda.TREE_STEP_LAUNCHES = 0
        t0 = time.perf_counter()
        code, score = _http(server.address, "/v1/score", {k: v for k, v in body("").items() if k != "output"})
        score_s = time.perf_counter() - t0
        count("score", "ok")
        check(code == 200 and launches()["forest_wide"] >= 1, f"serve score: {code} {score} {launches()}")
        model = registry.load_model(world["model"], world["model_name"])
        with FastaReader(world["fasta"]) as fasta:
            table = read_vcf(world["vcf"])
            cpu_score, cpu_filters = fv.FilterContext(model, fasta, torch.device("cpu")).score_table(table)
        cpu = {"n": len(table), "n_pass": int(np.sum(cpu_filters.codes == 0)),
               "score_mean": round(float(np.mean(cpu_score)), 6), "score_min": round(float(np.min(cpu_score)), 6),
               "score_max": round(float(np.max(cpu_score)), 6)}
        check(score["n"] == cpu["n"] == WORLD["n_variants"] and score["n_pass"] == cpu["n_pass"],
              f"serve score: {score} against the CPU's {cpu}")
        rng = np.random.default_rng(SERVE_COVERAGE["seed"])
        depth = rng.poisson(30, size=SERVE_COVERAGE["positions"]).astype(np.int32)
        depth[rng.integers(0, len(depth), size=10_000)] = 0
        native.reset_calls()
        t0 = time.perf_counter()
        code, coverage = _http(server.address, "/v1/coverage", {"depth": depth.tolist(),
                                                                "window": SERVE_COVERAGE["window"]})
        coverage_s = time.perf_counter() - t0
        count("coverage", "ok")
        means, hist = cov.coverage_stats_plain(depth, SERVE_COVERAGE["window"], cov.MAX_DEPTH_BIN, False)
        cdf = np.cumsum(hist.astype(np.float32), dtype=np.float32) / max(hist.sum(dtype=np.float32), 1.0)
        q = np.maximum(np.asarray([0.05, 0.5, 0.95], np.float32) * np.float32(1.0 - 1e-6), np.float32(1e-9))
        pct = np.argmax(cdf[None, :] >= q[:, None], axis=1)
        plain = {"windows": len(means), "mean": round(float(np.mean(means)), 6),
                 "percentiles": {"p5": int(pct[0]), "p50": int(pct[1]), "p95": int(pct[2])}}
        check(code == 200 and {k: coverage[k] for k in plain} == plain
              and native.CALLS["coverage_stats"]["native"] == 1,
              f"serve coverage: {coverage} against the plain twin's {plain}; {native.CALLS['coverage_stats']}")
        detail = {"run": "requests", "card": card, "gemm_s": gemm_s, "gemm_launches": gemm, "score_s": score_s,
                  "score": score, "cpu_score": cpu, "coverage_s": coverage_s,
                  "coverage_positions": SERVE_COVERAGE["positions"], "coverage": plain}
        print("SERVE_DETAIL " + json.dumps(detail), flush=True)
        out["requests"] = detail

        # -- 3. isolation: poison, deadline, shed; status and metrics; drain --------------------------------
        res: dict = {}

        def post(name: str, path: str, payload: dict) -> None:
            res[name] = _http(server.address, path, payload)

        threads = [threading.Thread(target=post, args=("poison", "/v1/filter", body(
            "poison.vcf", faults="pipeline.chunk:0", knobs={"VCTPU_CHUNK_RETRIES": "0"}))),
            threading.Thread(target=post, args=("clean", "/v1/filter", body("clean.vcf")))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(res["poison"][0] == 500 and res["poison"][1]["status"] == "error"
              and not (d / "poison.vcf").exists(), f"serve poison: {res['poison']}")
        filtered(*res["clean"], "clean.vcf", "clean beside the poisoned request")
        count("filter", "failed")
        count("filter", "ok")
        t0 = time.perf_counter()
        code, payload = _http(server.address, "/v1/filter", body("late.vcf", deadline_s=1.0,
                                                                 faults="pipeline.stage_hang:1@5"))
        deadline_s = time.perf_counter() - t0
        check(code == 504 and payload["status"] == "deadline" and not (d / "late.vcf").exists(),
              f"serve deadline: {code} {payload}")
        count("filter", "deadline")
        held = [threading.Thread(target=post, args=(f"held{i}", "/v1/filter", body(f"held{i}.vcf", faults=SERVE_HANG)))
                for i in range(2)]
        for t in held:
            t.start()
        _wait_for(lambda: server.admission.inflight == 2, "2 requests in flight")
        queued = [threading.Thread(target=post, args=(f"queued{i}", "/v1/coverage", {"depth": [1, 2, 3], "window": 2}))
                  for i in range(2)]
        for t in queued:
            t.start()
        _wait_for(lambda: server.admission.queued == 2, "2 requests queued")
        shed = [_http(server.address, "/v1/filter", body(f"shed{i}.vcf")) for i in range(2)]
        check(all(c == 503 and p["status"] == "shed" and p["reason"] == "queue_full" for c, p in shed),
              f"serve shed: {shed}")
        count("filter", "shed", 2)
        _wait_for(lambda: faults.cancel_hangs() or not any(t.is_alive() for t in held + queued), "the held requests")
        for i in range(2):
            filtered(*res[f"held{i}"], f"held{i}.vcf", f"held {i}")
            check(res[f"queued{i}"][0] == 200, f"serve queued {i}: {res[f'queued{i}']}")
        count("filter", "ok", 2)
        count("coverage", "ok", 2)
        left = _serve_droppings(d)
        check(not left, f"serve: files left behind {left}")
        code, status = _http(server.address, "/v1/status")
        check(code == 200 and status["in_flight"] == status["queued"] == 0 and status["device"].startswith("cuda")
              and status["engine"] == "cuda", f"serve status: {status}")
        code, text = _http(server.address, "/v1/metrics")
        values = _prom_values(text)
        counted = {}
        for key in sent:
            endpoint, outcome = key.split(":")
            counted[key] = values.get(f'vctpu_serve_requests_{outcome}_total{{endpoint="{endpoint}"}}')
        check(counted == sent, f"serve metrics: counted {counted}, sent {sent}")
        accepted = sum(n for k, n in sent.items() if not k.endswith(":shed"))
        check(values.get("vctpu_serve_requests_accepted_total") == accepted,
              f"serve metrics: {values.get('vctpu_serve_requests_accepted_total')} accepted, {accepted} admitted")
        server.drain("smoke")
        events = [json.loads(ln) for ln in obs_log.read_text().splitlines()]
        check(events[0]["kind"] == "manifest" and events[-1]["kind"] == "run_end" and events[-1]["status"] == "drain",
              f"serve obs stream: first {events[0]['kind']}, last {events[-1]}")
        detail = {"run": "isolation", "card": card, "deadline_request_s": deadline_s, "sent": sent,
                  "resident": status["resident"], "obs_events": len(events)}
        print("SERVE_DETAIL " + json.dumps(detail), flush=True)
        out["isolation"] = detail
    finally:
        faults.cancel_hangs()
        if not server.draining.is_set():
            server.drain("smoke")
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # -- 4. the daemon as a process of its own, drained by SIGTERM ------------------------------------
    ready, status_file = d / "ready.json", d / "status.json"
    root = Path(__file__).resolve().parent
    child_env = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_")}
    child_env["PYTHONPATH"] = str(root) + (os.pathsep + child_env["PYTHONPATH"] if child_env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    with open(d / "serve_process.log", "wb") as log_fh:
        argv = [sys.executable, "-m", "variantcalling_tpu_torch", "serve", "--backend", "gpu", "--port", "0",
                "--ready-file", str(ready), "--status-file", str(status_file), "--obs-log",
                str(d / "serve_process.obs.jsonl")]
        proc = subprocess.Popen(argv, cwd=str(root), env=child_env, stdout=log_fh, stderr=subprocess.STDOUT)
        try:
            _wait_for(lambda: proc.poll() is not None or ready.exists(), "the daemon's ready file")
            check(proc.poll() is None, f"serve process: exited {proc.returncode} before listening")
            start_s = time.perf_counter() - t0
            address = json.loads(ready.read_text())["address"]
            t0 = time.perf_counter()
            code, payload = _http(address, "/v1/filter", body("process.vcf"))
            request_s = time.perf_counter() - t0
            filtered(code, payload, "process.vcf", "process")
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            drain_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    report = json.loads(status_file.read_text())
    check(rc == 0 and report["status"] == "drained" and report["reason"] == "sigterm" and report["leaked"] == []
          and report["counters"].get("serve.requests_ok") == 1, f"serve process: exit {rc}, report {report}")
    children = _descendants()
    check(not any("variantcalling_tpu_torch serve" in c for c in children.values()),
          f"serve process: still running {children}")
    detail = {"run": "process", "card": card, "start_s": start_s, "request_s": request_s, "drain_s": drain_s,
              "exit": rc, "report": report}
    print("SERVE_DETAIL " + json.dumps(detail), flush=True)
    out["process"] = detail
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

#: phase 17's train_dan run: steps, each logged (one ``step`` event each)
OBS_DAN_STEPS = 50


def _obs_tools(log: str, out_dir: Path) -> tuple[dict, dict, float]:
    """The ``obs`` tool's subcommands over ``log`` through ``obs.cli.run`` in
    this process, their files under ``out_dir``: (exit code by subcommand,
    the JSON roll-ups of ``bottleneck`` and ``critical-path``, seconds)."""
    from variantcalling_tpu_torch.obs import cli as obs_cli

    t0 = time.perf_counter()
    rcs, parsed = {}, {}
    for name, argv in (("summary", ["summary", log]), ("bottleneck", ["bottleneck", log, "--json"]),
                       ("critical-path", ["critical-path", log, "--json"]),
                       ("flame", ["flame", log, "-o", str(out_dir / "run.speedscope.json"), "--collapsed",
                                  str(out_dir / "run.collapsed.txt")]),
                       ("cpuledger", ["cpuledger", log]), ("prom", ["prom", log, "-o", str(out_dir / "run.prom")]),
                       ("export", ["export", log, "-o", str(out_dir / "run.trace.json")])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs[name] = obs_cli.run(argv)
        if argv[-1] == "--json" and rcs[name] == 0:
            parsed[name] = json.loads(buf.getvalue())
    return rcs, parsed, time.perf_counter() - t0


def _chunk_traces(events: list[dict]) -> dict[str, list[str]]:
    """trace id -> its span names in stream order, each span parented on the one before it."""
    spans: dict[str, list[dict]] = {}
    for e in events:
        if e["kind"] == "trace":
            spans.setdefault(e["trace_id"], []).append(e)
    for tid, chain in spans.items():
        check("parents" not in chain[0] and all(c["parents"] == [p["span_id"]] for p, c in zip(chain, chain[1:])),
              f"trace {tid} is not a chain from its root")
    return {tid: [e["name"] for e in chain] for tid, chain in spans.items()}


def phase_telemetry(tmp: Path, card: str, stream: dict, pipe: dict, files: dict, sec: dict) -> dict:
    """Phase 17: the run telemetry on the main path, the device trace, and the somatic composites.

    1. Phase 8's 5 M-variant world streamed again (a forked process) with
       ``VCTPU_OBS=1`` (the stage profiler on by default) and
       ``VCTPU_OBS_CPUPROF=1``, right after an obs-off run of the same: the
       output's hash equal to that run's and phase 8's default run's, every
       line of the stream valid under the port's schema, one complete trace
       a chunk (ingest to writeback, a chain), as many as the run's chunks, the ``cost_analysis`` event naming ``cuda-wide``;
       ``obs summary``, ``bottleneck``, ``critical-path``, ``flame``,
       ``cpuledger``, ``prom`` and ``export`` exit 0 on it. An
       ``OBS_DETAIL`` line: both walls and the overhead, the dominant p95
       edge, the limiting stage.
    2. The 104,000-variant forest pickle world streamed in 1 MiB chunks with
       ``VCTPU_OBS_JAXPROF=1``: the bytes of phase 8's clean run, the device
       trace (``torch.profiler``'s Chrome trace) written, its
       ``forest_wide`` kernel events as many as the launch counter counted.
       A ``DEVICE_BUSY`` line: the card's busy share of the run's wall, from
       the union of the kernel intervals.
    3. ``train_dan`` on phase 9's 200,000 rows, ``OBS_DAN_STEPS`` steps each
       logged, obs on (a forked process): a ``step`` event a step.
    4. ``run_somatic_comparison_and_graphs`` on phase 12's held-out callset
       and truth, card and CPU (forked processes), and ``detailed_var_report``
       over phase 12's annotated comparison of the card, card and CPU (the
       four processes side by side): every h5 frame equal, the BED and CSVs
       byte-equal, the HTML equal without its images; the figures skipped
       counted (``SOMATIC_DETAIL`` lines).
    5. ``knobs --json`` exits 0 (the ``obs`` tool ran in 1).
    """
    from tests.torch_report_compare import strip_images
    from variantcalling_tpu_torch import knobs, obs
    from variantcalling_tpu_torch.obs import critical, export, schema
    from variantcalling_tpu_torch.obs import profile as obs_profile

    out: dict = {}
    # -- 1. the obs-on twin of phase 8's 5 M default run ---------------------------------
    # an obs-off run right before the obs-on one, so that the pair's walls compare (phase 8's default
    # run, minutes earlier, gives the bytes)
    base = _stream_subprocess(stream["world_5m"], tmp / "stream_5m_obs_off.vcf", card, "stream_5m_obs_off", {})
    (tmp / "stream_5m_obs_off.vcf").unlink()
    target = tmp / "stream_5m_obs.vcf"
    run = _stream_subprocess(stream["world_5m"], target, card, "stream_5m_obs",
                             {"VCTPU_OBS": "1", "VCTPU_OBS_CPUPROF": "1"})
    target.unlink()
    check(run["sha256"] == base["sha256"] == stream["stream_5m"]["default"]["sha256"],
          "the obs-on 5 M run's output differs from the obs-off runs'")
    log = str(target) + ".obs.jsonl"
    lines = Path(log).read_text().splitlines()
    errors = schema.validate_lines(lines)
    check(not errors, f"obs stream: {len(errors)} schema errors, first {errors[:3]}")
    events = export.read_run(log)
    traces = _chunk_traces(events)
    committed = [e for e in events if e["kind"] == "journal" and e["name"] == "committed"]
    check(len(traces) == run["chunks"] == committed[-1]["chunks"]
          and all(t[0] == "ingest" and t[-1] == "writeback" for t in traces.values()),
          f"obs stream: {len(traces)} traces for {run['chunks']} chunks, shapes {set(map(tuple, traces.values()))}")
    cost = [e for e in events if e["kind"] == "profile" and e["name"] == "cost_analysis"]
    check(len(cost) == 1 and cost[0]["strategy"] == "cuda-wide", f"cost_analysis events: {cost}")
    rcs, parsed, tools_s = _obs_tools(log, tmp)
    check(all(rc == 0 for rc in rcs.values()), f"obs tool exit codes: {rcs}")
    cp, bott = parsed["critical-path"], parsed["bottleneck"]
    check(cp["chunks"] == run["chunks"], f"critical-path counts {cp['chunks']} chunks of {run['chunks']}")
    detail = {"run": "stream_5m", "card": card, "chunks": run["chunks"], "wall_off_s": base["wall_s"],
              "wall_on_s": run["wall_s"], "overhead_pct": 100.0 * (run["wall_s"] / base["wall_s"] - 1.0),
              "events": len(events), "log_bytes": os.path.getsize(log),
              "dominant_p95_edge": cp["dominant_p95_edge"], "p95_edge_s": cp["p95_edges"].get(cp["dominant_p95_edge"]),
              "latency_p50_s": cp["latency_p50_s"], "latency_p95_s": cp["latency_p95_s"],
              "limiting_stage": bott.get("limiting_stage"), "cost_analysis": cost[0], "obs_tools_s": tools_s}
    print("OBS_DETAIL " + json.dumps(detail), flush=True)
    out["obs_5m"] = detail

    # -- 2. the device trace on the 104,000-variant world -----------------------------------------
    w = pipe["forest_pickle"]["world"]
    target = tmp / "stream_104k_devtrace.vcf"
    env = {"VCTPU_STREAM": "1", "VCTPU_STREAM_CHUNK_BYTES": str(STREAM_SMALL_CHUNK), "VCTPU_OBS": "1",
           "VCTPU_OBS_JAXPROF": "1"}
    dev = _drive(w, target, "gpu", card, "stream_104k_devtrace", env=env)
    check(hashlib.sha256(dev["bytes"]).hexdigest() == stream["stream_104k"]["clean_sha256"],
          "the device-traced run's output differs from the clean run's")
    log = str(target) + ".obs.jsonl"
    trace = Path(log + ".jaxprof") / obs.DEVICE_TRACE_FILE
    check(trace.exists(), f"no device trace at {trace}")
    summary = obs_profile.device_trace_summary(str(trace))
    launches = dev["launches"]["forest_wide"]
    # the kernel's events by its symbol (mangled or demangled, whichever the profiler records)
    wide_events = sum(k for name, k in summary["kernels"].items() if "forest_wide_margin_kernel" in name)
    check(launches > 0 and wide_events == launches,
          f"device trace: {wide_events} forest_wide kernel events, {launches} launches counted; kernels "
          f"{dict(sorted(summary['kernels'].items(), key=lambda kv: -kv[1])[:12])}")
    run_end = [e for e in export.read_run(log) if e["kind"] == "run_end"][-1]
    busy = {"run": "stream_104k", "card": card, "chunks": dev["stream"]["chunks"], "wall_s": run_end["dur"],
            "busy_s": summary["busy_s"], "busy_share": summary["busy_s"] / run_end["dur"],
            "kernel_s": summary["kernel_s"], "kernel_events": summary["kernel_events"],
            "forest_wide_events": wide_events, "forest_wide_launches": launches,
            "kernels": dict(sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:12]),
            "trace_bytes": trace.stat().st_size}
    print("DEVICE_BUSY " + json.dumps(busy), flush=True)
    out["device_busy"] = busy

    # -- 3. train_dan with obs on -------------------------------------------------------------------
    label = "dan_obs"
    argv = ["--input_file", files["small"], "--n_steps", str(OBS_DAN_STEPS), "--log_every", "1", "--backend", "gpu",
            "--output_file_prefix", str(tmp / label)]
    dan_run = _forked({"argv": argv, "env": {"VCTPU_OBS": "1"}}, label, _dan_child)
    check(dan_run["rc"] == 0 and not any(dan_run["launches"].values()), f"{label}: exit {dan_run['rc']}, "
          f"launches {dan_run['launches']}")
    events = export.read_run(str(tmp / f"{label}.obs.jsonl"))
    steps = [e for e in events if e["kind"] == "train" and e["name"] == "step"]
    hist = [e for e in events if e["kind"] == "metrics"][-1]["histograms"]["train.step_s"]
    check([e["step"] for e in steps] == list(range(OBS_DAN_STEPS)) and hist["count"] == OBS_DAN_STEPS,
          f"{label}: {len(steps)} step events, {hist['count']} step times for {OBS_DAN_STEPS} steps")
    print(f"train_dan with obs: {len(steps)} step events for {OBS_DAN_STEPS} steps, loss {steps[0]['loss']:.4f} -> "
          f"{steps[-1]['loss']:.4f}, step p50 {hist['p50']:.4g} s ({card})", flush=True)
    out["dan_obs"] = {"steps": len(steps), "wall_s": dan_run["seconds"]}

    # -- 4. the somatic composites, card against CPU ------------------------------------------------
    p = sec["paths"]
    d = tmp / "somatic"
    d.mkdir()
    jobs = {}
    for backend in ("gpu", "cpu"):
        argv = ["--somatic_vcf", p["heldout"], "--gt_vcf", p["truth"], "--highconf_bed", p["hcr"], "--reference",
                p["fasta"], "--output_folder", str(d / backend), "--call_sample_name", "sm1", "--truth_sample_name",
                "HG001", "--make_plots", "--backend", backend]
        jobs[f"somatic_{backend}"] = {"tool": "run_somatic_comparison_and_graphs", "argv": argv, "env": {}}
        argv = ["--h5_concordance_file", sec["comparison"]["gpu_h5"], "--h5_output", str(d / f"det_{backend}.h5"),
                "--csv_output", str(d / f"det_{backend}.csv"), "--html_output", str(d / f"det_{backend}.html"),
                "--exome_column_name", "exome", "--backend", backend]
        jobs[f"detailed_{backend}"] = {"tool": "detailed_var_report", "argv": argv, "env": {}}
    runs = _forked_all(jobs, _tool_child)  # the four side by side: no wall here is a headline
    for label, r in runs.items():
        check(r["rc"] == 0, f"{label}: exit {r['rc']}")
        print("SOMATIC_DETAIL " + json.dumps({"run": label, "card": card, "wall_s": r["seconds"], "stages": r["stages"],
                                              "launches": r["launches"], "figures_skipped": r["figures_skipped"],
                                              "peak_rss_bytes": r["peak_rss_bytes"],
                                              "peak_device_bytes": r["peak_device_bytes"]}), flush=True)
    rows = sum(_same_frames(str(d / "gpu" / f), str(d / "cpu" / f), f"somatic {f}")
               for f in ("somatic_comparison.h5", "somatic_eval.h5"))
    for f in ("somatic_comparison.intervals.bed", "somatic_eval.stats.csv", "somatic_eval.thresholds.csv"):
        check((d / "gpu" / f).read_bytes() == (d / "cpu" / f).read_bytes(), f"somatic: {f} differs")
    det_rows = _same_frames(str(d / "det_gpu.h5"), str(d / "det_cpu.h5"), "detailed_var_report")
    check((d / "det_gpu.csv").read_bytes() == (d / "det_cpu.csv").read_bytes(), "detailed_var_report: CSVs differ")
    html = [strip_images((d / f"det_{b}.html").read_text())[0] for b in ("gpu", "cpu")]
    check(html[0] == html[1], "detailed_var_report: the HTML differs")
    skipped = {k: r["figures_skipped"] for k, r in runs.items()}
    print(f"somatic composites: card and CPU equal ({rows} comparison and evaluation rows, {det_rows} detailed "
          f"rows, BED, CSVs and HTML without images); figures_skipped {skipped}; forest_wide launches "
          f"{[r['launches']['forest_wide'] for r in runs.values()]} ({card})", flush=True)
    out["somatic"] = {"figures_skipped": skipped, "launches": {k: r["launches"] for k, r in runs.items()}}

    # -- 5. the knobs tool ---------------------------------------------------------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = knobs.run(["--json"])
    check(rc == 0 and len(json.loads(buf.getvalue())) == len(knobs.REGISTRY), f"knobs --json: exit {rc}")
    print(f"knobs --json: {len(knobs.REGISTRY)} knobs; obs tools {sorted(rcs)} exit 0 in {tools_s:.2f} s", flush=True)
    return out


#: phase 18's seeded inputs: the tumor/normal pair planted on phase 12's truth, the two QC samples
SOMATIC_GT_PAIR = dict(seed=2045, n_somatic=2_000, n_mismatch=500)
QC_WORLD = dict(seed=2046, samples=("s1", "s2"), hist_rows=1_000)
#: phase 18's MRD queries (the signature VCF carries no INFO: its filter reads the position)
MRD_READ_QUERY = "rq > 0.7 and X_EDIST <= 4"
MRD_SIGNATURE_QUERY = "pos % 3 != 0"


def _chain_runs(jobs: dict[str, tuple[str, list[str], bool]], d: Path, card: str) -> dict[str, dict]:
    """Each ``label: (tool, argv, reads_vcf)`` twice, in ``d/a`` and ``d/b``
    (relative outputs), all at once, each in a forked process: exit 0, no
    kernel launched, a VCF read by the host engine's scan and no plain
    version; a ``REPORT_CHAIN_DETAIL`` line a run (wall, peak RSS, figures
    skipped). The runs of ``a`` by label."""
    specs = {}
    for label, (tool, argv, _) in jobs.items():
        for copy in ("a", "b"):
            (d / copy).mkdir(parents=True, exist_ok=True)
            specs[f"{label}/{copy}"] = {"tool": tool, "argv": argv, "env": {}, "cwd": str(d / copy)}
    runs = _forked_all(specs, _tool_child)
    for key, run in runs.items():
        label = key.split("/")[0]
        tool, _, reads_vcf = jobs[label]
        check(run["rc"] == 0, f"{key}: exit {run['rc']}")
        check(not any(run["launches"].values()), f"{key}: a kernel was launched ({run['launches']})")
        plain = [k for k, v in run["host"].items() if v["plain"]]
        check(not plain and (not reads_vcf or run["host"].get("vcf_parse", {}).get("native", 0) >= 1),
              f"{key}: the host engine did not serve its VCF reads; plain: {plain}")
        print("REPORT_CHAIN_DETAIL " + json.dumps({
            "run": key, "tool": tool, "card": card, "wall_s": run["seconds"], "peak_rss_bytes": run["peak_rss_bytes"],
            "figures_skipped": run["figures_skipped"], "side_by_side": len(specs)}), flush=True)
    return {label: runs[f"{label}/a"] for label in jobs}


def _same_trees(a: Path, b: Path, label: str) -> int:
    """The files under ``a`` and ``b``: the same names and bytes; returns how many."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    check(names == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file()),
          f"{label}: the two runs wrote other files")
    for name in names:
        check((a / name).read_bytes() == (b / name).read_bytes(), f"{label}: the two runs' {name} differ")
    return len(names)


def phase_report_chain(tmp: Path, card: str, sec: dict, reports: dict, feat: dict) -> dict:
    """The report chain and the QC metrics tools (phase 18), on the files the
    earlier phases wrote; each tool run twice, in two directories, all runs of
    a step side by side in forked processes (:func:`_chain_runs`), the two
    runs' files byte-equal.

    1. ``create_var_report --verbosity 2`` on phase 12's card comparison h5
       (its exome track): the all-data table's counts (``# pos``, ``# neg``,
       ``fn`` over SNP and Indel) equal the comparison frame's own TP, FP and
       FN counts;
    2. ``create_somatic_gt_file`` on a tumor and normal pair planted on phase
       12's truth (``synthetic_reports.write_somatic_gt_pair``): the planted
       somatic records and mismatches come back exactly, no planted
       problematic position is left in the BED; the GT VCF and BED then feed
       one ``run_somatic_comparison_and_graphs --backend gpu`` against phase
       12's held-out callset;
    3. ``report_wo_gt`` on phase 14's ``full_analysis`` h5;
    4. ``mrd_data_analysis`` on phase 15's card summary, scored cfDNA map and
       signature, with :data:`MRD_READ_QUERY` and :data:`MRD_SIGNATURE_QUERY`:
       the filtered tables equal a numpy selection written here;
    5. the six QC tools chained on two seeded samples
       (``synthetic_reports.write_qc_world``): ``import_metrics``,
       ``collect_existing_metrics``, ``sorter_to_h5``,
       ``sorter_stats_to_mean_coverage``, ``create_qc_report``, then
       ``convert_h5_to_json`` of its h5, which holds every key of it.

    Where matplotlib does not import (the card's machine) every figure is
    skipped and counted. ``REPORT_CHAIN_DETAIL`` lines."""
    from tests import torch_report_compare as rc
    from variantcalling_tpu_torch import synthetic_reports
    from variantcalling_tpu_torch.io.bed import read_bed
    from variantcalling_tpu_torch.io.vcf import read_vcf
    from variantcalling_tpu_torch.utils import h5_utils
    from variantcalling_tpu_torch.utils.frame_ops import json_double_text

    d = tmp / "report_chain"
    d.mkdir()
    out: dict = {}
    paths = sec["paths"]
    t0 = time.perf_counter()
    pair = synthetic_reports.write_somatic_gt_pair(str(d / "pair"), truth_vcf=paths["truth"], fasta=paths["fasta"],
                                                   **SOMATIC_GT_PAIR)
    qc = synthetic_reports.write_qc_world(str(d / "qc"), **QC_WORLD)
    print(f"world report chain: a tumor GT of {pair['n_planted']} planted somatic SNVs and "
          f"{len(pair['problematic'])} mismatches over phase 12's truth, QC metrics of {len(qc['samples'])} samples, "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    cmp_h5 = sec["comparison"]["gpu_h5"]

    # -- 1-4. the reports, side by side -----------------------------------------------------------------------------
    first = _chain_runs({
        "create_var_report": ("create_var_report", [
            "--h5_concordance_file", cmp_h5, "--exome_column_name", "exome", "--verbosity", "2", "--h5_output",
            "var.h5", "--html_output", "var.html"], False),
        "create_somatic_gt_file": ("create_somatic_gt_file", [
            "--gt_tumor", pair["tumor"], "--gt_normal", pair["normal"], "--gt_tumor_name", "T1", "--gt_normal_name",
            "N1", "--cmp_intervals", paths["hcr"], "--output_folder", "gt"], True),
        "report_wo_gt": ("report_wo_gt", ["--input_h5", reports["full_h5"], "--html_output", "wo_gt.html",
                                          "--sample_name", "case"], False),
        "mrd_data_analysis": ("mrd_data_analysis", [
            "--mrd_summary_h5", feat["mrd_h5"], "--featuremap", feat["scored"], "--signature_vcf", feat["signature"],
            "--read_filter_query", MRD_READ_QUERY, "--signature_filter_query", MRD_SIGNATURE_QUERY, "--h5_output",
            "mrd.h5", "--html_output", "mrd.html"], True),
        "import_metrics_s1": ("import_metrics", ["--metrics_prefix", qc["prefix"]["s1"], "--output_h5",
                                                 "s1.metrics.h5"], False),
        "import_metrics_s2": ("import_metrics", ["--metrics_prefix", qc["prefix"]["s2"], "--output_h5",
                                                 "s2.metrics.h5"], False),
        "collect_existing_metrics": ("collect_existing_metrics", [
            "--metric_files", *qc["files"]["s1"], qc["sorter_csv"], qc["frames_h5"], "--output_h5", "col.h5"], False),
        "sorter_to_h5": ("sorter_to_h5", ["--input_csv_file", qc["sorter_csv"], "--input_json_file", qc["sorter_json"],
                                          "--metric_mapping_file", qc["mapping_csv"], "--output_file", "sorter.h5"],
                         False),
        "sorter_stats_to_mean_coverage": ("sorter_stats_to_mean_coverage", [
            "--input_sorter_stats_json", qc["sorter_json"], "--output_file", "cov.txt"], False),
    }, d / "runs1", card)
    second = _chain_runs({"create_qc_report": ("create_qc_report", [
        "--samples", *qc["samples"], "--metrics_h5",
        *[str(d / "runs1" / "a" / f"{s}.metrics.h5") for s in qc["samples"]], "--run_id", "chip", "--h5_output",
        "qc.h5", "--html_output", "qc.html"], False)}, d / "runs2", card)
    third = _chain_runs({"convert_h5_to_json": ("convert_h5_to_json", [
        "--input_h5", str(d / "runs2" / "a" / "qc.h5"), "--output_json", "qc.json"], False)}, d / "runs3", card)
    runs = {**first, **second, **third}
    n_files = sum(_same_trees(d / f"runs{k}" / "a", d / f"runs{k}" / "b", f"report chain step {k}") for k in (1, 2, 3))
    a = d / "runs1" / "a"

    # 1. the report's counts against the comparison's own
    frame = h5_utils.read_hdf(cmp_h5, "all", skip_keys=h5_utils.CONCORDANCE_SKIP_KEYS)
    call, base = np.asarray(frame["call"], dtype=object), np.asarray(frame["base"], dtype=object)
    n_tp = int((call == "TP").sum())
    n_fp = int(((call == "FP") | (call == "FP_CA")).sum())
    n_fn = int(((base == "FN") | (base == "FN_CA")).sum())
    tab = h5_utils.read_hdf(str(a / "var.h5"), "all_data")
    rows = [list(tab.index).index(c) for c in ("SNP", "Indel")]
    pos, neg, fn = (int(np.asarray(tab[f"whole genome|{c}"])[rows].sum()) for c in ("# pos", "# neg", "fn"))
    check((pos - fn, neg, fn) == (n_tp, n_fp, n_fn),
          f"create_var_report: initial tp/fp/fn {(pos - fn, neg, fn)} != the comparison's {(n_tp, n_fp, n_fn)}")
    out["var_report"] = {"keys": len(h5_utils.list_keys(str(a / "var.h5"))), "initial_tp": n_tp,
                         "initial_fp": n_fp, "initial_fn": n_fn}

    # 2. the somatic truth: the plant back, the problematic positions out, then a comparison on the card
    gt_vcf = a / "gt" / "OUTPUT_gt_T1_minus_N1.vcf.gz"
    body = [ln for ln in gzip.decompress(gt_vcf.read_bytes()).decode().splitlines() if not ln.startswith("#")]
    check(body == pair["somatic"], f"create_somatic_gt_file: {len(body)} records, {len(pair['somatic'])} planted")
    bed_path = a / "gt" / "OUTPUT_hcr_no_problematic_positions.bed"
    bed = read_bed(str(bed_path))
    left = [(c, s, e) for c, s, e in pair["problematic"]
            if bed.contains(np.array([c] * (e - s), dtype=object), np.arange(s, e)).any()]
    check(not left, f"create_somatic_gt_file: {len(left)} planted problematic positions left in the BED")
    som = _forked({"tool": "run_somatic_comparison_and_graphs", "env": {}, "argv": [
        "--somatic_vcf", paths["heldout"], "--gt_vcf", str(gt_vcf), "--highconf_bed", str(bed_path), "--reference",
        paths["fasta"], "--output_folder", str(d / "somatic"), "--call_sample_name", "sm1", "--truth_sample_name",
        "HG001", "--backend", "gpu"]}, "somatic_on_gt", _tool_child)
    check(som["rc"] == 0 and not any(som["launches"].values()),
          f"run_somatic_comparison_and_graphs on the new truth: exit {som['rc']}, launches {som['launches']}")
    cmp_rows = sum(len(h5_utils.read_hdf(str(d / "somatic" / "somatic_comparison.h5"), k))
                   for k in h5_utils.list_keys(str(d / "somatic" / "somatic_comparison.h5")))
    print("REPORT_CHAIN_DETAIL " + json.dumps({
        "run": "somatic_on_gt", "tool": "run_somatic_comparison_and_graphs", "card": card, "wall_s": som["seconds"],
        "peak_rss_bytes": som["peak_rss_bytes"], "peak_device_bytes": som["peak_device_bytes"],
        "figures_skipped": som["figures_skipped"], "side_by_side": 1}), flush=True)
    out["somatic_gt"] = {"records": len(body), "problematic": len(pair["problematic"]),
                         "bed_bp": int((bed.end - bed.start).sum()), "comparison_rows": cmp_rows}

    # 4. the MRD tables against a selection written apart
    fm, sig = read_vcf(feat["scored"]), read_vcf(feat["signature"])
    sig_pos = np.asarray(sig.pos, dtype=np.int64)
    loci = set(zip(np.asarray(sig.chrom)[sig_pos % 3 != 0].tolist(), sig_pos[sig_pos % 3 != 0].tolist()))
    passing = (fm.info_field("rq") > 0.7) & (fm.info_field("X_EDIST") <= 4)
    chrom, fpos = np.asarray(fm.chrom), np.asarray(fm.pos, dtype=np.int64)
    on = np.array([(c, p) in loci for c, p in zip(chrom.tolist(), fpos.tolist())], dtype=bool)
    for tag, keep in (("filt_signature_filt_featuremap", on & passing), ("filt_signature_unfilt_featuremap", on)):
        support: dict = {}
        for locus in zip(chrom[keep].tolist(), fpos[keep].tolist()):
            support[locus] = support.get(locus, 0) + 1
        per = h5_utils.read_hdf(str(a / "mrd.h5"), f"df_supporting_reads_per_locus_{tag}")
        got = dict(zip(zip(np.asarray(per["chrom"]).tolist(), np.asarray(per["pos"]).tolist()),
                       np.asarray(per["n_supporting_reads"]).tolist()))
        tf = h5_utils.read_hdf(str(a / "mrd.h5"), f"df_tf_{tag}")
        check(got == support and list(got) == sorted(got) and int(tf["n_supporting_reads"][0]) == int(keep.sum())
              and int(tf["n_loci"][0]) == len(loci),
              f"mrd_data_analysis: {tag} is not the selection ({len(got)} loci, {len(support)} selected)")
    out["mrd"] = {"loci": len(loci), "filtered_reads": int((on & passing).sum()), "signature_reads": int(on.sum())}

    # 5. the JSON holds every key of the QC report
    qc_h5, doc = str(d / "runs2" / "a" / "qc.h5"), json.loads((d / "runs3" / "a" / "qc.json").read_text())
    check(sorted(doc) == h5_utils.list_keys(qc_h5), f"convert_h5_to_json: keys {sorted(doc)}")
    for key, records in doc.items():
        f = h5_utils.read_hdf(qc_h5, key)
        want = [{c: (v if not isinstance(v, float) else None if v != v or abs(v) == float("inf")
                     else float(json_double_text(v))) for c, v in zip(f.columns, row)}
                for row in zip(*(np.asarray(f[c]).tolist() for c in f.columns))]
        check(records == want, f"convert_h5_to_json: {key} is not the report's frame")
    out["qc"] = {"keys": sorted(doc), "rows": {k: len(v) for k, v in doc.items()}}

    # figures: drawn where matplotlib imports, else every one skipped and counted
    import importlib.util

    drawn = importlib.util.find_spec("matplotlib") is not None  # absent on the card's machine
    # a figure a section: report_wo_gt a key; MRD mutation types, ML_QUAL, read lengths (and the AFs, where the
    # signature has them); the QC report's reads and coverage; create_var_report none without --plot_dir
    want_skipped = {"report_wo_gt": len(h5_utils.list_keys(reports["full_h5"])),
                    "mrd_data_analysis": 3 + int(bool((~np.isnan(sig.info_field("AF"))).any())),
                    "create_qc_report": 2, "create_var_report": 0}
    skipped = {k: runs[k]["figures_skipped"] for k in want_skipped}
    check(skipped == {k: 0 if drawn else v for k, v in want_skipped.items()},
          f"figures skipped {skipped}, expected {want_skipped} (matplotlib {'present' if drawn else 'absent'})")
    out["figures_skipped"] = skipped
    out["walls"] = {k: v["seconds"] for k, v in runs.items()}
    print(f"report chain: 10 tools twice, {n_files} files byte-equal between the runs; create_var_report's counts "
          f"(tp {n_tp}, fp {n_fp}, fn {n_fn}) equal the comparison's; {len(body)} somatic GT records as planted, "
          f"none of {len(pair['problematic'])} problematic positions left, the comparison on them {cmp_rows} rows; "
          f"the MRD tables equal the selection ({out['mrd']}); the JSON holds the QC report's "
          f"{len(doc)} keys; figures skipped {skipped} ({card})", flush=True)
    return out


#: phase 19's planted duplicates, empty files and samples held to the per-read specs
HOST_DUPS = 1_040
HOST_EMPTY = dict(n=100, n_empty=30)
HOST_ADAPTER_SAMPLE = 5_000
HOST_ML_SAMPLE = 1_000
#: the world seed of phase 19's BEDs, duplicates and files
HOST_SEED = 2051
#: phase 19's homopolymer collection regions, and the intervals of each annotation BED
HOST_HPOL = dict(n_intervals=2_000, total_bp=20_000_000)
HOST_REGION_INTERVALS = 5_000


def _host_runs(jobs: dict[str, tuple], d: Path, card: str) -> dict[str, dict]:
    """Each ``label: (tool, argv, env, expected exit code)`` twice, in
    ``d/a/label`` and ``d/b/label`` (relative outputs), all at once, each in a
    forked process (:func:`_tool_child`, its standard output kept): the exit
    code, no kernel launched; a ``HOST_TOOLS_DETAIL`` line a run. The runs of
    ``a`` by label, after the two copies' files are held byte-equal."""
    specs = {}
    for label, (tool, argv, env, _) in jobs.items():
        for copy in ("a", "b"):
            (d / copy / label).mkdir(parents=True, exist_ok=True)
            specs[f"{label}/{copy}"] = {"tool": tool, "argv": argv, "env": env or {}, "cwd": str(d / copy / label),
                                        "raises": True}
    runs = _forked_all(specs, _tool_child)
    for key, run in runs.items():
        label = key.split("/")[0]
        tool, _, _, want_rc = jobs[label]
        check(run["rc"] == want_rc, f"{key}: exit {run['rc']} (expected {want_rc}): {run['error']}")
        check(not any(run["launches"].values()), f"{key}: a kernel was launched ({run['launches']})")
        print("HOST_TOOLS_DETAIL " + json.dumps({
            "run": key, "tool": tool, "card": card, "wall_s": run["seconds"], "peak_rss_bytes": run["peak_rss_bytes"],
            "figures_skipped": run["figures_skipped"], "side_by_side": len(specs)}), flush=True)
    _same_trees(d / "a", d / "b", f"host tools {d.name}")
    return {label: runs[f"{label}/a"] for label in jobs}


def _bed_mask(path: str, length: int) -> np.ndarray:
    """A BED's cover of one contig as a boolean mask, by numpy."""
    rows = np.loadtxt(path, dtype=np.int64, usecols=(1, 2), ndmin=2)
    edge = np.zeros(length + 1, dtype=np.int32)
    np.add.at(edge, np.minimum(rows[:, 0], length), 1)
    np.add.at(edge, np.minimum(rows[:, 1], length), -1)
    return np.cumsum(edge[:-1]) > 0


def _appended(path: str, sizes_in: np.ndarray, rows: np.ndarray) -> list[bytes]:
    """The bytes each record of ``rows`` of the BAM at ``path`` has past its input size ``sizes_in``."""
    from variantcalling_tpu_torch.io import bam as bam_io

    buf = bam_io.read_stream(path)
    starts, sizes = bam_io.record_offsets(buf, bam_io.header_end(buf))
    check(len(starts) == len(sizes_in), f"{path}: {len(starts)} records, the input {len(sizes_in)}")
    return [bytes(buf[starts[i] + 4 + sizes_in[i]:starts[i] + 4 + sizes[i]]) for i in rows.tolist()]


def phase_host_tools(tmp: Path, card: str, world: dict) -> dict:
    """The last twelve host-only tools (phase 19), each run twice in two
    directories, the runs of a step side by side in forked processes
    (:func:`_host_runs`), the two runs' files byte-equal, on seeded worlds
    of ``synthetic_tools`` and phase 4's chr20 world:

    1. ``sv_stats_collect`` on :data:`synthetic_tools.SV_WORLD` (25,000 SV
       records, a concordance h5 of 20,000 base and 25,000 call rows): the
       histograms and the concordance counts equal a numpy count of the
       plant; then ``create_sv_report --html_output`` on its pickle; and
       ``create_sv_report`` on the committed JAX-written pickle
       (``tests/torch_data/sv_stats_reference.pkl``, pandas 3 with Arrow
       strings) gives the h5 frames of the port's own ``sv_stats_collect``
       then ``create_sv_report`` on that world regenerated from its seed;
    2. ``ppmseq_qc`` on 500,000 reads of 200 bp: the crosstab equals a
       numpy count of the drawn tags;
    3. ``find_adapter_coords`` on the same reads: XF, XT and RX of a sample
       equal the plain per-read spec, and at least 99 % of the planted
       full-length adapters are found at their planted coordinate;
    4. ``add_ml_tags_bam`` on 20,000 reads and a (20,000, 380, 21) float32
       tensor: the tags of a sample equal the plain per-read spec, ``kr``
       the argmax key;
    5. ``collect_hpol_table`` on phase 4's FASTA and 2,000 intervals of
       about 20 Mbp: every row a run of its nucleotide of its length, a
       different base (or its interval's edge) on each side;
    6. ``annotate_contig --contig chr20`` on phase 4's VCF bgzipped with a
       ``.tbi``, two BEDs: each flag's count equals numpy membership;
    7. ``intersect_bed_regions`` of two BEDs less a third: the total length
       equals a numpy mask;
    8. ``index_vcf_file`` of the ``.vcf``: region reads through the new
       ``.tbi`` equal the whole-file read;
    9. ``remove_vcf_duplicates`` of 104,000 records and 1,040 planted
       duplicates: exactly those go, every other record as read (QUAL in the
       reference's rendering);
    10. ``remove_empty_files --dry_run`` of 100 files, 30 empty: 30 counted,
        none removed;
    11. ``cloud_sync``: a local path passes through, a ``gs://`` URI is
        localized by a stub ``gsutil`` on ``PATH`` with equal bytes, and with
        no CLI on ``PATH`` the tool fails as the reference's does. No network.

    ``HOST_TOOLS_DETAIL`` lines (wall, peak RSS, figures skipped, runs side by side)."""
    from tests import torch_worlds
    from variantcalling_tpu_torch import synthetic_tools as st
    from variantcalling_tpu_torch.io import bam as bam_io
    from variantcalling_tpu_torch.io.bed import read_bed
    from variantcalling_tpu_torch.io.vcf import format_qual, read_vcf
    from variantcalling_tpu_torch.pipelines import add_ml_tags_bam, find_adapter_coords
    from variantcalling_tpu_torch.pipelines.sv_stats_collect import SVBINS
    from variantcalling_tpu_torch.utils import h5_utils
    from variantcalling_tpu_torch.utils import pandas_pickle as pp
    from variantcalling_tpu_torch.utils.frame_ops import read_tsv

    d = tmp / "host_tools"
    d.mkdir()
    out: dict = {}
    length = WORLD["length"]
    t0 = time.perf_counter()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:  # processes: the writers' Python parts side by side
        futures = {
            "reads": pool.submit(st.write_read_world, str(d / "reads"), **st.READ_WORLD),
            "ml": pool.submit(st.write_ml_world, str(d / "ml"), **st.ML_WORLD),
            "sv": pool.submit(st.write_sv_world, str(d / "sv"), **st.SV_WORLD),
            "sv_ref": pool.submit(st.write_sv_world, str(d / "sv_ref"), **st.SV_REFERENCE_WORLD),
            "beds": pool.submit(st.write_region_beds, str(d / "beds"), seed=HOST_SEED, contig="chr20", length=length,
                                n_intervals=HOST_REGION_INTERVALS),
            "hpol": pool.submit(st.write_hpol_bed, str(d / "hpol.bed"), seed=HOST_SEED, contig="chr20", length=length,
                                **HOST_HPOL),
            "dup": pool.submit(st.write_dup_vcf, str(d / "dup.vcf"), world["vcf"], seed=HOST_SEED, n_dups=HOST_DUPS),
            "empty": pool.submit(st.write_empty_files, str(d / "empty"), seed=HOST_SEED, **HOST_EMPTY),
            "gz": pool.submit(st.bgzip_indexed, world["vcf"], str(d / "calls.vcf.gz")),
        }
        w = {k: f.result() for k, f in futures.items()}
    (d / "jax").mkdir()
    (d / "jax" / "stats.pkl").write_bytes(torch_worlds.SV_REFERENCE_PICKLE.read_bytes())
    stub = d / "bin"
    stub.mkdir()
    (stub / "gsutil").write_text(f"#!/bin/sh\n# gsutil -q cp URI DEST: a local copy, no network\ncp '{world['vcf']}' "
                                 "\"$4\"\n")
    (stub / "gsutil").chmod(0o755)
    (d / "nobin").mkdir()
    for copy in ("a", "b"):
        (d / "runs1" / copy / "index_vcf_file").mkdir(parents=True)
        (d / "runs1" / copy / "index_vcf_file" / "calls.vcf").write_bytes(Path(world["vcf"]).read_bytes())
    world_s = time.perf_counter() - t0
    print(f"world host tools: {st.READ_WORLD['n_reads']} reads, an ML tensor {st.ML_WORLD}, "
          f"{st.SV_WORLD['n_records']} SV records, BEDs, {HOST_DUPS} duplicates, {HOST_EMPTY['n']} files, "
          f"written in {world_s:.1f} s", flush=True)
    out["world_s"] = world_s

    sv, beds, reads = w["sv"], w["beds"], w["reads"]
    adapters = ["--left_adapter", st.LEFT_ADAPTER, "--right_adapter", st.RIGHT_ADAPTER, "--left_umi_length",
                str(st.LEFT_UMI)]
    path_env = {"PATH": str(stub) + os.pathsep + os.environ.get("PATH", "")}
    first = _host_runs({
        "sv_stats_collect": ("sv_stats_collect", [sv["vcf"], "sv.pkl", "--concordance_h5", sv["concordance_h5"]],
                             None, 0),
        "sv_stats_collect_ref": ("sv_stats_collect", [w["sv_ref"]["vcf"], "stats.pkl", "--concordance_h5",
                                                      w["sv_ref"]["concordance_h5"]], None, 0),
        "create_sv_report_jax_pickle": ("create_sv_report", ["--statistics_file", str(d / "jax" / "stats.pkl"),
                                                             "--h5_output", "ref.h5"], None, 0),
        "ppmseq_qc": ("ppmseq_qc", ["--input_bam", reads["bam"], "--output_h5", "ppmseq.h5"], None, 0),
        "find_adapter_coords": ("find_adapter_coords", ["--input_bam", reads["bam"], "--output_bam", "tagged.bam",
                                                        *adapters], None, 0),
        "add_ml_tags_bam": ("add_ml_tags_bam", ["--probability_tensor", w["ml"]["probs"], "--input_ubam",
                                                w["ml"]["bam"], "--output_ubam", "ml.bam"], None, 0),
        "collect_hpol_table": ("collect_hpol_table", ["--reference", world["fasta"], "--collection_regions",
                                                      w["hpol"], "--output", "hpol.tsv"], None, 0),
        "annotate_contig": ("annotate_contig", ["--input_vcf", w["gz"], "--output_vcf", "annotated.vcf",
                                                "--annotate_intervals", *beds[:2], "--contig", "chr20"], None, 0),
        "intersect_bed_regions": ("intersect_bed_regions", ["--include-regions", *beds[:2], "--exclude-regions",
                                                            beds[2], "--output-bed", "intersect.bed"], None, 0),
        "index_vcf_file": ("index_vcf_file", ["calls.vcf"], None, 0),
        "remove_vcf_duplicates": ("remove_vcf_duplicates", [w["dup"]["vcf"], "dedup.vcf"], None, 0),
        "remove_empty_files": ("remove_empty_files", [*w["empty"]["paths"], "--dry_run"], None, 0),
        "cloud_sync_local": ("cloud_sync", [world["vcf"], "--cache_dir", "cache"], None, 0),
        "cloud_sync_gs": ("cloud_sync", ["gs://bucket/chr20/calls.vcf", "--cache_dir", "cache"], path_env, 0),
        "cloud_sync_no_cli": ("cloud_sync", ["gs://bucket/x.vcf", "--cache_dir", "cache"], {"PATH": str(d / "nobin")},
                              1),
    }, d / "runs1", card)
    a1 = d / "runs1" / "a"
    second = _host_runs({
        "create_sv_report": ("create_sv_report", ["--statistics_file", str(a1 / "sv_stats_collect" / "sv.pkl"),
                                                  "--h5_output", "sv.h5", "--html_output", "sv.html"], None, 0),
        "create_sv_report_ref": ("create_sv_report", ["--statistics_file",
                                                      str(a1 / "sv_stats_collect_ref" / "stats.pkl"), "--h5_output",
                                                      "ref.h5"], None, 0),
    }, d / "runs2", card)
    runs = {**first, **second}
    a2 = d / "runs2" / "a"

    # 1. the SV histograms and concordance against the plant; the JAX pickle's report against the port's own
    res = pp.loads((a1 / "sv_stats_collect" / "sv.pkl").read_bytes())
    keep = sv["pass"]
    types, lens = sv["svtype"][keep], np.nan_to_num(sv["svlen"][keep], nan=0.0)
    bins = np.searchsorted(np.asarray(SVBINS), np.abs(lens), side="right") - 1
    want_types = {t: int((types == t).sum()) for t in set(types.tolist())}
    got_types = dict(zip(res["type_counts"].index.values.tolist(), res["type_counts"].values.tolist()))
    check(got_types == want_types, f"sv_stats_collect: type counts {got_types} != the plant's {want_types}")
    check(res["length_counts"].values.tolist() == np.bincount(bins, minlength=11).tolist(),
          "sv_stats_collect: length counts are not the plant's")
    lbt = res["length_by_type_counts"]
    want_rows = {t: np.bincount(bins[types == t], minlength=11).tolist() for t in sorted(want_types) if t != "CTX"}
    got_rows = {t: [int(lbt.columns[c][i]) for c in lbt.columns] for i, t in enumerate(lbt.index.values.tolist())}
    check(got_rows == want_rows, "sv_stats_collect: the length-by-type table is not the plant's")
    base = h5_utils.read_hdf(sv["concordance_h5"], "base")
    calls = h5_utils.read_hdf(sv["concordance_h5"], "calls")
    conc = res["concordance"]
    all_row = conc.index.tuples().index(("ALL", ""))
    want_all = {"TP_base": int((np.asarray(base["label"]) == "TP").sum()),
                "FN": int((np.asarray(base["label"]) == "FN").sum()),
                "TP_calls": int((np.asarray(calls["label"]) == "TP").sum()),
                "FP": int((np.asarray(calls["label"]) == "FP").sum())}
    got_all = {k: int(conc.columns[k][all_row]) for k in want_all}
    check(got_all == want_all and int(res["fp_stats"].values.sum()) == want_all["FP"],
          f"sv_stats_collect: the ALL row {got_all} != the h5's {want_all}")
    report_keys = h5_utils.list_keys(str(a2 / "create_sv_report" / "sv.h5"))
    check(report_keys == sorted(["parameters", "type_counts", "length_counts", "length_by_type_counts", "concordance",
                                 "recall_per_type", "recall_per_length_and_type",
                                 "fp_counts_per_length_and_type"]), f"create_sv_report: keys {report_keys}")
    ref_rows = _same_frames(str(a2 / "create_sv_report_ref" / "ref.h5"),
                            str(a1 / "create_sv_report_jax_pickle" / "ref.h5"), "create_sv_report (JAX pickle)")
    out["sv"] = {"records": int(len(sv["pass"])), "passing": int(keep.sum()), "types": want_types,
                 "report_keys": len(report_keys), "jax_pickle_rows": ref_rows}

    # 2. the crosstab against the drawn tags
    cross = h5_utils.read_hdf(str(a1 / "ppmseq_qc" / "ppmseq.h5"), "strand_tag_crosstab")
    want = np.zeros((6, 6), dtype=np.int64)
    np.add.at(want, (reads["cat_start"], reads["cat_end"]), 1)
    got = np.stack([np.asarray(cross[c]) for c in cross.columns[1:]], axis=1)
    check((got == want).all(), "ppmseq_qc: the crosstab is not the drawn tags' count")
    out["ppmseq"] = {"reads": int(want.sum()), "mixed_mixed": int(want[0, 0])}

    # 3. the adapters: a sample against the plain per-read spec, the planted ones found
    buf = bam_io.read_stream(reads["bam"])
    starts, sizes = bam_io.record_offsets(buf, bam_io.header_end(buf))
    lay = bam_io.record_layout(buf, starts, sizes)
    letters = bam_io.sequence_letters(buf, lay["seq"], st.READ_WORLD["read_len"])
    tagged = bam_io.read_stream(str(a1 / "find_adapter_coords" / "tagged.bam"))
    t_starts, t_sizes = bam_io.record_offsets(tagged, bam_io.header_end(tagged))
    t_lay = bam_io.record_layout(tagged, t_starts, t_sizes)
    tags = bam_io.find_aux_tags(tagged, t_lay["aux"], t_lay["end"], ("XF", "XT", "RX"))
    xf, xt = (bam_io.le_ints(tagged, tags[t][1], 4, signed=True) for t in ("XF", "XT"))
    args = find_adapter_coords.parse_args(["--input_bam", "-", "--output_bam", "-", *adapters])
    sample = np.sort(np.random.default_rng(HOST_SEED).choice(len(starts), HOST_ADAPTER_SAMPLE, replace=False))
    bad = 0
    for i in sample.tolist():
        got_rx = bytes(tagged[tags["RX"][1][i]:tags["RX"][1][i] + tags["RX"][2][i] - 1]).decode()
        bad += find_adapter_coords.analyze_read(bytes(letters[i]).decode(), args) != (int(xf[i]), int(xt[i]), got_rx)
    check(bad == 0, f"find_adapter_coords: {bad} of {HOST_ADAPTER_SAMPLE} sampled reads differ from the plain spec")
    left_full = (reads["left_end"] > 0) & ~reads["truncated"]
    left_hit = float((xf[left_full] == reads["left_end"][left_full] + 1 + st.LEFT_UMI).mean())
    right_full = reads["right_len"] == len(st.RIGHT_ADAPTER)
    right_hit = float((xt[right_full] == reads["right_start"][right_full] + 1).mean())
    check(left_hit >= 0.99 and right_hit >= 0.99,
          f"find_adapter_coords: planted full-length adapters found 5' {left_hit:.4f}, 3' {right_hit:.4f}")
    out["adapters"] = {"sample": HOST_ADAPTER_SAMPLE, "left_found": left_hit, "right_found": right_hit,
                       "left_planted": int(left_full.sum()), "right_planted": int(right_full.sum())}

    # 4. the ML tags of a sample against the plain per-read spec
    probs = np.load(w["ml"]["probs"], mmap_mode="r")
    ml_buf = bam_io.read_stream(w["ml"]["bam"])
    _, ml_sizes = bam_io.record_offsets(ml_buf, bam_io.header_end(ml_buf))
    rows = np.sort(np.random.default_rng(HOST_SEED + 1).choice(len(ml_sizes), HOST_ML_SAMPLE, replace=False))
    bad = kr_bad = 0
    for i, tail in zip(rows.tolist(), _appended(str(a1 / "add_ml_tags_bam" / "ml.bam"), ml_sizes, rows)):
        p = np.asarray(probs[i])
        key = p.argmax(axis=1)
        bad += tail != add_ml_tags_bam.read_tags(p, key, 0.003, 10.0)
        kr = np.frombuffer(tail[8:8 + p.shape[0]], dtype=np.int8)
        kr_bad += not (tail[:4] == b"krBc" and (kr == np.clip(key, 0, 127)).all())
    check(bad == 0 and kr_bad == 0, f"add_ml_tags_bam: {bad} sampled reads differ from the plain spec, {kr_bad} "
                                     "with kr not the argmax key")
    out["ml_tags"] = {"sample": HOST_ML_SAMPLE, "reads": int(len(ml_sizes))}

    # 5. the homopolymers against the genome
    codes = _fasta_codes(world["fasta"])["chr20"]
    hp = read_tsv(str(a1 / "collect_hpol_table" / "hpol.tsv"), names=["chrom", "pos", "length", "base"])
    pos, hl = np.asarray(hp["pos"], dtype=np.int64), np.asarray(hp["length"], dtype=np.int64)
    letter = np.full(128, 255, dtype=np.uint8)
    letter[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    nuc = letter[np.asarray(hp["base"]).astype("U1").view(np.uint32) % 128]
    iv = read_bed(w["hpol"])
    which = np.searchsorted(iv.start, pos, side="right") - 1
    lo, hi = iv.start[which], np.minimum(iv.end[which], length)
    inside = (pos >= lo) & (pos + hl <= hi)
    run_ok = np.zeros(len(pos), dtype=bool)
    for h in np.unique(hl).tolist():  # the rows of one hmer length at once
        at = np.flatnonzero(hl == h)
        run_ok[at] = (codes[np.minimum(pos[at, None] + np.arange(h), length - 1)] == nuc[at, None]).all(axis=1)
    left_ok = (pos == lo) | (codes[np.maximum(pos - 1, 0)] != nuc)
    right_ok = (pos + hl == hi) | (codes[np.minimum(pos + hl, length - 1)] != nuc)
    check(len(pos) > 0 and inside.all() and run_ok.all() and left_ok.all() and right_ok.all(),
          f"collect_hpol_table: of {len(pos)} rows, {int((~run_ok).sum())} are not a run of their base, "
          f"{int((~left_ok | ~right_ok).sum())} have their base beside them")
    out["hpol"] = {"rows": len(pos), "at_interval_edge": int(((pos == lo) | (pos + hl == hi)).sum())}

    # 6-7. the flags and the intersection against numpy masks
    table = read_vcf(str(a1 / "annotate_contig" / "annotated.vcf"))
    pos0 = np.asarray(table.pos, dtype=np.int64) - 1
    flags = {}
    for path in beds[:2]:
        name = Path(path).name.removesuffix(".bed")
        got_n = sum(f";{name};" in f";{s};" for s in table.info)
        want_n = int(_bed_mask(path, length)[pos0].sum())
        check(got_n == want_n, f"annotate_contig: {name} on {got_n} records, numpy membership {want_n}")
        flags[name] = got_n
    out["annotate"] = {"records": len(table), "flags": flags}
    inter = read_bed(str(a1 / "intersect_bed_regions" / "intersect.bed"))
    want_bp = int((_bed_mask(beds[0], length) & _bed_mask(beds[1], length) & ~_bed_mask(beds[2], length)).sum())
    check(inter.total_length() == want_bp, f"intersect_bed_regions: {inter.total_length()} bp, the mask {want_bp}")
    out["intersect"] = {"intervals": len(inter), "bp": want_bp}

    # 8. the index: region reads against the whole file
    gz = a1 / "index_vcf_file" / "calls.vcf.gz"
    check(runs["index_vcf_file"]["stdout"].strip() == "calls.vcf.gz.tbi", "index_vcf_file: printed "
          f"{runs['index_vcf_file']['stdout']!r}")
    whole = read_vcf(str(a1 / "index_vcf_file" / "calls.vcf"))
    wpos = np.asarray(whole.pos, dtype=np.int64)
    for lo_, hi_ in ((1, 1_000_000), (20_000_000, 20_050_000), (40_000_000, length)):
        part = read_vcf(str(gz), region=("chr20", lo_, hi_))
        sel = (wpos >= lo_) & (wpos <= hi_)
        check(np.array_equal(np.asarray(part.pos), wpos[sel]) and list(part.alt) == list(np.asarray(whole.alt)[sel]),
              f"index_vcf_file: the region chr20:{lo_}-{hi_} read through the index is not the whole file's")

    # 9. the duplicates gone, every other record as read
    got_lines = _records(a1 / "remove_vcf_duplicates" / "dedup.vcf")
    originals = w["dup"]["records"]
    same = len(got_lines) == len(originals) and all(
        g.split(b"\t")[:5] + g.split(b"\t")[6:] == o.split(b"\t")[:5] + o.split(b"\t")[6:]
        and g.split(b"\t")[5].decode() == format_qual(float(o.split(b"\t")[5])) for g, o in zip(got_lines, originals))
    check(same, f"remove_vcf_duplicates: {len(got_lines)} records, {len(originals)} originals, or a record changed")
    out["dedup"] = {"records_in": len(originals) + HOST_DUPS, "records_out": len(got_lines)}

    # 10-11. the file tools' printed lines
    check(runs["remove_empty_files"]["stdout"] == f"{HOST_EMPTY['n_empty']}\n"
          and all(os.path.exists(p) for p in w["empty"]["paths"]),
          f"remove_empty_files --dry_run: printed {runs['remove_empty_files']['stdout']!r} or removed a file")
    check(runs["cloud_sync_local"]["stdout"] == world["vcf"] + "\n", "cloud_sync: a local path did not pass through")
    cached = a1 / "cloud_sync_gs" / "cache" / "gs" / "bucket" / "chr20" / "calls.vcf"
    check(runs["cloud_sync_gs"]["stdout"] == "cache/gs/bucket/chr20/calls.vcf\n"
          and cached.read_bytes() == Path(world["vcf"]).read_bytes(), "cloud_sync: the stub's copy is not localized")
    check((runs["cloud_sync_no_cli"]["error"] or "").startswith(
        "could not localize gs://bucket/x.vcf: no working cloud CLI"),
          f"cloud_sync without a CLI: {runs['cloud_sync_no_cli']['error']!r}")

    import importlib.util

    drawn = importlib.util.find_spec("matplotlib") is not None  # absent on the card's machine
    skipped = {k: runs[k]["figures_skipped"] for k in ("create_sv_report", "create_sv_report_ref")}
    check(skipped == ({"create_sv_report": 0, "create_sv_report_ref": 0} if drawn
                      else {"create_sv_report": 6, "create_sv_report_ref": 6}),
          f"create_sv_report figures skipped {skipped} (matplotlib {'present' if drawn else 'absent'})")
    out["figures_skipped"] = skipped
    out["walls"] = {k: v["seconds"] for k, v in runs.items()}
    print(f"host tools: 12 tools twice, files byte-equal between the runs; SV histograms as planted "
          f"({out['sv']['passing']} passing records), the JAX pickle's report equal to the port's "
          f"({ref_rows} rows); ppmseq crosstab as drawn; adapters found 5' {left_hit:.4f}, 3' {right_hit:.4f}, "
          f"{HOST_ADAPTER_SAMPLE} reads as the plain spec; {HOST_ML_SAMPLE} ML-tagged reads as the plain spec; "
          f"{len(pos)} homopolymers checked; flags {flags}; intersection {want_bp} bp; "
          f"{len(originals) + HOST_DUPS} -> {len(got_lines)} records; figures skipped {skipped} ({card})",
          flush=True)
    return out


#: a worker's own log lines that phase 20 reads: its engine, its forest kernels' launches and its card memory
_SCALEOUT_RE = r"rank (\d+)/(\d+): done in ([\d.]+) s; forest kernel launches in this process: wide (\d+), tree_step (\d+)"
_ENGINE_RE = r"engine (\S+), model family (\S+), forest strategy (\S+),"
_PEAK_RE = r"peak device memory (-?\d+) bytes"


def _pod_cmd(world: dict, out: Path, inp: str | None = None, *flags: str) -> list[str]:
    """The port's pod launcher over ``world`` into ``out`` on the card, workers' logs kept."""
    return [sys.executable, "-m", "variantcalling_tpu_torch.parallel.podrun", "--keep-logs", "--timeout", "600",
            *flags, "--", "--input_file", inp or world["vcf"], "--model_file", world["model"], "--model_name",
            world["model_name"], "--reference_file", world["fasta"], "--output_file", str(out), "--backend", "gpu"]


def _popen_all(cmds: dict[str, list[str]], on_start=None) -> dict[str, dict]:
    """Every command side by side (``subprocess``: each starts a fresh
    interpreter, never a fork of this process and its CUDA context); exit
    code, host wall and output by label. ``on_start(procs)`` runs once all
    have started (phase 20's kill)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(Path(__file__).resolve().parent),
                                                               os.environ.get("PYTHONPATH")) if p))
    t0, procs = {}, {}
    for label, cmd in cmds.items():
        t0[label] = time.perf_counter()
        procs[label] = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(label: str) -> dict:
        out, _ = procs[label].communicate(timeout=900)
        return {"rc": procs[label].returncode, "wall_s": time.perf_counter() - t0[label], "stdout": out}

    with ThreadPoolExecutor(len(procs)) as pool:  # each process's pipe drained, and its end timed, as it comes
        waits = {label: pool.submit(wait, label) for label in procs}
        extra = on_start(procs) if on_start is not None else None
        runs = {label: w.result() for label, w in waits.items()}
    for label, run in runs.items():
        check(run["rc"] == 0, f"{label}: exit {run['rc']}\n{run['stdout'][-3000:]}")
    return {**runs, "on_start": extra}


def _pod_workers(out: Path, label: str, card: str, launched: bool = True) -> list[dict]:
    """Each worker of a pod into ``out``, read from its own log (``--keep-logs``),
    the logs removed: its rank, seconds in the scale-out, forest kernel
    launches, engine and strategy, peak card memory. Every worker must have
    scored on the card, none on ``cuda-gemm``, and (``launched``) each
    launched ``cuda-wide`` (an elastic adopter that resumed every chunk of
    its span launches nothing)."""
    import re

    workers = []
    for log in sorted(out.parent.glob(out.name + ".*.podlog")):
        text = log.read_text(errors="replace")
        log.unlink()
        done = re.findall(_SCALEOUT_RE, text)
        if not done:  # a worker killed on purpose, or one that lost its lease
            workers.append({"log": log.name, "completed": False})
            continue
        rank, ranks, seconds, wide, tree_step = done[-1]
        engine = re.findall(_ENGINE_RE, text)
        peak = re.findall(_PEAK_RE, text)
        w = {"log": log.name, "completed": True, "rank": int(rank), "ranks": int(ranks), "scaleout_s": float(seconds),
             "forest_wide_launches": int(wide), "forest_tree_step_launches": int(tree_step),
             "engine": engine[-1][0] if engine else None, "strategy": engine[-1][2] if engine else None,
             "peak_device_bytes": int(peak[-1]) if peak else None}
        check(w["engine"] == "cuda" and (w["forest_wide_launches"] > 0 or not launched)
              and w["forest_tree_step_launches"] == 0,
              f"{label}: worker {log.name} engine {w['engine']}, launches {wide} wide, {tree_step} tree_step ({card})")
        workers.append(w)
    check(any(w["completed"] for w in workers), f"{label}: no worker log found")
    return workers


def _without_ranks_line_sha256(path: Path) -> tuple[str, int]:
    """sha256 of ``path`` without its ``##vctpu_ranks=`` lines, and how many there were."""
    h, n = hashlib.sha256(), 0
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"##vctpu_ranks="):
                n += 1
                continue
            h.update(line)
    return h.hexdigest(), n


def _kill_first_journaled(pod: subprocess.Popen, out: Path, timeout: float = 300) -> dict:
    """SIGKILL the elastic pod's first span's worker (the slowed one) once its
    journal holds a committed chunk; the pod's state file names each running
    worker's pid and span."""
    import signal

    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and pod.poll() is None:
        try:
            workers = json.loads(Path(f"{out}.podrun.json").read_text()).get("workers") or []
        except (OSError, ValueError):
            workers = []
        w = min(workers, key=lambda w: w["span"][0], default=None)
        journal = Path(f"{out}.span{w['span'][0]}-{w['span'][1]}.seg.journal") if w else None
        try:
            committed = len(journal.read_text().splitlines()) - 1 if journal else 0
            running = Path(f"/proc/{w['pid']}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
        except (OSError, TypeError):
            committed, running = 0, False
        if committed >= 1 and running:
            try:
                os.kill(w["pid"], signal.SIGKILL)
                return {"killed_span": w["span"], "after_chunks": committed, "at_s": time.perf_counter() - t0}
            except ProcessLookupError:
                pass
        time.sleep(0.01)
    return {}


def _pod_leftovers(out: Path) -> list[str]:
    return sorted(p.name for p in out.parent.glob(out.name + ".*") if any(
        s in p.name for s in (".seg", ".done", ".lease", ".journal", ".partial", ".podrun.json", ".podlog")))


#: phase 20's slowed worker: a delay at each of its chunks, so the kill lands mid-span
SCALEOUT_SLOW_CHUNK = "pipeline.stage_hang:0@0.25"
#: phase 20's elastic ``--grace``: a worker on the card takes about 8 s to reach it, so the launcher's default
#: of 1.5 s lets the straggler rule steal a fresh worker of a short span again and again (exit 7)
SCALEOUT_GRACE_S = "30"


def phase_scaleout(tmp: Path, card: str, stream: dict, pipe: dict) -> dict:
    """Rank-partitioned and elastic filter pods on the one card (phase 20),
    every worker a process of its own running the streaming filter and
    ``cuda-wide`` on its span (``parallel/podrun``). A pod of N processes on
    one card checks correctness, not scaling.

    The three pods and the single-rank run of (c) side by side (4 + 3 + 2 + 1
    worker processes on the host's 8 cores and the one card, so each wall is
    a share):

    (a) phase 8's 5 M world through a 4-rank classic pod into ``.vcf``
        (``--no-merge``, then ``rank_plan.merge_ranks`` timed here): the
        merged bytes the default run's outside ``##vctpu_ranks=n=4``, which is
        there; every worker's ``forest_wide`` launches > 0 (its own log);
        ``merge-ranks`` on a copy with one segment removed exits 3 and leaves
        the destination as it was;
    (b) an elastic pod of 3 spans on the same world, the first span's worker
        (slowed by :data:`SCALEOUT_SLOW_CHUNK`) SIGKILLed after its first
        journaled chunk: the same launch exits 0 with the default run's
        sha256, nothing left over;
    (c) phase 4's 104,000-variant pickle world from a BGZF input through a
        2-rank pod into ``.vcf.gz``, beside a single-rank ``.vcf.gz`` run: the
        inflated bytes equal outside ``##vctpu_*``, a ``.tbi`` written, and a
        region read through it gives the single-rank run's records.

    One ``SCALEOUT_DETAIL`` line a pod: its wall, each worker's seconds,
    launches and peak card memory, the merge's seconds.
    """
    from variantcalling_tpu_torch.io import tabix
    from variantcalling_tpu_torch.io.bgzf import BgzfWriter
    from variantcalling_tpu_torch.parallel import rank_plan

    w5 = stream["world_5m"]
    want_5m = stream["stream_5m"]["default"]["sha256"]
    w104 = pipe["forest_pickle"]["world"]
    d = tmp / "scaleout"
    d.mkdir()
    bgzf_in = d / "calls_104k.vcf.gz"
    with BgzfWriter(str(bgzf_in)) as fh:
        fh.write(Path(w104["vcf"]).read_bytes())
    a_out, c_out, c_single = d / "pod_5m.vcf", d / "pod_104k.vcf.gz", d / "single_104k.vcf.gz"
    single_cmd = [sys.executable, "-m", "variantcalling_tpu_torch", "filter_variants_pipeline", "--input_file",
                  str(bgzf_in), "--model_file", w104["model"], "--model_name", w104["model_name"], "--reference_file",
                  w104["fasta"], "--output_file", str(c_single), "--backend", "gpu"]
    b_out = d / "elastic_5m.vcf"
    runs = _popen_all({"b": _pod_cmd(w5, b_out, None, "--elastic", "--ranks", "3", "--grace", SCALEOUT_GRACE_S,
                                     "--worker-env", f"0:VCTPU_FAULTS={SCALEOUT_SLOW_CHUNK}"),
                       "a": _pod_cmd(w5, a_out, None, "--ranks", "4", "--no-merge"),
                       "c": _pod_cmd(w104, c_out, str(bgzf_in), "--ranks", "2"), "c_single": single_cmd},
                      on_start=lambda procs: _kill_first_journaled(procs["b"], b_out))
    out = {}

    # -- (a) the 4-rank classic pod ---------------------------------------------------------------------------
    workers = _pod_workers(a_out, "scaleout_5m", card)
    check(sorted(w["rank"] for w in workers) == [0, 1, 2, 3], f"scaleout_5m: workers {workers}")
    # merge-ranks on a copy missing one segment: exit 3, the destination as it was
    bad = d / "bad"
    bad.mkdir()
    for seg in a_out.parent.glob(a_out.name + ".rank*of4.seg*"):
        if not seg.name.startswith(a_out.name + ".rank2of4.seg"):
            os.link(seg, bad / seg.name)
    (bad / a_out.name).write_bytes(b"untouched\n")
    proc = subprocess.run([sys.executable, "-m", "variantcalling_tpu_torch", "merge-ranks", str(bad / a_out.name)],
                          env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)), capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 3 and (bad / a_out.name).read_bytes() == b"untouched\n"
          and "rank 2/4 segment missing" in proc.stderr,
          f"merge-ranks without rank 2: exit {proc.returncode}, {proc.stderr[-500:]}")
    t0 = time.perf_counter()
    merged = rank_plan.merge_ranks(str(a_out), 4)
    merge_s = time.perf_counter() - t0
    digest, n_lines = _without_ranks_line_sha256(a_out)
    check(digest == want_5m and n_lines == 1 and b"##vctpu_ranks=n=4\n" in a_out.read_bytes()[:1 << 16],
          f"scaleout_5m: merged bytes differ from the default run's outside ##vctpu_ranks ({n_lines} lines)")
    check(merged["n"] == WORLD_STREAM["n_variants"] and not _pod_leftovers(a_out), f"scaleout_5m: {merged}")
    a_out.unlink()
    for f in bad.iterdir():
        f.unlink()
    out["scaleout_5m"] = {"pod": "classic", "world": "stream_5m", "ranks": 4, "card": card,
                          "pod_wall_s": runs["a"]["wall_s"], "merge_s": merge_s, "workers": workers,
                          "forest_wide_launches": sum(w["forest_wide_launches"] for w in workers),
                          "merge_ranks_exit_without_a_segment": proc.returncode, "side_by_side": 4}

    # -- (c) the 2-rank pod from BGZF into .vcf.gz -------------------------------------------------------------------
    workers = _pod_workers(c_out, "scaleout_104k_gz", card)
    got, want = gzip.decompress(c_out.read_bytes()), gzip.decompress(c_single.read_bytes())
    check(_strip(got) == _strip(want) and b"##vctpu_ranks=n=2" in got,
          "scaleout_104k_gz: inflated bytes differ from the single-rank run's outside ##vctpu_*")
    check(Path(f"{c_out}.tbi").exists(), "scaleout_104k_gz: no .tbi")
    contig, length = "chr20", WORLD["length"]
    lo, hi = length // 3, length // 3 + 2_000_000
    region = list(tabix.read_region_lines(str(c_out), contig, lo, hi))
    region_single = list(tabix.read_region_lines(str(c_single), contig, lo, hi))
    check(region == region_single and len(region) > 1000,
          f"scaleout_104k_gz: region read {len(region)} records against {len(region_single)}")
    check(not _pod_leftovers(c_out), f"scaleout_104k_gz: leftovers {_pod_leftovers(c_out)}")
    out["scaleout_104k_gz"] = {"pod": "classic", "world": "forest_pickle_104k", "ranks": 2, "card": card,
                               "pod_wall_s": runs["c"]["wall_s"], "single_wall_s": runs["c_single"]["wall_s"],
                               "workers": workers, "region_records": len(region),
                               "forest_wide_launches": sum(w["forest_wide_launches"] for w in workers),
                               "side_by_side": 4}

    # -- (b) the elastic pod with a SIGKILL --------------------------------------------------------------------------
    kill = runs["on_start"]
    stdout = runs["b"]["stdout"]
    check(bool(kill), f"scaleout_elastic: the kill never landed\n{stdout[-2000:]}")
    check("membership: recut" in stdout or "membership: reassign" in stdout,
          f"scaleout_elastic: no recut or reassign\n{stdout[-2000:]}")
    workers = _pod_workers(b_out, "scaleout_elastic", card, launched=False)
    check(sum(w.get("forest_wide_launches", 0) for w in workers) > 0, f"scaleout_elastic: no launch {workers}")
    check(_sha256(b_out) == want_5m, "scaleout_elastic: sha256 differs from the default run's")
    check(not _pod_leftovers(b_out), f"scaleout_elastic: leftovers {_pod_leftovers(b_out)}")
    b_out.unlink()
    transitions = [ln.split("membership: ", 1)[1].split(" ", 1)[0] for ln in stdout.splitlines()
                   if "membership: " in ln]
    out["scaleout_elastic"] = {"pod": "elastic", "world": "stream_5m", "spans": 3, "card": card,
                               "pod_wall_s": runs["b"]["wall_s"], "kill": kill, "transitions": transitions,
                               "workers": workers,
                               "forest_wide_launches": sum(w["forest_wide_launches"] for w in workers
                                                           if w["completed"]), "side_by_side": 4}
    for label, detail in out.items():
        print("SCALEOUT_DETAIL " + json.dumps({"run": label, **detail}), flush=True)
    print(f"scaleout: 4-rank pod on 5 M variants {runs['a']['wall_s']:.1f} s (merge {merge_s:.2f} s), elastic pod "
          f"with a SIGKILL {runs['b']['wall_s']:.1f} s ({' '.join(transitions)}), 2-rank BGZF pod "
          f"{runs['c']['wall_s']:.1f} s; bytes equal the single-rank runs' ({card})", flush=True)
    return out


#: phase 21: backends a fleet, a request's bound (the client's socket timeout and its deadline), and the scoped
#: fault that holds the quota case's first request at its first chunk for a few seconds
FABRIC_BACKENDS = 2
FABRIC_TIMEOUT_S = 300.0
FABRIC_HOLD = "pipeline.stage_hang:1@3"
#: a backend's drain line (``serve/backend.DRAIN_LOG``) in its ``.podlog``
_DRAIN_RE = r"forest kernel launches in this process: wide (\d+), tree_step (\d+); peak card memory (\d+) bytes"
_FABRIC_LEFTOVERS = (".seg", ".lease", ".done", ".tmp", ".partial", ".journal", ".podrun.json")


class _PeakRss:
    """The largest resident set of process ``pid``, sampled every 50 ms on a
    thread (``/proc/<pid>/statm``; the card's machine has no ``VmHWM``), and
    how much of it was anonymous at that sample (the ``Anonymous`` lines of
    ``/proc/<pid>/smaps``; the rest is file pages, such as a memory-mapped
    spool). ``anon`` stays None where ``smaps`` cannot be read."""

    def __init__(self, pid: int):
        import threading

        self.pid, self.peak, self.anon = pid, 0, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="fabric-rss", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        page = os.sysconf("SC_PAGE_SIZE")
        while not self._stop.is_set():
            with contextlib.suppress(OSError, ValueError, IndexError):
                with open(f"/proc/{self.pid}/statm") as fh:
                    rss = int(fh.read().split()[1]) * page
                if rss > self.peak:
                    self.peak = rss
                    with open(f"/proc/{self.pid}/smaps") as fh:
                        self.anon = 1024 * sum(int(ln.split()[1]) for ln in fh if ln.startswith("Anonymous:"))
            self._stop.wait(0.05)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(5)
        return {"peak": self.peak, "anon": self.anon, "file": None if self.anon is None else self.peak - self.anon}


def _fabric_request(address: str, world: dict, out: Path, token: str | None = None,
                    timeout: float = FABRIC_TIMEOUT_S, **params) -> dict:
    """One filter request through a fabric's front door (``transport.client_filter``):
    ``world``'s VCF streamed up, the answer streamed into ``out``."""
    from variantcalling_tpu_torch.serve import transport

    body = {"model": world["model"], "model_name": world["model_name"], "reference": world["fasta"],
            "output_name": out.name, "deadline_s": timeout, **params}
    t0 = time.perf_counter()
    code, payload = transport.client_filter(address, body, world["vcf"], str(out), token=token, timeout=timeout)
    return {"code": code, "payload": payload, "seconds": time.perf_counter() - t0}


def _within(future, bound: float):
    """``future``'s result; fails if the call outlives ``bound`` seconds."""
    check(bool(wait([future], timeout=bound).done), f"fabric: a client request outlived its {bound:.0f} s bound")
    return future.result()


def _maps(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as fh:
        return fh.read()


def _fabric_leftovers(*dirs: Path) -> list[str]:
    return sorted(str(p) for d in dirs for p in d.rglob("*") if p.is_file() and any(s in p.name
                                                                                     for s in _FABRIC_LEFTOVERS))


def phase_fabric(tmp: Path, card: str, stream: dict, pipe: dict) -> dict:
    """21. The serving fabric on the card, through the port's launcher
    (``parallel/podrun.start_fabric``): two fleets of two backends
    (``serve --fabric-backend --backend gpu``, each a process with its own
    CUDA context on the one card) and a router (``serve --fabric``, a process
    that imports no torch), started at once.

    Fleet A, on phase 4's 104,000-variant forest pickle world: a cold request
    at ``ranks=2`` (a span on each backend), warm ones at ``ranks=1`` and
    ``ranks=2``, one scoped to
    ``VCTPU_FOREST_STRATEGY=gemm``, each equal outside ``##vctpu_*`` to phase
    4's GPU output; ``/v1/status`` (``role`` router, 2 alive) and
    ``/v1/fabric/backends`` (each backend's rolling ``segment`` series); phase
    8's 5 M world at ``ranks=2`` and ``ranks=4`` (two spans a backend), the
    sha256 of the stripped bytes phase 8's default run's; while the ``ranks=4``
    request runs, the router maps neither ``libcuda`` nor ``libtorch`` (so it
    holds no CUDA context) and each backend maps ``libcuda``. A second router over the
    same backends with ``VCTPU_FABRIC_TOKENS`` and ``VCTPU_FABRIC_QUOTA=1``: no
    token 401, a wrong one 401, the right one 200 with equal bytes, and a
    second request of the principal while its first is held 429 ``quota``;
    SIGTERM: exit 0, ``drained``. Fleet A drained: every tier exit 0,
    ``drained``, no leaked thread; each backend's ``.podlog`` gives its
    ``forest_wide`` launches (> 0), its ``forest_tree_step`` launches (> 0: the
    ``gemm`` request's spans) and its peak card memory.

    Fleet B: the 5 M request at ``ranks=2``, backend 1 SIGKILLed once both
    spans are placed: 200, ``respans >= 1``, the same stripped sha256, a
    ``membership`` ``dead`` event in the router's obs stream; backend 2
    SIGKILLed, and the next request answers 502 ``backend_lost`` (or 503
    ``shed``) within its bound with no output; the router drained, exit 0.
    No ``.seg``, ``.lease``, ``.done``, ``.tmp``, partial or journal is left,
    and the routers' and drained backends' spools are gone (a SIGKILLed
    backend's spool is counted and removed).

    One ``FABRIC_DETAIL`` line: the fleets' start, each request's seconds,
    each backend's launches and peak card memory, the router's peak RSS.
    """
    import re
    import shutil
    import signal

    from variantcalling_tpu_torch.parallel import podrun

    w104, w5 = pipe["forest_pickle"]["world"], stream["world_5m"]
    want104 = _strip(pipe["forest_pickle"]["wide_gpu"]["bytes"])
    want5 = stream["stream_5m"]["default"]["stripped_sha256"]
    d = tmp / "fabric"
    d.mkdir()
    tmpdirs = {k: d / f"tmp_{k}" for k in ("a_router", "a_backends", "b_router", "b_backends", "auth_router")}
    for t in tmpdirs.values():
        t.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("VCTPU_")}
    fleets: dict = {}
    auth = None
    out: dict = {"card": card, "requests": {}}
    clients = ThreadPoolExecutor(1, thread_name_prefix="fabric-client")  # the requests held open while others run

    def stop_all():
        for h in fleets.values():
            podrun.stop_fabric(h)
        if auth is not None and auth.poll() is None:
            auth.kill()
            auth.wait(30)
        clients.shutdown(wait=False, cancel_futures=True)

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            futures = {k: pool.submit(podrun.start_fabric, str(d / k), FABRIC_BACKENDS, 240.0, env,
                                      {"TMPDIR": str(tmpdirs[f"{k}_backends"])},
                                      {"TMPDIR": str(tmpdirs[f"{k}_router"])}) for k in ("a", "b")}
            errors = []
            for k, f in futures.items():
                try:
                    fleets[k] = f.result()
                except Exception as e:  # noqa: BLE001 -- the other fleet is stopped, then this fails the phase
                    errors.append(f"fleet {k}: {e}")
            check(not errors, f"fabric: {errors}")
        out["fleet_start_s"] = time.perf_counter() - t0
        a, b = fleets["a"], fleets["b"]
        rss = _PeakRss(a.router.pid)

        def ok(label: str, address: str, world: dict, token: str | None = None, **params) -> dict:
            target = d / f"{label}.vcf"
            r = _fabric_request(address, world, target, token=token, **params)
            check(r["code"] == 200, f"fabric {label}: {r['code']} {r['payload']}")
            if world is w5:
                check(_stripped_sha256(target) == want5, f"fabric {label}: stripped sha256 differs from phase 8's")
            else:
                check(_strip(target.read_bytes()) == want104, f"fabric {label}: bytes differ from phase 4's GPU run")
            target.unlink()
            p = r["payload"]
            out["requests"][label] = {"seconds": r["seconds"], "n": p["n"], "spans": p["spans"],
                                      "respans": p["respans"]}
            return p

        # -- fleet A: the 104,000-variant world, cold and warm, auto and gemm ----------------------------------------
        ra = a.router_address
        ok("cold_ranks2", ra, w104, ranks=2)  # both backends cold: their first span each
        ok("warm_ranks1", ra, w104, ranks=1)
        ok("warm_ranks2", ra, w104, ranks=2)
        ok("gemm_ranks2", ra, w104, ranks=2, knobs={"VCTPU_FOREST_STRATEGY": "gemm"})
        _, status = _http(ra, "/v1/status")
        check(status["role"] == "router" and status["fleet"]["alive"] == FABRIC_BACKENDS, f"fabric status {status}")

        def segment_series() -> bool:
            reg = _http(ra, "/v1/fabric/backends")[1]["backends"]
            return all((b_["status"].get("endpoints") or {}).get("segment", {}).get("rolling_p50_s") for b_ in reg)

        _wait_for(segment_series, "every backend's rolling segment series in the router's registry", 30)

        # -- the 5 M world at 2 and 4 spans; the router off the card while it runs -----------------------------
        ok("stream5m_ranks2", ra, w5, ranks=2)
        ranks4 = clients.submit(ok, "stream5m_ranks4", ra, w5, ranks=4)
        _wait_for(lambda: _http(ra, "/v1/status")[1]["in_flight"] >= 1, "the ranks=4 request in flight", 60)
        router_maps = _maps(a.router.pid)
        check("libcuda" not in router_maps and "libtorch" not in router_maps, "fabric: the router maps CUDA or torch")
        check(all("libcuda" in _maps(p.pid) for p in a.backends), "fabric: a backend has not mapped libcuda")
        _within(ranks4, FABRIC_TIMEOUT_S + 60)

        # -- bearer tokens and the quota, on a second router over fleet A's backends ---------------------------------
        ready, status_file = d / "auth.router.ready", d / "auth.router.status"
        auth_env = dict(env, TMPDIR=str(tmpdirs["auth_router"]), VCTPU_FABRIC_TOKENS="sekrit:alice",
                        VCTPU_FABRIC_QUOTA="1",
                        PYTHONPATH=os.pathsep.join(p for p in (podrun.REPO, env.get("PYTHONPATH")) if p))
        auth = podrun._spawn_tier(["--fabric", "--port", "0", "--backends", ",".join(a.backend_addresses),
                                   "--ready-file", str(ready), "--status-file", str(status_file)],
                                  auth_env, str(d / "auth.router.podlog"))
        rauth = podrun._wait_ready(str(ready), auth, time.monotonic() + 60, "auth router")["address"]
        for label, token in (("no_token", None), ("wrong_token", "nope")):
            r = _fabric_request(rauth, w104, d / f"{label}.vcf", token=token, ranks=2)
            check(r["code"] == 401 and r["payload"]["status"] == "unauthorized" and not (d / f"{label}.vcf").exists(),
                  f"fabric {label}: {r['code']} {r['payload']}")
            out["requests"][label] = {"seconds": r["seconds"], "code": r["code"]}
        ok("right_token", rauth, w104, token="sekrit", ranks=2)
        # a handler releases its request's quota just after the response
        _wait_for(lambda: not _http(rauth, "/v1/status")[1]["principals"], "the quota released", 30)
        held = clients.submit(ok, "quota_held", rauth, w104, token="sekrit", ranks=2, faults=FABRIC_HOLD)
        _wait_for(lambda: _http(rauth, "/v1/status")[1]["principals"].get("alice") == 1, "the held request", 60)
        r = _fabric_request(rauth, w104, d / "quota.vcf", token="sekrit", ranks=2)
        check(r["code"] == 429 and r["payload"]["status"] == "quota" and not (d / "quota.vcf").exists(),
              f"fabric quota: {r['code']} {r['payload']}")
        out["requests"]["quota_refused"] = {"seconds": r["seconds"], "code": r["code"]}
        _within(held, FABRIC_TIMEOUT_S)
        auth.terminate()
        rc = auth.wait(60)
        doc = json.loads(status_file.read_text())
        check(rc == 0 and doc["status"] == "drained" and doc["leaked"] == [], f"fabric auth router: rc {rc}, {doc}")
        auth = None

        # -- fleet A drained: every tier clean, each backend's launches from its own log ------------------------------
        out["router_rss_bytes"] = rss.stop()
        report = podrun.stop_fabric(fleets.pop("a"))
        for tier, doc in [("router", report["router"]), *((f"backend {i}", v) for i, v in report["backends"].items())]:
            check(doc["rc"] == 0 and doc.get("status") == "drained" and doc.get("leaked") == [],
                  f"fabric A {tier}: {doc}")
        backends = []
        for i in range(1, FABRIC_BACKENDS + 1):
            found = re.findall(_DRAIN_RE, Path(f"{a.base}.backend{i}.podlog").read_text(errors="replace"))
            check(bool(found), f"fabric: backend {i} logged no launches")
            wide, tree_step, peak = (int(v) for v in found[-1])
            check(wide > 0 and tree_step > 0, f"fabric: backend {i} launched wide {wide}, tree_step {tree_step}")
            backends.append({"backend": i, "forest_wide_launches": wide, "forest_tree_step_launches": tree_step,
                             "peak_card_bytes": peak})
        out["backends"] = backends
        check(all(Path(f"{a.base}.obs.jsonl{s}").exists() for s in ("", ".backend1", ".backend2")),
              "fabric: an obs stream of fleet A is missing")

        # -- fleet B: a backend SIGKILLed mid-request, then the other ----------------------------------------------
        rb = b.router_address
        respan = clients.submit(ok, "respan_5m", rb, w5, ranks=2)
        _wait_for(lambda: all(v["inflight"] >= 1 for v in _http(rb, "/v1/status")[1]["backends"].values()),
                  "both spans of the 5 M request placed", 120)
        os.kill(b.backends[0].pid, signal.SIGKILL)
        b.backends[0].wait(30)
        p = _within(respan, FABRIC_TIMEOUT_S + 60)
        check(p["respans"] >= 1, f"fabric respan: {p}")
        os.kill(b.backends[1].pid, signal.SIGKILL)
        b.backends[1].wait(30)
        r = _fabric_request(rb, w104, d / "lost.vcf", ranks=2, timeout=120.0)
        check(r["code"] in (502, 503) and r["payload"]["status"] in ("backend_lost", "shed")
              and r["seconds"] < 120.0 and not (d / "lost.vcf").exists(), f"fabric lost: {r}")
        out["requests"]["backend_lost"] = {"seconds": r["seconds"], "code": r["code"],
                                           "status": r["payload"]["status"]}
        report = podrun.stop_fabric(fleets.pop("b"))
        check(report["router"]["rc"] == 0 and report["router"].get("status") == "drained"
              and report["router"].get("leaked") == [], f"fabric B router: {report['router']}")
        check(all(v["rc"] == -signal.SIGKILL for v in report["backends"].values()), f"fabric B: {report['backends']}")
        events = [json.loads(ln) for ln in Path(f"{b.base}.obs.jsonl").read_text().splitlines() if ln.strip()]
        dead = [e for e in events if e.get("kind") == "membership" and e.get("action") == "dead"]
        check(len(dead) >= 1, "fabric: no membership dead event in the router's obs stream")
        out["membership_dead_events"] = len(dead)
    finally:
        stop_all()
    left = _fabric_leftovers(d)
    check(not left, f"fabric: files left {left}")
    for k in ("a_router", "a_backends", "b_router", "auth_router"):
        check(not any(tmpdirs[k].iterdir()), f"fabric: {k} spool left {sorted(tmpdirs[k].iterdir())}")
    killed = sorted(str(p) for p in tmpdirs["b_backends"].rglob("*") if p.is_file())
    out["killed_backend_spool_files"] = len(killed)
    shutil.rmtree(d)
    print("FABRIC_DETAIL " + json.dumps(out), flush=True)
    req = out["requests"]
    print(f"fabric: fleets up in {out['fleet_start_s']:.1f} s; 104k cold {req['cold_ranks2']['seconds']:.2f} s, warm "
          f"{req['warm_ranks1']['seconds']:.2f} / {req['warm_ranks2']['seconds']:.2f} s, gemm "
          f"{req['gemm_ranks2']['seconds']:.2f} s; 5 M {req['stream5m_ranks2']['seconds']:.1f} / "
          f"{req['stream5m_ranks4']['seconds']:.1f} s, re-span {req['respan_5m']['seconds']:.1f} s; backend_lost in "
          f"{req['backend_lost']['seconds']:.2f} s; bytes equal phases 4 and 8 ({card})", flush=True)
    return out


def _phase(name: str, card: str, fn, *args):
    """``fn(*args)``, then a ``PHASE_SECONDS`` line with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print("PHASE_SECONDS " + json.dumps({"phase": name, "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    return out


#: phase 13's gVCF world cut to half of chr20 (records, variants and planted drops about halved)
GVCF_SMOKE_WORLD = dict(seed=2035, length=32_222_083, n_variants=52_000, mean_block=40)
#: phase 14's report world with a dbSNP of the case's sites and 250,000 others (the trio's alike)
REPORT_SMOKE_WORLD = dict(seed=2038, length=64_444_167, n_records=104_000, control_records=20_000,
                          n_extra_dbsnp=250_000)


def main() -> int:
    t0 = time.perf_counter()
    card = phase_card()
    build_s = _phase("build", card, phase_build)
    kern = _phase("kernel", card, phase_kernel, WORLD["n_variants"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe = _phase("pipeline", card, phase_pipeline, Path(tmp), card)
        world = pipe["forest_pickle"]["world"]
        _phase("families", card, phase_families, world, Path(tmp), card)
        _phase("blacklists", card, phase_blacklists, world, Path(tmp), card)
        _phase("sidecar", card, phase_sidecar, world, Path(tmp), card)
        stream = _phase("streaming", card, phase_streaming, Path(tmp), card, world)
        train = _phase("training", card, phase_training, Path(tmp), card)
        _phase("dan_eval", card, phase_dan_eval, Path(tmp), card, train["files"])
        cov = _phase("coverage", card, phase_coverage, Path(tmp), card)
        sec = _phase("sec", card, phase_sec, Path(tmp), card)
        geno = _phase("genotypes_gvcf", card, phase_genotypes_gvcf, Path(tmp), card, {"gvcf": GVCF_SMOKE_WORLD})
        reports = _phase("reports", card, phase_reports, Path(tmp), card, geno["files"]["trio"],
                         {"report": REPORT_SMOKE_WORLD})
        feat = _phase("featuremaps", card, phase_featuremaps, Path(tmp), card)
        _phase("serve", card, phase_serve, Path(tmp), card, pipe)
        _phase("telemetry", card, phase_telemetry, Path(tmp), card, stream, pipe, train["files"], sec)
        _phase("report_chain", card, phase_report_chain, Path(tmp), card, sec, reports["files"], feat["files"])
        _phase("host_tools", card, phase_host_tools, Path(tmp), card, world)
        _phase("scaleout", card, phase_scaleout, Path(tmp), card, stream, pipe)
        _phase("fabric", card, phase_fabric, Path(tmp), card, stream, pipe)
    print("PHASE_SECONDS " + json.dumps({"phase": "all", "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
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
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": kern[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        # the card's time alone, and the wrapper's host time, beside the single launch's ms
        "device_ms": rows[name]["device_ms"], "host_ms": rows[name]["host_ms"],
        # no single PyTorch call computes a decision forest
        "library_ms": None,
        "build_s": build_s[name],
    } for name, (source, replaces, launches) in meta.items()]
    # the fit's histogram, not a TPU kernel: it replaces the XLA one-hot product; its numbers at the
    # widest level (32 nodes) of the 5 M-row tree, its launches from the first 5 M-row training run
    hist = train["gbt_hist"][5]
    kernels.append({
        "name": "gbt_hist", "route": "cuda", "source": "variantcalling_tpu_torch/csrc/gbt_hist.cu",
        "replaces": "variantcalling_tpu/models/boosting.py:74",
        "launches": train["train_5m"]["train_5m_gpu"]["launches"]["gbt_hist"],
        "max_abs_err": max(r["max_abs_err"] for r in train["gbt_hist"].values()),
        "ms": hist["ms"], "plain_ms": hist["plain_ms"], "bound_ms": hist["bound_ms"], "bound_by": hist["bound_by"],
        "device_ms": hist["device_ms"], "host_ms": hist["host_ms"],
        # the bf16 one-hot product of the reference's accelerator formulation (not bit-equal)
        "library_ms": hist["library_ms"], "build_s": build_s["gbt_hist"],
    })
    # the CNV Viterbi, not a TPU kernel: it replaces the XLA lax.scan; its numbers on chr20 at 1 kb (the
    # shape of phase 11's cnv_calling run), its launches from that run
    vit = cov["viterbi"]["chr20_1kb"]
    kernels.append({
        "name": "cnv_viterbi", "route": "cuda", "source": "variantcalling_tpu_torch/csrc/cnv_viterbi.cu",
        "replaces": "variantcalling_tpu/cnv/caller.py:57", "launches": cov["cnv"]["launches"],
        "max_abs_err": vit["max_abs_err"], "ms": vit["ms"], "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
        "bound_by": vit["bound_by"], "device_ms": vit["device_ms"], "host_ms": vit["host_ms"],
        # no single PyTorch call computes a Viterbi path
        "library_ms": None, "build_s": build_s["cnv_viterbi"],
    })
    left = stop_processes()
    check(not left, f"processes left running by the phases: {left}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--time-kernel" and sys.argv[2] in ("wide", "tree_step"):
        sys.exit(time_kernel(sys.argv[2], sys.argv[3]))
    check(len(sys.argv) == 1, "usage: python3 chip_smoke.py [--time-kernel {wide,tree_step} CHECKOUT_ROOT]")
    _adopt_orphans()
    try:
        rc = main()
    finally:  # also when a phase failed
        stop_processes(kill=True)
    sys.exit(rc)
