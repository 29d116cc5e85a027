"""CLI dispatch: ``python -m variantcalling_tpu_torch <tool> <args>``.

Counterpart of ``variantcalling_tpu/__main__.py``; the port serves
``filter_variants_pipeline``, ``train_models_pipeline``,
``training_prep_pipeline``, ``train_dan``, ``evaluate_concordance``,
``coverage_analysis``, ``cnv_calling``, the four SEC tools
(``sec_training``, ``correct_systematic_errors``, ``sec_validation``,
``assess_sec_concordance``), ``run_comparison_pipeline``,
``vcfeval_flavors``, the genotype tools ``correct_genotypes_by_imputation``
and ``convert_haploid_regions``, the gVCF tools ``compress_gvcf``,
``cleanup_gvcf_before_calling``, ``gvcf_hcr`` and
``denovo_recalibrated_qualities``, ``find_runs_bed``, the report tools
``run_no_gt_report``, ``joint_calling_report`` and
``substitution_error_rate_report``, and the fingerprinting tools
``quick_fingerprinting`` and ``training_set_consistency_check``, the
single-read SNV and MRD tools ``srsnv_training``, ``srsnv_inference`` and
``mrd_analysis``, the LPR pair ``train_lib_prep_recalibration_model`` and
``filter_vcf_with_lib_prep_recalibration_model``,
``calibrate_bridging_snvs``, and the methylation tools
``concat_methyldackel_csvs``, ``process_mbias``, ``process_merge_context``,
``process_merge_context_no_cp_g`` and ``process_per_read``, the resident
daemon ``serve``, the somatic composites ``run_somatic_comparison_and_graphs``
and ``detailed_var_report``, and the registry and telemetry tools ``knobs``
and ``obs``: 41 tools. Each tool is a module exposing ``run(argv)``,
imported when called.
"""

from __future__ import annotations

import importlib
import logging
import sys

TOOLS: dict[str, str] = {
    "knobs": "variantcalling_tpu_torch.knobs",
    "obs": "variantcalling_tpu_torch.obs.cli",
    "filter_variants_pipeline": "variantcalling_tpu_torch.pipelines.filter_variants",
    "train_models_pipeline": "variantcalling_tpu_torch.pipelines.train_models",
    "training_prep_pipeline": "variantcalling_tpu_torch.pipelines.training_prep",
    "train_dan": "variantcalling_tpu_torch.pipelines.train_dan",
    "evaluate_concordance": "variantcalling_tpu_torch.pipelines.evaluate_concordance",
    "coverage_analysis": "variantcalling_tpu_torch.pipelines.coverage_analysis",
    "cnv_calling": "variantcalling_tpu_torch.pipelines.cnv_calling",
    "sec_training": "variantcalling_tpu_torch.pipelines.sec.sec_training",
    "correct_systematic_errors": "variantcalling_tpu_torch.pipelines.sec.correct_systematic_errors",
    "sec_validation": "variantcalling_tpu_torch.pipelines.sec.sec_validation",
    "assess_sec_concordance": "variantcalling_tpu_torch.pipelines.sec.assess_sec_concordance",
    "run_comparison_pipeline": "variantcalling_tpu_torch.pipelines.run_comparison",
    "vcfeval_flavors": "variantcalling_tpu_torch.pipelines.vcfeval_flavors",
    "correct_genotypes_by_imputation": "variantcalling_tpu_torch.pipelines.correct_genotypes_by_imputation",
    "convert_haploid_regions": "variantcalling_tpu_torch.pipelines.convert_haploid_regions",
    "compress_gvcf": "variantcalling_tpu_torch.pipelines.compress_gvcf",
    "cleanup_gvcf_before_calling": "variantcalling_tpu_torch.pipelines.cleanup_gvcf_before_calling",
    "gvcf_hcr": "variantcalling_tpu_torch.pipelines.gvcf_hcr",
    "denovo_recalibrated_qualities": "variantcalling_tpu_torch.pipelines.denovo_recalibrated_qualities",
    "find_runs_bed": "variantcalling_tpu_torch.pipelines.misc.find_runs_bed",
    "run_no_gt_report": "variantcalling_tpu_torch.pipelines.run_no_gt_report",
    "joint_calling_report": "variantcalling_tpu_torch.pipelines.joint_calling_report",
    "substitution_error_rate_report": "variantcalling_tpu_torch.pipelines.substitution_error_rate_report",
    "quick_fingerprinting": "variantcalling_tpu_torch.pipelines.quick_fingerprinting",
    "training_set_consistency_check": "variantcalling_tpu_torch.pipelines.training_set_consistency_check",
    "srsnv_training": "variantcalling_tpu_torch.pipelines.srsnv.srsnv_training",
    "srsnv_inference": "variantcalling_tpu_torch.pipelines.srsnv.srsnv_inference",
    "mrd_analysis": "variantcalling_tpu_torch.pipelines.mrd_analysis",
    "train_lib_prep_recalibration_model": "variantcalling_tpu_torch.pipelines.lpr.train_lib_prep_recalibration_model",
    "filter_vcf_with_lib_prep_recalibration_model":
        "variantcalling_tpu_torch.pipelines.lpr.filter_vcf_with_lib_prep_recalibration_model",
    "calibrate_bridging_snvs": "variantcalling_tpu_torch.pipelines.calibrate_bridging_snvs",
    "concat_methyldackel_csvs": "variantcalling_tpu_torch.pipelines.methylation.concat_methyldackel_csvs",
    "process_mbias": "variantcalling_tpu_torch.pipelines.methylation.process_mbias",
    "process_merge_context": "variantcalling_tpu_torch.pipelines.methylation.process_merge_context",
    "process_merge_context_no_cp_g": "variantcalling_tpu_torch.pipelines.methylation.process_merge_context_no_cp_g",
    "process_per_read": "variantcalling_tpu_torch.pipelines.methylation.process_per_read",
    "serve": "variantcalling_tpu_torch.serve.cli",
    "run_somatic_comparison_and_graphs": "variantcalling_tpu_torch.pipelines.run_somatic_comparison_and_graphs",
    "detailed_var_report": "variantcalling_tpu_torch.pipelines.detailed_var_report",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in {"-h", "--help"}:
        print("usage: python -m variantcalling_tpu_torch <tool> [tool args]\n\ntools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool: {tool!r}; run with --help for the tool list", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    from variantcalling_tpu_torch import knobs

    knobs.warn_unknown_env()  # a misspelt VCTPU_* name configures nothing: say so
    result = importlib.import_module(TOOLS[tool]).run(argv[1:])
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(main())
