"""Report tools' statistics and writers: VariantEval-style tables, no-ground-truth
statistics, mutational signatures and the self-contained HTML report."""
