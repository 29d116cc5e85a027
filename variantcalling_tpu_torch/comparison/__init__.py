"""Callset-to-truth comparison: the haplotype-aware matcher."""
