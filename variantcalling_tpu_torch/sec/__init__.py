"""SEC, systematic error correction: the cohort noise DB and the per-locus test."""
