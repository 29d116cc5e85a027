"""Library-prep recalibration (LPR): per-read SNV quality model train/apply."""
