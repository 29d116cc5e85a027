"""collect_existing_metrics — gather scattered metric files into one h5.

Counterpart of ``variantcalling_tpu/pipelines/misc/collect_existing_metrics.py``,
without pandas, with the same arguments (a host tool: no ``--backend``).
Picard-style ``.metrics`` files (``## METRICS CLASS`` / ``## HISTOGRAM``
sections, every value kept as the text it is), CSVs (read as
``pd.read_csv`` types them: ``utils/frame_ops.read_csv``) and h5s each land
under their own keys in the output h5.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from variantcalling_tpu_torch.utils.frame_ops import read_csv
from variantcalling_tpu_torch.utils.h5_utils import Frame, list_keys, object_column, read_hdf, write_hdf

log = logging.getLogger(__name__)


def read_picard_metrics(path: str) -> dict[str, Frame]:
    """The picard sections of ``path`` ('## METRICS CLASS ...', '## HISTOGRAM
    ...'): each section's first line the column names, its other lines the
    rows, as text (a short row padded with missing values)."""
    out: dict[str, Frame] = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("## METRICS CLASS") or line.startswith("## HISTOGRAM"):
            section = "metrics" if "METRICS" in line else "histogram"
            rows = []
            i += 1
            while i < len(lines) and lines[i].strip() and not lines[i].startswith("#"):
                rows.append(lines[i].split("\t"))
                i += 1
            if len(rows) >= 2:
                names, body = rows[0], rows[1:]
                if any(len(r) > len(names) for r in body):
                    raise ValueError(f"{len(names)} columns passed, passed data had "
                                     f"{max(len(r) for r in body)} columns")
                out[section] = Frame({n: object_column([r[j] if j < len(r) else None for r in body])
                                      for j, n in enumerate(names)})
        else:
            i += 1
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="collect_existing_metrics", description=run.__doc__)
    ap.add_argument("--metric_files", nargs="+", required=True)
    ap.add_argument("--output_h5", required=True)
    return ap.parse_args(argv)


def run(argv) -> int:
    """Collect metric files into one keyed h5."""
    args = parse_args(argv)
    mode = "w"
    n = 0
    for path in args.metric_files:
        stem = os.path.basename(path).split(".")[0]
        if path.endswith((".h5", ".hdf", ".hdf5")):
            tables = {f"{stem}_{key}": read_hdf(path, key=key) for key in list_keys(path)}
        elif path.endswith(".csv"):
            tables = {stem: Frame(read_csv(path))}
        else:  # picard .metrics, or any other sectioned text
            tables = {f"{stem}_{section}": df for section, df in read_picard_metrics(path).items()}
        for key, df in tables.items():
            write_hdf(df, args.output_h5, key=key, mode=mode)
            mode = "a"
            n += 1
    log.info("%d tables -> %s", n, args.output_h5)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
