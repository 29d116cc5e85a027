"""import_metrics — picard metrics files -> the long-format metrics h5.

Counterpart of ``variantcalling_tpu/pipelines/import_metrics.py``, without
pandas, with the same arguments (a host tool: no ``--backend``): every
``<prefix>*`` file is read for its picard sections
(``misc/collect_existing_metrics.read_picard_metrics``) into the (File,
Parameter, Value) table and the coverage histograms that
``create_qc_report`` reads.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from variantcalling_tpu_torch.pipelines.misc.collect_existing_metrics import read_picard_metrics
from variantcalling_tpu_torch.utils.h5_utils import Frame, concat_frames, object_column, write_frames

log = logging.getLogger(__name__)


def metrics_long_table(paths: list[str]) -> tuple[Frame, Frame]:
    """(the metrics long table, the coverage histograms) of picard-style files."""
    files, params, values = [], [], []
    cvg_frames = []
    for path in paths:
        name = os.path.basename(path)
        for suffix in (".txt", ".metrics", ".csv"):
            name = name.removesuffix(suffix)
        # the sample prefix cut: the metric-class part after the first '.'
        short = name.split(".", 1)[1] if "." in name else name
        sections = read_picard_metrics(path)
        m = sections.get("metrics")
        if m is not None and len(m):
            for col in m.columns:
                files.append(short)
                params.append(col)
                values.append(m[col][0])
        h = sections.get("histogram")
        if h is not None and len(h):
            cvg_frames.append(Frame({**h.data, "File": object_column([short] * len(h))}))
    metrics = Frame({"File": object_column(files), "Parameter": object_column(params),
                     "Value": object_column(values)}) if files else Frame({})
    cvg = concat_frames(cvg_frames) if cvg_frames else Frame({})
    cvg.index = None
    return metrics, cvg


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="import_metrics", description=run.__doc__)
    ap.add_argument("--metrics_prefix", required=True, help="glob prefix: <prefix>* files are parsed")
    ap.add_argument("--output_h5", required=True)
    return ap.parse_args(argv)


def run(argv) -> int:
    """Import a sample's picard metrics files into the QC-report h5 layout."""
    args = parse_args(argv)
    paths = sorted(p for p in glob.glob(args.metrics_prefix + "*") if os.path.isfile(p))
    metrics, cvg = metrics_long_table(paths)
    params = Frame({"value": object_column([args.metrics_prefix, str(len(paths))])},
                   object_column(["metrics_prefix", "n_files"]))
    tables = {"params": params, "metrics": metrics}
    if len(cvg):
        tables["coverage_histograms"] = cvg
    write_frames(args.output_h5, tables)
    log.info("%d metric rows from %d files -> %s", len(metrics), len(paths), args.output_h5)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
