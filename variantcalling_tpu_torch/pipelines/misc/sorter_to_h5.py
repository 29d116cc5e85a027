"""sorter_to_h5 — the sorter's stats (CSV and JSON) in one metrics h5.

Counterpart of ``variantcalling_tpu/pipelines/misc/sorter_to_h5.py``,
without pandas, with the same arguments (a host tool: no ``--backend``):
the CSV as ``pd.read_csv`` types it (``utils/frame_ops.read_csv``) under
``stats``, the JSON's scalars flattened as ``pd.json_normalize`` flattens
them (nested keys joined with ``.``) under ``scalar_stats``, both renamed
by the optional mapping CSV.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from variantcalling_tpu_torch.utils.frame_ops import read_csv
from variantcalling_tpu_torch.utils.h5_utils import Frame, object_column, write_frames

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="sorter_to_h5", description=run.__doc__)
    ap.add_argument("--input_csv_file", required=True, help="sorter stats csv")
    ap.add_argument("--input_json_file", required=True, help="sorter scalar stats json")
    ap.add_argument("--metric_mapping_file", default=None,
                    help="optional csv mapping sorter metric names -> report names")
    ap.add_argument("--output_file", required=True, help="output h5")
    return ap.parse_args(argv)


def _flatten(data: dict, prefix: str, out: dict) -> dict:
    for key, value in data.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            _flatten(value, name, out)
        else:
            out[name] = value
    return out


def json_normalize(data: dict) -> Frame:
    """``pd.json_normalize(data)`` of one JSON object: its non-object values
    first, then its nested objects' values under ``a.b`` names (an empty
    object gives none); one row, each column typed as pandas types one value
    (int64, float64, bool, else objects)."""
    flat = {k: v for k, v in data.items() if not isinstance(v, dict)}
    flat.update(_flatten({k: v for k, v in data.items() if isinstance(v, dict)}, "", {}))
    cols = {}
    for name, v in flat.items():
        if isinstance(v, bool):
            cols[name] = np.array([v], dtype=bool)
        elif isinstance(v, int) and -(1 << 63) <= v < (1 << 63):
            cols[name] = np.array([v], dtype=np.int64)
        elif isinstance(v, float):
            cols[name] = np.array([v], dtype=np.float64)
        else:
            cols[name] = object_column([v])
    return Frame(cols)


def run(argv) -> int:
    """Convert sorter csv+json stats into a keyed h5."""
    args = parse_args(argv)
    stats = read_csv(args.input_csv_file)
    with open(args.input_json_file) as fh:
        scalars = json.load(fh)
    if args.metric_mapping_file:
        mapping = read_csv(args.metric_mapping_file)
        first, second = (np.asarray(v).tolist() for v in list(mapping.values())[:2])
        cols = dict(zip(first, second))
        stats = {cols.get(k, k): v for k, v in stats.items()}
        scalars = {cols.get(k, k): v for k, v in scalars.items()}
    flat = json_normalize(scalars)
    write_frames(args.output_file, {"stats": Frame(stats), "scalar_stats": flat})
    log.info("sorter stats (%d rows, %d scalars) -> %s", len(Frame(stats)), len(flat.columns), args.output_file)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
