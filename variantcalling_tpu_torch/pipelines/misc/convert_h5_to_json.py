"""convert_h5_to_json — every key of a metrics h5 as one JSON document.

Counterpart of ``variantcalling_tpu/pipelines/misc/convert_h5_to_json.py``,
without pandas, with the same arguments (a host tool: no ``--backend``):
``{key: records}``, each key's rows as ``df.to_json(orient="records")``
writes them and ``json.loads`` reads them back (``utils/frame_ops.records_json``:
floats at pandas' 10 decimals, NaN and infinities ``null``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from variantcalling_tpu_torch.utils.frame_ops import records_json
from variantcalling_tpu_torch.utils.h5_utils import list_keys, read_hdf

log = logging.getLogger(__name__)


def h5_to_dict(path: str, ignored_substrings: list[str] | None = None) -> dict:
    out: dict = {}
    for name in list_keys(path):
        if ignored_substrings and any(sub in name for sub in ignored_substrings):
            continue
        out[name] = records_json(read_hdf(path, key=name))
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="convert_h5_to_json", description=run.__doc__)
    ap.add_argument("--input_h5", required=True)
    ap.add_argument("--output_json", required=True)
    ap.add_argument("--ignored_h5_key_substring", nargs="*", default=None)
    return ap.parse_args(argv)


def run(argv) -> int:
    """Convert a keyed metrics h5 into JSON."""
    args = parse_args(argv)
    data = h5_to_dict(args.input_h5, args.ignored_h5_key_substring)
    with open(args.output_json, "w") as fh:
        json.dump(data, fh, indent=2, default=str)
    log.info("%d keys -> %s", len(data), args.output_json)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
