"""remove_empty_files — delete the zero-length files of a list.

Counterpart of ``variantcalling_tpu/pipelines/misc/remove_empty_files.py``,
with the same arguments (a host tool: no ``--backend``): it prints how many
files it removed (with ``--dry_run``, would remove) and logs each.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="remove_empty_files", description=run.__doc__)
    ap.add_argument("paths", nargs="+", help="files to check")
    ap.add_argument("--dry_run", action="store_true")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Remove empty files from the argument list."""
    args = parse_args(argv)
    removed = 0
    for p in args.paths:
        if os.path.isfile(p) and os.path.getsize(p) == 0:
            if not args.dry_run:
                os.remove(p)
            removed += 1
            log.info("removed empty file %s", p)
    print(removed)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
