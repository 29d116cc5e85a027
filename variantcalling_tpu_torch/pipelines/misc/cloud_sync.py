"""cloud_sync — localize a cloud object and print the local path.

Counterpart of ``variantcalling_tpu/pipelines/misc/cloud_sync.py``, with the
same arguments (a host tool: no ``--backend``), over ``utils/cloud``.
"""

from __future__ import annotations

import argparse
import sys

from variantcalling_tpu_torch.utils.cloud import DEFAULT_CACHE, cloud_sync


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="cloud_sync", description=run.__doc__)
    ap.add_argument("uri", help="gs://, s3://, or local path")
    ap.add_argument("--cache_dir", default=DEFAULT_CACHE)
    ap.add_argument("--force", action="store_true", help="re-download even if cached")
    return ap.parse_args(argv)


def run(argv) -> int:
    """Localize a cloud URI (prints the resulting local path)."""
    args = parse_args(argv)
    print(cloud_sync(args.uri, args.cache_dir, force=args.force))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
