"""index_vcf_file — build the .tbi index of a BGZF VCF in process.

Counterpart of ``variantcalling_tpu/pipelines/misc/index_vcf_file.py``, with
the same argument (a host tool: no ``--backend``). A plain ``.vcf`` is
BGZF-compressed to ``.vcf.gz`` first: its text as the reference reads it
(UTF-8, universal newlines, so ``\\r\\n`` and ``\\r`` end a line as ``\\n``)
written in one piece; BGZF blocks are cut at every 65,280 bytes of the
stream whatever the writes, so the blocks are the reference's. Then
``io/tabix`` writes the index; the ``.tbi`` path is printed.
"""

from __future__ import annotations

import argparse
import logging
import sys

from variantcalling_tpu_torch.io.bgzf import BgzfWriter
from variantcalling_tpu_torch.io.tabix import build_tabix_index

log = logging.getLogger(__name__)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="index_vcf_file", description=run.__doc__)
    ap.add_argument("input", help="VCF (.vcf -> recompressed to .vcf.gz first, or .vcf.gz)")
    return ap.parse_args(argv)


def run(argv) -> int:
    """BGZF-compress (if needed) and tabix-index a VCF."""
    args = parse_args(argv)
    path = args.input
    if not path.endswith(".gz"):
        gz = path + ".gz"
        with open(path, "rb") as src:
            text = src.read().decode("utf-8")
        if "\r" in text:
            text = text.replace("\r\n", "\n").replace("\r", "\n")
        with BgzfWriter(gz) as dst:
            dst.write(text.encode("utf-8"))
        path = gz
    tbi = build_tabix_index(path)
    log.info("indexed %s -> %s", path, tbi)
    print(tbi)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
