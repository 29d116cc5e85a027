"""add_ml_tags_bam — write per-flow probability tags into a uBAM.

Counterpart of ``variantcalling_tpu/pipelines/add_ml_tags_bam.py``, with the
same arguments (a host tool: no ``--backend``) and the same tags:

- ``kr:B:c`` — the regressed flow key (hmer length per flow, clipped 0..127);
- ``kh:B:c`` / ``kf:B:i`` / ``kd:B:c`` — alternative hmer calls: for every
  (flow, class) whose probability is at least ``--probability_threshold``
  and is not the called class, the class, its flow index, and the scaled
  phred of p_alt/p_called.

Inputs: the probability tensor (reads x flows x classes; ``.npy`` or raw
``.bin`` float32 with ``--n_flows/--n_classes``), memory-mapped, not loaded
whole, and optionally the regressed key (reads x flows; default the
per-flow argmax). The reference computes one read's tags a call
(:func:`read_tags`, kept here as the plain spec); the port computes a block
of reads at once (:func:`block_tags`) with the same float32 operations, so
the bytes are equal: ``np.round`` half to even, the ``int8`` clip, the
``1e-10`` floors. Records keep every byte and get their tags appended; read
order must match the tensor's first axis.
"""

from __future__ import annotations

import argparse
import logging
import struct
import sys

import numpy as np

from variantcalling_tpu_torch.io import bam
from variantcalling_tpu_torch.io.bgzf import BgzfWriter

log = logging.getLogger(__name__)

DEFAULT_FLOW_ORDER = "TGCA"
#: reads a block of :func:`block_tags`
BLOCK_READS = 1024


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="add_ml_tags_bam", description=run.__doc__)
    ap.add_argument("--probability_tensor", required=True, help="npy/bin (reads, flows, classes)")
    ap.add_argument("--regressed_key", default=None, help="npy/bin (reads, flows); default argmax")
    ap.add_argument("--input_ubam", required=True)
    ap.add_argument("--output_ubam", required=True)
    ap.add_argument("--flow_order", default=DEFAULT_FLOW_ORDER)
    ap.add_argument("--n_flows", type=int, default=None)
    ap.add_argument("--n_classes", type=int, default=None)
    ap.add_argument("--probability_threshold", type=float, default=0.003)
    ap.add_argument("--probability_scaling_factor", type=float, default=10.0)
    return ap.parse_args(argv)


def load_tensor(path: str, n_flows: int | None, n_classes: int | None) -> np.ndarray:
    """The tensor memory-mapped: a ``.npy`` as saved, a ``.bin`` as float32 (reads, n_flows, n_classes)."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if n_flows is None or n_classes is None:
        raise SystemExit("--n_flows/--n_classes required for .bin tensors")
    raw = np.memmap(path, dtype=np.float32, mode="r")
    return raw.reshape(-1, n_flows, n_classes)


def read_tags(probs: np.ndarray, key: np.ndarray, threshold: float, sf: float) -> bytes:
    """Tag bytes for one read from its (flows, classes) probabilities (the reference's rule)."""
    called = np.clip(key.astype(np.int64), 0, probs.shape[1] - 1)
    p_called = np.maximum(probs[np.arange(len(key)), called], 1e-10)
    alt_flows, alt_classes = np.nonzero(probs >= threshold)
    keep = probs[alt_flows, alt_classes] >= threshold
    not_called = alt_classes != called[alt_flows]
    alt_flows, alt_classes = alt_flows[keep & not_called], alt_classes[keep & not_called]
    ratios = probs[alt_flows, alt_classes] / p_called[alt_flows]
    kd = np.clip(np.round(-sf * np.log10(np.maximum(ratios, 1e-10))), -127, 127).astype(np.int8)

    out = bytearray()
    kr8 = np.clip(key, 0, 127).astype(np.int8)
    out += b"krBc" + struct.pack("<I", len(kr8)) + kr8.tobytes()
    out += b"khBc" + struct.pack("<I", len(alt_classes)) + np.clip(alt_classes, 0, 127).astype(np.int8).tobytes()
    out += b"kfBi" + struct.pack("<I", len(alt_flows)) + alt_flows.astype(np.int32).tobytes()
    out += b"kdBc" + struct.pack("<I", len(kd)) + kd.tobytes()
    return bytes(out)


def block_tags(probs: np.ndarray, key: np.ndarray, threshold: float, sf: float) -> list[bytes]:
    """:func:`read_tags` of each read of a block ((reads, flows, classes)
    probabilities, (reads, flows) keys), every elementwise step over the
    whole block in the reference's dtypes."""
    n, n_flows, n_classes = probs.shape
    called = np.clip(key.astype(np.int64), 0, n_classes - 1)
    p_called = np.maximum(np.take_along_axis(probs, called[..., None], axis=2)[..., 0], 1e-10)
    flat = np.flatnonzero(probs >= threshold)  # row-major: by read, flow, class, as nonzero orders them
    reads, rem = np.divmod(flat, n_flows * n_classes)
    alt_flows, alt_classes = np.divmod(rem, n_classes)
    keep = alt_classes != called[reads, alt_flows]
    reads, alt_flows, alt_classes = reads[keep], alt_flows[keep], alt_classes[keep]
    ratios = probs[reads, alt_flows, alt_classes] / p_called[reads, alt_flows]
    kd = np.clip(np.round(-sf * np.log10(np.maximum(ratios, 1e-10))), -127, 127).astype(np.int8)
    kr8 = np.clip(key, 0, 127).astype(np.int8)
    kh = np.clip(alt_classes, 0, 127).astype(np.int8)
    kf = alt_flows.astype("<i4")
    bounds = np.searchsorted(reads, np.arange(n + 1))
    kr_head = b"krBc" + struct.pack("<I", n_flows)
    out = []
    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        count = struct.pack("<I", hi - lo)
        out.append(b"".join((kr_head, kr8[i].tobytes(), b"khBc", count, kh[lo:hi].tobytes(), b"kfBi", count,
                             kf[lo:hi].tobytes(), b"kdBc", count, kd[lo:hi].tobytes())))
    return out


def run(argv) -> int:
    """Append flow-probability tags to every uBAM record."""
    args = parse_args(argv)
    probs = load_tensor(args.probability_tensor, args.n_flows, args.n_classes)
    key = load_tensor(args.regressed_key, args.n_flows, 1).reshape(probs.shape[0], -1) if args.regressed_key \
        else None

    buf = bam.read_stream(args.input_ubam)
    try:
        first = bam.header_end(buf)
    except ValueError:
        raise SystemExit(f"{args.input_ubam}: not a BAM") from None
    starts, sizes = bam.record_offsets(buf, first)
    if len(starts) > probs.shape[0]:
        raise SystemExit(f"probability tensor has {probs.shape[0]} reads; BAM has more")
    tags: list[bytes] = []
    for lo in range(0, len(starts), BLOCK_READS):
        hi = min(lo + BLOCK_READS, len(starts))
        block = np.asarray(probs[lo:hi])
        k = np.asarray(key[lo:hi]) if key is not None else block.argmax(axis=2)
        tags += block_tags(block, k, args.probability_threshold, args.probability_scaling_factor)
    extra = np.frombuffer(b"".join(tags), dtype=np.uint8)
    lens = np.fromiter(map(len, tags), dtype=np.int64, count=len(tags))
    with BgzfWriter(args.output_ubam) as out:
        out.write(bam.append_to_records(buf, first, starts, sizes, extra, lens))
    log.info("tagged %d reads -> %s", len(starts), args.output_ubam)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
