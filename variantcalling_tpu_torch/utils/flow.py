"""Flow-space sequence encoding (Ultima flow cycles).

Counterpart of ``variantcalling_tpu/utils/flow.py``: a base sequence as
per-flow homopolymer counts for a cyclic flow order (default TGCA), by
vectorized run-length encoding: one pass builds (base, run length) pairs,
cyclic deltas place each run at its flow index, and the key is one scatter.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FLOW_ORDER = "TGCA"


def generate_key_from_sequence(sequence: str, flow_order: str = DEFAULT_FLOW_ORDER,
                               non_standard_as_a: bool = False) -> np.ndarray:
    """Flow-space key: ``key[f]`` = hmer length consumed at flow ``f``.

    Raises ValueError on a base outside the flow order unless ``non_standard_as_a``."""
    cycle = len(flow_order)
    base_to_flow = {b: i for i, b in enumerate(flow_order)}
    codes = np.frombuffer(sequence.upper().encode("ascii"), dtype=np.uint8)
    lut = np.full(256, -1, dtype=np.int8)
    for b, i in base_to_flow.items():
        lut[ord(b)] = i
    flow_idx = lut[codes]
    if (flow_idx < 0).any():
        if not non_standard_as_a:
            raise ValueError("Non-standard nucleotide in sequence")
        flow_idx = np.where(flow_idx < 0, base_to_flow["A"], flow_idx)
    if len(flow_idx) == 0:
        return np.zeros(0, dtype=np.int64)

    boundaries = np.nonzero(np.diff(flow_idx) != 0)[0] + 1
    starts = np.concatenate([[0], boundaries])
    run_bases = flow_idx[starts].astype(np.int64)
    run_lens = np.diff(np.concatenate([starts, [len(flow_idx)]]))

    # cyclic flow position of each run: advance ((next - cur - 1) mod cycle) + 1
    deltas = np.empty(len(run_bases), dtype=np.int64)
    deltas[0] = run_bases[0]  # flows skipped from the cycle's start
    if len(run_bases) > 1:
        deltas[1:] = (run_bases[1:] - run_bases[:-1] - 1) % cycle + 1
    flow_pos = np.cumsum(deltas)

    key = np.zeros(int(flow_pos[-1]) + 1, dtype=np.int64)
    key[flow_pos] = run_lens
    return key


def key_to_base_index(key: np.ndarray) -> np.ndarray:
    """Base offset at which each flow starts (the key's cumulative sum, shifted)."""
    k2base = np.cumsum(key)
    return np.concatenate([[0], k2base[:-1]])
