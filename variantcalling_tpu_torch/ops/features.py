"""Per-variant window features as torch ops (reference-context windows -> feature tensors).

Counterpart of ``variantcalling_tpu/ops/features.py``, whose functions are
plain jnp (no Pallas kernel), so plain torch here. Every function takes
and returns tensors on the caller's device and returns exactly the
reference's values and dtypes (int32 codes, float32 GC fraction).

Where the two frameworks differ:

- torch defaults to int64 where JAX uses int32: results are cast to int32.
- "first index where" uses ``cumprod`` over the boolean prefix instead of
  ``argmin``/``argmax`` ties, so the first index is taken on every device
  by construction.
- ``gc_content`` casts its counts to float32 before dividing, as JAX's
  int32 true divide does, instead of torch's integer true divide.

Window layout: ``windows[:, center]`` is the variant's anchor base
(A0 C1 G2 T3 N4); the left motif is ``windows[:, center-k:center]`` and the
right context starts at ``center + 1``.
"""

from __future__ import annotations

import torch

A, C, G, T, N = 0, 1, 2, 3, 4

DEFAULT_FLOW_ORDER = "TGCA"

_SIG_PAD = 1 << 20  # sentinel for "no run here" in flow signatures


def _leading_true(mask: torch.Tensor) -> torch.Tensor:
    """Count of leading True values per row (= index of the first False, or the width)."""
    return torch.cumprod(mask.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)


def gc_content(windows: torch.Tensor, center: int, radius: int = 10) -> torch.Tensor:
    """Fraction of G/C in the +-radius window around the anchor (N excluded from denominator)."""
    w = windows[:, center - radius: center + radius + 1]
    n_gc = ((w == G) | (w == C)).sum(dim=1, dtype=torch.int32)
    n_base = (w != N).sum(dim=1, dtype=torch.int32)
    return n_gc.to(torch.float32) / torch.clamp(n_base, min=1).to(torch.float32)


def run_length_at(windows: torch.Tensor, start: int, max_run: int = 40) -> torch.Tensor:
    """Length of the homopolymer run starting at column ``start`` (capped at max_run)."""
    span = windows[:, start: start + max_run]
    return _leading_true(span == windows[:, start: start + 1])


def hmer_indel_features(windows: torch.Tensor, center: int, is_indel: torch.Tensor,
                        indel_nuc: torch.Tensor, max_run: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """(hmer_indel_length, hmer_indel_nuc_code) per variant: an indel whose
    inserted/deleted bases are one nucleotide equal to the reference base
    after the anchor; its length is the reference run length there."""
    run_len = run_length_at(windows, center + 1, max_run=max_run)
    next_base = windows[:, center + 1].to(torch.int32)
    nuc = indel_nuc.to(torch.int32)
    is_hmer = is_indel & (nuc < 4) & (nuc == next_base)
    hmer_len = torch.where(is_hmer, run_len, torch.zeros_like(run_len))
    hmer_nuc = torch.where(is_hmer, nuc, torch.full_like(nuc, N))
    return hmer_len, hmer_nuc


def motif_codes(windows: torch.Tensor, center: int, k: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Base-5-packed left/right k-mer motif codes adjacent to the anchor."""
    powers = 5 ** torch.arange(k - 1, -1, -1, dtype=torch.int32, device=windows.device)
    left = (windows[:, center - k: center].to(torch.int32) * powers).sum(dim=1, dtype=torch.int32)
    right = (windows[:, center + 1: center + 1 + k].to(torch.int32) * powers).sum(dim=1, dtype=torch.int32)
    return left, right


def _flow_signature(hap: torch.Tensor, fo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(flow count, sorted nonzero-flow positions) per row, in closed form.

    Each maximal base run consumes ``d`` flows: the cyclic distance from the
    previous run's flow-cycle position (first run: its position + 1). The
    first N truncates the haplotype.
    """
    n, length = hap.shape
    dev = hap.device
    idx = torch.arange(length, device=dev)[None, :]
    lookup = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    lookup[fo.long()] = torch.arange(4, dtype=torch.int32, device=dev)
    pos = lookup[hap.long()]
    eff = _leading_true(hap != N)
    valid = idx < eff[:, None]
    prev_pos = torch.cat([torch.full((n, 1), -1, dtype=torch.int32, device=dev), pos[:, :-1]], dim=1)
    start = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                       hap[:, 1:] != hap[:, :-1]], dim=1) & valid
    d = torch.where(idx == 0, pos + 1, torch.remainder(pos - prev_pos, 4))
    cum = torch.cumsum(torch.where(start, d, torch.zeros_like(d)), dim=1, dtype=torch.int32)
    flows = torch.where(start, cum, torch.zeros_like(cum)).amax(dim=1)
    sig = torch.sort(torch.where(start, cum, torch.full_like(cum, _SIG_PAD)), dim=1).values
    return flows, sig


def flow_order_codes(flow_order: str, device) -> torch.Tensor:
    return torch.tensor([{"A": A, "C": C, "G": G, "T": T}[c] for c in flow_order],
                        dtype=torch.int32, device=device)


def cycle_skip_status(windows: torch.Tensor, center: int, ref_code: torch.Tensor,
                      alt_code: torch.Tensor, is_snp: torch.Tensor,
                      flow_order: str = DEFAULT_FLOW_ORDER, context: int = 4) -> torch.Tensor:
    """Cycle-skip status per variant: 0 non-skip, 1 possible cycle-skip, 2 cycle-skip, -1 NA (non-SNP).

    Compares the flow keys of the local haplotype (``context`` bases either
    side) with the ref vs the alt base at the center.
    """
    fo = flow_order_codes(flow_order, windows.device)
    left = windows[:, center - context: center].to(torch.int32)
    right = windows[:, center + 1: center + 1 + context].to(torch.int32)
    ref_hap = torch.cat([left, ref_code.to(torch.int32)[:, None], right], dim=1)
    alt_hap = torch.cat([left, alt_code.to(torch.int32)[:, None], right], dim=1)
    ref_flows, ref_sig = _flow_signature(ref_hap, fo)
    alt_flows, alt_sig = _flow_signature(alt_hap, fo)
    skip = ref_flows != alt_flows
    zero_pattern_change = (ref_sig != alt_sig).any(dim=1)
    status = torch.where(skip, 2, torch.where(zero_pattern_change, 1, 0)).to(torch.int32)
    return torch.where(is_snp, status, torch.full_like(status, -1))
