"""SEC correction: score observed allele counts against the cohort noise DB.

Counterpart of ``variantcalling_tpu/sec/caller.py``. For every callset
variant at a DB locus the test is the batched multinomial likelihood
ratio (:mod:`ops.stats`): how likely are the observed AD counts under the
cohort noise distribution, relative to their own best fit? A high ratio
means the observation looks like the noise seen across the cohort, and the
call is corrected (FILTER gains ``SEC``). The ratio is one fused
elementwise pass over (N, 5) rows on the run's device; ``torch.lgamma``
is not XLA's ``gammaln``, so ratios agree with the reference's to a
stated relative tolerance, not bit for bit.

``observed_allele_counts`` reads AD from the native scan's arrays where
they give the loop's answer by construction (:func:`_scan_rows`), and
parses the text, as the reference does, for every other record.
"""

from __future__ import annotations

import numpy as np
import torch

from variantcalling_tpu_torch import device as device_mod
from variantcalling_tpu_torch.ops.stats import correct_multinomial_frequencies, multinomial_log_pmf
from variantcalling_tpu_torch.sec.db import N_ALLELE_SLOTS, SecDb

DEFAULT_NOISE_RATIO = 0.1  # ratio above this -> noise-consistent -> SEC


def noise_likelihood_ratio(observed: torch.Tensor, noise_counts: torch.Tensor) -> torch.Tensor:
    """(N,) likelihood ratio of observed (N, A) counts under noise (N, A), on their device."""
    p_noise = correct_multinomial_frequencies(noise_counts)
    log_l = multinomial_log_pmf(observed, p_noise)
    log_max = multinomial_log_pmf(observed, correct_multinomial_frequencies(observed))
    return torch.exp(log_l - log_max)


def _counts_from_text(table, max_alts: int) -> np.ndarray:
    """The reference's loop: FORMAT/AD through ``format_numeric``, missing
    and negative values as 0, alts past ``max_alts`` summed into ``other``."""
    ad = table.format_numeric("AD")
    out = np.zeros((len(table), N_ALLELE_SLOTS), dtype=np.float32)
    if ad.shape[1] == 0:
        return out
    valid = np.where(ad >= 0, ad, 0.0)
    out[:, 0] = valid[:, 0]
    k = min(max_alts, ad.shape[1] - 1)
    if k > 0:
        out[:, 1: 1 + k] = valid[:, 1: 1 + k]
    if ad.shape[1] - 1 > max_alts:
        out[:, -1] = valid[:, 1 + max_alts:].sum(axis=1)
    return out


def _span_bytes(buf: np.ndarray, a: np.ndarray, b: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8: the bytes of each span [a, b), 0 past its end."""
    idx = a[:, None] + np.arange(width)
    return np.where(idx < b[:, None], buf[np.minimum(idx, max(len(buf) - 1, 0))], 0).astype(np.uint8)


#: the longest sample-0 AD field the fast path reads (two counts of up to 15 digits and a comma)
_AD_WIDTH = 31


def _scan_rows(table) -> np.ndarray:
    """Records whose sample-0 AD is exactly ``<digits>,<digits>``, located in
    the text by the FORMAT key's index (one lookup a distinct FORMAT, where
    ``AD`` appears once): for these the scan's two values are the loop's
    answer, since a string of digits parses to the same float in the scan
    and in ``float()``, and nothing lies past the first alt."""
    aux = table.aux
    n, buf = len(table), aux.buf
    t0, t1 = aux.tail_spans[:, 0], aux.tail_spans[:, 1]
    # byte offsets of every tab and colon, each closed by a sentinel at the buffer's end
    tabs = np.append(np.flatnonzero(buf == ord("\t")), len(buf))
    colons = np.append(np.flatnonzero(buf == ord(":")), len(buf))
    f_end = tabs[np.searchsorted(tabs, t0)]  # FORMAT is [t0, f_end), sample 0 is [s0, s1)
    s0 = f_end + 1
    s1 = np.minimum(tabs[np.minimum(np.searchsorted(tabs, s0), len(tabs) - 1)], t1)
    has = (t1 > t0) & (f_end < t1)
    # AD's index among the FORMAT keys, found once for each distinct FORMAT (its bytes and length)
    k = np.full(n, -1, dtype=np.int64)
    if has.any():
        lens = np.where(has, f_end - t0, 0)
        key = np.concatenate([_span_bytes(buf, t0, t0 + lens, int(lens.max())),
                              lens.astype("<u4").view(np.uint8).reshape(n, 4)], axis=1)
        uniq, inv = np.unique(np.ascontiguousarray(key).view(np.dtype((np.void, key.shape[1]))).reshape(n),
                              return_inverse=True)
        at = []
        for u in uniq:
            raw = bytes(u)
            keys = raw[: int(np.frombuffer(raw[-4:], "<u4")[0])].split(b":")
            at.append(keys.index(b"AD") if keys.count(b"AD") == 1 else -1)
        k = np.where(has, np.asarray(at, dtype=np.int64)[inv.reshape(n)], -1)
    # the AD field: from sample 0's start (k == 0) or past its k-th colon, to the next colon or the sample's end
    kth = colons[np.clip(np.searchsorted(colons, s0) + k - 1, 0, len(colons) - 1)]
    ok = (k == 0) | ((k > 0) & (kth < s1))
    a = np.where(ok, np.where(k == 0, s0, kth + 1), 0)
    b = np.where(ok, np.minimum(colons[np.minimum(np.searchsorted(colons, a), len(colons) - 1)], s1), 0)
    ok &= (b - a >= 3) & (b - a <= _AD_WIDTH)
    text = _span_bytes(buf, np.where(ok, a, 0), np.where(ok, b, 0), _AD_WIDTH)
    digit = (text >= ord("0")) & (text <= ord("9"))
    commas = (text == ord(",")).sum(axis=1)
    last = text[np.arange(n), np.clip(b - a - 1, 0, _AD_WIDTH - 1)]
    return ok & (commas == 1) & (digit.sum(axis=1) + commas == b - a) & digit[:, 0] & (last >= ord("0")) \
        & (last <= ord("9"))


def observed_allele_counts(table, max_alts: int = N_ALLELE_SLOTS - 2) -> np.ndarray:
    """(N, N_ALLELE_SLOTS) float32 counts from FORMAT/AD: ref, alt1..alt3, other."""
    if table.aux is None or len(table) == 0:
        return _counts_from_text(table, max_alts)
    fast = _scan_rows(table)
    out = np.zeros((len(table), N_ALLELE_SLOTS), dtype=np.float32)
    out[fast, :2] = table.aux.ad[fast, :2]
    rest = np.flatnonzero(~fast)
    if len(rest):
        out[rest] = _counts_from_text(table.subset(rest), max_alts)
    return out


def correct_calls(
    table,
    db: SecDb,
    noise_ratio_threshold: float = DEFAULT_NOISE_RATIO,
    device: torch.device | str = "gpu",
) -> tuple[np.ndarray, np.ndarray]:
    """(is_sec bool per record, float32 likelihood ratio per record), the
    ratios computed on ``device`` (a backend name goes through
    :func:`device.resolve`: the card unless ``"cpu"``)."""
    hit, rows = db.lookup(np.asarray(table.chrom), table.pos)
    ratios = np.zeros(len(table), dtype=np.float32)
    if not hit.any() or len(db) == 0:
        return np.zeros(len(table), dtype=bool), ratios
    r = hit_ratios(table, db, hit, rows, device)
    ratios[hit] = r
    is_sec = np.zeros(len(table), dtype=bool)
    is_sec[hit] = r > noise_ratio_threshold
    return is_sec, ratios


def hit_ratios(table, db: SecDb, hit: np.ndarray, rows: np.ndarray, device: torch.device | str) -> np.ndarray:
    """The ratio of every record at a DB locus (``hit``), on ``device``."""
    device = device_mod.as_device(device)
    obs = torch.from_numpy(observed_allele_counts(table)[hit]).to(device)
    noise = torch.from_numpy(db.counts[rows[hit]]).to(device)
    return noise_likelihood_ratio(obs, noise).cpu().numpy()
