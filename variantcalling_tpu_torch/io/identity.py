"""Run identity: what makes a run's scored bytes a function of its input.

Counterpart of ``variantcalling_tpu/io/identity.py``. Two subsystems must
agree byte for byte on "the same configuration":

- the resume journal (``io/journal.py``): committed chunks carry the old
  run's scores, so resuming under another model, flags or engine would
  commit a mixed output;
- the chunk-result cache (``io/chunk_cache.py``): a cached rendered body may
  replay into a run only when every input of the scores is the same, and
  must still replay when only execution knobs (IO threads) changed.

Both build their identity from :func:`scoring_config`, so a field added to
one cannot be missing from the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib


def input_signature(path: str) -> list[int]:
    """Cheap identity of a referenced file: (size, mtime_ns)."""
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def file_sig(path: str | None) -> list | None:
    """``[abspath, size, mtime_ns]`` of an optional referenced file."""
    return None if not path else [os.path.abspath(path), *input_signature(path)]


def scoring_fields(args) -> dict:
    """The flags and files that change the TREE_SCORE or FILTER a record
    gets. Keys and value spellings are the reference's: renaming one
    invalidates (safely: recompute) every persisted identity."""
    return {
        "model_file": file_sig(getattr(args, "model_file", None)),
        "model_name": getattr(args, "model_name", None),
        "runs_file": file_sig(getattr(args, "runs_file", None)),
        "blacklist": file_sig(getattr(args, "blacklist", None)),
        "blacklist_cg_insertions": bool(getattr(args, "blacklist_cg_insertions", False)),
        "hpol": [int(v) for v in getattr(args, "hpol_filter_length_dist", [10, 10])],
        "flow_order": getattr(args, "flow_order", "TGCA"),
        "is_mutect": bool(getattr(args, "is_mutect", False)),
        "annotate_intervals": sorted(os.path.abspath(p) for p in (getattr(args, "annotate_intervals", None) or [])),
    }


def scoring_config(args, engine: str, forest_strategy: str, model_family: str,
                   model_digest: str | None = None) -> dict:
    """The full scoring configuration: the args' fields plus the run's
    resolved engine (``cuda`` or ``torch-cpu``: threshold and DAN scores
    differ within their tolerance between the card and the CPU, so a partial
    written on one never resumes on the other), forest strategy, model
    family and, for a DAN, the digest of its weights (one pickle holds
    several families). The journal's ``config`` and the cache's fingerprint
    input. The port scores on one device and one rank: ``mesh_devices``,
    ``ranks`` and ``span`` keep the reference's keys at those values."""
    cfg = scoring_fields(args)
    cfg["engine"] = engine
    cfg["forest_strategy"] = forest_strategy
    cfg["mesh_devices"] = 1
    cfg["ranks"] = [0, 1]
    cfg["span"] = None
    cfg["model_family"] = model_family
    cfg["model_digest"] = model_digest
    return cfg


def cache_identity(config: dict) -> dict:
    """The chunk cache's partition-agnostic view of a scoring config:
    ``ranks`` and ``span`` removed (record bytes never depend on them)."""
    cfg = dict(config)
    cfg.pop("ranks", None)
    cfg.pop("span", None)
    return cfg


def resume_meta(args, chunk_bytes: int, header_bytes: bytes, config: dict) -> dict:
    """The journal header's identity: the exact input file, chunking and
    output header a partial was written under, around the scoring
    ``config``. Chunk boundaries are a function of (input bytes,
    chunk_bytes), so pinning both makes "skip the journaled prefix" safe."""
    return {
        "input": os.path.abspath(args.input_file),
        "input_sig": input_signature(args.input_file),
        "chunk_bytes": int(chunk_bytes),
        "header_len": len(header_bytes),
        "header_crc": zlib.crc32(header_bytes),
        "config": config,
    }


def fingerprint(config: dict) -> str:
    """sha256 over the canonical (sorted keys, compact) JSON of a config."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


def describe_mismatch(old: dict, new: dict, _prefix: str = "", _limit: int = 6) -> str:
    """Field-level diff of two identity dicts, for the log line that says
    which field invalidated a journal, e.g. ``config.engine:
    journal='cuda' run='torch-cpu'``."""
    diffs: list[str] = []

    def walk(o, n, prefix):
        if len(diffs) >= _limit:
            return
        if isinstance(o, dict) and isinstance(n, dict):
            for k in sorted(set(o) | set(n)):
                walk(o.get(k), n.get(k), f"{prefix}.{k}" if prefix else str(k))
            return
        if o != n:
            diffs.append(f"{prefix}: journal={o!r} run={n!r}")

    walk(old, new, _prefix)
    if not diffs:
        return "no field-level difference (type/shape change)"
    return "; ".join(diffs[:_limit])
