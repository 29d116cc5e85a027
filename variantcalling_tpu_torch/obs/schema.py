"""The obs event schema: one committed contract, one validator.

Counterpart of ``variantcalling_tpu/obs/schema.py``, the same module over
a copy of the same artifact (``event_schema.json``, version
:data:`SCHEMA_VERSION`), so a stream of either package validates under
both validators. Every line of an obs run log is a JSON object with the common envelope
(``v``/``seq``/``ts``/``t``/``kind``/``name``/``pid``/``tid``) plus its
kind's required fields. The contract lives in the committed
``event_schema.json`` next to this module, not in code, so the
export/summary readers and external consumers validate against the same
artifact, and a schema change is a reviewable diff to one file.

The validator is hand-rolled over that artifact (no jsonschema
dependency — the container doesn't ship one): type names are the small
closed set ``int``/``number``/``string``/``object``/``array``/``bool``.
Unknown kinds and extra fields are allowed (forward compatibility);
missing/mistyped REQUIRED fields are errors.
"""

from __future__ import annotations

import json
import os

SCHEMA_VERSION = 1

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "event_schema.json")
_SCHEMA: dict | None = None


def load_schema() -> dict:
    """The committed schema artifact (cached)."""
    global _SCHEMA
    if _SCHEMA is None:
        with open(_SCHEMA_PATH, encoding="utf-8") as fh:
            _SCHEMA = json.load(fh)
    return _SCHEMA


def _type_ok(value, type_name: str) -> bool:
    if type_name == "int":
        return isinstance(value, int) and not isinstance(value, bool)
    if type_name == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if type_name == "string":
        return isinstance(value, str)
    if type_name == "object":
        return isinstance(value, dict)
    if type_name == "array":
        return isinstance(value, list)
    if type_name == "bool":
        return isinstance(value, bool)
    return True  # unknown type name in the artifact: don't invent failures


def validate_event(event: dict) -> list[str]:
    """Schema errors for one event dict (empty list == valid)."""
    schema = load_schema()
    errors: list[str] = []
    if not isinstance(event, dict):
        return ["event is not a JSON object"]
    for field, type_name in schema["common"].items():
        if field not in event:
            errors.append(f"missing common field {field!r}")
        elif not _type_ok(event[field], type_name):
            errors.append(f"common field {field!r} is not a {type_name}")
    if event.get("v") != schema["schema_version"]:
        errors.append(f"schema version {event.get('v')!r} != "
                      f"{schema['schema_version']}")
    kind = event.get("kind")
    kind_spec = schema["kinds"].get(kind) if isinstance(kind, str) else None
    if kind_spec is not None:
        for field, type_name in kind_spec.get("required", {}).items():
            if field not in event:
                errors.append(f"{kind} event missing field {field!r}")
            elif not _type_ok(event[field], type_name):
                errors.append(f"{kind} field {field!r} is not a {type_name}")
    return errors


def validate_lines(lines: list[str], continuation: bool = False) -> list[str]:
    """Schema errors for a whole JSONL log, prefixed with 1-based line
    numbers; also enforces the stream-level invariants (seq strictly
    increasing from 0, ts monotonically non-decreasing, manifest first).

    ``continuation=True`` validates a ROTATION SEGMENT
    (``<log>.segN``, ``VCTPU_OBS_MAX_MB``): the manifest lives in the
    base file and ``seq`` continues from wherever the previous segment
    stopped, so those two checks anchor on the segment's first event
    instead of the stream origin."""
    errors: list[str] = []
    prev_seq: int | None = None if continuation else -1
    prev_ts = None
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except ValueError as e:
            errors.append(f"line {i}: not JSON ({e})")
            continue
        for err in validate_event(event):
            errors.append(f"line {i}: {err}")
        seq, ts = event.get("seq"), event.get("ts")
        if isinstance(seq, int):
            if prev_seq is not None and seq != prev_seq + 1:
                errors.append(f"line {i}: seq {seq} breaks the ordered "
                              f"stream (expected {prev_seq + 1})")
            prev_seq = seq
        if isinstance(ts, (int, float)) and not isinstance(ts, bool):
            if prev_ts is not None and ts < prev_ts:
                errors.append(f"line {i}: ts moved backwards "
                              f"({ts} < {prev_ts})")
            prev_ts = ts
        if i == 1 and not continuation and event.get("kind") != "manifest":
            errors.append("line 1: stream must open with the run manifest")
    return errors
