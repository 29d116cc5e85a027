"""ONE JSON-emission helper for every CLI that dumps JSON.

Counterpart of ``variantcalling_tpu/utils/jsonio.py``: ``knobs --json``
and ``obs summary --json`` both render through :func:`render_json` / :func:`emit_json` so the CLI JSON surface
has one formatting contract (2-space indent, insertion order preserved,
trailing newline) and one place to change it.
"""

from __future__ import annotations

import json
import sys


def render_json(obj, indent: int = 2) -> str:
    """The canonical CLI JSON rendering (no trailing newline)."""
    return json.dumps(obj, indent=indent)


def emit_json(obj, stream=None) -> None:
    """Print ``obj`` as canonical CLI JSON (with trailing newline)."""
    print(render_json(obj), file=stream if stream is not None else sys.stdout)
