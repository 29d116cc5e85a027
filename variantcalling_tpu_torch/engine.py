"""The run-level scoring engine, recorded in the output header.

Counterpart of ``variantcalling_tpu/engine.py``. The port has one engine
per device: ``cuda`` (torch ops plus the hand-written forest kernel on the
card) or ``torch-cpu`` (the same torch program on the CPU, with each
kernel's plain version). The engine follows the run's device, is decided
once per run, and is written as ``##vctpu_engine=<name>``.
"""

from __future__ import annotations

HEADER_KEY = "vctpu_engine"


class EngineError(RuntimeError):
    """A requested engine or strategy cannot serve this run (CLI exit 2).
    Never caught by a fallback: the run fails with a clear message."""


_NAMES = {"cuda": "cuda", "cpu": "torch-cpu"}


def engine_name(device: torch.device) -> str:
    if device.type not in _NAMES:
        raise ValueError(f"no scoring engine for device {device}")
    return _NAMES[device.type]


def resolve_request(device: torch.device) -> str:
    """A serving daemon's per-request engine: the engine of the daemon's
    device. Counterpart of the reference's ``resolve_request``, whose engine
    knobs (``VCTPU_ENGINE``, ``VCTPU_REQUIRE_NATIVE``) the port does not
    honour yet (``ROADMAP.md`` A10): scoped in a request, they are validated
    and ignored, as the CLI treats them."""
    return engine_name(device)


def header_line(name: str) -> str:
    return f"##{HEADER_KEY}={name}"
