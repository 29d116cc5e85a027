"""The run-level scoring engine, recorded in the output header.

Counterpart of ``variantcalling_tpu/engine.py``. The port has one engine
per device: ``cuda`` (torch ops plus the hand-written forest kernel on the
card) or ``torch-cpu`` (the same torch program on the CPU, with each
kernel's plain version). The engine follows the run's device, is decided
once per run, and is written as ``##vctpu_engine=<name>``.
"""

from __future__ import annotations

import torch

HEADER_KEY = "vctpu_engine"


class EngineError(RuntimeError):
    """A requested engine or strategy cannot serve this run (CLI exit 2).
    Never caught by a fallback: the run fails with a clear message."""


_NAMES = {"cuda": "cuda", "cpu": "torch-cpu"}


def engine_name(device: torch.device) -> str:
    if device.type not in _NAMES:
        raise ValueError(f"no scoring engine for device {device}")
    return _NAMES[device.type]


def header_line(name: str) -> str:
    return f"##{HEADER_KEY}={name}"
