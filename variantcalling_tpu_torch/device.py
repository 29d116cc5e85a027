"""Run device resolution: ``cuda`` unless the caller asks for the CPU.

Resolved once per run by the entry point and passed down explicitly.
Asking for the card when there is none is an error — a run never carries
on on the CPU by itself. A run is one process on one device:
:func:`multi_rank` names the knobs of a launch that asks for more.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this host (CLI exit 2)."""


def resolve(backend: str = "gpu") -> torch.device:
    """``"gpu"``/``"cuda"`` -> the current CUDA device; ``"cpu"`` -> the CPU."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "--backend gpu was requested but torch sees no CUDA device; "
                "rerun with --backend cpu to score on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown backend {backend!r} (expected gpu or cpu)")


def as_device(device: torch.device | str) -> torch.device:
    """A ``torch.device`` as given, or a backend name through :func:`resolve`."""
    return resolve(device) if isinstance(device, str) else device


def multi_rank() -> str | None:
    """The knobs that ask for more than one rank, as text for a message, if
    any: the tools that run one process on the whole input refuse them
    (``train_dan``, ``sec_training``: their collectives are ``ROADMAP.md``
    A7c). The filter runs such a launch as one worker of a pod
    (``parallel/rank_plan``)."""
    from variantcalling_tpu_torch import knobs

    span, rank, ranks = knobs.get_str("VCTPU_SPAN"), knobs.get_int("VCTPU_RANK"), knobs.get_int("VCTPU_NUM_PROCESSES")
    if span:
        return f"VCTPU_SPAN={span}"
    if (ranks or 1) > 1 or (rank or 0) > 0:
        return f"VCTPU_RANK={rank} VCTPU_NUM_PROCESSES={ranks}"
    return None
