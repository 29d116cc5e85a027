"""Per-stage timing records of the port's tools.

Each stage of a run logs ``stage <name> <seconds> s`` at INFO
(:data:`STAGE_LOG`), the record that ``chip_smoke.py`` sums a run's stages
from. Every tool times its stages with :func:`stage`.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger(__name__)

#: format of the per-stage timing log records (the stage name, then seconds)
STAGE_LOG = "stage %s %.3f s"


@contextlib.contextmanager
def stage(name: str, device=None):
    """Log the host wall seconds of one stage at INFO; where ``device`` is a
    CUDA device, after synchronizing it, so the time holds the card's work.
    A stage without ``device`` that touches the card ends in a copy to the
    host, which waits for that work."""
    t0 = time.perf_counter()
    yield
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)
    log.info(STAGE_LOG, name, time.perf_counter() - t0)
