"""Per-stage timing records of the port's tools.

Each stage of a run logs ``stage <name> <seconds> s`` at INFO
(:data:`STAGE_LOG`), the record that ``chip_smoke.py`` sums a run's stages
from, and lands as a span in the span table and the open obs stream
(:func:`utils.trace.record`). Every tool times its stages with :func:`stage`.
"""

from __future__ import annotations

import contextlib
import logging
import time

from variantcalling_tpu_torch.utils import trace

log = logging.getLogger(__name__)

#: format of the per-stage timing log records (the stage name, then seconds)
STAGE_LOG = "stage %s %.3f s"


@contextlib.contextmanager
def stage(name: str, device=None):
    """Log the host wall seconds of one stage at INFO; where ``device`` is a
    CUDA device, after synchronizing it, so the time holds the card's work.
    A stage without ``device`` that touches the card ends in a copy to the
    host, which waits for that work."""
    local = trace.TRACER._local
    local.depth += 1
    t0 = time.perf_counter()
    try:
        yield
        if getattr(device, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        log.info(STAGE_LOG, name, dt)
    finally:
        local.depth -= 1
    trace.record(name, dt, local.depth)
