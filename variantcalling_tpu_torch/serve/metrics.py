"""Request metrics of the serving daemon.

Counterpart of ``variantcalling_tpu/serve/metrics.py``. One recorder, two
sinks: the daemon's own registry, always on, which admission reads for its
early shed and ``/v1/status`` and ``/v1/metrics`` render; and the open obs
run's registry, when the daemon writes a stream, so its request series land
in the stream's final ``metrics`` snapshot.

Per-endpoint series carry a ``.by_endpoint.<endpoint>`` suffix, which the
Prometheus renderer (:mod:`obs.prom`) lifts into an ``{endpoint="..."}``
label: ``serve.request_s.by_endpoint.filter`` becomes
``vctpu_serve_request_s{endpoint="filter",...}``.
"""

from __future__ import annotations

from variantcalling_tpu_torch import knobs, obs
from variantcalling_tpu_torch.obs.metrics import MetricsRegistry

#: request statuses a counter family exists for
STATUSES = ("accepted", "ok", "failed", "shed", "deadline", "cancelled")


class ServeMetrics:
    """The daemon's request-metric recorder."""

    def __init__(self):
        self.registry = MetricsRegistry(window_s=knobs.get_float("VCTPU_OBS_WINDOW_S"))

    def _counter(self, name: str):
        self.registry.counter(name).add(1)
        obs.counter(name).add(1)  # a no-op without a stream

    def count(self, endpoint: str, status: str) -> None:
        self._counter(f"serve.requests_{status}")
        self._counter(f"serve.requests_{status}.by_endpoint.{endpoint}")

    def observe_latency(self, endpoint: str, dur_s: float) -> None:
        self.registry.histogram(f"serve.request_s.by_endpoint.{endpoint}").observe(dur_s)
        obs.histogram(f"serve.request_s.by_endpoint.{endpoint}").observe(dur_s)

    def set_load(self, in_flight: int, queued: int) -> None:
        self.registry.gauge("serve.in_flight").set(in_flight)
        self.registry.gauge("serve.queued").set(queued)
        obs.gauge("serve.in_flight").set(in_flight)
        obs.gauge("serve.queued").set(queued)

    def rolling_p50(self, endpoint: str) -> float | None:
        return self.registry.histogram(f"serve.request_s.by_endpoint.{endpoint}").rolling_quantile(0.5)

    def rolling_p99(self, endpoint: str) -> float | None:
        return self.registry.histogram(f"serve.request_s.by_endpoint.{endpoint}").rolling_quantile(0.99)

    def snapshot(self) -> dict:
        return self.registry.snapshot()
