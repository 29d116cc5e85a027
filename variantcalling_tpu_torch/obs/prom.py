"""Prometheus text exposition of obs metrics — the external-scraper face
of the live telemetry plane.

Counterpart of ``variantcalling_tpu/obs/prom.py``, the same renderer; the
serving daemon's ``GET /v1/metrics`` also answers with
:func:`snapshot_to_prom` of its registry.

Two consumers share one renderer:

- ``vctpu obs prom <log>`` converts any obs run log's latest metrics
  state (the final ``metrics`` snapshot of a finished run, or the last
  periodic ``snapshot`` of an in-flight one) into the Prometheus text
  exposition format, for ad-hoc scraping of a genome-scale run;
- the live textfile writer (``VCTPU_OBS_PROM_FILE``) atomically rewrites
  a node-exporter-style textfile on every periodic snapshot, so a
  standing scraper watches the run without parsing JSONL.

Mapping: counters -> ``vctpu_<name>_total``; gauges -> ``vctpu_<name>``
plus ``vctpu_<name>_peak``; histograms -> a summary family
(``quantile`` label, ``_count``/``_sum`` series) from the CUMULATIVE
buckets plus a ``_rolling`` gauge family (same quantile labels,
``window_s`` label) from the rolling-window rings — rolling p95 means
"recent", the SLO signal. Metric names are sanitized to the Prometheus
charset; everything else is verbatim.
"""

from __future__ import annotations

import os
import re
import tempfile

#: Prometheus metric-name charset (values and label values are free-form)
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: histogram snapshot percentile keys -> Prometheus quantile label values
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def _san(name: str) -> str:
    return _NAME_RE.sub("_", name)


#: per-endpoint metric convention (vctpu serve, docs/serving.md): a
#: metric named ``<base>.by_endpoint.<endpoint>`` renders as the base
#: family with a real ``{endpoint="…"}`` label, so per-endpoint request
#: series (rolling p99s, shed/accepted/failed counters) are one
#: Prometheus family each instead of a family per endpoint
_ENDPOINT_SEP = ".by_endpoint."


def _split_endpoint(name: str) -> tuple[str, str | None]:
    base, sep, endpoint = name.partition(_ENDPOINT_SEP)
    return (base, endpoint) if sep and endpoint else (name, None)


def _label_str(labels: list[tuple[str, str]]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _num(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".9g")


def snapshot_to_prom(snap: dict, tool: str = "vctpu",
                     in_flight: bool = True,
                     extra: dict[str, float] | None = None) -> str:
    """Render one metrics snapshot (``{counters, gauges, histograms}``,
    the ``metrics``/``snapshot`` event body) as text exposition."""
    lines: list[str] = []
    seen_families: set[str] = set()

    def family(name: str, mtype: str, help_text: str) -> None:
        # one HELP/TYPE per family: endpoint-labeled series of one base
        # (``.by_endpoint.`` convention) share a single family header
        if name in seen_families:
            return
        seen_families.add(name)
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")

    family("vctpu_run_in_flight", "gauge",
           "1 while the run is still writing its obs stream")
    lines.append(f'vctpu_run_in_flight{{tool="{tool}"}} '
                 f"{1 if in_flight else 0}")

    for name, value in sorted((extra or {}).items()):
        m = f"vctpu_{_san(name)}"
        family(m, "gauge", f"obs run field {name}")
        lines.append(f"{m} {_num(value)}")

    for name, value in sorted((snap.get("counters") or {}).items()):
        base, endpoint = _split_endpoint(name)
        m = f"vctpu_{_san(base)}_total"
        family(m, "counter", f"obs counter {base}")
        labels = [("endpoint", endpoint)] if endpoint else []
        lines.append(f"{m}{_label_str(labels)} {_num(value)}")

    for name, g in sorted((snap.get("gauges") or {}).items()):
        if not isinstance(g, dict):
            continue
        base, endpoint = _split_endpoint(name)
        m = f"vctpu_{_san(base)}"
        labels = [("endpoint", endpoint)] if endpoint else []
        family(m, "gauge", f"obs gauge {base}")
        lines.append(f"{m}{_label_str(labels)} {_num(g.get('value'))}")
        family(f"{m}_peak", "gauge", f"obs gauge {base} run peak")
        lines.append(f"{m}_peak{_label_str(labels)} {_num(g.get('peak'))}")

    for name, h in sorted((snap.get("histograms") or {}).items()):
        if not isinstance(h, dict):
            continue
        base, endpoint = _split_endpoint(name)
        m = f"vctpu_{_san(base)}"
        ep_labels = [("endpoint", endpoint)] if endpoint else []
        family(m, "summary", f"obs histogram {base} (cumulative)")
        for key, q in _QUANTILES:
            if h.get(key) is not None:
                lines.append(
                    f"{m}{_label_str(ep_labels + [('quantile', q)])} "
                    f"{_num(h[key])}")
        lines.append(f"{m}_sum{_label_str(ep_labels)} "
                     f"{_num(h.get('sum', 0))}")
        lines.append(f"{m}_count{_label_str(ep_labels)} "
                     f"{_num(h.get('count', 0))}")
        rolling = h.get("rolling")
        if isinstance(rolling, dict):
            rm = f"{m}_rolling"
            family(rm, "gauge",
                   f"obs histogram {base} rolling-window quantiles")
            window = _num(rolling.get("window_s"))
            for key, q in _QUANTILES:
                if rolling.get(key) is not None:
                    lines.append(
                        f"{rm}{_label_str(ep_labels + [('quantile', q), ('window_s', window)])} "
                        f"{_num(rolling[key])}")
            lines.append(
                f"{rm}_count{_label_str(ep_labels + [('window_s', window)])} "
                f"{_num(rolling.get('count', 0))}")
    return "\n".join(lines) + "\n"


def events_to_prom(events: list[dict]) -> str:
    """Text exposition of an obs log's LATEST metrics state: the last
    ``snapshot``/``metrics`` event wins (an in-flight run has periodic
    snapshots, a finished one ends with the final ``metrics``)."""
    manifest = next((e for e in events if e.get("kind") == "manifest"), None)
    run_end = next((e for e in reversed(events)
                    if e.get("kind") == "run_end"), None)
    snap_ev = next((e for e in reversed(events)
                    if e.get("kind") in ("snapshot", "metrics")), None)
    snap = {k: snap_ev.get(k, {}) for k in
            ("counters", "gauges", "histograms")} if snap_ev else {}
    extra: dict[str, float] = {}
    hb = next((e for e in reversed(events)
               if e.get("kind") == "heartbeat"), None)
    if hb is not None:
        for key in ("chunks", "records", "vps", "pct", "eta_s"):
            if isinstance(hb.get(key), (int, float)):
                extra[f"progress.{key}"] = hb[key]
    if run_end is not None:
        extra["run_duration_seconds"] = float(run_end.get("dur", 0.0))
    return snapshot_to_prom(
        snap, tool=(manifest or {}).get("tool", "vctpu"),
        in_flight=run_end is None, extra=extra)


def write_textfile(path: str, text: str) -> None:
    """Atomic textfile-collector write: a scraper must never read a
    half-written exposition (tmp file + ``os.replace`` in one dir)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".vctpu_prom_", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
