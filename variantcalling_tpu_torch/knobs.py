"""Typed registry of every ``VCTPU_*`` environment knob.

Counterpart of ``variantcalling_tpu/knobs.py``: the same knobs, with the
same names, kinds, defaults, bounds, help and error messages, so that a
value one package refuses the other refuses too. Every ``VCTPU_*`` read in
the port goes through :func:`get` and its typed forms; a malformed value
raises :class:`~variantcalling_tpu_torch.engine.EngineError` (CLI exit 2),
and ``filter_variants.run`` calls :func:`validate_all` before it reads
anything. Unknown ``VCTPU_*`` variables are reported at CLI start with a
closest-match suggestion (:func:`warn_unknown_env`).

The registry lists every knob of the reference, also those the port does
not honour yet (``ROADMAP.md`` names the slice that brings each): they are
validated all the same. :data:`HONOURED` names the knobs the port reads.
:class:`scope` layers typed per-request overrides over the environment for
one execution context (the serving daemon's requests, :mod:`serve`).
:func:`run` is the ``knobs`` tool that dumps the resolved registry. Left
out: the reference's ``##vctpu_knobs=`` header line.

Booleans accept ``1/true/yes/on`` and ``0/false/no/off`` (case
insensitive); a set-but-empty variable means "unset" except for ``str``
knobs, where the empty string is meaningful.
"""

from __future__ import annotations

import contextvars
import difflib
import logging
import os
from dataclasses import dataclass
from typing import Any

from variantcalling_tpu_torch.engine import EngineError

log = logging.getLogger(__name__)

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@dataclass(frozen=True)
class Knob:
    """One declared ``VCTPU_*`` environment knob."""

    name: str  # full env name, e.g. "VCTPU_THREADS"
    kind: str  # "bool" | "int" | "float" | "str" | "enum"
    default: Any  # typed default when unset (None = no value)
    help: str
    choices: tuple[str, ...] | None = None  # enum values
    label: str | None = None  # enum error noun ("engine", "forest strategy")
    positive: bool = False  # int must be > 0
    minimum: float | None = None  # inclusive numeric lower bound
    in_header: bool = False  # recorded in ##vctpu_knobs= when env-set


def _k(*args, **kwargs) -> Knob:
    return Knob(*args, **kwargs)


#: Every knob the framework reads. Keep alphabetical within each group.
REGISTRY: dict[str, Knob] = {k.name: k for k in (
    # -- engine / scoring configuration (recorded via their own header
    #    lines: ##vctpu_engine= / ##vctpu_forest_strategy=) --------------
    _k("VCTPU_ENGINE", "enum", "auto",
       "scoring engine contract: auto|native|jit (docs/robustness.md)",
       choices=("auto", "native", "jit"), label="engine"),
    _k("VCTPU_REQUIRE_NATIVE", "bool", False,
       "fail loudly (exit 2) when the native scoring engine cannot load"),
    _k("VCTPU_NATIVE_FOREST", "bool", True,
       "legacy spelling of VCTPU_ENGINE=jit when 0 (predates engine.py)"),
    _k("VCTPU_NO_NATIVE", "bool", False,
       "disable the native C++ library entirely (build/load returns None)"),
    _k("VCTPU_FOREST_STRATEGY", "enum", "auto",
       "forest inference strategy: auto|gather|gemm|wide|pallas "
       "(docs/models.md)",
       choices=("auto", "gather", "gemm", "wide", "pallas"),
       label="forest strategy"),
    _k("VCTPU_MODEL_FAMILY", "enum", "auto",
       "scoring model family: auto|forest|dan — explicit request fails "
       "loudly when the loaded model is another family (docs/models.md)",
       choices=("auto", "forest", "dan"),
       label="model family"),
    _k("VCTPU_PALLAS", "bool", True,
       "allow the pallas wide-block kernel in strategy auto-resolution",
       in_header=True),
    _k("VCTPU_WIDE_CHUNK", "int", None,
       "N-chunk of the wide-contraction driver (bounds the decision "
       "tensor); default models/forest.WIDE_CHUNK", positive=True,
       in_header=True),
    _k("VCTPU_WIDE_BLOCK", "int", None,
       "trees per block-diagonal routing block; default fills the "
       "128-lane MXU", positive=True, in_header=True),
    _k("VCTPU_NATIVE_GBT", "bool", True,
       "allow the native partitioned-sample GBT trainer on CPU fits"),
    _k("VCTPU_NATIVE_FUSED", "bool", True,
       "native engine: score each chunk via the single fused "
       "parse->featurize->walk native call; 0 selects the unfused "
       "byte-parity reference path (docs/perf_notes.md)"),
    _k("VCTPU_MESH_DEVICES", "int", None,
       "data-parallel mesh size for XLA scoring (shard_map over dp); 1 "
       "pins single-device, default auto — 1 on cpu, every local device "
       "on accelerators (docs/streaming_executor.md)", positive=True),
    _k("VCTPU_MESH_MEGABATCH_ROWS", "int", None,
       "rows per mesh scoring megabatch in the streaming executor; "
       "default 16384 x mesh devices", positive=True),
    _k("VCTPU_MESH_OVERLAP", "bool", True,
       "overlap megabatch packing with the in-flight scoring dispatch "
       "(one group in flight on a dedicated dispatch worker); 0 keeps "
       "the synchronous pack-then-score loop "
       "(docs/streaming_executor.md)"),
    # -- streaming executor / parallel host pipeline --------------------
    _k("VCTPU_THREADS", "int", None,
       "host pipeline threads; 1 selects the serial path; default cpu "
       "count", positive=True),
    _k("VCTPU_STREAM", "bool", True,
       "allow the streaming (chunked, overlapped) filter executor"),
    _k("VCTPU_STREAM_CHUNK_BYTES", "int", 8 << 20,
       "bytes of VCF text per streaming pipeline item", positive=True),
    _k("VCTPU_IO_THREADS", "int", None,
       "host-IO worker pool size (sharded BGZF inflate, parallel chunk "
       "parse, writeback block compress); 1 disables parallel IO; "
       "default cpu count", positive=True),
    _k("VCTPU_IO_SHARD_BYTES", "int", 4 << 20,
       "decompressed bytes per parallel BGZF inflate shard "
       "(docs/streaming_executor.md)", positive=True),
    _k("VCTPU_NATIVE_THREADS", "int", None,
       "native engine kernel fan-out cap (C++ for_shards; read by the "
       "native library directly); default hardware concurrency",
       positive=True),
    _k("VCTPU_STAGE_TIMEOUT_S", "float", 900.0,
       "streaming-stage watchdog deadline in seconds (0 disables)",
       minimum=0.0),
    _k("VCTPU_IO_RETRIES", "int", 2,
       "bounded retries for transient ingest/writeback IO errors",
       minimum=0),
    _k("VCTPU_IO_BACKOFF_S", "float", 0.05,
       "initial retry backoff in seconds (doubles per attempt, plus "
       "bounded deterministic per-worker jitter)", minimum=0.0),
    _k("VCTPU_CHUNK_RETRIES", "int", 1,
       "bounded re-dispatches of a failed streaming chunk / megabatch "
       "before the failure is final (recovery ladder, "
       "docs/robustness.md); 0 fails on the first strike", minimum=0),
    _k("VCTPU_QUARANTINE", "bool", False,
       "divert deterministically-failing chunks to a <out>.quarantine "
       "sidecar instead of failing the run (OPT-IN: changes which "
       "records reach the output; default fails loudly — "
       "docs/robustness.md recovery ladder)",
       # changes WHICH records reach the output => scoring-class
       # (knobs_contract.json): an artifact produced under quarantine
       # must say so in its ##vctpu_knobs= provenance header
       in_header=True),
    _k("VCTPU_RESUME", "bool", True,
       "resume interrupted plain-text runs from the chunk journal"),
    _k("VCTPU_RESUME_VERIFY", "enum", "last",
       "journal resume verification depth: last (spot-check the final "
       "chunk's CRC) or full (re-read and CRC-check every journaled "
       "chunk plus the header)", choices=("last", "full"),
       label="resume verification mode"),
    _k("VCTPU_JOURNAL_FSYNC", "bool", False,
       "fsync the partial output and journal after every committed "
       "chunk (durability over throughput; default relies on flush "
       "ordering only)"),
    # -- multi-host -----------------------------------------------------
    _k("VCTPU_COORDINATOR", "str", None,
       "host:port of rank 0 — presence turns any tool into one rank of "
       "a global mesh (docs/distributed.md)"),
    _k("VCTPU_NUM_PROCESSES", "int", None,
       "total ranks of a multi-host launch (jax.distributed) or of a "
       "rank-partitioned local pod run (docs/scaleout.md)", positive=True),
    _k("VCTPU_RANK", "int", None,
       "this process's rank in a rank-partitioned scale-out run "
       "(tools/podrun sets it; resolved BEFORE any jax init, so the "
       "local launcher needs no jax.distributed — docs/scaleout.md)",
       minimum=0),
    _k("VCTPU_PROCESS_ID", "int", None,
       "this rank's id in a multi-host launch", minimum=0),
    _k("VCTPU_SPAN", "str", None,
       "lo:hi:gen — this worker is one leased span of an elastic pod "
       "(absolute decompressed-byte targets + lease generation; "
       "tools/podrun --elastic sets it — docs/scaleout.md \"Elastic "
       "membership\")"),
    _k("VCTPU_AUTO_DISTRIBUTED", "bool", False,
       "initialize jax.distributed from the cluster environment (TPU "
       "pods)"),
    _k("VCTPU_ALL_RANKS_WRITE", "bool", False,
       "let every rank write its own output copy (default: rank 0 only)"),
    # -- caches / IO ----------------------------------------------------
    _k("VCTPU_CACHE", "bool", False,
       "content-addressed chunk-result cache: replay rendered chunk "
       "bodies keyed on (input span CRC, scoring identity) instead of "
       "recomputing them (OPT-IN; byte-identical output either way — "
       "docs/caching.md)"),
    _k("VCTPU_CACHE_DIR", "str", "",
       "chunk-result cache directory (default ~/.cache/vctpu/chunks; "
       "one store shared across ranks/spans — keys are "
       "partition-agnostic)"),
    _k("VCTPU_CACHE_MAX_MB", "int", 512,
       "chunk-result cache size bound in MiB (LRU eviction; bounds the "
       "on-disk store and the serve daemon's in-memory warm index "
       "separately)", positive=True),
    _k("VCTPU_COMPILE_CACHE", "str", None,
       "persistent XLA compilation cache dir; empty string disables; "
       "default ~/.cache/vctpu/xla"),
    _k("VCTPU_GENOME_CACHE", "bool", True,
       "persist the encoded genome as a .venc sidecar and memmap hits"),
    _k("VCTPU_GENOME_CACHE_DIR", "str", "",
       "directory for .venc sidecars (default: next to the FASTA)"),
    _k("VCTPU_FASTA_CACHE_BYTES", "int", 4 << 30,
       "byte budget of the in-memory encoded-contig cache (0 disables)",
       minimum=0),
    _k("VCTPU_CLOUD_TIMEOUT", "int", 600,
       "seconds before a cloud-CLI localization attempt is killed",
       positive=True),
    _k("VCTPU_SUBPROC_TIMEOUT_S", "int", 3600,
       "timeout for external tool subprocesses (beagle, …) — VCT005: no "
       "subprocess runs unbounded", positive=True),
    # -- vctpu serve — the resident daemon (docs/serving.md) -----------
    _k("VCTPU_SERVE_HOST", "str", "127.0.0.1",
       "vctpu serve bind address (localhost only by design — the daemon "
       "is a host-local multiplexer, not an internet face)"),
    _k("VCTPU_SERVE_PORT", "int", 8844,
       "vctpu serve TCP port (0 = ephemeral, the chosen port lands in "
       "the --ready-file)", minimum=0),
    _k("VCTPU_SERVE_SOCKET", "str", "",
       "vctpu serve Unix-domain socket path (set -> AF_UNIX instead of "
       "TCP)"),
    _k("VCTPU_SERVE_MAX_INFLIGHT", "int", 2,
       "admission control: pipeline requests executing concurrently; "
       "further admitted requests wait in the bounded queue",
       positive=True),
    _k("VCTPU_SERVE_QUEUE_DEPTH", "int", 8,
       "admission control: requests allowed to WAIT for an execution "
       "slot; arrivals beyond it are shed with an explicit 503 "
       "(docs/serving.md admission/shed policy)", minimum=0),
    _k("VCTPU_SERVE_DEADLINE_S", "float", 300.0,
       "default per-request deadline in seconds (queue wait + "
       "execution); the request JSON's deadline_s overrides per "
       "request; expiry cancels the request at the next chunk boundary "
       "(0 disables)", minimum=0.0),
    _k("VCTPU_SERVE_DRAIN_S", "float", 60.0,
       "graceful-drain budget on SIGTERM/SIGINT: finish in-flight "
       "requests up to this many seconds while refusing new work, then "
       "exit", minimum=0.0),
    # -- vctpu serve --fabric — the scatter-gather router tier
    #    (docs/serving_fabric.md) ---------------------------------------
    _k("VCTPU_FABRIC_BACKENDS", "str", "",
       "comma-separated backend daemon addresses the router registers "
       "at startup (http://host:port, or a filesystem path for "
       "AF_UNIX); each must be a `vctpu serve --fabric-backend` daemon"),
    _k("VCTPU_FABRIC_HEARTBEAT_S", "float", 2.0,
       "router heartbeat period in seconds: each beat polls every "
       "registered backend's /v1/status (rolling-SLO series) and "
       "/v1/metrics (prom text, cpu-ledger series included when the "
       "backend samples them)", minimum=0.05),
    _k("VCTPU_FABRIC_DEAD_AFTER", "int", 3,
       "consecutive failed heartbeats before the router marks a backend "
       "dead (stops placing spans on it; membership event emitted)",
       positive=True),
    _k("VCTPU_FABRIC_QUOTA", "int", 4,
       "per-principal concurrent-request quota at the front door; "
       "arrivals beyond it get 429 with Retry-After (bearer tokens map "
       "requests to principals — VCTPU_FABRIC_TOKENS)", positive=True),
    _k("VCTPU_FABRIC_TOKENS", "str", "",
       "bearer-token auth table for the front door: "
       "'token:principal,token2:principal2'; empty string disables auth "
       "(every request is the 'anonymous' principal)"),
    _k("VCTPU_FABRIC_STREAM_CHUNK_BYTES", "int", 1 << 20,
       "chunked-transfer frame size for fabric body streaming (request "
       "upload spooling and response download)", positive=True),
    _k("VCTPU_FABRIC_SPAN_ATTEMPTS", "int", 2,
       "placement attempts per span before the whole request fails with "
       "a distinct backend_lost status (each re-span bumps the lease "
       "generation and lands on a different live backend)",
       positive=True),
    # -- diagnostics / test harness ------------------------------------
    _k("VCTPU_OBS", "bool", False,
       "record run telemetry (manifest + metrics + event log) to an obs "
       "JSONL sidecar (docs/observability.md)"),
    _k("VCTPU_OBS_PATH", "str", "",
       "obs run-log path override; default <output_file>.obs.jsonl"),
    _k("VCTPU_OBS_PROFILE", "bool", True,
       "obs v2 attribution when VCTPU_OBS=1: per-stage work/wait "
       "profile, RSS/CPU watermark sampler, runtime cost_analysis "
       "(docs/observability.md)"),
    _k("VCTPU_OBS_SAMPLE_S", "float", 0.05,
       "resource-watermark sampler interval in seconds", minimum=0.001),
    _k("VCTPU_OBS_CPUPROF", "bool", False,
       "obs v3 continuous CPU sampling profiler when VCTPU_OBS=1: "
       "whole-process stack samples + per-thread CPU clocks folded into "
       "the sample event stream (vctpu obs flame / cpuledger; "
       "docs/observability.md)"),
    _k("VCTPU_OBS_CPUPROF_HZ", "float", 7.0,
       "continuous-profiler sampling rate in Hz; the conservative "
       "default fits the <=2% overhead budget on a saturated 2-core "
       "host (every tick holds the GIL briefly) — raise it on hosts "
       "with spare cores for finer flames", minimum=1.0),
    _k("VCTPU_OBS_TAIL_POLL_S", "float", 1.0,
       "vctpu obs tail --follow poll interval in seconds "
       "(--interval-s overrides per invocation)", minimum=0.01),
    _k("VCTPU_OBS_JAXPROF", "bool", False,
       "capture a jax.profiler device trace (<run log>.jaxprof/) "
       "alongside the obs stream for side-by-side Perfetto loading"),
    _k("VCTPU_OBS_TRACE", "bool", True,
       "causal chunk tracing when VCTPU_OBS=1: per-chunk trace ids, "
       "per-stage trace spans with parent links (the walkable DAG "
       "vctpu obs critical-path consumes); 0 opts out "
       "(docs/observability.md)"),
    _k("VCTPU_OBS_SNAPSHOT_S", "float", 10.0,
       "minimum seconds between periodic in-run metrics snapshots "
       "(kind=snapshot, emitted on the event-flush cadence; the live "
       "plane for vctpu obs tail/prom); 0 disables", minimum=0.0),
    _k("VCTPU_OBS_WINDOW_S", "float", 60.0,
       "rolling-window span of the windowed histogram quantiles "
       "(rolling p50/p95/p99 mean 'the last ~window', not all-of-run)",
       minimum=1.0),
    _k("VCTPU_OBS_MAX_MB", "int", None,
       "obs run-log size cap in MB: the stream rotates to .seg1/.seg2/"
       "... segments at the cap (readers merge segments transparently); "
       "unset = one unbounded file", positive=True),
    _k("VCTPU_OBS_PROM_FILE", "str", "",
       "Prometheus textfile-collector path: every periodic snapshot "
       "atomically rewrites this file with the text exposition "
       "(vctpu obs prom is the offline sibling)"),
    _k("VCTPU_BENCH_GATE", "bool", False,
       "run_tests.sh: run the opt-in bench regression gate stage "
       "(tools/bench_gate.py) before pytest"),
    _k("VCTPU_BENCH_BASELINE", "str", "",
       "bench_gate baseline JSON path; default: newest committed "
       "BENCH_r*.json"),
    _k("VCTPU_TRACE", "bool", False,
       "print every closed trace span at INFO level"),
    _k("VCTPU_FAULTS", "str", "",
       "fault-injection spec, e.g. io.chunk_read:2,pipeline.stage_hang@30 "
       "(utils/faults.py)"),
    _k("VCTPU_FLAKEHUNT", "bool", False,
       "run_tests.sh: repeat flakehunt-marked tests 5x after the main run"),
    _k("VCTPU_CHAOS", "bool", False,
       "run_tests.sh: run the opt-in chaos smoke stage (tools/chaoshunt, "
       "10 fixed seeds) after tier-0 lint"),
    _k("VCTPU_LOAD", "bool", False,
       "run_tests.sh: run the opt-in load×chaos smoke stage "
       "(tools/loadhunt, 10 fixed seeds against a real vctpu serve "
       "daemon — docs/serving.md)"),
    _k("VCTPU_SCALEOUT", "bool", False,
       "run_tests.sh: run the opt-in simulated multi-host stage (the "
       "2-process local launcher end-to-end on the cpu backend plus the "
       "multi-process system tests — docs/scaleout.md)"),
    _k("VCTPU_PROBE_INTERVAL", "int", 1800,
       "tools/tpu_probe.py polling interval in seconds", positive=True),
    _k("VCTPU_PROBE_HOURS", "float", 11.5,
       "tools/tpu_probe.py total probe-loop duration in hours",
       minimum=0.0),
)}


#: the knobs the port reads, each doing there what it does in the reference
#: (``VCTPU_NATIVE_THREADS`` is read by the native engine's C++); the rest of
#: the registry is validated and waits for its module
HONOURED = frozenset({
    # the scoring configuration, the host engine and the genome sidecar
    "VCTPU_FOREST_STRATEGY", "VCTPU_MODEL_FAMILY", "VCTPU_NO_NATIVE", "VCTPU_NATIVE_THREADS",
    "VCTPU_FASTA_CACHE_BYTES", "VCTPU_GENOME_CACHE", "VCTPU_GENOME_CACHE_DIR",
    # the streaming executor, its journal, chunk cache and fault injection
    "VCTPU_THREADS", "VCTPU_STREAM", "VCTPU_STREAM_CHUNK_BYTES", "VCTPU_IO_THREADS", "VCTPU_IO_SHARD_BYTES",
    "VCTPU_STAGE_TIMEOUT_S", "VCTPU_IO_RETRIES", "VCTPU_IO_BACKOFF_S", "VCTPU_CHUNK_RETRIES",
    "VCTPU_QUARANTINE", "VCTPU_RESUME", "VCTPU_RESUME_VERIFY", "VCTPU_JOURNAL_FSYNC", "VCTPU_CACHE",
    "VCTPU_CACHE_DIR", "VCTPU_CACHE_MAX_MB", "VCTPU_FAULTS",
    # the boosted-forest fit
    "VCTPU_NATIVE_GBT",
    # the rank check of train_dan and sec_training: a launch of more than one rank exits 2 (A7)
    "VCTPU_RANK", "VCTPU_NUM_PROCESSES", "VCTPU_SPAN",
    # the bound on the imputation chain's external beagle
    "VCTPU_SUBPROC_TIMEOUT_S",
    # the serving daemon: its address, admission limits, deadlines and drain, and the obs
    # stream and rolling latency windows it writes
    "VCTPU_SERVE_HOST", "VCTPU_SERVE_PORT", "VCTPU_SERVE_SOCKET", "VCTPU_SERVE_MAX_INFLIGHT",
    "VCTPU_SERVE_QUEUE_DEPTH", "VCTPU_SERVE_DEADLINE_S", "VCTPU_SERVE_DRAIN_S",
    "VCTPU_OBS", "VCTPU_OBS_PATH", "VCTPU_OBS_WINDOW_S",
    # the run telemetry: the stage profiler and its resource sampler, the CPU
    # sampler, causal tracing, snapshots, rotation, the Prometheus textfile,
    # the device trace (torch.profiler), the obs tool's tail, the span log
    "VCTPU_OBS_PROFILE", "VCTPU_OBS_SAMPLE_S", "VCTPU_OBS_CPUPROF", "VCTPU_OBS_CPUPROF_HZ",
    "VCTPU_OBS_TAIL_POLL_S", "VCTPU_OBS_JAXPROF", "VCTPU_OBS_TRACE", "VCTPU_OBS_SNAPSHOT_S",
    "VCTPU_OBS_MAX_MB", "VCTPU_OBS_PROM_FILE", "VCTPU_TRACE",
})


#: the per-request override layer (:class:`scope`): knob name -> raw string,
#: or None to mask the environment back to the declared default, carried in
#: a contextvar so that two concurrent requests never see each other's
#: settings. The executor copies the submitting context into its workers
#: (``parallel/pipeline.py``), so a scope follows the request's chunks.
_SCOPE: contextvars.ContextVar[dict[str, str | None] | None] = contextvars.ContextVar("vctpu_knob_scope",
                                                                                     default=None)


class scope:
    """Layer raw knob overrides over the environment for the current
    execution context.

    ``overrides`` maps registered knob names to raw strings, parsed at the
    first read exactly as the environment's text would be (a malformed value
    raises ``EngineError`` there), or to ``None``, which masks an environment
    setting back to the declared default. Scopes nest: an inner scope merges
    over the outer one, and leaving a scope restores the layer before it. An
    unknown name raises ``KeyError`` at construction."""

    __slots__ = ("overrides", "_token")

    def __init__(self, overrides: dict[str, object] | None = None, **kw):
        merged: dict[str, object] = dict(overrides or {})
        merged.update(kw)
        for name in merged:
            if name not in REGISTRY:
                raise KeyError(f"{name} is not a registered VCTPU knob")
        self.overrides = {name: (None if value is None else str(value)) for name, value in merged.items()}
        self._token = None

    def __enter__(self) -> "scope":
        base = _SCOPE.get()
        layered = dict(base) if base else {}
        layered.update(self.overrides)
        self._token = _SCOPE.set(layered)
        return self

    def __exit__(self, *exc) -> bool:
        _SCOPE.reset(self._token)
        self._token = None
        return False


def scoped(name: str) -> bool:
    """Whether ``name`` is overridden by the current context's scope layer."""
    layer = _SCOPE.get()
    return layer is not None and name in layer


def raw(name: str) -> str | None:
    """The raw string a knob resolves from (None when unset): the context's
    scope layer first, else the environment. The port's single
    ``os.environ`` access point for ``VCTPU_*`` keys."""
    if name not in REGISTRY:
        raise KeyError(f"{name} is not a registered VCTPU knob")
    layer = _SCOPE.get()
    if layer is not None and name in layer:
        return layer[name]
    return os.environ.get(name)


def _parse(knob: Knob, raw_value: str) -> Any:
    text = raw_value.strip()
    if knob.kind == "str":
        return raw_value
    if not text:  # set-but-empty == unset for non-str knobs
        return knob.default
    if knob.kind == "bool":
        low = text.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise EngineError(
            f"{knob.name}={raw_value!r} is not a valid boolean; use one of "
            f"{'/'.join(_TRUE)} or {'/'.join(_FALSE)}")
    if knob.kind == "enum":
        low = text.lower()
        if low not in knob.choices:
            noun = knob.label or knob.name
            raise EngineError(
                f"{knob.name}={low!r} is not a valid {noun}; choose one of "
                f"{'/'.join(knob.choices)}")
        return low
    if knob.kind == "int":
        try:
            value = int(text)
        except ValueError:
            value = None
        if knob.positive:
            if value is None or value <= 0:
                raise EngineError(
                    f"{knob.name}={raw_value!r} is not a positive integer")
        elif value is None:
            raise EngineError(
                f"{knob.name}={raw_value!r} is not an integer")
    elif knob.kind == "float":
        try:
            value = float(text)
        except ValueError:
            raise EngineError(
                f"{knob.name}={raw_value!r} is not a number") from None
    else:  # pragma: no cover — registry construction guards kinds
        raise EngineError(f"unknown knob kind {knob.kind!r} for {knob.name}")
    if knob.minimum is not None and value < knob.minimum:
        raise EngineError(
            f"{knob.name}={raw_value!r} must be >= {knob.minimum}")
    return value


def get(name: str) -> Any:
    """The typed, validated value of a registered knob (env beats the
    declared default). The one parse point: a malformed value raises
    ``EngineError`` here (CLI exit 2), whatever the run would have used."""
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered VCTPU knob")
    raw_value = raw(name)
    if raw_value is None:
        return knob.default
    return _parse(knob, raw_value)


def _typed(name: str, kinds: tuple[str, ...]) -> Any:
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered VCTPU knob")
    if knob.kind not in kinds:
        raise TypeError(f"{name} is a {knob.kind} knob, not {'/'.join(kinds)}")
    return get(name)


def get_bool(name: str) -> bool:
    return _typed(name, ("bool",))


def get_int(name: str) -> int | None:
    return _typed(name, ("int",))


def get_float(name: str) -> float:
    return _typed(name, ("float",))


def get_str(name: str) -> str | None:
    return _typed(name, ("str", "enum"))


def source(name: str) -> str:
    """Where the resolved value came from: ``"scope"``, ``"env"`` or ``"default"``."""
    if scoped(name):
        return "scope"
    return "env" if raw(name) is not None else "default"


def resolved() -> list[tuple[str, Any, str]]:
    """(name, typed value, source) of every registered knob, sorted. Raises on
    the first malformed value, like :func:`validate_all`."""
    return [(name, get(name), source(name)) for name in sorted(REGISTRY)]


def validate_all() -> None:
    """Parse every registered knob, raising ``EngineError`` on the first
    malformed value: a bad knob exits 2 before any work, never mid-run."""
    for name in REGISTRY:
        get(name)


def unknown_env() -> list[tuple[str, str | None]]:
    """``VCTPU_*`` variables set in the environment but absent from the
    registry, each with its closest registered name (typo detection) or
    None when nothing is close."""
    out: list[tuple[str, str | None]] = []
    for key in sorted(os.environ):
        if not key.startswith("VCTPU_") or key in REGISTRY:
            continue
        close = difflib.get_close_matches(key, REGISTRY, n=1, cutoff=0.6)
        out.append((key, close[0] if close else None))
    return out


def warn_unknown_env() -> list[str]:
    """Log a startup warning for every unknown ``VCTPU_*`` variable (a typo
    such as ``VCTPU_FOERST_STRATEGY=wide`` configures nothing). Returns the
    warning strings."""
    warnings = []
    for key, suggestion in unknown_env():
        msg = f"unknown environment variable {key} is ignored"
        if suggestion:
            msg += f" — did you mean {suggestion}?"
        warnings.append(msg)
        log.warning("%s", msg)
    return warnings


def run(argv: list[str]) -> int:
    """CLI (``knobs``): print every knob's resolved value and source, as the
    reference's ``vctpu knobs`` does. ``--json`` emits a machine-readable
    dump. Exit 2 on a malformed value, after naming the knob."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="vctpu knobs",
        description="dump the resolved VCTPU_* knob registry")
    parser.add_argument("--json", action="store_true",
                        help="emit JSON instead of aligned text")
    args = parser.parse_args(argv)

    for msg in warn_unknown_env():
        print(f"warning: {msg}")
    try:
        rows = resolved()
    except EngineError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        from variantcalling_tpu_torch.utils.jsonio import emit_json

        emit_json({name: {"value": value, "source": src,
                          "help": REGISTRY[name].help}
                   for name, value, src in rows})
        return 0
    width = max(len(name) for name, _, _ in rows)
    for name, value, src in rows:
        shown = "" if value is None else value
        print(f"{name:<{width}}  {shown!s:<12} [{src:>7}]  {REGISTRY[name].help}")
    return 0
