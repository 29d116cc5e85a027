"""``serve``: the resident, fault-isolated scoring daemon, on the card, and the serving fabric.

Counterpart of ``variantcalling_tpu/serve/``. A CLI run
pays its cold costs every time: the interpreter and torch, the model
unpickle, the predictor's kernel tables built and uploaded, the genome
encoded and put on the card. The daemon pays them once and serves filter,
score and coverage requests over localhost HTTP or a Unix socket (standard
library only) through the port's streaming executor, several at once on one
card:

- **per-request isolation**: each request runs under its own
  ``knobs.scope``, ``faults.scope`` and cancel token, with its own recovery
  budget (chunk retries, the watchdog, quarantine); a poisoned request gets
  its own error, and the daemon and concurrent requests are untouched;
- **admission and shedding**: ``VCTPU_SERVE_MAX_INFLIGHT`` requests execute,
  ``VCTPU_SERVE_QUEUE_DEPTH`` wait, the rest are shed with an explicit 503;
  an early shed on the rolling latency p50; per-request deadlines with
  chunk-granular cancellation; a graceful drain on SIGTERM;
- **resident state**: models and genomes (:mod:`.state`), the built
  predictors with their tables on the card and the resident device genome;
- **observability**: one obs stream over the daemon's life (request events,
  per-endpoint rolling latency histograms, request counters), the same
  registry rendered for Prometheus at ``GET /v1/metrics``.

The serving fabric puts a router (:mod:`.router`, ``serve --fabric``) in
front of N backends (:mod:`.backend`, ``serve --fabric-backend``: the daemon
plus the streaming ``POST /v1/segment``): the router cuts each streamed
filter request into contig-aware spans, streams each to a live backend,
merges the segments at their seams and streams the batch CLI's bytes back
(:mod:`.transport`: chunked bodies, bearer tokens, per-principal quota). The
router imports no torch: this package's modules import it only where a
device is used.
"""

from variantcalling_tpu_torch.serve.daemon import Server  # noqa: F401
