"""A bounded FIFO cache with per-key build locks.

Counterpart of the reference's ``serve/state._KeyedCache``. Requests for
one key block on one build; requests for different keys build at once; the
table lock is held only for bookkeeping, never across a build. The oldest
entry goes once there are more than ``max_entries``. A build that raises
caches nothing and the next request builds again.

It holds the serving daemon's resident models and genomes
(:mod:`variantcalling_tpu_torch.serve.state`) and the filter pipeline's
built predictors (``pipelines/filter_variants``).
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger(__name__)


class KeyedCache:
    """Bounded FIFO of built values with per-key build locks; counts hits
    and misses (each miss is one build)."""

    def __init__(self, name: str, max_entries: int):
        self.name = name
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: dict[tuple, object] = {}
        self._building: dict[tuple, threading.Lock] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple, build):
        """The value of ``key``, built by ``build()`` on a miss."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                return self._entries[key]
            gate = self._building.setdefault(key, threading.Lock())
        with gate:
            # re-check: a request that waited on the gate finds the entry built meanwhile
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    return self._entries[key]
            try:
                value = build()
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                raise
            with self._lock:
                self.misses += 1
                self._entries[key] = value
                while len(self._entries) > self.max_entries:
                    evicted = next(iter(self._entries))
                    del self._entries[evicted]
                    log.info("%s cache evicted %s", self.name, evicted[0])
                self._building.pop(key, None)
            return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}
