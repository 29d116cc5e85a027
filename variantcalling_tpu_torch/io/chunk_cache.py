"""Content-addressed chunk-result cache: what a repeated callset does not recompute.

Counterpart of ``variantcalling_tpu/io/chunk_cache.py``, with the same entry
format and keys. Chunk results of the streaming executor are pure: chunk
boundaries are a function of (input bytes, chunk_bytes), every per-variant
product is row-local, and the resume journal relies on rendered bytes being
a function of (input span, scoring config). This module keeps rendered chunk
bodies across runs in a bounded store keyed by

    ``<fingerprint[:16]>-<crc32(raw span)>-<len(raw span)>``

where the fingerprint is :func:`io.identity.fingerprint` over the same
``config`` the journal pins (engine, strategy, family, model, flags and
files; no execution knob, so an IO-thread change still hits). Values are
uncompressed rendered bodies with their (records, pass) counts: a ``.gz``
run recompresses a replayed body through the live BGZF carry, so the
framing is the same as a cold run's at any mix of hits and misses.

- :class:`DiskStore` under ``VCTPU_CACHE_DIR`` (default
  ``~/.cache/vctpu/chunks``): atomic per-entry writes (tmp + ``os.replace``),
  CRC-checked reads (a corrupt entry is evicted and recomputed), an
  mtime-LRU bound of ``VCTPU_CACHE_MAX_MB``;
- :class:`MemoryStore`: a byte-bounded in-process LRU, consulted before the
  disk, for a process that serves many runs (:func:`resident_mode`).

Publication is committed-prefix only: workers stage computed entries by
chunk sequence number, and the committer publishes them only after the
chunk's bytes are in the partial file (and the journal), so a failed run
never publishes an entry no output carried.
"""

from __future__ import annotations

import logging
import os
import struct
import tempfile
import threading
import time
import zlib
from collections import OrderedDict

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io import identity as identity_mod
from variantcalling_tpu_torch.utils import degrade, faults

log = logging.getLogger(__name__)

#: on-disk entry framing: magic, n_records, n_pass, body_len, body_crc32
_MAGIC = b"VCC1"
_HDR = struct.Struct("<4sIIQI")
ENTRY_SUFFIX = ".vcc"
_TMP_PREFIX = ".vcc_tmp_"
#: tmp files older than this are torn leftovers of a killed writer
_STALE_TMP_S = 300.0


def enabled() -> bool:
    """``VCTPU_CACHE=1``; off by default."""
    return knobs.get_bool("VCTPU_CACHE")


def store_dir() -> str:
    d = knobs.get_str("VCTPU_CACHE_DIR")
    return d or os.path.join(os.path.expanduser("~"), ".cache", "vctpu", "chunks")


def max_bytes() -> int:
    return knobs.get_int("VCTPU_CACHE_MAX_MB") << 20


def _encode(body: bytes, records: int, passed: int) -> bytes:
    return _HDR.pack(_MAGIC, records, passed, len(body), zlib.crc32(body)) + body


def _decode(blob: bytes) -> tuple[bytes, int, int] | None:
    """One stored entry, checked; None for anything suspicious (short read,
    bad magic, length or CRC mismatch): the caller recomputes."""
    if len(blob) < _HDR.size:
        return None
    magic, records, passed, body_len, crc = _HDR.unpack_from(blob)
    if magic != _MAGIC or len(blob) != _HDR.size + body_len:
        return None
    body = blob[_HDR.size:]
    if zlib.crc32(body) != crc:
        return None
    return body, records, passed


class DiskStore:
    """One directory of ``<key>.vcc`` entries, LRU-bounded by mtime. Safe for
    many processes: writes are atomic renames, reads tolerate concurrent
    eviction, and the bound treats every stat and remove as best-effort."""

    def __init__(self, root: str, bound: int):
        self.root = root
        self.bound = bound
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._sweep_tmp()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ENTRY_SUFFIX)

    def _sweep_tmp(self) -> None:
        """Remove torn tmp files a killed writer left behind, by age, so a
        live concurrent writer's tmp survives."""
        now = time.time()
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if not name.startswith(_TMP_PREFIX):
                continue
            p = os.path.join(self.root, name)
            try:
                if now - os.stat(p).st_mtime > _STALE_TMP_S:
                    os.remove(p)
            except OSError:
                pass

    def get(self, key: str) -> tuple[bytes, int, int] | None:
        path = self._path(key)
        try:
            faults.check("cache.entry_read")
            with open(path, "rb") as fh:
                blob = fh.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            degrade.record("chunk_cache.entry_read", e, fallback="treated as a miss — chunk recomputed")
            return None
        ent = _decode(blob)
        if ent is None:
            log.warning("chunk cache: corrupt entry %s — evicted, recomputing", path)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return ent

    def put(self, key: str, body: bytes, records: int, passed: int) -> None:
        fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX, dir=self.root)
        try:
            # injection point "cache.entry_write": armed with a delay it
            # hangs here, mid-entry-write
            faults.check("cache.entry_write")
            with os.fdopen(fd, "wb") as fh:
                fh.write(_encode(body, records, passed))
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._enforce_bound()

    def _enforce_bound(self) -> None:
        """Evict least recently used entries (mtime: reads touch) until the
        directory fits the byte bound."""
        with self._lock:
            try:
                names = os.listdir(self.root)
            except OSError:
                return
            entries = []
            total = 0
            for name in names:
                if not name.endswith(ENTRY_SUFFIX):
                    continue
                p = os.path.join(self.root, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
            if total <= self.bound:
                return
            for _, size, p in sorted(entries):
                try:
                    os.remove(p)
                except OSError:
                    continue
                total -= size
                if total <= self.bound:
                    break

    def stats(self) -> dict:
        try:
            names = os.listdir(self.root)
        except OSError:
            return {"entries": 0, "bytes": 0}
        n = b = 0
        for name in names:
            if name.endswith(ENTRY_SUFFIX):
                try:
                    b += os.stat(os.path.join(self.root, name)).st_size
                except OSError:
                    continue
                n += 1
        return {"entries": n, "bytes": b}


class MemoryStore:
    """Byte-bounded in-process LRU of immutable entries; all state under a lock."""

    def __init__(self, bound: int):
        self.bound = bound
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, tuple[bytes, int, int]] = OrderedDict()
        self._bytes = 0

    def get(self, key: str) -> tuple[bytes, int, int] | None:
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
            return ent

    def put(self, key: str, body: bytes, records: int, passed: int) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[key] = (body, records, passed)
            self._bytes += len(body)
            while self._bytes > self.bound and self._entries:
                _, (b, _k, _p) = self._entries.popitem(last=False)
                self._bytes -= len(b)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


_RESIDENT = False
_MEMORY: MemoryStore | None = None
_MEMORY_LOCK = threading.Lock()

#: the process's session tallies, rolled in at each session's end (the
#: serving daemon's ``/v1/status``); updated under ``_MEMORY_LOCK``
_TOTALS = {"sessions": 0, "hits": 0, "misses": 0, "bytes_saved": 0, "published": 0}


def resident_mode(on: bool = True) -> None:
    """Opt this process into the in-memory index shared by its runs (a
    process serving many runs); off drops the index. A one-shot CLI run
    leaves it off: it would only hold every rendered body twice."""
    global _RESIDENT, _MEMORY
    with _MEMORY_LOCK:
        _RESIDENT = on
        if not on:
            _MEMORY = None


def _memory_store() -> MemoryStore | None:
    global _MEMORY
    with _MEMORY_LOCK:
        if not _RESIDENT:
            return None
        if _MEMORY is None:
            _MEMORY = MemoryStore(max_bytes())
        return _MEMORY


def resident_stats() -> dict:
    """The in-memory index's size and the process's cumulative cache traffic
    (the serving daemon's ``/v1/status``)."""
    with _MEMORY_LOCK:
        out = dict(_TOTALS, enabled=enabled(), resident=_RESIDENT)
        mem = _MEMORY
    out["memory"] = mem.stats() if mem is not None else {"entries": 0, "bytes": 0}
    return out


class CacheSession:
    """One run's view of the stores: fingerprint-scoped keys, counted lookups
    and committed-prefix publication. :meth:`key_of`, :meth:`get` and
    :meth:`stage` run on chunk workers; :meth:`publish_up_to` and
    :meth:`discard` on the sequenced committer. Shared state is locked."""

    def __init__(self, fp: str, stores: list):
        self.fingerprint = fp
        self._fp16 = fp[:16]
        self._stores = stores  # consult order: memory (if any), disk
        self._lock = threading.Lock()
        self._staged: dict[int, tuple[str, object, int, int]] = {}
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0
        self.published = 0

    def key_of(self, raw) -> str:
        """Address of one raw input span under this config: CRC32 and length
        of the unparsed chunk bytes."""
        return f"{self._fp16}-{zlib.crc32(raw) & 0xFFFFFFFF:08x}-{len(raw)}"

    def get(self, key: str) -> tuple[bytes, int, int] | None:
        for i, store in enumerate(self._stores):
            ent = store.get(key)
            if ent is None:
                continue
            body, records, passed = ent
            if i > 0 and isinstance(self._stores[0], MemoryStore):
                self._stores[0].put(key, bytes(body), records, passed)  # a disk hit warms the memory index
            with self._lock:
                self.hits += 1
                self.bytes_saved += len(body)
            return body, records, passed
        with self._lock:
            self.misses += 1
        return None

    def stage(self, seq: int, key: str, body, records: int, passed: int) -> None:
        """Hold a computed entry until its chunk commits (``body`` may be an
        array view: copied to bytes at publish time, by the committer)."""
        with self._lock:
            self._staged[seq] = (key, body, records, passed)

    def publish_up_to(self, seq: int) -> None:
        """Publish every staged entry of a chunk ``<= seq``, after those bytes
        reached the sink (and the journal). A store failure drops the entry
        (a degradation), never the run."""
        with self._lock:
            ready = sorted(s for s in self._staged if s <= seq)
            items = [self._staged.pop(s) for s in ready]
        for key, body, records, passed in items:
            blob = body if isinstance(body, bytes) else bytes(body)
            for store in self._stores:
                try:
                    store.put(key, blob, records, passed)
                except OSError as e:
                    degrade.record("chunk_cache.entry_write", e, warn=True,
                                   fallback="cache entry dropped — output unaffected")
            with self._lock:
                self.published += 1

    def discard(self) -> None:
        """Failure path: drop everything unpublished."""
        with self._lock:
            self._staged.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "bytes_saved": self.bytes_saved,
                    "published": self.published}

    def finish(self) -> None:
        """A run's end: one ``cache`` obs event with the session's traffic,
        rolled into the process totals (:func:`resident_stats`)."""
        from variantcalling_tpu_torch import obs

        st = self.stats()
        with _MEMORY_LOCK:
            for k, v in st.items():
                _TOTALS[k] += v
            _TOTALS["sessions"] += 1
        if obs.active():
            obs.event("cache", "session", **st)


def open_session(config: dict) -> CacheSession | None:
    """None when the cache is off; else a session over the in-memory index
    (:func:`resident_mode`) and the on-disk store. An unusable cache
    directory degrades to whatever store remains, never fails the run."""
    if not enabled():
        return None
    fp = identity_mod.fingerprint(identity_mod.cache_identity(config))
    stores: list = []
    mem = _memory_store()
    if mem is not None:
        stores.append(mem)
    try:
        stores.append(DiskStore(store_dir(), max_bytes()))
    except OSError as e:
        degrade.record("chunk_cache.store_open", e, warn=True,
                       fallback="chunk cache disabled for this run" if not stores else "in-memory index only")
    if not stores:
        return None
    return CacheSession(fp, stores)
