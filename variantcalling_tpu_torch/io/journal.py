"""Chunk journal for resumable, atomic streaming writeback.

Counterpart of ``variantcalling_tpu/io/journal.py``, with the same files and
formats. The streaming filter executor writes its output through two files,
so that an interrupted run never leaves a partial file at the destination
and can resume instead of recomputing:

- ``<out>.partial.<pid>-<hex>``: the output bytes as they accumulate,
  renamed onto the destination (``os.replace``, atomic on POSIX) after the
  last chunk. The destination holds a previous complete file or nothing.
- ``<out>.journal``: one JSON line per committed chunk (sequence number,
  record and pass counts, body length, CRC32), after a header line binding
  the journal to the exact input file (size + mtime_ns), chunk size, output
  header bytes and scoring configuration (``io/identity.py``). A line is
  appended and flushed after the chunk's bytes are in the partial file, so
  the journal never claims more than the partial holds.

Resume: chunk boundaries are a function of (input bytes, chunk_bytes),
every per-variant product is row-local, and the journal pins both, so
"skip the journaled chunks, truncate the partial to the journaled
watermark, continue" reproduces the uninterrupted output byte for byte.
Anything suspicious (identity mismatch, a corrupt line, a CRC mismatch, a
partial shorter than the watermark) degrades to a fresh run.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import zlib
from dataclasses import dataclass, field

from variantcalling_tpu_torch import knobs
from variantcalling_tpu_torch.io import identity as identity_mod

log = logging.getLogger(__name__)

JOURNAL_SUFFIX = ".journal"
PARTIAL_SUFFIX = ".partial"
_VERSION = 1


def fsync_enabled() -> bool:
    """``VCTPU_JOURNAL_FSYNC``: fsync the partial and the journal per chunk."""
    return knobs.get_bool("VCTPU_JOURNAL_FSYNC")


def partial_path(out_path: str, token: str | None = None) -> str:
    """The in-flight output path; ``token`` (:func:`new_partial_token`) makes
    it run-unique, so two concurrent runs to one output never write into
    each other's partial. ``None``: the fixed name of older journals."""
    base = str(out_path) + PARTIAL_SUFFIX
    return f"{base}.{token}" if token else base


def open_partial(out_path: str, token: str | None, mode: str = "wb"):
    """Open the in-flight partial of ``out_path``."""
    return open(partial_path(out_path, token), mode)


def remove_partial(out_path: str, token: str | None) -> None:
    """Best-effort removal of the in-flight partial (the failure exit of a
    run that cannot resume)."""
    try:
        os.remove(partial_path(out_path, token))
    except OSError:
        pass


def commit_partial(out_path: str, token: str | None) -> None:
    """Atomically rename the partial onto its destination."""
    os.replace(partial_path(out_path, token), out_path)


def new_partial_token() -> str:
    """A fresh run-unique partial suffix. The leading pid matters:
    :func:`cleanup_stale_partials` only sweeps partials whose owning process
    is dead."""
    return f"{os.getpid()}-{os.urandom(4).hex()}"


def _token_pid(token: str) -> int | None:
    head = token.split("-", 1)[0]
    return int(head) if head.isdigit() else None


#: partial tokens with an open sink in this process (pid liveness alone
#: cannot tell this process's live run from its own failed one)
_ACTIVE_TOKENS: set[str] = set()


def claim_token(token: str) -> None:
    _ACTIVE_TOKENS.add(token)


def release_token(token: str) -> None:
    _ACTIVE_TOKENS.discard(token)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: alive under another uid
    return True


def token_in_use(token: str) -> bool:
    """Whether a running process owns this partial: another live pid always
    counts; this process's pid only while an open sink claims the token."""
    pid = _token_pid(token)
    if pid is None or not _pid_alive(pid):
        return False
    if pid != os.getpid():
        return True
    return token in _ACTIVE_TOKENS


def cleanup_stale_partials(out_path: str) -> None:
    """Remove abandoned unique-suffix partials next to ``out_path``: those no
    running process owns (:func:`token_in_use`)."""
    prefix = str(out_path) + PARTIAL_SUFFIX + "."
    for p in glob.glob(glob.escape(str(out_path) + PARTIAL_SUFFIX) + ".*"):
        token = p[len(prefix):]
        if _token_pid(token) is None or token_in_use(token):
            continue
        try:
            os.remove(p)
            log.info("swept stale partial %s (no live owner)", p)
        except OSError:
            pass


def journal_path(out_path: str) -> str:
    return str(out_path) + JOURNAL_SUFFIX


@dataclass
class ResumeState:
    """What a valid journal and partial file let a run skip."""

    chunks: int  # complete chunks already in the partial file
    watermark: int  # byte offset in the partial file after those chunks
    n_records: int
    n_pass: int
    #: the partial's suffix, re-tokened under this process
    partial_token: str | None = None


@dataclass
class ChunkJournal:
    """Writer and loader of the ``<out>.journal`` sidecar."""

    out_path: str
    _fh: object | None = field(default=None, repr=False)

    def begin(self, meta: dict) -> None:
        """Start a fresh journal with the run-identity header line."""
        meta = dict(meta, version=_VERSION)
        self._fh = open(journal_path(self.out_path), "w", encoding="utf-8")
        self._fh.write(json.dumps(meta, sort_keys=True) + "\n")
        self._fh.flush()

    def reopen(self) -> None:
        """Append to an existing journal (resume)."""
        self._fh = open(journal_path(self.out_path), "a", encoding="utf-8")

    def append(self, seq: int, records: int, passed: int, body_len: int, crc: int,
               in_end: int | None = None) -> None:
        if self._fh is None:
            raise RuntimeError("journal not started")
        entry = {"seq": seq, "records": records, "pass": passed, "body_len": body_len, "crc": crc}
        if in_end is not None:
            # the absolute decompressed end offset of the chunk's input span
            entry["in_end"] = int(in_end)
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()
        if fsync_enabled():
            # the line reaches the disk before the next chunk starts: a
            # power cut can then cost at most the chunk in flight
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def finish(self) -> None:
        """Successful completion: remove the journal."""
        self.close()
        try:
            os.remove(journal_path(self.out_path))
        except OSError:
            pass

    @staticmethod
    def load(out_path: str) -> tuple[dict, list[dict]] | None:
        """(meta, entries) of an existing journal; None when absent or
        unreadable. A torn last line (killed mid-append) is dropped; any
        earlier corruption invalidates the journal."""
        try:
            with open(journal_path(out_path), encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            return None
        if not lines:
            return None
        try:
            meta = json.loads(lines[0])
        except ValueError:
            return None
        if not isinstance(meta, dict) or meta.get("version") != _VERSION:
            return None
        entries: list[dict] = []
        for i, line in enumerate(lines[1:]):
            try:
                e = json.loads(line)
            except ValueError:
                if i == len(lines) - 2:  # torn tail line: drop it
                    break
                return None
            if not isinstance(e, dict) or e.get("seq") != len(entries):
                return None  # out-of-order or duplicated entries: distrust all
            entries.append(e)
        return meta, entries


def try_resume(out_path: str, meta: dict, claim: bool = False) -> ResumeState | None:
    """Check the journal and partial against this run's identity ``meta``
    and prepare the partial for continuation: truncated to the journaled
    watermark (healing a torn final chunk) and re-tokened under this
    process. Any mismatch or malformation returns None (a fresh run).
    ``claim=True`` claims the new token atomically with the rename; the
    caller then owns :func:`release_token`."""
    try:
        return _try_resume(out_path, meta, claim=claim)
    except (KeyError, ValueError, TypeError, OSError):
        log.info("streaming resume: malformed journal — fresh run")
        return None


def _try_resume(out_path: str, meta: dict, claim: bool = False) -> ResumeState | None:
    loaded = ChunkJournal.load(out_path)
    if loaded is None:
        return None
    jmeta, entries = loaded
    expect = dict(meta, version=_VERSION)
    if {k: jmeta.get(k) for k in expect} != expect:
        log.info("streaming resume: journal identity mismatch (%s) — fresh run",
                 identity_mod.describe_mismatch({k: jmeta.get(k) for k in expect}, expect))
        return None
    if not entries:
        return None
    token = jmeta.get("partial") or None
    if token is not None and token_in_use(token):
        log.info("streaming resume: the journal's partial is owned by a running process — fresh run")
        return None
    part = partial_path(out_path, token)
    try:
        size = os.path.getsize(part)
    except OSError:
        return None
    watermark = int(meta["header_len"]) + sum(int(e["body_len"]) for e in entries)
    if size < watermark:
        log.info("streaming resume: partial file behind the journal — fresh run")
        return None
    with open(part, "rb") as fh:
        if knobs.get_str("VCTPU_RESUME_VERIFY") == "full":
            # re-read and CRC-check every journaled chunk and the header
            head = fh.read(int(meta["header_len"]))
            if zlib.crc32(head) != int(meta["header_crc"]):
                log.info("streaming resume: header CRC mismatch (full verify) — fresh run")
                return None
            for e in entries:
                body = fh.read(int(e["body_len"]))
                if len(body) != int(e["body_len"]) or zlib.crc32(body) != int(e["crc"]):
                    log.info("streaming resume: chunk %d CRC mismatch (full verify) — fresh run", int(e["seq"]))
                    return None
        else:
            # default: check the last journaled chunk's bytes
            last = entries[-1]
            fh.seek(watermark - int(last["body_len"]))
            if zlib.crc32(fh.read(int(last["body_len"]))) != int(last["crc"]):
                log.info("streaming resume: chunk CRC mismatch — fresh run")
                return None
    if size > watermark:  # torn final chunk beyond the journal: heal it
        with open(part, "r+b") as fh:
            fh.truncate(watermark)
    # re-token: the resumed run owns its partial under its own pid, so a
    # concurrent run's sweep of dead owners cannot delete it
    new_token = new_partial_token()
    if claim:
        claim_token(new_token)  # before the file exists: no sweep gap
    try:
        os.rename(part, partial_path(out_path, new_token))
        # rewrite the journal (meta with the new token, the checked entries):
        # appending after a torn tail line would poison the next resume
        j = ChunkJournal(out_path)
        j.begin(dict(jmeta, partial=new_token))
        for e in entries:
            j.append(int(e["seq"]), int(e["records"]), int(e["pass"]), int(e["body_len"]), int(e["crc"]),
                     in_end=e.get("in_end"))
        j.close()
    except BaseException:
        if claim:
            release_token(new_token)
        raise
    return ResumeState(chunks=len(entries), watermark=watermark,
                       n_records=sum(int(e["records"]) for e in entries),
                       n_pass=sum(int(e["pass"]) for e in entries), partial_token=new_token)


def discard(out_path: str) -> None:
    """Remove the journal and its partial (a run that cannot resume, or a
    fresh run superseding leftovers), unless a running process owns that
    partial, then sweep abandoned partials of dead runs."""
    loaded = ChunkJournal.load(out_path)
    token = loaded[0].get("partial") if loaded else None
    paths = [journal_path(out_path), partial_path(out_path)]
    if token and not token_in_use(token):
        paths.append(partial_path(out_path, token))
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass
    cleanup_stale_partials(out_path)
