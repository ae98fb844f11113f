"""Recovery event log, deterministic fault injection, the
integrity-checked cache store, and the dispatch watchdog.

The part of ``repro.util.resilience`` that the serving path, the
simulator's trace cache and the sweep engine call: :func:`log_event`
records every recovery decision in a bounded process-wide log;
:class:`FaultInjector` replays a deterministic fault plan against the
instrumented sites, so chaos tests can prove that injected faults cost
only retries; :func:`write_bytes` / :func:`read_bytes` (with their npz
and json forms) publish cache entries atomically (temp file + rename)
beside a sha256 sidecar, and move an entry that fails its check to
``quarantine/`` so the caller recomputes it; and :func:`watchdog_call`
bounds one simulator dispatch by a wall-clock deadline with a retry.

Fault sites:

  ``cache_read``   a verified cache read: the entry is quarantined and
                   the caller recomputes
  ``cache_write``  a cache write fails: the store degrades to cache-off
                   and the caller keeps its computed value
  ``dispatch``  the matching simulator dispatch raises
                :class:`DispatchTimeout`: the watchdog clears the bucket
                plans and retries once
  ``evict``     the serving scheduler preempts the matching live
                sequence mid-decode: pages freed, translation-cache
                versions bumped, request re-queued for re-prefill

Each fault names its site, an occurrence set (``at``) counted per
(site, match) pair, and an optional substring ``match`` on the site tag.
Install a plan process-wide with :func:`inject_faults`; instrumented
sites consult :func:`fault_injector`.

Watchdog on the card.  A CUDA kernel cannot be cancelled from a thread:
a dispatch that times out is abandoned, not stopped, and its work stays
queued on the stream, so the retry runs behind it.  On the card the
retry therefore helps only against a hang on the host (trace set-up, a
lock, a stuck build); a hung kernel holds the stream until it ends.
Injected faults (``timeout_s <= 0``, run inline) are how tests exercise
the retry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

#: sidecar suffix holding the hex sha256 of the entry's bytes
SIDECAR_SUFFIX = ".sha256"
#: subdirectory (of the entry's cache dir) corrupted entries move to
QUARANTINE_DIR = "quarantine"
#: the instrumented fault sites
FAULT_SITES = ("cache_read", "cache_write", "dispatch", "evict")


class DispatchTimeout(RuntimeError):
    """A watchdogged dispatch exceeded its deadline (or a fault plan
    injected one)."""


_EVENTS: "deque[Tuple[str, str]]" = deque(maxlen=512)
_EVENTS_LOCK = threading.Lock()


def log_event(kind: str, detail: str) -> None:
    """Record one recovery decision (quarantine / cache_off / evict /
    fault_injected / resume / watchdog_timeout / watchdog_retry / ...)
    in the bounded process-wide log."""
    with _EVENTS_LOCK:
        _EVENTS.append((kind, detail))


def recovery_events(clear: bool = False) -> List[Tuple[str, str]]:
    """The recovery decisions taken so far, oldest first."""
    with _EVENTS_LOCK:
        out = list(_EVENTS)
        if clear:
            _EVENTS.clear()
    return out


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: fire at the given per-(site, match)
    occurrence indices of ``site`` whose tag contains ``match``."""

    site: str                    # cache_read|cache_write|dispatch|evict
    at: Tuple[int, ...] = (0,)
    match: str = ""

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}")


class FaultInjector:
    """Deterministic fault plan replay.  The injector counts occurrences
    per (site, match) pair, so a plan is insensitive to unrelated traffic
    on the same site with different tags.  ``seed`` is kept for plans
    that draw their occurrences (none of the named plans does); explicit
    :class:`Fault` lists replay as they are."""

    def __init__(self, faults: Iterable[Fault] = (), seed: int = 0):
        self.faults = tuple(faults)
        self.seed = seed
        self._counts: Dict[Tuple[str, str], int] = {}
        self.fired: List[Tuple[str, str, int]] = []   # (site, tag, idx)

    def fires(self, site: str, tag: str = "") -> bool:
        """Advance the matching occurrence counters; True iff any
        planned fault fires at this occurrence."""
        hit = False
        for f in self.faults:
            if f.site != site or f.match not in tag:
                continue
            key = (site, f.match)
            idx = self._counts.get(key, 0)
            self._counts[key] = idx + 1
            if idx in f.at:
                hit = True
                self.fired.append((site, tag, idx))
                log_event("fault_injected", f"{site}[{idx}] {tag}")
        return hit

    @classmethod
    def from_plan(cls, name: str, seed: int = 0) -> "FaultInjector":
        """A named fault plan (the JAX package's chaos matrix)."""
        plans: Dict[str, Tuple[Fault, ...]] = {
            # one corrupt cache read and one failed cache write: the
            # read quarantines and recomputes, the write degrades to
            # cache-off
            "cache_corrupt": (
                Fault("cache_read", at=(0,)),
                Fault("cache_write", at=(0,)),
            ),
            # first dispatch of a bucket hangs; the watchdog clears the
            # bucket plans and the retry completes
            "dispatch_hang": (Fault("dispatch", at=(0,)),),
            # repeated mid-decode evictions: preempt -> re-prefill
            "evict_storm": (Fault("evict", at=(0, 1, 2)),),
        }
        if name not in plans:
            raise KeyError(f"unknown fault plan {name!r}; "
                           f"available: {sorted(plans)}")
        return cls(plans[name], seed=seed)


_INJECTOR: Optional[FaultInjector] = None


def fault_injector() -> Optional[FaultInjector]:
    """The installed process-wide injector, or None (the common case)."""
    return _INJECTOR


class inject_faults:
    """Context manager installing ``injector`` process-wide."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector

    def __enter__(self) -> FaultInjector:
        global _INJECTOR
        self._prev = _INJECTOR
        _INJECTOR = self.injector
        return self.injector

    def __exit__(self, *exc) -> None:
        global _INJECTOR
        _INJECTOR = self._prev


# ---------------------------------------------------------------------------
# integrity-checked cache entries
# ---------------------------------------------------------------------------
def _sidecar(path: str) -> str:
    return path + SIDECAR_SUFFIX


def quarantine(path: str, reason: str) -> Optional[str]:
    """Move a corrupted cache entry (and its sidecar) into the
    ``quarantine/`` subdirectory of its cache dir; returns the new path
    (None if the move failed — the entry is then unlinked so it cannot
    poison the next run either)."""
    qdir = os.path.join(os.path.dirname(path), QUARANTINE_DIR)
    dest = os.path.join(qdir, os.path.basename(path))
    try:
        os.makedirs(qdir, exist_ok=True)
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{os.path.basename(path)}.{n}")
        os.replace(path, dest)
        if os.path.exists(_sidecar(path)):
            os.replace(_sidecar(path), dest + SIDECAR_SUFFIX)
        log_event("quarantine", f"{path} -> {dest} ({reason})")
        return dest
    except OSError:
        for p in (path, _sidecar(path)):
            try:
                os.unlink(p)
            except OSError:
                pass
        log_event("quarantine", f"{path} unlinked ({reason}; "
                                "quarantine dir unwritable)")
        return None


def write_bytes(path: str, data: bytes) -> bool:
    """Atomically publish ``data`` at ``path`` with its sha256 sidecar.
    Any filesystem failure, or an injected ``cache_write`` fault,
    degrades to cache-off (returns False)."""
    tmp = None
    try:
        inj = fault_injector()
        if inj is not None and inj.fires("cache_write", path):
            raise OSError(f"injected cache_write fault: {path}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        # sidecar first: a crash between the two renames leaves a sidecar
        # without an entry (harmless), never an unverifiable entry
        fd2, tmp2 = tempfile.mkstemp(dir=os.path.dirname(path),
                                     suffix=".tmp")
        with os.fdopen(fd2, "w") as f:
            f.write(hashlib.sha256(data).hexdigest())
        os.replace(tmp2, _sidecar(path))
        os.replace(tmp, path)
        return True
    except OSError as e:
        log_event("cache_off", f"write failed: {path} ({e})")
        if tmp is not None and os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def read_bytes(path: str) -> Optional[bytes]:
    """Verified read of one cache entry; None means "recompute".  A
    missing entry gives None; a sidecar mismatch, an unreadable file or
    an injected ``cache_read`` fault quarantines the entry first."""
    if not os.path.exists(path):
        return None
    inj = fault_injector()
    if inj is not None and inj.fires("cache_read", path):
        quarantine(path, "injected cache_read fault")
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        quarantine(path, f"unreadable: {e}")
        return None
    sc = _sidecar(path)
    if os.path.exists(sc):
        try:
            with open(sc) as f:
                want = f.read().strip()
        except OSError:
            want = ""
        if want and hashlib.sha256(data).hexdigest() != want:
            quarantine(path, "sha256 sidecar mismatch")
            return None
    return data


def read_npz(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Verified npz read -> array dict; a corrupt entry (bit flips,
    truncation — with or without a sidecar) is quarantined and None
    returned."""
    data = read_bytes(path)
    if data is None:
        return None
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:               # zipfile/zlib/ValueError zoo
        quarantine(path, f"npz parse failed: {type(e).__name__}: {e}")
        return None


def write_npz(path: str, arrays: Dict) -> bool:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return write_bytes(path, buf.getvalue())


def read_json(path: str):
    """Verified json read; a corrupt entry is quarantined, None returned."""
    data = read_bytes(path)
    if data is None:
        return None
    try:
        return json.loads(data.decode("utf-8"))
    except Exception as e:
        quarantine(path, f"json parse failed: {type(e).__name__}: {e}")
        return None


def write_json(path: str, obj, **dump_kw) -> bool:
    return write_bytes(path, json.dumps(obj, **dump_kw).encode("utf-8"))


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def watchdog_call(fn: Callable[[], object], timeout_s: float, *,
                  tag: str = "", retries: int = 1,
                  on_timeout: Optional[Callable[[], None]] = None):
    """Run ``fn`` under a wall-clock deadline with bounded retries.

    ``timeout_s > 0``: ``fn`` runs on a daemon worker thread; if it has
    not finished after ``timeout_s`` seconds the attempt counts as
    :class:`DispatchTimeout` and the thread is abandoned (it cannot be
    stopped; on the card its kernels stay queued, see the module
    docstring).  ``timeout_s <= 0``: ``fn`` runs inline and only an
    injected ``DispatchTimeout`` can fire.

    On timeout, ``on_timeout()`` runs before the retry (the sweep engine
    clears the bucket plans there).  The last attempt's timeout
    propagates.
    """
    last: Optional[DispatchTimeout] = None
    for attempt in range(retries + 1):
        try:
            if timeout_s and timeout_s > 0:
                result: list = []
                error: list = []

                def _run():
                    try:
                        result.append(fn())
                    except BaseException as e:   # noqa: BLE001
                        error.append(e)

                t = threading.Thread(target=_run, daemon=True,
                                     name=f"watchdog:{tag}")
                t.start()
                t.join(timeout_s)
                if t.is_alive():
                    raise DispatchTimeout(
                        f"{tag or 'dispatch'} exceeded {timeout_s}s "
                        f"(attempt {attempt + 1})")
                if error:
                    raise error[0]
                return result[0]
            return fn()
        except DispatchTimeout as e:
            last = e
            log_event("watchdog_timeout", f"{tag} attempt {attempt + 1}: {e}")
            if attempt >= retries:
                raise
            if on_timeout is not None:
                on_timeout()
            log_event("watchdog_retry", f"{tag} retrying "
                                        f"(attempt {attempt + 2})")
    raise last if last else RuntimeError("unreachable")
