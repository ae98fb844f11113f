"""Recovery event log and deterministic fault injection for serving.

The part of ``repro.util.resilience`` that the scheduler and engine
call: :func:`log_event` records every recovery decision in a bounded
process-wide log, and :class:`FaultInjector` replays a deterministic
fault plan against the instrumented sites, so chaos tests can prove that
injected faults cost only retries (outputs stay bit-exact vs a
fault-free run).  The integrity-checked cache entries and the watchdog
belong to the simulator slice and are not ported yet.

Each fault names its site, an occurrence set (``at``) counted per
(site, match) pair, and an optional substring ``match`` on the site tag.
Install a plan process-wide with :func:`inject_faults`; instrumented
sites consult :func:`fault_injector`.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

_EVENTS: "deque[Tuple[str, str]]" = deque(maxlen=512)
_EVENTS_LOCK = threading.Lock()


def log_event(kind: str, detail: str) -> None:
    """Record one recovery decision (evict / fault_injected / ...) in the
    bounded process-wide log."""
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

    site: str                    # evict (the only site ported so far)
    at: Tuple[int, ...] = (0,)
    match: str = ""

    def __post_init__(self):
        if self.site != "evict":
            raise ValueError(f"unknown fault site {self.site!r}")


class FaultInjector:
    """Deterministic fault plan replay.  The injector counts occurrences
    per (site, match) pair, so a plan is insensitive to unrelated traffic
    on the same site with different tags."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults = tuple(faults)
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
    def from_plan(cls, name: str) -> "FaultInjector":
        """A named fault plan (the serving plan of the JAX package's
        matrix; the cache and dispatch plans come with the simulator
        slice)."""
        plans: Dict[str, Tuple[Fault, ...]] = {
            # repeated mid-decode evictions: preempt -> re-prefill
            "evict_storm": (Fault("evict", at=(0, 1, 2)),),
        }
        if name not in plans:
            raise KeyError(f"unknown fault plan {name!r}; "
                           f"available: {sorted(plans)}")
        return cls(plans[name])


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
