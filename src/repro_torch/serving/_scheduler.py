"""Continuous-batching scheduler over the paged KV manager.

The scheduler is the "OS" of the serving stack: it admits requests while
physical KV pages are available, allocates/frees pages through
KVPageManager, and — NDPage's runtime decision — picks the table
organization per step from measured occupancy (flat once occupancy crosses
the threshold, which for dense decode is immediately; radix only helps
sparse/prefix-shared mappings).  Table rows are memoized in the
TranslationCache (the PWC analogue) keyed by (seq, version); the cache
owns the version counters (bumped on mapping growth and on invalidate).

Host-side numpy, copied from ``repro.serving._scheduler``.  The
``meter`` hook (a translation cost meter that prices every step) stays
``None`` until the port has the cost model of the simulator slice.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.kv_page_manager import KVPageManager
from repro_torch.core.translation_cache import TranslationCache
from repro_torch.util import resilience


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray               # (S_prompt,) int32
    max_new_tokens: int = 32
    generated: List[int] = dataclasses.field(default_factory=list)
    #: higher wins admission and survives eviction longer; ties resolve
    #: to arrival order (admission) / latest arrival (eviction victim)
    priority: int = 0
    #: give up if not finished within this many scheduler clock ticks of
    #: submission (None = no deadline)
    deadline_steps: Optional[int] = None
    #: preemptions tolerated before the request is shed for good
    max_retries: int = 3
    # -- runtime bookkeeping (scheduler-owned) -------------------------------
    retries: int = 0
    submit_tick: int = -1
    not_before: int = 0              # backoff gate for re-admission
    admit_seq: int = -1              # admission order (victim tie-break)
    failed: Optional[str] = None     # "shed" | "deadline" when given up

    @classmethod
    def build(cls, req_id: int, prompt, *, max_new_tokens: int = 32,
              priority: int = 0, deadline_steps: Optional[int] = None,
              max_retries: int = 3) -> "Request":
        """The public constructor: exactly the caller-owned fields,
        keyword-only.  Runtime bookkeeping (``submit_tick``,
        ``admit_seq``, ``retries``, ``not_before``, ``failed``) belongs
        to the scheduler — callers building requests this way can never
        poke it."""
        return cls(req_id=req_id,
                   prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=max_new_tokens, priority=priority,
                   deadline_steps=deadline_steps, max_retries=max_retries)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def effective_prompt(self) -> np.ndarray:
        """The token stream to teacher-force at (re-)admission: the
        prompt plus everything generated before a preemption.  Greedy
        decode is deterministic, so re-prefilling this stream rebuilds
        the KV cache bit-exactly and the continuation matches the
        never-preempted run."""
        if not self.generated:
            return self.prompt
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.generated, np.int32)])


class BatchScheduler:
    #: bound on the given-up-requests history (the same reason the
    #: meter bounds its step/retired histories): under sustained
    #: shedding an unbounded ``failed`` list is a leak at fleet scale
    FAILED_HISTORY = 4096

    def __init__(self, kvm: KVPageManager, max_batch: int,
                 table_mode: Optional[str] = None, meter=None):
        self.kvm = kvm
        self.max_batch = max_batch
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(max_batch - 1, -1, -1))
        self.table_mode = table_mode          # None = occupancy-driven
        self.tcache = TranslationCache(capacity=4 * max_batch)
        #: optional translation cost meter (None until the port has
        #: the simulator slice's cost model)
        self.meter = meter
        self.stats = {"admitted": 0, "completed": 0, "preempted": 0,
                      "shed": 0, "deadline_dropped": 0, "resumed": 0,
                      "steps": 0}
        #: engine-driven clock (one tick per engine loop iteration, even
        #: when nothing is running) — backoff and deadlines key off it
        self.clock = 0
        #: requests given up on (``req.failed`` says why) — a bounded
        #: deque: only the most recent ``FAILED_HISTORY`` are retained
        #: (``stats["shed"]``/``stats["deadline_dropped"]`` stay exact)
        self.failed: Deque[Request] = deque(maxlen=self.FAILED_HISTORY)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.submit_tick < 0:
            req.submit_tick = self.clock
        self.queue.append(req)

    def tick(self) -> None:
        """Advance the scheduler clock (the engine calls this once per
        loop iteration, running or not, so backoff gates and deadlines
        make progress even while the batch is empty)."""
        self.clock += 1

    def _can_admit(self, req: Request) -> bool:
        need = -(-max(len(req.effective_prompt()), 1)
                 // self.kvm.page_size) + 1
        return bool(self.free_slots) and self.kvm.pool.free_pages >= need

    def _next_admissible(self) -> Optional[Request]:
        """Highest-priority queued request whose backoff gate has
        opened; FIFO within a priority class (stable sort).  Expired
        deadlines are dropped here."""
        for req in list(self.queue):
            if (req.deadline_steps is not None
                    and self.clock - req.submit_tick > req.deadline_steps):
                self.queue.remove(req)
                req.failed = "deadline"
                self.failed.append(req)
                self.stats["deadline_dropped"] += 1
                self.tcache.invalidate(req.req_id)
                if self.meter is not None:
                    self.meter.retire_request(req.req_id)
        ready = [r for r in self.queue if r.not_before <= self.clock]
        if not ready:
            return None
        return max(ready, key=lambda r: r.priority)   # max() is stable

    def admit(self) -> List[Tuple[int, Request]]:
        """Admit queued requests into free slots; returns new (slot, req).

        Head-of-line blocking is per priority class: if the best
        eligible request does not fit, nothing behind it jumps the
        queue (no starvation of big requests)."""
        admitted = []
        while True:
            req = self._next_admissible()
            if req is None or not self._can_admit(req):
                break
            self.queue.remove(req)
            slot = self.free_slots.pop()
            self.kvm.add_sequence(req.req_id, len(req.effective_prompt()))
            self.running[req.req_id] = req
            self.slot_of[req.req_id] = slot
            req.admit_seq = self.stats["admitted"]
            self.stats["admitted"] += 1
            if req.retries:
                self.stats["resumed"] += 1
            admitted.append((slot, req))
        return admitted

    # -- preemption / shedding ----------------------------------------------
    def pick_victim(self, prefer_not: Optional[int] = None
                    ) -> Optional[int]:
        """The running seq to evict under pressure: lowest priority,
        latest admission breaking ties (oldest work is preserved).
        ``prefer_not`` (the seq asking for pages) loses priority ties
        but a genuinely lower-priority runner is ALWAYS the victim —
        growth must never evict a higher-priority sequence."""
        if not self.running:
            return None
        return max(self.running,
                   key=lambda s: (-self.running[s].priority,
                                  s != prefer_not,
                                  self.running[s].admit_seq))

    def preempt(self, seq_id: int, reason: str = "evict") -> Request:
        """Evict a running request: free its slot and KV pages,
        invalidate its translation-cache rows (version floor advances —
        a recycled id can never hit the stale mapping), and either
        requeue it with exponential backoff or shed it for good once
        ``max_retries`` is exhausted.  The meter keeps accumulating
        across preemptions (re-prefill translation work is real work)."""
        req = self.running.pop(seq_id)
        slot = self.slot_of.pop(seq_id)
        self.free_slots.append(slot)
        self.kvm.free_sequence(seq_id)
        self.tcache.invalidate(seq_id)
        self.stats["preempted"] += 1
        req.retries += 1
        if req.retries > req.max_retries:
            req.failed = "shed"
            self.failed.append(req)
            self.stats["shed"] += 1
            if self.meter is not None:
                self.meter.retire_request(seq_id)
        else:
            req.not_before = self.clock + 2 ** req.retries
            self.queue.append(req)
        resilience.log_event(
            "preempt", f"seq {seq_id} ({reason}), retry {req.retries}"
                       f"/{req.max_retries}, "
                       f"{len(req.generated)} tokens kept")
        return req

    def grow(self, seq_id: int) -> bool:
        """Grow ``seq_id``'s mapping by one token, shedding the lowest-
        priority runner on pool exhaustion until the allocation fits.
        Returns False when ``seq_id`` itself was the victim of last
        resort (caller must stop touching its slot this step)."""
        while True:
            try:
                old_pages = len(self.kvm.pages[seq_id])
                self.kvm.append_token(seq_id)
                if len(self.kvm.pages[seq_id]) != old_pages:
                    self.tcache.bump(seq_id)     # mapping changed
                return True
            except MemoryError:
                victim = self.pick_victim(prefer_not=seq_id)
                if victim is None:
                    raise
                self.preempt(victim, reason="overload")
                if victim == seq_id:
                    return False

    # -- step bookkeeping ----------------------------------------------------
    def active_seqs(self) -> List[int]:
        return sorted(self.running, key=lambda r: self.slot_of[r])

    def step_tables(self):
        """(mode, table rows per running seq, lengths) for the decode step."""
        mode = self.table_mode or self.kvm.preferred_mode()
        seqs = self.active_seqs()
        rows = []
        hits = np.zeros(len(seqs), bool)
        for i, sid in enumerate(seqs):
            row = self.tcache.lookup(sid)
            if row is None:
                pages = self.kvm.pages[sid]
                row = np.full(self.kvm.max_pages, -1, np.int32)
                row[: len(pages)] = pages
                self.tcache.insert(sid, None, row)
            else:
                hits[i] = True
            rows.append(row)
        lengths = np.asarray([self.kvm.lengths[s] for s in seqs], np.int32)
        self.stats["steps"] += 1
        stacked = (np.stack(rows) if rows
                   else np.zeros((0, self.kvm.max_pages), np.int32))
        if self.meter is not None and rows:
            # price the step: a hit is the TLB-hit analogue, a miss a
            # table walk whose cost scales with the touched PTE lines
            # of the rebuilt row under each mechanism's organization
            self.meter.record_step(seqs, hits, stacked,
                                   self.kvm.leaf_size)
        return mode, stacked, lengths

    def record_tokens(self, tokens: Dict[int, int]) -> List[Request]:
        """Append generated tokens; grow mappings (shedding under
        overload); retire finished."""
        finished = []
        for sid, tok in tokens.items():
            if sid not in self.running:       # evicted earlier this step
                continue
            req = self.running[sid]
            req.generated.append(int(tok))
            if req.done:
                continue                      # retires below; no growth
            self.grow(sid)
        for sid in list(self.running):
            if self.running[sid].done:
                req = self.running.pop(sid)
                slot = self.slot_of.pop(sid)
                self.free_slots.append(slot)
                self.kvm.free_sequence(sid)
                self.tcache.invalidate(sid)
                if self.meter is not None:
                    self.meter.retire_request(sid)
                self.stats["completed"] += 1
                finished.append(req)
        return finished
