"""Fleet-scale continuous batching: thousands of live sequences,
array-at-once.

The port of ``repro.serving.fleet``.
:class:`repro_torch.serving.BatchScheduler` / :class:`ServeEngine` run
the real model at toy batch sizes; this module is the same serving design
scaled to production shape.  :class:`FleetScheduler` keeps every piece
of per-request state in struct-of-arrays form so admission, deadline
sweeps, page growth, translation pricing and retirement are single
numpy operations over the whole batch — NO per-request Python loop runs
on the step path (per-request work happens only at per-lifetime events:
submit, admission placement, preemption, retirement).

The pieces, mirroring the small-batch stack one-for-one:

  mapping          a (max_batch, max_pages) int32 slot table over a
                   refcounted :class:`~repro_torch.core.kv_page_manager.
                   PagePool` — the KV page manager's role, vectorized
  translation      a per-slot dirty bit replaces the TranslationCache:
                   a slot hits unless its mapping changed since the
                   last priced step (the LRU's capacity, 4x batch,
                   exceeds the running set, so the semantics coincide)
  pricing          :meth:`TranslationMeter.record_slots` — the
                   vectorized twin of ``record_step``: per-slot budget
                   matrix, flushed to dicts only at release
  prefix sharing   requests carrying the same ``prefix_id`` share the
                   fully-covered pages of their prompt head through
                   pool refcounts; radix-org line pricing then dedups
                   identical leaves batch-globally
                   (``cost_model._np_row_lines_shared``) — the radix
                   line-sharing win the flat org cannot have
  admission        priority-ordered feasibility by cumulative page
                   need AND (optionally) cumulative estimated
                   translation cycles against ``translation_budget`` —
                   translation cost as a first-class admission input

:class:`FleetEngine` drives the loop with a single surrogate decode on
``device`` (the card by default, raising without one): a deterministic
uint32 hash of ``(token, position)`` — greedy-decode shaped and
resume-exact — computed in int64 torch ops.  The JAX package jits it
once for the whole fleet; here the decode FUNCTION is built once per
(vocab, device), and ``decode_trace_count()`` counts those builds.
Teacher-forced replay after preemption rebuilds the stream bit-exactly,
so the evict-storm chaos invariant holds at fleet scale.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import block_table as BT
from repro_torch.core.kv_page_manager import PagePool
from repro_torch.serving._scheduler import Request
from repro_torch.sim.cost_model import (ORG_FLAT, ORG_INV, ORG_RADIX,
                                        TranslationMeter, _usable_leaf_size)
from repro_torch.util import resilience
from repro_torch.util.device import DeviceLike, resolve_device

#: request store states
QUEUED, RUNNING, DONE, FAILED = 0, 1, 2, 3

#: surrogate-decode vocabulary (any fixed power of two works)
VOCAB = 32768

#: times a surrogate decode function has been BUILT (one per (vocab,
#: device)) — the port's counterpart of the JAX package's trace count
_DECODE_TRACES = [0]

_U32 = 0xFFFFFFFF


def decode_trace_count() -> int:
    return _DECODE_TRACES[0]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a uint32
    constant, without int64 overflow: the two 16-bit halves of ``x``
    are multiplied apart (each product below 2**48)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


@functools.lru_cache(maxsize=None)
def _decode_fn(vocab: int, device: torch.device
               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The surrogate decode on ``device``: next token = the uint32 hash
    of (current token, position) of the JAX package's jitted step, in
    int64 torch ops masked to 32 bits after every multiply and add.
    Deterministic per (token, pos), so a preempted request that
    teacher-forces its prompt + prior tokens reproduces the
    continuation bit-exactly."""
    _DECODE_TRACES[0] += 1

    def step(tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = _mul32(tokens.to(device=device, dtype=torch.int64) & _U32,
                   2654435761)
        x = (x + _mul32(pos.to(device=device, dtype=torch.int64) & _U32,
                        40503)) & _U32
        x = (x + 0x9E3779B9) & _U32
        x = x ^ (x >> 13)
        x = _mul32(x, 2246822519)
        x = x ^ (x >> 16)
        return (x % vocab).to(torch.int32)

    return step


class FleetScheduler:
    """Struct-of-arrays continuous-batching scheduler (see module doc).

    Semantics mirror :class:`BatchScheduler`: priority admission with
    per-class head-of-line blocking, exponential-backoff preemption,
    shedding after ``max_retries``, queued-deadline drops, and
    translation pricing of every step under all mechanisms at once.
    """

    FAILED_HISTORY = 4096

    _R_FIELDS = ("r_prio", "r_deadline", "r_submit", "r_not_before",
                 "r_retries", "r_max_retries", "r_max_new", "r_prefix",
                 "r_prefix_len", "r_base", "r_eff", "r_status",
                 "r_admit_seq")

    def __init__(self, *, num_pages: int, max_batch: int, page_size: int,
                 max_len: int, leaf_size: int = 4,
                 flatten_threshold: float = 0.5,
                 table_mode: Optional[str] = None, meter=None,
                 prefix_sharing: bool = True,
                 translation_budget: Optional[float] = None,
                 budget_mech: str = "ndpage", budget_patience: int = 4,
                 failed_history: int = FAILED_HISTORY):
        self.pool = PagePool(num_pages)
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_len = max_len
        self.max_pages = -(-max_len // page_size)
        self.leaf_size = _usable_leaf_size(self.max_pages, leaf_size)
        self.flatten_threshold = flatten_threshold
        self.table_mode = table_mode
        self.meter = meter
        self.prefix_sharing = prefix_sharing
        self.translation_budget = translation_budget
        self.budget_mech = budget_mech
        self.budget_patience = budget_patience
        if translation_budget is not None:
            if meter is None:
                raise ValueError("translation_budget needs a meter "
                                 "(admission estimates price against "
                                 "its cost model)")
            self._budget_cost = meter.model.cost(budget_mech)
        self._over_budget = 0
        self._est_sum = 0.0

        b = max_batch
        # -- slot state (the step-path arrays) ------------------------------
        self.slot_req = np.full(b, -1, np.int64)      # request-store index
        self.slot_pages = np.full((b, self.max_pages), -1, np.int32)
        self.slot_npages = np.zeros(b, np.int32)
        self.slot_len = np.zeros(b, np.int32)         # steps taken
        self.slot_eff = np.zeros(b, np.int32)         # stream length
        self.slot_base = np.zeros(b, np.int32)        # original prompt len
        self.slot_miss = np.zeros(b, bool)            # mapping changed
        self.slot_tokens = np.zeros((b, max_len), np.int32)
        self.slot_pfx = np.full(b, -1, np.int64)      # live prefix id
        self.slot_est = np.zeros(b, np.float64)       # admission estimate
        self._free_slots = list(range(b - 1, -1, -1))

        # -- request store (struct-of-arrays, capacity-doubled) -------------
        self._cap = 1024
        self._n = 0
        self.reqs: List[Request] = []
        self.r_prio = np.zeros(self._cap, np.int32)
        self.r_deadline = np.full(self._cap, -1, np.int32)
        self.r_submit = np.zeros(self._cap, np.int32)
        self.r_not_before = np.zeros(self._cap, np.int32)
        self.r_retries = np.zeros(self._cap, np.int32)
        self.r_max_retries = np.zeros(self._cap, np.int32)
        self.r_max_new = np.zeros(self._cap, np.int32)
        self.r_prefix = np.full(self._cap, -1, np.int64)
        self.r_prefix_len = np.zeros(self._cap, np.int32)
        self.r_base = np.zeros(self._cap, np.int32)
        self.r_eff = np.zeros(self._cap, np.int32)
        self.r_status = np.zeros(self._cap, np.int8)
        self.r_admit_seq = np.full(self._cap, -1, np.int64)

        # -- prefix registry (prefix_id -> live shared pages) ---------------
        self._pfx_pages: Dict[int, np.ndarray] = {}
        self._pfx_sharers: Dict[int, int] = {}

        self.clock = 0
        self._admit_seq = 0
        self.stats = {"admitted": 0, "completed": 0, "preempted": 0,
                      "shed": 0, "deadline_dropped": 0, "resumed": 0,
                      "steps": 0, "peak_running": 0,
                      "mode_flat_steps": 0, "mode_radix_steps": 0}
        self.failed: Deque[Request] = deque(maxlen=failed_history)

    # -- submission ----------------------------------------------------------
    def _ensure(self, n: int) -> None:
        if n <= self._cap:
            return
        cap = max(self._cap * 2, n)
        for name in self._R_FIELDS:
            arr = getattr(self, name)
            grown = np.full(cap, -1, arr.dtype) if name in (
                "r_deadline", "r_prefix", "r_admit_seq") \
                else np.zeros(cap, arr.dtype)
            grown[:self._cap] = arr
            setattr(self, name, grown)
        self._cap = cap

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("fleet requests need max_new_tokens >= 1")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.req_id}: prompt + max_new_tokens = "
                f"{len(req.prompt) + req.max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        if req.prefix_id is not None and req.prefix_id < 0:
            raise ValueError(f"prefix_id must be >= 0, got {req.prefix_id}")
        if req.submit_tick < 0:
            req.submit_tick = self.clock
        i = self._n
        self._ensure(i + 1)
        self.reqs.append(req)
        self.r_prio[i] = req.priority
        self.r_deadline[i] = (-1 if req.deadline_steps is None
                              else req.deadline_steps)
        self.r_submit[i] = req.submit_tick
        self.r_not_before[i] = req.not_before
        self.r_retries[i] = req.retries
        self.r_max_retries[i] = req.max_retries
        self.r_max_new[i] = req.max_new_tokens
        self.r_prefix[i] = -1 if req.prefix_id is None else req.prefix_id
        self.r_prefix_len[i] = req.prefix_len
        self.r_base[i] = len(req.prompt)
        self.r_eff[i] = len(req.effective_prompt())
        self.r_status[i] = QUEUED
        self.r_admit_seq[i] = -1
        self._n += 1

    def tick(self) -> None:
        self.clock += 1

    # -- introspection -------------------------------------------------------
    @property
    def num_running(self) -> int:
        return self.max_batch - len(self._free_slots)

    def has_queued(self) -> bool:
        return bool((self.r_status[:self._n] == QUEUED).any())

    def occupancy(self) -> float:
        """Used slots / mapped slots across live sequences (the flatten
        signal, same definition as ``KVPageManager.occupancy``)."""
        act = self.slot_req >= 0
        mapped = int(self.slot_npages[act].sum()) * self.page_size
        return int(self.slot_eff[act].sum()) / mapped if mapped else 0.0

    def preferred_mode(self) -> str:
        return (BT.FLAT if self.occupancy() >= self.flatten_threshold
                else BT.RADIX)

    # -- admission (array-at-once) ------------------------------------------
    def _deadline_sweep(self) -> None:
        n = self._n
        expired = np.flatnonzero(
            (self.r_status[:n] == QUEUED) & (self.r_deadline[:n] >= 0)
            & (self.clock - self.r_submit[:n] > self.r_deadline[:n]))
        for i in expired:                 # per-event, bounded by drops
            self._fail(int(i), "deadline")
        self.stats["deadline_dropped"] += expired.size

    def _fail(self, idx: int, reason: str) -> None:
        req = self.reqs[idx]
        req.failed = reason
        self.r_status[idx] = FAILED
        self.failed.append(req)
        if self.meter is not None:
            self.meter.retire_request(req.req_id)

    def _estimate(self, idxs: np.ndarray) -> np.ndarray:
        """Estimated steady-state translation cycles/step per candidate
        under the budget mechanism: a decode step misses when the
        mapping grew (one page boundary per ``page_size`` tokens), and
        a miss walks the candidate's FINAL table (prompt + full
        generation budget) — the conservative admission price."""
        c = self._budget_cost
        final = self.r_base[idxs] + self.r_max_new[idxs]
        pages = (-(-final // self.page_size)).astype(np.float64)
        if c.org == ORG_FLAT:
            lines = np.ceil(pages / BT.PTE_PER_LINE)
        elif c.org == ORG_RADIX:
            lines = 1.0 + np.ceil(pages / self.leaf_size)
        elif c.org == ORG_INV:
            lines = pages
        else:
            lines = np.ones_like(pages)
        p_miss = 1.0 / self.page_size
        return (p_miss * (c.walk + c.pte_line * np.maximum(lines - 1, 0))
                + (1.0 - p_miss) * c.tlb_hit)

    def admit(self) -> List[int]:
        """One admission sweep: drop expired deadlines, order eligible
        queued requests by (priority desc, submit order), and admit the
        longest feasible head — cumulative page need (prefix-discounted
        for live shared prefixes) within the pool AND, under a
        translation budget, cumulative estimated cycles within budget.
        Head-of-line blocking: the first infeasible candidate stops the
        sweep (no starvation of big requests).  Returns filled slots."""
        self._deadline_sweep()
        n = self._n
        eligible = np.flatnonzero(
            (self.r_status[:n] == QUEUED)
            & (self.r_not_before[:n] <= self.clock))
        if eligible.size == 0 or not self._free_slots:
            return []
        order = eligible[np.lexsort((eligible, -self.r_prio[eligible]))]
        eff = np.maximum(self.r_eff[order], 1)
        need = (-(-eff // self.page_size) + 1).astype(np.int64)
        if self.prefix_sharing and self._pfx_pages:
            # discount pages an already-live prefix will provide
            alive = np.sort(np.fromiter(self._pfx_pages, np.int64,
                                        len(self._pfx_pages)))
            sizes = np.asarray([len(self._pfx_pages[int(p)])
                                for p in alive], np.int64)
            pf = self.r_prefix[order]
            pos = np.minimum(np.searchsorted(alive, pf), alive.size - 1)
            live = (pf >= 0) & (alive[pos] == pf)
            cover = np.minimum(self.r_prefix_len[order] // self.page_size,
                               np.where(live, sizes[pos], 0))
            need = np.maximum(need - cover, 1)
        ok = np.cumsum(need) <= self.pool.free_pages
        ok &= np.arange(order.size) < len(self._free_slots)
        if self.translation_budget is not None:
            est = self._estimate(order)
            ok &= (np.cumsum(est) + self._est_sum) <= self.translation_budget
        k = order.size if bool(ok.all()) else int(np.argmin(ok))
        return [self._place(int(i)) for i in order[:k]]

    def _place(self, idx: int) -> int:
        """Put one admitted request into a slot (a per-lifetime event:
        the token-stream copy and prefix-registry bookkeeping are
        inherently per-request; the step path never loops)."""
        req = self.reqs[idx]
        slot = self._free_slots.pop()
        stream = np.asarray(req.effective_prompt(), np.int32)
        eff = max(len(stream), 1)
        need = -(-eff // self.page_size)
        row = self.slot_pages[slot]
        shared = 0
        pid = req.prefix_id if self.prefix_sharing else None
        register = False
        if pid is not None:
            full = req.prefix_len // self.page_size   # fully-covered only
            if pid in self._pfx_pages:
                pfx = self._pfx_pages[pid]
                shared = min(full, len(pfx), need)
                if shared:
                    self.pool.share_array(pfx[:shared])
                    row[:shared] = pfx[:shared]
                    self._pfx_sharers[pid] += 1
                    self.slot_pfx[slot] = pid
            elif full > 0:
                register = True
        try:
            fresh = self.pool.allocate_array(need - shared)
        except MemoryError:
            if shared:                    # unwind the shared references
                self.pool.release_array(row[:shared])
                self._pfx_sharers[pid] -= 1
                self.slot_pfx[slot] = -1
            row[:shared] = -1
            self._free_slots.append(slot)
            raise
        row[shared:need] = fresh
        if register:
            k = min(req.prefix_len // self.page_size, need)
            if k:
                self._pfx_pages[pid] = row[:k].copy()
                self._pfx_sharers[pid] = 1
                self.slot_pfx[slot] = pid

        self.slot_npages[slot] = need
        self.slot_tokens[slot, :len(stream)] = stream
        self.slot_len[slot] = 0
        self.slot_eff[slot] = len(stream)
        self.slot_base[slot] = len(req.prompt)
        self.slot_miss[slot] = True       # fresh mapping: first step walks
        self.slot_req[slot] = idx
        self.r_status[idx] = RUNNING
        self.r_admit_seq[idx] = self._admit_seq
        self._admit_seq += 1
        self.stats["admitted"] += 1
        if self.r_retries[idx]:
            self.stats["resumed"] += 1
        if self.meter is not None:
            self.meter.bind_slot(slot, req.req_id)
        if self.translation_budget is not None:
            est = float(self._estimate(np.asarray([idx]))[0])
            self.slot_est[slot] = est
            self._est_sum += est
        if self.num_running > self.stats["peak_running"]:
            self.stats["peak_running"] = self.num_running
        return slot

    # -- the step path (all vectorized) --------------------------------------
    def price_step(self) -> np.ndarray:
        """Price one engine step for every active slot under every
        mechanism at once, advance the dirty bits, and record the
        occupancy-driven table-mode decision.  Returns active slots."""
        act = np.flatnonzero(self.slot_req >= 0)
        self.stats["steps"] += 1
        mode = self.table_mode or self.preferred_mode()
        self.stats["mode_flat_steps" if mode == BT.FLAT
                   else "mode_radix_steps"] += 1
        if self.meter is not None and act.size:
            self.meter.record_slots(
                act, ~self.slot_miss[act], self.slot_pages[act],
                self.leaf_size, shared_leaves=self.prefix_sharing)
            self.slot_miss[act] = False
            if self.translation_budget is not None:
                i = self.meter.model.mechs.index(self.budget_mech)
                if float(self.meter.step_cycles[-1][i]) \
                        > self.translation_budget:
                    self._over_budget += 1
                    if self._over_budget >= self.budget_patience:
                        victim = self.pick_victim_slot()
                        if victim is not None:
                            self.preempt_slot(victim, reason="budget")
                        self._over_budget = 0
                else:
                    self._over_budget = 0
        return act

    def advance(self, out_tokens: np.ndarray) -> List[Request]:
        """Consume one decode output for every active slot: teacher-
        forced slots keep reading their stream, decode-phase slots
        append the produced token; finished requests retire (freeing
        pages first), then grown streams allocate their boundary pages
        (shedding victims on pool exhaustion).  Returns finished."""
        out = np.asarray(out_tokens)
        act = self.slot_req >= 0
        self.slot_len[act] += 1
        prod = act & (self.slot_len >= self.slot_eff)
        rows = np.flatnonzero(prod)
        finished: List[Request] = []
        if not rows.size:
            return finished
        self.slot_tokens[rows, self.slot_eff[rows]] = out[rows]
        self.slot_eff[rows] += 1
        gen = self.slot_eff[rows] - self.slot_base[rows]
        done_mask = gen >= self.r_max_new[self.slot_req[rows]]
        for b in rows[done_mask]:         # per-event: retirement
            finished.append(self._retire(int(b)))
        grow_rows = rows[~done_mask]
        needs = -(-self.slot_eff[grow_rows] // self.page_size)
        g = grow_rows[needs > self.slot_npages[grow_rows]]
        if g.size:
            while self.pool.free_pages < g.size:
                victim = self.pick_victim_slot()
                if victim is None:
                    raise MemoryError(
                        "KV pool exhausted with nothing left to shed")
                self.preempt_slot(victim, reason="overload")
                g = g[self.slot_req[g] >= 0]
                if not g.size:
                    break
        if g.size:
            fresh = self.pool.allocate_array(g.size)
            self.slot_pages[g, self.slot_npages[g]] = fresh
            self.slot_npages[g] += 1
            self.slot_miss[g] = True      # mapping grew: next step walks
        return finished

    # -- preemption / retirement (per-lifetime events) ------------------------
    def pick_victim_slot(self, prefer_not: Optional[int] = None
                         ) -> Optional[int]:
        """Vectorized :meth:`BatchScheduler.pick_victim`: lowest
        priority, latest admission breaking ties; ``prefer_not`` loses
        ties but never outranks a lower-priority runner."""
        run = np.flatnonzero(self.slot_req >= 0)
        if not run.size:
            return None
        ridx = self.slot_req[run]
        not_self = run != (-1 if prefer_not is None else prefer_not)
        order = np.lexsort((self.r_admit_seq[ridx], not_self,
                            -self.r_prio[ridx]))
        return int(run[order[-1]])

    def _copyout(self, slot: int, req: Request) -> None:
        req.generated = [int(t) for t in self.slot_tokens[
            slot, self.slot_base[slot]:self.slot_eff[slot]]]

    def _release_slot(self, slot: int) -> None:
        npg = int(self.slot_npages[slot])
        if npg:
            self.pool.release_array(self.slot_pages[slot, :npg])
            self.slot_pages[slot, :npg] = -1
        self.slot_npages[slot] = 0
        pid = int(self.slot_pfx[slot])
        if pid >= 0:
            self._pfx_sharers[pid] -= 1
            if self._pfx_sharers[pid] == 0:
                del self._pfx_sharers[pid]
                del self._pfx_pages[pid]
            self.slot_pfx[slot] = -1
        if self.translation_budget is not None:
            self._est_sum -= float(self.slot_est[slot])
            self.slot_est[slot] = 0.0
        self.slot_req[slot] = -1
        self.slot_miss[slot] = False
        self._free_slots.append(slot)

    def preempt_slot(self, slot: int, reason: str = "evict") -> Request:
        """Evict a running slot: tokens generated so far are preserved
        on the request (teacher-forced replay restores them bit-exactly
        at re-admission), pages release through the refcounts (a shared
        prefix page survives while any sharer lives), and the request
        requeues with exponential backoff — or is shed for good past
        ``max_retries``."""
        idx = int(self.slot_req[slot])
        req = self.reqs[idx]
        self._copyout(slot, req)
        self.r_eff[idx] = self.r_base[idx] + len(req.generated)
        self._release_slot(slot)
        self.stats["preempted"] += 1
        self.r_retries[idx] += 1
        req.retries = int(self.r_retries[idx])
        if req.retries > req.max_retries:
            self.stats["shed"] += 1
            if self.meter is not None:
                self.meter.release_slot(slot, retire=True)
            req.failed = "shed"
            self.r_status[idx] = FAILED
            self.failed.append(req)
        else:
            if self.meter is not None:
                self.meter.release_slot(slot, retire=False)
            req.not_before = self.clock + 2 ** req.retries
            self.r_not_before[idx] = req.not_before
            self.r_status[idx] = QUEUED
        resilience.log_event(
            "preempt", f"fleet slot {slot} req {req.req_id} ({reason}), "
                       f"retry {req.retries}/{req.max_retries}, "
                       f"{len(req.generated)} tokens kept")
        return req

    def _retire(self, slot: int) -> Request:
        idx = int(self.slot_req[slot])
        req = self.reqs[idx]
        self._copyout(slot, req)
        self.r_eff[idx] = self.r_base[idx] + len(req.generated)
        self._release_slot(slot)
        if self.meter is not None:
            self.meter.release_slot(slot, retire=True)
        self.r_status[idx] = DONE
        self.stats["completed"] += 1
        return req


class FleetEngine:
    """The fleet decode loop: one surrogate decode over the full slot
    axis per step on ``device``, scheduler bookkeeping fully vectorized
    on the host around it.  API mirrors :class:`ServeEngine` (submit /
    run / throughput)."""

    def __init__(self, *, max_batch: int = 1024, max_len: int = 64,
                 page_size: int = 8, leaf_size: int = 4,
                 num_pages: Optional[int] = None, cost_model=None,
                 table_mode: Optional[str] = None,
                 prefix_sharing: bool = True,
                 translation_budget: Optional[float] = None,
                 budget_mech: str = "ndpage",
                 flatten_threshold: float = 0.5, vocab: int = VOCAB,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        meter = None
        if cost_model is not None:
            meter = TranslationMeter(cost_model, max_slots=max_batch)
        self.meter = meter
        if num_pages is None:
            num_pages = max_batch * (-(-max_len // page_size)) + 8
        self.sched = FleetScheduler(
            num_pages=num_pages, max_batch=max_batch,
            page_size=page_size, max_len=max_len, leaf_size=leaf_size,
            flatten_threshold=flatten_threshold, table_mode=table_mode,
            meter=meter, prefix_sharing=prefix_sharing,
            translation_budget=translation_budget,
            budget_mech=budget_mech)
        self.max_batch = max_batch
        self._decode = _decode_fn(vocab, self.device)
        self._rows = np.arange(max_batch)

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        finished: List[Request] = []
        s = self.sched
        for _ in range(max_steps):
            s.tick()
            s.admit()
            if not s.num_running and not s.has_queued():
                break
            if not s.num_running:
                continue
            # injected mid-decode eviction (the evict_storm chaos
            # plan): teacher-forced replay keeps tokens bit-exact
            inj = resilience.fault_injector()
            if inj is not None and s.num_running and inj.fires("evict"):
                s.preempt_slot(s.pick_victim_slot(), reason="fault")
                if not s.num_running:
                    continue
            s.price_step()
            nxt = s.slot_tokens[self._rows,
                                np.minimum(s.slot_len, s.max_len - 1)]
            out = self._decode(torch.from_numpy(nxt),
                               torch.from_numpy(s.slot_len)).cpu().numpy()
            finished.extend(s.advance(out))
        return finished

    def throughput(self) -> Dict:
        """Per-mechanism fleet report (requires ``cost_model``) — the
        ``ServeEngine.throughput`` contract plus fleet-scale fields
        (peak concurrency, scheduler stats, decode functions built)."""
        if self.meter is None:
            raise ValueError("FleetEngine was built without a cost_model;"
                             " pass cost_model= to enable throughput()")
        m = self.meter
        return {
            "tokens_per_sec": m.tokens_per_sec(),
            "translation_cycles": m.translation_cycles(),
            "per_step_cycles": m.per_step_cycles(),
            "tokens": m.tokens, "steps": m.steps,
            "tcache_hits": m.hits, "tcache_misses": m.misses,
            "peak_running": self.sched.stats["peak_running"],
            "occupancy": self.sched.occupancy(),
            "stats": dict(self.sched.stats),
            "prefix_sharing": self.sched.prefix_sharing,
            "decode_traces": decode_trace_count(),
        }
