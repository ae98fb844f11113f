"""Translation cost model: simulator mechanism latencies -> serving cycles.

The port of ``repro.sim.cost_model``, the bridge between the repo's two
halves.  The timing simulator (:mod:`repro_torch.sim.simulator`) knows
what a page walk COSTS under each mechanism (radix / ech / hugepage /
ndpage / ideal) on a given machine; the paged-KV serving stack
(:mod:`repro_torch.serving`) knows how often the runtime RESOLVES
translations (TranslationCache hits vs misses, and how many PTE lines a
table rebuild touches under the flat vs radix block organization).  A
:class:`TranslationCostModel` carries the per-lookup cycle costs from
the first world into the second, so ``ServeEngine`` can report
tokens/sec under every mechanism — the paper's end-to-end claim at the
serving layer.  Those tokens/sec are the SIMULATED NDP machine's
(``freq_ghz`` 2.6, ``model_cycles_per_token`` of compute a token), not
the card's.

Cost derivation (:meth:`TranslationCostModel.from_sim`) is ONE
simulator dispatch on ``device``: all mechanisms ride the M axis of a
single :func:`repro_torch.sim.simulate` call on the serving machine's
shape — on the card one LRU-scan and one timing-epilogue launch a chunk.
Per mechanism ``m``:

  ``tlb_hit``   cycles when the serving TranslationCache hits (the
                L1-TLB analogue): the machine's L1-DTLB latency.
  ``walk``      cycles on a miss: L2-TLB probe + the simulator's
                measured average page-table-walk latency for ``m``.
  ``pte_line``  cycles per ADDITIONAL PTE cache line the rebuild
                touches beyond the first: the machine's per-line DRAM
                cost for L1-bypassing mechanisms, an L1-hit-rate-
                weighted blend for cache-filling ones.
  ``org``       which serving block-table organization the mechanism's
                line count follows (flat, radix, segment, inverted, or
                none for ideal).

Derived models are memoized in the port's trace-cache directory
(``.trace_cache/repro_torch/costmodel_<machine>_<key>.json``), keyed by
the device type among everything else.  :data:`PINNED_COSTS` is the JAX
package's committed table for the default ``SERVING_COST`` machine
(simulated cycles), so the serving path never NEEDS a simulator run.

No fallback hides the card: on a CUDA device a failed derivation — a
missing card, a kernel that does not build or launch — propagates, even
under ``for_machine(source="auto")``; only ``device="cpu"`` falls back to
the pinned table there, as the reference does.  The meter and
:meth:`TranslationCostModel.lookup_cycles` are numpy float64 host
accounting, copied from the reference so totals are bit-equal.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import sys
from collections import deque
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.ndp_sim import (PRESETS, SERVING_COST,
                                         MachineConfig, cpu_machine,
                                         ndp_machine)
from repro_torch.core.block_table import PTE_PER_LINE, RANGES_PER_LINE
from repro_torch.sim import mechanisms as MS
from repro_torch.util import resilience
from repro_torch.util.device import DeviceLike, resolve_device

#: part of the memo key: bump on any change to the derivation above
_COST_MODEL_VERSION = 3

_FACTORIES = {"ndp": ndp_machine, "cpu": cpu_machine}

#: serving-table organizations a mechanism's line count can follow
ORG_FLAT = "flat"      # one contiguous row: adjacent leaves share lines
ORG_RADIX = "radix"    # per-node allocations: directory + leaf lines
ORG_NONE = "none"      # no translation structure at all (ideal)
ORG_SEG = "segment"    # range descriptors: lines ~ contiguous runs
ORG_INV = "inverted"   # hashed buckets: every entry its own line


def serving_org(name: str) -> str:
    """Which block-table organization mechanism ``name`` maps to on the
    serving side: an explicit ``spec.org`` wins (the zoo's segment /
    inverted organizations); otherwise ``flattened`` mechanisms read the
    single flat row, everything else that walks reads a tree of
    independently-allocated nodes, and ``ideal`` reads nothing."""
    spec = MS.get(name)
    if spec.org is not None:
        return spec.org
    if spec.ideal:
        return ORG_NONE
    if spec.flattened:
        return ORG_FLAT
    return ORG_RADIX


@dataclasses.dataclass(frozen=True)
class LookupCost:
    """Per-lookup cycle costs of one mechanism (see module docstring)."""

    tlb_hit: float
    walk: float
    pte_line: float
    org: str


@dataclasses.dataclass(frozen=True)
class TranslationCostModel:
    """Per-mechanism lookup costs for one serving machine.

    ``mechs`` fixes the mechanism order every vectorized result
    follows; ``source`` records how the numbers were obtained
    ("sweep" = fresh simulator run, "cache" = trace-cache memo,
    "pinned" = the committed fallback table).
    """

    mechs: Tuple[str, ...]
    costs: Tuple[LookupCost, ...]          # aligned with mechs
    machine: str
    freq_ghz: float
    model_cycles_per_token: float
    source: str

    def cost(self, mech: str) -> LookupCost:
        return self.costs[self.mechs.index(mech)]

    @functools.cached_property
    def _vectors(self) -> Tuple[np.ndarray, ...]:
        """The per-mechanism (M,) cost arrays, materialized once — the
        meter calls :meth:`lookup_cycles` on every decode step."""
        return (np.array([c.tlb_hit for c in self.costs]),
                np.array([c.walk for c in self.costs]),
                np.array([c.pte_line for c in self.costs]),
                np.array([c.org for c in self.costs]))

    @functools.cached_property
    def needs_zoo_lines(self) -> bool:
        """True when any mechanism uses the segment/inverted accounting
        — lets the meter hot path skip those counts otherwise."""
        return any(c.org in (ORG_SEG, ORG_INV) for c in self.costs)

    # -- vectorized accounting ----------------------------------------------
    def lookup_cycles(self, hit: np.ndarray, lines_flat: np.ndarray,
                      lines_radix: np.ndarray,
                      lines_seg: np.ndarray | None = None,
                      lines_inv: np.ndarray | None = None) -> np.ndarray:
        """Translation cycles for N lookups under every mechanism.

        ``hit``: (N,) bool — the serving TranslationCache hit;
        ``lines_flat``/``lines_radix`` (and, for models carrying
        segment/inverted-org mechanisms, ``lines_seg``/``lines_inv``):
        (N,) touched-PTE-line counts of the rebuilt row under each
        organization.  An omitted zoo count defaults to 1 line (no
        extra-line cost).  Returns (N, M) float64.
        """
        hit = np.asarray(hit, bool)[:, None]
        lf = np.asarray(lines_flat, np.float64)[:, None]
        lr = np.asarray(lines_radix, np.float64)[:, None]
        one = np.ones_like(lf)
        ls = (one if lines_seg is None
              else np.asarray(lines_seg, np.float64)[:, None])
        li = (one if lines_inv is None
              else np.asarray(lines_inv, np.float64)[:, None])
        tlb, walk, line, org = self._vectors
        lines = np.select(
            [org == ORG_FLAT, org == ORG_RADIX, org == ORG_SEG,
             org == ORG_INV],
            [lf, lr, ls, li], default=one)
        miss = walk + line * np.maximum(lines - 1.0, 0.0)
        return np.where(hit, tlb[None], miss)

    def tokens_per_sec(self, tokens: int, trans_cycles: np.ndarray,
                       model_cycles_per_token: float | None = None
                       ) -> Dict[str, float]:
        """Simulated end-to-end throughput per mechanism: the model
        compute budget (``model_cycles_per_token`` x tokens) plus each
        mechanism's accumulated translation cycles, at the simulated
        machine's clock.  ``model_cycles_per_token`` overrides the
        model's own value (re-pricing the SAME totals)."""
        if tokens <= 0:
            return {m: 0.0 for m in self.mechs}
        mcpt = (self.model_cycles_per_token
                if model_cycles_per_token is None
                else float(model_cycles_per_token))
        total = mcpt * tokens + np.asarray(trans_cycles, np.float64)
        secs = total / (self.freq_ghz * 1e9)
        return {m: float(tokens / secs[i])
                for i, m in enumerate(self.mechs)}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_sim(cls, mach: MachineConfig,
                 mechs: Sequence[str] | None = None, *,
                 preset: str | None = None, workload: str | None = None,
                 model_cycles_per_token: float | None = None,
                 use_cache: bool = True,
                 device: DeviceLike = "cuda") -> "TranslationCostModel":
        """Derive the cost table from ONE simulator dispatch on ``mach``,
        run on ``device`` (the card by default, raising without one).
        The result is memoized in the port's trace cache, keyed on
        everything it depends on, the device type included."""
        dev = resolve_device(device)
        mechs = tuple(mechs or SERVING_COST["mechs"])
        preset = preset or SERVING_COST["preset"]
        workload = workload or SERVING_COST["workload"]
        mcpt = float(model_cycles_per_token
                     if model_cycles_per_token is not None
                     else SERVING_COST["model_cycles_per_token"])

        path = _memo_path(mach, mechs, preset, workload, dev)
        if use_cache:
            cached = _memo_load(path, mcpt)
            if cached is not None:
                return cached

        from repro_torch.sim.simulator import simulate
        from repro_torch.workloads import generate_trace
        sim_preset = PRESETS[preset]
        trace = generate_trace(workload, mach.num_cores, preset=sim_preset)
        res = simulate(mach, trace, mechs=mechs, chunk=sim_preset.chunk,
                       device=dev)

        costs = []
        for m in mechs:
            spec = MS.get(m)
            if spec.ideal:
                costs.append(LookupCost(0.0, 0.0, 0.0, ORG_NONE))
                continue
            walk = (res.scalar("avg_ptw_latency", m)
                    + float(mach.l2_tlb.latency))
            org = serving_org(m)
            # contiguous orgs stream extra lines through an open DRAM
            # row under the banked model; per-node orgs pay closed rows
            dram = mach.memory.line_cycles(
                contiguous=org in (ORG_FLAT, ORG_SEG))
            if spec.bypass_l1:
                line = dram
            else:
                l1_hit = 1.0 - res.scalar("pte_l1_miss_rate", m)
                line = (l1_hit * mach.l1d.latency
                        + (1.0 - l1_hit) * dram)
            costs.append(LookupCost(
                tlb_hit=float(mach.l1_dtlb.latency), walk=round(walk, 3),
                pte_line=round(line, 3), org=org))

        model = cls(mechs=mechs, costs=tuple(costs), machine=mach.name,
                    freq_ghz=mach.freq_ghz, model_cycles_per_token=mcpt,
                    source="sweep")
        if use_cache:
            _memo_store(path, model)
        return model

    @classmethod
    def pinned(cls, model_cycles_per_token: float | None = None
               ) -> "TranslationCostModel":
        """The committed table (:data:`PINNED_COSTS`) — no simulator
        run, no cache, no device."""
        p = PINNED_COSTS
        mcpt = float(model_cycles_per_token
                     if model_cycles_per_token is not None
                     else SERVING_COST["model_cycles_per_token"])
        return cls(
            mechs=tuple(p["mechs"]),
            costs=tuple(LookupCost(*p["costs"][m]) for m in p["mechs"]),
            machine=p["machine"], freq_ghz=p["freq_ghz"],
            model_cycles_per_token=mcpt, source="pinned")

    @classmethod
    def for_machine(cls, mach: MachineConfig | None = None, *,
                    source: str = "auto", device: DeviceLike = "cuda",
                    **kw) -> "TranslationCostModel":
        """The serving entry point.  ``source``:

        * ``"pinned"`` — the committed table, no simulation;
        * ``"sweep"``  — always derive on ``device`` (memoized);
        * ``"auto"``   — derive (serving the memo when warm).  On the
          CPU a failed derivation falls back to the pinned table, as in
          the JAX package; on a CUDA device it propagates (a missing
          card, or a kernel that fails to build or launch, is never
          hidden behind the pinned numbers).
        """
        if source == "pinned":
            return cls.pinned(kw.get("model_cycles_per_token"))
        if source not in ("sweep", "auto"):
            raise ValueError(f"unknown cost-model source {source!r}")
        dev = resolve_device(device)
        if mach is None:
            mach = _FACTORIES[SERVING_COST["machine"]](
                int(SERVING_COST["cores"]))
        if source == "sweep" or dev.type != "cpu":
            return cls.from_sim(mach, device=dev, **kw)
        try:
            return cls.from_sim(mach, device=dev, **kw)
        except Exception as e:                      # noqa: BLE001
            print(f"# cost model: CPU sweep derivation failed ({e!r}); "
                  "falling back to the pinned table", file=sys.stderr)
            return cls.pinned(kw.get("model_cycles_per_token"))


# ---------------------------------------------------------------------------
# trace-cache memoization (the port's directory, degrade-to-off rules)
# ---------------------------------------------------------------------------
def _engine_digest(mechs: Tuple[str, ...]) -> str:
    """Hash of everything OUTSIDE this module the derived costs depend
    on: the full spec values of the mechanisms used and the port's
    simulator sources — the engine, page-table walk, trace generator,
    mechanism registry and memory model, and both simulator kernels
    (``_sweep.ENGINE_SOURCES``: wrappers, plain versions, ``.cu``)."""
    from repro_torch.sim import _sweep
    h = hashlib.sha256()
    for s in MS.specs_for(mechs):
        h.update(repr((s.name, s.n_pte, s.parallel, s.bypass_l1,
                       s.pwc_levels, s.huge, s.flattened, s.ideal,
                       s.cache_tlb, s.segment, s.colocate, s.org,
                       getattr(s.walk_fn, "__qualname__", None))
                      ).encode())
    h.update(_sweep._engine_ckpt_digest().encode())
    return h.hexdigest()


def _memo_path(mach: MachineConfig, mechs: Tuple[str, ...], preset: str,
               workload: str, device: DeviceLike = "cuda") -> str | None:
    from repro_torch.workloads import trace_cache_dir
    d = trace_cache_dir()
    if d is None:
        return None
    key_src = json.dumps({
        "machine": dataclasses.asdict(mach),
        "mechs": list(mechs), "workload": workload,
        # preset VALUES, not just the name
        "preset": dataclasses.asdict(PRESETS[preset]),
        "engine": _engine_digest(mechs),
        "version": _COST_MODEL_VERSION,
        # the card's float sums may differ from the CPU's in the last bits
        "device": str(device).split(":")[0],
    }, sort_keys=True, default=str)
    h = hashlib.sha256(key_src.encode()).hexdigest()[:20]
    return os.path.join(d, f"costmodel_{mach.name}_{h}.json")


def _memo_load(path: str | None, mcpt: float
               ) -> "TranslationCostModel | None":
    """Integrity-checked memo load (sha256 sidecar, quarantine on
    corruption); None = re-derive."""
    if path is None:
        return None
    p = resilience.read_json(path)
    if p is None:
        return None
    try:
        return TranslationCostModel(
            mechs=tuple(p["mechs"]),
            costs=tuple(LookupCost(*p["costs"][m]) for m in p["mechs"]),
            machine=p["machine"], freq_ghz=p["freq_ghz"],
            model_cycles_per_token=mcpt, source="cache")
    except Exception:                    # schema drift: re-derive
        resilience.quarantine(path, "costmodel memo schema mismatch")
        return None


def _memo_store(path: str | None, model: TranslationCostModel) -> None:
    if path is None:
        return
    # atomic + sidecar; filesystem failure degrades to cache-off
    resilience.write_json(path, {
        "mechs": list(model.mechs),
        "costs": {m: list(dataclasses.astuple(c))
                  for m, c in zip(model.mechs, model.costs)},
        "machine": model.machine, "freq_ghz": model.freq_ghz,
    }, indent=1)


# ---------------------------------------------------------------------------
# the committed fallback table
# ---------------------------------------------------------------------------
#: The JAX package's table, derived there via
#: ``TranslationCostModel.from_sim(ndp_machine(4))`` on the SERVING_COST
#: defaults (dlrm workload, smoke preset): simulated cycles of the NDP
#: machine, copied verbatim.
PINNED_COSTS: Dict = {
    "machine": "ndp-4c",
    "freq_ghz": 2.6,
    "mechs": ("radix", "ech", "hugepage", "ndpage", "ideal"),
    "costs": {
        # (tlb_hit, walk, pte_line, org)
        "radix": (1.0, 482.827, 90.628, ORG_RADIX),
        "ech": (1.0, 343.52, 100.0, ORG_RADIX),
        "hugepage": (1.0, 300.021, 92.463, ORG_RADIX),
        "ndpage": (1.0, 290.523, 100.0, ORG_FLAT),
        "ideal": (0.0, 0.0, 0.0, ORG_NONE),
    },
}


# ---------------------------------------------------------------------------
# the serving-side accumulator
# ---------------------------------------------------------------------------
class TranslationMeter:
    """Accumulates translation cycles per mechanism as the serving
    scheduler resolves lookups — the per-step and per-request budget
    ``ServeEngine`` reports throughput from.

    One meter serves EVERY mechanism at once: the engine runs a single
    decode loop and each step's cache hits / misses / touched-line
    counts are priced under all mechanisms simultaneously.
    """

    #: bounded histories, so a long-lived engine never grows without
    #: limit (running totals are exact regardless): per-step cycle
    #: vectors, and budgets of RETIRED requests.
    STEP_HISTORY = 4096
    RETIRED_HISTORY = 4096

    def __init__(self, model: TranslationCostModel,
                 max_slots: int | None = None):
        self.model = model
        m = len(model.mechs)
        self.total = np.zeros(m, np.float64)
        self.step_cycles: "deque[np.ndarray]" = deque(
            maxlen=self.STEP_HISTORY)                  # per-step (M,)
        #: live per-request budgets (seq_id -> (M,) cycles)
        self.per_request: Dict[Hashable, np.ndarray] = {}
        #: budgets of completed requests, most recent last
        self.retired: "deque[Tuple[Hashable, np.ndarray]]" = deque(
            maxlen=self.RETIRED_HISTORY)
        self.tokens = 0
        self.steps = 0
        self.hits = 0
        self.misses = 0
        # -- the vectorized slot path (fleet scheduler) ---------------------
        # per-slot live budgets as one (max_slots, M) matrix accumulated
        # array-at-once by record_slots; budgets flush into the
        # per_request / retired dicts only at release time
        self._slot_budget = (np.zeros((max_slots, m), np.float64)
                             if max_slots else None)
        self._slot_owner: List = [None] * (max_slots or 0)

    def record_step(self, seq_ids: Sequence[Hashable], hit: np.ndarray,
                    flat_rows: np.ndarray, leaf_size: int) -> None:
        """Price one scheduler step.  ``flat_rows`` is the (N, max_pages)
        int32 mapping the step resolved (-1 holes).  Line counts are
        plain numpy (no device dispatch on the decode hot path) and only
        for MISS rows — hits are priced at tlb_hit."""
        n = len(seq_ids)
        if n == 0:
            return
        hit = np.asarray(hit, bool)
        flat = np.asarray(flat_rows, np.int32)
        lf = np.ones(n, np.int64)
        lr = np.ones(n, np.int64)
        lseg = np.ones(n, np.int64)
        linv = np.ones(n, np.int64)
        miss = np.flatnonzero(~hit)
        if miss.size:
            ls = _usable_leaf_size(flat.shape[1], leaf_size)
            lf[miss], lr[miss] = _np_row_lines(flat[miss], ls)
            if self.model.needs_zoo_lines:
                lseg[miss] = _np_seg_lines(flat[miss])
                linv[miss] = _np_inv_lines(flat[miss])
        per_seq = self.model.lookup_cycles(hit, lf, lr, lseg, linv)
        for i, sid in enumerate(seq_ids):
            if sid in self.per_request:
                self.per_request[sid] = self.per_request[sid] + per_seq[i]
            else:
                self.per_request[sid] = per_seq[i].copy()
        step = per_seq.sum(axis=0)
        self.step_cycles.append(step)
        self.total += step
        self.tokens += n                  # every active slot advances one
        self.steps += 1
        h = int(hit.sum())
        self.hits += h
        self.misses += n - h

    # -- the vectorized slot path (fleet scheduler) --------------------------
    def bind_slot(self, slot: int, req_id: Hashable) -> None:
        """Attach ``req_id`` to a scheduler slot (admission).  Requires
        the meter was built with ``max_slots``."""
        assert self._slot_budget is not None, "meter built without slots"
        assert self._slot_owner[slot] is None, (slot, req_id)
        self._slot_owner[slot] = req_id

    def record_slots(self, slots: np.ndarray, hit: np.ndarray,
                     flat_rows: np.ndarray, leaf_size: int, *,
                     shared_leaves: bool = False) -> None:
        """Vectorized :meth:`record_step` over scheduler SLOTS: line
        counts, per-mechanism cycles and the per-slot budget
        accumulation are all array-at-once.  ``shared_leaves=True``
        counts radix-org lines with batch-global shared-leaf dedup
        (:func:`_np_row_lines_shared`)."""
        assert self._slot_budget is not None, "meter built without slots"
        slots = np.asarray(slots, np.int64)
        n = slots.size
        if n == 0:
            return
        hit = np.asarray(hit, bool)
        flat = np.asarray(flat_rows, np.int32)
        lf = np.ones(n, np.int64)
        lr = np.ones(n, np.int64)
        lseg = np.ones(n, np.int64)
        linv = np.ones(n, np.int64)
        miss = np.flatnonzero(~hit)
        if miss.size:
            ls = _usable_leaf_size(flat.shape[1], leaf_size)
            rows = flat[miss]
            if shared_leaves:
                lf[miss], lr[miss] = _np_row_lines_shared(rows, ls)
            else:
                lf[miss], lr[miss] = _np_row_lines(rows, ls)
            if self.model.needs_zoo_lines:
                lseg[miss] = _np_seg_lines(rows)
                linv[miss] = _np_inv_lines(rows)
        per_seq = self.model.lookup_cycles(hit, lf, lr, lseg, linv)
        self._slot_budget[slots] += per_seq      # slots are unique
        step = per_seq.sum(axis=0)
        self.step_cycles.append(step)
        self.total += step
        self.tokens += n
        self.steps += 1
        h = int(hit.sum())
        self.hits += h
        self.misses += n - h

    def release_slot(self, slot: int, *, retire: bool) -> None:
        """Fold a slot's accumulated budget into its request's dict
        entry (preemption keeps it live; ``retire=True`` moves it to the
        bounded retired history)."""
        assert self._slot_budget is not None, "meter built without slots"
        req_id = self._slot_owner[slot]
        assert req_id is not None, slot
        self._slot_owner[slot] = None
        budget = self._slot_budget[slot].copy()
        self._slot_budget[slot] = 0.0
        if req_id in self.per_request:
            self.per_request[req_id] = self.per_request[req_id] + budget
        else:
            self.per_request[req_id] = budget
        if retire:
            self.retire_request(req_id)

    def retire_request(self, seq_id: Hashable) -> None:
        """Move a completed request's budget out of the live dict (kept
        in the bounded ``retired`` history)."""
        budget = self.per_request.pop(seq_id, None)
        if budget is not None:
            self.retired.append((seq_id, budget))

    def request_budgets(self) -> Dict[Hashable, np.ndarray]:
        """Live AND retained-retired per-request budgets.  A recycled
        request id SUMS across its incarnations."""
        out: Dict[Hashable, np.ndarray] = {}
        live_slots = (
            [(rid, self._slot_budget[s])
             for s, rid in enumerate(self._slot_owner) if rid is not None]
            if self._slot_budget is not None else [])
        for sid, budget in (list(self.retired)
                            + list(self.per_request.items()) + live_slots):
            if sid in out:
                out[sid] = out[sid] + budget
            else:
                out[sid] = budget.copy()
        return out

    def tokens_per_sec(self, model_cycles_per_token: float | None = None
                       ) -> Dict[str, float]:
        return self.model.tokens_per_sec(self.tokens, self.total,
                                         model_cycles_per_token)

    def translation_cycles(self) -> Dict[str, float]:
        return {m: float(self.total[i])
                for i, m in enumerate(self.model.mechs)}

    def per_step_cycles(self) -> Dict[str, Dict[str, float]]:
        """Mean and worst-case step cycles per mechanism over the
        retained step window."""
        if not self.step_cycles:
            return {m: {"mean": 0.0, "max": 0.0}
                    for m in self.model.mechs}
        steps = np.stack(self.step_cycles)            # (S, M)
        return {m: {"mean": float(steps[:, i].mean()),
                    "max": float(steps[:, i].max())}
                for i, m in enumerate(self.model.mechs)}


def _usable_leaf_size(max_pages: int, leaf_size: int) -> int:
    """Largest leaf size <= requested that divides ``max_pages``
    (``block_table.radix_from_flat`` requires an exact split)."""
    ls = max(1, min(leaf_size, max_pages))
    while max_pages % ls:
        ls -= 1
    return ls


def _np_group_lines(mapped: np.ndarray) -> np.ndarray:
    """Touched line groups of a line-aligned span, over the last axis
    (the JAX package's ``repro.core.block_table._lines_of``)."""
    n = mapped.shape[-1]
    pad = (-n) % PTE_PER_LINE
    m = np.pad(mapped, [(0, 0)] * (mapped.ndim - 1) + [(0, pad)])
    groups = m.reshape(m.shape[:-1] + (-1, PTE_PER_LINE))
    return groups.any(-1).sum(-1)


def _np_row_lines(flat: np.ndarray, leaf_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Touched-PTE-line counts of (N, max_pages) mapping rows under the
    flat and the radix organization, pure numpy — the hot-path
    equivalent of the JAX package's ``count_pte_lines(flat /
    radix_from_flat(flat))``."""
    mapped = flat >= 0                                # (N, maxp)
    lf = _np_group_lines(mapped)
    n, maxp = mapped.shape
    leaves = mapped.reshape(n, maxp // leaf_size, leaf_size)
    dir_valid = leaves.any(-1)                        # (N, n_dir)
    lr = _np_group_lines(dir_valid) + _np_group_lines(leaves).sum(-1)
    return lf, lr


def _np_row_lines_shared(flat: np.ndarray, leaf_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`_np_row_lines` with BATCH-GLOBAL shared-leaf dedup on the
    radix count — the numpy twin of the JAX package's
    ``count_pte_lines_shared``.

    A leaf whose physical-page content is identical across rows is one
    allocation: its lines are charged to the FIRST row (row-major)
    referencing it and zero to every other sharer.  The flat count is
    unchanged — each flat row is its own contiguous allocation.
    """
    mapped = flat >= 0                                # (N, maxp)
    lf = _np_group_lines(mapped)
    n, maxp = mapped.shape
    n_dir = maxp // leaf_size
    leaves = flat.reshape(n * n_dir, leaf_size)
    lmapped = mapped.reshape(n * n_dir, leaf_size)
    valid = lmapped.any(-1)
    lines = np.zeros(n * n_dir, np.int64)
    vidx = np.flatnonzero(valid)
    if vidx.size:
        sub = leaves[vidx]
        # deterministic first occurrence of each distinct leaf content
        # (np.unique's return_index is not guaranteed first-occurrence
        # for axis-based unique)
        _, inverse = np.unique(sub, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        first = np.full(int(inverse.max()) + 1, vidx.size, np.int64)
        np.minimum.at(first, inverse, np.arange(vidx.size))
        keep = vidx[first]
        lines[keep] = _np_group_lines(lmapped[keep])
    dir_valid = valid.reshape(n, n_dir)
    lr = _np_group_lines(dir_valid) + lines.reshape(n, n_dir).sum(-1)
    return lf, lr


def _np_seg_lines(flat: np.ndarray) -> np.ndarray:
    """Numpy twin of the JAX package's ``count_segment_lines``: one
    range per maximal physically-contiguous mapped run, RANGES_PER_LINE
    a line."""
    flat = np.asarray(flat, np.int64)
    mapped = flat >= 0
    nd = flat.ndim
    pad_cfg = [(0, 0)] * (nd - 1) + [(1, 0)]
    prev_m = np.pad(mapped[..., :-1], pad_cfg, constant_values=False)
    prev_p = np.pad(flat[..., :-1], pad_cfg, constant_values=-2)
    runs = (mapped & (~prev_m | (flat != prev_p + 1))).sum(-1)
    return (runs + RANGES_PER_LINE - 1) // RANGES_PER_LINE


def _np_inv_lines(flat: np.ndarray) -> np.ndarray:
    """Numpy twin of the JAX package's ``count_inverted_lines``: every
    mapped entry hashes to its own bucket line."""
    return (np.asarray(flat, np.int64) >= 0).sum(-1)


def _main(argv: Optional[List[str]] = None) -> int:
    """Derive the SERVING_COST table on ``--device`` and print it in the
    layout of :data:`PINNED_COSTS`."""
    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    args = ap.parse_args(argv)
    mach = _FACTORIES[SERVING_COST["machine"]](int(SERVING_COST["cores"]))
    model = TranslationCostModel.from_sim(mach, use_cache=False,
                                          device=args.device)
    print(json.dumps({
        "machine": model.machine, "freq_ghz": model.freq_ghz,
        "mechs": model.mechs,
        "costs": {m: dataclasses.astuple(c)
                  for m, c in zip(model.mechs, model.costs)},
    }, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
