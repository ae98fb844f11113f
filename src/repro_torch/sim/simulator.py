"""Trace-driven timing simulator for NDP/CPU address translation.

The port of ``repro.sim.simulator``.  Mechanistic interval model
(Sniper-style): every trace entry is one memory instruction preceded by
``work`` non-memory instructions.  Per entry the engine models, for all
mechanisms at once (M axis) and all lanes (the fused simulations x cores
axis): the L1 DTLB -> L2 TLB (-> cache-as-TLB) -> page-table walk, the
walk's PTE accesses through the per-level PWCs and then the cache
hierarchy or, for a bypassing mechanism (NDPage), memory directly, the
data access through the hierarchy, and a shared-memory queueing delay
from the measured demand (``q = service * rho * K``): aggregate for the
bounded-linear memory, per bank for the banked one, whose row buffers
discount an access to a bank's open row.

Engine.  The trace is padded to chunks and streamed through one chunk
runner, split along the only serial dependency:

* the **scan** (``kernels.lru_scan``: a hand-written CUDA kernel on the
  card, an eager step loop on the CPU) carries only the LRU tag/stamp
  tables (and, banked, each bank's open row) and emits one packed int32
  of hit bits per (step, lane, mechanism);
* the **epilogue** (``kernels.sim_epilogue``: a hand-written CUDA kernel
  on the card, vectorized torch ops on the CPU) expands the hit bits over
  the whole chunk, does every latency and counter computation, and adds
  the chunk's deltas into the state.

The queueing delay is held constant within a chunk (recomputed from the
aggregate demand at every chunk boundary), which is what makes the split
exact.  Tables are laid out ``(B, C, M, sets, ways)`` and viewed as the
fused ``(B*C, M, sets, ways)`` lane layout for the scan; the scan updates
them in place.  Everything a chunk reads that does not depend on the
state is made once a bucket: the inputs on the fused lane layout, the
per-lane valid bits, flag words and parameters, and the PTE walk lines
(by group of chunks, at most ``LINES_GROUP_BYTES`` of them at once).  On
the card a chunk is then the queue delay (a few torch ops), one scan
launch and one epilogue launch.

Everything runs on one engine, the batched one: :func:`simulate` is
:func:`simulate_batch` of one trace, and :func:`simulate_batch` is
:func:`simulate_batch_varied` of one machine.  The JAX package reroutes
one-core runs to its batch engine and pads them to two lanes, around an
XLA reduction whose float order changes at width 1, to keep its two
engines bit-identical; the port has one engine and needs neither.  Lanes
never interact, and a lane's sums over a chunk run in one order whatever
the batch's width (the plain epilogue sums each lane's contiguous row,
``ref.sim_epilogue_ref``; the kernel folds a lane's step tiles in a
fixed order), so a lane's results do not depend on the batch it ran in.

Bucket plans.  What a batch's (machine shape, walk-fn tuple, chunk)
fixes — the table shapes, the hierarchy depth, whether there is a
cache-as-TLB, the banked geometry, which instantiation of each kernel
runs, and the bytes of walk lines a lane takes a chunk — is derived once
by :func:`_bucket_plan` and cached for the life of the process, keyed
the way the JAX package keys its jitted chunk runner.  The JAX package
compiles one runner per key; on the card a "compile" is a bucket plan,
since the CUDA kernels are built once per process by ``kernels/_build.py``
and every plan launches one of their instantiations.
:func:`runner_cache_info` counts the plans made (the sweep engine's
"compiles") and :func:`clear_runner_cache` drops them, the watchdog's
recovery hook.

A trace may be a ``"trace:<path>"`` spec of a real trace, ingested by
:mod:`repro_torch.workloads.ingest`.

Several cards (``devices``, the JAX rule of :func:`sim_devices`): the
batch is padded to a multiple of the card count (pad lanes are job 0's
machine and mechanisms with an empty trace, so no valid bit), split into
that many lane groups (:func:`lane_groups`), and each group runs the
same two kernels on its own card, the chunks issued to the cards in
turn so they overlap; the results are gathered in job order
(:func:`run_lane_groups`).  Lanes never meet, so each lane's counters
do not depend on the split.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import page_table as PT
from repro_torch.kernels import lru_scan as LS
from repro_torch.kernels import sim_epilogue as SE
from repro_torch.kernels.ref import COUNTERS
from repro_torch.sim import memory_model as MM
from repro_torch.sim.mechanisms import (DEFAULT_MECHS, MAX_PTE, specs_for,
                                        tables_for)
from repro_torch.util.device import resolve_device

if TYPE_CHECKING:       # configs.ndp_sim imports sim.memory_model
    from repro_torch.configs.ndp_sim import MachineConfig

M = len(DEFAULT_MECHS)

#: scan-chunk length; traces are padded to a multiple of this
DEFAULT_CHUNK = 512
#: the most bytes of PTE walk lines held at once: the lines are made for
#: a group of chunks this size (the whole trace of the full preset's
#: buckets, and of 65,536-entry windows at 8 cores)
LINES_GROUP_BYTES = 1 << 30

# 2MB huge pages: 512 x 4KB pages (footprints are unscaled)
HUGE_SHIFT = 9
# salt of the region hash that picks the 4KB-fallback regions
_FRAG_SALT = 0x9E3779B9

# huge-page cost model: FRAC_4K is the fraction of memory falling back to
# 4KB mappings as contiguity is consumed (grows with allocating cores);
# HP_STALL the amortized per-access stall for 2MB fault latency /
# compaction / bloat, growing with core count.  Calibrated against Figs
# 12-14 by the JAX package.
FRAC_4K = {1: 0.16, 2: 0.27, 4: 0.49, 8: 0.93}
HP_STALL_BASE = 55.0
HP_STALL_PER_CORE = 7.0
QUEUE_K = MM.QUEUE_K        # bounded-linear queue slope (cycles at rho=1)
# ECH: cuckoo upsizing/rehash churn per walk ~ (cores - 2)^2
ECH_REHASH_QUAD = 5.0


@dataclasses.dataclass
class SimResult:
    mechs: Tuple[str, ...]
    cycles: np.ndarray            # (M, C)
    instructions: np.ndarray      # (C,)
    trans_cycles: np.ndarray      # (M, C) translation stall cycles
    walk_cycles: np.ndarray       # (M, C)
    walks: np.ndarray             # (M, C)
    l1tlb_misses: np.ndarray      # (M, C)
    accesses: int
    pte_accesses: np.ndarray      # (M, C)
    pte_l1_hits: np.ndarray       # (M, C)
    pte_mem: np.ndarray           # (M, C)
    data_l1_misses: np.ndarray    # (M, C)
    data_mem: np.ndarray          # (M, C)

    # -- derived metrics ----------------------------------------------------
    def ipc(self) -> np.ndarray:
        return self.instructions[None, :] / self.cycles

    def speedup_vs(self, base: str = "radix") -> Dict[str, float]:
        b = self.mechs.index(base)
        mean_c = self.cycles.mean(axis=1)
        return {m: float(mean_c[b] / mean_c[i])
                for i, m in enumerate(self.mechs)}

    def avg_ptw_latency(self) -> np.ndarray:
        return (self.walk_cycles / np.maximum(self.walks, 1)).mean(axis=1)

    def translation_fraction(self) -> np.ndarray:
        return (self.trans_cycles / self.cycles).mean(axis=1)

    def tlb_miss_rate(self) -> np.ndarray:
        return (self.l1tlb_misses / self.accesses).mean(axis=1)

    def pte_l1_miss_rate(self) -> np.ndarray:
        return 1.0 - (self.pte_l1_hits
                      / np.maximum(self.pte_accesses, 1)).mean(axis=1)

    def data_l1_miss_rate(self) -> np.ndarray:
        return (self.data_l1_misses / self.accesses).mean(axis=1)

    # -- slicing helpers ----------------------------------------------------
    def select(self, mechs: Sequence[str] | str | None = None,
               cores: Sequence[int] | slice | int | None = None
               ) -> "SimResult":
        """Sub-view of the result restricted to ``mechs`` (names, order
        preserved as given) and/or ``cores`` (index/slice/sequence)."""
        if isinstance(mechs, str):
            mechs = (mechs,)
        names = self.mechs if mechs is None else tuple(mechs)
        mi = np.asarray([self.mechs.index(n) for n in names])
        if cores is None:
            ci = np.arange(self.cycles.shape[1])
        elif isinstance(cores, slice):
            ci = np.arange(self.cycles.shape[1])[cores]
        else:
            ci = np.atleast_1d(np.asarray(cores))
        mc = lambda a: a[np.ix_(mi, ci)]                     # noqa: E731
        return SimResult(
            mechs=names,
            cycles=mc(self.cycles),
            instructions=self.instructions[ci],
            trans_cycles=mc(self.trans_cycles),
            walk_cycles=mc(self.walk_cycles),
            walks=mc(self.walks),
            l1tlb_misses=mc(self.l1tlb_misses),
            accesses=self.accesses,
            pte_accesses=mc(self.pte_accesses),
            pte_l1_hits=mc(self.pte_l1_hits),
            pte_mem=mc(self.pte_mem),
            data_l1_misses=mc(self.data_l1_misses),
            data_mem=mc(self.data_mem),
        )

    def scalar(self, metric: str, mech: str) -> float:
        """One derived metric for one mechanism, as a plain float:
        ``res.scalar("avg_ptw_latency", "radix")``."""
        return getattr(self.select(mechs=(mech,)), metric)().item()


# ---------------------------------------------------------------------------
# state construction and the shape/data split
# ---------------------------------------------------------------------------
def _table_shapes(mach: "MachineConfig") -> Dict[str, Tuple[int, int]]:
    """name -> (num_sets, ways) for every LRU table of one (mech, core)."""
    shapes = {
        "l1": (mach.l1d.num_sets, mach.l1d.ways),
        "l1tlb": (mach.l1_dtlb.entries // mach.l1_dtlb.ways,
                  mach.l1_dtlb.ways),
        "l2tlb": (mach.l2_tlb.entries // 12, 12),
        # per-level PWCs as one table: set index IS the walk level
        "pwc": (MAX_PTE, mach.pwc_entries),
    }
    if mach.l2 is not None:
        shapes["l2"] = (mach.l2.num_sets, mach.l2.ways)
    if mach.l3 is not None:
        shapes["l3"] = (mach.l3.num_sets, mach.l3.ways)
    if mach.ctlb_kb > 0:
        # cache-as-TLB: ctlb_kb KB of repurposed cache, one translation
        # per 64B line; structurally absent at ctlb_kb=0
        entries = mach.ctlb_kb * 1024 // 64
        shapes["ctlb"] = (max(entries // mach.ctlb_ways, 1),
                          mach.ctlb_ways)
    return shapes


@dataclasses.dataclass(frozen=True)
class MachineShape:
    """Everything about a ``MachineConfig`` that determines ARRAY SHAPES:
    the core count, the (sets, ways) geometry of every LRU table, and the
    memory model's shape half.  Jobs of one batch must share it; their
    other differences (latencies, service times, per-mechanism flags)
    ride the lanes as data."""

    num_cores: int
    tables: Tuple[Tuple[str, int, int], ...]    # (name, sets, ways)
    memory: Tuple = ("bounded_linear",)

    @property
    def hier(self) -> Tuple[str, ...]:
        names = {n for n, _, _ in self.tables}
        return ("l1", "l2", "l3") if "l2" in names else ("l1",)


def machine_shape(mach: "MachineConfig") -> MachineShape:
    return MachineShape(
        num_cores=mach.num_cores,
        tables=tuple((n, s, w)
                     for n, (s, w) in _table_shapes(mach).items()),
        memory=mach.memory.shape_key())


def _data_params(mach: "MachineConfig") -> Dict[str, np.float32]:
    """The value-like half of a ``MachineConfig``: every latency the
    timing epilogue consumes, as float32 scalars.  ``mem_lat`` is the
    closed-row/full access latency, ``row_save`` the cycles an open-row
    hit skips (0.0 for bounded_linear), ``service`` the queue service
    time."""
    return {k: np.float32(v) for k, v in {
        "mem_lat": mach.memory.miss_latency(),
        "row_save": mach.memory.row_hit_save(),
        "l1_lat": mach.l1d.latency,
        "l2_lat": mach.l2.latency if mach.l2 else 0.0,
        "l3_lat": mach.l3.latency if mach.l3 else 0.0,
        "l2tlb_lat": mach.l2_tlb.latency,
        "pwc_lat": mach.pwc_latency,
        "service": mach.memory.service,
        "promo": (HP_STALL_BASE
                  + HP_STALL_PER_CORE * max(mach.num_cores - 1, 0)),
        "ech_rehash": ECH_REHASH_QUAD * max(mach.num_cores - 2, 0) ** 2,
        "ctlb_lat": mach.ctlb_latency,
        # multi-stack NDP memory: the expected extra hop cost of a memory
        # access, (remote fraction) x (hop cycles); 0.0 at num_stacks=1
        "stack_pen": ((1.0 - 1.0 / mach.num_stacks)
                      * mach.stack_hop_cycles),
    }.items()}


def _mech_arrays(names: Tuple[str, ...]) -> Dict[str, np.ndarray]:
    """The spec registry lowered to per-mechanism VALUE arrays, so lanes
    of one batch may disagree on walk depth, bypass, PWC placement, or
    huge-page semantics.  Only the walk FUNCTIONS must agree."""
    t = tables_for(names)
    return {"n_pte": t.n_pte, "parallel": t.parallel, "bypass": t.bypass,
            "pwc_on": t.pwc_on, "huge": t.huge, "ideal": t.ideal,
            "cache_tlb": t.cache_tlb, "segment": t.segment,
            "colocate": t.colocate}


def _walk_fns(names: Tuple[str, ...]) -> Tuple:
    """The code half of a mechanism tuple: the VPN -> PTE-line functions."""
    return tuple(s.walk_fn for s in specs_for(names))


#: the largest vpn the engine takes: the data line ``vpn * 64 + off``
#: stays below 2^31, so the scan's truncating and the epilogue's floor
#: division give the same bank and row, as in the JAX package
MAX_VPN = (1 << 25) - 1


def init_state(mach: "MachineConfig", m: int = M, batch: int | None = None,
               *, device="cuda") -> Dict:
    """Zeroed engine state on ``device``.  ``batch=None``: one simulation,
    tables (C, M, sets, ways); ``batch=B``: B independent simulations,
    tables (B, C, M, sets, ways).  Clock and counters are (M, C) per
    simulation, ``mem_accs`` (M,); a banked machine adds ``bank_row``
    (C, M, banks) open-row ids (-1: closed) and has ``mem_accs`` (M,
    banks)."""
    dev = resolve_device(device)
    c = mach.num_cores
    lead = () if batch is None else (batch,)

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    st = {name: {"tags": zeros((c, m, sets, ways), torch.int32),
                 "lru": zeros((c, m, sets, ways), torch.int32)}
          for name, (sets, ways) in _table_shapes(mach).items()}
    st["stamp"] = zeros((c, m), torch.int32)
    st["clock"] = zeros((m, c), torch.float32)
    if mach.memory.kind == "banked":
        nb = mach.memory.num_banks
        st["bank_row"] = torch.full(lead + (c, m, nb), -1, dtype=torch.int32,
                                    device=dev)
        st["mem_accs"] = zeros((m, nb), torch.float32)
    else:
        st["mem_accs"] = zeros((m,), torch.float32)
    st["counters"] = {k: zeros((m, c), torch.float32) for k in COUNTERS}
    return st


# ---------------------------------------------------------------------------
# bucket plans: what a (machine shape, walk fns, chunk) key fixes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Everything a batch's key fixes before its data is seen: the table
    shapes (``shape.tables``), the hierarchy depth, the cache-as-TLB, the
    banked geometry (0 banks: bounded-linear memory), the kernel
    instantiations that run, and the bytes of walk lines one lane takes a
    chunk."""

    shape: MachineShape
    walk_fns: Tuple
    chunk: int
    m: int
    n_hier: int
    has_ctlb: bool
    banks: int
    lines_per_row: int
    scan_kernel: str
    epilogue_kernel: str
    lane_lines_bytes: int

    def lines_group(self, lanes: int) -> int:
        """Chunks of walk lines made at once for ``lanes`` lanes: at most
        ``LINES_GROUP_BYTES`` of them."""
        return max(1, LINES_GROUP_BYTES // (lanes * self.lane_lines_bytes))


@functools.lru_cache(maxsize=None)
def _bucket_plan(shape: MachineShape, walk_fns: Tuple, chunk: int,
                 batched: bool = True) -> BucketPlan:
    """The plan of one key, made once a process (the counterpart of the
    JAX package's ``_chunk_runner``, keyed the same way; the port has
    only the batched engine, so ``batched`` is always True here)."""
    banked = shape.memory[0] == "banked"
    n_hier = len(shape.hier)
    has_ctlb = any(n == "ctlb" for n, _, _ in shape.tables)
    b = "true" if banked else "false"
    return BucketPlan(
        shape=shape, walk_fns=walk_fns, chunk=chunk, m=len(walk_fns),
        n_hier=n_hier, has_ctlb=has_ctlb,
        banks=shape.memory[1] if banked else 0,
        lines_per_row=(shape.memory[2] // MM.LINE_BYTES) if banked else 0,
        scan_kernel=(f"lru_scan_kernel<{n_hier}, "
                     f"{'true' if has_ctlb else 'false'}, {b}>"),
        epilogue_kernel=f"sim_epilogue_kernel<{b}>",
        lane_lines_bytes=(chunk * shape.num_cores * len(walk_fns)
                          * MAX_PTE * 4))


#: plans made before the last clear_runner_cache(), so the count that
#: runner_cache_info() reports stays monotone across clears
_CLEARED_MISSES = 0


def runner_cache_info():
    """Stats of the bucket-plan cache: ``misses`` counts the plans made
    this process — one per distinct (machine shape, walk-fn tuple,
    chunk, batched) key, monotone across :func:`clear_runner_cache`.  The
    sweep engine reports them as its "compiles"."""
    info = _bucket_plan.cache_info()
    return info._replace(misses=info.misses + _CLEARED_MISSES)


def clear_runner_cache() -> None:
    """Drop every cached bucket plan (the watchdog's recovery hook); the
    count of plans made survives in :func:`runner_cache_info`."""
    global _CLEARED_MISSES
    _CLEARED_MISSES += _bucket_plan.cache_info().misses
    _bucket_plan.cache_clear()


# ---------------------------------------------------------------------------
# the pieces around the kernels
# ---------------------------------------------------------------------------
def _pad_lines(a: torch.Tensor) -> torch.Tensor:
    """Pad (..., d) walk lines to (..., MAX_PTE)."""
    return torch.nn.functional.pad(a, (0, MAX_PTE - a.shape[-1]))


def walk_lines(vpn: torch.Tensor, is4k: torch.Tensor, huge: torch.Tensor,
               walk_fns: Tuple) -> torch.Tensor:
    """(T, L) vpns -> (T, L, M, MAX_PTE) int32 PTE line ids.  ``huge`` is
    (L, M) data: huge-page mechanisms take the radix lines in fragmented
    (4KB) regions."""
    radix = _pad_lines(PT.radix4_walk_lines(vpn))
    per_mech = []
    for i, fn in enumerate(walk_fns):
        if fn is None:
            lines = torch.zeros_like(radix)
        elif fn is PT.radix4_walk_lines:
            lines = radix
        else:
            lines = _pad_lines(fn(vpn))
        h = huge[None, :, i, None]
        per_mech.append(torch.where(h & is4k[..., None], radix, lines))
    return torch.stack(per_mech, dim=-2)


def _queue(clock: torch.Tensor, mem_accs: torch.Tensor,
           service: torch.Tensor) -> torch.Tensor:
    """Queue delay per (sim, mech) from the demand measured so far,
    bounded-linear law, held constant within the chunk.  clock (B, M, C),
    mem_accs (B, M), service (B,) -> (B, M).  Banked: the same law per
    bank, mem_accs (B, M, banks) -> (B, M, banks), so traffic on one bank
    never delays another."""
    elapsed = torch.clamp(clock.mean(dim=-1), min=1.0)
    if mem_accs.dim() == 3:
        return MM.queue_delay(mem_accs / elapsed[..., None],
                              service[:, None, None])
    rate = mem_accs / elapsed                 # aggregate accesses/cycle
    svc = service[:, None]
    rho = torch.clamp(rate * svc, 0.0, MM.RHO_MAX)
    return svc * rho * QUEUE_K


# ---------------------------------------------------------------------------
# the chunk loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Bucket:
    """One batch on the device: its plan, the padded inputs on the fused
    lane layout (T_pad, B*C), the per-lane mechanism tables, the per-sim
    data params (for the queue), and the kernels' flag words and
    parameter array.  The walk lines of the chunks of one group are kept
    in ``lines``."""

    mach: "MachineConfig"
    plan: BucketPlan
    shape: MachineShape
    walk_fns: Tuple
    b: int
    m: int
    chunk: int
    lens: List[int]
    xs: Tuple[torch.Tensor, ...]    # vpn, off, work, is4k, valid: (T_pad, L)
    mt_l: Dict[str, torch.Tensor]   # (L, M) (pwc_on (L, M, 4))
    dp: Dict[str, torch.Tensor]     # (B,)
    flags: torch.Tensor             # (L, M) int32
    params: torch.Tensor            # (L, K) float32
    group: int                      # chunks a group of walk lines
    lines: Tuple[int, torch.Tensor | None] = (-1, None)  # (group, lines)

    @property
    def c(self) -> int:
        return self.shape.num_cores

    @property
    def n_chunks(self) -> int:
        return self.xs[0].shape[0] // self.chunk

    def chunk_lines(self, i: int) -> torch.Tensor:
        """Chunk ``i``'s (T, L, M, MAX_PTE) walk lines, a slice of its
        group's, which are made (torch ops) when the group is first
        reached."""
        g, first = divmod(i, self.group)
        if self.lines[0] != g:
            self.lines = (-1, None)     # free the last group first
            sl = slice(g * self.group * self.chunk,
                       (g + 1) * self.group * self.chunk)
            self.lines = (g, walk_lines(self.xs[0][sl], self.xs[3][sl],
                                        self.mt_l["huge"], self.walk_fns))
        return self.lines[1][first * self.chunk:(first + 1) * self.chunk]


def _resolve_trace(trace, num_cores: int, length: int | None):
    """Accept a workload name or a ``"trace:<path>"`` spec of a real
    trace anywhere a trace dict is expected: resolved through
    :func:`repro_torch.workloads.generate_trace`, which dispatches specs
    to the ingest layer."""
    if isinstance(trace, str):
        from repro_torch.workloads import generate_trace, parse_workload_spec
        parse_workload_spec(trace)       # fail loudly at the boundary
        return generate_trace(trace, num_cores, length=length)
    return trace


def _prepare(jobs: Sequence["SimJob"], length: int | None, chunk: int,
             dev: torch.device) -> Tuple[_Bucket, List[np.ndarray]]:
    """Check the shape bucket, pad and pack the traces, move everything
    the chunks need to ``dev``.  Returns the bucket and each job's work
    array (for the instruction counts)."""
    shape = machine_shape(jobs[0].mach)
    wf = _walk_fns(jobs[0].mechs)
    c = shape.num_cores
    for j in jobs:
        if machine_shape(j.mach) != shape:
            raise ValueError(
                f"job {j.mach.name!r} breaks the shape bucket: "
                f"{machine_shape(j.mach)} != {shape} — split the batch "
                "by machine_shape() first")
        if _walk_fns(j.mechs) != wf:
            raise ValueError(
                f"job mechs {j.mechs} have different walk functions "
                "than the bucket's — bucket by walk-fn tuple first")

    vpns, offs, works, lens = [], [], [], []
    for j in jobs:
        vpn = j.trace["vpn"][:, :length] if length else j.trace["vpn"]
        if vpn.shape[0] != c:
            raise ValueError(f"trace has {vpn.shape[0]} cores, machine "
                             f"{j.mach.name!r} {c}")
        if vpn.size and not 0 <= vpn.min() <= vpn.max() <= MAX_VPN:
            raise ValueError(f"trace vpns span [{vpn.min()}, {vpn.max()}]; "
                             f"the engine takes 0..{MAX_VPN}")
        vpns.append(vpn)
        offs.append(j.trace["off"][:, : vpn.shape[1]])
        works.append(j.trace["work"][:, : vpn.shape[1]])
        lens.append(vpn.shape[1])
    t_pad = max(lens) + (-max(lens)) % chunk
    b = len(jobs)
    plan = _bucket_plan(shape, wf, chunk, True)

    def pack(arrs, dtype):
        out = np.zeros((t_pad, b, c), dtype)
        for i, a in enumerate(arrs):
            out[: lens[i], i] = np.ascontiguousarray(a.T)
        return out

    # huge-page fragmentation: which 2MB regions fell back to 4KB (host)
    is4ks = []
    for j, v in zip(jobs, vpns):
        frac = FRAC_4K.get(j.mach.num_cores, min(0.93, 0.05 + 0.11 *
                                                 j.mach.num_cores))
        region = PT._hash_np(v >> HUGE_SHIFT, _FRAG_SALT)
        is4ks.append(region % 1000 < int(frac * 1000))
    valid = np.zeros((t_pad, b, c), bool)     # per lane
    for i, n in enumerate(lens):
        valid[:n, i] = True
    # the fused lane layout (T_pad, B*C): lane b * C + core
    xs = tuple(torch.from_numpy(a.reshape(t_pad, b * c)).to(dev) for a in (
        pack(vpns, np.int32), pack(offs, np.int32),
        pack(works, np.float32), pack(is4ks, bool), valid))

    mts = [_mech_arrays(j.mechs) for j in jobs]
    dps = [_data_params(j.mach) for j in jobs]
    mt = {k: torch.from_numpy(np.stack([t[k] for t in mts])).to(dev)
          for k in mts[0]}
    dp = {k: torch.from_numpy(np.stack([d[k] for d in dps])).to(dev)
          for k in dps[0]}
    mt_l = {k: torch.repeat_interleave(v, c, dim=0) for k, v in mt.items()}
    dp_l = {k: torch.repeat_interleave(v, c, dim=0) for k, v in dp.items()}
    bucket = _Bucket(mach=jobs[0].mach, plan=plan, shape=shape, walk_fns=wf,
                     b=b, m=plan.m, chunk=chunk, lens=lens, xs=xs, mt_l=mt_l,
                     dp=dp, flags=LS.mech_flags(mt_l),
                     params=SE.lane_params(dp_l), group=plan.lines_group(b))
    bucket.chunk_lines(0)           # the first group's walk lines
    return bucket, works


def _scan_inputs(bk: _Bucket, state: Dict, i: int) -> Dict:
    """The scan's operands for chunk ``i`` on the fused lane layout, the
    tables, stamp and (banked) open rows as views of ``state`` (the scan
    updates them in place), plus ``work`` for the epilogue.  Views only:
    no copies."""
    sl = slice(i * bk.chunk, (i + 1) * bk.chunk)
    vpn, off, work, is4k, valid = (a[sl] for a in bk.xs)
    lanes = bk.b * bk.c

    def fused(t):
        return t.view((lanes,) + t.shape[2:])

    tables = {name: (fused(state[name]["tags"]), fused(state[name]["lru"]))
              for name, _, _ in bk.shape.tables}
    args = dict(vpn=vpn, off=off, is4k=is4k, valid=valid,
                pte=bk.chunk_lines(i), flags=bk.flags,
                stamp=state["stamp"].view(lanes, bk.m), tables=tables,
                work=work)
    if "bank_row" in state:
        args.update(bank_row=fused(state["bank_row"]),
                    lines_per_row=bk.plan.lines_per_row)
    return args


def _run_chunk(bk: _Bucket, state: Dict, i: int) -> None:
    """Chunk ``i``: the queue delay, the scan and the epilogue, which adds
    the chunk's deltas into ``state``."""
    args = _scan_inputs(bk, state, i)
    work = args.pop("work")
    q = _queue(state["clock"], state["mem_accs"], bk.dp["service"])
    packed = LS.lru_scan(**args)
    banked = {k: args[k] for k in ("pte", "vpn", "off", "lines_per_row")
              } if "bank_row" in args else {}
    SE.sim_epilogue(packed, work, args["is4k"], args["valid"], q, bk.flags,
                    bk.params, state["clock"], state["mem_accs"],
                    state["counters"], n_hier=bk.plan.n_hier,
                    has_ctlb=bk.plan.has_ctlb, **banked)


def simulate(mach: "MachineConfig", trace: Dict[str, np.ndarray] | str,
             length: int | None = None, *,
             mechs: Tuple[str, ...] | None = None,
             chunk: int = DEFAULT_CHUNK, device="cuda") -> SimResult:
    """Run the registered mechanisms over a multi-core trace on ``mach``.

    ``mechs`` selects/orders mechanisms from the spec registry (default:
    the paper's five).  The trace is zero-padded to a multiple of
    ``chunk`` (padding is masked out of every counter).  Runs on
    ``device`` (the card by default; ``"cpu"`` runs the plain scan)."""
    names = DEFAULT_MECHS if mechs is None else tuple(mechs)
    return simulate_batch(mach, [trace], length, mechs=names, chunk=chunk,
                          device=device)[0]


def simulate_batch(mach: "MachineConfig",
                   traces: Sequence[Dict[str, np.ndarray] | str],
                   length: int | None = None, *,
                   mechs: Tuple[str, ...] | None = None,
                   chunk: int = DEFAULT_CHUNK,
                   devices: int | None = None,
                   timings: Dict | None = None,
                   device="cuda") -> List[SimResult]:
    """Run B independent simulations sharing ``mach`` as one batch.

    ``traces`` is a sequence of trace dicts (each ``(num_cores, T_i)``);
    lanes with shorter traces are masked with per-sim valid bits, so
    mixed-length buckets are fine.  Lanes never interact.
    ``devices``: the lanes split over that many cards
    (:func:`simulate_batch_varied`).
    ``timings``, if given, is filled with wall clock: "total_s",
    "compile_s_est" (first-chunk excess over the steady per-chunk rate:
    the kernel's build and load, on the card), "run_s" (= total -
    compile estimate), "chunks" and "devices" (the cards used)."""
    names = DEFAULT_MECHS if mechs is None else tuple(mechs)
    return simulate_batch_varied(
        [SimJob(mach, tr, names) for tr in traces], length,
        chunk=chunk, devices=devices, timings=timings, device=device)


@dataclasses.dataclass
class SimJob:
    """One lane of a varied batch: a machine, its trace, and the
    mechanism tuple to evaluate.  All jobs of one
    :func:`simulate_batch_varied` call must share the machine SHAPE
    (:func:`machine_shape`) and the mechanisms' walk-fn tuple —
    everything value-like (latencies, service time, bypass/PWC/huge
    flags, walk depth) may differ per lane."""

    mach: "MachineConfig"
    trace: Dict[str, np.ndarray] | str
    mechs: Tuple[str, ...] = DEFAULT_MECHS


def sim_devices(devices: int | None, b: int, device="cuda") -> int:
    """The cards a batch of ``b`` lanes runs on (the JAX package's rule):
    ``devices``, or by default 1, or every card when ``SIM_DEVICES`` is
    set; clamped to the cards there are (one for the CPU) and to
    ``b``."""
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = devices
    if n is None:
        n = have if os.environ.get("SIM_DEVICES") else 1
    return max(1, min(n, have, b))


def lane_groups(b: int, n: int) -> List[range]:
    """The lanes of each of ``n`` groups over ``b`` jobs padded to a
    multiple of ``n`` (lanes ``>= b`` are pad lanes)."""
    per = -(-b // n)
    return [range(g * per, (g + 1) * per) for g in range(n)]


def simulate_batch_varied(jobs: Sequence[SimJob],
                          length: int | None = None, *,
                          chunk: int = DEFAULT_CHUNK,
                          devices: int | None = None,
                          timings: Dict | None = None,
                          device="cuda") -> List[SimResult]:
    """B heterogeneous (machine, trace, mechanisms) jobs as one batch.

    The jobs must form one shape bucket: equal :func:`machine_shape` and
    equal mechanism walk-fn tuples (a ``ValueError`` names the offender
    otherwise).  Everything value-like varies per lane.  ``devices``:
    the lanes split over that many cards (:func:`sim_devices`; on the
    card ``device`` names, ``cuda:0`` to ``cuda:n-1``), and ``timings``
    records the count used as "devices"."""
    dev = resolve_device(device)
    if not jobs:
        return []
    n = sim_devices(devices, len(jobs), dev)
    group_devices = ([torch.device("cuda", g) for g in range(n)]
                     if dev.type == "cuda" and n > 1 else [dev])
    return run_lane_groups(jobs, group_devices, length, chunk=chunk,
                           timings=timings)


def run_lane_groups(jobs: Sequence[SimJob], group_devices: Sequence,
                    length: int | None = None, *,
                    chunk: int = DEFAULT_CHUNK,
                    timings: Dict | None = None) -> List[SimResult]:
    """The jobs as ``len(group_devices)`` lane groups (:func:`lane_groups`),
    group g on ``group_devices[g]`` (the CPU tests give several CPU
    devices), the chunks issued to the groups in turn; the results in
    job order."""
    jobs = [j if not isinstance(j.trace, str)
            else dataclasses.replace(
                j, trace=_resolve_trace(j.trace, j.mach.num_cores, length))
            for j in jobs]
    b, n = len(jobs), len(group_devices)
    groups = lane_groups(b, n)
    first = jobs[0]
    empty = {k: first.trace[k][:, :0] for k in ("vpn", "off", "work")}
    padded = list(jobs) + [dataclasses.replace(first, trace=empty)] * (
        len(groups) * len(groups[0]) - b)
    runs = []
    groups = [g for g in groups if g[0] < b]    # a group of pads has no work
    for lanes, gdev in zip(groups, group_devices):
        gdev = resolve_device(gdev)
        bk, works = _prepare([padded[i] for i in lanes], length, chunk, gdev)
        runs.append((bk, works, init_state(bk.mach, bk.m, batch=bk.b,
                                           device=gdev), gdev))

    def sync():
        for _, _, _, gdev in runs:
            if gdev.type == "cuda":
                torch.cuda.synchronize(gdev)

    n_chunks = max(bk.n_chunks for bk, _, _, _ in runs)
    t0 = time.perf_counter()
    t_first = 0.0
    for i in range(n_chunks):
        for bk, _, state, _ in runs:
            if i < bk.n_chunks:
                _run_chunk(bk, state, i)
        if timings is not None and i == 0:
            sync()
            t_first = time.perf_counter() - t0
    results: List[SimResult] = []
    for (bk, works, state, _), lanes in zip(runs, groups):
        results.extend(_results(bk, works, state,
                                [padded[i] for i in lanes]))
    if timings is not None:
        total = time.perf_counter() - t0
        steady = ((total - t_first) / (n_chunks - 1)
                  if n_chunks > 1 else 0.0)
        timings["chunks"] = n_chunks
        timings["total_s"] = total
        timings["compile_s_est"] = max(0.0, t_first - steady)
        timings["run_s"] = total - timings["compile_s_est"]
        timings["devices"] = n
    return results[:b]


def _results(bk: _Bucket, works, state: Dict, jobs) -> List[SimResult]:
    cnt = {k: v.cpu().numpy() for k, v in state["counters"].items()}
    clock = state["clock"].cpu().numpy()
    return [SimResult(
        mechs=jobs[i].mechs,
        cycles=clock[i],
        instructions=np.asarray((works[i] + 1).sum(axis=1), np.float64),
        trans_cycles=cnt["trans"][i],
        walk_cycles=cnt["walk_cyc"][i],
        walks=cnt["walks"][i],
        l1tlb_misses=cnt["l1tlb_miss"][i],
        accesses=bk.lens[i],
        pte_accesses=cnt["pte_acc"][i],
        pte_l1_hits=cnt["pte_l1_hit"][i],
        pte_mem=cnt["pte_mem"][i],
        data_l1_misses=cnt["data_l1_miss"][i],
        data_mem=cnt["data_mem"][i],
    ) for i in range(len(jobs))]
