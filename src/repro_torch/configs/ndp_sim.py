"""The paper's own configuration: Table I machine configs + Table II workloads.

The port's copy of ``repro.configs.ndp_sim``: it parameterizes the
translation simulator (``repro_torch.sim``).  All latencies are in core
cycles at 2.6 GHz, matching Table I of the paper.  The sweep, search and
serving tables of the reference wait for the sweep slice, and the
deprecated flat memory kwargs (``mem_latency=`` ...) are not ported:
``memory`` takes a ``MemoryModel``, a preset name, a field dict or None.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Tuple

from repro_torch.sim.memory_model import resolve_memory_model


@dataclass(frozen=True)
class CacheParams:
    size_bytes: int
    ways: int
    latency: int                # cycles
    line_bytes: int = 64

    @property
    def num_sets(self) -> int:
        return self.size_bytes // (self.ways * self.line_bytes)


@dataclass(frozen=True)
class TLBParams:
    entries: int
    ways: int
    latency: int


@dataclass(frozen=True)
class MachineConfig:
    """One simulated machine (CPU or NDP), per Table I."""

    name: str
    is_ndp: bool
    num_cores: int
    freq_ghz: float = 2.6
    # cache hierarchy: NDP has ONLY L1; CPU has L1+L2+L3.
    l1d: CacheParams = field(default_factory=lambda: CacheParams(32 * 1024, 8, 4))
    l2: CacheParams | None = None
    l3: CacheParams | None = None
    # MMU
    l1_dtlb: TLBParams = field(default_factory=lambda: TLBParams(64, 4, 1))
    l2_tlb: TLBParams = field(default_factory=lambda: TLBParams(1536, 12, 12))
    # page-walk caches: one per upper level, near-ideal for L4/L3 (paper VI)
    pwc_entries: int = 32
    pwc_latency: int = 2
    # memory system: a repro_torch.sim.memory_model.MemoryModel, a preset
    # name ("bounded_linear"/"banked"), a field dict, or None (the
    # bounded_linear DDR4 default)
    memory: Any = None
    interconnect_hop: int = 4       # mesh hop latency, cycles
    interconnect_hops_to_mem: int = 8
    # --- mechanism-zoo knobs (all inert at their defaults) ---
    # cache-as-TLB (Victima): ctlb_kb KB of cache capacity repurposed as
    # a second large TLB level, one translation per repurposed 64B line;
    # 0 = the structure does not exist
    ctlb_kb: int = 0
    ctlb_ways: int = 8
    ctlb_latency: int = 16          # L2-cache-latency-class probe
    # multi-stack NDP memory (CODA): with >1 stacks a fraction
    # (1 - 1/num_stacks) of memory accesses land in a REMOTE stack and
    # pay stack_hop_cycles extra; co-location-aware mechanisms dodge
    # most of it
    num_stacks: int = 1
    stack_hop_cycles: int = 36

    def __post_init__(self):
        object.__setattr__(self, "memory", resolve_memory_model(self.memory))


def cpu_machine(cores: int) -> MachineConfig:
    return MachineConfig(
        name=f"cpu-{cores}c", is_ndp=False, num_cores=cores,
        l2=CacheParams(512 * 1024, 16, 16),
        # Table I: 2MB/core — modelled as a private 2MB slice per core
        l3=CacheParams(2 * 1024 * 1024, 16, 35),
        memory=dict(latency=170.0,          # DDR4 ~65ns @2.6GHz
                    bandwidth_gbs=19.2, service=12.0),
        interconnect_hops_to_mem=8,
    )


def ndp_machine(cores: int) -> MachineConfig:
    return MachineConfig(
        name=f"ndp-{cores}c", is_ndp=True, num_cores=cores,
        l2=None, l3=None,
        # NDP core in the logic layer: short path to the stacked DRAM
        # (HBM2, bank-limited irregular single-line accesses)
        memory=dict(latency=100.0, bandwidth_gbs=307.2, service=46.0),
        interconnect_hops_to_mem=1,
    )


def zoo_machine(cores: int) -> MachineConfig:
    """The mechanism-zoo comparison point: an NDP machine with 256KB of
    cache repurposable as translation reach (Victima) and a 4-stack
    memory with a local-vs-remote latency split (CODA)."""
    return replace(ndp_machine(cores), name=f"zoo-{cores}c", ctlb_kb=256,
                   num_stacks=4)


# Table II — workload trace parameters.  footprint_gb reproduces the
# dataset sizes; pattern keys map to generators in repro_torch.workloads.
WORKLOADS: Dict[str, dict] = {
    "bc":   dict(suite="GraphBIG", pattern="graph", footprint_gb=8,  alpha=2.1),
    "bfs":  dict(suite="GraphBIG", pattern="graph_frontier", footprint_gb=8, alpha=2.1),
    "cc":   dict(suite="GraphBIG", pattern="graph", footprint_gb=8,  alpha=2.3),
    "gc":   dict(suite="GraphBIG", pattern="graph", footprint_gb=8,  alpha=2.2),
    "pr":   dict(suite="GraphBIG", pattern="graph_sweep", footprint_gb=8, alpha=2.1),
    "tc":   dict(suite="GraphBIG", pattern="graph", footprint_gb=8,  alpha=1.9),
    "sp":   dict(suite="GraphBIG", pattern="graph_frontier", footprint_gb=8, alpha=2.0),
    "xs":   dict(suite="XSBench",  pattern="mc_lookup", footprint_gb=9),
    "rnd":  dict(suite="GUPS",     pattern="uniform", footprint_gb=10),
    "dlrm": dict(suite="DLRM",     pattern="embedding_bag", footprint_gb=10),
    "gen":  dict(suite="GenomicsBench", pattern="kmer", footprint_gb=33),
}

CORE_COUNTS: Tuple[int, ...] = (1, 4, 8)


@dataclass(frozen=True)
class SimPreset:
    """A (trace window, footprint scale, seed, chunk) bundle.

    ``smoke`` shrinks the simulated window so the whole simulator path
    runs at test cost; the footprint stays at Table-II scale, since the
    paper's effects need footprint >> TLB reach.  ``full`` is the
    paper-figure configuration.
    """

    name: str
    trace_len: int
    footprint_scale: float      # multiplies Table-II footprint_gb
    seed: int
    chunk: int                  # scan chunk length (repro_torch.sim.simulator)


PRESETS: Dict[str, SimPreset] = {
    "smoke": SimPreset("smoke", trace_len=2048, footprint_scale=1.0,
                       seed=1234, chunk=512),
    "full": SimPreset("full", trace_len=8000, footprint_scale=1.0,
                      seed=0, chunk=1024),
}
