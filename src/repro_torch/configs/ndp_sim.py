"""The paper's own configuration: Table I machine configs + Table II workloads.

The port's copy of ``repro.configs.ndp_sim``: it parameterizes the
translation simulator (``repro_torch.sim``).  All latencies are in core
cycles at 2.6 GHz, matching Table I of the paper.  The sweep and
search presets (``SWEEPS``, ``SEARCH_SPACES``) are the reference's plain
data.  Its serving tables wait for the costed-serving slice, and the
deprecated flat memory kwargs (``mem_latency=`` ...) are not ported:
``memory`` takes a ``MemoryModel``, a preset name, a field dict or None.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Tuple


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
        # lazy: importing repro_torch.sim runs its __init__, whose sweep
        # and search modules import this one
        from repro_torch.sim.memory_model import resolve_memory_model
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


# ---------------------------------------------------------------------------
# sensitivity-sweep presets (consumed by repro_torch.sim.sweep(name))
# ---------------------------------------------------------------------------
#: the workload subset the sensitivity figures sweep over: one per
#: suite-level behaviour (uniform, graph, frontier, MC lookup,
#: embedding, k-mer) — 6 workloads x 4 machine variants = 24 points
SWEEP_WORKLOADS: Tuple[str, ...] = ("rnd", "bc", "bfs", "xs", "dlrm",
                                    "gen")

#: Declarative grids for the paper's sensitivity studies.  Each entry is
#: plain data: ``axes`` is an ordered (name, values) tuple — special
#: names workload/machine/cores/mechs, everything else a MachineConfig
#: override path — plus optional base/cores/workload/mechs/preset
#: defaults and a human-facing ``figure`` note.  Shape-changing axes
#: (PWC/TLB sizes) cost one bucket per size; value-only axes
#: (latencies, bypass flags) share ONE bucket plan across the whole
#: grid — the bucketing is asserted in tests/test_torch_sweep.py.
SWEEPS: Dict[str, dict] = {
    # PWC sizing: NDPage keeps its lead at every page-walk-cache size
    "pwc_size": dict(
        axes=(("pwc_entries", (8, 16, 32, 64)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="PWC-size sensitivity (4 shapes, 24 points)"),
    # L1-DTLB sizing: translation overhead vs TLB reach
    "tlb_size": dict(
        axes=(("l1_dtlb.entries", (32, 64, 128, 256)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="L1-DTLB-size sensitivity (4 shapes, 24 points)"),
    # L1-bypass ablation: ndpage vs ndpage_nobyp share walk functions,
    # so BOTH mechanism tuples land in one shape bucket (bypass is
    # per-lane data) — 24 points, at most one bucket plan
    "l1_bypass": dict(
        axes=(("mechs", (("radix", "ndpage", "ideal"),
                         ("radix", "ndpage_nobyp", "ideal"))),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="L1-bypass on/off ablation (1 shape, 12 points)"),
    # flattened-level choice: PL2-merge (ndpage) vs PL3-merge
    # (ndpage_pl3) — different walk functions, two buckets
    "flatten_level": dict(
        axes=(("mechs", (("radix", "ndpage", "ideal"),
                         ("radix", "ndpage_pl3", "ideal"))),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="flattened-level choice PL2 vs PL3 (2 buckets)"),
    # core scaling: the paper's 1/4/8-core study as one sweep
    "core_scaling": dict(
        axes=(("cores", CORE_COUNTS),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp",
        figure="1/4/8-core scaling (3 shapes, 18 points)"),
    # memory latency: pure value axis — 24 points, ONE bucket plan
    "mem_latency": dict(
        axes=(("memory.latency", (60.0, 100.0, 170.0, 240.0)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="memory-latency sensitivity (1 shape, 24 points, "
               "1 compile)"),
    # banked DRAM timing: switch the memory model to the banked preset
    # (ONE shape — bank geometry is part of it), then sweep the
    # open/closed-row timings as pure value axes.  memory_model comes
    # FIRST: overrides apply in axis order, so t_cas/t_rp land on the
    # already-banked model.
    "banked_timing": dict(
        axes=(("memory_model", ("banked",)),
              ("memory.t_cas", (15.0, 25.0, 40.0)),
              ("memory.t_rp", (20.0, 30.0)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        figure="banked DRAM timing sensitivity (1 shape, 36 points, "
               "1 compile)"),
    # mechanism zoo: the related-work designs (Victima cache-as-TLB,
    # Picorel inverted/segment, CODA co-location, range table) against
    # the paper set on the zoo machine (ctlb enabled, 4 memory stacks).
    # One mechs tuple + one shape => ONE bucket for all 6 points.
    "zoo": dict(
        axes=(("ctlb_kb", (256,)),
              ("num_stacks", (4,)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        mechs=("radix", "ndpage_search", "victima", "picorel",
               "coda", "range_table", "ideal"),
        figure="related-work mechanism zoo (1 shape, 6 points, "
               "1 compile)"),
    # Victima reach: sweep the cache-capacity-repurposing (demotion /
    # promotion occupancy) knob — each ctlb_kb is a distinct shape
    "victima_reach": dict(
        axes=(("ctlb_kb", (64, 128, 256, 512)),
              ("workload", SWEEP_WORKLOADS)),
        base="ndp", cores=4,
        mechs=("radix", "victima", "ideal"),
        figure="Victima cache-as-TLB reach sensitivity "
               "(4 shapes, 24 points)"),
}


# ---------------------------------------------------------------------------
# design-space-search presets (consumed by repro_torch.sim.search(name))
# ---------------------------------------------------------------------------
#: the two committed real-format fixture traces, as "trace:" workload
#: specs (paths relative to the repo root; the search layer absolutizes
#: them) — the search objective averages over the figure-suite workload
#: subset PLUS these, so a config that only wins on synthetics can't
#: climb the frontier
SEARCH_FIXTURES: Tuple[str, ...] = (
    "trace:tests/fixtures/traces/gups_small.champsim.xz",
    "trace:tests/fixtures/traces/graph_small.lackey.gz",
)

#: Declarative design spaces for the automated search.  Each entry is
#: plain data consumed by ``repro_torch.sim._search``: ``knobs`` is an
#: ordered (name, values) tuple — ``flatten``/``l1_bypass``/``huge``
#: select the candidate's mechanism STRUCTURE from the registry family,
#: ``l1_dtlb`` is an (entries, ways) geometry bundle, everything else a
#: MachineConfig override path — plus the population sizing, the
#: workload suite the fitness averages over, and the pinned seed that
#: makes runs hermetic.  Geometry knobs change table shapes (one bucket
#: plan per distinct shape x flatten level); flag knobs ride the batch
#: lanes as data.
SEARCH_SPACES: Dict[str, dict] = {
    # the standard seeded search: 4x3x2 machine geometries x 2 PWC
    # latencies x 8 mechanism structures = 384 genomes; >= 200
    # evaluated across <= 10 generations (1 paper + 56 random +
    # 6 x 24 offspring = 201).  pwc_latency is a VALUE-ONLY knob —
    # it rides the batch lanes and adds no buckets
    "default": dict(
        knobs=(("pwc_entries", (8, 16, 32, 64)),
               ("pwc_latency", (2, 4)),
               ("l1_dtlb", ((64, 4), (128, 8), (256, 8))),
               ("l2_tlb.entries", (1536, 3072)),
               ("flatten", ("pl2", "pl3")),
               ("l1_bypass", (True, False)),
               ("huge", (False, True))),
        cores=4,
        workloads=SWEEP_WORKLOADS + SEARCH_FIXTURES,
        n_random=56, population=32, generations=6, offspring=24,
        trace_len=512, chunk=512, preset="smoke", seed=20250808),
    # mechanism zoo as a genome knob: which related-work design to run
    # is itself searched, alongside the structures they need (ctlb
    # reach for victima, a fixed 4-stack memory so co-location
    # matters).  ``zoo_mech`` overrides the structural triple; paper
    # default is ``ndpage`` (see _search.PAPER_DEFAULTS).
    "zoo": dict(
        knobs=(("pwc_entries", (16, 32)),
               ("ctlb_kb", (0, 256)),
               ("num_stacks", (4,)),
               ("zoo_mech", ("ndpage_search", "victima", "picorel",
                             "coda", "range_table"))),
        cores=4,
        workloads=("rnd", "bc", "xs") + SEARCH_FIXTURES,
        n_random=12, population=8, generations=1, offspring=6,
        trace_len=512, chunk=512, preset="smoke", seed=11),
    # memory-model space: is the banked row-buffer model worth its
    # bucket, and does it move the structural knobs' frontier?
    # ``memory_model`` is a genome knob applied via apply_param (the
    # banked kind keys its own shape bucket; a NEW space rather than a
    # "default" extension so the committed frontier baseline's genome
    # schema stays untouched).
    "memory": dict(
        knobs=(("pwc_entries", (16, 32)),
               ("flatten", ("pl2", "pl3")),
               ("l1_bypass", (True, False)),
               ("memory_model", ("bounded_linear", "banked"))),
        cores=4,
        workloads=("rnd", "bc", "xs") + SEARCH_FIXTURES[:1],
        n_random=12, population=8, generations=1, offspring=8,
        trace_len=512, chunk=512, preset="smoke", seed=29),
    # fast lane: 1 generation over a 2-shape slice
    "quick": dict(
        knobs=(("pwc_entries", (16, 32)),
               ("flatten", ("pl2", "pl3")),
               ("l1_bypass", (True, False)),
               ("huge", (False, True))),
        cores=4,
        workloads=("rnd", "bc", "xs") + SEARCH_FIXTURES[:1],
        n_random=10, population=8, generations=1, offspring=6,
        trace_len=512, chunk=512, preset="smoke", seed=7),
}
