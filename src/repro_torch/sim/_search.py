"""Automated design-space search: evolve translation configs on the
sweep engine.

The port of ``repro.sim._search``.  The paper hand-picks NDPage's design
point (flatten the last two levels, bypass the L1 for PTEs, fixed
PWC/TLB geometry) and never asks whether a *different* point in the same
space dominates it.  This
module asks, with the harness shape neural-architecture-search uses —
seeded random baseline -> objective evaluation -> evolutionary Pareto
loop (mutation + crossover over the frontier) — made near-free by the
sweep engine's shape/data split: every generation's candidates pack as
value-only lanes into :func:`repro_torch.sim.run_bucketed`, ONE
:func:`simulate_batch_varied` dispatch per (machine-shape, walk-fn)
bucket (on the card the LRU-scan and epilogue kernels a chunk), so the
bucket plans made are bounded by the bucket count, never the population
size (``runner_cache_info()`` asserts it in tests).

The genome
----------
A candidate is one value per knob of a declarative :class:`SearchSpace`
(presets in ``repro_torch.configs.ndp_sim.SEARCH_SPACES``):

  ``pwc_entries``, ``l2_tlb.entries``, ...   MachineConfig override
                  paths (geometry knobs change table shapes)
  ``l1_dtlb``     an (entries, ways) L1-DTLB geometry bundle
  ``flatten``     "pl2" | "pl3" — which levels the flattened node merges
  ``l1_bypass``   PTE fills bypass the NDP L1 (True) or pollute it
  ``huge``        the candidate maps 2MB huge pages

The structural triple (flatten, l1_bypass, huge) selects one of the
eight registered ``ndpage*`` mechanism variants; each candidate is
simulated as ``("radix", <variant>)`` so its speedup baseline rides the
same lanes.

Objectives (multi-objective, named, directional)
------------------------------------------------
  ``mean_speedup``  (max) suite-mean speedup over radix across the
                    figure-suite workloads plus the two committed
                    real-trace fixtures
  ``sram_kb``       (min) an SRAM/area proxy from the geometry knobs:
                    8 bytes per L1-DTLB / L2-TLB entry + 8 bytes per
                    PWC entry per walk level (``MAX_PTE`` levels)
  ``worst_ptw``     (min) worst-case average page-table-walk latency
                    (cycles) across the workload suite

The output is a :class:`SearchResult`: the Pareto frontier (no
dominated points), full provenance (seed, generations, population,
bucket-plan counts), and an explicit verdict on whether any discovered
point DOMINATES the paper's NDPage config.

Caching / resume
----------------
Evaluated objectives are cached per-candidate to
``.trace_cache/repro_torch/search_evals_*.json`` (the port's own
directory) — flushed after every generation, keyed on the space, the
workload suite (fixture file hashes included), the trace preset (seed
included), the device type and the engine file hashes — so a resumed or
repeated run re-dispatches only genomes it has never seen.  Same search
seed + same engine => bit-identical frontier.

CLI:  ``python -m repro_torch.sim.search [--smoke|--quick|--space S]
[--device cpu] [--out FILE]`` (``--smoke``, the default, is the standard
seeded search, >= 200 candidates; ``--quick`` one generation).  With
``--out`` the ``"search"`` section is merged into that json file; there
is no default file.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.ndp_sim import (PRESETS, SEARCH_SPACES,
                                         MachineConfig, ndp_machine)
from repro_torch.sim import _sweep
from repro_torch.sim._sweep import apply_param, run_bucketed
from repro_torch.sim.mechanisms import MAX_PTE
from repro_torch.sim.simulator import SimJob, SimResult
from repro_torch.util import resilience

#: part of the eval-cache key: bump on any change to the evaluation or
#: objective derivation in this module
_SEARCH_VERSION = 1

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

#: knobs that select the candidate's mechanism STRUCTURE instead of a
#: MachineConfig override
STRUCT_KNOBS = ("flatten", "l1_bypass", "huge")

#: (flatten, l1_bypass, huge) -> registered mechanism name
MECH_BY_STRUCT: Dict[Tuple[str, bool, bool], str] = {
    ("pl2", True, False): "ndpage",
    ("pl2", False, False): "ndpage_nobyp",
    ("pl2", True, True): "ndpage_hp",
    ("pl2", False, True): "ndpage_nobyp_hp",
    ("pl3", True, False): "ndpage_pl3",
    ("pl3", False, False): "ndpage_pl3_nobyp",
    ("pl3", True, True): "ndpage_pl3_hp",
    ("pl3", False, True): "ndpage_pl3_nobyp_hp",
}

#: the paper's NDPage design point, per knob — knobs a space omits fall
#: back to these, and the paper candidate (always evaluated, generation
#: 0) is exactly this genome restricted to the space's knobs
PAPER_DEFAULTS: "OrderedDict[str, object]" = OrderedDict([
    ("pwc_entries", 32),
    ("pwc_latency", 2),
    ("l1_dtlb", (64, 4)),
    ("l2_tlb.entries", 1536),
    ("flatten", "pl2"),
    ("l1_bypass", True),
    ("huge", False),
    # direct mechanism pick (the zoo space); "ndpage" = defer to the
    # structural triple above
    ("zoo_mech", "ndpage"),
    # zoo machine knobs: the paper machine carves no cache into a
    # cache-as-TLB and models a single memory stack
    ("ctlb_kb", 0),
    ("num_stacks", 1),
    # DRAM model preset (the "memory" space flips this to "banked");
    # the paper's numbers are calibrated on the bounded-linear model
    ("memory_model", "bounded_linear"),
])

#: named objectives with their optimization direction
OBJECTIVES: Tuple[Tuple[str, str], ...] = (
    ("mean_speedup", "max"),
    ("sram_kb", "min"),
    ("worst_ptw", "min"),
)


# ---------------------------------------------------------------------------
# the declarative space
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """One declarative design space + search sizing (see module doc)."""

    name: str
    knobs: Tuple[Tuple[str, Tuple], ...]     # ordered (name, values)
    cores: int
    workloads: Tuple[str, ...]
    n_random: int
    population: int
    generations: int
    offspring: int
    trace_len: int
    chunk: int
    preset: str
    seed: int

    def __post_init__(self):
        for name, values in self.knobs:
            if not values:
                raise ValueError(f"knob {name!r} has no values")
            if len(set(values)) != len(values):
                raise ValueError(f"knob {name!r} has duplicate values")

    @property
    def knob_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.knobs)

    def size(self) -> int:
        return int(np.prod([len(v) for _, v in self.knobs]))

    @classmethod
    def named(cls, name: str) -> "SearchSpace":
        try:
            spec = dict(SEARCH_SPACES[name])
        except KeyError:
            raise KeyError(f"unknown search space {name!r}; available: "
                           f"{sorted(SEARCH_SPACES)}") from None
        spec["knobs"] = tuple((n, tuple(v)) for n, v in spec["knobs"])
        spec["workloads"] = tuple(spec["workloads"])
        return cls(name=name, **spec)


def resolve_space(space: "SearchSpace | str") -> SearchSpace:
    return SearchSpace.named(space) if isinstance(space, str) else space


# ---------------------------------------------------------------------------
# genomes
# ---------------------------------------------------------------------------
def paper_genome(space: SearchSpace) -> Tuple:
    """The paper's design point expressed in this space's knobs."""
    return tuple(PAPER_DEFAULTS[n] for n in space.knob_names)


def genome_dict(space: SearchSpace, genome: Tuple
                ) -> "OrderedDict[str, object]":
    return OrderedDict(zip(space.knob_names, genome))


def genome_key(space: SearchSpace, genome: Tuple) -> str:
    """Stable JSON key for one genome (tuples become lists)."""
    return json.dumps(list(genome_dict(space, genome).items()),
                      default=list)


def _knob(space: SearchSpace, genome: Tuple, name: str):
    names = space.knob_names
    return (genome[names.index(name)] if name in names
            else PAPER_DEFAULTS[name])


def mech_for(space: SearchSpace, genome: Tuple) -> str:
    """The registered mechanism variant this genome selects: an explicit
    ``zoo_mech`` knob wins outright (zoo spaces search over whole
    designs, not NDPage structure); ``"ndpage"`` or an absent knob
    defers to the structural triple."""
    zoo = _knob(space, genome, "zoo_mech")
    if zoo != "ndpage":
        return str(zoo)
    struct = (_knob(space, genome, "flatten"),
              bool(_knob(space, genome, "l1_bypass")),
              bool(_knob(space, genome, "huge")))
    return MECH_BY_STRUCT[struct]


def build_machine(space: SearchSpace, genome: Tuple) -> MachineConfig:
    """The candidate's NDP machine: the base ndp config with every
    geometry knob applied."""
    mach = ndp_machine(space.cores)
    for name, value in genome_dict(space, genome).items():
        if name in STRUCT_KNOBS or name == "zoo_mech":
            continue
        if name == "l1_dtlb":
            entries, ways = value
            mach = apply_param(mach, "l1_dtlb.entries", int(entries))
            mach = apply_param(mach, "l1_dtlb.ways", int(ways))
        else:
            mach = apply_param(mach, name, value)
    return mach


def sram_kb(space: SearchSpace, genome: Tuple) -> float:
    """SRAM/area proxy (KB) of the genome's translation structures:
    8 bytes per TLB entry (tag + PPN) and 8 bytes per PWC entry per
    walk level (the PWC table is ``MAX_PTE`` sets x ``pwc_entries``
    ways).  Analytic in the genome, so the objective is exact and
    deterministic."""
    dtlb_entries, _ = _knob(space, genome, "l1_dtlb")
    sram_bytes = (8 * int(_knob(space, genome, "pwc_entries")) * MAX_PTE
                  + 8 * int(dtlb_entries)
                  + 8 * int(_knob(space, genome, "l2_tlb.entries")))
    return sram_bytes / 1024.0


# ---------------------------------------------------------------------------
# dominance / Pareto frontier
# ---------------------------------------------------------------------------
def dominates(a: Dict[str, float], b: Dict[str, float],
              objectives: Sequence[Tuple[str, str]] = OBJECTIVES) -> bool:
    """True iff objective vector ``a`` dominates ``b``: at least as good
    on every objective (directionally) and strictly better on one."""
    strict = False
    for name, direction in objectives:
        va, vb = a[name], b[name]
        if direction == "min":
            va, vb = -va, -vb
        if va < vb:
            return False
        if va > vb:
            strict = True
    return strict


def pareto_indices(vectors: Sequence[Dict[str, float]],
                   objectives: Sequence[Tuple[str, str]] = OBJECTIVES
                   ) -> List[int]:
    """Indices of the non-dominated vectors, in input order."""
    return [i for i, v in enumerate(vectors)
            if not any(dominates(w, v, objectives)
                       for j, w in enumerate(vectors) if j != i)]


# ---------------------------------------------------------------------------
# evaluated candidates
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Candidate:
    """One evaluated genome."""

    genome: "OrderedDict[str, object]"
    mech: str
    objectives: Dict[str, float]
    per_workload: Dict[str, float]      # workload -> speedup over radix
    origin: str                          # paper|random|mutation|crossover
    gen: int

    def to_json_dict(self) -> Dict:
        return {"genome": {k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in self.genome.items()},
                "mech": self.mech,
                "objectives": {k: round(v, 6)
                               for k, v in self.objectives.items()},
                "per_workload": {k: round(v, 6)
                                 for k, v in self.per_workload.items()},
                "origin": self.origin, "gen": self.gen}


@dataclasses.dataclass
class SearchResult:
    """Everything one search run produced: every evaluated candidate,
    the Pareto frontier (no dominated points, deterministically
    ordered), the paper-config verdict, and full provenance."""

    space: SearchSpace
    objectives: Tuple[Tuple[str, str], ...]
    candidates: List[Candidate]
    frontier: List[Candidate]
    paper: Candidate
    verdict: Dict
    provenance: Dict

    def to_json_dict(self) -> Dict:
        return {
            "space": self.space.name,
            "space_size": self.space.size(),
            "objectives": [{"name": n, "direction": d}
                           for n, d in self.objectives],
            "evaluated": len(self.candidates),
            "frontier": [c.to_json_dict() for c in self.frontier],
            "paper": self.paper.to_json_dict(),
            "verdict": self.verdict,
            "provenance": self.provenance,
        }


def _frontier_sort_key(c: Candidate):
    return (-c.objectives["mean_speedup"], c.objectives["sram_kb"],
            c.objectives["worst_ptw"], json.dumps(
                list(c.genome.items()), default=list))


# ---------------------------------------------------------------------------
# evaluation: populations -> value-only lanes on the sweep engine
# ---------------------------------------------------------------------------
def _abs_workload(workload: str) -> str:
    """Absolutize a relative ``trace:`` fixture path against the repo
    root (the declarative spaces keep paths portable/relative)."""
    from repro_torch.workloads import parse_workload_spec
    spec = parse_workload_spec(workload)
    if spec.kind != "trace" or os.path.isabs(spec.name):
        return workload
    return spec.with_path(os.path.join(_ROOT, spec.name)).canonical()


_TRACES: Dict[Tuple, Dict] = {}


def _trace_table(space: SearchSpace) -> Dict[str, Dict]:
    """workload -> trace dict for this space, generated once per
    process (both sides additionally memoize on disk)."""
    from repro_torch.workloads import generate_trace
    sim_preset = PRESETS[space.preset]
    out = {}
    for wl in space.workloads:
        key = (wl, space.cores, space.trace_len, space.preset)
        if key not in _TRACES:
            _TRACES[key] = generate_trace(
                _abs_workload(wl), space.cores, length=space.trace_len,
                seed=sim_preset.seed, preset=sim_preset)
        out[wl] = _TRACES[key]
    return out


def _objectives_from_results(space: SearchSpace, genome: Tuple,
                             mech: str, results: Sequence[SimResult]
                             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    per_wl = {wl: float(res.speedup_vs("radix")[mech])
              for wl, res in zip(space.workloads, results)}
    worst = max(float(res.scalar("avg_ptw_latency", mech))
                for res in results)
    obj = {"mean_speedup": float(np.mean(list(per_wl.values()))),
           "sram_kb": sram_kb(space, genome),
           "worst_ptw": worst}
    return obj, per_wl


def evaluate_genomes(space: SearchSpace, genomes: Sequence[Tuple], *,
                     cache: Dict | None = None,
                     devices: int | None = None,
                     checkpoint: "bool | str | None" = None,
                     watchdog_s: float | None = None, device="cuda"
                     ) -> Tuple[List[Tuple[Dict, Dict, str]], Dict]:
    """Evaluate a batch of genomes on ``device``: each becomes
    ``len(workloads)`` value-only lanes of the bucketed sweep dispatch
    (one ``simulate_batch_varied`` per (machine-shape, walk-fn) bucket).

    Returns (per-genome ``(objectives, per_workload, mech)`` in input
    order, dispatch stats).  ``cache`` (genome-key -> stored eval) is
    consulted and updated in place; cached genomes never re-dispatch.
    ``checkpoint``/``watchdog_s`` pass straight to
    :func:`repro_torch.sim.run_bucketed` (crash-resume + hung-dispatch
    retry; both off by default).
    """
    cache = {} if cache is None else cache
    stats = {"points": 0, "buckets": 0, "runner_compiles": 0,
             "distinct_shapes": 0, "wall_s": 0.0, "per_bucket": [],
             "cache_hits": 0}
    fresh: List[Tuple] = []
    for g in genomes:
        if genome_key(space, g) in cache:
            stats["cache_hits"] += 1
        elif g not in fresh:
            fresh.append(g)

    if fresh:
        traces = _trace_table(space)
        jobs = []
        for g in fresh:
            mach = build_machine(space, g)
            mech = mech_for(space, g)
            jobs.extend(SimJob(mach, traces[wl], ("radix", mech))
                        for wl in space.workloads)
        outs, dstats = run_bucketed(jobs, chunk=space.chunk,
                                    devices=devices,
                                    checkpoint=checkpoint,
                                    watchdog_s=watchdog_s, device=device)
        for k in ("points", "buckets", "runner_compiles",
                  "distinct_shapes", "wall_s"):
            stats[k] = dstats[k]
        stats["per_bucket"] = dstats["per_bucket"]
        n_wl = len(space.workloads)
        for i, g in enumerate(fresh):
            mech = mech_for(space, g)
            obj, per_wl = _objectives_from_results(
                space, g, mech, outs[i * n_wl:(i + 1) * n_wl])
            cache[genome_key(space, g)] = {
                "objectives": obj, "per_workload": per_wl, "mech": mech}

    out = []
    for g in genomes:
        e = cache[genome_key(space, g)]
        out.append((dict(e["objectives"]), dict(e["per_workload"]),
                    e["mech"]))
    return out, stats


# ---------------------------------------------------------------------------
# the on-disk eval cache (per-generation / resume support)
# ---------------------------------------------------------------------------
def _engine_digest(space: SearchSpace) -> str:
    """Hash of everything the objective values depend on besides the
    genome: the engine's sources and kernels (``_sweep.ENGINE_SOURCES``,
    mechanisms.py among them, hashed WHOLESALE: a zoo space's
    ``zoo_mech`` knob can reach any registered spec) and the bucketing
    module, this module's version, the mechanism registry's candidate
    specs, and the fixture trace files themselves."""
    from repro_torch.sim import mechanisms as MS
    h = hashlib.sha256()
    h.update(str(_SEARCH_VERSION).encode())
    h.update(_sweep._engine_ckpt_digest().encode())
    with open(_sweep.__file__, "rb") as f:
        h.update(f.read())
    reachable = set(MECH_BY_STRUCT.values())
    for kn, values in space.knobs:
        if kn == "zoo_mech":
            reachable.update(str(v) for v in values if v != "ndpage")
    for name in ("radix",) + tuple(sorted(reachable)):
        s = MS.get(name)
        h.update(repr((s.name, s.n_pte, s.parallel, s.bypass_l1,
                       s.pwc_levels, s.huge, s.flattened, s.ideal,
                       s.cache_tlb, s.segment, s.colocate, s.org,
                       getattr(s.walk_fn, "__qualname__", None))).encode())
    for wl in space.workloads:
        if wl.startswith("trace:"):
            path = _abs_workload(wl)[len("trace:"):].partition("?")[0]
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _eval_cache_path(space: SearchSpace, device="cuda") -> str | None:
    from repro_torch.workloads import trace_cache_dir
    d = trace_cache_dir()
    if d is None:
        return None
    key_src = json.dumps({
        "knobs": [[n, list(v)] for n, v in space.knobs],
        "cores": space.cores, "workloads": list(space.workloads),
        "trace_len": space.trace_len, "chunk": space.chunk,
        "preset": dataclasses.asdict(PRESETS[space.preset]),
        "engine": _engine_digest(space),
        "device": str(device).split(":")[0],
    }, sort_keys=True, default=list)
    h = hashlib.sha256(key_src.encode()).hexdigest()[:20]
    return os.path.join(d, f"search_evals_{space.name}_{h}.json")


def _eval_cache_load(path: str | None) -> Dict:
    """Integrity-checked eval-cache load (sha256 sidecar, quarantine on
    corruption); a bad cache re-evaluates instead of crashing a resumed
    search."""
    if path is None:
        return {}
    data = resilience.read_json(path)
    if isinstance(data, dict):
        return data
    if data is not None:
        resilience.quarantine(path, "eval cache is not a dict")
    return {}


def _eval_cache_store(path: str | None, cache: Dict) -> None:
    if path is None:
        return
    # atomic + sidecar; filesystem failure degrades to cache-off
    resilience.write_json(path, cache)


# ---------------------------------------------------------------------------
# sampling / variation (all deterministic under the seeded Generator)
# ---------------------------------------------------------------------------
def _random_genome(rng: np.random.Generator, space: SearchSpace) -> Tuple:
    return tuple(values[rng.integers(len(values))]
                 for _, values in space.knobs)


def _sample_unique(rng: np.random.Generator, space: SearchSpace, n: int,
                   seen: set) -> List[Tuple]:
    out: List[Tuple] = []
    tries = 0
    limit = max(50 * n, 500)
    while len(out) < n and tries < limit:
        tries += 1
        g = _random_genome(rng, space)
        if g not in seen:
            seen.add(g)
            out.append(g)
    return out


def _mutate(rng: np.random.Generator, space: SearchSpace,
            parent: Tuple) -> Tuple:
    g = list(parent)
    n_flip = 1 + int(rng.random() < 0.3)
    for ki in rng.choice(len(space.knobs),
                         size=min(n_flip, len(space.knobs)),
                         replace=False):
        values = [v for v in space.knobs[ki][1] if v != g[ki]]
        if values:
            g[ki] = values[rng.integers(len(values))]
    return tuple(g)


def _crossover(rng: np.random.Generator, a: Tuple, b: Tuple) -> Tuple:
    return tuple(x if rng.random() < 0.5 else y for x, y in zip(a, b))


def _breed(rng: np.random.Generator, space: SearchSpace,
           parents: List[Tuple], n: int, seen: set
           ) -> List[Tuple[Tuple, str]]:
    """Up to ``n`` unseen offspring as (genome, origin) pairs."""
    out: List[Tuple[Tuple, str]] = []
    tries = 0
    limit = max(50 * n, 500)
    while len(out) < n and tries < limit:
        tries += 1
        if len(parents) >= 2 and rng.random() < 0.5:
            i, j = rng.choice(len(parents), size=2, replace=False)
            g, origin = _crossover(rng, parents[i], parents[j]), "crossover"
        else:
            g = _mutate(rng, space,
                        parents[rng.integers(len(parents))])
            origin = "mutation"
        if g not in seen:
            seen.add(g)
            out.append((g, origin))
    return out


# ---------------------------------------------------------------------------
# the search loop
# ---------------------------------------------------------------------------
def search(space: "SearchSpace | str" = "default", *,
           seed: int | None = None, use_cache: bool = True,
           devices: int | None = None,
           checkpoint: "bool | str | None" = None,
           watchdog_s: float | None = None, device="cuda") -> SearchResult:
    """Run the seeded design-space search (see module docstring) on
    ``device`` (the card by default).

    Deterministic: the same ``seed`` (default: the space's pinned seed)
    over the same space and engine produces a bit-identical frontier,
    with or without a warm eval cache.  A killed run resumes on two
    levels: the persisted eval cache skips whole finished generations,
    and ``checkpoint=True`` additionally restores any finished dispatch
    buckets of the generation that was in flight (see
    :func:`repro_torch.sim.run_bucketed`).
    """
    space = resolve_space(space)
    seed = space.seed if seed is None else seed
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    cache_path = _eval_cache_path(space, device) if use_cache else None
    cache = _eval_cache_load(cache_path)
    cache_hits0 = 0

    seen_genomes: set = set()
    by_key: "OrderedDict[str, Candidate]" = OrderedDict()
    totals = {"runner_compiles": 0, "dispatch_buckets": 0,
              "eval_cache_hits": 0, "lanes": 0}
    bucket_keys: set = set()

    def submit(batch: List[Tuple[Tuple, str]], gen: int) -> None:
        genomes = [g for g, _ in batch]
        evals, stats = evaluate_genomes(space, genomes, cache=cache,
                                        devices=devices,
                                        checkpoint=checkpoint,
                                        watchdog_s=watchdog_s, device=device)
        totals["runner_compiles"] += stats["runner_compiles"]
        totals["dispatch_buckets"] += stats["buckets"]
        totals["eval_cache_hits"] += stats["cache_hits"]
        totals["lanes"] += stats["points"]
        for b in stats["per_bucket"]:
            bucket_keys.add((b["shape"], tuple(b["walk_fns"])))
        for (g, origin), (obj, per_wl, mech) in zip(batch, evals):
            by_key[genome_key(space, g)] = Candidate(
                genome=genome_dict(space, g), mech=mech,
                objectives=obj, per_workload=per_wl,
                origin=origin, gen=gen)
        _eval_cache_store(cache_path, cache)   # per-generation flush

    # generation 0: the paper's design point + the random baseline
    paper = paper_genome(space)
    seen_genomes.add(paper)
    gen0 = [(paper, "paper")]
    gen0 += [(g, "random") for g in _sample_unique(
        rng, space, space.n_random, seen_genomes)]
    cache_hits0 = len(cache)
    submit(gen0, gen=0)

    # evolutionary Pareto loop: parents are the current frontier
    generations_run = 0
    for g in range(1, space.generations + 1):
        cands = list(by_key.values())
        front = pareto_indices([c.objectives for c in cands],
                               OBJECTIVES)
        parents = [tuple(cands[i].genome.values()) for i in front]
        if len(parents) < 2:
            best = max(cands, key=lambda c: c.objectives["mean_speedup"])
            bg = tuple(best.genome.values())
            if bg not in parents:
                parents.append(bg)
        offspring = _breed(rng, space, parents, space.offspring,
                           seen_genomes)
        # the frontier's mutation/crossover neighborhood can dry up in
        # late generations — top the generation up with fresh random
        # genomes so the evaluation budget is actually spent
        if len(offspring) < space.offspring:
            offspring += [(g, "random") for g in _sample_unique(
                rng, space, space.offspring - len(offspring),
                seen_genomes)]
        if not offspring:                # space exhausted
            break
        submit(offspring, gen=g)
        generations_run = g

    cands = list(by_key.values())
    front_idx = pareto_indices([c.objectives for c in cands], OBJECTIVES)
    frontier = sorted((cands[i] for i in front_idx),
                      key=_frontier_sort_key)

    paper_cand = by_key[genome_key(space, paper)]
    dominating = sorted(
        (c for c in cands
         if dominates(c.objectives, paper_cand.objectives, OBJECTIVES)),
        key=_frontier_sort_key)
    verdict = {
        "dominates_paper": bool(dominating),
        "paper_objectives": {k: round(v, 6) for k, v in
                             paper_cand.objectives.items()},
        "paper_on_frontier": any(c is paper_cand for c in frontier),
        "dominating_points": [c.to_json_dict() for c in dominating[:5]],
        "n_dominating": len(dominating),
    }
    provenance = {
        "seed": seed,
        "generations": generations_run,
        "population": space.population,
        "n_random": space.n_random,
        "offspring_per_gen": space.offspring,
        "evaluated": len(cands),
        "lanes_dispatched": totals["lanes"],
        "runner_compiles": totals["runner_compiles"],
        "dispatch_buckets": totals["dispatch_buckets"],
        "distinct_buckets": len(bucket_keys),
        "eval_cache_hits": totals["eval_cache_hits"],
        "eval_cache_warm_start": cache_hits0,
        "trace_len": space.trace_len,
        "chunk": space.chunk,
        "workloads": list(space.workloads),
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    return SearchResult(space=space, objectives=OBJECTIVES,
                        candidates=cands, frontier=frontier,
                        paper=paper_cand, verdict=verdict,
                        provenance=provenance)


# ---------------------------------------------------------------------------
# json merge + CLI
# ---------------------------------------------------------------------------
def merge_search_section(section: Dict, path: str) -> None:
    """Attach ``section`` under the ``"search"`` key of the json file at
    ``path`` without clobbering the other sections already there."""
    data: Dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"# WARNING: could not read existing {path} ({e}); "
                  "rewriting it with the search section only",
                  file=sys.stderr)
    data["search"] = section
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the standard seeded search (space 'default': "
                         ">= 200 candidates, <= 10 generations)")
    ap.add_argument("--quick", action="store_true",
                    help="1-generation smoke (space 'quick')")
    ap.add_argument("--space", default=None,
                    help="explicit space name (overrides --smoke/--quick)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the space's pinned seed")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore the on-disk eval cache")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="json file to merge the 'search' section into "
                         "(none by default)")
    args = ap.parse_args(argv)
    name = args.space or ("quick" if args.quick else "default")

    result = search(name, seed=args.seed, use_cache=not args.no_cache,
                    device=args.device)
    p = result.provenance
    print(f"search space={name} seed={p['seed']} device={args.device} "
          f"evaluated={p['evaluated']}/{result.space.size()} "
          f"gens={p['generations']} compiles={p['runner_compiles']} "
          f"buckets={p['distinct_buckets']} wall={p['wall_s']}s")
    print("frontier (mean_speedup / sram_kb / worst_ptw):")
    for c in result.frontier:
        o = c.objectives
        print(f"  {o['mean_speedup']:.4f} / {o['sram_kb']:.2f}KB / "
              f"{o['worst_ptw']:.1f}cyc  {c.mech:<22} "
              f"{dict(c.genome)}")
    v = result.verdict
    print(f"paper config {v['paper_objectives']} -> "
          + ("DOMINATED by "
             f"{v['n_dominating']} discovered point(s)"
             if v["dominates_paper"] else
             "not dominated by any discovered point"))
    if args.out:
        merge_search_section(result.to_json_dict(), args.out)
        print(f"# merged 'search' section into {args.out}")
    return 0 if result.frontier else 1


if __name__ == "__main__":               # pragma: no cover
    sys.exit(_main())
