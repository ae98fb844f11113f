"""Declarative mechanism specs for the NDP translation simulator.

The port's copy of ``repro.sim.mechanisms``.  Every address-translation
mechanism is ONE :class:`MechanismSpec` describing its static structure:
the PTE accesses of a walk and whether they issue serially or in
parallel, whether PTE fills bypass the cache hierarchy (NDPage), which
walk levels have a page-walk cache, whether it maps 2MB pages, and the
function mapping VPNs to the PTE line ids its walk touches
(:mod:`repro_torch.core.page_table`, torch ops).

:data:`DEFAULT_MECHS` pins the paper's five mechanisms;
``simulate(..., mechs=(...))`` opts into any registered subset.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import page_table as PT

# Upper bound on PTE accesses per walk across all registered mechanisms;
# walk-line arrays are padded to this width.
MAX_PTE = 4


@dataclasses.dataclass(frozen=True)
class MechanismSpec:
    """Static structure of one address-translation mechanism."""

    name: str
    #: PTE accesses per walk (0 = no translation at all, i.e. ideal)
    n_pte: int
    #: probes issue simultaneously; walk latency is max() of the probes
    #: plus a fixed issue/conflict overhead (ECH cuckoo probing)
    parallel: bool = False
    #: PTE accesses skip the cache hierarchy and go straight to memory
    bypass_l1: bool = False
    #: page-walk cache present per walk level (index 0 = top level)
    pwc_levels: Tuple[bool, ...] = (False,) * MAX_PTE
    #: 2MB mappings: scaled TLB keys, 4KB-fallback fragmentation model and
    #: amortized promotion/fault stall
    huge: bool = False
    #: the walk's bottom reads ONE flattened (merged) node
    flattened: bool = False
    #: translation is free (no TLB, no walk) — the paper's upper bound
    ideal: bool = False
    #: probes a cache-as-TLB level (Victima) after an L2-TLB miss, on a
    #: machine with ``ctlb_kb > 0``
    cache_tlb: bool = False
    #: direct-segment fast path (Picorel): the non-fragmented share of
    #: the footprint translates by base/limit registers
    segment: bool = False
    #: co-location-aware placement (CODA): dodges most of the remote-
    #: stack hop on ``num_stacks > 1`` machines
    colocate: bool = False
    #: serving cost-model organization override ("segment"/"inverted")
    org: Optional[str] = None
    #: VPN -> (T, n_pte) PTE line ids; None only when n_pte == 0
    walk_fn: Optional[Callable] = None
    description: str = ""

    def __post_init__(self):
        if not 0 <= self.n_pte <= MAX_PTE:
            raise ValueError(f"{self.name}: n_pte must be in [0, {MAX_PTE}]")
        if len(self.pwc_levels) != MAX_PTE:
            raise ValueError(f"{self.name}: pwc_levels must have {MAX_PTE} "
                             "entries (pad with False)")
        if self.n_pte > 0 and self.walk_fn is None:
            raise ValueError(f"{self.name}: walking mechanisms need walk_fn")
        if any(self.pwc_levels[self.n_pte:]):
            raise ValueError(f"{self.name}: PWC beyond walk depth")
        if self.huge and self.segment:
            raise ValueError(f"{self.name}: huge and segment both claim "
                             "the fragmentation mask — pick one")
        if self.org not in (None, "flat", "radix", "segment", "inverted",
                            "none"):
            raise ValueError(f"{self.name}: unknown org {self.org!r}")


@dataclasses.dataclass(frozen=True)
class MechTables:
    """The spec registry lowered to numpy tables with a leading M axis."""

    names: Tuple[str, ...]
    n_pte: np.ndarray        # (M,)   int32
    parallel: np.ndarray     # (M,)   bool
    bypass: np.ndarray       # (M,)   bool
    pwc_on: np.ndarray       # (M, MAX_PTE) bool
    huge: np.ndarray         # (M,)   bool
    ideal: np.ndarray        # (M,)   bool
    cache_tlb: np.ndarray    # (M,)   bool
    segment: np.ndarray      # (M,)   bool
    colocate: np.ndarray     # (M,)   bool

    @property
    def num_mechs(self) -> int:
        return len(self.names)


_REGISTRY: Dict[str, MechanismSpec] = {}
#: callbacks run on every (re-)registration, so caches built from the
#: old spec can drop it
_INVALIDATE_HOOKS = []


def on_register(hook) -> None:
    _INVALIDATE_HOOKS.append(hook)


def _validate_walk_fn(spec: MechanismSpec) -> None:
    """Reject a walk fn whose output width disagrees with ``n_pte``, and
    a DIFFERENT function sharing another mechanism's ``__qualname__``
    (bucketing keys on qualnames; sharing one function object is fine)."""
    if spec.walk_fn is None:
        return
    qn = getattr(spec.walk_fn, "__qualname__", repr(spec.walk_fn))
    for other in _REGISTRY.values():
        if other.name == spec.name or other.walk_fn is None:
            continue
        oqn = getattr(other.walk_fn, "__qualname__", repr(other.walk_fn))
        if other.walk_fn is not spec.walk_fn and oqn == qn:
            raise ValueError(
                f"{spec.name}: walk_fn __qualname__ {qn!r} collides with "
                f"mechanism {other.name!r}'s distinct walk fn — rename "
                "the function (or share the same function object)")
    probe = spec.walk_fn(torch.zeros(2, dtype=torch.int32))
    if tuple(probe.shape) != (2, spec.n_pte):
        raise ValueError(
            f"{spec.name}: walk_fn returns shape {tuple(probe.shape)} for "
            f"a (2,) vpn tensor but n_pte={spec.n_pte} expects "
            f"(2, {spec.n_pte})")


def register(spec: MechanismSpec, *, overwrite: bool = False) -> MechanismSpec:
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"mechanism {spec.name!r} already registered")
    _validate_walk_fn(spec)
    _REGISTRY[spec.name] = spec
    tables_for.cache_clear()
    for hook in _INVALIDATE_HOOKS:
        hook()
    return spec


def get(name: str) -> MechanismSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown mechanism {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def specs_for(names: Tuple[str, ...]) -> Tuple[MechanismSpec, ...]:
    return tuple(get(n) for n in names)


@functools.lru_cache(maxsize=None)
def tables_for(names: Tuple[str, ...]) -> MechTables:
    specs = specs_for(names)
    return MechTables(
        names=tuple(s.name for s in specs),
        n_pte=np.array([s.n_pte for s in specs], np.int32),
        parallel=np.array([s.parallel for s in specs], bool),
        bypass=np.array([s.bypass_l1 for s in specs], bool),
        pwc_on=np.array([s.pwc_levels for s in specs], bool),
        huge=np.array([s.huge for s in specs], bool),
        ideal=np.array([s.ideal for s in specs], bool),
        cache_tlb=np.array([s.cache_tlb for s in specs], bool),
        segment=np.array([s.segment for s in specs], bool),
        colocate=np.array([s.colocate for s in specs], bool),
    )


# ---------------------------------------------------------------------------
# the paper's five mechanisms (Table I / Figs 12-14)
# ---------------------------------------------------------------------------
register(MechanismSpec(
    name="radix", n_pte=4, pwc_levels=(True, True, True, True),
    walk_fn=PT.radix4_walk_lines,
    description="x86-64 4-level radix table; serial pointer chase, "
                "per-level PWCs, PTE fills pollute the caches"))

register(MechanismSpec(
    name="ech", n_pte=2, parallel=True,
    walk_fn=PT.ech_probe_lines,
    description="Elastic Cuckoo Hash table (Skarlatos et al.): d=2 hashed "
                "probes issued in parallel, no PWCs; multi-core allocation "
                "pressure triggers upsizing/rehash churn"))

register(MechanismSpec(
    name="hugepage", n_pte=3, pwc_levels=(True, True, True, False),
    huge=True, walk_fn=PT.hugepage_walk_lines,
    description="2MB pages: 3-level walk and 512x TLB reach, but "
                "fragmentation forces 4KB fallbacks and promotion/fault "
                "stalls grow with allocating cores"))

register(MechanismSpec(
    name="ndpage", n_pte=3, bypass_l1=True, flattened=True,
    pwc_levels=(True, True, False, False),
    walk_fn=PT.ndpage_walk_lines,
    description="NDPage: flattened L2/L1 node (one access), PTE accesses "
                "bypass the NDP L1, PWCs only on the near-ideal L4/L3"))

register(MechanismSpec(
    name="ideal", n_pte=0, ideal=True,
    description="no translation at all — upper bound"))

register(MechanismSpec(
    name="ndpage_pl3", n_pte=2, bypass_l1=True, flattened=True,
    pwc_levels=(True, False, False, False),
    walk_fn=PT.ndpage_pl3_walk_lines,
    description="flattened-PL3 NDPage variant: L4 + one merged L3/L2/L1 "
                "access, PTEs bypass L1"))

register(MechanismSpec(
    name="ndpage_nobyp", n_pte=3, bypass_l1=False, flattened=True,
    pwc_levels=(True, True, False, False),
    walk_fn=PT.ndpage_walk_lines,
    description="NDPage with L1 bypass DISABLED (sensitivity ablation): "
                "flattened walk kept, but PTE fills compete for the tiny "
                "NDP L1 — degrades toward radix"))

# design-space search structural variants: (flatten level, L1-bypass,
# huge-page mapping), sharing walk FUNCTIONS per flatten level
register(MechanismSpec(
    name="ndpage_pl3_nobyp", n_pte=2, bypass_l1=False, flattened=True,
    pwc_levels=(True, False, False, False),
    walk_fn=PT.ndpage_pl3_walk_lines,
    description="search variant: flattened-PL3 walk with the L1 bypass "
                "DISABLED — PTE fills compete for the NDP L1"))

register(MechanismSpec(
    name="ndpage_hp", n_pte=3, bypass_l1=True, flattened=True,
    pwc_levels=(True, True, False, False), huge=True,
    walk_fn=PT.ndpage_walk_lines,
    description="search variant: NDPage (flattened PL2/PL1, L1 bypass) "
                "mapping 2MB huge pages — TLB reach vs fragmentation/"
                "promotion stalls"))

register(MechanismSpec(
    name="ndpage_nobyp_hp", n_pte=3, bypass_l1=False, flattened=True,
    pwc_levels=(True, True, False, False), huge=True,
    walk_fn=PT.ndpage_walk_lines,
    description="search variant: flattened PL2/PL1 walk, cached PTE "
                "fills, 2MB huge pages"))

register(MechanismSpec(
    name="ndpage_pl3_hp", n_pte=2, bypass_l1=True, flattened=True,
    pwc_levels=(True, False, False, False), huge=True,
    walk_fn=PT.ndpage_pl3_walk_lines,
    description="search variant: flattened-PL3 walk, L1 bypass, 2MB "
                "huge pages"))

register(MechanismSpec(
    name="ndpage_pl3_nobyp_hp", n_pte=2, bypass_l1=False, flattened=True,
    pwc_levels=(True, False, False, False), huge=True,
    walk_fn=PT.ndpage_pl3_walk_lines,
    description="search variant: flattened-PL3 walk, cached PTE fills, "
                "2MB huge pages"))

# the design-space search's winning configuration (space "default", seed
# 20250808): structurally identical to ndpage_pl3, named separately
register(MechanismSpec(
    name="ndpage_search", n_pte=2, bypass_l1=True, flattened=True,
    pwc_levels=(True, False, False, False),
    walk_fn=PT.ndpage_pl3_walk_lines,
    description="search winner (space 'default', seed 20250808): "
                "paper geometry + flattened-PL3 walk; dominates the "
                "paper's NDPage config on speedup/SRAM/worst-PTW"))

# ---------------------------------------------------------------------------
# the related-work mechanism zoo
# ---------------------------------------------------------------------------
register(MechanismSpec(
    name="victima", n_pte=4, pwc_levels=(True, True, True, True),
    cache_tlb=True, walk_fn=PT.radix4_walk_lines,
    description="Victima (Kanellopoulos et al., 2310.04158): L2-cache "
                "lines repurposed as a second large set-associative TLB "
                "level probed after an L2-TLB miss; geometry derives "
                "from the repurposed capacity (ctlb_kb = the demotion/"
                "promotion occupancy knob), x86 radix walk underneath"))

register(MechanismSpec(
    name="picorel", n_pte=1, bypass_l1=True, segment=True,
    org="inverted", walk_fn=PT.inverted_hash_lines,
    description="Picorel et al. (1612.00445) near-memory translation: "
                "direct-segment fast path for the contiguous footprint, "
                "one set-associative inverted-hash bucket access for "
                "the fragmentation-broken rest — no radix levels at all"))

register(MechanismSpec(
    name="coda", n_pte=4, pwc_levels=(True, True, True, True),
    colocate=True, walk_fn=PT.radix4_walk_lines,
    description="CODA-style co-location-aware mapping: stock radix "
                "hardware, but vpn->frame placement biases PTEs and "
                "data into the LOCAL NDP stack, dodging the remote-"
                "stack hop penalty on multi-stack machines"))

register(MechanismSpec(
    name="range_table", n_pte=4, pwc_levels=(True, True, False, False),
    org="segment", walk_fn=PT.range_walk_lines,
    description="range/segment-table translation (binary-search "
                "AddrTrans idiom): log2(ranges) probes over sorted "
                "range descriptors; the early probes stay cached, so "
                "miss cost scales with extent fragmentation, not depth"))

#: the four related-work designs, in zoo-report order
ZOO_MECHS: Tuple[str, ...] = ("victima", "picorel", "coda", "range_table")

#: the paper's evaluation set, in figure order — the simulator default
DEFAULT_MECHS: Tuple[str, ...] = ("radix", "ech", "hugepage", "ndpage",
                                  "ideal")
