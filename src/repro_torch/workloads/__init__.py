"""Workload axis of the simulator: the Table-II synthetic generators, and
the ONE parser every consumer resolves a workload-axis value through
(:func:`parse_workload_spec`).  Real-trace ingest (``"trace:<path>"``
specs) is not ported yet (ROADMAP module item 2) and raises."""
import dataclasses
from typing import Dict

from repro_torch.workloads.generators import (TRACE_PATTERNS,  # noqa: F401
                                              generate_trace,
                                              generate_traces,
                                              trace_cache_dir)

_TRACE_PREFIX = "trace:"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A parsed workload-axis value: ``kind`` is ``"named"`` (a Table-II
    generator; ``name`` indexes ``configs.ndp_sim.WORKLOADS``).  The
    ``"trace"`` kind of the JAX package comes with the ingest layer."""

    kind: str
    name: str
    opts: Dict = dataclasses.field(default_factory=dict)

    def canonical(self) -> str:
        """Back to the string form."""
        return self.name


def parse_workload_spec(workload: str) -> WorkloadSpec:
    """Parse/validate a workload-axis value.  A name of a Table-II
    generator gives a ``"named"`` spec; anything else raises ``KeyError``
    listing the known names.  A ``"trace:<path>"`` spec raises
    ``NotImplementedError``: real-trace ingest is ROADMAP module item 2."""
    if isinstance(workload, str) and workload.startswith(_TRACE_PREFIX):
        raise NotImplementedError(
            f"{workload!r}: real-trace ingest ('trace:<path>' specs) is not "
            "ported to repro_torch yet (ROADMAP module item 2)")
    from repro_torch.configs.ndp_sim import WORKLOADS
    if workload not in WORKLOADS:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(WORKLOADS)} (or a 'trace:<path>' spec)")
    return WorkloadSpec("named", str(workload))
