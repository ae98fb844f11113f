"""Workload axis of the simulator: the Table-II synthetic generators plus
real-trace ingest, and the ONE parser every consumer resolves a
workload-axis value through (:func:`parse_workload_spec`)."""
import dataclasses
from typing import Dict

from repro_torch.workloads.generators import (TRACE_PATTERNS,  # noqa: F401
                                              generate_trace,
                                              generate_traces,
                                              trace_cache_dir)
from repro_torch.workloads.ingest import (TraceFormatError,  # noqa: F401
                                          ingest_trace, is_trace_spec,
                                          parse_trace_spec)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A parsed workload-axis value.

    ``kind`` is ``"named"`` (a Table-II generator; ``name`` indexes
    ``configs.ndp_sim.WORKLOADS``) or ``"trace"`` (``name`` is the trace
    file path, ``opts`` the validated ingest options).
    """

    kind: str
    name: str
    opts: Dict = dataclasses.field(default_factory=dict)

    def with_path(self, path: str) -> "WorkloadSpec":
        """Same spec, different trace path (path absolutization)."""
        assert self.kind == "trace", self
        return dataclasses.replace(self, name=path)

    def canonical(self) -> str:
        """Back to the string form (``"name"`` / ``"trace:<path>?..."``),
        options in parse order."""
        if self.kind == "named":
            return self.name
        query = "&".join(f"{k}={v}" for k, v in self.opts.items())
        return f"trace:{self.name}" + (f"?{query}" if query else "")


def parse_workload_spec(workload: str) -> WorkloadSpec:
    """Parse/validate a workload-axis value.

    ``"trace:<path>[?opt=val&...]"`` is a real-trace ingest spec; unknown
    or malformed query options raise ``ValueError``
    (:func:`repro_torch.workloads.ingest.parse_trace_spec`).  Anything
    else must name a Table-II generator or it raises ``KeyError`` listing
    the known names.
    """
    if is_trace_spec(workload):
        path, opts = parse_trace_spec(workload)
        return WorkloadSpec("trace", path, opts)
    from repro_torch.configs.ndp_sim import WORKLOADS
    if workload not in WORKLOADS:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(WORKLOADS)} (or a 'trace:<path>' spec)")
    return WorkloadSpec("named", str(workload))
