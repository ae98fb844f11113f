"""Real-trace ingestion: ChampSim / Valgrind lackey / CSV -> simulator
traces.

The port's copy of ``repro.workloads.ingest`` (plain numpy, as there).
The synthetic Table-II generators model the paper's workloads
statistically; this package replays the real thing.  Any supported
trace format streams into the exact ``{"vpn", "off", "work", "pages"}``
dict :func:`repro_torch.sim.simulate` and the batch engine consume, so
real traces flow through every engine path with no simulator changes.
The dispatch point is :func:`repro_torch.workloads.generate_trace`: a
workload name of the form ``"trace:<path>[?opt=val&...]"`` routes here
instead of the generators, which is what makes a ``simulate_batch``
lane, or a ``--workloads`` entry of ``python -m
repro_torch.launch.simulate``, over a real trace just work.

Pipeline
--------
1. **Parse** — the format parser (``champsim`` fixed 64-byte binary
   records, ``lackey`` text, ``csv`` text; auto-detected from the file
   name, ``.xz``/``.gz`` decompressed transparently) streams blocks of
   ``(addr, work[, tid])``: byte addresses plus the non-memory
   instruction count preceding each access.
2. **Interleave** — the single stream is split into ``num_cores``
   per-core streams: ``round_robin`` (access i -> core i mod C, the
   default — preserves per-core temporal structure of a multiprogrammed
   replay), ``blocked`` (contiguous C-way split), or ``thread`` (a csv
   ``tid`` column maps threads onto cores).  ``length`` clamps every
   core's stream (parsing stops early once enough accesses are read,
   except ``thread`` mode which must see the whole file).
3. **Page split + remap** — addresses split into ``(vpn, line-offset)``
   at a configurable ``page_bytes`` (default 4KB, the simulator's
   native page).  Sparse 64-bit vpns are compacted by a gap-capped
   monotone remap: page ordering and intra-region adjacency (deltas up
   to ``gap_cap`` pages, default one 2MB region) are preserved exactly
   — so leaf-PTE-line sharing, huge-page regions, and upper-level
   walk-line locality survive — while address-space gaps collapse to
   ``gap_cap``, keeping vpns int32-safe for the engine.
4. **Cache** — results memoize through the same integrity-checked npz
   layer as the generators (the port's own subdirectory of
   ``.trace_cache``), keyed as the JAX package keys them: (file sha256,
   parser, every pipeline option, ingest version), so touching the
   trace file or any option can never serve a stale cached trace.

The engine takes vpns below 2^25 (``sim.simulator.MAX_VPN``): a trace
whose remapped footprint is larger is refused there; a lower
``gap_cap`` shrinks it.

``python -m repro_torch.workloads.ingest <trace>`` (``__main__``) is the
command line over this layer, the JAX package's
``scripts/convert_trace.py``: the trace's characterization, and its
``.npz``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.workloads.ingest import champsim, lackey, textcsv
from repro_torch.workloads.ingest.io import (TraceFormatError,  # noqa: F401
                                       file_sha256, open_stream)

#: bump on any behavior change so stale .trace_cache entries are never
#: served; the JAX package's value, so the two packages key alike
_INGEST_VERSION = 1

PARSERS = {
    "champsim": champsim.parse_blocks,
    "lackey": lackey.parse_blocks,
    "csv": textcsv.parse_blocks,
}

INTERLEAVES = ("round_robin", "blocked", "thread")

#: one 2MB huge-page region, in 4KB pages — the default gap cap keeps
#: distinct allocation regions in distinct huge regions after remap
DEFAULT_GAP_CAP = 512
DEFAULT_WORK_CLIP = 64


def detect_format(path: str) -> str:
    """Infer the parser from the file name (compression suffixes are
    ignored): ``*.champsim*``/``*.trace*`` -> champsim, ``*lackey*`` ->
    lackey, ``*.csv``/``*.txt``/``*.mem`` -> csv."""
    name = os.path.basename(path).lower()
    for suffix in (".xz", ".gz"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    if ".champsim" in name or name.endswith(".trace"):
        return "champsim"
    if "lackey" in name:
        return "lackey"
    if name.endswith((".csv", ".txt", ".mem")):
        return "csv"
    raise TraceFormatError(
        f"cannot infer trace format from {path!r}; pass fmt= "
        f"(one of {sorted(PARSERS)})")


# ---------------------------------------------------------------------------
# trace:<path>?opt=val workload specs
# ---------------------------------------------------------------------------
_SPEC_PREFIX = "trace:"
_SPEC_OPTS = {"fmt": str, "interleave": str, "page_bytes": int,
              "work_clip": int, "gap_cap": int}


def is_trace_spec(workload) -> bool:
    """True for ``"trace:<path>"`` workload-axis values."""
    return isinstance(workload, str) and workload.startswith(_SPEC_PREFIX)


def parse_trace_spec(spec: str) -> Tuple[str, Dict]:
    """``"trace:<path>[?opt=val&opt=val]"`` -> (path, option dict).

    Options mirror :func:`ingest_trace` keywords: ``fmt``,
    ``interleave``, ``page_bytes``, ``work_clip``, ``gap_cap``.
    """
    if not is_trace_spec(spec):
        raise ValueError(f"not a trace spec: {spec!r}")
    rest = spec[len(_SPEC_PREFIX):]
    path, _, query = rest.partition("?")
    if not path:
        raise ValueError(f"trace spec {spec!r} has an empty path")
    opts: Dict = {}
    if query:
        for item in query.split("&"):
            key, sep, value = item.partition("=")
            if not sep or key not in _SPEC_OPTS:
                raise ValueError(
                    f"trace spec {spec!r}: bad option {item!r} "
                    f"(known: {sorted(_SPEC_OPTS)})")
            opts[key] = _SPEC_OPTS[key](value)
    return path, opts


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------
def _interleave(addr: np.ndarray, work: np.ndarray,
                tid: Optional[np.ndarray], num_cores: int, mode: str,
                path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One stream -> (num_cores, n) per-core addr/work arrays."""
    total = addr.size
    if mode == "round_robin":
        n = total // num_cores
        if n == 0:
            raise TraceFormatError(
                f"{path}: only {total} accesses — too short for "
                f"{num_cores} cores")
        a = addr[: n * num_cores].reshape(n, num_cores).T
        w = work[: n * num_cores].reshape(n, num_cores).T
        return a, w
    if mode == "blocked":
        n = total // num_cores
        if n == 0:
            raise TraceFormatError(
                f"{path}: only {total} accesses — too short for "
                f"{num_cores} cores")
        return (addr[: n * num_cores].reshape(num_cores, n),
                work[: n * num_cores].reshape(num_cores, n))
    if mode == "thread":
        if tid is None:
            raise TraceFormatError(
                f"{path}: interleave='thread' needs a tid column "
                "(csv format only)")
        uniq, first = np.unique(tid, return_index=True)
        order = uniq[np.argsort(first)]        # thread appearance order
        streams = []
        for c in range(num_cores):
            mask = np.isin(tid, order[c::num_cores])
            streams.append((addr[mask], work[mask]))
        n = min(s[0].size for s in streams)
        if n == 0:
            raise TraceFormatError(
                f"{path}: {order.size} threads cannot fill "
                f"{num_cores} cores")
        return (np.stack([s[0][:n] for s in streams]),
                np.stack([s[1][:n] for s in streams]))
    raise ValueError(f"unknown interleave {mode!r}; "
                     f"known: {INTERLEAVES}")


def _compact_vpns(vpn64: np.ndarray, gap_cap: int,
                  path: str) -> Tuple[np.ndarray, int]:
    """Gap-capped monotone vpn remap (see module docstring)."""
    flat = vpn64.ravel()
    uniq = np.unique(flat)
    new = np.zeros(uniq.size, np.int64)
    if uniq.size > 1:
        np.cumsum(np.minimum(np.diff(uniq), gap_cap), out=new[1:])
    pages = int(new[-1]) + 1
    if pages >= 1 << 31:
        raise TraceFormatError(
            f"{path}: {pages} pages after remap overflow int32 — "
            f"lower gap_cap (now {gap_cap})")
    remapped = new[np.searchsorted(uniq, flat)].reshape(vpn64.shape)
    return remapped, pages


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def ingest_trace(path: str, num_cores: int, *,
                 length: Optional[int] = None,
                 fmt: Optional[str] = None,
                 interleave: str = "round_robin",
                 page_bytes: int = 4096,
                 work_clip: int = DEFAULT_WORK_CLIP,
                 gap_cap: int = DEFAULT_GAP_CAP,
                 use_cache: bool = True) -> Dict[str, np.ndarray]:
    """Parse a real memory trace into a simulator trace dict.

    Returns ``{"vpn", "off", "work"}`` int32 arrays of shape
    ``(num_cores, n)`` plus the remapped footprint ``"pages"`` — the
    same contract as :func:`repro_torch.workloads.generate_trace`.

    ``length`` clamps each core's stream (``n <= length``); a shorter
    file yields fewer accesses, which the engines handle via their
    per-lane valid masks.  ``page_bytes`` (power of two, >= 128) sets
    the vpn/offset split — the simulator's timing model natively
    assumes 4KB pages; other sizes are for trace analysis.
    ``work_clip`` bounds per-access
    work so one huge compute gap cannot dominate the window.
    ``use_cache=False`` bypasses the on-disk ``.trace_cache`` layer.
    """
    if num_cores < 1:
        raise ValueError(f"num_cores must be >= 1, got {num_cores}")
    if page_bytes < 128 or page_bytes & (page_bytes - 1):
        raise ValueError(
            f"page_bytes must be a power of two >= 128, got {page_bytes}")
    if gap_cap < 1:
        raise ValueError(f"gap_cap must be >= 1, got {gap_cap} "
                         "(0 would collapse every page to vpn 0)")
    if work_clip < 0:
        raise ValueError(f"work_clip must be >= 0, got {work_clip}")
    if interleave not in INTERLEAVES:
        raise ValueError(f"unknown interleave {interleave!r}; "
                         f"known: {INTERLEAVES}")
    fmt = fmt or detect_format(path)
    if fmt not in PARSERS:
        raise TraceFormatError(f"unknown trace format {fmt!r}; "
                               f"known: {sorted(PARSERS)}")

    from repro_torch.workloads import generators as G
    cache_path = None
    if use_cache and G.trace_cache_dir() is not None:
        key = (f"ingest_{file_sha256(path)[:20]}_{fmt}_c{num_cores}"
               f"_n{length}_i{interleave}_p{page_bytes}_w{work_clip}"
               f"_g{gap_cap}_v{_INGEST_VERSION}")
        cache_path = os.path.join(G.trace_cache_dir(), key + ".npz")
        cached = G._cache_load(cache_path)
        if cached is not None:
            return cached

    # stream the parser; stop early once the clamp window is full
    # (thread mode must see the whole file — tids interleave arbitrarily)
    cap = (length * num_cores
           if length is not None and interleave != "thread" else None)
    addr_bl, work_bl, tid_bl = [], [], []
    total = 0
    tid_seen = None
    for addr, work, tid in PARSERS[fmt](path):
        addr_bl.append(addr)
        work_bl.append(work)
        if tid_seen is None:
            tid_seen = tid is not None
        if tid_seen:
            tid_bl.append(tid)
        total += addr.size
        if cap is not None and total >= cap:
            break
    if total == 0:
        raise TraceFormatError(f"{path}: trace contains no memory "
                               f"accesses (format {fmt!r})")
    addr = np.concatenate(addr_bl)
    work = np.clip(np.concatenate(work_bl), 0, work_clip)
    tid = np.concatenate(tid_bl) if tid_bl else None
    if cap is not None:
        addr, work = addr[:cap], work[:cap]

    a, w = _interleave(addr, work, tid, num_cores, interleave, path)
    if length is not None:
        a, w = a[:, :length], w[:, :length]

    shift = page_bytes.bit_length() - 1
    vpn, pages = _compact_vpns(a >> shift, gap_cap, path)
    off = (a & (page_bytes - 1)) >> 6
    trace = {"vpn": vpn.astype(np.int32), "off": off.astype(np.int32),
             "work": w.astype(np.int32), "pages": pages}
    G._cache_store(cache_path, trace)
    return trace
