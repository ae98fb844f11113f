"""Synthetic memory-trace generators for the Table-II workloads.

The port's copy of ``repro.workloads.generators`` (plain numpy, as
there).  Each generator emits, for ALL cores at once, a stream of (vpn,
line_offset, work): ``vpn`` is the 4KB virtual page, ``line_offset`` the
64B line within it and ``work`` the non-memory instructions preceding
the access.  The statistical structure is modelled on the published
characterizations of the suites:

  GUPS (rnd)        uniform random updates over the whole table
  GraphBIG (bc,cc,  power-law vertex access mixed with short sequential
   gc,tc)           runs over CSR arrays
  bfs / sp          frontier bursts: sequential frontier scan + random
                    neighbour expansion
  pr (sweep)        sequential property sweep + random edge endpoints
  XSBench (xs)      random nuclide/grid lookups with binary-search ladders
  DLRM (dlrm)       embedding-bag bursts of random rows + a dense
                    sequential MLP segment
  GenomicsBench     k-mer hash probes: uniform probes + 2-line runs
   (gen)

Footprints follow Table II unscaled.  Every generator produces
``(num_cores, length)`` arrays from one numpy RNG seeded with a stable
hash of the workload name (``zlib.crc32``), so traces are bit-identical
across processes and to the JAX package's.  Generated traces are
memoized on disk under the JAX package's key, in a ``repro_torch/``
subdirectory of its cache (``.trace_cache/`` at the repo root;
``SIM_TRACE_CACHE=<dir>`` overrides the root, ``=0`` disables it), so
the port never reads a trace the reference wrote nor writes one the
reference reads.  Entries go through the integrity-checked store of
:mod:`repro_torch.util.resilience`.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.util import resilience

FOOTPRINT_SCALE = 1.0
PAGE_LINES = 64  # 4KB / 64B

#: bump on any change to the generators so stale .trace_cache entries are
#: never served
_CACHE_VERSION = 2
#: the port's own subdirectory of the trace cache
CACHE_SUBDIR = "repro_torch"


def _pages(footprint_gb: float) -> int:
    return max(1 << 14, int(footprint_gb * FOOTPRINT_SCALE * (1 << 18)))


def _stable_hash(s: str) -> int:
    """Process-stable workload hash (crc32), unlike builtin ``hash``."""
    return zlib.crc32(s.encode("utf-8"))


def _hot_lines(rng, shape, pages: int, alpha: float) -> np.ndarray:
    """Power-law LINE accesses: hot vertices reuse their exact lines, and
    hot ids are CONTIGUOUS (degree-renumbered vertex arrays) — so hot pages
    and their leaf PTEs exhibit the cacheable locality real graph codes
    show on CPU-class cache hierarchies."""
    total = pages * PAGE_LINES
    u = rng.random(shape)
    x = np.floor(total * u ** alpha).astype(np.int64)
    return np.minimum(x, total - 1)


def _runs(rng, cores: int, n: int, pages: int, run_len: int,
          rep: int = 6) -> np.ndarray:
    """Sequential runs: each 64B line is touched ``rep`` times in a row
    (word-granular streaming over arrays) for ~run_len distinct lines."""
    n_lines = max(1, n // (run_len * rep)) * run_len
    starts = rng.integers(0, pages,
                          (cores, max(1, n_lines // run_len))) * PAGE_LINES
    offs = np.arange(run_len)
    lines = (starts[..., None] + offs[None, None, :]).reshape(cores, -1)
    lines = np.repeat(lines, rep, axis=1)[:, :n]
    if lines.shape[1] < n:
        lines = np.pad(lines, ((0, 0), (0, n - lines.shape[1])), mode="wrap")
    return lines % (pages * PAGE_LINES)


def _mix_streams(rng, parts, weights, n: int) -> np.ndarray:
    """Interleave line-granular streams according to weights, consuming
    each stream IN ORDER per core (preserves runs / repetition structure)."""
    cores = parts[0].shape[0]
    choice = rng.choice(len(parts), size=(cores, n),
                        p=np.asarray(weights) / np.sum(weights))
    out = np.empty((cores, n), np.int64)
    for i, p in enumerate(parts):
        mask = choice == i
        # position within stream i = running count of stream-i picks
        take = (np.cumsum(mask, axis=1) - 1) % p.shape[1]
        vals = np.take_along_axis(np.ascontiguousarray(p), take, axis=1)
        out[mask] = vals[mask]
    return out


def _emit(lines: np.ndarray, work: np.ndarray):
    vpn = (lines // PAGE_LINES).astype(np.int32)
    off = (lines % PAGE_LINES).astype(np.int32)
    return vpn, off, work.astype(np.int32)


def gen_uniform(rng, cores, n, pages):
    lines = rng.integers(0, pages * PAGE_LINES, (cores, n))
    work = rng.integers(1, 4, (cores, n))
    return _emit(lines, work)


def gen_graph(rng, cores, n, pages, alpha=2.1):
    hot = _hot_lines(rng, (cores, n), pages, 2 * alpha)    # hot vertices
    seq = _runs(rng, cores, n, pages, run_len=8, rep=8)    # CSR scans
    cold = rng.integers(0, pages * PAGE_LINES, (cores, n))  # cold neighbours
    lines = _mix_streams(rng, [hot, seq, cold], [0.5, 0.35, 0.15], n)
    work = rng.integers(2, 7, (cores, n))
    return _emit(lines, work)


def gen_graph_frontier(rng, cores, n, pages, alpha=2.1):
    frontier = _runs(rng, cores, n, pages, run_len=32, rep=8)
    expand = _hot_lines(rng, (cores, n), pages, 2 * alpha)  # hot neighbours
    cold = rng.integers(0, pages * PAGE_LINES, (cores, n))
    lines = _mix_streams(rng, [frontier, expand, cold], [0.45, 0.35, 0.2], n)
    work = rng.integers(2, 6, (cores, n))
    return _emit(lines, work)


def gen_graph_sweep(rng, cores, n, pages, alpha=2.1):
    sweep = np.broadcast_to(                               # property sweep
        np.repeat(np.arange(n // 8 + 1), 8)[:n] % (pages * PAGE_LINES),
        (cores, n))
    edges = rng.integers(0, pages * PAGE_LINES, (cores, n))  # edge endpoints
    hot = _hot_lines(rng, (cores, n), pages, 2 * alpha)    # hot vertices
    lines = _mix_streams(rng, [sweep, edges, hot], [0.5, 0.25, 0.25], n)
    work = rng.integers(2, 5, (cores, n))
    return _emit(lines, work)


def gen_mc_lookup(rng, cores, n, pages):
    """XSBench: random energy -> binary-search ladder over grid pages, then
    a short sequential read of the nuclide data (few lines, word-granular)."""
    ladder = 6
    read = 6
    n_look = max(1, n // (ladder + read))
    centers = rng.integers(0, pages, (cores, n_look))
    cols = []
    for step in range(ladder):
        stride = max(pages >> (step + 1), 1)
        if step < 3:
            # top of the search tree: the same few nodes on every lookup
            node = (pages >> 1) // max(stride, 1) * stride % pages
            jitter = np.full((cores, n_look), node)
        else:
            jitter = ((centers + (rng.integers(0, 2, (cores, n_look)) * 2 - 1)
                       * stride) % pages)
        cols.append(jitter * PAGE_LINES + (_hash32(jitter) % PAGE_LINES))
    hit_line = centers * PAGE_LINES + rng.integers(0, PAGE_LINES,
                                                   (cores, n_look))
    for r in range(read):
        cols.append(hit_line + (r // 3))         # ~2 lines, reused
    lines = np.stack(cols, axis=2).reshape(cores, -1)[:, :n]
    if lines.shape[1] < n:
        lines = np.pad(lines, ((0, 0), (0, n - lines.shape[1])), mode="wrap")
    work = rng.integers(4, 9, (cores, n))
    return _emit(lines, work)


def gen_embedding_bag(rng, cores, n, pages):
    """DLRM sparse-length-sum: bags of random rows (each row ~2 lines read
    word-by-word) + a dense sequential MLP segment."""
    rows = _hot_lines(rng, (cores, n), pages, alpha=2.2)
    rows = np.repeat(rows[:, : max(1, n // 4)], 4, axis=1)[:, :n]
    dense = _runs(rng, cores, n, max(pages // 64, 1), run_len=64, rep=8)
    lines = _mix_streams(rng, [rows, dense], [0.6, 0.4], n)
    work = rng.integers(1, 4, (cores, n))
    return _emit(lines, work)


def gen_kmer(rng, cores, n, pages):
    probes = rng.integers(0, pages * PAGE_LINES, (cores, n))
    probes = np.repeat(probes[:, : max(1, n // 3)], 3, axis=1)[:, :n]
    runs = _runs(rng, cores, n, pages, run_len=4, rep=8)
    lines = _mix_streams(rng, [probes, runs], [0.55, 0.45], n)
    work = rng.integers(2, 6, (cores, n))
    return _emit(lines, work)


def _hash32(x):
    x = np.asarray(x, np.uint32) ^ np.uint32(0x9E3779B9)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    return (x ^ (x >> 15)).astype(np.int64)


TRACE_PATTERNS = {
    "uniform": gen_uniform,
    "graph": gen_graph,
    "graph_frontier": gen_graph_frontier,
    "graph_sweep": gen_graph_sweep,
    "mc_lookup": gen_mc_lookup,
    "embedding_bag": gen_embedding_bag,
    "kmer": gen_kmer,
}


# ---------------------------------------------------------------------------
# on-disk trace cache
# ---------------------------------------------------------------------------
def trace_cache_dir() -> str | None:
    """The port's cache directory (``CACHE_SUBDIR`` of the shared cache
    root), or None when disabled (SIM_TRACE_CACHE=0)."""
    env = os.environ.get("SIM_TRACE_CACHE")
    if env == "0":
        return None
    if env:
        return os.path.join(env, CACHE_SUBDIR)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, ".trace_cache", CACHE_SUBDIR)


def _cache_path(workload: str, cores: int, length: int, seed: int,
                spec: dict, pages: int) -> str | None:
    d = trace_cache_dir()
    if d is None:
        return None
    # the key covers everything the trace depends on: the resolved page
    # count (folds footprint_gb and every scale knob), the generator
    # pattern and its alpha — so editing a WORKLOADS entry in
    # configs/ndp_sim.py can never serve a stale cached trace.  The key
    # is the JAX package's; the directory is the port's own
    key = (f"{workload}_c{cores}_n{length}_s{seed}_p{pages}"
           f"_g{spec['pattern']}_a{spec.get('alpha', 0):g}"
           f"_v{_CACHE_VERSION}")
    return os.path.join(d, key + ".npz")


def _cache_load(path: str | None) -> Dict[str, np.ndarray] | None:
    """Integrity-checked load: a truncated or bit-flipped entry (killed
    nightly writer, disk corruption) is QUARANTINED and None returned —
    the caller regenerates, exactly like the OSError degrade path."""
    if path is None:
        return None
    arrays = resilience.read_npz(path)
    if arrays is None:
        return None
    try:
        return {"vpn": arrays["vpn"], "off": arrays["off"],
                "work": arrays["work"], "pages": int(arrays["pages"])}
    except KeyError:                     # entry from an older schema
        resilience.quarantine(path, "missing trace arrays")
        return None


def _cache_store(path: str | None, trace: Dict[str, np.ndarray]) -> None:
    if path is None:
        return
    # the cache is an optimization: any filesystem failure (read-only
    # checkout, unwritable SIM_TRACE_CACHE) degrades to cache-off.
    # Writes are atomic (temp + rename) with a sha256 sidecar, so
    # concurrent writers never publish torn files and readers detect
    # corruption (repro_torch.util.resilience owns both halves).
    resilience.write_npz(path, {"vpn": trace["vpn"], "off": trace["off"],
                                "work": trace["work"],
                                "pages": trace["pages"]})


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def generate_trace(workload: str, num_cores: int, length: int | None = None,
                   seed: int | None = None, preset=None,
                   use_cache: bool = True) -> Dict[str, np.ndarray]:
    """Per-core traces for a Table-II workload.

    Returns dict with vpn/off/work arrays of shape (num_cores, length).
    All cores share the dataset (same footprint region) and draw from one
    vectorized RNG, so no per-core Python loop runs.

    ``preset`` is a :class:`repro_torch.configs.ndp_sim.SimPreset` (or
    its name, e.g. ``"smoke"``) supplying defaults for ``length`` and
    ``seed`` and scaling the Table-II footprint; explicit
    ``length``/``seed`` win.  ``use_cache=False`` bypasses the on-disk
    trace cache for this call.

    A ``workload`` of the form ``"trace:<path>[?opt=val&...]"`` ingests
    a real trace (ChampSim / Valgrind lackey / csv, see
    :mod:`repro_torch.workloads.ingest`) instead of generating one:
    ``length`` clamps it (``None`` replays the whole file), ``seed`` and
    the footprint scale are ignored.
    """
    from repro_torch.configs.ndp_sim import PRESETS, WORKLOADS
    from repro_torch.workloads import parse_workload_spec
    scale = 1.0
    if preset is not None:
        if isinstance(preset, str):
            preset = PRESETS[preset]
        length = preset.trace_len if length is None else length
        seed = preset.seed if seed is None else seed
        scale = preset.footprint_scale
    wspec = parse_workload_spec(workload)
    if wspec.kind == "trace":
        from repro_torch.workloads.ingest import ingest_trace
        return ingest_trace(wspec.name, num_cores, length=length,
                            use_cache=use_cache, **wspec.opts)
    if length is None:
        raise TypeError("generate_trace needs `length` or a `preset`")
    if seed is None:
        seed = 0

    spec = WORKLOADS[workload]
    pattern = TRACE_PATTERNS[spec["pattern"]]
    pages = _pages(spec["footprint_gb"] * scale)

    path = _cache_path(workload, num_cores, length, seed, spec,
                       pages) if use_cache else None
    cached = _cache_load(path)
    if cached is not None:
        return cached

    rng = np.random.default_rng([seed, _stable_hash(workload), num_cores])
    kwargs = {}
    if "alpha" in spec and "alpha" in pattern.__code__.co_varnames:
        kwargs["alpha"] = spec["alpha"]
    vpn, off, work = pattern(rng, num_cores, length, pages, **kwargs)
    trace = {"vpn": vpn, "off": off, "work": work, "pages": pages}
    _cache_store(path, trace)
    return trace


def generate_traces(workloads: Sequence[str], num_cores: int,
                    length: int | None = None, seed: int | None = None,
                    preset=None,
                    use_cache: bool = True) -> List[Dict[str, np.ndarray]]:
    """Traces for a whole batch bucket (one per workload, same core count)
    — the unit :func:`repro_torch.sim.simulate_batch` consumes."""
    return [generate_trace(w, num_cores, length, seed, preset, use_cache)
            for w in workloads]
