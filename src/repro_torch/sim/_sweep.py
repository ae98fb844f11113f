"""Declarative machine-parameter sweep engine for sensitivity studies.

The port of ``repro.sim._sweep``.  The paper's headline numbers rest on
sensitivity analyses — PWC/TLB sizing, L1-bypass on/off, flattened-level
choice, core scaling — and :func:`sweep` runs each as a declarative grid
over machine parameters × mechanisms × workloads.  It buckets the
cross-product by table shape (``machine_shape`` + mechanism walk-fn
tuple) and runs each bucket as ONE batched
:func:`repro_torch.sim.simulator.simulate_batch_varied`, on the card the
LRU-scan and timing-epilogue kernels a chunk.  Parameter values that
don't change array shapes — latencies, memory service time,
bypass/PWC/huge flags, walk depth — ride the batch lanes as data, so e.g.
a 4-latency × 6-workload grid is 24 simulations, one bucket, one bucket
plan.

Grid axes (an ordered mapping ``name -> values``):

  ``workload``    Table-II workload names, or ``"trace:<path>"`` for
                  ingested real traces (see repro_torch.workloads.ingest)
  ``machine``     "ndp" | "cpu" (Table-I machine family)
  ``cores``       core count (passed to the machine factory)
  ``mechs``       mechanism-name tuples from the spec registry
  anything else   a ``MachineConfig`` override path, dotted for nested
                  fields: "pwc_entries", "l1_dtlb.entries",
                  "l2_tlb.entries", "l1d.size_bytes", "memory.latency",
                  "memory.t_cas" — plus "memory_model", which switches
                  to a named MemoryModel preset (calibration-preserving)

Named presets for the paper's sensitivity figures live in
``repro_torch.configs.ndp_sim.SWEEPS`` and run as ``sweep("pwc_size")``;
``python -m repro_torch.launch.simulate --sweep NAME`` prints them.

:class:`SweepResult` keeps the named axes: ``select(axis=value)`` drops
an axis, ``select(axis=[...])`` subsets it, ``scalar(metric, mech)`` /
``speedup(mech)`` evaluate a derived metric over the whole grid as a
plain ndarray, and ``point(...)`` returns one ``SimResult``.

Every entry point runs on ``device`` (the card by default, raising
without one; ``"cpu"`` runs the plain scan).  Nothing gives way to the
CPU when a kernel fails to build or launch.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.ndp_sim import (PRESETS, SWEEPS, MachineConfig,
                                         cpu_machine, ndp_machine)
from repro_torch.sim import memory_model as MM
from repro_torch.sim.mechanisms import DEFAULT_MECHS, get as _get_mech
from repro_torch.sim.simulator import (SimJob, SimResult, _walk_fns,
                                       clear_runner_cache, machine_shape,
                                       runner_cache_info,
                                       simulate_batch_varied)
from repro_torch.util import resilience
from repro_torch.util.device import resolve_device

_FACTORIES = {"ndp": ndp_machine, "cpu": cpu_machine}


# ---------------------------------------------------------------------------
# grid -> points
# ---------------------------------------------------------------------------
def _field_names(obj) -> set:
    return {f.name for f in dataclasses.fields(obj)}


def apply_param(mach: MachineConfig, path: str, value) -> MachineConfig:
    """Non-destructively override one MachineConfig field; one level of
    dotting reaches into the nested Cache/TLB/MemoryModel params
    ("l1_dtlb.entries", "l1d.size_bytes", "memory.t_cas").  Validates
    against dataclass FIELDS, so derived properties (e.g.
    ``l1d.num_sets``) are rejected with a named error rather than
    crashing in ``dataclasses.replace``.

    ``memory_model`` switches the machine to a named
    :data:`~repro_torch.sim.memory_model.MEMORY_MODELS` preset keeping its
    calibration (:func:`~repro_torch.sim.memory_model.with_kind`), and an
    unknown ``memory.*`` knob raises a ``ValueError`` that LISTS the
    knobs (a typo'd override must never silently no-op a whole sweep).
    The JAX package's deprecated flat paths (``mem_latency`` ...) are not
    ported: the port's MachineConfig has no such field."""
    if path == "memory_model":
        return dataclasses.replace(mach,
                                   memory=MM.with_kind(mach.memory, value))
    head, _, rest = path.partition(".")
    if head == "memory" and rest and rest not in _field_names(
            MM.MemoryModel):
        knobs = ", ".join(f"memory.{f.name}"
                          for f in dataclasses.fields(MM.MemoryModel))
        raise ValueError(
            f"unknown memory-model knob {path!r}: known knobs are "
            f"{knobs}, or 'memory_model' to switch presets "
            f"{tuple(MM.MEMORY_MODELS)}")
    if head not in _field_names(mach):
        raise KeyError(
            f"unknown sweep parameter {path!r}: MachineConfig has no "
            f"field {head!r}")
    if rest:
        sub = getattr(mach, head)
        if (sub is None or not dataclasses.is_dataclass(sub)
                or rest not in _field_names(sub)):
            raise KeyError(
                f"unknown sweep parameter {path!r}: "
                f"{type(sub).__name__ if sub is not None else None} has "
                f"no field {rest!r}")
        return dataclasses.replace(
            mach, **{head: dataclasses.replace(sub, **{rest: value})})
    return dataclasses.replace(mach, **{head: value})


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One fully-resolved grid point."""

    mach: MachineConfig
    workload: str
    mechs: Tuple[str, ...]


def _resolve_point(named: Dict, base: str, cores: int, workload: str,
                   mechs: Tuple[str, ...]) -> SweepPoint:
    named = dict(named)
    family = named.pop("machine", base)
    if family not in _FACTORIES:
        raise KeyError(f"unknown machine family {family!r}; "
                       f"known: {sorted(_FACTORIES)}")
    mach = _FACTORIES[family](int(named.pop("cores", cores)))
    w = named.pop("workload", workload)
    # "trace:<path>" values ingest a real trace instead of naming a
    # Table-II generator; either way the ONE spec parser validates here,
    # not deep inside a bucketed run
    from repro_torch.workloads import parse_workload_spec
    parse_workload_spec(str(w))
    mnames = tuple(named.pop("mechs", mechs))
    for n in mnames:
        _get_mech(n)                      # fail fast on unknown mechanisms
    for path, value in named.items():
        mach = apply_param(mach, path, value)
    return SweepPoint(mach=mach, workload=w, mechs=mnames)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SweepResult:
    """Grid of :class:`SimResult` with named axes.

    ``axes`` maps axis name -> value tuple in grid order; ``results`` is
    an object ndarray of the same shape; ``stats`` records the
    bucketing/compile accounting of the run.
    """

    axes: "OrderedDict[str, Tuple]"
    results: np.ndarray
    stats: Dict

    def axis(self, name: str) -> Tuple:
        return self.axes[name]

    def _index(self, name: str, v) -> int:
        vals = list(self.axes[name])
        try:
            return vals.index(v)
        except ValueError:
            raise KeyError(f"axis {name!r} has no value {v!r}; "
                           f"values: {vals}") from None

    def select(self, **kw) -> "SweepResult":
        """Slice by axis name: a single axis value drops the axis, a
        list/tuple of values keeps it restricted to those values (order
        as given).  A tuple that IS one of the axis's values (e.g. a
        mechanism tuple on a ``mechs`` axis) selects that single value.
        Unknown axis names raise."""
        unknown = set(kw) - set(self.axes)
        if unknown:
            raise KeyError(f"unknown sweep axes {sorted(unknown)}; "
                           f"have {list(self.axes)}")
        out = self.results
        axes = OrderedDict()
        drop = []
        for dim, (name, vals) in enumerate(self.axes.items()):
            if name not in kw:
                axes[name] = vals
                continue
            sel = kw[name]
            if not isinstance(sel, np.ndarray) and sel in vals:
                out = np.take(out, [self._index(name, sel)], axis=dim)
                drop.append(dim)
            elif isinstance(sel, (list, tuple, np.ndarray)):
                out = np.take(out, [self._index(name, v) for v in sel],
                              axis=dim)
                axes[name] = tuple(sel)
            else:
                self._index(name, sel)               # raises with values
        if drop:
            out = np.squeeze(out, axis=tuple(drop))
        return SweepResult(axes=axes, results=out, stats=self.stats)

    def point(self, **kw) -> SimResult:
        """The single :class:`SimResult` at one fully-specified grid
        point (every remaining axis must resolve to one value)."""
        r = self.select(**kw)
        if r.results.size != 1:
            raise KeyError(f"point() needs every axis pinned; still "
                           f"open: {dict(r.axes)}")
        return r.results.reshape(())[()]

    def map(self, fn) -> np.ndarray:
        """Apply ``fn(SimResult) -> float`` over the grid."""
        out = np.empty(self.results.shape, np.float64)
        for idx in np.ndindex(*self.results.shape):
            out[idx] = fn(self.results[idx])
        return out

    def scalar(self, metric: str, mech: str) -> np.ndarray:
        """``SimResult.scalar(metric, mech)`` over the whole grid."""
        return self.map(lambda r: r.scalar(metric, mech))

    def speedup(self, mech: str, base: str = "radix") -> np.ndarray:
        """Mean-cycle speedup of ``mech`` vs ``base`` over the grid."""
        return self.map(lambda r: r.speedup_vs(base)[mech])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
#: SimResult array fields, in (de)serialization order, for checkpoints
_RESULT_FIELDS = ("cycles", "instructions", "trans_cycles", "walk_cycles",
                  "walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
                  "pte_mem", "data_l1_misses", "data_mem")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every source a checkpointed result depends on besides the jobs
#: themselves, relative to the package: a code change can never serve a
#: stale bucket
ENGINE_SOURCES = (
    "sim/simulator.py", "sim/mechanisms.py", "sim/memory_model.py",
    "workloads/generators.py", "core/page_table.py", "configs/ndp_sim.py",
    "kernels/ref.py", "kernels/lru_scan.py", "kernels/sim_epilogue.py",
    "kernels/csrc/lru_scan.cu", "kernels/csrc/sim_epilogue.cu")


@functools.lru_cache(maxsize=1)
def _engine_ckpt_digest() -> str:
    """Hash of :data:`ENGINE_SOURCES`."""
    h = hashlib.sha256()
    for rel in ENGINE_SOURCES:
        with open(os.path.join(_PKG, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def checkpoint_key(jobs: Sequence[SimJob], chunk: int,
                   length: int | None, device="cuda") -> str:
    """Content key of one ``run_bucketed`` call: engine sources, chunk
    layout, the device type (the card's float sums may differ from the
    CPU's in the last bits), and every job's machine, mechanisms and
    trace BYTES (str trace specs hash the underlying file)."""
    h = hashlib.sha256()
    h.update(_engine_ckpt_digest().encode())
    h.update(json.dumps({"chunk": chunk, "length": length,
                         "device": str(device).split(":")[0]}).encode())
    memo: Dict[int, str] = {}
    for j in jobs:
        h.update(json.dumps(dataclasses.asdict(j.mach), sort_keys=True,
                            default=str).encode())
        h.update(repr(tuple(j.mechs)).encode())
        t = j.trace
        if isinstance(t, str):
            h.update(t.encode())
            if t.startswith("trace:"):
                from repro_torch.workloads.ingest import parse_trace_spec
                from repro_torch.workloads.ingest.io import file_sha256
                h.update(file_sha256(parse_trace_spec(t)[0]).encode())
        else:
            tid = id(t)
            if tid not in memo:
                th = hashlib.sha256()
                for k in ("vpn", "off", "work"):
                    th.update(np.ascontiguousarray(t[k]).tobytes())
                th.update(str(int(t["pages"])).encode())
                memo[tid] = th.hexdigest()
            h.update(memo[tid].encode())
    return h.hexdigest()[:20]


def _ckpt_pack(results: Sequence[SimResult]) -> Dict:
    out: Dict = {"n": np.int64(len(results))}
    for k, r in enumerate(results):
        out[f"j{k}_mechs"] = np.asarray(r.mechs)
        out[f"j{k}_accesses"] = np.int64(r.accesses)
        for f in _RESULT_FIELDS:
            out[f"j{k}_{f}"] = getattr(r, f)
    return out


def _ckpt_unpack(arrays: Dict, expect: int) -> Optional[List[SimResult]]:
    try:
        if int(arrays["n"]) != expect:
            return None
        return [SimResult(
            mechs=tuple(str(m) for m in arrays[f"j{k}_mechs"]),
            accesses=int(arrays[f"j{k}_accesses"]),
            **{f: arrays[f"j{k}_{f}"] for f in _RESULT_FIELDS})
            for k in range(expect)]
    except KeyError:                     # schema drift: re-dispatch
        return None


def _resolve_checkpoint(checkpoint, jobs, chunk, length, device="cuda"
                        ) -> Optional[str]:
    """The checkpoint path prefix for this call, or None (off).

    ``checkpoint``: None consults ``SIM_SWEEP_CHECKPOINT`` (unset/0 =
    off, any other value = on); True/"auto" derive the content key; any
    other string IS the key (caller-managed staleness).  Checkpoints live
    in the port's own trace-cache directory."""
    if checkpoint is None:
        env = os.environ.get("SIM_SWEEP_CHECKPOINT", "")
        checkpoint = env not in ("", "0") and (env
                                               if env != "1" else "auto")
    if not checkpoint:
        return None
    from repro_torch.workloads import trace_cache_dir
    d = trace_cache_dir()
    if d is None:
        return None
    key = (checkpoint_key(jobs, chunk, length, device)
           if checkpoint in (True, "auto")
           else str(checkpoint))
    return os.path.join(d, f"sweepckpt_{key}")


def run_bucketed(jobs: Sequence[SimJob], *, chunk: int,
                 devices: int | None = None,
                 length: int | None = None,
                 checkpoint: "bool | str | None" = None,
                 watchdog_s: float | None = None,
                 device="cuda") -> Tuple[List[SimResult], Dict]:
    """The sweep engine's dispatch core, reusable on any heterogeneous
    job list (the design-space search feeds whole candidate populations
    through here): bucket ``jobs`` by table shape — ``machine_shape`` x
    the mechanisms' walk-fn tuple — and run each bucket as ONE
    :func:`simulate_batch_varied` on ``device``.  Value-only differences
    (latencies, bypass/PWC/huge flags, walk depth) ride the batch lanes,
    so the bucket plans made are bounded by the number of buckets, never
    the number of jobs.

    Resilience (both off by default):

    * ``checkpoint`` — persist each completed bucket's results to
      ``<trace cache>/repro_torch/sweepckpt_<key>_b<i>.npz``
      (integrity-checked, atomic; the key covers the engine sources, the
      device type and every job's machine/mechs/trace bytes).  A killed
      run resumed with the same jobs loads the finished buckets
      bit-exactly and dispatches ONLY the rest: a resumed bucket makes
      no plan and launches no kernel.  ``True``/"auto" derives the key; a
      string is used as the key verbatim; None consults
      ``SIM_SWEEP_CHECKPOINT``.
    * ``watchdog_s`` — wall-clock deadline per bucket dispatch; a hung
      dispatch (or an injected ``dispatch`` fault) gets ONE retry after
      :func:`repro_torch.sim.simulator.clear_runner_cache`.  None
      consults ``SIM_DISPATCH_TIMEOUT`` (seconds; 0 = no deadline,
      injected faults still exercise the retry path).  On the card a
      hung kernel cannot be cancelled (``util/resilience.py``).

    ``devices``: each bucket's lanes split over that many cards
    (``simulator.sim_devices``; each bucket's entry records the count
    used as "devices").  Returns
    the per-job :class:`SimResult` list (job order preserved) plus the
    bucketing/compile stats dict ``sweep()`` exposes as
    ``SweepResult.stats`` (minus the grid-level entries); a "compile" is
    a bucket plan."""
    dev = resolve_device(device)
    if watchdog_s is None:
        watchdog_s = float(os.environ.get("SIM_DISPATCH_TIMEOUT", "0")
                           or 0)
    ckpt_prefix = _resolve_checkpoint(checkpoint, jobs, chunk, length, dev)

    buckets: "OrderedDict[Tuple, List[int]]" = OrderedDict()
    for i, j in enumerate(jobs):
        key = (machine_shape(j.mach), _walk_fns(j.mechs))
        buckets.setdefault(key, []).append(i)

    results: List[SimResult] = [None] * len(jobs)   # type: ignore[list-item]
    info0 = runner_cache_info()
    per_bucket = []
    resumed_buckets = 0
    t0 = time.perf_counter()
    for bi, ((shape, wf), idxs) in enumerate(buckets.items()):
        # the display key is as discriminating as the bucket key: the
        # memory shape (bank geometry) is part of machine_shape
        shape_str = (f"{shape.num_cores}c/"
                     + ":".join(str(p) for p in shape.memory) + "/"
                     + ",".join(f"{n}:{s}x{w}" for n, s, w in shape.tables))
        entry = {
            "shape": shape_str,
            "walk_fns": [getattr(f, "__qualname__", str(f)) if f else None
                         for f in wf],
            "points": list(idxs),
            "lanes": len(idxs),
        }
        ckpt_path = (f"{ckpt_prefix}_b{bi:03d}.npz"
                     if ckpt_prefix else None)
        outs = None
        if ckpt_path is not None:
            arrays = resilience.read_npz(ckpt_path)
            if arrays is not None:
                outs = _ckpt_unpack(arrays, len(idxs))
        if outs is not None:
            resumed_buckets += 1
            resilience.log_event(
                "resume", f"bucket {bi} ({shape_str}, {len(idxs)} lanes) "
                          f"restored from {os.path.basename(ckpt_path)}")
            entry.update(compiles=0, total_s=0.0, compile_s_est=0.0,
                         devices=0, resumed=True)
        else:
            before = runner_cache_info().misses
            tm: Dict = {}
            tag = f"bucket{bi}:{shape_str}"

            def _dispatch():
                inj = resilience.fault_injector()
                if inj is not None and inj.fires("dispatch", tag):
                    raise resilience.DispatchTimeout(
                        f"injected dispatch fault: {tag}")
                return simulate_batch_varied(
                    [jobs[i] for i in idxs], length, chunk=chunk,
                    devices=devices, timings=tm, device=dev)

            outs = resilience.watchdog_call(
                _dispatch, watchdog_s, tag=tag, retries=1,
                on_timeout=clear_runner_cache)
            entry.update(
                compiles=runner_cache_info().misses - before,
                total_s=round(tm.get("total_s", 0.0), 3),
                compile_s_est=round(tm.get("compile_s_est", 0.0), 3),
                devices=tm.get("devices", 1), resumed=False)
            if ckpt_path is not None:
                resilience.write_npz(ckpt_path, _ckpt_pack(outs))
        for i, res in zip(idxs, outs):
            results[i] = res
        per_bucket.append(entry)
    return results, {
        "points": len(jobs),
        "buckets": len(buckets),
        # buckets may split one machine shape across walk-fn tuples, so
        # count the shapes themselves too
        "distinct_shapes": len({shape for shape, _ in buckets}),
        "runner_compiles": runner_cache_info().misses - info0.misses,
        "resumed_buckets": resumed_buckets,
        "wall_s": round(time.perf_counter() - t0, 3),
        "chunk": chunk,
        "per_bucket": per_bucket,
    }


GridLike = Union[str, Mapping[str, Sequence], "OrderedDict[str, Tuple]"]


def named_sweep(name: str) -> Dict:
    """The declarative preset dict from ``configs.ndp_sim.SWEEPS``."""
    try:
        return dict(SWEEPS[name])
    except KeyError:
        raise KeyError(f"unknown sweep preset {name!r}; "
                       f"available: {sorted(SWEEPS)}") from None


#: fallbacks when neither the call nor a preset pins a knob
_DEFAULTS = dict(base="ndp", cores=4, workload="rnd",
                 mechs=DEFAULT_MECHS, preset="smoke")


def sweep(grid: GridLike, *, base: str | None = None,
          cores: int | None = None, workload: str | None = None,
          mechs: Tuple[str, ...] | None = None,
          preset: str | None = None, trace_len: int | None = None,
          seed: int | None = None, chunk: int | None = None,
          devices: int | None = None,
          checkpoint: "bool | str | None" = None,
          watchdog_s: float | None = None, device="cuda") -> SweepResult:
    """Run a sensitivity grid, one batched dispatch per shape bucket, on
    ``device``.

    ``grid`` is an ordered ``axis -> values`` mapping (see module
    docstring) or the name of a preset in ``configs.ndp_sim.SWEEPS``
    (whose entry may also carry ``base``/``cores``/``workload``/
    ``mechs``/``preset`` defaults; explicit keyword arguments win over
    the preset, which wins over the module defaults).  ``preset`` names
    a ``SimPreset`` supplying trace length / seed / chunk (default
    "smoke"); explicit ``trace_len``/``seed``/``chunk`` win.
    """
    kw = dict(base=base, cores=cores, workload=workload,
              mechs=mechs, preset=preset)
    if isinstance(grid, str):
        spec = named_sweep(grid)
        axes_src = spec.pop("axes")
        spec.pop("figure", None)          # human-facing, not a parameter
        for k, v in spec.items():
            if k not in kw:
                raise KeyError(f"sweep preset {grid!r}: unknown key {k!r}")
            if kw[k] is None:
                kw[k] = v
    else:
        axes_src = grid.items() if isinstance(grid, Mapping) else grid
    for k, v in _DEFAULTS.items():
        if kw[k] is None:
            kw[k] = v

    sim_preset = PRESETS[kw["preset"]]
    trace_len = sim_preset.trace_len if trace_len is None else trace_len
    seed = sim_preset.seed if seed is None else seed
    chunk = sim_preset.chunk if chunk is None else chunk

    axes: "OrderedDict[str, Tuple]" = OrderedDict(
        (name, tuple(vals)) for name, vals in axes_src)
    if not axes:
        raise ValueError("sweep needs at least one axis")
    for name, vals in axes.items():
        if not vals:
            raise ValueError(f"sweep axis {name!r} has no values")

    dims = tuple(len(v) for v in axes.values())
    points: List[SweepPoint] = []
    for combo in itertools.product(*axes.values()):
        points.append(_resolve_point(
            dict(zip(axes, combo)), kw["base"], kw["cores"],
            kw["workload"], kw["mechs"]))

    # resolve each point's trace once per (workload, cores), then hand the
    # whole cross-product to the bucketed dispatch core
    from repro_torch.workloads import generate_trace
    traces: Dict[Tuple[str, int], Dict] = {}   # (workload, cores) -> trace
    for p in points:
        key = (p.workload, p.mach.num_cores)
        if key not in traces:
            traces[key] = generate_trace(key[0], key[1], length=trace_len,
                                         seed=seed, preset=sim_preset)
    jobs = [SimJob(p.mach, traces[p.workload, p.mach.num_cores], p.mechs)
            for p in points]
    outs, stats = run_bucketed(jobs, chunk=chunk, devices=devices,
                               checkpoint=checkpoint,
                               watchdog_s=watchdog_s, device=device)
    results = np.empty(dims, object)
    for i, res in enumerate(outs):
        results[np.unravel_index(i, dims)] = res
    stats["trace_len"] = trace_len
    return SweepResult(axes=axes, results=results, stats=stats)
