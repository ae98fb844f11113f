"""Simulator launcher of the port: the paper's Figs 12-14 experiment.

On the card, the default (the ``full`` preset: 8,000-entry windows,
Table-II footprints, seed 0, chunks of 1,024):
  python -m repro_torch.launch.simulate [--preset full|smoke] \
      [--machines ndp,cpu] [--cores 1,4,8] [--workloads bc,bfs,...] \
      [--memory bounded_linear|banked] [--trace-len N] [--profile]
runs one ``simulate_batch`` per (machine, cores) bucket, every workload
on the batch axis, the paper's five mechanisms on the mechanism axis, and
prints each workload's speedup over radix, the NDP averages beside the
paper's (Figs 12, 13, 14 at 1, 4, 8 cores), and per bucket the wall
seconds, chunks, LRU-scan and epilogue kernel launches and trace entries
a second.  The card's context and the kernels' builds come before the
first bucket, so no bucket's wall time holds them.  ``--profile`` traces
each bucket with torch.profiler and prints its time by operator and the
card's busy share.  ``--memory banked`` switches every machine to the
banked DRAM model (16 banks of 2 KB rows; the machine's own latency
kept, ``memory_model.with_kind``).  ``--workloads`` also takes
``trace:<path>[?opt=val&...]`` specs of real traces (ChampSim, Valgrind
lackey or CSV; ``repro_torch.workloads.ingest``), each replayed up to
the window.

``--sweep NAME[,NAME...]`` runs named sensitivity sweeps
(``configs.ndp_sim.SWEEPS``: pwc_size, tlb_size, l1_bypass,
flatten_level, core_scaling, mem_latency, banked_timing, zoo,
victima_reach) at ``--preset`` instead of the figure buckets, one
``simulate_batch_varied`` per shape bucket through the same two kernels,
and prints each point's speedups over radix and each sweep's points,
buckets, bucket plans ("compiles") and wall seconds.

On the CPU (plain PyTorch scan):
  python -m repro_torch.launch.simulate --preset smoke --device cpu
  python -m repro_torch.launch.simulate --preset smoke --device cpu \
      --sweep l1_bypass
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.ndp_sim import (CORE_COUNTS, PRESETS, SWEEPS,
                                         WORKLOADS, cpu_machine,
                                         ndp_machine)
from repro_torch.kernels import _build
from repro_torch.kernels import lru_scan as LS
from repro_torch.kernels import sim_epilogue as SE
from repro_torch.sim import DEFAULT_MECHS, simulate_batch, sweep
from repro_torch.sim.memory_model import MEMORY_MODELS, with_kind
from repro_torch.util.device import resolve_device
from repro_torch.util.profile import print_profile
from repro_torch.workloads import generate_traces, parse_workload_spec

MACHINES = {"ndp": ndp_machine, "cpu": cpu_machine}
#: the figure of each core count, and the paper's average NDP speedups
#: over radix in it (benchmarks/sim_figures.py of the JAX package)
FIGS = {1: "fig12_1c", 4: "fig13_4c", 8: "fig14_8c"}
PAPER = {1: {"ech": 1.176, "hugepage": 1.08, "ndpage": 1.344},
         4: {"ech": 1.299, "ndpage": 1.426},
         8: {"ech": 1.078, "hugepage": 0.901, "ndpage": 1.407}}
SHOWN = tuple(m for m in DEFAULT_MECHS if m != "radix")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="full", choices=sorted(PRESETS))
    ap.add_argument("--machines", default="ndp,cpu",
                    help="comma-separated, of " + ",".join(MACHINES))
    ap.add_argument("--cores", default=",".join(map(str, CORE_COUNTS)))
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated Table-II names or "
                         "trace:<path> specs")
    ap.add_argument("--memory", default="bounded_linear",
                    choices=sorted(MEMORY_MODELS),
                    help="the machines' DRAM model")
    ap.add_argument("--trace-len", type=int, default=None,
                    help="trace window (default: the preset's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace each bucket with torch.profiler and print "
                         "the time by operator")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated named sweeps, of "
                         + ",".join(SWEEPS))
    return ap


def with_memory(mach, memory: str):
    """``mach`` with its memory switched to the ``memory`` preset, the
    machine's own calibration kept (``memory_model.with_kind``)."""
    if mach.memory.kind == memory:
        return mach
    return dataclasses.replace(mach, memory=with_kind(mach.memory, memory))


def bucket_machine(machine: str, cores: int, memory: str = "bounded_linear"):
    """The bucket's machine, its memory switched to ``memory``."""
    return with_memory(MACHINES[machine](cores), memory)


def run_bucket(machine: str, cores: int, workloads: List[str], preset,
               trace_len: Optional[int], device,
               profile: bool = False, memory: str = "bounded_linear") -> Dict:
    """One (machine, cores) bucket: every workload as one batch."""
    t0 = time.perf_counter()
    traces = generate_traces(workloads, cores, length=trace_len,
                             preset=preset)
    gen_s = time.perf_counter() - t0
    before, before_ep = LS.launches, SE.launches
    timings: Dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if profile else None
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        results = simulate_batch(bucket_machine(machine, cores, memory),
                                 traces,
                                 chunk=preset.chunk, timings=timings,
                                 device=device)
    wall = time.perf_counter() - t0
    if prof is not None:
        print_profile(prof, wall)
    entries = sum(tr["vpn"].shape[0] * tr["vpn"].shape[1] for tr in traces)
    return {"machine": machine, "cores": cores,
            "results": dict(zip(workloads, results)),
            "speedups": {w: r.speedup_vs() for w, r in
                         zip(workloads, results)},
            "trace_gen_s": gen_s, "wall_s": wall,
            "chunks": timings["chunks"],
            "launches": LS.launches - before,
            "epilogue_launches": SE.launches - before_ep, "entries": entries,
            "entries_per_s": entries / wall}


def averages(bucket: Dict) -> Dict[str, float]:
    """Mean speedup over radix of each mechanism across the workloads."""
    return {m: float(np.mean([s[m] for s in bucket["speedups"].values()]))
            for m in SHOWN}


def _ready(device) -> None:
    """The card's context and the kernels' builds and loads, so no
    bucket's wall time holds them."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        _build.build_all(["lru_scan", "sim_epilogue"])
        LS._lib(), SE._lib()


def point_label(axes: Dict, idx) -> str:
    """``axis=value`` of one grid point (mechanism tuples joined by +)."""
    return " ".join(
        f"{n}={'+'.join(v[i]) if isinstance(v[i], tuple) else v[i]}"
        for (n, v), i in zip(axes.items(), idx))


def run_sweeps(args, show_points: bool = True) -> Dict:
    """Every named sweep of ``args.sweep`` at ``args.preset``, as a dict
    name -> ``SweepResult``; prints each point's speedups over radix
    (unless ``show_points`` is False) and each sweep's points, buckets,
    bucket plans and wall seconds."""
    device = resolve_device(args.device)
    names = args.sweep.split(",")
    for n in names:
        if n not in SWEEPS:
            raise ValueError(f"unknown sweep {n!r}: one of {sorted(SWEEPS)}")
    _ready(device)
    out = {}
    for name in names:
        before, before_ep = LS.launches, SE.launches
        t0 = time.perf_counter()
        r = sweep(name, preset=args.preset, trace_len=args.trace_len,
                  device=device)
        wall = time.perf_counter() - t0
        if show_points:
            for idx in np.ndindex(*r.results.shape):
                res = r.results[idx]
                sp = res.speedup_vs()
                print(f"sweep {name} {point_label(r.axes, idx)}: "
                      + " ".join(f"{m}={sp[m]:.3f}" for m in res.mechs
                                 if m != "radix"))
        st = r.stats
        print(f"sweep {name}: {st['points']} points, {st['buckets']} "
              f"buckets, {st['distinct_shapes']} shapes, "
              f"{st['runner_compiles']} compiles (per bucket "
              f"{[b['compiles'] for b in st['per_bucket']]}), "
              f"{st['trace_len']}-entry windows, wall {wall:.3f} s "
              f"(dispatch {st['wall_s']:.3f} s), lru_scan launches "
              f"{LS.launches - before}, sim_epilogue launches "
              f"{SE.launches - before_ep}")
        out[name] = r
    return out


def run(args) -> List[Dict]:
    """Every requested bucket in the order of the JAX package's figure
    benchmark (cores outer, machines inner); prints as it goes."""
    device = resolve_device(args.device)
    preset = PRESETS[args.preset]
    machines = args.machines.split(",")
    for m in machines:
        if m not in MACHINES:
            raise ValueError(f"unknown machine {m!r}: one of "
                             f"{sorted(MACHINES)}")
    workloads = args.workloads.split(",")
    for w in workloads:
        parse_workload_spec(w)          # a name or a trace spec, or raise
    window = args.trace_len or preset.trace_len
    _ready(device)
    print(f"simulate: preset {preset.name}, {window}-entry windows, seed "
          f"{preset.seed}, chunk {preset.chunk}, device {device}, "
          f"memory {args.memory}, mechanisms {','.join(DEFAULT_MECHS)}")
    out = []
    for cores in (int(c) for c in args.cores.split(",")):
        for machine in machines:
            bk = run_bucket(machine, cores, workloads, preset,
                            args.trace_len, device, args.profile,
                            args.memory)
            out.append(bk)
            tag = FIGS.get(cores, f"{cores}c") if machine == "ndp" else (
                f"cpu_{cores}c")
            for w, s in bk["speedups"].items():
                print(f"{tag}_{w}: "
                      + " ".join(f"{m}={s[m]:.3f}" for m in SHOWN))
            avg = averages(bk)
            paper = (f" (paper: {PAPER[cores]})"
                     if machine == "ndp" and cores in PAPER else "")
            print(f"{tag}_avg: "
                  + " ".join(f"{m}={avg[m]:.3f}" for m in SHOWN) + paper)
            print(f"bucket {machine} {cores}c: {len(workloads)} sims, "
                  f"{bk['chunks']} chunks, wall {bk['wall_s']:.3f} s "
                  f"(traces {bk['trace_gen_s']:.3f} s apart), lru_scan "
                  f"launches {bk['launches']}, sim_epilogue launches "
                  f"{bk['epilogue_launches']}, "
                  f"{bk['entries_per_s']:.0f} trace entries/s")
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.sweep:
        run_sweeps(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
