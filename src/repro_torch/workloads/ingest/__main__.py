"""Convert a real memory trace into a simulator trace (.npz).

Parses any format the port's ingest layer knows (ChampSim binary
records, Valgrind lackey text, csv — ``.xz``/``.gz`` transparently
decompressed), interleaves it over ``--cores``, and writes the
simulator's ``{vpn, off, work, pages}`` dict as an ``.npz``.  Also
prints the trace characterization (footprint, page/line reuse, work
density) that tells you which Table-II synthetic workload it most
resembles.  The flags, the printed lines and the npz keys are the JAX
package's ``scripts/convert_trace.py``'s.

The npz is convenient for archiving/sharing, but the simulator does
not need it: every engine entry point accepts
``workload="trace:<path>[?opt=val&...]"`` directly (options below map
1:1 onto the spec-string options) and memoizes the parse through the
port's ``.trace_cache/repro_torch/``.

Usage:
  python -m repro_torch.workloads.ingest trace.champsim.xz --cores 4
  python -m repro_torch.workloads.ingest mem.csv --fmt csv \\
      --interleave thread --length 100000 --out mem.npz
  python -m repro_torch.workloads.ingest trace.lackey.gz --stats-only
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.workloads.ingest import (DEFAULT_GAP_CAP,
                                          DEFAULT_WORK_CLIP, INTERLEAVES,
                                          PARSERS, ingest_trace)


def stats(trace, page_bytes: int = 4096) -> dict:
    """The trace's characterization: cores, accesses a core, footprint,
    distinct pages and lines touched, line and page reuse, mean work."""
    vpn, off, work = trace["vpn"], trace["off"], trace["work"]
    lines = vpn.astype(np.int64) * (page_bytes // 64) + off
    n = vpn.size
    return {
        "cores": vpn.shape[0],
        "accesses_per_core": vpn.shape[1],
        "footprint_pages": trace["pages"],
        "footprint_mb": round(trace["pages"] * page_bytes / 2**20, 1),
        "distinct_pages_touched": int(np.unique(vpn).size),
        "distinct_lines_touched": int(np.unique(lines).size),
        "line_reuse": round(1.0 - np.unique(lines).size / n, 3),
        "page_reuse": round(1.0 - np.unique(vpn).size / n, 3),
        "mean_work": round(float(work.mean()), 2),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads.ingest", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="trace file (.xz/.gz auto-decompressed)")
    p.add_argument("--out", default=None,
                   help="output .npz (default: <input>.npz; "
                        "--stats-only skips writing)")
    p.add_argument("--cores", type=int, default=4)
    p.add_argument("--length", type=int, default=None,
                   help="clamp per-core accesses (default: whole file)")
    p.add_argument("--fmt", choices=sorted(PARSERS), default=None,
                   help="parser (default: inferred from the file name)")
    p.add_argument("--interleave", choices=INTERLEAVES,
                   default="round_robin")
    p.add_argument("--page-bytes", type=int, default=4096)
    p.add_argument("--work-clip", type=int, default=DEFAULT_WORK_CLIP)
    p.add_argument("--gap-cap", type=int, default=DEFAULT_GAP_CAP)
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the .trace_cache memoization layer")
    p.add_argument("--stats-only", action="store_true",
                   help="print the characterization, write nothing")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trace = ingest_trace(
        args.input, args.cores, length=args.length, fmt=args.fmt,
        interleave=args.interleave, page_bytes=args.page_bytes,
        work_clip=args.work_clip, gap_cap=args.gap_cap,
        use_cache=not args.no_cache)

    for k, v in stats(trace, args.page_bytes).items():
        print(f"{k}: {v}")

    if not args.stats_only:
        out = args.out or args.input + ".npz"
        np.savez(out, vpn=trace["vpn"], off=trace["off"],
                 work=trace["work"], pages=trace["pages"])
        print(f"wrote {out}")

    spec = f"trace:{args.input}"
    extras = []
    if args.fmt:
        extras.append(f"fmt={args.fmt}")
    if args.interleave != "round_robin":
        extras.append(f"interleave={args.interleave}")
    if args.page_bytes != 4096:
        extras.append(f"page_bytes={args.page_bytes}")
    if extras:
        spec += "?" + "&".join(extras)
    print(f'# replay directly: sweep({{"workload": ("{spec}",)}}) or '
          f'simulate_batch(mach, ["{spec}"])')
    return 0


if __name__ == "__main__":
    sys.exit(main())
