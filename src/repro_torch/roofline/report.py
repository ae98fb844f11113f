"""Render the roofline table of a dry-run results file (counterpart of
``repro.roofline.report``; the records are the JAX dry-run's).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [path]
       [--mesh 16x16] [--markdown]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from repro_torch import config as C
from repro_torch.roofline.analysis import HW, Hardware, roofline_terms


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:7.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:6.1f}ms"
    return f"{x * 1e6:6.1f}us"


def build_rows(results: Dict, mesh: str, hw: Hardware = HW):
    rows = []
    for key, cell in sorted(results.items()):
        if cell["mesh"] != mesh:
            continue
        cfg = C.get_arch(cell["arch"])
        shape = C.SHAPES[cell["shape"]]
        t = roofline_terms(cell, cfg, shape, hw)
        rows.append((cell["arch"], cell["shape"], t, cell))
    return rows


def main(argv: Optional[Sequence[str]] = None, hw: Hardware = HW) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="dryrun_results.json")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        results = json.load(f)
    rows = build_rows(results, args.mesh, hw)

    sep = "|" if args.markdown else "  "
    hdr = (f"{'arch':24s}{sep}{'shape':12s}{sep}{'compute':>9s}{sep}"
           f"{'memory':>9s}{sep}{'collect':>9s}{sep}{'bound':>8s}{sep}"
           f"{'useful':>7s}{sep}{'roofline':>8s}")
    print(hdr)
    if args.markdown:
        print("|".join(["---"] * 8))
    for arch, shape, t, cell in rows:
        print(f"{arch:24s}{sep}{shape:12s}{sep}"
              f"{fmt_s(t['compute_s']):>9s}{sep}"
              f"{fmt_s(t['memory_s']):>9s}{sep}"
              f"{fmt_s(t['collective_s']):>9s}{sep}"
              f"{t['dominant']:>8s}{sep}"
              f"{t['useful_flop_frac']:>7.3f}{sep}"
              f"{t['roofline_frac']:>8.4f}")


if __name__ == "__main__":
    main()
