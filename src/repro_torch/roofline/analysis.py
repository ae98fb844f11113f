"""Three-term roofline of a dry-run cell (counterpart of
``repro.roofline.analysis``, the same arithmetic and record keys).

    compute    = flops / peak_FLOP/s
    memory     = bytes_accessed / HBM_bw
    collective = collective_bytes / link_bw

The default :class:`Hardware` is one NVIDIA H100 SXM from its data sheet
(dense, at the 700 W limit): 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s
NVLink each way.  ``model_flops`` is the 6 N D rule (6 N_active D for
MoE) for a train step, 2 N D for a prefill or a decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch import config as C


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12        # bf16 / card
    hbm_bw: float = 3.35e12           # bytes/s per card
    ici_bw: float = 450e9             # bytes/s per link (NVLink, each way)


HW = Hardware()


def model_flops(cfg: C.ArchConfig, shape: C.ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (prefill, decode) with N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch                   # one token per sequence
    return 2.0 * n * tokens


def roofline_terms(cell: Dict, cfg: Optional[C.ArchConfig] = None,
                   shape: Optional[C.ShapeConfig] = None,
                   hw: Hardware = HW) -> Dict[str, float]:
    """cell: one dry-run results record.  Returns the terms in seconds,
    per device (the record's numbers are a device's already)."""
    t_compute = cell["flops"] / hw.peak_flops
    t_memory = cell["bytes_accessed"] / hw.hbm_bw
    t_coll = cell["collective_bytes"] / hw.ici_bw
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
    }
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    bound = max(terms.values())
    out = dict(terms)
    out["dominant"] = dominant.replace("_s", "")
    out["step_lower_bound_s"] = bound
    if cfg is not None and shape is not None:
        chips = 512 if cell["mesh"] == "2x16x16" else 256
        mf = model_flops(cfg, shape) / chips      # per-device useful flops
        out["model_flops_per_device"] = mf
        out["useful_flop_frac"] = (mf / cell["flops"]) if cell["flops"] else 0
        # useful work at peak over the least step time
        out["roofline_frac"] = (mf / hw.peak_flops) / bound if bound else 0.0
    return out
