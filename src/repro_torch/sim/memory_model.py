"""Declarative DRAM memory-model specs — the single source of memory timing.

The port's copy of ``repro.sim.memory_model``.  Two named presets:

* ``bounded_linear`` — one flat access latency for every memory touch
  plus an aggregate bounded-linear queue (``q = service * rho * K``);
  the default, and the model every machine of the paper's figures uses.
* ``banked`` — per-bank row-buffer model: ``num_banks`` banks, each
  holding one open row of ``row_buffer_bytes``; an open-row access pays
  ``overhead + t_cas``, a closed-row one ``overhead + t_rp + t_rcd +
  t_cas``, and the queue is per bank: traffic on one bank never delays
  another.  The simulator's scan tracks each bank's open row and its
  epilogue prices each access by its own bank.

Address -> (bank, row) mapping is the open-page row-interleave over 64B
line ids::

    bank = (line / lines_per_row) % num_banks
    row  = line / (lines_per_row * num_banks)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

#: DRAM/cache line size the whole engine assumes
LINE_BYTES = 64

#: bounded-linear queue slope (cycles at rho = 1) and the saturation clip
QUEUE_K = 6.5
RHO_MAX = 0.96

KINDS = ("bounded_linear", "banked")

#: fields that are SHAPE (table layouts and hit-bit count); everything
#: else is value-only data
SHAPE_FIELDS = ("kind", "num_banks", "row_buffer_bytes")


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """One machine's memory system, declaratively.

    ``latency`` is the flat full-access latency of the bounded model;
    ``service`` is the queue service time per 64B line: aggregate for
    ``bounded_linear``, per bank for ``banked``.
    """

    kind: str = "bounded_linear"
    latency: float = 170.0          # DDR4 ~65ns @2.6GHz
    bandwidth_gbs: float = 19.2
    service: float = 14.0
    # --- banked geometry (SHAPE) ---
    num_banks: int = 16
    row_buffer_bytes: int = 2048
    # --- banked timings (DATA) ---
    t_rcd: float = 30.0             # activate (RAS-to-CAS)
    t_rp: float = 30.0              # precharge
    t_cas: float = 25.0             # column read
    overhead: float = 15.0          # controller + interconnect per access

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown memory model kind {self.kind!r}: one of {KINDS}")
        for f in ("latency", "bandwidth_gbs", "service",
                  "t_rcd", "t_rp", "t_cas", "overhead"):
            v = float(getattr(self, f))
            if v < 0.0:
                raise ValueError(f"MemoryModel.{f} must be >= 0, got {v}")
            object.__setattr__(self, f, v)
        for f in ("num_banks", "row_buffer_bytes"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.num_banks < 1:
            raise ValueError(f"num_banks must be >= 1, got {self.num_banks}")
        if (self.row_buffer_bytes < LINE_BYTES
                or self.row_buffer_bytes % LINE_BYTES):
            raise ValueError(
                f"row_buffer_bytes must be a positive multiple of "
                f"{LINE_BYTES}, got {self.row_buffer_bytes}")

    @property
    def lines_per_row(self) -> int:
        return self.row_buffer_bytes // LINE_BYTES

    def miss_latency(self) -> float:
        """Cycles for a closed-row (or bounded-model) memory access."""
        if self.kind == "banked":
            return self.overhead + self.t_rp + self.t_rcd + self.t_cas
        return self.latency

    def hit_latency(self) -> float:
        """Cycles for an open-row access (banked); = miss for bounded."""
        if self.kind == "banked":
            return self.overhead + self.t_cas
        return self.latency

    def row_hit_save(self) -> float:
        """Cycles an open-row hit saves: precharge + activate (banked);
        0.0 for bounded_linear."""
        if self.kind == "banked":
            return self.t_rp + self.t_rcd
        return 0.0

    def line_cycles(self, contiguous: bool) -> float:
        """Price of one more PTE line fetched in a multi-line refill:
        contiguous spans stream through an open row (banked)."""
        if self.kind == "banked" and contiguous:
            return self.hit_latency()
        return self.miss_latency()

    def shape_key(self) -> Tuple:
        """The SHAPE half, hashable — part of ``MachineShape``."""
        if self.kind == "banked":
            return ("banked", self.num_banks, self.row_buffer_bytes)
        return ("bounded_linear",)


#: named presets; ``banked`` is calibrated for the NDP logic-layer
#: machine (closed-row total 15 + 30 + 30 + 25 = 100 cycles, per-bank
#: service ~tRC = 117 cycles)
MEMORY_MODELS = {
    "bounded_linear": MemoryModel(),
    "banked": MemoryModel(kind="banked", latency=100.0,
                          bandwidth_gbs=307.2, service=117.0,
                          num_banks=16, row_buffer_bytes=2048,
                          t_rcd=30.0, t_rp=30.0, t_cas=25.0,
                          overhead=15.0),
}


def resolve_memory_model(spec) -> MemoryModel:
    """Normalize a ``MachineConfig.memory`` value: ``None`` -> the
    bounded_linear default, a preset name -> the registry entry, a field
    dict -> ``MemoryModel(**spec)``, a ``MemoryModel`` -> itself."""
    if spec is None:
        return MEMORY_MODELS["bounded_linear"]
    if isinstance(spec, MemoryModel):
        return spec
    if isinstance(spec, str):
        if spec not in MEMORY_MODELS:
            raise KeyError(
                f"unknown memory model preset {spec!r}: "
                f"one of {tuple(MEMORY_MODELS)}")
        return MEMORY_MODELS[spec]
    if isinstance(spec, dict):
        return MemoryModel(**spec)
    raise TypeError(
        f"MachineConfig.memory must be a MemoryModel, preset name, field "
        f"dict, or None — got {type(spec).__name__}")


def with_kind(cur: MemoryModel, name: str) -> MemoryModel:
    """Switch ``cur`` to preset ``name`` keeping the machine's own
    calibration: ``latency``/``bandwidth_gbs`` carry over; to ``banked``
    ``overhead`` is re-derived so the closed-row total equals
    ``latency``; to ``bounded_linear`` ``service`` carries over too."""
    preset = resolve_memory_model(name)
    if preset.kind == "banked":
        return dataclasses.replace(
            preset, latency=cur.latency, bandwidth_gbs=cur.bandwidth_gbs,
            overhead=max(
                cur.latency - (preset.t_rp + preset.t_rcd + preset.t_cas),
                0.0))
    return dataclasses.replace(preset, latency=cur.latency,
                               bandwidth_gbs=cur.bandwidth_gbs,
                               service=cur.service)


def bank_of(line, num_banks: int, lines_per_row: int):
    """64B line id -> bank index (row-interleaved open-page mapping)."""
    return (line // lines_per_row) % num_banks


def row_of(line, num_banks: int, lines_per_row: int):
    """64B line id -> row id within its bank."""
    return line // (lines_per_row * num_banks)


def queue_delay(rate: torch.Tensor, service) -> torch.Tensor:
    """Bounded-linear queue law ``q = service * rho * K`` with
    ``rho = clip(rate * service, 0, RHO_MAX)``, elementwise."""
    rho = torch.clamp(rate * service, 0.0, RHO_MAX)
    return service * rho * QUEUE_K
