"""Trace-driven translation simulator of the port (the paper's experiment).

The port of ``repro.sim``: set-associative caches, TLBs and page-walk
caches as per-chunk LRU tables, scanned by a hand-written CUDA kernel on
the card (``kernels/csrc/lru_scan.cu``) and by a plain PyTorch step loop
on the CPU; a vectorized timing epilogue (a hand-written CUDA kernel on
the card, torch ops on the CPU); a queueing memory model, bounded-linear
or banked DRAM with per-bank open rows; the standalone LRU model
(:mod:`repro_torch.sim.cache_model`); and the declarative registry of
translation mechanisms (:mod:`repro_torch.sim.mechanisms`), evaluated
together along a mechanism axis — the paper's five by default.  The
sweep, search and cost model of the JAX package are not ported yet
(ROADMAP module item 6).
"""
from repro_torch.sim.mechanisms import (DEFAULT_MECHS, MechanismSpec,  # noqa: F401
                                        register)
from repro_torch.sim.memory_model import (MEMORY_MODELS,  # noqa: F401
                                          MemoryModel)
from repro_torch.sim.simulator import (MachineShape, SimJob,  # noqa: F401
                                       SimResult, machine_shape, simulate,
                                       simulate_batch, simulate_batch_varied)
