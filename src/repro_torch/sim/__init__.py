"""Trace-driven translation simulator of the port (the paper's experiment).

The port of ``repro.sim``: set-associative caches, TLBs and page-walk
caches as per-chunk LRU tables, scanned by a hand-written CUDA kernel on
the card (``kernels/csrc/lru_scan.cu``) and by a plain PyTorch step loop
on the CPU; a vectorized timing epilogue (a hand-written CUDA kernel on
the card, torch ops on the CPU); a queueing memory model, bounded-linear
or banked DRAM with per-bank open rows; the standalone LRU model
(:mod:`repro_torch.sim.cache_model`); the declarative registry of
translation mechanisms (:mod:`repro_torch.sim.mechanisms`), evaluated
together along a mechanism axis — the paper's five by default; the
sensitivity-sweep engine (:func:`sweep`, :func:`run_bucketed`) and the
design-space search (:func:`search`), both on the same two kernels.  The
JAX package's cost model and costed serving are not ported yet (ROADMAP
module item 6).

This facade is the public import surface of the simulator layer; the
sweep and search modules are private (``_sweep`` / ``_search``), and the
``repro_torch.sim.sweep`` / ``repro_torch.sim.search`` paths are shims
that warn on import (``python -m repro_torch.sim.search`` runs the CLI).
"""
from repro_torch.sim.mechanisms import (DEFAULT_MECHS, MechanismSpec,  # noqa: F401
                                        register)
from repro_torch.sim.memory_model import (MEMORY_MODELS,  # noqa: F401
                                          MemoryModel)
from repro_torch.sim.simulator import (MachineShape, SimJob,  # noqa: F401
                                       SimResult, machine_shape,
                                       runner_cache_info, simulate,
                                       simulate_batch, simulate_batch_varied)
from repro_torch.sim._search import (SearchResult, SearchSpace,  # noqa: F401
                                     search)
from repro_torch.sim._sweep import (SweepResult, apply_param,  # noqa: F401
                                    run_bucketed, sweep)
