"""The serving layer's public import surface.

``ServeEngine`` / ``BatchScheduler`` run the real model at small batch;
``FleetEngine`` / ``FleetScheduler`` are the same serving design at
fleet scale (thousands of live sequences, struct-of-arrays scheduling,
prefix sharing, translation-aware admission).  Build requests with
:meth:`Request.build`.

Import from this package: ``_engine`` and ``_scheduler`` are private.
"""
from repro_torch.serving._engine import (ServeEngine,  # noqa: F401
                                         greedy_reference, shard_requests)
from repro_torch.serving._scheduler import (BatchScheduler,  # noqa: F401
                                            Request)
from repro_torch.serving.fleet import (FleetEngine,  # noqa: F401
                                       FleetScheduler)
