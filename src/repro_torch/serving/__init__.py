"""The serving layer's public import surface.

``ServeEngine`` / ``BatchScheduler`` run the real model at small batch.
Build requests with :meth:`Request.build`.  The fleet engine waits for
its slice.
"""
from repro_torch.serving._engine import (ServeEngine,  # noqa: F401
                                         greedy_reference)
from repro_torch.serving._scheduler import (BatchScheduler,  # noqa: F401
                                            Request)
