"""Deprecated import path: the implementation lives in
``repro_torch.serving._scheduler``; import :class:`BatchScheduler` /
:class:`Request` from :mod:`repro_torch.serving` instead."""
import warnings

from repro_torch.serving._scheduler import (BatchScheduler,  # noqa: F401
                                            Request)

warnings.warn(
    "repro_torch.serving.scheduler is deprecated; import BatchScheduler / "
    "Request from repro_torch.serving instead",
    DeprecationWarning, stacklevel=2)
