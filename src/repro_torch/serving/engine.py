"""Deprecated import path: the implementation lives in
``repro_torch.serving._engine``; import :class:`ServeEngine` /
:func:`greedy_reference` from :mod:`repro_torch.serving` instead."""
import warnings

from repro_torch.serving._engine import (ServeEngine,  # noqa: F401
                                         greedy_reference)

warnings.warn(
    "repro_torch.serving.engine is deprecated; import ServeEngine / "
    "greedy_reference from repro_torch.serving instead",
    DeprecationWarning, stacklevel=2)
