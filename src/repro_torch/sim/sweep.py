"""Deprecated import path — the implementation lives in
``repro_torch.sim._sweep``; import :func:`sweep` / :func:`run_bucketed` /
:func:`apply_param` from :mod:`repro_torch.sim` instead."""
import warnings

from repro_torch.sim._sweep import (_RESULT_FIELDS,  # noqa: F401
                                    SweepPoint, SweepResult, apply_param,
                                    checkpoint_key, named_sweep,
                                    run_bucketed, sweep)

warnings.warn(
    "repro_torch.sim.sweep is deprecated; import sweep / run_bucketed / "
    "apply_param from repro_torch.sim instead",
    DeprecationWarning, stacklevel=2)
