"""Deprecated import path — the implementation lives in
``repro_torch.sim._search``; import :func:`search` / :class:`SearchSpace`
from :mod:`repro_torch.sim` instead.  ``python -m repro_torch.sim.search``
is the CLI and stays warning-free (running as ``__main__`` is not an
import off the old path):

  python -m repro_torch.sim.search [--quick|--space S] [--device cpu]
"""
import sys
import warnings

from repro_torch.sim._search import (OBJECTIVES,  # noqa: F401
                                     Candidate, SearchResult, SearchSpace,
                                     build_machine, dominates,
                                     evaluate_genomes, merge_search_section,
                                     pareto_indices, resolve_space, search)

if __name__ != "__main__":
    warnings.warn(
        "repro_torch.sim.search is deprecated; import search / SearchSpace "
        "from repro_torch.sim instead",
        DeprecationWarning, stacklevel=2)

if __name__ == "__main__":               # pragma: no cover
    from repro_torch.sim._search import _main
    sys.exit(_main())
