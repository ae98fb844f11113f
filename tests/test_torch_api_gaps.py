"""The single-device API gaps the port closed beside the JAX package:
the serve launcher's ``--kv-mode dense`` (served as ``auto``, as the
JAX launcher does) and the deprecated import paths
``repro_torch.serving.engine`` and ``repro_torch.serving.scheduler``."""
import importlib
import sys

import pytest

from repro_torch import serving
from repro_torch.launch import serve as SERVE


def _tokens(out):
    return {r.req_id: list(r.generated) for r in out["done"]}


def test_kv_mode_dense_is_served_as_auto(capsys):
    argv = ["--local-smoke", "--device", "cpu", "--requests", "4"]
    auto = SERVE.main(argv + ["--kv-mode", "auto"])
    dense = SERVE.main(argv + ["--kv-mode", "dense"])
    assert _tokens(dense) == _tokens(auto)
    assert len(dense["done"]) == 4
    assert dense["engine"].sched.table_mode is None
    assert dense["engine"].sched.stats == auto["engine"].sched.stats
    assert capsys.readouterr().out.count("served 4 requests") == 2


@pytest.mark.parametrize("name, names", [
    ("engine", ("ServeEngine", "greedy_reference")),
    ("scheduler", ("BatchScheduler", "Request")),
])
def test_deprecated_serving_paths_warn_and_reexport(name, names):
    full = f"repro_torch.serving.{name}"
    sys.modules.pop(full, None)
    with pytest.warns(DeprecationWarning, match=full):
        mod = importlib.import_module(full)
    for attr in names:
        assert getattr(mod, attr) is getattr(serving, attr)
