"""``step_flops`` over every cell of granite-34b and internvl2-76b (see
``test_torch_step_flops.py``, whose check this is)."""
import pytest

from test_torch_step_flops import cells, check_cell


@pytest.mark.parametrize("arch, shape", cells("granite-34b", "internvl2-76b"))
def test_step_flops_cell(arch, shape, monkeypatch):
    check_cell(arch, shape, monkeypatch)
