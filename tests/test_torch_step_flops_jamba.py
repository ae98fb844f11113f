"""``step_flops`` over every cell of jamba-1.5-large-398b (see
``test_torch_step_flops.py``, whose check this is)."""
import pytest

from test_torch_step_flops import cells, check_cell


@pytest.mark.parametrize("arch, shape", cells("jamba-1.5-large-398b"))
def test_step_flops_cell(arch, shape, monkeypatch):
    check_cell(arch, shape, monkeypatch)
