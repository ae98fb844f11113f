"""``step_flops`` over every cell of rwkv6-3b, long_500k included (see
``test_torch_step_flops.py``, whose check this is)."""
import pytest

from test_torch_step_flops import cells, check_cell


@pytest.mark.parametrize("arch, shape", cells("rwkv6-3b"))
def test_step_flops_cell(arch, shape, monkeypatch):
    check_cell(arch, shape, monkeypatch)
