"""``roofline.flop_stats.step_flops`` completes for every arch x
``cells_for`` cell at full width and depth, on fake tensors, without
walking a plain scan: the plain versions of the kernels raise if called,
and each cell records exactly the hand kernels its path runs.

Fake tensors cost the Python dispatch of every op and no arithmetic: a
train step of the deepest configs (deepseek-v2 at 60 layers, jamba at
72) takes 20-30 s on one CPU worker here.  So the cells are spread over
``test_torch_step_flops*.py`` by arch, each file well within 60 s;
:func:`check_cell` is their one check.
"""
import pytest

from repro_torch import config as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.models.attention import BLOCKWISE_THRESHOLD
from repro_torch.roofline.flop_stats import step_flops

PLAIN = ("flash_attention_ref", "paged_attention_ref", "selective_scan_ref",
         "wkv_ref")


def cells(*archs):
    return [(a, s) for a in archs for s in C.cells_for(C.get_arch(a))]


def expected_kernels(cfg, shape) -> set:
    """The hand kernels the port's path runs for the cell."""
    kinds = {m for m, _ in cfg.layer_kinds()}
    directions = {"train": ("fwd", "bwd"), "prefill": ("fwd",),
                  "decode": ()}[shape.kind]
    out = set()
    attn = kinds & {C.ATTN, C.ATTN_LOCAL, C.ATTN_MLA}
    if attn and shape.kind != "decode" and shape.seq_len > BLOCKWISE_THRESHOLD:
        d = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
             if C.ATTN_MLA in attn else cfg.head_dim)
        route = FA._route(cfg.torch_dtype, d)
        out |= {f"flash_attention_{route}_{x}" for x in directions}
    if shape.kind == "decode" and kinds & {C.ATTN, C.ATTN_LOCAL}:
        out.add("paged_attention")
    if C.MAMBA in kinds:
        out |= {f"selective_scan_{x}" for x in directions}
    if C.RWKV in kinds:
        out |= {f"wkv_{x}" for x in directions}
    return out


def check_cell(arch: str, shape_name: str, monkeypatch) -> None:
    def walked(*args, **kwargs):
        raise AssertionError("a plain version ran on fake tensors")

    for name in PLAIN:
        monkeypatch.setattr(ref, name, walked)
    cfg, shape = C.get_arch(arch), C.SHAPES[shape_name]
    got = step_flops(cfg, shape, device="cpu")
    kernels = {k for k in got if not k.startswith("aten.") and k != "total"}
    assert kernels == expected_kernels(cfg, shape)
    assert all(isinstance(v, int) and v > 0 for v in got.values())
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert got.get("aten.mm", 0) + got.get("aten.bmm", 0) > 0


@pytest.mark.parametrize("arch, shape", cells(
    "internlm2-1.8b", "gemma3-1b", "phi3-medium-14b", "whisper-tiny",
    "granite-moe-1b-a400m"))
def test_step_flops_cell(arch, shape, monkeypatch):
    check_cell(arch, shape, monkeypatch)
