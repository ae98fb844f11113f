"""``repro_torch.launch.specs`` against the JAX package's
``jax.eval_shape`` specs, for every arch at full width and depth and at
every shape of ``cells_for``: every leaf's shape and dtype, every leaf a
fake tensor (nothing allocated).

Parameters are compared leaf by leaf through the port's own mapping of
the JAX tree (``model_zoo._block_leaves``, the paths
``params_from_numpy`` fills): a scanned layer's JAX leaf carries the
periods on a leading axis.  Decode states are compared in the flat,
radix and dense modes.  The specs are built on the card's device, the
default, but for the radix decode state: PyTorch built without CUDA
cannot index a fake CUDA tensor, and ``radix_from_flat`` indexes, so
that one is built with ``device="cpu"``.
"""
import jax
import numpy as np
import pytest
import torch

from repro import config as JC
from repro.launch import specs as JSP
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import specs as SP
from repro_torch.models import model_zoo as MZ
from repro_torch.util.device import is_fake, resolve_device

ARCHS = JC.list_archs()
CELLS = [(a, s) for a in ARCHS for s in JC.cells_for(JC.get_arch(a))]


def _same(t: torch.Tensor, j, want_device: str = "cuda") -> None:
    assert is_fake(t)
    assert t.device.type == want_device
    assert tuple(t.shape) == tuple(j.shape), (t.shape, j.shape)
    assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name


def _stack_pairs(stack, tree, scfg):
    """(port parameter, JAX leaf) for every weight of a stack
    (``params_from_numpy``'s walk); a scanned layer's JAX leaf loses its
    leading period axis, which must hold ``scfg.num_periods``."""
    n_prefix, period = len(scfg.prefix_pattern), len(scfg.layer_pattern)
    for i, block in enumerate(stack.layers):
        if i < n_prefix:
            bp = tree["prefix"][i]
        else:
            bp = tree["scan"][f"block_{(i - n_prefix) % period}"]
        for path, p in MZ._block_leaves(block):
            leaf = MZ._leaf(bp, path)
            if i >= n_prefix:
                assert leaf.shape[0] == scfg.num_periods
                leaf = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
            yield p, leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match(arch):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    model = SP.param_specs(cfg)
    tree = JSP.param_specs(jcfg)
    pairs = [(model.embed, tree["embed"]),
             (model.final_norm.scale, tree["final_norm"]["scale"])]
    if model.lm_head is not None:
        pairs.append((model.lm_head, tree["lm_head"]))
    pairs += list(_stack_pairs(model.stack, tree["stack"], cfg))
    if cfg.is_encdec:
        pairs += list(_stack_pairs(model.encoder, tree["encoder"],
                                   MZ._encoder_cfg(cfg)))
        pairs.append((model.enc_norm.scale, tree["enc_norm"]["scale"]))
    for p, leaf in pairs:
        _same(p, leaf)
    # every parameter is matched, and together they hold every element
    # of the JAX tree
    assert len(pairs) == len(list(model.parameters()))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch, shape", CELLS)
def test_train_input_specs_match(arch, shape):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    got = SP.train_input_specs(cfg, C.SHAPES[shape])
    want = JSP.train_input_specs(jcfg, JC.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    tok = SP.decode_token_specs(C.SHAPES[shape])
    _same(tok, JSP.decode_token_specs(JC.SHAPES[shape]))


def _state_pairs(state, jstate, cfg):
    yield state["lengths"], jstate["lengths"], False
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    for i, st in enumerate(state["stack"]):
        if i < n_prefix:
            jst, stacked = jstate["stack"]["prefix"][i], False
        else:
            jst = jstate["stack"]["scan"][f"block_{(i - n_prefix) % period}"]
            stacked = True
        assert sorted(st) == sorted(jst)
        for k in st:
            yield st[k], jst[k], stacked
    assert ("table" in state) == ("table" in jstate)
    if isinstance(state.get("table"), BT.RadixTable):
        yield state["table"].directory, jstate["table"].directory, False
        yield state["table"].leaves, jstate["table"].leaves, False
    elif "table" in state:
        yield state["table"], jstate["table"], False
    assert ("enc_out" in state) == ("enc_out" in jstate)
    if "enc_out" in state:
        yield state["enc_out"], jstate["enc_out"], False


@pytest.mark.parametrize("kv_mode", [BT.FLAT, BT.RADIX, "dense"])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_decode_state_specs_match(arch, shape, kv_mode):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    device = "cpu" if kv_mode == BT.RADIX else "cuda"
    state = SP.decode_state_specs(cfg, C.SHAPES[shape], kv_mode,
                                  device=device)
    jstate = JSP.decode_state_specs(jcfg, JC.SHAPES[shape], kv_mode)
    assert sorted(state) == sorted(jstate)
    for t, j, stacked in _state_pairs(state, jstate, cfg):
        if stacked:
            assert j.shape[0] == cfg.num_periods
            j = jax.ShapeDtypeStruct(j.shape[1:], j.dtype)
        _same(t, j, device)


def test_fake_mode_accepts_the_card_and_nothing_else(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with SP.FAKE_MODE:
        assert resolve_device("cuda") == torch.device("cuda")
        t = torch.ones(3)
        assert is_fake(t)            # nothing made under the mode is real
        with pytest.raises(ValueError, match="meta"):
            resolve_device("meta")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    # another fake mode is not the specs' mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")


def test_specs_allocate_nothing():
    model = SP.param_specs(C.get_arch("deepseek-v2-236b"))
    n = sum(p.numel() for p in model.parameters())
    assert n > 2e11                      # 236 B parameters, no storage
    assert all(is_fake(p) for p in model.parameters())
