"""``repro_torch.parallel.sharding`` against ``repro.parallel.sharding``.

The rules run on fake meshes (an object with ``axis_names`` and
``shape``, as ``tests/test_sharding.py``'s ``FakeMesh``), so no process
group is needed: the 16 x 16 and 2 x 16 x 16 production meshes and a
(4, 2) test mesh.  The JAX ``param_sharding`` / ``state_sharding`` wrap
each spec in a ``NamedSharding``, which needs a real mesh, so the test
replaces that wrapper with the identity and compares the specs
themselves.  Parameters: every arch at full size (the port's
``launch.specs`` fake tensors, JAX ``jax.eval_shape``) and at smoke size,
``fsdp`` on and off, each port parameter against the JAX leaf that
``params_from_numpy`` fills from (a scanned leaf's spec loses its leading
``None``, the period axis the port does not have).  Decode states: every
leaf, flat and dense modes, and the radix table.  Specs compare entry by
entry (``P`` is a tuple, as the JAX ``PartitionSpec``).
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro import config as JC
from repro.launch import specs as JSP
from repro.parallel import sharding as JSH
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import specs as SP
from repro_torch.models import init_decode_state, init_params
from repro_torch.models import model_zoo as MZ
from repro_torch.parallel import sharding as SH

ARCHS = JC.list_archs()


class FakeMesh:
    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16),
          "4x2": FakeMesh(data=4, model=2)}


@pytest.fixture(autouse=True)
def _bare_specs(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, smoke: bool):
    jcfg = JC.get_arch(arch)
    if smoke:
        jcfg = JC.smoke_variant(jcfg)
    return JSP.param_specs(jcfg)


def _port_model(arch: str, smoke: bool):
    if smoke:
        cfg = C.smoke_variant(C.get_arch(arch))
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return SP.param_specs(C.get_arch(arch), device="cpu")


def _stack_pairs(stack, tree, scfg, prefix):
    """(port name, JAX leaf, scanned) of every weight of a stack."""
    n_prefix, period = len(scfg.prefix_pattern), len(scfg.layer_pattern)
    for i, block in enumerate(stack.layers):
        scanned = i >= n_prefix
        bp = (tree["scan"][f"block_{(i - n_prefix) % period}"] if scanned
              else tree["prefix"][i])
        for path, _ in MZ._block_leaves(block):
            yield (f"{prefix}.layers.{i}.{'.'.join(path)}",
                   MZ._leaf(bp, path), scanned)


def _param_pairs(model, tree):
    cfg = model.cfg
    pairs = [("embed", tree["embed"], False),
             ("final_norm.scale", tree["final_norm"]["scale"], False)]
    if model.lm_head is not None:
        pairs.append(("lm_head", tree["lm_head"], False))
    pairs += list(_stack_pairs(model.stack, tree["stack"], cfg, "stack"))
    if cfg.is_encdec:
        pairs += list(_stack_pairs(model.encoder, tree["encoder"],
                                   MZ._encoder_cfg(cfg), "encoder"))
        pairs.append(("enc_norm.scale", tree["enc_norm"]["scale"], False))
    return pairs


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_sharding_matches_jax(arch, smoke):
    model = _port_model(arch, smoke)
    tree = _jax_params(arch, smoke)
    pairs = _param_pairs(model, tree)
    assert len(pairs) == len(list(model.parameters()))
    for mesh_name, mesh in MESHES.items():
        for fsdp in (True, False):
            cfg = dataclasses.replace(model.cfg, fsdp=fsdp)
            jcfg = dataclasses.replace(JC.get_arch(arch), fsdp=fsdp)
            got = SH.param_sharding(model, mesh, cfg)
            want = jax.tree_util.tree_map_with_path(
                lambda p, leaf: leaf, JSH.param_sharding(tree, mesh, jcfg))
            jleaves = {id(leaf): spec for leaf, spec in zip(
                jax.tree.leaves(tree), jax.tree.leaves(
                    want, is_leaf=lambda x: isinstance(x, tuple)))}
            for name, leaf, scanned in pairs:
                spec = jleaves[id(leaf)]
                if scanned:
                    assert spec[0] is None, (name, spec)
                    spec = spec[1:]
                assert got[name] == spec, (mesh_name, fsdp, name, got[name],
                                           spec)
                assert isinstance(got[name], SH.P)


def _state_pairs(state, jstate, specs, jspecs, cfg):
    """(port spec, JAX spec, scanned, leaf name) of every state leaf."""
    yield specs["lengths"], jspecs["lengths"], False, "lengths"
    n_prefix, period = len(cfg.prefix_pattern), len(cfg.layer_pattern)
    for i, st in enumerate(specs["stack"]):
        if i < n_prefix:
            jst, scanned = jspecs["stack"]["prefix"][i], False
        else:
            jst = jspecs["stack"]["scan"][f"block_{(i - n_prefix) % period}"]
            scanned = True
        assert sorted(st) == sorted(jst)
        for k in st:
            yield st[k], jst[k], scanned, k
    if isinstance(specs.get("table"), BT.RadixTable):
        yield (specs["table"].directory, jspecs["table"].directory, False,
               "directory")
        yield specs["table"].leaves, jspecs["table"].leaves, False, "leaves"
    elif "table" in specs:
        yield specs["table"], jspecs["table"], False, "table"
    if "enc_out" in specs:
        yield specs["enc_out"], jspecs["enc_out"], False, "enc_out"


@pytest.mark.parametrize("kv_mode", [BT.FLAT, BT.RADIX, "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_sharding_matches_jax(arch, kv_mode):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    shape = dataclasses.replace(C.SHAPES["decode_32k"], global_batch=32,
                                seq_len=1024)
    jshape = dataclasses.replace(JC.SHAPES["decode_32k"], global_batch=32,
                                 seq_len=1024)
    state = SP.decode_state_specs(cfg, shape, kv_mode, device="cpu")
    jstate = JSP.decode_state_specs(jcfg, jshape, kv_mode)
    n = 0
    for mesh in MESHES.values():
        specs = SH.state_sharding(state, mesh, cfg)
        jspecs = JSH.state_sharding(jstate, mesh, jcfg)
        for got, want, scanned, name in _state_pairs(state, jstate, specs,
                                                     jspecs, cfg):
            if scanned:
                assert want[0] is None
                want = want[1:]
            assert got == want, (name, got, want)
            n += 1
    assert n > 3 * 2


@pytest.mark.parametrize("n_pages", [1024, 1 << 20])
def test_qhead_strategy_both_sides_of_the_budget(n_pages):
    """gemma3-1b's MQA pool (4 / 1 heads of 256) fits the per-device
    budget at 1,024 pages of 64 and not at 2^20: query-head mode, then
    head_dim mode, for the pools' storage rule too."""
    mesh = MESHES["4x2"]
    cfg, jcfg = C.get_arch("gemma3-1b"), JC.get_arch("gemma3-1b")
    kw = dict(h=cfg.num_heads, kh=cfg.num_kv_heads, hd=cfg.head_dim,
              n_attn_layers=SH._n_attn_layers(cfg), n_pages=n_pages,
              page=64)
    got = SH.qhead_strategy(mesh, **kw)
    assert got == JSH.qhead_strategy(mesh, **kw)
    assert got == (n_pages == 1024)
    assert SH._n_attn_layers(cfg) == JSH._n_attn_layers(jcfg)
    shape = (n_pages, 64, cfg.num_kv_heads, cfg.head_dim)
    batch = SH.batch_axes(mesh)
    assert SH._state_rule("kp", shape, mesh, batch, cfg) == \
        JSH._state_rule("kp", shape, mesh, batch, False, jcfg)
    assert SH.paged_mode(mesh, cfg, n_pages=n_pages, page=64) == (
        "qhead" if got else "hd")
    assert SH.QHEAD_POOL_BUDGET == JSH.QHEAD_POOL_BUDGET


VALID_CASES = [
    (("model",), (3,)), (("model",), (4,)), ((("data", "model"),), (8,)),
    ((("data", "model"),), (4,)), (("data", "model"), (8, 7)),
    (("model",), (40,)), (("model",), (1,)), (("data", None, "model"),
                                              (6, 5, 3)),
    ((("data", "model"), "model"), (12, 4)), (("pod", "data"), (4, 4)),
]


@pytest.mark.parametrize("allow_uneven", [False, True])
@pytest.mark.parametrize("spec, shape", VALID_CASES)
def test_valid_spec_matches_jax(spec, shape, allow_uneven):
    for mesh in (MESHES["4x2"], FakeMesh(data=4, model=16),
                 MESHES["2x16x16"]):
        got = SH.valid_spec(spec, shape, mesh, allow_uneven)
        want = JSH.valid_spec(JSH.P(*spec), shape, mesh, allow_uneven)
        assert got == want, (spec, shape, got, want)
        assert isinstance(got, tuple)


def test_rule_table_and_helpers_match_jax():
    mesh = MESHES["2x16x16"]
    assert SH.batch_axes(mesh) == JSH.batch_axes(mesh) == ("pod", "data")
    assert SH.batch_axes(MESHES["4x2"]) == ("data",)
    names = ["embed", "lm_head", "wq", "wk", "wv", "wo", "w_dq", "w_dkv",
             "w_uq", "w_uk", "w_uv", "router", "w_up", "w_gate", "w_down",
             "w_k", "w_v", "in_proj", "conv_w", "conv_b", "x_proj", "A_log",
             "D", "dt_proj", "out_proj", "w_r", "w_g", "w_o", "w_A", "w_B",
             "scale", "bias"]
    for parent in ("mixer", "ffn", "shared"):
        for name in names:
            for ndim in (1, 2, 3):
                for fsdp in (True, False):
                    assert SH._rule_for((parent, name), ndim, fsdp) == \
                        JSH._rule_for((parent, name), ndim, fsdp)


def test_block_and_shard_state_follow_the_specs():
    """A rank's block of a whole decode state (``shard_state``) has the
    shapes ``init_decode_state`` builds for that rank under the mesh
    rule: the pools of smoke internlm2 (2 kv heads) split over model 2,
    the batch over data 2."""
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              dtype="float32")
    mesh = FakeMesh(data=2, model=2)
    state = init_decode_state(cfg, 4, 32, BT.FLAT, 8, device="cpu")
    for d in range(2):
        for m in range(2):
            local = SH.shard_state(state, mesh, cfg, {"data": d, "model": m})
            kp = state["stack"][0]["kp"]
            assert local["stack"][0]["kp"].shape == (kp.shape[0] // 2, 8, 1,
                                                     16)
            assert torch.equal(local["stack"][0]["kp"],
                               kp[d * 8:(d + 1) * 8, :, m:m + 1])
            assert local["lengths"].shape == (2,)
            assert local["table"].shape == (2, state["table"].shape[1])
    assert SH.block((8, 6), SH.P(("data", "model"), None), mesh,
                    {"data": 1, "model": 0}) == (slice(4, 6), slice(0, 6))
    with pytest.raises(ValueError, match="does not split"):
        SH.block((3,), SH.P("model"), mesh, {"model": 1})


def _names(placements):
    return [(type(p).__name__, getattr(p, "dim", None)) for p in placements]


def _rank_constrain(rank, world):
    """On a (2, 2) test mesh: ``constrain`` of a whole tensor and of a
    DTensor, ``constrain_act`` under the mesh (a plain tensor passes
    through; an uneven batch split is allowed there)."""
    from repro_torch.launch import mesh as LM
    from repro_torch.parallel.context import BATCH, constrain_act, use_mesh

    mesh = LM.make_test_mesh(world)
    x = torch.arange(48.0).reshape(8, 6)
    d = SH.constrain(x, mesh, "data", "model")
    out = {"both": tuple(d.to_local().shape),
           "whole": torch.equal(d.full_tensor(), x),
           "placements": _names(d.placements)}
    out["model"] = tuple(SH.constrain(d, mesh, None, "model")
                         .to_local().shape)
    out["dropped"] = _names(SH.constrain(
        torch.ones(3, 5), mesh, "data", "model").placements)
    with use_mesh(mesh):
        out["plain"] = constrain_act(x, BATCH, "model") is x
        out["act"] = tuple(constrain_act(d, BATCH, None).to_local().shape)
        odd = SH.constrain(torch.ones(3, 6), mesh, None, None)
        out["uneven"] = tuple(constrain_act(odd, BATCH).to_local().shape)
    out["no_mesh"] = constrain_act(d, BATCH) is d
    out["coords"] = SH.axis_coords(mesh)
    return out


@pytest.fixture(scope="module")
def constrained():
    from repro_torch.launch import mesh as LM
    return LM.spawn(_rank_constrain, 4)


def test_constrain_lays_out_dtensors(constrained):
    for rank, out in enumerate(constrained):
        assert out["coords"] == {"data": rank // 2, "model": rank % 2}
        assert out["both"] == (4, 3) and out["whole"]
        assert out["placements"] == [("Shard", 0), ("Shard", 1)]
        assert out["model"] == (8, 3)
        # 3 x 5 divides neither axis: replicated on both
        assert out["dropped"] == [("Replicate", None), ("Replicate", None)]


def test_constrain_act_follows_the_installed_mesh(constrained):
    for rank, out in enumerate(constrained):
        assert out["plain"] and out["no_mesh"]
        assert out["act"] == (4, 6)
        # 3 rows over data 2 with allow_uneven: torch.chunk's 2 + 1
        assert out["uneven"] == ((2, 6) if rank // 2 == 0 else (1, 6))
