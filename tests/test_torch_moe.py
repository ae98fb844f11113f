"""The port's routed mixture of experts (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe``, on the same weights
(``moe_init`` of the JAX package, copied into the port's module) and
the same inputs (numpy, from a seed), in float32.

The JAX ``_route_group`` returns only its output and aux loss, so the
tests record the live function's dispatch and combine tensors where it
hands them to ``jnp.einsum``: the routed experts and queue positions
(integers) must give the same dispatch exactly, and the routed experts
must be ``lax.top_k``'s.  Outputs, combine weights and the aux loss are
held to 2e-5 (float32 sums over D and the experts in other orders);
gradients to the ROADMAP's model tolerance 1e-4 (each sums 1,024 tokens'
products, of magnitudes up to about 70 here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import moe as JM
from repro_torch import config as C
from repro_torch.models import moe as M

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(name, **changes):
    """(JAX cfg, port cfg) at smoke width in float32."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(name)), dtype="float32",
                               **changes)
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(name)),
                              dtype="float32", **changes)
    return jcfg, cfg


def _pair(jcfg, cfg, seed=0, router=None):
    """JAX params and the port's MoE holding the same weights; ``router``
    replaces the router's weights in both."""
    p = JM.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if router is not None:
        p["router"] = jnp.asarray(router, jnp.float32)
    mod = M.MoE(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, value in p.items():
            if name == "shared":
                for n, v in value.items():
                    getattr(mod.shared, n).copy_(torch.tensor(np.asarray(v)))
            else:
                getattr(mod, name).copy_(torch.tensor(np.asarray(value)))
    return p, mod


class _Recorder:
    """``jnp`` with its einsum recording each call's first operand."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self._log.setdefault(spec, []).append(np.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)


def _live_group(monkeypatch, p, xg, jcfg):
    """The JAX _route_group on one group: (out, aux, dispatch (G, E, C),
    combine (G, E, C))."""
    log = {}
    monkeypatch.setattr(JM, "jnp", _Recorder(log))
    out, aux = JM._route_group(p, jnp.asarray(xg), jcfg)
    monkeypatch.setattr(JM, "jnp", jnp)
    return (np.asarray(out), float(aux), log["gec,gd->ecd"][0],
            log["gec,ecd->gd"][0].astype(np.float32))


def _hold_group(monkeypatch, jcfg, cfg, p, mod, xg):
    """One group through both packages: dispatch exactly, combine, output
    and aux to TOL, the experts lax.top_k's.  Returns the port's keep."""
    jout, jaux, jdisp, jcomb = _live_group(monkeypatch, p, xg, jcfg)
    x = torch.tensor(xg)[None]
    probs, top_p, top_i, pos, keep = M.route(mod, x, cfg)
    disp, comb = M._dispatch_combine(top_p, top_i, pos, keep,
                                     cfg.moe.num_experts,
                                     M.capacity(cfg, xg.shape[0]), x.dtype)
    np.testing.assert_array_equal(disp[0].numpy(), jdisp)
    np.testing.assert_allclose(comb[0].numpy(), jcomb, **TOL)
    jprobs = jax.nn.softmax(jnp.asarray(xg) @ p["router"], axis=-1)
    _, jtop = jax.lax.top_k(jprobs, cfg.moe.num_experts_per_tok)
    np.testing.assert_array_equal(top_i[0].numpy(), np.asarray(jtop))
    out, aux = M._route_groups(mod, x, cfg)
    np.testing.assert_allclose(out[0].numpy(), jout, **TOL)
    np.testing.assert_allclose(float(aux[0]), jaux, **TOL)
    return keep[0]


@pytest.mark.parametrize("name,changes", [
    ("granite-moe-1b-a400m", {}),
    ("deepseek-v2-236b", {}),
    ("granite-moe-1b-a400m", {"gated_ffn": False}),
], ids=["gated", "shared", "gelu"])
@pytest.mark.parametrize("g", [16, 64, 512])
def test_route_group_matches(monkeypatch, name, changes, g):
    """Dropless groups (g <= 64: the capacity is g) and a 512-token
    group at capacity-factor routing; gated experts, a shared expert
    (deepseek-v2) and GELU experts."""
    jcfg, cfg = _cfgs(name, **changes)
    p, mod = _pair(jcfg, cfg)
    xg = np.random.default_rng(g).standard_normal((g, cfg.d_model),
                                                  np.float32)
    keep = _hold_group(monkeypatch, jcfg, cfg, p, mod, xg)
    assert M.capacity(cfg, g) == (g if g <= 64 else int(g * 2 * 1.25 / 4))
    if g <= 64:
        assert bool(keep.all())


def test_capacity_overflow_drops_the_same_tokens(monkeypatch):
    """A router skewed to expert 0 sends every token there first: its
    queue passes the 320 places of a 512-token group, and the tokens past
    them are dropped, the same ones in both packages."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    rng = np.random.default_rng(5)
    router = rng.standard_normal((cfg.d_model, 4)).astype(np.float32) * 0.1
    router[:, 0] = 0.5
    p, mod = _pair(jcfg, cfg, router=router)
    xg = (rng.standard_normal((512, cfg.d_model)) + 1.0).astype(np.float32)
    keep = _hold_group(monkeypatch, jcfg, cfg, p, mod, xg)
    assert M.capacity(cfg, 512) == 320
    dropped = int((~keep).sum())
    assert dropped >= 512 - 320
    # the tokens dropped are the last to queue: token-major, then slot
    _, _, top_i, pos, _ = M.route(mod, torch.tensor(xg)[None], cfg)
    first = top_i[0] == 0
    assert bool((pos[0][first] == torch.arange(int(first.sum()))).all())


def test_zero_router_pins_the_tie_order(monkeypatch):
    """A router of zeros makes every probability 1/E: lax.top_k takes
    the lower indices first, and so must the port (torch.topk promises no
    order on ties)."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    p, mod = _pair(jcfg, cfg, router=np.zeros((cfg.d_model, 4), np.float32))
    xg = np.random.default_rng(9).standard_normal((96, cfg.d_model),
                                                  np.float32)
    _hold_group(monkeypatch, jcfg, cfg, p, mod, xg)
    _, top_p, top_i, pos, keep = M.route(mod, torch.tensor(xg)[None], cfg)
    k = cfg.moe.num_experts_per_tok
    assert bool((top_i[0] == torch.arange(k)).all())
    np.testing.assert_allclose(top_p.numpy(), 1.0 / k, **TOL)
    # experts 0 and 1 queue every token in order; 96 > 64: capacity 60
    assert M.capacity(cfg, 96) == 60
    assert pos[0, :, 0].tolist() == list(range(96))
    assert int(keep.sum()) == 2 * 60


@pytest.mark.parametrize("b,s", [(2, 8), (1, 512), (2, 512), (4, 256)])
def test_moe_apply_matches(b, s):
    """moe_apply over one group and over several (the JAX package's
    lax.scan over groups, here one leading axis): output and the mean of
    the groups' aux losses."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    p, mod = _pair(jcfg, cfg, seed=1)
    x = np.random.default_rng(b * s).standard_normal((b, s, cfg.d_model),
                                                     np.float32)
    jout, jaux = JM.moe_apply(p, jnp.asarray(x), jcfg)
    out, aux = M.moe_apply(mod, torch.tensor(x), cfg)
    assert out.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_moe_gradients_match():
    """Gradients of a loss through routing (the router through top_p and
    the aux loss), the experts and the shared expert."""
    jcfg, cfg = _cfgs("deepseek-v2-236b")
    p, mod = _pair(jcfg, cfg, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 512, cfg.d_model),
                                                 np.float32)
    w = np.random.default_rng(4).standard_normal((2, 512, cfg.d_model),
                                                 np.float32)

    def jloss(params, xx):
        out, aux = JM.moe_apply(params, xx, jcfg)
        return jnp.sum(out * w) + 3.0 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    mod.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = M.moe_apply(mod, xt, cfg)
    (torch.sum(out * torch.tensor(w)) + 3.0 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for name in ("router", "w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(),
                                   np.asarray(jg[name]), **GRAD_TOL,
                                   err_msg=name)
    for name in ("w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(getattr(mod.shared, name).grad.numpy(),
                                   np.asarray(jg["shared"][name]),
                                   **GRAD_TOL, err_msg=f"shared.{name}")


def test_moe_apply_refuses_ragged_groups():
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    _, mod = _pair(jcfg, cfg)
    with pytest.raises(ValueError, match="groups of 512"):
        M.moe_apply(mod, torch.zeros(1, 600, cfg.d_model), cfg)


def test_router_is_float32_in_a_bf16_model():
    cfg = C.smoke_variant(C.get_arch("deepseek-v2-236b"))
    assert cfg.dtype == "bfloat16"
    mod = M.MoE(cfg, cfg.torch_dtype, torch.device("cpu"),
                torch.Generator().manual_seed(0))
    assert mod.router.dtype == torch.float32
    assert mod.w_up.dtype == mod.shared.w_up.dtype == torch.bfloat16
    assert mod.w_up.shape == (4, 64, 32) and mod.w_down.shape == (4, 32, 64)
    assert mod.shared.w_up.shape == (64, 32)
    out, aux = M.moe_apply(mod, torch.randn(1, 8, 64).to(torch.bfloat16),
                           cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
