"""RWKV6 on the port against the JAX package, on the CPU: the config and
its leaves, the WKV recurrence's plain forward and its backward as the
kernel computes it (``ref.wkv_ref``, ``ref.wkv_bwd_ref``) against the
JAX ``step`` under ``chunked_scan``, autograd and ``jax.grad``, the
recurrence's dispatch (a CUDA tensor reaches the kernel, never the plain
version), the time-mix block (``models/rwkv.py``) against
``repro.models.rwkv`` on the same weights, rwkv6-3b's model at smoke
width (``forward_train``, a train step, decode), and the serving engine
against the JAX engine and the JAX ``greedy_reference``.

Smoke width (``smoke_variant``: d_model 64, head size 16, 4 heads,
decay lora 8, 2 layers), float32.  The recurrence and the block are
held to rtol = atol = 2e-5 and 1e-5 (both packages sum in float32 in
other orders: the einsum over the state, the projections); gradients to
the same bound of each gradient's largest element (a weight's gradient
sums over every token, and its rounding scales with its largest terms,
not with the element).  At slow decay (``w0`` -6) the forward too is
held to 2e-5 of its largest element: outputs near 0 come from float32
sums of terms in the tens there.  The model's logits, losses and
gradients to rtol = atol = 1e-4 (several layers and the vocabulary
projection).  Generated tokens exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.models.scan_utils import chunked_scan
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import greedy_reference as jgreedy_reference
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv as WK
from repro_torch.launch import serve as LS
from repro_torch.launch import train as LT
from repro_torch.models import (forward_train, init_params,
                                params_from_numpy, params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models.model_zoo import Model
from repro_torch.serving import Request, ServeEngine, greedy_reference
from repro_torch.train import data as D
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import (TrainState, loss_fn,
                                          make_train_step, trainable)
from repro_torch.util import resilience

NAME = "rwkv6-3b"
#: the recurrence against the JAX step, and its gradients (of scale)
WKV_TOL = 2e-5
#: the time-mix block against the JAX block, and its gradients (of scale)
TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = 1e-5
#: the model: logits, losses, gradients and weights after a step
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_len=48, page_size=8)
#: AdamW's eps in the two-step comparison, both sides alike (as the
#: variants file does for jamba): the channel mix's relu^2 leaves some
#: units of ``w_k`` and some embedding rows with second-step gradients
#: near zero, float32 summation noise of the two packages (the gradients
#: themselves agree to 1e-4 in the test), and at eps 1e-8 or 1e-6 Adam's
#: m / (sqrt(v) + eps) turns that noise into weight differences of 5.4e-4
#: and 1.9e-4.  At 1e-4 the same noise moves a weight by under 1e-4, and
#: a wrong gradient of any element still moves it past 1e-4
ADAM_EPS = 1e-4


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, JAX params, numpy tree, port model) of
    rwkv6-3b at smoke width in float32."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(NAME)), dtype="float32")
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(NAME)),
                              dtype="float32")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_numpy(cfg, tree, "cpu")


def _rwkv_pair():
    """The first layer's JAX time-mix leaves and the port's block on
    them."""
    jcfg, cfg, jparams, _, _ = _setup()
    jp = jax.tree.map(lambda a: a[0],
                      jparams["stack"]["scan"]["block_0"]["mixer"])
    m = R.RWKV(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.tensor(np.asarray(jp[name])))
    return jcfg, cfg, jp, m


def _wkv_inputs(b, s, h, hs, seed, w0=-0.5):
    """WKV operands at an RWKV layer's scale: r, k, v, do normal, w =
    exp(-exp(w0 + 0.5 n)) (a decay lora's spread), u 0.1 n
    (``rwkv_init``'s)."""
    rng = np.random.default_rng(seed)
    d = h * hs
    arrays = dict(r=rng.standard_normal((b, s, d)),
                  k=rng.standard_normal((b, s, d)),
                  v=rng.standard_normal((b, s, d)),
                  w=np.exp(-np.exp(w0 + 0.5 * rng.standard_normal(
                      (b, s, d)))),
                  u=0.1 * rng.standard_normal((h, hs)),
                  do=rng.standard_normal((b, s, d)))
    return arrays, {k: torch.tensor(v, dtype=torch.float32)
                    for k, v in arrays.items()}


def _args(t):
    return [t[k] for k in ("r", "k", "v", "w", "u")]


def _jax_wkv(r, k, v, w, u):
    """The JAX package's recurrence: ``rwkv_apply``'s ``step`` under
    ``chunked_scan`` (``src/repro/models/rwkv.py:105-111``)."""
    b, s, d = r.shape
    nh, hs = u.shape

    def step(state, inp):
        r_t, k_t, v_t, w_t = inp
        a_t = k_t[..., :, None] * v_t[..., None, :]
        o_t = jnp.einsum("bhi,bhij->bhj", r_t,
                         state + u[None, :, :, None] * a_t)
        return w_t[..., :, None] * state + a_t, o_t

    xs = tuple(x.reshape(b, s, nh, hs).swapaxes(0, 1) for x in (r, k, v, w))
    _, os_ = chunked_scan(step, jnp.zeros((b, nh, hs, hs), jnp.float32), xs)
    return os_.swapaxes(0, 1).reshape(b, s, d)


def _scaled_close(got, want, tol, what,
                  names=("dr", "dk", "dv", "dw", "du")):
    """max |got - want| within ``tol`` of max |want|, per tensor."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w).max() / (np.abs(w).max() or 1.0)
        assert err <= tol, f"{what}: {name} off by {err:.3e} of its scale"


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------
def test_param_count_matches():
    """The JAX package's formula, kept as it is (ROADMAP section 3: it
    does not count the leaves)."""
    cfg, jcfg = C.get_arch(NAME), jget_arch(NAME)
    assert cfg.param_count() == jcfg.param_count() == 2_868_510_720
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.layer_kinds() == [(C.RWKV, C.DENSE_FF)] * 32
    small = C.smoke_variant(cfg)
    assert small.param_count() == jsmoke(jcfg).param_count()
    # the leaves hold fewer: no gate lora, 9 d of mix, decay and norm
    # parameters where the formula has 6 d, and the channel mix's mix_k
    model = Model(cfg, torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 2_863_598_080


def test_parameter_names_and_dtypes():
    """The time-mix and channel-mix leaves are the JAX tree's; w0, u and
    the groupnorm's scale and bias stay float32 in a bf16 model."""
    cfg = C.smoke_variant(C.get_arch(NAME))
    assert cfg.dtype == "bfloat16"
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jsmoke(jget_arch(NAME))
    want = {"mixer": JR.rwkv_init(jax.random.PRNGKey(0), jcfg,
                                  jnp.bfloat16),
            "ffn": JL.relu_sq_ffn_init(jax.random.PRNGKey(1), 64, 128,
                                       jnp.bfloat16)}
    block = model.stack.layers[0]
    assert block.rwkv and block.channel_mix and block.rope_width == 0
    for part, jp in want.items():
        params = dict(getattr(block, part).named_parameters())
        assert set(params) == set(jp)
        for name, p in params.items():
            assert tuple(p.shape) == jp[name].shape, name
            assert str(p.dtype).split(".")[1] == str(jp[name].dtype), name
    f32 = {n for n, p in block.mixer.named_parameters()
           if p.dtype == torch.float32}
    assert f32 == {"w0", "u", "ln_x_scale", "ln_x_bias"}


def test_params_roundtrip():
    _, _, _, tree, model = _setup()
    back = params_to_numpy(model)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the WKV recurrence's plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,hs", [(2, 12, 2, 16), (1, 256, 2, 16),
                                      (2, 512, 1, 16), (1, 17, 1, 64)])
def test_wkv_ref_and_bwd_ref_match_jax(b, s, h, hs):
    """The plain forward against the JAX recurrence under chunked_scan,
    and the kernel's backward algorithm against ``jax.grad`` of it: S
    inside one chunk (17: not a whole 8-step backward sub-chunk),
    exactly one chunk and two chunks; head sizes 16 and 64."""
    arrays, t = _wkv_inputs(b, s, h, hs, seed=s)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    o, states = ref.wkv_ref(*_args(t), return_states=True)
    jo = _jax_wkv(j["r"], j["k"], j["v"], j["w"], j["u"])
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=WKV_TOL,
                               atol=WKV_TOL)
    assert tuple(states.shape) == (b, -(-s // 256), h, hs, hs)
    assert not states[:, 0].any()
    jgrads = jax.grad(lambda *x: jnp.sum(_jax_wkv(*x) * j["do"]),
                      argnums=(0, 1, 2, 3, 4))(
        j["r"], j["k"], j["v"], j["w"], j["u"])
    got = ref.wkv_bwd_ref(*_args(t), states, t["do"])
    _scaled_close(got, jgrads, WKV_TOL, "bwd_ref vs jax.grad")


@pytest.mark.parametrize("b,s,h,hs", [(2, 12, 2, 16), (1, 256, 1, 64),
                                      (2, 512, 2, 16), (3, 1, 2, 16)])
def test_wkv_bwd_ref_matches_autograd(b, s, h, hs):
    """``wkv_bwd_ref`` (chunks recomputed from their stored states)
    against torch autograd of ``wkv_ref``; at S 1 the decay reaches no
    output."""
    _, t = _wkv_inputs(b, s, h, hs, seed=s + 1)
    leaves = [x.clone().requires_grad_(True) for x in _args(t)]
    o, states = ref.wkv_ref(*leaves, return_states=True)
    want = torch.autograd.grad(o, leaves, t["do"], allow_unused=True)
    want = [torch.zeros_like(x) if g is None else g
            for g, x in zip(want, leaves)]
    got = ref.wkv_bwd_ref(*_args(t), states, t["do"])
    _scaled_close(got, want, WKV_TOL, "bwd_ref vs autograd")
    if s == 1:
        assert not got[3].any()


@pytest.mark.parametrize("b,s,h,hs", [(1, 512, 1, 64), (2, 512, 2, 16)])
def test_wkv_slow_decay_matches_jax_and_autograd(b, s, h, hs):
    """Slow decay, ``w0`` -6 (w about 0.997): a state sums hundreds of
    steps and G crosses the 256-step chunk at nearly full weight.  The
    plain forward against the JAX recurrence, and ``wkv_bwd_ref``
    against ``jax.grad`` and torch autograd, all to 2e-5 of the largest
    element."""
    arrays, t = _wkv_inputs(b, s, h, hs, seed=s + hs, w0=-6.0)
    assert arrays["w"].mean() > 0.99
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    leaves = [x.clone().requires_grad_(True) for x in _args(t)]
    o, states = ref.wkv_ref(*leaves, return_states=True)
    jo = _jax_wkv(j["r"], j["k"], j["v"], j["w"], j["u"])
    _scaled_close([o.detach()], [jo], WKV_TOL, "wkv_ref vs jax",
                  names=("o",))
    got = ref.wkv_bwd_ref(*_args(t), states, t["do"])
    want = torch.autograd.grad(o, leaves, t["do"])
    _scaled_close(got, want, WKV_TOL, "bwd_ref vs autograd")
    jgrads = jax.grad(lambda *x: jnp.sum(_jax_wkv(*x) * j["do"]),
                      argnums=(0, 1, 2, 3, 4))(
        j["r"], j["k"], j["v"], j["w"], j["u"])
    _scaled_close(got, jgrads, WKV_TOL, "bwd_ref vs jax.grad")


# ---------------------------------------------------------------------------
# the WKV recurrence by the kernels' stages, the chunks side by side
# ---------------------------------------------------------------------------
#: (B, S, heads, head size): one chunk (a ragged 200 steps, and exactly
#: 256), two chunks and sixteen (rwkv6-3b's 4,096 training steps), at
#: head sizes 16 and 64
STAGE_SHAPES = [(2, 200, 2, 16), (1, 256, 1, 64), (2, 512, 2, 16),
                (1, 512, 1, 64), (1, 4096, 1, 16), (1, 4096, 1, 64)]
#: the composed forward and backward run the JAX gradient too: sixteen
#: chunks at head size 16 only (at 64 a case takes minutes beside the
#: other test workers)
COMPOSE_SHAPES = STAGE_SHAPES[:-1]
#: the decay's ``w0``: fast (w about 0.2-0.8), slow (w about 0.997: a
#: chunk's decay about 0.46 and its delta a sum of hundreds of terms) and
#: underflowing (w about 6e-4: a chunk's decay and most of its partial
#: products are exactly 0)
STAGE_DECAYS = {"fast": -0.5, "slow": -6.0, "underflow": 2.0}


def _stage_case(b, s, h, hs, decay):
    w0 = STAGE_DECAYS[decay]
    arrays, t = _wkv_inputs(b, s, h, hs, seed=s + hs + int(w0 * 10),
                            w0=w0)
    return arrays, t


def _forward_close(got, want, decay, what):
    """The forward's tolerance: allclose 2e-5, or at slow decay 2e-5 of
    the largest element (outputs near 0 from float32 sums of terms in
    the tens)."""
    if decay == "slow":
        _scaled_close([got], [want], WKV_TOL, what, names=("o",))
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=WKV_TOL, atol=WKV_TOL, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_chunk_step():
    def step(state, inp):
        k_t, v_t, w_t = inp
        return w_t[..., :, None] * state + k_t[..., :, None] * v_t[
            ..., None, :], None

    return jax.jit(lambda state, xs: jax.lax.scan(step, state, xs)[0])


def _jax_chunk_states(k, v, w, u):
    """The JAX recurrence's state at the start of every 256-step chunk
    (the first 0), a chunk's scan at a time."""
    b, s, _ = k.shape
    nh, hs = u.shape
    xs = tuple(x.reshape(b, s, nh, hs).swapaxes(0, 1) for x in (k, v, w))
    out = [jnp.zeros((b, nh, hs, hs), jnp.float32)]
    for c0 in range(256, s, 256):
        out.append(_jax_chunk_step()(out[-1], tuple(
            x[c0 - 256:c0] for x in xs)))
    return np.stack([np.asarray(x) for x in out], axis=1)


def _autograd_g_end(t):
    """torch autograd's gradient of the state at the start of every
    chunk but the first, through ``wkv_ref``'s step: the gradient of the
    state after each chunk's last step (0 after the last chunk)."""
    r, k, v, w, u = _args(t)
    b, s, _ = r.shape
    nh, hs = u.shape
    rh, kh, vh, wh = (x.reshape(b, s, nh, hs) for x in (r, k, v, w))
    zs = [torch.zeros((b, nh, hs, hs), requires_grad=True)
          for _ in range(-(-s // 256) - 1)]
    state = torch.zeros((b, nh, hs, hs))
    outs = []
    for step in range(s):
        if step and step % 256 == 0:
            state = state + zs[step // 256 - 1]
        a = kh[:, step, :, :, None] * vh[:, step, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rh[:, step],
                                 state + u[None, :, :, None] * a))
        state = wh[:, step, :, :, None] * state + a
    o = torch.stack(outs, dim=1).reshape(b, s, nh * hs)
    grads = list(torch.autograd.grad(o, zs, t["do"])) if zs else []
    return torch.stack(grads + [torch.zeros((b, nh, hs, hs))], dim=1)


@pytest.mark.parametrize("decay", list(STAGE_DECAYS))
@pytest.mark.parametrize("b,s,h,hs", STAGE_SHAPES)
def test_wkv_chunk_chain_matches_states(b, s, h, hs, decay):
    """The forward's stages (each chunk's end state from 0 and its
    decay, then the chain over chunks) give the chunk states of the
    step-at-a-time ``wkv_ref`` and of the JAX recurrence; no factor is
    divided by w, so at underflowing decay the chunks' decays are exactly
    0 and nothing is NaN."""
    arrays, t = _stage_case(b, s, h, hs, decay)
    delta, dec, states = ref.wkv_chunk_ref(t["k"], t["v"], t["w"], t["u"])
    chunks = -(-s // 256)
    assert tuple(states.shape) == (b, chunks, h, hs, hs)
    assert tuple(delta.shape) == states.shape
    assert tuple(dec.shape) == (b, chunks, h, hs)
    assert torch.isfinite(delta).all() and torch.isfinite(states).all()
    assert ((dec >= 0) & (dec <= 1)).all()
    assert not states[:, 0].any()
    if decay == "underflow" and s >= 256:
        assert not dec.any()
    _, want = ref.wkv_ref(*_args(t), return_states=True)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    jstates = _jax_chunk_states(j["k"], j["v"], j["w"], j["u"])
    for other, what in ((want, "wkv_ref"), (jstates, "jax")):
        _forward_close(states.numpy(), np.asarray(other), decay,
                       f"chained states vs {what}")


@pytest.mark.parametrize("decay", list(STAGE_DECAYS))
@pytest.mark.parametrize("b,s,h,hs", STAGE_SHAPES)
def test_wkv_bwd_chunk_chain_matches_autograd(b, s, h, hs, decay):
    """The backward's stages (each chunk's G contribution from 0 and its
    decay, then the chain in reverse) give the gradient of the state at
    every chunk's end, against torch autograd's gradient of the
    chunk-start states."""
    _, t = _stage_case(b, s, h, hs, decay)
    delta, dec, g_end = ref.wkv_bwd_chunk_ref(t["r"], t["w"], t["do"],
                                              t["u"])
    assert tuple(g_end.shape) == (b, -(-s // 256), h, hs, hs)
    assert torch.isfinite(delta).all() and torch.isfinite(g_end).all()
    assert not g_end[:, -1].any()
    if decay == "underflow" and s >= 256:
        assert not dec.any()
    _scaled_close([g_end], [_autograd_g_end(t)], WKV_TOL,
                  "g_end vs autograd", names=("g_end",))


@pytest.mark.parametrize("decay", list(STAGE_DECAYS))
@pytest.mark.parametrize("b,s,h,hs", COMPOSE_SHAPES)
def test_wkv_stages_compose_forward_and_backward(b, s, h, hs, decay):
    """A forward and a backward composed from the stages (every chunk
    walked from its chained state, the u terms rank one) against
    ``wkv_ref``, ``wkv_bwd_ref``, the JAX recurrence and ``jax.grad``."""
    arrays, t = _stage_case(b, s, h, hs, decay)
    o, states = ref.wkv_stages_ref(*_args(t))
    want_o, want_states = ref.wkv_ref(*_args(t), return_states=True)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    jo = _jax_wkv(j["r"], j["k"], j["v"], j["w"], j["u"])
    _forward_close(o.numpy(), want_o.numpy(), decay, "stages vs wkv_ref")
    _forward_close(o.numpy(), np.asarray(jo), decay, "stages vs jax")
    got = ref.wkv_bwd_stages_ref(*_args(t), states, t["do"])
    assert all(torch.isfinite(g).all() for g in got)
    _scaled_close(got, ref.wkv_bwd_ref(*_args(t), want_states, t["do"]),
                  WKV_TOL, "stages vs bwd_ref")
    jgrads = jax.grad(lambda *x: jnp.sum(_jax_wkv(*x) * j["do"]),
                      argnums=(0, 1, 2, 3, 4))(
        j["r"], j["k"], j["v"], j["w"], j["u"])
    _scaled_close(got, jgrads, WKV_TOL, "stages vs jax.grad")


def test_chunk_states_restart_the_recurrence():
    """The state kept at the start of the second chunk restarts the
    recurrence to the same outputs."""
    _, t = _wkv_inputs(1, 512, 2, 16, seed=3)
    o, states = ref.wkv_ref(*_args(t), return_states=True)
    tail = {k: x[:, 256:] for k, x in t.items() if k != "u"}
    s = states[:, 1]
    u = t["u"]
    for i in range(8):
        r_t, k_t, v_t, w_t = (tail[k][:, i].reshape(1, 2, 16)
                              for k in ("r", "k", "v", "w"))
        a = k_t[..., :, None] * v_t[..., None, :]
        o_t = torch.einsum("bhi,bhij->bhj", r_t, s + u[None, :, :, None] * a)
        assert torch.equal(o_t.reshape(1, 32), o[:, 256 + i])
        s = w_t[..., :, None] * s + a


def test_long_ragged_sequences_are_refused():
    """As chunked_scan's assert: more than a chunk, not whole chunks;
    the plain path, the dispatch and the block all refuse it."""
    _, t = _wkv_inputs(1, 300, 1, 16, seed=4)
    for fn in (ref.wkv_ref, ops.wkv):
        with pytest.raises(ValueError, match="whole number of chunks"):
            fn(*_args(t))
    _, cfg, _, m = _rwkv_pair()
    with pytest.raises(ValueError, match="whole number of chunks"):
        R.rwkv_apply(m, torch.zeros((1, 300, cfg.d_model)), cfg)


def test_wkv_dispatch_and_checks(monkeypatch):
    """CPU tensors run the plain version; a CUDA tensor goes to the
    kernel (here there is none to load, so the call raises and nothing
    is counted), never to the plain version; bad operands raise."""
    _, t = _wkv_inputs(1, 8, 2, 16, seed=5)
    args = _args(t)
    assert torch.equal(ops.wkv(*args), ref.wkv_ref(*args))
    with pytest.raises(ValueError, match="w must be float32"):
        ops.wkv(*args[:3], args[3].double(), args[4])
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv(args[0].mT.contiguous().mT, *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        WK.forward(*args)
    with pytest.raises(ValueError, match="no wkv for device"):
        ops.wkv(*(a.to("meta") for a in args))

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_card():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(ref, "wkv_ref", no_plain)
    monkeypatch.setattr(WK, "_lib", no_card)
    with FakeTensorMode():
        cuda = [torch.zeros(a.shape, dtype=a.dtype, device="cuda")
                for a in args]
        odd = [torch.zeros((1, 8, 64), device="cuda") for _ in range(4)]
        odd.append(torch.zeros((2, 32), device="cuda"))
    before = (WK.launches_fwd, WK.launches_bwd)
    # a fake CUDA tensor takes the wrapper's shape-only route: no launch
    assert ops.wkv(*cuda).shape == cuda[0].shape
    # one taken for a real CUDA tensor goes to the kernel, never to the
    # plain version
    monkeypatch.setattr(WK, "is_fake", lambda t: False)
    with pytest.raises(RuntimeError, match="no kernel library"):
        ops.wkv(*cuda)
    with pytest.raises(ValueError, match="head size 32"):
        WK.forward(*odd)
    assert (WK.launches_fwd, WK.launches_bwd) == before


# ---------------------------------------------------------------------------
# the time-mix block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [12, 256, 512])
def test_rwkv_apply_matches(s):
    """Outputs, and the gradients of every leaf and of the input, against
    ``jax.grad`` of the JAX ``rwkv_apply`` (S 512 takes chunked_scan's
    chunked branch)."""
    jcfg, cfg, jp, m = _rwkv_pair()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    m.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out = R.rwkv_apply(m, tx, cfg)
    out.backward(torch.tensor(dy))

    def loss(p, xx):
        return jnp.sum(JR.rwkv_apply(p, xx, jcfg) * dy)

    jout = JR.rwkv_apply(jp, jnp.asarray(x), jcfg)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    names = [name for name, _ in m.named_parameters()]
    _scaled_close([tx.grad] + [p.grad for p in m.parameters()],
                  [jgx] + [jgp[name] for name in names], BWD_TOL,
                  "rwkv_apply gradients", ["x"] + names)


def test_rwkv_decode_matches():
    """Ten single-token steps against the JAX ``rwkv_decode``: outputs
    and both states after every step."""
    jcfg, cfg, jp, m = _rwkv_pair()
    x = np.random.default_rng(1).standard_normal(
        (10, 2, 1, cfg.d_model)).astype(np.float32)
    st = R.rwkv_init_state(cfg, 2, torch.device("cpu"))
    jst = JR.rwkv_init_state(jcfg, 2)
    for t in range(10):
        with torch.no_grad():
            y = R.rwkv_decode(m, torch.tensor(x[t]), st, cfg)
        jy, jst = JR.rwkv_decode(jp, jnp.asarray(x[t]), jst, jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {t}")
        for key in ("wkv", "shift"):
            np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]),
                                       **TOL, err_msg=f"step {t} {key}")


def test_decode_steps_equal_rwkv_apply():
    """The single-step update reproduces the sequence forward."""
    _, cfg, _, m = _rwkv_pair()
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)), dtype=torch.float32)
    st = R.rwkv_init_state(cfg, 2, torch.device("cpu"))
    with torch.no_grad():
        want = R.rwkv_apply(m, x, cfg)
        got = torch.cat([R.rwkv_decode(m, x[:, t:t + 1], st, cfg)
                         for t in range(12)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_channel_mix_matches():
    """``relu_sq_ffn_apply`` on the JAX leaves, with a bf16 input (the
    mix in float32, cast before the matmul)."""
    _, _, jparams, _, model = _setup()
    jffn = jax.tree.map(lambda a: a[1],
                        jparams["stack"]["scan"]["block_0"]["ffn"])
    rng = np.random.default_rng(6)
    x, prev = (rng.standard_normal((2, 5, 64)).astype(np.float32)
               for _ in range(2))
    got = L.relu_sq_ffn_apply(model.stack.layers[1].ffn, torch.tensor(x),
                              torch.tensor(prev))
    want = JL.relu_sq_ffn_apply(jffn, jnp.asarray(x), jnp.asarray(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _batches(cfg, b, s, step=0):
    raw = D.SyntheticLM(cfg.vocab_size, s, b).batch_at(step)
    return ({k: torch.from_numpy(v) for k, v in raw.items()},
            {k: jnp.asarray(v) for k, v in raw.items()})


def test_forward_train_matches():
    jcfg, cfg, jparams, _, model = _setup()
    tb, jb = _batches(cfg, 2, 24)
    logits, aux = forward_train(model, cfg, tb)
    jlogits, _ = jforward_train(jparams, jcfg, jb)
    assert tuple(logits.shape) == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    assert float(aux) == 0.0


def test_train_step_matches():
    """One loss and its gradients, then two AdamW steps with 2
    microbatches: metrics, then the weights."""
    jcfg, cfg, jparams, tree, _ = _setup()
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    tb, jb = _batches(cfg, 2, 16)
    loss, _ = loss_fn(model, cfg, tb)
    loss.backward()
    (jloss, _), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **MODEL_TOL)
    got = params_to_numpy(model, grads=True)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    model = trainable(params_from_numpy(cfg, tree, "cpu"))
    state = TrainState(model, adamw_init(dict(model.named_parameters())), 0)
    jstate = jtl.TrainState(params=jparams, opt=jopt.adamw_init(jparams),
                            rng=jax.random.PRNGKey(0))
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=50, eps=ADAM_EPS)
    step = make_train_step(cfg, AdamWConfig(**opt), 2)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.AdamWConfig(**opt), 2))
    for i in range(2):
        tb, jb = _batches(cfg, 4, 16, step=i)
        state, m = step(state, tb)
        jstate, jm = jstep(jstate, jb)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], float(jm[key]), **MODEL_TOL,
                                       err_msg=f"step {i} {key}")
    for got, want in zip(jax.tree.leaves(params_to_numpy(state.params)),
                         jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got, np.asarray(want), **MODEL_TOL)


# ---------------------------------------------------------------------------
# serving rwkv6-3b
# ---------------------------------------------------------------------------
def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, rng.integers(3, 8))
            .astype(np.int32) for _ in range(n)]


def _serve(eng, request_cls, prompts, new_tokens=5):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(req_id=i, prompt=p,
                               max_new_tokens=new_tokens))
    done = eng.run(max_steps=500)
    return {r.req_id: list(r.generated) for r in done}


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
def test_engine_matches_jax_engine_without_slot_reuse(table_mode):
    """Four requests on four slots (no slot is reused, so the JAX
    engine's state carry-over does not arise): the same streams,
    scheduler stats and translation-cache hits and misses; the model has
    no attention layer, so its pools are never read."""
    jcfg, cfg, jparams, _, model = _setup()
    prompts = _prompts(cfg)
    shape = dict(ENGINE, max_batch=4, table_mode=table_mode)
    out = []
    for eng, req in ((JServeEngine(jcfg, jparams, **shape), JRequest),
                     (ServeEngine(cfg, model, **shape, device="cpu"),
                      Request)):
        tokens = _serve(eng, req, prompts)
        tc = eng.sched.tcache
        out.append((tokens, dict(eng.sched.stats), tc.hits, tc.misses))
    assert len(out[1][0]) == 4
    assert out[1] == out[0]


def _jax_greedy(prompts, new_tokens=5):
    jcfg, _, jparams, _, _ = _setup()
    return {i: jgreedy_reference(jcfg, jparams, p, new_tokens,
                                 kv_mode=BT.FLAT, **ENGINE)
            for i, p in enumerate(prompts)}


@pytest.mark.parametrize("table_mode", [None, BT.RADIX])
def test_engine_with_reused_slots_matches_greedy_reference(table_mode):
    """Four requests on two slots: each admitted request starts from a
    zero recurrent state (``wkv``, ``shift``, ``ffn_shift``), so every
    stream equals the JAX package's single-sequence ``greedy_reference``
    (the JAX engine's own streams do not: it carries the slot's state
    over)."""
    _, cfg, _, _, model = _setup()
    prompts = _prompts(cfg, seed=1)
    eng = ServeEngine(cfg, model, max_batch=2, table_mode=table_mode,
                      device="cpu", **ENGINE)
    got = _serve(eng, Request, prompts)
    assert eng.sched.stats["admitted"] == 4
    assert got == _jax_greedy(prompts)
    port = {i: greedy_reference(cfg, model, p, 5, kv_mode=BT.FLAT,
                                device="cpu", **ENGINE)
            for i, p in enumerate(prompts)}
    assert got == port


def test_engine_after_preemption_matches_greedy_reference():
    """Injected mid-decode evictions: a resumed request re-prefills its
    prompt and tokens so far from a zero state."""
    _, cfg, _, _, model = _setup()
    prompts = _prompts(cfg, seed=5)
    eng = ServeEngine(cfg, model, max_batch=2, device="cpu", **ENGINE)
    with resilience.inject_faults(
            resilience.FaultInjector.from_plan("evict_storm")):
        got = _serve(eng, Request, prompts)
    assert eng.sched.stats["preempted"] >= 1
    assert eng.sched.stats["resumed"] >= 1
    assert got == _jax_greedy(prompts)


def test_launchers_local_smoke(tmp_path, capsys):
    """``launch.serve`` and ``launch.train --arch rwkv6-3b --local-smoke
    --device cpu``: three requests, and two steps of 8 x 64 tokens
    through the plain recurrence."""
    out = LS.main(["--local-smoke", "--device", "cpu", "--arch", NAME,
                   "--requests", "3"])
    assert len(out["done"]) == 3
    assert f"of {NAME}-smoke on cpu" in capsys.readouterr().out
    out = LT.train(LT.build_parser().parse_args(
        ["--local-smoke", "--device", "cpu", "--arch", NAME, "--steps", "2",
         "--ckpt-dir", str(tmp_path)]))
    assert out["cfg"].name == NAME + "-smoke"
    assert len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) and m["aux"] == 0
               for m in out["history"])
