"""Mamba and the jamba hybrid on the port against the JAX package, on the
CPU: the Mamba block (``models/mamba.py``) against ``repro.models.mamba``
on the same weights, the selective scan's plain forward and its
backward as the kernel computes it (``ref.selective_scan_ref``,
``ref.selective_scan_bwd_ref``) against autograd and ``jax.grad``, the
scan's dispatch (a CUDA tensor reaches the kernel, never the plain
version), the jamba configs and their cuts, and the serving engine on
jamba against the JAX engine and the JAX ``greedy_reference``.

Smoke width (``smoke_variant``: d_model 64, d_inner 128, d_state 4,
d_conv 2, dt_rank 4), float32.  Outputs and states are held to rtol =
atol = 1e-5 (the two packages sum in float32 in other orders: the
einsums over the state, the projections).  Gradients are held to 1e-5
of each gradient's largest element: a weight's gradient is a sum over
every token (512 x 2 here) whose rounding scales with its largest terms,
not with the element (``out_proj``'s reach 14 at S 512, where an element
of 0.07 differs by 1.2e-5 between the packages); the same bound holds
the backward's algorithm against autograd (its sums over channels and
time run in the kernel's blocked order).  Generated tokens exactly.
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
from repro.models import init_params as jinit_params
from repro.models import mamba as JM
from repro.models.scan_utils import chunked_scan
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import greedy_reference as jgreedy_reference
from repro_torch import config as C
from repro_torch.configs.jamba_1_5_large_398b import PATTERN
from repro_torch.core import block_table as BT
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch import train as LT
from repro_torch.models import init_params, params_from_numpy
from repro_torch.models import mamba as M
from repro_torch.serving import Request, ServeEngine, greedy_reference
from repro_torch.util import resilience

NAME = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=1e-5)
#: gradients, of each gradient's largest element
BWD_TOL = 1e-5
ENGINE = dict(max_len=48, page_size=8)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, JAX params, port model) of jamba at smoke
    width in float32: 8 layers, attention at layer 3."""
    jcfg = dataclasses.replace(jsmoke(jget_arch(NAME)), dtype="float32")
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(NAME)),
                              dtype="float32")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_numpy(cfg, tree, "cpu")


def _mamba_pair():
    """The first Mamba layer's JAX leaves and the port's block on them."""
    jcfg, cfg, jparams, _ = _setup()
    jp = jax.tree.map(lambda a: a[0],
                      jparams["stack"]["scan"]["block_0"]["mixer"])
    m = M.Mamba(cfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.tensor(np.asarray(jp[name])))
    return jcfg, cfg, jp, m


def _scan_inputs(b, s, d, n, seed, x_dtype=torch.float32):
    """Scan operands at Mamba's scale: dt in [1e-3, 0.1] (its init's
    range), a = -(1..N) jittered."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=rng.standard_normal((b, s, d)),
        dt=rng.uniform(1e-3, 0.1, (b, s, d)),
        b=rng.standard_normal((b, s, n)),
        c=rng.standard_normal((b, s, n)),
        a=-np.arange(1, n + 1)[None] * rng.uniform(0.5, 1.5, (d, n)),
        dy=rng.standard_normal((b, s, d)))
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()}
    t["x"] = t["x"].to(x_dtype)
    return arrays, t


def _jax_scan(x, dt, b, c, a):
    """The JAX package's recurrence: ``mamba_apply``'s ``step`` under
    ``chunked_scan`` (``src/repro/models/mamba.py:96-107``)."""
    def step(h, inp):
        x_t, dt_t, b_t, c_t = inp
        da = jnp.exp(dt_t[..., None] * a[None])
        dbx = (dt_t * x_t.astype(jnp.float32))[..., None] * b_t[:, None, :]
        h = da * h + dbx
        return h, jnp.einsum("bdn,bn->bd", h, c_t)

    h0 = jnp.zeros((x.shape[0], x.shape[2], a.shape[1]), jnp.float32)
    xs = tuple(v.swapaxes(0, 1) for v in (x, dt, b, c))
    _, ys = chunked_scan(step, h0, xs)
    return ys.swapaxes(0, 1)


def _scaled_close(got, want, tol, what, names=("dx", "ddt", "db", "dc",
                                                "da")):
    """max |got - want| within ``tol`` of max |want|, per tensor."""
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, f"{what}: {name} off by {err:.3e} of its scale"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cut", ["full", "serve", "train"])
def test_param_counts_match(cut):
    """The port's param_count equals the JAX package's for the full model
    and both depth cuts that run on one card."""
    full, jfull = C.get_arch(NAME), jget_arch(NAME)
    changes = {"full": {},
               "serve": dict(num_layers=4, layer_pattern=PATTERN[:4]),
               "train": dict(num_layers=2, layer_pattern=PATTERN[2:4])}[cut]
    cfg = dataclasses.replace(full, **changes)
    jcfg = dataclasses.replace(jfull, **changes)
    if cut == "train":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=4))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    want = {"full": 398_553_038_848, "serve": 23_021_273_088,
            "train": 4_664_999_936}[cut]
    assert cfg.param_count() == want


def test_parameter_names_and_dtypes():
    """The Mamba leaves are the JAX tree's; A_log, D and dt_bias stay
    float32 in a bf16 model, the rest takes the model dtype."""
    cfg = C.smoke_variant(C.get_arch(NAME))
    assert cfg.dtype == "bfloat16"
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = JM.mamba_init(jax.random.PRNGKey(0), jsmoke(jget_arch(NAME)),
                       jnp.bfloat16)
    block = model.stack.layers[0]
    assert block.mamba and block.rope_width == 0
    params = dict(block.mixer.named_parameters())
    assert set(params) == set(jp)
    for name, p in params.items():
        assert tuple(p.shape) == jp[name].shape, name
        assert str(p.dtype).split(".")[1] == str(jp[name].dtype), name
    assert {n for n, p in params.items() if p.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    kinds = [b.mamba for b in model.stack.layers]
    assert kinds == [True, True, True, False, True, True, True, True]


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [12, 256, 512])
def test_mamba_apply_matches(s):
    """Outputs, and the gradients of every leaf and of the input, against
    ``jax.grad`` of the JAX ``mamba_apply`` (S 512 takes chunked_scan's
    chunked branch)."""
    jcfg, cfg, jp, m = _mamba_pair()
    rng = np.random.default_rng(s)
    u = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    m.requires_grad_(True)
    tu = torch.tensor(u, requires_grad=True)
    out = M.mamba_apply(m, tu, cfg)
    out.backward(torch.tensor(dy))

    def loss(p, x):
        return jnp.sum(JM.mamba_apply(p, x, jcfg) * dy)

    jout = JM.mamba_apply(jp, jnp.asarray(u), jcfg)
    jgp, jgu = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    names = [name for name, _ in m.named_parameters()]
    _scaled_close([tu.grad] + [p.grad for p in m.parameters()],
                  [jgu] + [jgp[name] for name in names], BWD_TOL,
                  "mamba_apply gradients", ["u"] + names)


def test_mamba_decode_matches():
    """Ten single-token steps against the JAX ``mamba_decode``: outputs
    and both states after every step."""
    jcfg, cfg, jp, m = _mamba_pair()
    u = np.random.default_rng(1).standard_normal(
        (10, 2, 1, cfg.d_model)).astype(np.float32)
    st = M.mamba_init_state(cfg, 2, torch.device("cpu"))
    jst = JM.mamba_init_state(jcfg, 2)
    for t in range(10):
        with torch.no_grad():
            y = M.mamba_decode(m, torch.tensor(u[t]), st, cfg)
        jy, jst = JM.mamba_decode(jp, jnp.asarray(u[t]), jst, jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"step {t}")
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]),
                                       **TOL, err_msg=f"step {t} {key}")


def test_decode_steps_equal_mamba_apply():
    """The single-step update reproduces the sequence forward."""
    _, cfg, _, m = _mamba_pair()
    u = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)), dtype=torch.float32)
    st = M.mamba_init_state(cfg, 2, torch.device("cpu"))
    with torch.no_grad():
        want = M.mamba_apply(m, u, cfg)
        got = torch.cat([M.mamba_decode(m, u[:, t:t + 1], st, cfg)
                         for t in range(12)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_long_ragged_sequences_are_refused():
    """As chunked_scan's assert: more than a chunk, not whole chunks."""
    _, cfg, _, m = _mamba_pair()
    with pytest.raises(ValueError, match="whole number of chunks"):
        M.mamba_apply(m, torch.zeros((1, 300, cfg.d_model)), cfg)


# ---------------------------------------------------------------------------
# the selective scan's plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,d,n", [(2, 12, 128, 4), (2, 203, 130, 4),
                                     (1, 512, 64, 16), (2, 601, 40, 4)])
def test_bwd_ref_matches_autograd(b, s, d, n):
    """``selective_scan_bwd_ref`` (chunks of 256 recomputed from stored
    states, per-block partials of db / dc, per-row partials of da)
    against autograd of ``selective_scan_ref``, at S not a multiple of
    the kernel's 16-step forward tile, its 8-step backward sub-chunk or
    the 256-step chunk, and D not a multiple of the 128-channel block."""
    _, t = _scan_inputs(b, s, d, n, seed=s)
    leaves = {k: t[k].clone().requires_grad_(True)
              for k in ("x", "dt", "b", "c", "a")}
    y, hs = ref.selective_scan_ref(*leaves.values(), return_states=True)
    want = torch.autograd.grad(y, tuple(leaves.values()), t["dy"])
    assert tuple(hs.shape) == (b, -(-s // 256), d, n)
    assert not hs[:, 0].any()
    got = ref.selective_scan_bwd_ref(t["x"], t["dt"], t["b"], t["c"],
                                     t["a"], hs, t["dy"])
    _scaled_close(got, want, BWD_TOL, "bwd_ref vs autograd")


@pytest.mark.parametrize("b,s,d,n", [
    pytest.param(2, 12, 128, 4, id="12"),
    pytest.param(2, 203, 128, 4, id="203"),
    pytest.param(2, 512, 128, 4, id="512"),
    pytest.param(1, 200, 136, 4, id="b1-s200-d136-n4"),
    pytest.param(1, 256, 136, 4, id="b1-s256-d136-n4"),
    pytest.param(1, 512, 136, 4, id="b1-s512-d136-n4"),
    pytest.param(1, 200, 136, 16, id="b1-s200-d136-n16"),
    pytest.param(1, 256, 136, 16, id="b1-s256-d136-n16"),
    pytest.param(1, 512, 136, 16, id="b1-s512-d136-n16"),
])
def test_scan_and_bwd_ref_match_jax(b, s, d, n):
    """The plain forward and the kernel's backward algorithm against the
    JAX recurrence under chunked_scan and its ``jax.grad``: at jamba's N
    16 and the smoke width's N 4; S inside one chunk (203: not a whole
    8-step backward sub-chunk; 200: not a whole 16-step forward tile),
    exactly one chunk and two chunks; D 136, not a whole 128-channel
    block."""
    arrays, t = _scan_inputs(b, s, d, n, seed=s + 1)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    y, hs = ref.selective_scan_ref(t["x"], t["dt"], t["b"], t["c"], t["a"],
                                   return_states=True)
    jy = _jax_scan(j["x"], j["dt"], j["b"], j["c"], j["a"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    jgrads = jax.grad(lambda *v: jnp.sum(_jax_scan(*v) * j["dy"]),
                      argnums=(0, 1, 2, 3, 4))(
        j["x"], j["dt"], j["b"], j["c"], j["a"])
    got = ref.selective_scan_bwd_ref(t["x"], t["dt"], t["b"], t["c"],
                                     t["a"], hs, t["dy"])
    _scaled_close(got, jgrads, BWD_TOL, "bwd_ref vs jax.grad")


def test_chunk_states_and_bf16_inputs():
    """``return_states`` gives the state at the start of every 256-step
    chunk, from which the recurrence restarts to the same outputs; a
    bf16 x is read as float32 and its gradient comes back in bf16."""
    _, t = _scan_inputs(1, 300, 16, 4, seed=3, x_dtype=torch.bfloat16)
    y, hs = ref.selective_scan_ref(t["x"], t["dt"], t["b"], t["c"], t["a"],
                                   return_states=True)
    assert tuple(hs.shape) == (1, 2, 16, 4) and not hs[:, 0].any()
    y32 = ref.selective_scan_ref(t["x"].float(), t["dt"], t["b"], t["c"],
                                 t["a"])
    assert y.dtype == torch.float32 and torch.equal(y, y32)
    h = hs[:, 1]
    for i in range(256, 300):
        h = ref._scan_step(h, t["x"][:, i], t["dt"][:, i], t["b"][:, i],
                           t["a"])
        assert torch.equal(torch.einsum("bdn,bn->bd", h, t["c"][:, i]),
                           y[:, i])
    dx = ref.selective_scan_bwd_ref(t["x"], t["dt"], t["b"], t["c"],
                                    t["a"], hs, t["dy"])[0]
    assert dx.dtype == torch.bfloat16


def test_scan_dispatch_and_checks(monkeypatch):
    """CPU tensors run the plain version; a CUDA tensor goes to the
    kernel (here there is none to load, so the call raises and nothing
    is counted), never to the plain version; bad operands raise."""
    _, t = _scan_inputs(1, 8, 16, 4, seed=4)
    args = [t[k] for k in ("x", "dt", "b", "c", "a")]
    assert torch.equal(ops.selective_scan(*args),
                       ref.selective_scan_ref(*args))
    with pytest.raises(ValueError, match="dt must be float32"):
        ops.selective_scan(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(args[0], args[1], args[2],
                           args[3].mT.contiguous().mT, args[4])
    with pytest.raises(ValueError, match="CUDA"):
        SS.forward(*args)
    with pytest.raises(ValueError, match="no selective_scan for device"):
        ops.selective_scan(*(a.to("meta") for a in args))

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_card():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(ref, "selective_scan_ref", no_plain)
    monkeypatch.setattr(SS, "_lib", no_card)
    with FakeTensorMode():
        cuda = [torch.zeros(a.shape, dtype=a.dtype, device="cuda")
                for a in args]
        wide = [torch.zeros(shape, device="cuda")
                for shape in ((1, 8, 8), (1, 8, 8), (16, 8))]
    before = (SS.launches_fwd, SS.launches_bwd)
    # a fake CUDA tensor takes the wrapper's shape-only route: no launch
    assert ops.selective_scan(*cuda).shape == cuda[0].shape
    # one taken for a real CUDA tensor goes to the kernel, never to the
    # plain version
    monkeypatch.setattr(SS, "is_fake", lambda t: False)
    with pytest.raises(RuntimeError, match="no kernel library"):
        ops.selective_scan(*cuda)
    with pytest.raises(ValueError, match="d_state 8"):
        SS.forward(cuda[0], cuda[1], *wide)
    assert (SS.launches_fwd, SS.launches_bwd) == before


# ---------------------------------------------------------------------------
# serving jamba
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
    scheduler stats and translation-cache hits and misses."""
    jcfg, cfg, jparams, model = _setup()
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
    jcfg, _, jparams, _ = _setup()
    return {i: jgreedy_reference(jcfg, jparams, p, new_tokens,
                                 kv_mode=BT.FLAT, **ENGINE)
            for i, p in enumerate(prompts)}


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
def test_engine_with_reused_slots_matches_greedy_reference(table_mode):
    """Four requests on two slots: each admitted request starts from a
    zero recurrent state, so every stream equals the JAX package's
    single-sequence ``greedy_reference`` (the JAX engine's own streams
    for requests 2 and 3 do not: it carries the slot's state over)."""
    _, cfg, _, model = _setup()
    prompts = _prompts(cfg)
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
    prompt and tokens so far from a zero state, so its stream still
    equals ``greedy_reference``."""
    _, cfg, _, model = _setup()
    prompts = _prompts(cfg, seed=5)
    eng = ServeEngine(cfg, model, max_batch=2, device="cpu", **ENGINE)
    with resilience.inject_faults(
            resilience.FaultInjector.from_plan("evict_storm")):
        got = _serve(eng, Request, prompts)
    assert eng.sched.stats["preempted"] >= 1
    assert eng.sched.stats["resumed"] >= 1
    assert got == _jax_greedy(prompts)


def test_train_launcher_local_smoke(tmp_path):
    """``launch.train --arch jamba-1.5-large-398b --local-smoke --device
    cpu``: two steps of 8 x 64 tokens through the plain scan."""
    out = LT.train(LT.build_parser().parse_args(
        ["--local-smoke", "--device", "cpu", "--arch", NAME, "--steps", "2",
         "--ckpt-dir", str(tmp_path)]))
    assert out["cfg"].name == NAME + "-smoke"
    assert len(out["history"]) == 2
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0
               for m in out["history"])
