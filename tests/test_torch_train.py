"""The port's training path against the JAX package's, on the same
weights (``params_from_numpy`` of the JAX ``init_params`` tree) and the
same batches (``SyntheticLM``), at smoke width in float32.

Tolerances (atol = rtol): logits, losses and gradients 1e-4, the
port's model tolerance (both sides sum in float32 in other orders, XLA's
dots against PyTorch's matmuls, through two layers and the vocabulary
projection); the AdamW update 1e-6 on identical inputs (elementwise
float32 arithmetic, rounded in other orders).  Data, checkpoints and
restarts are held bit for bit.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JSHAPES
from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import config as C
from repro_torch.launch import train as LT
from repro_torch.util.profile import print_profile
from repro_torch.models import (forward_train, params_from_numpy,
                                params_to_numpy)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as D
from repro_torch.train.fault_tolerance import FaultConfig, GuardedTrainer
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, schedule)
from repro_torch.train.train_loop import (TrainState, init_train_state,
                                          loss_fn, make_train_step,
                                          trainable)

TOL = dict(rtol=1e-4, atol=1e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
JCFG = dataclasses.replace(jsmoke(jget_arch("internlm2-1.8b")),
                           dtype="float32")
CFG = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                          dtype="float32")
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
JOPT = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
JPARAMS = jinit_params(JCFG, jax.random.PRNGKey(0))
TREE = jax.tree.map(np.asarray, JPARAMS)


def _model(cfg=CFG):
    return trainable(params_from_numpy(cfg, TREE, device="cpu"))


def _batch(b=4, s=16, step=0):
    raw = D.SyntheticLM(CFG.vocab_size, s, b).batch_at(step)
    return ({k: torch.from_numpy(v) for k, v in raw.items()},
            {k: jnp.asarray(v) for k, v in raw.items()})


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_params_to_numpy_inverts_params_from_numpy():
    got = params_to_numpy(_model())
    assert jax.tree.structure(got) == jax.tree.structure(TREE)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(TREE)):
        np.testing.assert_array_equal(a, b)


def test_forward_train_logits_match():
    tb, jb = _batch()
    logits, aux = forward_train(_model(), CFG, tb)
    jlogits, jaux = jforward_train(JPARAMS, JCFG, jb)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match(remat):
    cfg = dataclasses.replace(CFG, remat=remat)
    model = _model(cfg)
    tb, jb = _batch()
    loss, parts = loss_fn(model, cfg, tb)
    loss.backward()
    loss = loss.detach()
    (jloss, jparts), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        JPARAMS, dataclasses.replace(JCFG, remat=remat), jb)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]),
                               **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


def test_blockwise_branch_at_4096_tokens():
    """S = 4096 > BLOCKWISE_THRESHOLD: the port runs flash attention (its
    plain version here), JAX jax.checkpoint(blockwise_attention)."""
    model = _model()
    tb, jb = _batch(b=1, s=4096)
    loss, _ = loss_fn(model, CFG, tb)
    loss.backward()
    loss = loss.detach()
    (jloss, _), jgrads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(
        JPARAMS, JCFG, jb)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_tree_close(params_to_numpy(model, grads=True), jgrads, TOL)


def test_adamw_update_matches():
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 4), "b": (4,), "m": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jstate = jopt.adamw_init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = adamw_init(tparams)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(4):
        scale = 100.0 if step == 0 else 0.1      # clipped, then not
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate, jm = jopt.adamw_update(
            JOPT, jparams, {k: jnp.asarray(v) for k, v in grads.items()},
            jstate)
        tparams, tstate, tm = adamw_update(
            OPT, tparams, {k: torch.tensor(v) for k, v in grads.items()},
            tstate)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), **OPT_TOL)
            np.testing.assert_allclose(tstate["mu"][k].numpy(),
                                       np.asarray(jstate["mu"][k]),
                                       **OPT_TOL)
            np.testing.assert_allclose(tstate["nu"][k].numpy(),
                                       np.asarray(jstate["nu"][k]),
                                       **OPT_TOL)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   **OPT_TOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), **OPT_TOL)
        assert tstate["step"] == int(jstate["step"])


def test_adamw_decay_skips_vectors_and_keeps_bf16():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16),
              "b": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert all(m.dtype == torch.float32 for m in state["mu"].values())
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = adamw_update(OPT._replace(weight_decay=0.5), params, zeros,
                             state)
    assert float(new["w"][0, 0]) < 1.0 and float(new["b"][0]) == 1.0
    assert new["w"].dtype == torch.bfloat16


def test_schedule_matches():
    for step in (0, 1, 2, 3, 25, 50, 60):
        np.testing.assert_allclose(schedule(OPT, step),
                                   float(jopt.schedule(JOPT, step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches(micro):
    """Two steps: metrics of each, then the weights."""
    model = _model()
    state = TrainState(model, adamw_init(dict(model.named_parameters())), 0)
    jstate = jtl.TrainState(params=JPARAMS, opt=jopt.adamw_init(JPARAMS),
                            rng=jax.random.PRNGKey(0))
    step = make_train_step(CFG, OPT, micro)
    jstep = jax.jit(jtl.make_train_step(JCFG, JOPT, micro))
    for i in range(2):
        tb, jb = _batch(step=i)
        state, m = step(state, tb)
        jstate, jm = jstep(jstate, jb)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], float(jm[key]), **TOL,
                                       err_msg=f"step {i} {key}")
    _assert_tree_close(params_to_numpy(state.params), jstate.params, TOL)


def test_microbatching_matches_full_batch():
    tb, _ = _batch()
    s1, m1 = make_train_step(CFG, OPT, 1)(
        TrainState(_model(), adamw_init(dict(_model().named_parameters())),
                   0), tb)
    s4, m4 = make_train_step(CFG, OPT, 4)(
        TrainState(_model(), adamw_init(dict(_model().named_parameters())),
                   0), tb)
    np.testing.assert_allclose(m1["loss"], m4["loss"], rtol=1e-5)
    np.testing.assert_allclose(s1.params.embed.detach().numpy(),
                               s4.params.embed.detach().numpy(),
                               rtol=5e-4, atol=5e-5)


def test_train_step_raises_for_parallel_options():
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(CFG, OPT, compress=lambda g: g)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(CFG, OPT, mesh=object())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,rank,world", [(0, 0, 0, 1), (3, 7, 1, 4),
                                                  (1, 123, 3, 4)])
def test_synthetic_batches_bit_identical(seed, step, rank, world):
    args = (CFG.vocab_size, 32, 8, seed)
    got = D.SyntheticLM(*args).batch_at(step, rank, world)
    want = jdata.SyntheticLM(*args).batch_at(step, rank, world)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_token_bin_loader_bit_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(5 * 4 * 17, dtype=np.int32).tofile(path)
    got = D.TokenBinLoader(str(path), 16, 4)
    want = jdata.TokenBinLoader(str(path), 16, 4)
    assert got.num_steps == want.num_steps
    for step, rank in ((0, 0), (3, 1), (7, 0)):
        np.testing.assert_array_equal(got.batch_at(step, rank, 2)["tokens"],
                                      want.batch_at(step, rank, 2)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints and fault tolerance
# ---------------------------------------------------------------------------
def _state(seed):
    return init_train_state(CFG, seed, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    state, _ = make_train_step(CFG, OPT)(_state(2), _batch()[0])
    ckpt.save(str(tmp_path), 7, state, extra={"data_step": 7})
    other = _state(5)
    got, extra = ckpt.restore(str(tmp_path), other)
    assert extra["data_step"] == 7
    assert isinstance(got, TrainState) and got.opt["step"] == 1
    for (ka, a), (kb, b) in zip(ckpt._flatten(state), ckpt._flatten(got)):
        assert ka == kb
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_keep_last_k(tmp_path):
    state = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, state, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_restart_is_bit_exact(tmp_path):
    """Stop at step 3, restore into a fresh state, continue -> identical
    to an uninterrupted run."""
    data = D.SyntheticLM(CFG.vocab_size, 16, 4)
    step = make_train_step(CFG, OPT)

    def run(lo, hi, state):
        for i in range(lo, hi):
            raw = data.batch_at(i)
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in raw.items()})
        return state

    want = run(0, 6, _state(3))
    st = run(0, 3, _state(3))
    ckpt.save(str(tmp_path), 3, st)
    st2, _ = ckpt.restore(str(tmp_path), _state(9))
    st2 = run(3, 6, st2)
    for (k, a), (_, b) in zip(ckpt._flatten(want), ckpt._flatten(st2)):
        if torch.is_tensor(a):
            assert torch.equal(a, b), k


def test_guarded_trainer_restart_is_bit_exact(tmp_path):
    data = D.SyntheticLM(CFG.vocab_size, 16, 4)
    batch = lambda i: {k: torch.from_numpy(v)  # noqa: E731
                       for k, v in data.batch_at(i).items()}
    step = make_train_step(CFG, OPT)
    fc = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2)
    whole = GuardedTrainer(FaultConfig(ckpt_dir=str(tmp_path / "w"),
                                       ckpt_every=100), step, _state(4))
    for i in range(5):
        whole.run_step(batch(i))
    first = GuardedTrainer(fc, step, _state(4))
    for i in range(3):                   # checkpoint at step 2, then die
        first.run_step(batch(i))
    resumed = GuardedTrainer(fc, step, _state(8))
    assert resumed.maybe_restore() and resumed.step == 2
    while resumed.step < 5:
        resumed.run_step(batch(resumed.step))
    for a, b in zip(whole.state.params.parameters(),
                    resumed.state.params.parameters()):
        assert torch.equal(a, b)


def test_retry_then_success(tmp_path):
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return state + 1, {"loss": 0.0}

    g = GuardedTrainer(FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=100),
                       flaky_step, state=torch.zeros(()))
    assert g.run_step({}) is not None and g.stats.retries == 1
    assert int(g.state) == 1


def test_persistent_failure_restores_and_raises(tmp_path):
    def bad_step(state, batch):
        raise RuntimeError("broken")

    g = GuardedTrainer(FaultConfig(ckpt_dir=str(tmp_path), max_retries=2,
                                   backoff_s=0.0),
                       bad_step, state=torch.zeros(()))
    ckpt.save(str(tmp_path), 0, torch.zeros(()))
    with pytest.raises(RuntimeError):
        g.run_step({})
    assert g.stats.retries == 2 and g.stats.restores == 1


def test_periodic_checkpointing(tmp_path):
    g = GuardedTrainer(FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
                       lambda state, batch: (state + 1, {}),
                       state=torch.zeros(()))
    for _ in range(4):
        g.run_step({})
    assert ckpt.latest_step(str(tmp_path)) == 4


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launcher_local_smoke_cpu(tmp_path, capsys):
    out = LT.main(["--local-smoke", "--device", "cpu", "--steps", "3",
                   "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out["cfg"].dtype == "float32" and out["microbatches"] == 2
    assert out["shape"].seq_len == 64 and out["shape"].global_batch == 8
    assert "step 3: loss=" in capsys.readouterr().out


def test_launcher_full_width_defaults():
    args = LT.build_parser().parse_args([])
    assert (args.arch, args.steps, args.device) == ("internlm2-1.8b", 3,
                                                    "cuda")
    assert (LT.GLOBAL_BATCH, args.microbatches) == (8, 4)
    assert C.SHAPES[args.shape].seq_len == 4096


def test_launcher_profile_cpu(tmp_path, capsys):
    """--profile traces the steps after the first and prints the table."""
    out = LT.main(["--local-smoke", "--device", "cpu", "--steps", "2",
                   "--profile", "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 2
    assert out["profile"].key_averages()
    assert "Self CPU" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--steps 2"):
        LT.main(["--local-smoke", "--device", "cpu", "--steps", "1",
                 "--profile", "--ckpt-dir", str(tmp_path)])


def test_print_profile_leaves_out_step_ranges(capsys):
    """The card's busy time sums its kernels, not the ProfilerStep ranges
    of a scheduled profile, which span them."""
    def event(key, us):
        return types.SimpleNamespace(
            key=key, device_type=torch.autograd.DeviceType.CUDA,
            self_device_time_total=us, count=1)

    class Averages(list):
        def table(self, **_):
            return "table"

    events = Averages([event("ProfilerStep*", 2e6), event("kernel_a", 1.5e6),
                       event("kernel_b", 0.5e6)])
    print_profile(types.SimpleNamespace(key_averages=lambda: events), 4.0)
    out = capsys.readouterr().out
    assert "device busy 2.000 s of 4.000 s wall (50.0%)" in out
    assert "ProfilerStep" not in out


def test_launcher_raises_for_multihost_flags(tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        LT.main(["--local-smoke", "--device", "cpu", "--coordinator",
                 "localhost:1234", "--ckpt-dir", str(tmp_path)])


def test_launcher_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        LT.main(["--local-smoke", "--steps", "1", "--ckpt-dir",
                 str(tmp_path)])
