"""The port's ServeEngine against the JAX package's, on the same weights
and prompts: identical token streams, scheduler stats and translation
cache hits/misses (smoke width, float32, on the CPU)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import greedy_reference as jgreedy_reference
from repro.util import resilience as jresilience
from repro_torch import config as C
from repro_torch.core import block_table as BT
from repro_torch.launch import serve as SERVE
from repro_torch.models import params_from_numpy
from repro_torch.serving import Request, ServeEngine, greedy_reference
from repro_torch.sim.cost_model import TranslationCostModel
from repro_torch.util import resilience

JCFG = dataclasses.replace(jsmoke(jget_arch("internlm2-1.8b")),
                           dtype="float32")
CFG = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                          dtype="float32")
JPARAMS = jinit_params(JCFG, jax.random.PRNGKey(0))
MODEL = params_from_numpy(CFG, jax.tree.map(np.asarray, JPARAMS),
                          device="cpu")
ENGINE = dict(max_batch=3, max_len=48, page_size=8)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, rng.integers(3, 8))
            .astype(np.int32) for _ in range(n)]


def _run_jax(prompts, new_tokens=5, injector=None, setup=None, **kw):
    eng = JServeEngine(JCFG, JPARAMS, **{**ENGINE, **kw})
    return _drive(eng, JRequest, jresilience, prompts, new_tokens,
                  injector, setup)


def _run_port(prompts, new_tokens=5, injector=None, setup=None, **kw):
    eng = ServeEngine(CFG, MODEL, **{**ENGINE, **kw}, device="cpu")
    return _drive(eng, Request, resilience, prompts, new_tokens, injector,
                  setup)


def _drive(eng, request_cls, res, prompts, new_tokens, injector, setup):
    extra = setup(eng) if setup else [{}] * len(prompts)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(req_id=i, prompt=p,
                               max_new_tokens=new_tokens, **extra[i]))
    if injector is not None:
        with res.inject_faults(injector):
            done = eng.run(max_steps=500)
    else:
        done = eng.run(max_steps=500)
    return eng, {r.req_id: list(r.generated) for r in done}


def _observables(eng, tokens):
    tc = eng.sched.tcache
    return (tokens, dict(eng.sched.stats), tc.hits, tc.misses,
            dict(eng.kvm.stats), eng.kvm.pool.free_pages,
            [(r.req_id, r.failed) for r in eng.sched.failed])


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
def test_engine_matches_jax_engine(table_mode):
    prompts = _prompts(5)
    jeng, jtok = _run_jax(prompts, table_mode=table_mode)
    eng, tok = _run_port(prompts, table_mode=table_mode)
    assert len(tok) == 5
    assert _observables(eng, tok) == _observables(jeng, jtok)


@pytest.mark.parametrize("table_mode", [None, BT.FLAT, BT.RADIX])
def test_engine_matches_greedy_reference(table_mode):
    prompts = _prompts(4, seed=3)
    _, tok = _run_port(prompts, table_mode=table_mode)
    for i, p in enumerate(prompts):
        want = greedy_reference(CFG, MODEL, p, 5, kv_mode=BT.FLAT,
                                max_len=48, page_size=8, device="cpu")
        assert tok[i] == want, (i, tok[i], want)


@pytest.mark.parametrize("kv_mode", ["dense", BT.FLAT, BT.RADIX])
def test_greedy_reference_matches_jax(kv_mode):
    for p in _prompts(2, seed=4):
        want = jgreedy_reference(JCFG, JPARAMS, p, 6, kv_mode=kv_mode,
                                 max_len=48, page_size=8)
        got = greedy_reference(CFG, MODEL, p, 6, kv_mode=kv_mode,
                               max_len=48, page_size=8, device="cpu")
        assert got == want


def test_evict_storm_is_bit_exact():
    """Three injected mid-decode evictions cost only retries; the port
    replays the JAX package's preemptions step for step."""
    prompts = _prompts(4, seed=5)
    _, clean = _run_port(prompts)
    resilience.recovery_events(clear=True)
    eng, faulted = _run_port(
        prompts, injector=resilience.FaultInjector.from_plan("evict_storm"))
    kinds = [kind for kind, _ in resilience.recovery_events()]
    assert kinds.count("fault_injected") == 3
    assert kinds.count("preempt") == eng.sched.stats["preempted"]
    jeng, jfaulted = _run_jax(
        prompts, injector=jresilience.FaultInjector.from_plan("evict_storm"))
    assert faulted == clean
    assert eng.sched.stats["preempted"] >= 3
    assert eng.sched.stats["resumed"] >= 1
    assert eng.sched.stats["shed"] == 0
    assert _observables(eng, faulted) == _observables(jeng, jfaulted)


def test_overload_eviction_matches_jax():
    """KV pool exhaustion sheds the lowest-priority runner the same way;
    both requests still finish with the same tokens."""
    prompts = [p[:4] for p in _prompts(2, seed=6)]

    def hog(eng):
        eng.kvm.pool.allocate(eng.kvm.pool.free_pages - 3)
        return [{"priority": 1}, {}]

    jeng, jtok = _run_jax(prompts, new_tokens=8, setup=hog)
    eng, tok = _run_port(prompts, new_tokens=8, setup=hog)
    assert eng.sched.stats["preempted"] >= 1 and not eng.sched.failed
    assert _observables(eng, tok) == _observables(jeng, jtok)


def test_deadline_drop_matches_jax():
    prompts = [p[:4] for p in _prompts(2, seed=7)]

    def deadline(eng):
        return [{}, {"deadline_steps": 2}]

    jeng, jtok = _run_jax(prompts, new_tokens=4, setup=deadline,
                          max_batch=1)
    eng, tok = _run_port(prompts, new_tokens=4, setup=deadline, max_batch=1)
    assert list(tok) == [0]
    assert _observables(eng, tok) == _observables(jeng, jtok)


def test_slots_and_pages_are_recycled():
    eng = ServeEngine(CFG, MODEL, max_batch=2, max_len=48, page_size=8,
                      device="cpu")
    for i, p in enumerate(_prompts(6, seed=1)):
        eng.submit(Request.build(i, p, max_new_tokens=3))
    assert len(eng.run()) == 6
    assert eng.kvm.pool.free_pages == eng.kvm.pool.num_pages - 1  # scratch


def test_cost_model_serves_the_five_mechanisms():
    """``cost_model=`` is ported now: a costed engine serves and
    ``throughput()`` reports the paper's five mechanisms."""
    eng = ServeEngine(CFG, MODEL, cost_model=TranslationCostModel.pinned(),
                      **ENGINE, device="cpu")
    for i, p in enumerate(_prompts(3, seed=8)):
        eng.submit(Request.build(i, p, max_new_tokens=3))
    assert len(eng.run()) == 3
    rep = eng.throughput()
    assert tuple(rep["tokens_per_sec"]) == (
        "radix", "ech", "hugepage", "ndpage", "ideal")
    assert rep["tcache_hits"] + rep["tcache_misses"] == rep["tokens"] > 0


def test_default_device_raises_without_a_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(CFG, MODEL)
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_reference(CFG, MODEL, _prompts(1)[0], 2)
    with pytest.raises(RuntimeError, match="cuda"):
        SERVE.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        SERVE.main(["--local-smoke", "--requests", "1"])


def test_launcher_local_smoke_on_cpu(capsys):
    out = SERVE.main(["--local-smoke", "--device", "cpu", "--requests", "5"])
    assert len(out["done"]) == 5
    assert all(len(r.generated) == SERVE.SMOKE["new_tokens"]
               for r in out["done"])
    assert "served 5 requests" in capsys.readouterr().out
