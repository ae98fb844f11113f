"""Translation-costed serving on the port against the JAX package's:
``ServeEngine(cost_model=)`` decodes the same tokens with the same
translation-cache hits, misses and steps, and its meter's float64
totals are bit-equal (smoke width, float32, on the CPU)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.sim.cost_model import LookupCost as JLookupCost
from repro.sim.cost_model import TranslationCostModel as JTCM
from repro.util import resilience as jresilience
from repro_torch import config as C
from repro_torch.configs.ndp_sim import ndp_machine
from repro_torch.core import block_table as BT
from repro_torch.launch import serve as SERVE
from repro_torch.models import params_from_numpy
from repro_torch.serving import Request, ServeEngine
from repro_torch.sim.cost_model import TranslationCostModel as TCM
from repro_torch.util import resilience

JCFG = dataclasses.replace(jsmoke(jget_arch("internlm2-1.8b")),
                           dtype="float32")
CFG = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                          dtype="float32")
JPARAMS = jinit_params(JCFG, jax.random.PRNGKey(0))
MODEL = params_from_numpy(CFG, jax.tree.map(np.asarray, JPARAMS),
                          device="cpu")
#: the engine shape and request mixes of the JAX package's costed serving
#: benchmark (``benchmarks/serving_translation.py``), restated
ENGINE = dict(max_batch=4, max_len=96, page_size=8)
MIXES = {
    "decode_heavy_smoke": dict(n_requests=4, prompt=(3, 8), new_tokens=8),
    "prefill_heavy_smoke": dict(n_requests=3, prompt=(24, 40),
                                new_tokens=3),
    "decode_heavy": dict(n_requests=8, prompt=(3, 8), new_tokens=16),
    "prefill_heavy": dict(n_requests=6, prompt=(24, 40), new_tokens=4),
}


def _prompts(mix, seed):
    rng = np.random.default_rng(seed)
    lo, hi = mix["prompt"]
    return [rng.integers(1, CFG.vocab_size, rng.integers(lo, hi))
            .astype(np.int32) for _ in range(mix["n_requests"])]


def _serve(engine_cls, request_cls, cfg, params, model, prompts, new,
           injector=None, res=None, **kw):
    eng = engine_cls(cfg, params, **{**ENGINE, **kw}, cost_model=model)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(req_id=i, prompt=p, max_new_tokens=new))
    if injector is not None:
        with res.inject_faults(injector):
            done = eng.run(max_steps=500)
    else:
        done = eng.run(max_steps=500)
    return eng, done


def _report(eng, done):
    rep = eng.throughput()
    budgets = eng.meter.request_budgets()
    return ([(r.req_id, list(r.generated)) for r in done],
            dict(eng.sched.stats), eng.sched.tcache.hits,
            eng.sched.tcache.misses, rep,
            {k: v.tolist() for k, v in budgets.items()},
            eng.meter.total.tolist())


def _both(prompts, new, jmodel=None, tmodel=None, **kw):
    jeng, jdone = _serve(JServeEngine, JRequest, JCFG, JPARAMS,
                         jmodel or JTCM.pinned(), prompts, new,
                         res=jresilience, **kw)
    teng, tdone = _serve(ServeEngine, Request, CFG, MODEL,
                         tmodel or TCM.pinned(), prompts, new,
                         res=resilience, device="cpu", **kw)
    return _report(jeng, jdone), _report(teng, tdone)


@pytest.mark.parametrize("name", list(MIXES))
def test_costed_engine_matches_jax(name):
    mix = MIXES[name]
    prompts = _prompts(mix, seed=list(MIXES).index(name) % 2)
    want, got = _both(prompts, mix["new_tokens"])
    assert got == want
    tokens, stats, hits, misses, rep, _, _ = got
    assert len(tokens) == mix["n_requests"]
    assert rep["tcache_hits"] + rep["tcache_misses"] == rep["tokens"]
    tps = rep["tokens_per_sec"]
    assert tps["ndpage"] >= tps["radix"]
    assert all(tps["ideal"] >= v for v in tps.values())


@pytest.mark.parametrize("table_mode", [BT.FLAT, BT.RADIX])
def test_meter_does_not_change_scheduling(table_mode):
    """A costed and an uncosted engine decode the same tokens through the
    same steps; only the meter is added."""
    prompts = _prompts(MIXES["decode_heavy_smoke"], seed=3)
    runs = []
    for model in (None, TCM.pinned()):
        eng = ServeEngine(CFG, MODEL, **ENGINE, table_mode=table_mode,
                          cost_model=model, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request.build(i, p, max_new_tokens=6))
        done = eng.run()
        runs.append(({r.req_id: r.generated for r in done},
                     dict(eng.sched.stats), eng.sched.tcache.hits))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="cost_model"):
        ServeEngine(CFG, MODEL, **ENGINE, device="cpu").throughput()


def test_costed_evict_storm_matches_jax():
    """Injected evictions re-prefill; the re-prefill's translations are
    priced the same way in both packages."""
    prompts = _prompts(MIXES["decode_heavy_smoke"], seed=5)
    plans = (jresilience.FaultInjector.from_plan("evict_storm"),
             resilience.FaultInjector.from_plan("evict_storm"))
    jeng, jdone = _serve(JServeEngine, JRequest, JCFG, JPARAMS,
                         JTCM.pinned(), prompts, 6, injector=plans[0],
                         res=jresilience)
    teng, tdone = _serve(ServeEngine, Request, CFG, MODEL, TCM.pinned(),
                         prompts, 6, injector=plans[1], res=resilience,
                         device="cpu")
    assert teng.sched.stats["preempted"] >= 3
    assert _report(teng, tdone) == _report(jeng, jdone)


def test_derived_cost_model_prices_like_jax():
    """The port's own CPU derivation, fed to both engines, gives the same
    meter totals as JAX's engine under the same table."""
    tmodel = TCM.from_sim(ndp_machine(4), use_cache=False, device="cpu")
    jmodel = JTCM(mechs=tmodel.mechs, costs=tuple(
        JLookupCost(*dataclasses.astuple(c)) for c in tmodel.costs),
        machine=tmodel.machine,
        freq_ghz=tmodel.freq_ghz,
        model_cycles_per_token=tmodel.model_cycles_per_token,
        source=tmodel.source)
    prompts = _prompts(MIXES["prefill_heavy_smoke"], seed=1)
    want, got = _both(prompts, 3, jmodel=jmodel, tmodel=tmodel)
    assert got == want


def test_launcher_costed_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
    out = SERVE.main(["--local-smoke", "--device", "cpu", "--requests", "3",
                      "--cost-model", "pinned"])
    assert out["cost_model"].source == "pinned"
    text = capsys.readouterr().out
    assert "simulated" in text and "wall clock on cpu" in text
    rep = out["engine"].throughput()
    assert rep["tokens"] == rep["tcache_hits"] + rep["tcache_misses"]
    for cache, source in (("0", "sweep"), (str(tmp_path), "sweep"),
                          (str(tmp_path), "cache")):
        monkeypatch.setenv("SIM_TRACE_CACHE", cache)
        out = SERVE.main(["--local-smoke", "--device", "cpu", "--requests",
                          "2", "--cost-model", "sweep"])
        assert out["cost_model"].source == source
    uncosted = SERVE.main(["--local-smoke", "--device", "cpu",
                           "--requests", "3"])
    assert uncosted["cost_model"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SERVE.main(["--local-smoke", "--requests", "1",
                        "--cost-model", "sweep"])
