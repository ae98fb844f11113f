"""The JAX package's chaos plans (``scripts/chaos.py``) replayed against
the port on the CPU: each injected fault may cost retries, never
answers, and the port's recovery log takes the same kinds of decision,
in the same order, as the JAX run of the same plan and seed.

  * ``cache_corrupt``: a cache read fault quarantines the entry and the
    caller recomputes; the recompute's write fault degrades to
    cache-off.  The trace cache (the plan's own family), the cost-model
    memo and the search's eval cache share the store; each regenerates
    bit-exactly.
  * ``dispatch_hang``: a sweep bucket's dispatch raises
    ``DispatchTimeout``; the watchdog clears the bucket plans and
    retries to the same ``SimResult``s.
  * ``evict_storm``: three mid-decode evictions; preempted requests
    re-prefill and every request's tokens equal the fault-free run's.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

from repro.config import get_arch as jget_arch, smoke_variant as jsmoke
from repro.models import init_params as jinit_params
from repro.util import resilience as jresilience
from repro_torch import config as C
from repro_torch.configs import ndp_sim as CFG
from repro_torch.models import params_from_numpy
from repro_torch.serving import Request, ServeEngine
from repro_torch.sim import _search as SEARCH
from repro_torch.sim import cost_model as CM
from repro_torch.sim._sweep import _RESULT_FIELDS, sweep
from repro_torch.util import resilience
from repro_torch.workloads import generate_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
TRACE_KEYS = ("vpn", "off", "work")
#: a cache read fault, then the recompute's failed write
CACHE_KINDS = ["fault_injected", "quarantine", "fault_injected",
               "cache_off"]


def _chaos_script():
    spec = importlib.util.spec_from_file_location(
        "chaos_script", ROOT / "scripts" / "chaos.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_kinds(plan: str, monkeypatch, tmp_path):
    """The event kinds of the JAX package's own run of ``plan``."""
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path / "jax"))
    jresilience.recovery_events(clear=True)
    assert _chaos_script().PLANS[plan](SEED)
    return [k for k, _ in jresilience.recovery_events(clear=True)]


def _faulted(plan: str, run):
    """``run()`` under ``plan``: (its result, the recovery event kinds)."""
    resilience.recovery_events(clear=True)
    with resilience.inject_faults(
            resilience.FaultInjector.from_plan(plan, seed=SEED)):
        got = run()
    return got, [k for k, _ in resilience.recovery_events(clear=True)]


def test_cache_corrupt_trace_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path / "port"))

    def run():
        return generate_trace("rnd", 2, length=2048, seed=SEED)

    clean = run()
    faulted, kinds = _faulted("cache_corrupt", run)
    assert all(np.array_equal(clean[k], faulted[k]) for k in TRACE_KEYS)
    assert kinds == CACHE_KINDS
    assert kinds == _jax_kinds("cache_corrupt", monkeypatch, tmp_path)


def test_cache_corrupt_cost_model_memo(monkeypatch, tmp_path):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))

    def run():
        return CM.TranslationCostModel.from_sim(CFG.ndp_machine(2),
                                                device="cpu")

    clean = run()
    assert clean.source == "sweep"
    faulted, kinds = _faulted("cache_corrupt", run)
    # the memo's read fault re-derives it; the trace cache beside it
    # serves the clean run's entries
    assert faulted.source == "sweep" and faulted.costs == clean.costs
    assert kinds == CACHE_KINDS


def test_cache_corrupt_search_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
    space = SEARCH.SearchSpace(
        name="tiny", knobs=(("pwc_entries", (16, 32)),
                            ("flatten", ("pl2", "pl3"))),
        cores=2, workloads=("rnd",), n_random=2, population=4,
        generations=1, offspring=2, trace_len=272, chunk=272,
        preset="smoke", seed=11)

    def run():
        return SEARCH.search(space, use_cache=True, device="cpu")

    clean = run()
    faulted, kinds = _faulted("cache_corrupt", run)
    assert faulted.provenance["eval_cache_hits"] == 0   # re-evaluated
    assert [c.objectives for c in faulted.frontier] == \
        [c.objectives for c in clean.frontier]
    assert kinds == CACHE_KINDS


def test_dispatch_hang_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path / "port"))
    grid = {"memory.latency": [100, 170]}

    def run():
        return sweep(grid, preset="smoke", seed=SEED, device="cpu")

    clean = run()
    faulted, kinds = _faulted("dispatch_hang", run)
    assert all(
        np.array_equal(getattr(clean.results.flat[i], f),
                       getattr(faulted.results.flat[i], f))
        for i in range(clean.results.size) for f in _RESULT_FIELDS)
    assert kinds == ["fault_injected", "watchdog_timeout", "watchdog_retry"]
    assert kinds == _jax_kinds("dispatch_hang", monkeypatch, tmp_path)


def test_evict_storm_matches_jax(monkeypatch, tmp_path):
    jcfg = dataclasses.replace(jsmoke(jget_arch("internlm2-1.8b")),
                               dtype="float32")
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch("internlm2-1.8b")),
                              dtype="float32")
    model = params_from_numpy(cfg, jax.tree.map(
        np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0))), device="cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]

    def run():
        eng = ServeEngine(cfg, model, max_batch=4, max_len=64, page_size=8,
                          device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, prompt=p, max_new_tokens=6))
        return {r.req_id: list(r.generated) for r in eng.run()}

    clean = run()
    faulted, kinds = _faulted("evict_storm", run)
    assert faulted == clean
    assert kinds.count("fault_injected") == 3
    assert kinds == _jax_kinds("evict_storm", monkeypatch, tmp_path)


def test_plans_match_jax():
    for name in ("cache_corrupt", "dispatch_hang", "evict_storm"):
        got = resilience.FaultInjector.from_plan(name, seed=3)
        want = jresilience.FaultInjector.from_plan(name, seed=3)
        assert got.seed == want.seed == 3
        assert [dataclasses.astuple(f) for f in got.faults] == \
            [dataclasses.astuple(f) for f in want.faults]
    with pytest.raises(KeyError, match="cache_corrupt"):
        resilience.FaultInjector.from_plan("nope")
