"""The port's fleet engine against the JAX package's: the surrogate
decode (uint32 hash in int64 torch ops), FleetEngine on the
``serving_fleet`` mixes at reduced scale (the same finished ids,
tokens, stats and bit-equal meter totals), prefix sharing through the
refcounted pool, the translation budget and the evict_storm plan at
fleet scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ndp_sim import SERVING_FLEET as JSERVING_FLEET
from repro.serving import FleetEngine as JFleetEngine
from repro.serving import Request as JRequest
from repro.serving.fleet import _decode_fn as j_decode_fn
from repro.sim.cost_model import TranslationCostModel as JTCM
from repro.util import resilience as jresilience
from repro_torch.configs.ndp_sim import SERVING_FLEET
from repro_torch.serving import FleetEngine, FleetScheduler, Request
from repro_torch.serving import fleet as FL
from repro_torch.sim.cost_model import TranslationCostModel as TCM
from repro_torch.util import resilience

CPU = torch.device("cpu")
#: SERVING_FLEET's structure at a reduced count: 64 slots, 96 requests,
#: the per-step translation budget scaled with the slots (1/16)
REDUCED = dict({k: v for k, v in SERVING_FLEET.items() if k != "smoke"},
               max_batch=64, num_requests=96, prefix_groups=4,
               translation_budget=SERVING_FLEET["translation_budget"] / 16)


def _mix(build, p, seed, shared):
    """The request list of one ``benchmarks/serving_fleet.py`` run,
    restated (requests are mutated by the scheduler, so built per run)."""
    rng = np.random.default_rng(seed)
    reqs = []
    if shared:
        prefixes = {g: rng.integers(1, 30_000, p["prefix_len"])
                    for g in range(p["prefix_groups"])}
        for i in range(p["num_requests"]):
            g = i % p["prefix_groups"]
            tail = rng.integers(1, 30_000, p["tail_tokens"])
            reqs.append(build(i, np.concatenate([prefixes[g], tail]),
                              max_new_tokens=p["new_tokens"], prefix_id=g,
                              prefix_len=p["prefix_len"]))
    else:
        lo, hi = p["independent_prompt"]
        for i in range(p["num_requests"]):
            prompt = rng.integers(1, 30_000, rng.integers(lo, hi))
            reqs.append(build(i, prompt, max_new_tokens=p["new_tokens"]))
    return reqs


RUNS = {"shared": (0, True, True, None),
        "unshared": (0, True, False, None),
        "independent": (1, False, True, None),
        "budget": (0, True, True, "translation_budget")}


def _fleet(engine_cls, build, model, run, p=REDUCED, injector=None,
           res=None, **kw):
    seed, shared, sharing, budget = RUNS[run]
    eng = engine_cls(max_batch=p["max_batch"], max_len=p["max_len"],
                     page_size=p["page_size"], leaf_size=p["leaf_size"],
                     cost_model=model, prefix_sharing=sharing,
                     translation_budget=p[budget] if budget else None,
                     budget_mech=p["budget_mech"], **kw)
    for r in _mix(build, p, seed, shared):
        eng.submit(r)
    if injector is not None:
        with res.inject_faults(injector):
            done = eng.run()
    else:
        done = eng.run()
    return eng, done


def _observe(eng, done):
    rep = eng.throughput()
    rep.pop("decode_traces")
    return ([(r.req_id, list(r.generated), r.retries, r.failed)
             for r in done], rep,
            {k: v.tolist() for k, v in eng.meter.request_budgets().items()},
            eng.meter.total.tolist(),
            [(r.req_id, r.failed) for r in eng.sched.failed],
            eng.sched.pool.free_pages)


@pytest.mark.parametrize("run", list(RUNS))
def test_fleet_matches_jax(run):
    jeng, jdone = _fleet(JFleetEngine, JRequest.build, JTCM.pinned(), run)
    eng, done = _fleet(FleetEngine, Request.build, TCM.pinned(), run,
                       device="cpu")
    got, want = _observe(eng, done), _observe(jeng, jdone)
    assert got == want
    n = REDUCED["num_requests"]
    stats = got[1]["stats"]
    assert stats["completed"] + stats["shed"] == n
    if run != "budget":
        assert len(done) == n
        assert got[1]["peak_running"] == REDUCED["max_batch"]
    else:
        assert 0 < got[1]["peak_running"] < REDUCED["max_batch"]


def test_sharing_moves_radix_cycles_only():
    """With sharing on and off the tokens are identical; radix's cycles
    drop and its simulated tokens/s rise, ndpage's cycles are unchanged."""
    reps, gens = {}, {}
    for run in ("shared", "unshared"):
        eng, done = _fleet(FleetEngine, Request.build, TCM.pinned(), run,
                           device="cpu")
        reps[run] = eng.throughput()
        gens[run] = {r.req_id: r.generated for r in done}
    assert gens["shared"] == gens["unshared"]
    on, off = reps["shared"], reps["unshared"]
    assert on["translation_cycles"]["radix"] < \
        off["translation_cycles"]["radix"]
    assert on["translation_cycles"]["ndpage"] == \
        off["translation_cycles"]["ndpage"]
    assert on["tokens_per_sec"]["radix"] > off["tokens_per_sec"]["radix"]


def test_surrogate_decode_matches_jax_over_the_full_range():
    """Every token of the vocabulary at every position of the fleet's
    max_len, plus the int32 extremes, hash to the JAX package's tokens."""
    vocab, max_len = FL.VOCAB, SERVING_FLEET["max_len"]
    tok, pos = np.meshgrid(np.arange(vocab, dtype=np.int32),
                           np.arange(max_len, dtype=np.int32))
    tok, pos = tok.ravel(), pos.ravel()
    edge = np.array([0, 1, 2**31 - 1, 2**31 - 2, 2**16, 2**16 - 1,
                     123456789], np.int32)
    tok = np.concatenate([tok, edge, np.repeat(edge, edge.size)])
    pos = np.concatenate([pos, edge[::-1], np.tile(edge, edge.size)])
    want = np.asarray(j_decode_fn(vocab)(jnp.asarray(tok), jnp.asarray(pos)))
    got = FL._decode_fn(vocab, CPU)(torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    small = FL._decode_fn(1000, CPU)(torch.from_numpy(tok[:4096]),
                                     torch.from_numpy(pos[:4096]))
    np.testing.assert_array_equal(
        small.numpy(), np.asarray(j_decode_fn(1000)(
            jnp.asarray(tok[:4096]), jnp.asarray(pos[:4096]))))


def test_one_decode_function_per_device():
    n0 = FL.decode_trace_count()
    for _ in range(3):
        eng = FleetEngine(max_batch=8, max_len=16, page_size=4,
                          cost_model=TCM.pinned(), device="cpu")
        for i in range(5):
            eng.submit(Request.build(i, [1, 2, 3], max_new_tokens=2))
        eng.run()
    assert FL.decode_trace_count() - n0 <= 1
    assert eng.throughput()["decode_traces"] == FL.decode_trace_count()


def test_shared_pages_are_refcounted_and_survive_eviction():
    """Sharers map the same physical prefix pages (one allocation, one
    extra reference a sharer); evicting a sharer drops only its own
    references, in step with the JAX scheduler."""
    p = dict(REDUCED, num_requests=8, prefix_groups=2, prefix_len=16)
    scheds = []
    for engine_cls, build, kw in ((JFleetEngine, JRequest.build, {}),
                                  (FleetEngine, Request.build,
                                   {"device": "cpu"})):
        eng = engine_cls(max_batch=8, max_len=64, page_size=8,
                         cost_model=None, **kw)
        for r in _mix(build, p, 2, True):
            eng.submit(r)
        eng.sched.tick()
        eng.sched.admit()
        scheds.append(eng.sched)
    jsched, sched = scheds
    assert sched.num_running == 8 and len(sched._pfx_pages) == 2
    for pid, pages in sched._pfx_pages.items():
        np.testing.assert_array_equal(pages, jsched._pfx_pages[pid])
        assert [sched.pool.refcount(int(q)) for q in pages] == [4, 4]
    np.testing.assert_array_equal(sched.slot_pages, jsched.slot_pages)
    victim = sched.pick_victim_slot()
    assert victim == jsched.pick_victim_slot()
    pid = int(sched.slot_pfx[victim])
    pages = sched._pfx_pages[pid].copy()
    for s in (jsched, sched):
        s.preempt_slot(victim, reason="test")
    assert [sched.pool.refcount(int(q)) for q in pages] == \
        [jsched.pool.refcount(int(q)) for q in pages] == [3, 3]
    for b in np.flatnonzero(sched.slot_req >= 0):
        if sched.slot_pfx[b] == pid:
            np.testing.assert_array_equal(sched.slot_pages[b, :2], pages)
    assert pid in sched._pfx_pages


def test_evict_storm_is_bit_exact_at_fleet_scale():
    """The evict_storm plan at 256 concurrent slots: the storm run equals
    the clean run's tokens, and the JAX package's storm run in every
    observable."""
    p = dict(REDUCED, max_batch=256, num_requests=300, prefix_groups=4)

    def run(engine_cls, build, res, inject, **kw):
        plan = res.FaultInjector.from_plan("evict_storm") if inject else None
        return _fleet(engine_cls, build, (JTCM if res is jresilience
                                          else TCM).pinned(), "shared", p,
                      injector=plan, res=res, **kw)

    clean, cdone = run(FleetEngine, Request.build, resilience, False,
                       device="cpu")
    storm, sdone = run(FleetEngine, Request.build, resilience, True,
                       device="cpu")
    jstorm, jsdone = run(JFleetEngine, JRequest.build, jresilience, True)
    s = storm.sched.stats
    assert s["peak_running"] >= 256 and s["preempted"] >= 3
    assert s["resumed"] >= 3
    assert ({r.req_id: r.generated for r in cdone}
            == {r.req_id: r.generated for r in sdone})
    assert _observe(storm, sdone) == _observe(jstorm, jsdone)
    assert storm.sched.pool.free_pages == storm.sched.pool.num_pages


def test_refusals_match_jax():
    eng, jeng = (FleetEngine(max_batch=4, max_len=8, page_size=4,
                             device="cpu"),
                 JFleetEngine(max_batch=4, max_len=8, page_size=4))
    for e, build in ((eng, Request.build), (jeng, JRequest.build)):
        with pytest.raises(ValueError, match="max_new_tokens"):
            e.submit(build(0, [1, 2], max_new_tokens=0))
        with pytest.raises(ValueError, match="exceeds"):
            e.submit(build(0, [1] * 6, max_new_tokens=8))
        with pytest.raises(ValueError, match="prefix_id"):
            r = build(0, [1, 2], max_new_tokens=2, prefix_id=1,
                      prefix_len=1)
            r.prefix_id = -1
            e.submit(r)
        with pytest.raises(ValueError, match="cost_model"):
            e.throughput()
    with pytest.raises(ValueError, match="meter"):
        FleetScheduler(num_pages=64, max_batch=4, page_size=4, max_len=16,
                       translation_budget=100.0)
    for build in (Request.build, JRequest.build):
        with pytest.raises(ValueError, match="prefix_len"):
            build(0, [1, 2, 3], prefix_id=1, prefix_len=9)
    r = Request.build(0, [1, 2, 3], prefix_id=1, prefix_len=2)
    assert (r.prefix_id, r.prefix_len, r.submit_tick) == (1, 2, -1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetEngine(max_batch=4)


def test_fleet_config_equal():
    assert SERVING_FLEET == JSERVING_FLEET
