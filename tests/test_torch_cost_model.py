"""The port's translation cost model against the JAX package's: the
registry's serving orgs, the pinned table, the derivation through the
simulator (on the CPU path here), the memo, the meter's step and slot
paths (bit-equal float64 totals) and the numpy line twins against the
JAX package's line counters (exact)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ndp_sim as JCFG
from repro.core import block_table as JBT
from repro.sim import cost_model as JCM
from repro.sim import mechanisms as JMS
from repro_torch.configs import ndp_sim as CFG
from repro_torch.core import block_table as BT
from repro_torch.sim import cost_model as CM
from repro_torch.sim import mechanisms as MS

#: the derived costs are rounded to 3 decimals from float sums that
#: agree to rtol 1e-5, so the last digit may flip
COST_ATOL = 2e-3

ZOO_MECHS = ("radix", "ndpage", "victima", "picorel", "range_table",
             "ideal")


def test_serving_config_data_equal():
    assert CFG.SERVING_COST == JCFG.SERVING_COST
    assert CFG.SERVING_FLEET == JCFG.SERVING_FLEET


def test_serving_org_matches_over_the_registry():
    names = JMS.registered_names()
    assert set(MS.registered_names()) == set(names)
    for name in names:
        assert CM.serving_org(name) == JCM.serving_org(name), name
    assert (CM.ORG_FLAT, CM.ORG_RADIX, CM.ORG_NONE, CM.ORG_SEG,
            CM.ORG_INV) == (JCM.ORG_FLAT, JCM.ORG_RADIX, JCM.ORG_NONE,
                            JCM.ORG_SEG, JCM.ORG_INV)


def test_pinned_table_equal():
    assert CM.PINNED_COSTS == JCM.PINNED_COSTS
    for mcpt in (None, 150.0):
        got = CM.TranslationCostModel.pinned(mcpt)
        want = JCM.TranslationCostModel.pinned(mcpt)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    m = CM.TranslationCostModel.pinned()
    assert m.cost("ndpage").walk < m.cost("radix").walk
    assert m.cost("ideal").walk == 0.0


def _same_costs(got, want):
    assert got.mechs == want.mechs
    assert (got.machine, got.freq_ghz, got.model_cycles_per_token) == (
        want.machine, want.freq_ghz, want.model_cycles_per_token)
    for m in want.mechs:
        g, w = got.cost(m), want.cost(m)
        assert (g.tlb_hit, g.org) == (w.tlb_hit, w.org), m
        np.testing.assert_allclose([g.walk, g.pte_line],
                                   [w.walk, w.pte_line], rtol=0,
                                   atol=COST_ATOL, err_msg=m)


@pytest.mark.parametrize("point", ["serving_cost", "zoo", "banked"])
def test_from_sim_matches_jax(point):
    """One simulator dispatch per package at the same point; on the
    port the plain scan and epilogue (the card runs their kernels)."""
    if point == "serving_cost":
        jm, tm, kw = JCFG.ndp_machine(4), CFG.ndp_machine(4), {}
    elif point == "zoo":
        jm, tm = JCFG.zoo_machine(2), CFG.zoo_machine(2)
        kw = dict(mechs=ZOO_MECHS, workload="rnd")
    else:
        jm = dataclasses.replace(JCFG.ndp_machine(2), memory="banked")
        tm = dataclasses.replace(CFG.ndp_machine(2), memory="banked")
        kw = dict(model_cycles_per_token=500.0)
    want = JCM.TranslationCostModel.from_sim(jm, use_cache=False, **kw)
    got = CM.TranslationCostModel.from_sim(tm, use_cache=False,
                                           device="cpu", **kw)
    assert got.source == want.source == "sweep"
    _same_costs(got, want)


def test_memo_round_trips_keyed_by_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
    mach = CFG.ndp_machine(2)
    a = CM.TranslationCostModel.from_sim(mach, device="cpu")
    assert a.source == "sweep"
    d = tmp_path / "repro_torch"
    memos = [f for f in os.listdir(d) if f.startswith("costmodel_")
             and not f.endswith(".sha256")]
    assert len(memos) == 1 and (d / (memos[0] + ".sha256")).exists()
    b = CM.TranslationCostModel.from_sim(mach, device="cpu",
                                         model_cycles_per_token=200.0)
    assert b.source == "cache" and b.costs == a.costs
    assert b.model_cycles_per_token == 200.0
    args = (mach, tuple(CFG.SERVING_COST["mechs"]), "smoke", "dlrm")
    cpu_path = CM._memo_path(*args, device="cpu")
    assert cpu_path == str(d / memos[0])
    assert CM._memo_path(*args, device="cuda") != cpu_path
    assert CM._memo_path(*args, device="cuda:0") == CM._memo_path(
        *args, device="cuda")
    # a corrupt memo is quarantined and re-derived, never served
    with open(cpu_path, "w") as f:
        f.write("{not json")
    c = CM.TranslationCostModel.from_sim(mach, device="cpu")
    assert c.source == "sweep" and c.costs == a.costs
    # use_cache=False neither reads nor writes the memo
    os.remove(cpu_path)
    CM.TranslationCostModel.from_sim(mach, device="cpu", use_cache=False)
    assert not os.path.exists(cpu_path)


def test_no_fallback_hides_the_card(monkeypatch):
    """On a CUDA device ``source="auto"`` propagates a failed derivation;
    only the CPU falls back to the pinned table, as the reference does."""
    if not torch.cuda.is_available():
        for call in (lambda: CM.TranslationCostModel.for_machine(),
                     lambda: CM.TranslationCostModel.for_machine(
                         source="auto", device="cuda"),
                     lambda: CM.TranslationCostModel.for_machine(
                         source="sweep"),
                     lambda: CM.TranslationCostModel.from_sim(
                         CFG.ndp_machine(4), use_cache=False),
                     lambda: CM._main([])):
            with pytest.raises(RuntimeError, match="cuda"):
                call()

    def broken(cls, mach, **kw):
        raise RuntimeError("nvcc failed to build lru_scan")

    monkeypatch.setattr(CM.TranslationCostModel, "from_sim",
                        classmethod(broken))
    monkeypatch.setattr(CM, "resolve_device", torch.device)
    with pytest.raises(RuntimeError, match="nvcc"):
        CM.TranslationCostModel.for_machine(source="auto", device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        CM.TranslationCostModel.for_machine(source="sweep", device="cpu")
    fallback = CM.TranslationCostModel.for_machine(source="auto",
                                                   device="cpu")
    assert fallback.source == "pinned"
    pinned = CM.TranslationCostModel.for_machine(source="pinned",
                                                 device="cuda")
    assert pinned.source == "pinned"
    with pytest.raises(ValueError, match="source"):
        CM.TranslationCostModel.for_machine(source="bogus", device="cpu")


def test_main_prints_the_serving_table_on_cpu(capsys):
    assert CM._main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["machine"] == JCM.PINNED_COSTS["machine"]
    assert tuple(out["mechs"]) == JCM.PINNED_COSTS["mechs"]
    for m, c in out["costs"].items():
        p = JCM.PINNED_COSTS["costs"][m]
        assert c[0] == p[0] and c[3] == p[3]
        np.testing.assert_allclose(c[1:3], p[1:3], rtol=0.05)


# ---------------------------------------------------------------------------
# lookup pricing, the meter and the numpy line twins
# ---------------------------------------------------------------------------
def _zoo_models():
    """A model whose mechanisms cover every org, in both packages."""
    costs = {"radix": (1.0, 480.5, 90.25, "radix"),
             "ndpage": (1.0, 290.5, 100.0, "flat"),
             "picorel": (2.0, 310.0, 95.5, "inverted"),
             "range_table": (1.0, 250.75, 80.0, "segment"),
             "ideal": (0.0, 0.0, 0.0, "none")}
    out = []
    for mod in (JCM, CM):
        out.append(mod.TranslationCostModel(
            mechs=tuple(costs), costs=tuple(mod.LookupCost(*c)
                                            for c in costs.values()),
            machine="zoo-2c", freq_ghz=2.6, model_cycles_per_token=700.0,
            source="pinned"))
    return out


def _models(kind):
    if kind == "pinned":
        return JCM.TranslationCostModel.pinned(), \
            CM.TranslationCostModel.pinned()
    return tuple(_zoo_models())


@pytest.mark.parametrize("kind", ["pinned", "zoo"])
def test_lookup_cycles_and_tokens_per_sec_equal(kind):
    jm, tm = _models(kind)
    assert tm.needs_zoo_lines == jm.needs_zoo_lines == (kind == "zoo")
    rng = np.random.default_rng(1)
    hit = rng.random(40) < 0.5
    counts = [rng.integers(0, 9, 40) for _ in range(4)]
    for k in (2, 4):
        got = tm.lookup_cycles(hit, *counts[:k])
        want = jm.lookup_cycles(hit, *counts[:k])
        assert got.dtype == want.dtype and (got == want).all()
    trans = rng.random(len(tm.mechs)) * 1e5
    for mcpt in (None, 150.0):
        assert tm.tokens_per_sec(123, trans, mcpt) == \
            jm.tokens_per_sec(123, trans, mcpt)
    assert tm.tokens_per_sec(0, trans) == jm.tokens_per_sec(0, trans)


def _steps(seed, n_steps=12, n=6, maxp=16):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        flat = rng.integers(0, 300, (n, maxp)).astype(np.int32)
        flat[rng.random((n, maxp)) < 0.35] = -1
        flat[:, :4] = flat[0, :4]                     # a shared leaf
        ids = rng.choice(9, n, replace=False).tolist()
        yield ids, rng.random(n) < 0.4, flat


def _meter_state(m):
    budgets = m.request_budgets()
    return (m.total.tolist(), m.tokens, m.steps, m.hits, m.misses,
            {k: v.tolist() for k, v in budgets.items()},
            m.per_step_cycles(), m.translation_cycles(), m.tokens_per_sec(),
            [s.tolist() for s in m.step_cycles])


@pytest.mark.parametrize("kind", ["pinned", "zoo"])
@pytest.mark.parametrize("leaf", [4, 5, 16])
def test_meter_record_step_bit_equal(kind, leaf):
    jm, tm = _models(kind)
    meters = [JCM.TranslationMeter(jm), CM.TranslationMeter(tm)]
    for ids, hit, flat in _steps(leaf):
        for m in meters:
            m.record_step(ids, hit, flat, leaf)
        for m in meters:
            m.retire_request(ids[0])
    assert _meter_state(meters[1]) == _meter_state(meters[0])


@pytest.mark.parametrize("kind", ["pinned", "zoo"])
@pytest.mark.parametrize("shared", [False, True])
def test_meter_record_slots_bit_equal(kind, shared):
    jm, tm = _models(kind)
    meters = [JCM.TranslationMeter(jm, max_slots=12),
              CM.TranslationMeter(tm, max_slots=12)]
    rng = np.random.default_rng(7)
    owner = {}
    for step, (ids, hit, flat) in enumerate(_steps(11 + shared)):
        slots = rng.choice(12, len(ids), replace=False)
        for s, rid in zip(slots, ids):
            s = int(s)
            if owner.get(s) not in (None, rid):
                for m in meters:
                    m.release_slot(s, retire=bool(step % 2))
                owner[s] = None
            if owner.get(s) is None:
                for m in meters:
                    m.bind_slot(s, rid)
                owner[s] = rid
        for m in meters:
            m.record_slots(slots, hit, flat, 4, shared_leaves=shared)
    assert _meter_state(meters[1]) == _meter_state(meters[0])
    acc = np.sum(list(meters[1].request_budgets().values()), axis=0)
    np.testing.assert_allclose(acc, meters[1].total, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_numpy_line_twins_equal_the_jax_counters(seed):
    """The meter's numpy twins against the JAX package's line counters
    and its own twins, exactly."""
    rng = np.random.default_rng(seed)
    b, maxp, ls = 7, 32, [4, 8, 16, 32][seed]
    flat = rng.integers(0, 500, (b, maxp)).astype(np.int32)
    flat[rng.random((b, maxp)) < 0.3] = -1
    flat[:, :ls] = flat[2, :ls]                       # planted shared leaf
    flat[4] = -1                                      # an empty row
    flat[5, :] = np.arange(maxp)                      # one physical run
    assert CM._usable_leaf_size(maxp, ls) == JCM._usable_leaf_size(maxp, ls)
    jf = jnp.asarray(flat)
    lf, lr = CM._np_row_lines(flat, ls)
    np.testing.assert_array_equal(
        lf, np.asarray(JBT.count_pte_lines(jf, JBT.FLAT)))
    np.testing.assert_array_equal(lr, np.asarray(JBT.count_pte_lines(
        JBT.radix_from_flat(jf, ls), JBT.RADIX)))
    slf, slr = CM._np_row_lines_shared(flat, ls)
    jslf, jslr = JCM._np_row_lines_shared(flat, ls)
    np.testing.assert_array_equal(slf, jslf)
    np.testing.assert_array_equal(slr, jslr)
    np.testing.assert_array_equal(
        slr, np.asarray(JBT.count_pte_lines_shared(jf, ls)))
    np.testing.assert_array_equal(slf, lf)
    for twin, jref in ((CM._np_seg_lines, JBT.count_segment_lines),
                       (CM._np_inv_lines, JBT.count_inverted_lines)):
        np.testing.assert_array_equal(twin(flat), np.asarray(jref(jf)))


def _rows(seed, b=6, maxp=32, shared_leaf=0):
    """Seeded mapping rows with holes, an empty row, a contiguous run and
    (``shared_leaf`` > 0) one leaf planted identically in every row."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 400, (b, maxp)).astype(np.int32)
    flat[rng.random((b, maxp)) < 0.3] = -1
    flat[1, :20] = np.arange(100, 120)                 # one physical run
    flat[1, 20:] = -1
    if shared_leaf:
        flat[:, :shared_leaf] = flat[0, :shared_leaf]
    flat[3] = -1                                       # an empty row
    return flat


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("leaf", [4, 8, 16])
def test_line_twins_match_every_jax_organization(seed, leaf):
    """Each organization's count (flat, radix, shared radix, segment,
    inverted) and the ragged line groups, against the JAX package's
    ``count_pte_lines`` by mode."""
    flat = _rows(seed, shared_leaf=leaf if seed else 0)
    jf = jnp.asarray(flat)
    jr = JBT.radix_from_flat(jf, leaf_size=leaf)
    lf, lr = CM._np_row_lines(flat, leaf)
    for got, jt, mode in ((lf, jf, JBT.FLAT), (lr, jr, JBT.RADIX),
                          (CM._np_seg_lines(flat), jf, JBT.SEGMENT),
                          (CM._np_inv_lines(flat), jf, JBT.INVERTED)):
        np.testing.assert_array_equal(
            got, np.asarray(JBT.count_pte_lines(jt, mode)), err_msg=mode)
    np.testing.assert_array_equal(
        CM._np_row_lines_shared(flat, leaf)[1],
        np.asarray(JBT.count_pte_lines_shared(jf, leaf)))
    for n in (5, 16, 17, 33):                          # ragged spans
        m = np.random.default_rng(seed).random((3, n)) < 0.4
        np.testing.assert_array_equal(
            CM._np_group_lines(m), np.asarray(JBT._lines_of(jnp.asarray(m))))


def test_shared_leaf_lines_charged_to_the_first_row():
    flat = np.full((3, 16), -1, np.int32)
    flat[:, :4] = [7, 8, 9, 10]                       # one shared leaf
    flat[1, 4:8] = [1, 2, 3, 4]
    got = CM._np_row_lines_shared(flat, 4)[1]
    np.testing.assert_array_equal(
        got, np.asarray(JBT.count_pte_lines_shared(jnp.asarray(flat), 4)))
    assert got.tolist() == [2, 2, 1]


def test_line_constants_equal():
    assert (BT.PTE_PER_LINE, BT.RANGES_PER_LINE) == (JBT.PTE_PER_LINE,
                                                     JBT.RANGES_PER_LINE)


def test_usable_leaf_size_matches():
    for maxp in range(1, 40):
        for ls in (1, 3, 4, 8, 16, 64):
            assert CM._usable_leaf_size(maxp, ls) == \
                JCM._usable_leaf_size(maxp, ls)
