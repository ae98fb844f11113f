"""The port's design-space search (``repro_torch.sim.search``) against the
JAX package's (``repro.sim.search``), on the CPU's plain scan: on the
tiny space of ``tests/test_search.py`` and on the ``quick`` preset the
same genomes are evaluated in the same order and the same frontier comes
out, objectives within rtol 1e-5; the tiny space's bucket and bucket-plan
counts equal the reference's; a 24-genome generation dispatches as 6
buckets; dominance and Pareto laws; the eval cache is reused from the
port's own directory; the CLI merges only into a file it is given.

Chunk lengths 272/304 are unique to this file (fresh cache keys in both
packages).
"""
import dataclasses
import importlib
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.sim import _search as J
from repro_torch.sim import _search as T
from repro_torch.sim import _sweep as TSW

RTOL = 1e-5
CHUNK = 272
CHUNK_FRESH = 304
LEN = 272


def _space(mod, **over):
    base = dict(
        name="tiny",
        knobs=(("pwc_entries", (16, 32)),
               ("flatten", ("pl2", "pl3")),
               ("l1_bypass", (True, False))),
        cores=2, workloads=("rnd", "xs"),
        n_random=5, population=8, generations=2, offspring=4,
        trace_len=LEN, chunk=CHUNK, preset="smoke", seed=11)
    base.update(over)
    return mod.SearchSpace(**base)


def assert_same_search(got, want):
    """Same genomes evaluated in the same order with the same origins and
    mechanisms, the same frontier in the same order, objectives and
    per-workload speedups within RTOL, the same verdict."""
    assert [dict(c.genome) for c in got.candidates] == \
        [dict(c.genome) for c in want.candidates]
    assert [(c.origin, c.gen, c.mech) for c in got.candidates] == \
        [(c.origin, c.gen, c.mech) for c in want.candidates]
    assert [dict(c.genome) for c in got.frontier] == \
        [dict(c.genome) for c in want.frontier]
    for a, b in zip(got.candidates, want.candidates):
        assert a.objectives.keys() == b.objectives.keys()
        for k in a.objectives:
            np.testing.assert_allclose(a.objectives[k], b.objectives[k],
                                       rtol=RTOL, atol=0, err_msg=k)
        for w in a.per_workload:
            np.testing.assert_allclose(a.per_workload[w], b.per_workload[w],
                                       rtol=RTOL, atol=0, err_msg=w)
    for k in ("dominates_paper", "paper_on_frontier", "n_dominating"):
        assert got.verdict[k] == want.verdict[k], k


@pytest.fixture(scope="module")
def pair():
    """One tiny-space search in each package, shared by the read-only
    tests."""
    return (T.search(_space(T), use_cache=False, device="cpu"),
            J.search(_space(J), use_cache=False))


def test_tiny_space_matches_reference(pair):
    got, want = pair
    assert_same_search(got, want)
    for k in ("seed", "generations", "evaluated", "lanes_dispatched",
              "runner_compiles", "dispatch_buckets", "distinct_buckets",
              "eval_cache_hits"):
        assert got.provenance[k] == want.provenance[k], k
    assert got.provenance["runner_compiles"] <= \
        got.provenance["distinct_buckets"]
    assert got.paper.origin == "paper"
    assert dict(got.paper.genome) == {"pwc_entries": 32, "flatten": "pl2",
                                      "l1_bypass": True}


def test_quick_space_matches_reference():
    got = T.search("quick", use_cache=False, device="cpu")
    want = J.search("quick", use_cache=False)
    assert_same_search(got, want)
    assert got.provenance["evaluated"] == want.provenance["evaluated"] > 8


def test_same_seed_same_frontier(pair):
    got, _ = pair
    again = T.search(_space(T), use_cache=False, device="cpu")
    assert [dict(c.genome) for c in again.candidates] == \
        [dict(c.genome) for c in got.candidates]
    assert [c.objectives for c in again.frontier] == \
        [c.objectives for c in got.frontier]


def test_generation_of_24_is_six_buckets():
    """24 candidates over 3 PWC shapes x 8 mechanism structures dispatch
    as (shape x walk-fn tuple) buckets: 6 plans, not 24, the reference's
    counts (``tests/test_search.py``)."""
    knobs = (("pwc_entries", (8, 16, 32)), ("flatten", ("pl2", "pl3")),
             ("l1_bypass", (True, False)), ("huge", (False, True)))
    genomes = [tuple(g) for g in itertools.product(
        (8, 16, 32), ("pl2", "pl3"), (True, False), (False, True))]
    assert len(genomes) == 24
    space = _space(T, knobs=knobs, workloads=("rnd",), chunk=CHUNK_FRESH)
    evals, st = T.evaluate_genomes(space, genomes, device="cpu")
    assert len(evals) == 24
    assert (st["points"], st["buckets"], st["distinct_shapes"],
            st["runner_compiles"]) == (24, 6, 3, 6)
    assert sorted(b["lanes"] for b in st["per_bucket"]) == [4] * 6
    assert len({T.mech_for(space, g) for g in genomes}) == 8


@pytest.mark.parametrize("name", ("default", "zoo", "memory", "quick"))
def test_genome_helpers_match_reference(name):
    ts, js = T.SearchSpace.named(name), J.SearchSpace.named(name)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert T.paper_genome(ts) == J.paper_genome(js)
    rng = np.random.default_rng(5)
    for _ in range(12):
        g = T._random_genome(rng, ts)
        assert T.genome_key(ts, g) == J.genome_key(js, g)
        assert T.mech_for(ts, g) == J.mech_for(js, g)
        assert T.sram_kb(ts, g) == J.sram_kb(js, g)
        assert dataclasses.asdict(T.build_machine(ts, g)) == \
            dataclasses.asdict(J.build_machine(js, g))


def test_space_errors():
    with pytest.raises(KeyError, match="unknown search space"):
        T.resolve_space("nope")
    with pytest.raises(ValueError, match="duplicate"):
        _space(T, knobs=(("pwc_entries", (16, 16)),))


def test_breeding_is_the_reference_s():
    """The seeded sampling, mutation and crossover draw the same genomes
    from the same generator state."""
    ts, js = T.SearchSpace.named("default"), J.SearchSpace.named("default")
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    a = T._sample_unique(r1, ts, 20, set())
    b = J._sample_unique(r2, js, 20, set())
    assert a == b
    assert T._breed(r1, ts, a[:4], 10, set(a)) == \
        J._breed(r2, js, b[:4], 10, set(b))


# ---------------------------------------------------------------------------
# dominance / frontier laws
# ---------------------------------------------------------------------------
def test_dominance_and_pareto_laws():
    rng = np.random.default_rng(0)
    names = [n for n, _ in T.OBJECTIVES]
    assert T.OBJECTIVES == J.OBJECTIVES
    for _ in range(25):
        vecs = [dict(zip(names, row))
                for row in rng.random((rng.integers(1, 20), 3))]
        # ties on one objective
        vecs += [dict(vecs[0], sram_kb=vecs[-1]["sram_kb"])]
        front = T.pareto_indices(vecs)
        assert front == J.pareto_indices(vecs) and front
        for i, v in enumerate(vecs):
            dominated = any(T.dominates(w, v)
                            for j, w in enumerate(vecs) if j != i)
            assert (i in front) == (not dominated)
        for v in vecs:
            assert not T.dominates(v, v)
        for a in vecs:
            for b in vecs:
                assert T.dominates(a, b) == J.dominates(a, b)
                assert not (T.dominates(a, b) and T.dominates(b, a))


def test_search_frontier_is_nondominated(pair):
    got, _ = pair
    vecs = [c.objectives for c in got.frontier]
    assert T.pareto_indices(vecs) == list(range(len(vecs)))
    for c in got.candidates:
        if c.objectives in vecs:
            continue
        assert any(T.dominates(f.objectives, c.objectives)
                   for f in got.frontier), c.genome


# ---------------------------------------------------------------------------
# the eval cache, the CLI
# ---------------------------------------------------------------------------
def test_eval_cache_reuse(tmp_path, monkeypatch):
    """A warm eval cache reproduces the frontier without a single new
    lane; it lives in the port's own directory, keyed by device."""
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
    space = _space(T, n_random=2, generations=1, offspring=2)
    cold = T.search(space, use_cache=True, device="cpu")
    warm = T.search(space, use_cache=True, device="cpu")
    assert cold.provenance["lanes_dispatched"] > 0
    assert warm.provenance["lanes_dispatched"] == 0
    assert warm.provenance["eval_cache_hits"] > 0
    assert [c.objectives for c in warm.frontier] == \
        [c.objectives for c in cold.frontier]
    files = [f for f in os.listdir(tmp_path / "repro_torch")
             if f.startswith("search_evals_tiny_") and f.endswith(".json")]
    assert len(files) == 1
    assert not [f for f in os.listdir(tmp_path) if f.startswith("search_")]
    path = T._eval_cache_path(space, "cpu")
    assert os.path.basename(path) == files[0]
    assert T._eval_cache_path(space, "cuda") != path


def test_cli_merges_only_into_a_given_file(pair, tmp_path, monkeypatch,
                                           capsys):
    got, _ = pair
    seen = {}

    def fake(name, **kw):
        seen.update(kw, name=name)
        return got

    monkeypatch.setattr(T, "search", fake)
    monkeypatch.chdir(tmp_path)
    assert T._main(["--quick", "--device", "cpu", "--no-cache"]) == 0
    assert seen == {"name": "quick", "seed": None, "use_cache": False,
                    "device": "cpu"}
    assert os.listdir(tmp_path) == []
    out = capsys.readouterr().out
    assert "frontier (mean_speedup / sram_kb / worst_ptw):" in out
    assert "paper config" in out

    path = tmp_path / "bench.json"
    path.write_text(json.dumps({"figures": {"x": 1}}))
    assert T._main(["--space", "memory", "--device", "cpu",
                    "--out", str(path)]) == 0
    data = json.loads(path.read_text())
    assert data["figures"] == {"x": 1}
    assert data["search"]["evaluated"] == len(got.candidates)
    assert data["search"]["frontier"] == [c.to_json_dict()
                                          for c in got.frontier]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_card_is_the_default_and_there_is_no_fallback():
    with pytest.raises(RuntimeError, match="is_available"):
        T.search(_space(T, n_random=0, generations=0), use_cache=False)
    with pytest.raises(RuntimeError, match="is_available"):
        T.evaluate_genomes(_space(T), [(32, "pl2", True)])


def test_old_paths_warn_and_reexport(monkeypatch):
    import repro_torch.sim as pkg
    for name, impl, names in (
            ("repro_torch.sim.search", T, ("search", "SearchSpace",
                                           "evaluate_genomes")),
            ("repro_torch.sim.sweep", TSW, ("sweep", "run_bucketed",
                                            "apply_param"))):
        # importing the module rebinds the package's function of the same
        # name to it: both are restored after the test
        attr = name.rsplit(".", 1)[1]
        monkeypatch.setattr(pkg, attr, getattr(pkg, attr))
        monkeypatch.delitem(sys.modules, name, raising=False)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            mod = importlib.import_module(name)
        for n in names:
            assert getattr(mod, n) is getattr(impl, n)
