"""The port's sweep engine (``repro_torch.sim.sweep``) against the JAX
package's (``repro.sim.sweep``), on the CPU's plain scan: the same grids
give the same points, buckets, shapes and bucket plans ("compiles"),
integer counters equal and cycles within rtol 1e-5; a one-point grid is
the port's ``simulate``; ``SweepResult`` selection round-trips;
``apply_param`` reaches nested fields and raises as the reference does;
checkpoints resume with no dispatch, re-dispatch a corrupt bucket, are
off by default, and an injected dispatch fault is retried to the same
results.

Chunk lengths 208-272 are unique to this file, so the bucket-plan and
runner-cache accounting of both packages starts from fresh keys (each
cache is keyed on (shape, walk fns, chunk, batched) and process-wide).
"""
import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from repro.sim import apply_param as japply_param
from repro.sim import sweep as jsweep
from repro.sim import _sweep as JSW
from repro.configs import ndp_sim as JC
from repro_torch.configs import ndp_sim as TC
from repro_torch.sim import apply_param, run_bucketed, simulate, sweep
from repro_torch.sim import _sweep as TSW
from repro_torch.sim import simulator as TSIM
from repro_torch.util import resilience
from repro_torch.workloads import generate_trace

RTOL = 1e-5
INT_FIELDS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
              "pte_mem", "data_l1_misses", "data_mem")
FLOAT_FIELDS = ("cycles", "trans_cycles", "walk_cycles")
LEN = 600
CHUNK_SELECT = 232
CHUNK_CKPT = 248
CHUNK_FAULT = 264
#: grid shapes of the named presets, cut to 2 cores, two workloads and
#: LEN-entry windows; each a chunk of its own
GRIDS = {
    "l1_bypass": (224, {"mechs": (("radix", "ndpage", "ideal"),
                                  ("radix", "ndpage_nobyp", "ideal")),
                        "workload": ("rnd", "bc")}, {}),
    "pwc_size": (240, {"pwc_entries": (8, 16, 32, 64),
                       "workload": ("rnd", "xs")}, {}),
    "mem_latency": (208, {"memory.latency": (60.0, 240.0),
                          "workload": ("rnd", "bc")}, {}),
    "banked_timing": (216, {"memory_model": ("banked",),
                            "memory.t_cas": (15.0, 40.0),
                            "workload": ("rnd",)}, {}),
    "victima_reach": (272, {"ctlb_kb": (512,), "workload": ("xs",)},
                      {"mechs": ("radix", "victima", "ideal")}),
}


def assert_results_match(got, want, exact=False):
    assert got.mechs == want.mechs
    assert got.accesses == want.accesses
    assert np.array_equal(got.instructions, want.instructions)
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if exact:
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=f)


def bucket_view(stats):
    return [(b["shape"], b["walk_fns"], b["points"], b["lanes"],
             b["compiles"]) for b in stats["per_bucket"]]


# ---------------------------------------------------------------------------
# grids against the JAX package
# ---------------------------------------------------------------------------
def test_one_point_grid_equals_simulate():
    r = sweep({"workload": ("rnd",)}, cores=2, trace_len=LEN, seed=1234,
              chunk=512, device="cpu")
    assert r.stats["points"] == 1 and r.stats["buckets"] == 1
    want = simulate(TC.ndp_machine(2),
                    generate_trace("rnd", 2, length=LEN, seed=1234,
                                   preset="smoke"),
                    chunk=512, device="cpu")
    assert_results_match(r.point(workload="rnd"), want, exact=True)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_matches_reference(name):
    chunk, grid, kw = GRIDS[name]
    got = sweep(grid, cores=2, trace_len=LEN, chunk=chunk, device="cpu",
                **kw)
    want = jsweep(grid, cores=2, trace_len=LEN, chunk=chunk, **kw)
    assert got.axes == want.axes
    for k in ("points", "buckets", "distinct_shapes", "runner_compiles",
              "resumed_buckets", "chunk", "trace_len"):
        assert got.stats[k] == want.stats[k], k
    assert bucket_view(got.stats) == bucket_view(want.stats)
    for a, b in zip(got.results.flat, want.results.flat):
        assert_results_match(a, b)


@pytest.mark.parametrize("name", sorted(TC.SWEEPS))
def test_named_preset_points_and_buckets(name):
    """Every named preset resolves to the reference's points (machines,
    workloads, mechanisms) and bucket keys, without running them."""
    def points(mod, cfg):
        spec = mod.named_sweep(name)
        axes = dict(spec["axes"])
        out = []
        for combo in itertools.product(*axes.values()):
            out.append(mod._resolve_point(
                dict(zip(axes, combo)), spec.get("base", "ndp"),
                spec.get("cores", 4), "rnd",
                spec.get("mechs", cfg.DEFAULT_MECHS)))
        return out

    import repro.sim.mechanisms as JM
    import repro_torch.sim.mechanisms as TM
    got, want = points(TSW, TM), points(JSW, JM)
    assert len(got) == len(want) > 0
    keys = set()
    for a, b in zip(got, want):
        assert dataclasses.asdict(a.mach) == dataclasses.asdict(b.mach)
        assert (a.workload, a.mechs) == (b.workload, b.mechs)
        shape = TSIM.machine_shape(a.mach)
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JSW.machine_shape(b.mach))
        qn = tuple(getattr(f, "__qualname__", None)
                   for f in TSIM._walk_fns(a.mechs))
        assert qn == tuple(getattr(f, "__qualname__", None)
                           for f in JSW._walk_fns(b.mechs))
        keys.add((shape, qn))
    buckets = {"pwc_size": 4, "tlb_size": 4, "l1_bypass": 1,
               "flatten_level": 2, "core_scaling": 3, "mem_latency": 1,
               "banked_timing": 1, "zoo": 1, "victima_reach": 4}
    assert len(keys) == buckets[name]


# ---------------------------------------------------------------------------
# SweepResult
# ---------------------------------------------------------------------------
class TestSelect:
    @pytest.fixture(scope="class")
    def res(self):
        return sweep({"memory.latency": (100, 170),
                      "workload": ("rnd", "bc", "bfs")},
                     cores=2, trace_len=LEN, chunk=CHUNK_SELECT,
                     device="cpu")

    def test_select_round_trips_every_axis(self, res):
        full = res.scalar("avg_ptw_latency", "radix")
        for dim, (name, vals) in enumerate(res.axes.items()):
            parts = [res.select(**{name: v}) for v in vals]
            for p in parts:
                assert name not in p.axes
            restacked = np.stack(
                [p.scalar("avg_ptw_latency", "radix") for p in parts],
                axis=dim)
            np.testing.assert_array_equal(restacked, full)
            ident = res.select(**{name: list(vals)})
            assert ident.axes == res.axes
            np.testing.assert_array_equal(
                ident.scalar("avg_ptw_latency", "radix"), full)

    def test_select_subsets_and_reorders(self, res):
        sub = res.select(workload=["bfs", "rnd"])
        assert sub.axes["workload"] == ("bfs", "rnd")
        np.testing.assert_array_equal(
            sub.speedup("ndpage")[:, 1],
            res.select(workload="rnd").speedup("ndpage"))

    def test_point_and_errors(self, res):
        p = res.point(**{"memory.latency": 100, "workload": "bc"})
        assert p.mechs[0] == "radix"
        a = (res.select(**{"memory.latency": 170})
             .select(workload="bfs").results[()])
        assert a is res.point(**{"memory.latency": 170, "workload": "bfs"})
        with pytest.raises(KeyError, match="every axis pinned"):
            res.point(**{"memory.latency": 100})
        with pytest.raises(KeyError, match="unknown sweep axes"):
            res.select(nope=1)
        with pytest.raises(KeyError, match="no value"):
            res.select(**{"memory.latency": 999})

    def test_mechs_axis_selects_a_tuple(self):
        r = sweep({"mechs": (("radix", "ndpage"), ("radix", "ideal"))},
                  cores=1, trace_len=256, chunk=CHUNK_SELECT, device="cpu")
        assert r.point(mechs=("radix", "ideal")).mechs == ("radix", "ideal")
        sub = r.select(mechs=[("radix", "ideal")])
        assert sub.axes["mechs"] == (("radix", "ideal"),)


# ---------------------------------------------------------------------------
# apply_param and the errors of a grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path,value", [
    ("pwc_entries", 64), ("l1_dtlb.entries", 128), ("l2_tlb.entries", 3072),
    ("l1d.size_bytes", 65536), ("memory.latency", 240.0),
    ("memory.t_cas", 40.0), ("memory_model", "banked"), ("ctlb_kb", 512)])
def test_apply_param_matches_reference(path, value):
    got = apply_param(TC.ndp_machine(2), path, value)
    want = japply_param(JC.ndp_machine(2), path, value)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TC.ndp_machine(2).l1_dtlb.entries == 64     # original untouched


def test_apply_param_errors():
    m = TC.ndp_machine(2)
    for mod, mach in ((TSW, m), (JSW, JC.ndp_machine(2))):
        with pytest.raises(KeyError, match="no field 'entriez'"):
            mod.apply_param(mach, "l1_dtlb.entriez", 32)
        with pytest.raises(KeyError, match="no field 'num_sets'"):
            mod.apply_param(mach, "l1d.num_sets", 32)
        with pytest.raises(KeyError, match="no field 'nope'"):
            mod.apply_param(mach, "nope", 1)
        with pytest.raises(ValueError, match="memory.t_cas"):
            mod.apply_param(mach, "memory.tcas", 1.0)
    # the reference's deprecated flat paths are not ported
    with pytest.raises(KeyError, match="no field 'mem_latency'"):
        apply_param(m, "mem_latency", 100.0)


def test_grid_errors():
    with pytest.raises(KeyError, match="no field"):
        sweep({"l1_dtlb.entriez": (32,)}, cores=2, trace_len=64,
              device="cpu")
    with pytest.raises(KeyError, match="unknown workload"):
        sweep({"workload": ("nope",)}, cores=2, trace_len=64, device="cpu")
    with pytest.raises(KeyError, match="unknown sweep preset"):
        sweep("not_a_preset", device="cpu")
    with pytest.raises(KeyError, match="unknown mechanism"):
        sweep({"mechs": (("radix", "nope"),)}, cores=2, trace_len=64,
              device="cpu")
    with pytest.raises(ValueError, match="has no values"):
        sweep({"workload": ()}, cores=2, device="cpu")
    # devices=2 on the CPU runs, clamped to its one device and recorded
    two = sweep({"workload": ("rnd",)}, cores=2, trace_len=64, devices=2,
                device="cpu")
    assert [b["devices"] for b in two.stats["per_bucket"]] == [1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_card_is_the_default_and_there_is_no_fallback():
    with pytest.raises(RuntimeError, match="is_available"):
        sweep({"workload": ("rnd",)}, cores=2, trace_len=64)
    job = TSIM.SimJob(TC.ndp_machine(1), "rnd")
    with pytest.raises(RuntimeError, match="is_available"):
        run_bucketed([job], chunk=64)


# ---------------------------------------------------------------------------
# checkpoints and the dispatch watchdog
# ---------------------------------------------------------------------------
class TestCheckpoint:
    GRID = {"memory.latency": (100, 170), "pwc_entries": (16, 32)}

    def _sweep(self, chunk=CHUNK_CKPT, **kw):
        return sweep(self.GRID, cores=2, trace_len=LEN, chunk=chunk,
                     device="cpu", **kw)

    @staticmethod
    def _ckpts(d):
        return sorted(f for f in os.listdir(d)
                      if f.startswith("sweepckpt_") and f.endswith(".npz"))

    @staticmethod
    def _count_dispatches(monkeypatch):
        calls = []
        real = TSW.simulate_batch_varied

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(TSW, "simulate_batch_varied", counting)
        return calls

    def test_resume_dispatches_nothing(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
        d = tmp_path / "repro_torch"               # the port's own directory
        r1 = self._sweep(checkpoint=True)
        assert r1.stats["buckets"] == 2 and r1.stats["runner_compiles"] == 2
        assert len(self._ckpts(d)) == 2

        calls = self._count_dispatches(monkeypatch)
        TSIM.clear_runner_cache()
        r2 = self._sweep(checkpoint=True)
        assert calls == [] and r2.stats["resumed_buckets"] == 2
        assert r2.stats["runner_compiles"] == 0
        assert all(b["resumed"] and b["compiles"] == 0
                   for b in r2.stats["per_bucket"])
        for a, b in zip(r1.results.flat, r2.results.flat):
            assert_results_match(b, a, exact=True)
        assert "resume" in [k for k, _ in resilience.recovery_events()]

        # a crash after bucket 0: only the lost bucket dispatches
        lost = self._ckpts(d)[1]
        os.remove(d / lost)
        os.remove(str(d / lost) + resilience.SIDECAR_SUFFIX)
        r3 = self._sweep(checkpoint=True)
        assert len(calls) == 1 and r3.stats["resumed_buckets"] == 1
        for a, b in zip(r1.results.flat, r3.results.flat):
            assert_results_match(b, a, exact=True)

    def test_corrupt_checkpoint_redispatches(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
        d = tmp_path / "repro_torch"
        r1 = self._sweep(checkpoint=True)
        p = d / self._ckpts(d)[0]
        raw = bytearray(p.read_bytes())
        raw[10] ^= 0xFF
        p.write_bytes(raw)
        calls = self._count_dispatches(monkeypatch)
        r2 = self._sweep(checkpoint=True)          # quarantine + re-dispatch
        assert len(calls) == 1 and r2.stats["resumed_buckets"] == 1
        assert os.listdir(d / resilience.QUARANTINE_DIR)
        for a, b in zip(r1.results.flat, r2.results.flat):
            assert_results_match(b, a, exact=True)

    def test_checkpoint_off_by_default(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
        monkeypatch.delenv("SIM_SWEEP_CHECKPOINT", raising=False)
        self._sweep()
        assert not [f for f in os.listdir(tmp_path / "repro_torch")
                    if f.startswith("sweepckpt_")]

    def test_checkpoint_key_covers_device_and_jobs(self):
        tr = generate_trace("rnd", 2, length=64, seed=3)
        jobs = [TSIM.SimJob(TC.ndp_machine(2), tr)]
        key = TSW.checkpoint_key(jobs, 64, None, "cpu")
        assert key == TSW.checkpoint_key(jobs, 64, None, "cpu")
        assert key != TSW.checkpoint_key(jobs, 64, None, "cuda")
        assert key != TSW.checkpoint_key(jobs, 32, None, "cpu")
        other = [TSIM.SimJob(apply_param(TC.ndp_machine(2), "pwc_entries",
                                         16), tr)]
        assert key != TSW.checkpoint_key(other, 64, None, "cpu")

    def test_injected_dispatch_fault_is_retried(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
        clean = self._sweep(chunk=CHUNK_FAULT)
        inj = resilience.FaultInjector.from_plan("dispatch_hang")
        resilience.recovery_events(clear=True)
        with resilience.inject_faults(inj):
            faulted = self._sweep(chunk=CHUNK_FAULT)
        assert [site for site, _, _ in inj.fired] == ["dispatch"]
        for a, b in zip(clean.results.flat, faulted.results.flat):
            assert_results_match(b, a, exact=True)
        kinds = [k for k, _ in resilience.recovery_events()]
        assert kinds.count("watchdog_timeout") == 1
        assert "watchdog_retry" in kinds
        # the retry ran after the plans were cleared: it made its plan anew
        assert faulted.stats["per_bucket"][0]["compiles"] == 1


def test_launcher_sweep(capsys):
    """``launch.simulate --sweep`` prints every point and the bucket
    stats, and returns what ``sweep`` returns."""
    from repro_torch.launch import simulate as LAUNCH
    args = LAUNCH.build_parser().parse_args(
        ["--preset", "smoke", "--device", "cpu", "--trace-len", "256",
         "--sweep", "l1_bypass"])
    got = LAUNCH.run_sweeps(args)["l1_bypass"]
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.startswith("sweep l1_bypass mechs=")]) \
        == got.stats["points"] == 12
    assert any(ln.startswith("sweep l1_bypass: 12 points, 1 buckets")
               for ln in out)
    want = sweep("l1_bypass", preset="smoke", trace_len=256, device="cpu")
    for a, b in zip(got.results.flat, want.results.flat):
        assert_results_match(a, b, exact=True)
    with pytest.raises(ValueError, match="unknown sweep"):
        LAUNCH.run_sweeps(LAUNCH.build_parser().parse_args(
            ["--device", "cpu", "--sweep", "nope"]))
