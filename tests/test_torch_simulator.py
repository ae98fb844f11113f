"""The port's simulator against the JAX package: the plain LRU scan
against the reference scan (``_build_model``'s step under
``jax.lax.scan``), and ``simulate`` / ``simulate_batch`` /
``simulate_batch_varied``, the ``SimResult`` helpers and the launcher
against ``repro.sim``.  Integer counters must be equal; the cycle sums
are float32 sums in other orders and agree within rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ndp_sim as JC
from repro.sim import simulator as JSIM
from repro.sim.mechanisms import registered_names
from repro.workloads import generate_traces as jgenerate_traces
from repro_torch.configs import ndp_sim as TC
from repro_torch.kernels import lru_scan as LS
from repro_torch.kernels import ref
from repro_torch.launch import simulate as LAUNCH
from repro_torch.sim import simulator as TSIM

RTOL = 1e-5
INT_FIELDS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
              "pte_mem", "data_l1_misses", "data_mem")
FLOAT_FIELDS = ("cycles", "trans_cycles", "walk_cycles")


def assert_results_match(got, want):
    assert got.mechs == want.mechs
    assert got.accesses == want.accesses
    assert np.array_equal(got.instructions, want.instructions)
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=f)


def cut(trace, n):
    return {k: (v[:, :n] if k != "pages" else v) for k, v in trace.items()}


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
SCAN_CASES = {
    "ndp": ("ndp_machine", None),
    "cpu": ("cpu_machine", None),
    "zoo": ("zoo_machine", registered_names()),
}


def scan_inputs(smoke_trace, jmach, names, t_len):
    """Two workloads x 2 cores = 4 lanes; the second workload's lanes go
    invalid after 600 steps (mixed lengths); walk lines from the port."""
    traces = [cut(smoke_trace(w, 2), t_len) for w in ("rnd", "xs")]
    vpn = np.stack([t["vpn"].T for t in traces], 1).reshape(t_len, 4)
    off = np.stack([t["off"].T for t in traces], 1).reshape(t_len, 4)
    frac = JSIM.FRAC_4K[2]
    is4k = (JSIM._hash_np(vpn >> JSIM.HUGE_SHIFT) % 1000) < int(frac * 1000)
    valid = np.ones((t_len, 4), bool)
    valid[600:, 2:] = False
    mt = {k: np.ascontiguousarray(np.broadcast_to(v, (4,) + v.shape))
          for k, v in JSIM._mech_arrays(names).items()}
    walk_fns = TSIM._walk_fns(names)
    pte = TSIM.walk_lines(torch.from_numpy(vpn), torch.from_numpy(is4k),
                          torch.from_numpy(mt["huge"]), walk_fns).numpy()
    return vpn.astype(np.int32), off.astype(np.int32), is4k, valid, pte, mt


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_lru_scan_ref_matches_reference_scan(smoke_trace, case):
    machine, mechs = SCAN_CASES[case]
    names = tuple(mechs) if mechs else JSIM.DEFAULT_MECHS
    jmach = getattr(JC, machine)(2)
    t_len, half = 768, 384
    vpn, off, is4k, valid, pte, mt = scan_inputs(smoke_trace, jmach, names,
                                                 t_len)
    m = len(names)
    shape = JSIM.machine_shape(jmach)

    # the reference: the JAX engine's own step under lax.scan, two chunks
    make_step, _ = JSIM._build_model(shape, batched=True)
    step = make_step({k: jnp.asarray(v) for k, v in mt.items()})
    scan = jax.jit(lambda carry, xs: jax.lax.scan(step, carry, xs))
    carry = ({n: {"tags": jnp.zeros((4, m, s, w), jnp.int32),
                  "lru": jnp.zeros((4, m, s, w), jnp.int32)}
              for n, s, w in shape.tables}, jnp.zeros((4, m), jnp.int32))
    want = []
    for sl in (slice(0, half), slice(half, t_len)):
        carry, packed = scan(carry, tuple(jnp.asarray(a[sl]) for a in (
            vpn, off, pte, is4k, valid)))
        want.append(np.asarray(packed))
    want_tabs, want_stamp = carry

    # the port's plain version, the same two chunks
    tables = {n: (torch.zeros((4, m, s, w), dtype=torch.int32),
                  torch.zeros((4, m, s, w), dtype=torch.int32))
              for n, s, w in shape.tables}
    stamp = torch.zeros((4, m), dtype=torch.int32)
    flags = LS.mech_flags({k: torch.from_numpy(v) for k, v in mt.items()})
    got = []
    for sl in (slice(0, half), slice(half, t_len)):
        got.append(ref.lru_scan_ref(
            torch.from_numpy(vpn[sl]), torch.from_numpy(off[sl]),
            torch.from_numpy(is4k[sl]), torch.from_numpy(valid[sl]),
            torch.from_numpy(np.ascontiguousarray(pte[sl])), flags, stamp,
            tables).numpy())

    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert np.array_equal(g, w)
    assert np.array_equal(stamp.numpy(), np.asarray(want_stamp))
    for n, (tags, lru) in tables.items():
        assert np.array_equal(tags.numpy(), np.asarray(want_tabs[n]["tags"]))
        assert np.array_equal(lru.numpy(), np.asarray(want_tabs[n]["lru"]))
    # the scan did real work: TLB, PWC (levels 0-2) and data-L1 hits, and
    # the cache-as-TLB filled
    bits = np.concatenate(got)
    for b in (0, 1, 2, 3, 4, 6 + 4):
        assert ((bits >> b) & 1).any(), b
    if case == "zoo":
        assert bool(tables["ctlb"][0].any())
        assert int(stamp[0, 0]) == t_len * (2 + 4 + 5 + 1)


def test_lru_scan_wrapper_dispatch_and_checks():
    """CPU tensors run the plain version; a device with no kernel raises;
    the kernel's operand checks reject bad shapes and dtypes."""
    t, lanes, m = 8, 2, 1
    vpn = torch.arange(t * lanes, dtype=torch.int32).view(t, lanes)
    off = torch.zeros_like(vpn)
    flags4 = torch.full((lanes, m), 4 << LS.FLAG_N_PTE_SHIFT,
                        dtype=torch.int32)
    args = dict(vpn=vpn, off=off, is4k=torch.zeros(t, lanes, dtype=torch.bool),
                valid=torch.ones(t, lanes, dtype=torch.bool),
                pte=torch.zeros((t, lanes, m, 4), dtype=torch.int32),
                flags=flags4, stamp=torch.zeros((lanes, m), dtype=torch.int32),
                tables={n: (torch.zeros((lanes, m, s, w), dtype=torch.int32),
                            torch.zeros((lanes, m, s, w), dtype=torch.int32))
                        for n, (s, w) in (("l1tlb", (16, 4)),
                                          ("l2tlb", (128, 12)),
                                          ("pwc", (4, 32)), ("l1", (64, 8)))})
    plain = dict(args, stamp=args["stamp"].clone(),
                 tables={n: (a.clone(), b.clone())
                         for n, (a, b) in args["tables"].items()})
    before = LS.launches
    assert torch.equal(LS.lru_scan(**args), ref.lru_scan_ref(**plain))
    assert LS.launches == before           # the plain path launches nothing
    assert int(args["stamp"][0, 0]) == t * (2 + 4 + 5)
    LS._check(**args)
    with pytest.raises(ValueError, match="no lru_scan"):
        LS.lru_scan(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                       for k, v in args.items()})
    with pytest.raises(ValueError, match="must be torch.int32"):
        LS._check(**dict(args, off=off.long()))
    with pytest.raises(ValueError, match="needs table 'pwc'"):
        LS._check(**dict(args, tables={k: v for k, v in args["tables"].items()
                                       if k != "pwc"}))
    with pytest.raises(ValueError, match="l2 and l3"):
        LS._check(**dict(args, tables=dict(args["tables"],
                                           l2=args["tables"]["l1"])))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("machine", ["ndp_machine", "cpu_machine",
                                     "zoo_machine"])
def test_shape_and_data_split_equal(machine):
    for cores in (1, 4):
        jm, tm = getattr(JC, machine)(cores), getattr(TC, machine)(cores)
        assert TSIM._table_shapes(tm) == JSIM._table_shapes(jm)
        assert dataclasses.astuple(TSIM.machine_shape(tm)) == \
            dataclasses.astuple(JSIM.machine_shape(jm))
        assert TSIM.machine_shape(tm).hier == JSIM.machine_shape(jm).hier
        assert TSIM._data_params(tm) == JSIM._data_params(jm)
        jst = JSIM.init_state(jm, 5, batch=3)
        tst = TSIM.init_state(tm, 5, batch=3, device="cpu")
        for k in ("stamp", "clock", "mem_accs"):
            assert tuple(tst[k].shape) == jst[k].shape
        for n, _, _ in TSIM.machine_shape(tm).tables:
            assert tuple(tst[n]["tags"].shape) == jst[n]["tags"].shape
        assert sorted(tst["counters"]) == sorted(jst["counters"])
    names = registered_names()
    for k, v in JSIM._mech_arrays(names).items():
        assert np.array_equal(TSIM._mech_arrays(names)[k], v)


@pytest.mark.parametrize("workload,machine,cores", [
    ("rnd", "ndp_machine", 1), ("bc", "ndp_machine", 4),
    ("xs", "cpu_machine", 4)])
def test_simulate_matches_reference(smoke, smoke_trace, smoke_sim, workload,
                                    machine, cores):
    jm, tm = getattr(JC, machine)(cores), getattr(TC, machine)(cores)
    want = smoke_sim(workload, jm)
    got = TSIM.simulate(tm, smoke_trace(workload, cores), chunk=smoke.chunk,
                        device="cpu")
    assert_results_match(got, want)
    assert got.cycles.shape == (5, cores)
    sp = got.speedup_vs()
    assert sp["ideal"] > sp["ndpage"] > 1.0


def test_simulate_batch_mixed_lengths(smoke, smoke_trace):
    traces = [cut(smoke_trace("rnd", 2), 700), cut(smoke_trace("gen", 2), 1300),
              cut(smoke_trace("dlrm", 2), 1024)]
    jm, tm = JC.ndp_machine(2), TC.ndp_machine(2)
    want = JSIM.simulate_batch(jm, traces, chunk=smoke.chunk)
    timings = {}
    got = TSIM.simulate_batch(tm, traces, chunk=smoke.chunk, timings=timings,
                              device="cpu")
    assert [r.accesses for r in got] == [700, 1300, 1024]
    for g, w in zip(got, want):
        assert_results_match(g, w)
    assert timings["chunks"] == 3
    assert set(timings) == {"chunks", "total_s", "compile_s_est", "run_s"}
    # lanes never interact: a lane alone gives the same counters; its
    # float sums may round differently (torch picks the order by shape)
    alone = TSIM.simulate(tm, traces[0], chunk=smoke.chunk, device="cpu")
    for f in INT_FIELDS:
        assert np.array_equal(getattr(alone, f), getattr(got[0], f)), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(alone, f), getattr(got[0], f),
                                   rtol=RTOL, atol=0, err_msg=f)


def test_simulate_batch_varied_heterogeneous_lanes(smoke, smoke_trace):
    """ndpage against its no-bypass ablation (one walk function, the flag
    is lane data) and two memory latencies, in one batch."""
    def slow(pkg):
        base = pkg.ndp_machine(2)
        return dataclasses.replace(base, name="ndp-slow", memory=dataclasses
                                   .replace(base.memory, latency=150.0))

    tr_a, tr_b = (cut(smoke_trace(w, 2), 1024) for w in ("bfs", "xs"))
    plan = [(False, tr_a, ("radix", "ndpage")),
            (True, tr_b, ("radix", "ndpage_nobyp")),
            (False, tr_b, ("radix", "ndpage_nobyp")),
            (True, tr_a, ("radix", "ndpage"))]

    def jobs(pkg, simmod):
        return [simmod.SimJob(slow(pkg) if s else pkg.ndp_machine(2), tr, m)
                for s, tr, m in plan]

    want = JSIM.simulate_batch_varied(jobs(JC, JSIM), chunk=smoke.chunk)
    got = TSIM.simulate_batch_varied(jobs(TC, TSIM), chunk=smoke.chunk,
                                     device="cpu")
    for g, w in zip(got, want):
        assert_results_match(g, w)
    # the slower memory costs cycles; only the ablation's PTE lines go
    # through (and hit in) the L1
    assert got[3].cycles.mean() > got[0].cycles.mean()
    assert got[0].pte_l1_hits[1].sum() == got[3].pte_l1_hits[1].sum() == 0
    assert got[1].pte_l1_hits[1].sum() > 0 and got[2].pte_l1_hits[1].sum() > 0
    with pytest.raises(ValueError, match="shape bucket"):
        TSIM.simulate_batch_varied(
            [TSIM.SimJob(TC.ndp_machine(2), tr_a),
             TSIM.SimJob(TC.cpu_machine(2), tr_a)], device="cpu")
    with pytest.raises(ValueError, match="walk functions"):
        TSIM.simulate_batch_varied(
            [TSIM.SimJob(TC.ndp_machine(2), tr_a, ("radix", "ndpage")),
             TSIM.SimJob(TC.ndp_machine(2), tr_a, ("radix", "ech"))],
            device="cpu")
    assert TSIM.simulate_batch_varied([], device="cpu") == []


def test_sim_result_helpers_equal():
    rng = np.random.default_rng(4)
    mechs = ("radix", "ech", "hugepage", "ndpage", "ideal")
    arrays = {f.name: (rng.random((5, 3), dtype=np.float32) * 1000 + 1
                       ).astype(np.float32)
              for f in dataclasses.fields(JSIM.SimResult)
              if f.name not in ("mechs", "instructions", "accesses")}
    kw = dict(arrays, mechs=mechs, instructions=rng.random(3) * 1e4,
              accesses=2048)
    j, t = JSIM.SimResult(**kw), TSIM.SimResult(**kw)
    for fn in ("ipc", "avg_ptw_latency", "translation_fraction",
               "tlb_miss_rate", "pte_l1_miss_rate", "data_l1_miss_rate"):
        assert np.array_equal(getattr(t, fn)(), getattr(j, fn)())
    assert t.speedup_vs() == j.speedup_vs()
    assert t.speedup_vs("ndpage") == j.speedup_vs("ndpage")
    for sel in (dict(mechs="ech"), dict(mechs=("ideal", "radix")),
                dict(cores=1), dict(cores=slice(0, 2)),
                dict(mechs=("ndpage",), cores=[0, 2])):
        a, b = t.select(**sel), j.select(**sel)
        assert a.mechs == b.mechs
        for f in arrays:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (sel, f)
    assert t.scalar("avg_ptw_latency", "radix") == j.scalar(
        "avg_ptw_latency", "radix")


def test_launcher_smoke_matches_reference(monkeypatch, capsys):
    monkeypatch.setenv("SIM_TRACE_CACHE", "0")
    workloads = ["rnd", "gen"]
    args = LAUNCH.build_parser().parse_args(
        ["--preset", "smoke", "--device", "cpu", "--machines", "ndp",
         "--cores", "4", "--workloads", ",".join(workloads)])
    (bucket,) = LAUNCH.run(args)
    out = capsys.readouterr().out
    assert "fig13_4c_avg" in out and "lru_scan launches 0" in out
    assert bucket["chunks"] == 4 and bucket["launches"] == 0
    smoke = JC.PRESETS["smoke"]
    traces = jgenerate_traces(workloads, 4, preset=smoke, use_cache=False)
    want = JSIM.simulate_batch(JC.ndp_machine(4), traces, chunk=smoke.chunk)
    for w, r in zip(workloads, want):
        for m, s in r.speedup_vs().items():
            assert bucket["speedups"][w][m] == pytest.approx(s, rel=1e-5)
    avg = LAUNCH.averages(bucket)
    assert avg["ideal"] > avg["ndpage"] > 1.0


def test_launcher_profile(monkeypatch, capsys):
    """``--profile`` traces the bucket and prints the time by operator
    (one 64-step chunk: the profiler records every eager operation)."""
    monkeypatch.setenv("SIM_TRACE_CACHE", "0")
    assert LAUNCH.build_parser().parse_args(["--profile"]).profile
    preset = dataclasses.replace(TC.PRESETS["smoke"], chunk=64)
    bucket = LAUNCH.run_bucket("ndp", 1, ["rnd"], preset, 64,
                               torch.device("cpu"), profile=True)
    out = capsys.readouterr().out
    assert "Self CPU time total" in out and "aten::index_put_" in out
    assert bucket["chunks"] == 1 and bucket["launches"] == 0


def test_unported_paths_raise(smoke_trace, monkeypatch):
    tr = cut(smoke_trace("rnd", 2), 64)
    with pytest.raises(NotImplementedError, match="module item 10"):
        TSIM.simulate_batch(TC.ndp_machine(2), [tr], devices=2, device="cpu")
    with pytest.raises(FileNotFoundError):        # a trace spec is ingested
        TSIM.simulate(TC.ndp_machine(2), "trace:/nonexistent/t.champsim",
                      device="cpu")
    with pytest.raises(ValueError, match="cores"):
        TSIM.simulate(TC.ndp_machine(4), tr, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TSIM.simulate(TC.ndp_machine(2), tr)
    with pytest.raises(RuntimeError, match="is_available"):
        LAUNCH.run(LAUNCH.build_parser().parse_args(["--preset", "smoke"]))
