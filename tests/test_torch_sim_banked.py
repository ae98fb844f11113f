"""Banked DRAM memory in the port's simulator against the JAX package: the
plain LRU scan with its per-bank open rows against the reference's own
step under ``jax.lax.scan``, the plain epilogue with its per-bank queue
delays and row-buffer discount against the reference's ``epilogue``, and
``simulate`` / ``simulate_batch`` / ``simulate_batch_varied`` against
``repro.sim`` over several chunks (the per-bank queue feedback).  Integer
outputs must be equal; the cycle sums are float32 sums in other orders
and agree within rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ndp_sim as JC
from repro.sim import memory_model as JMM
from repro.sim import simulator as JSIM
from repro.sim.mechanisms import registered_names
from repro_torch.configs import ndp_sim as TC
from repro_torch.core import page_table as TPT
from repro_torch.kernels import lru_scan as LS
from repro_torch.kernels import ref
from repro_torch.kernels import sim_epilogue as SE
from repro_torch.launch import simulate as LAUNCH
from repro_torch.sim import memory_model as TMM
from repro_torch.sim import simulator as TSIM

RTOL = 1e-5
INT_FIELDS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
              "pte_mem", "data_l1_misses", "data_mem")
FLOAT_FIELDS = ("cycles", "trans_cycles", "walk_cycles")
FLOAT_COUNTERS = ("trans", "walk_cyc")
CASES = {
    "ndp": ("ndp_machine", 2, None),
    "cpu": ("cpu_machine", 2, None),
    "zoo": ("zoo_machine", 4, registered_names()),
}


def banked(pkg, mm, mach, num_banks=16, **timing):
    """``mach`` with its memory switched to the banked preset (the
    machine's own calibration kept), ``num_banks`` banks."""
    mem = dataclasses.replace(mm.with_kind(mach.memory, "banked"),
                              num_banks=num_banks, **timing)
    return dataclasses.replace(mach, memory=mem)


def jbanked(mach, num_banks=16, **timing):
    return banked(JC, JMM, mach, num_banks, **timing)


def tbanked(mach, num_banks=16, **timing):
    return banked(TC, TMM, mach, num_banks, **timing)


def cut(trace, n):
    return {k: (v[:, :n] if k != "pages" else v) for k, v in trace.items()}


def assert_results_match(got, want):
    assert got.mechs == want.mechs
    assert got.accesses == want.accesses
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=0, err_msg=f)


def chunk_inputs(smoke_trace, cores, names, t_len=768):
    """4 lanes: two workloads at 2 cores, or one at 4; the last two lanes
    go invalid after 600 steps.  Walk lines from the port."""
    works = ("rnd", "xs") if cores == 2 else ("bfs",)
    traces = [cut(smoke_trace(w, cores), t_len) for w in works]

    def fuse(key):
        return np.ascontiguousarray(
            np.stack([t[key].T for t in traces], 1).reshape(t_len, 4))

    vpn, off = fuse("vpn").astype(np.int32), fuse("off").astype(np.int32)
    work = fuse("work").astype(np.float32)
    frac = JSIM.FRAC_4K[cores]
    is4k = (JSIM._hash_np(vpn >> JSIM.HUGE_SHIFT) % 1000) < int(frac * 1000)
    valid = np.ones((t_len, 4), bool)
    valid[600:, 2:] = False
    mt = {k: np.ascontiguousarray(np.broadcast_to(v, (4,) + v.shape))
          for k, v in JSIM._mech_arrays(names).items()}
    pte = TSIM.walk_lines(torch.from_numpy(vpn), torch.from_numpy(is4k),
                          torch.from_numpy(mt["huge"]),
                          TSIM._walk_fns(names)).numpy()
    return vpn, off, work, is4k, valid, pte, mt


@pytest.mark.parametrize("num_banks", [8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_banked_lru_scan_ref_matches_reference_scan(smoke_trace, case,
                                                    num_banks):
    machine, cores, mechs = CASES[case]
    names = tuple(mechs) if mechs else JSIM.DEFAULT_MECHS
    jmach = jbanked(getattr(JC, machine)(cores), num_banks)
    lpr = jmach.memory.lines_per_row
    t_len, half = 768, 384
    vpn, off, _, is4k, valid, pte, mt = chunk_inputs(smoke_trace, cores,
                                                     names, t_len)
    m = len(names)
    shape = JSIM.machine_shape(jmach)
    assert shape.memory == ("banked", num_banks, 2048)

    make_step, _ = JSIM._build_model(shape, batched=True)
    step = make_step({k: jnp.asarray(v) for k, v in mt.items()})
    scan = jax.jit(lambda carry, xs: jax.lax.scan(step, carry, xs))
    tabs = {n: {"tags": jnp.zeros((4, m, s, w), jnp.int32),
                "lru": jnp.zeros((4, m, s, w), jnp.int32)}
            for n, s, w in shape.tables}
    tabs["bank_row"] = jnp.full((4, m, num_banks), -1, jnp.int32)
    carry = (tabs, jnp.zeros((4, m), jnp.int32))
    want = []
    for sl in (slice(0, half), slice(half, t_len)):
        carry, packed = scan(carry, tuple(jnp.asarray(a[sl]) for a in (
            vpn, off, pte, is4k, valid)))
        want.append(np.asarray(packed))
    want_tabs, want_stamp = carry

    tables = {n: (torch.zeros((4, m, s, w), dtype=torch.int32),
                  torch.zeros((4, m, s, w), dtype=torch.int32))
              for n, s, w in shape.tables}
    bank_row = torch.full((4, m, num_banks), -1, dtype=torch.int32)
    stamp = torch.zeros((4, m), dtype=torch.int32)
    flags = LS.mech_flags({k: torch.from_numpy(v) for k, v in mt.items()})
    got = []
    for sl in (slice(0, half), slice(half, t_len)):
        got.append(LS.lru_scan(
            torch.from_numpy(vpn[sl]), torch.from_numpy(off[sl]),
            torch.from_numpy(is4k[sl]), torch.from_numpy(valid[sl]),
            torch.from_numpy(np.ascontiguousarray(pte[sl])), flags, stamp,
            tables, bank_row, lpr).numpy())

    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(stamp.numpy(), np.asarray(want_stamp))
    assert np.array_equal(bank_row.numpy(),
                          np.asarray(want_tabs["bank_row"]))
    for n, (tags, lru) in tables.items():
        assert np.array_equal(tags.numpy(), np.asarray(want_tabs[n]["tags"]))
        assert np.array_equal(lru.numpy(), np.asarray(want_tabs[n]["lru"]))
    # the five row-buffer bits sit after every other bit, and open rows
    # were hit by PTE lines and by data lines
    first = ref.bank_bit(len(shape.hier), "ctlb" in tables)
    assert first + 5 <= 27
    bits = np.concatenate(got)
    assert ((bits >> (first + 4)) & 1).any()
    assert ((bits >> first) & 0b1111).any()
    assert not (bits >> (first + 5)).any()
    assert (bank_row.numpy() >= 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_banked_sim_epilogue_ref_matches_reference_epilogue(smoke_trace,
                                                            case):
    machine, cores, mechs = CASES[case]
    names = tuple(mechs) if mechs else JSIM.DEFAULT_MECHS
    jmach = jbanked(getattr(JC, machine)(cores))
    lpr, nb = jmach.memory.lines_per_row, jmach.memory.num_banks
    vpn, off, work, is4k, valid, pte, mt = chunk_inputs(smoke_trace, cores,
                                                        names)
    shape = JSIM.machine_shape(jmach)
    n_hier = len(shape.hier)
    has_ctlb = any(n == "ctlb" for n, _, _ in shape.tables)
    m = len(names)
    rng = np.random.default_rng(23)
    dp = {k: (np.float32(v) * (1 + 0.1 * rng.random(4))).astype(np.float32)
          for k, v in JSIM._data_params(jmach).items()}
    dp["stack_pen"] = np.float32([0.0, 12.5, 0.0, 30.0])
    q = (rng.random((m, 4, nb)) * 40).astype(np.float32)

    tmt = {k: torch.from_numpy(v) for k, v in mt.items()}
    tables = {n: (torch.zeros((4, m, s, w), dtype=torch.int32),
                  torch.zeros((4, m, s, w), dtype=torch.int32))
              for n, s, w in shape.tables}
    packed = ref.lru_scan_ref(
        torch.from_numpy(vpn), torch.from_numpy(off), torch.from_numpy(is4k),
        torch.from_numpy(valid), torch.from_numpy(pte), LS.mech_flags(tmt),
        torch.zeros((4, m), dtype=torch.int32), tables,
        torch.full((4, m, nb), -1, dtype=torch.int32), lpr)
    # the five sites' lines, (T, M, L, 5), as the JAX runner's _lines5
    pm = np.swapaxes(pte, 1, 2)
    data = (vpn * 64 + off)[:, None, :, None]
    lines = np.concatenate([pm, np.broadcast_to(data, pm.shape[:-1] + (1,))],
                           -1)

    _, epilogue = JSIM._build_model(shape, batched=True)
    want_cnt, want_cyc, want_mem = epilogue(
        jnp.asarray(packed.numpy()).swapaxes(1, 2), jnp.asarray(work),
        jnp.asarray(is4k), jnp.asarray(valid), jnp.asarray(q),
        {k: jnp.asarray(v) for k, v in mt.items()},
        {k: jnp.asarray(v) for k, v in dp.items()},
        lines=jnp.asarray(lines))
    tdp = {k: torch.from_numpy(v) for k, v in dp.items()}
    cnt, cyc, mem_n = ref.sim_epilogue_ref(
        packed.transpose(1, 2), torch.from_numpy(work),
        torch.from_numpy(is4k), torch.from_numpy(valid), torch.from_numpy(q),
        tmt, tdp, n_hier, has_ctlb, torch.from_numpy(lines.copy()), lpr)
    for k in ref.COUNTERS:
        g, w = cnt[k].numpy(), np.asarray(want_cnt[k])
        if k in FLOAT_COUNTERS:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)
        else:
            assert np.array_equal(g, w), k
    np.testing.assert_allclose(cyc.numpy(), np.asarray(want_cyc), rtol=RTOL,
                               atol=0)
    assert mem_n.shape == (m, 4, nb)
    assert np.array_equal(mem_n.numpy(), np.asarray(want_mem))
    # demand on several banks, and the row-buffer discount reached
    assert (mem_n.sum(dim=(0, 1)) > 0).sum() > 1
    assert int(mem_n.sum()) == int(cnt["pte_mem"].sum()
                                   + cnt["data_mem"].sum())

    # the wrapper's CPU path adds the same into a (B, M, C, banks) state
    b, c = 2, 2
    clock = torch.zeros((b, m, c))
    mem_accs = torch.ones((b, m, nb))
    counters = {k: torch.zeros((b, m, c)) for k in ref.COUNTERS}
    q_sim = torch.from_numpy(np.ascontiguousarray(q[:, ::c].transpose(1, 0,
                                                                        2)))
    SE.sim_epilogue(
        packed, torch.from_numpy(work), torch.from_numpy(is4k),
        torch.from_numpy(valid), q_sim, LS.mech_flags(tmt),
        SE.lane_params(tdp), clock, mem_accs, counters, n_hier=n_hier,
        has_ctlb=has_ctlb, pte=torch.from_numpy(pte), vpn=torch.from_numpy(vpn),
        off=torch.from_numpy(off), lines_per_row=lpr)
    cnt2, cyc2, mem2 = ref.sim_epilogue_ref(
        packed.transpose(1, 2), torch.from_numpy(work),
        torch.from_numpy(is4k), torch.from_numpy(valid),
        torch.from_numpy(np.repeat(q[:, ::c], c, axis=1)), tmt, tdp, n_hier,
        has_ctlb, torch.from_numpy(lines.copy()), lpr)

    def unfuse(a):
        return a.reshape((m, b, c) + a.shape[2:]).transpose(0, 1)

    assert torch.equal(clock, unfuse(cyc2))
    assert torch.equal(mem_accs, 1.0 + unfuse(mem2).sum(dim=2))
    for k in ref.COUNTERS:
        assert torch.equal(counters[k], unfuse(cnt2[k])), k


@pytest.mark.parametrize("machine", ["ndp_machine", "cpu_machine"])
def test_banked_simulate_batch_matches_reference(smoke_trace, machine):
    """Three chunks of 256 (the per-bank queue windows feed back twice),
    mixed lengths, and a lane alone through ``simulate``."""
    traces = [cut(smoke_trace("rnd", 2), 700), cut(smoke_trace("gen", 2), 768),
              cut(smoke_trace("bfs", 2), 512)]
    jm, tm = jbanked(getattr(JC, machine)(2)), tbanked(getattr(TC, machine)(2))
    want = JSIM.simulate_batch(jm, traces, chunk=256)
    got = TSIM.simulate_batch(tm, traces, chunk=256, device="cpu")
    for g, w in zip(got, want):
        assert_results_match(g, w)
    alone = TSIM.simulate(tm, traces[1], chunk=256, device="cpu")
    assert_results_match(alone, want[1])
    # banked memory is a different result, not the bounded one
    bounded = TSIM.simulate(getattr(TC, machine)(2), traces[1], chunk=256,
                            device="cpu")
    assert not np.array_equal(bounded.cycles, alone.cycles)
    sp = alone.speedup_vs()
    assert sp["ideal"] > sp["ndpage"] > 1.0


def test_banked_simulate_batch_varied_lanes_differ_in_t_cas(smoke_trace):
    """Lanes of one batch with different column latencies and bank
    services (value-only data), over three chunks."""
    tr_a, tr_b = (cut(smoke_trace(w, 2), 768) for w in ("bfs", "xs"))
    plan = [(25.0, 117.0, tr_a, ("radix", "ndpage")),
            (40.0, 117.0, tr_b, ("radix", "ndpage_nobyp")),
            (25.0, 60.0, tr_b, ("radix", "ndpage_nobyp")),
            (40.0, 117.0, tr_a, ("radix", "ndpage"))]

    def jobs(pkg, simmod, make):
        return [simmod.SimJob(make(pkg.ndp_machine(2), t_cas=t, service=s),
                              tr, names) for t, s, tr, names in plan]

    want = JSIM.simulate_batch_varied(jobs(JC, JSIM, jbanked), chunk=256)
    got = TSIM.simulate_batch_varied(jobs(TC, TSIM, tbanked), chunk=256,
                                     device="cpu")
    for g, w in zip(got, want):
        assert_results_match(g, w)
    # the slower column read costs cycles, the faster bank service saves
    assert got[3].cycles.mean() > got[0].cycles.mean()
    assert got[2].cycles.mean() < got[1].cycles.mean()


@pytest.mark.parametrize("machine", ["ndp_machine", "zoo_machine"])
def test_banked_state_and_shape_equal(machine):
    for cores in (1, 4):
        jm = jbanked(getattr(JC, machine)(cores), 8)
        tm = tbanked(getattr(TC, machine)(cores), 8)
        assert dataclasses.astuple(TSIM.machine_shape(tm)) == \
            dataclasses.astuple(JSIM.machine_shape(jm))
        assert TSIM._data_params(tm) == JSIM._data_params(jm)
        jst = JSIM.init_state(jm, 5, batch=3)
        tst = TSIM.init_state(tm, 5, batch=3, device="cpu")
        for k in ("bank_row", "mem_accs", "clock", "stamp"):
            assert tuple(tst[k].shape) == jst[k].shape, k
            assert np.array_equal(tst[k].numpy(), np.asarray(jst[k])), k
    tr = {k: np.zeros((1, 64), np.int32) for k in ("vpn", "off", "work")}
    with pytest.raises(ValueError, match="1 to 64 banks"):
        TSIM.simulate(tbanked(TC.ndp_machine(1), 65), tr, chunk=64,
                      device="cpu")


def test_banked_queue_delay_equal():
    """The per-bank queue law equals the JAX runner's ``_queue`` on the
    same demand (a bank axis after the mechanisms)."""
    rng = np.random.default_rng(3)
    clock = (rng.random((3, 5, 4)) * 1e5).astype(np.float32)
    clock[0] = 0.0                                  # elapsed clamps to 1
    accs = (rng.integers(0, 4000, (3, 5, 16))).astype(np.float32)
    service = np.float32([117.0, 46.0, 200.0])
    got = TSIM._queue(torch.from_numpy(clock), torch.from_numpy(accs),
                      torch.from_numpy(service)).numpy()
    elapsed = jnp.maximum(jnp.asarray(clock).mean(axis=-1), 1.0)
    want = JMM.queue_delay(jnp.asarray(accs) / elapsed[..., None],
                           jnp.asarray(service)[:, None, None])
    assert np.array_equal(got, np.asarray(want))
    assert (got == np.float32(service[0] * JMM.RHO_MAX * JMM.QUEUE_K)).any()


def test_line_ids_stay_non_negative():
    """Every registered walk function gives line ids in [0, 2^31) for the
    vpns the engine takes, and the data line stays below 2^31, so the
    scan's truncating and the epilogue's floor division agree; vpns
    outside are refused."""
    vpn = torch.tensor([0, 1, 511, 512, 123457, 1 << 24, TSIM.MAX_VPN],
                       dtype=torch.int32)
    for names in (registered_names(),):
        for fn in TSIM._walk_fns(names):
            if fn is None:
                continue
            lines = fn(vpn).long()
            assert (lines >= TPT.PT_REGION_LINE).all()
            assert (lines < TPT.PT_REGION_LINE + (1 << 27)).all()
    assert TSIM.MAX_VPN * 64 + 63 < 2 ** 31
    tr = {"vpn": np.full((1, 64), TSIM.MAX_VPN + 1, np.int32),
          "off": np.zeros((1, 64), np.int32),
          "work": np.zeros((1, 64), np.int32)}
    with pytest.raises(ValueError, match="engine takes"):
        TSIM.simulate(TC.ndp_machine(1), tr, chunk=64, device="cpu")
    tr["vpn"][0, 3] = -1
    with pytest.raises(ValueError, match="engine takes"):
        TSIM.simulate(TC.ndp_machine(1), tr, chunk=64, device="cpu")


def test_banked_wrappers_refuse_operands(monkeypatch):
    """The scan and epilogue wrappers' banked operand checks, and a CUDA
    banked epilogue call that must reach the kernel path."""
    t, lanes, m, nb = 8, 2, 3, 16
    i32 = dict(dtype=torch.int32)
    scan = dict(vpn=torch.zeros((t, lanes), **i32),
                off=torch.zeros((t, lanes), **i32),
                is4k=torch.zeros((t, lanes), dtype=torch.bool),
                valid=torch.ones((t, lanes), dtype=torch.bool),
                pte=torch.zeros((t, lanes, m, 4), **i32),
                flags=torch.zeros((lanes, m), **i32),
                stamp=torch.zeros((lanes, m), **i32),
                tables={n: (torch.zeros((lanes, m, s, w), **i32),
                            torch.zeros((lanes, m, s, w), **i32))
                        for n, (s, w) in TSIM._table_shapes(
                            TC.ndp_machine(1)).items()},
                bank_row=torch.full((lanes, m, nb), -1, **i32),
                lines_per_row=32)
    LS._check(**scan)
    with pytest.raises(ValueError, match="1 to 64 banks"):
        LS._check(**dict(scan, bank_row=torch.zeros((lanes, m, 65), **i32)))
    with pytest.raises(ValueError, match="bank_row must be torch.int32"):
        LS._check(**dict(scan, bank_row=torch.zeros((lanes, m + 1, nb),
                                                    **i32)))
    with pytest.raises(ValueError, match="lines_per_row"):
        LS._check(**dict(scan, lines_per_row=0))

    ep = dict(packed=torch.zeros((t, lanes, m), **i32),
              work=torch.ones((t, lanes)),
              is4k=torch.zeros((t, lanes), dtype=torch.bool),
              valid=torch.ones((t, lanes), dtype=torch.bool),
              q=torch.zeros((1, m, nb)),
              flags=torch.full((lanes, m), 4 << ref.FLAG_N_PTE_SHIFT, **i32),
              params=torch.ones((lanes, len(ref.EPILOGUE_PARAMS))),
              clock=torch.zeros((1, m, lanes)),
              mem_accs=torch.zeros((1, m, nb)),
              counters={k: torch.zeros((1, m, lanes)) for k in ref.COUNTERS},
              n_hier=1, has_ctlb=False, pte=scan["pte"], vpn=scan["vpn"],
              off=scan["off"], lines_per_row=32)
    SE.sim_epilogue(**ep)
    # 8 valid steps on 2 lanes, nothing hit, every line 0 (bank 0): 4 PTE
    # and 1 data access a step, all on bank 0
    assert torch.equal(ep["mem_accs"][0, :, 0], torch.full((m,), 80.0))
    assert float(ep["mem_accs"][..., 1:].sum()) == 0.0
    with pytest.raises(ValueError, match="needs pte"):
        SE._check(**{k: v for k, v in ep.items() if k != "pte"})
    with pytest.raises(ValueError, match="mem_accs must be"):
        SE._check(**dict(ep, mem_accs=torch.zeros((1, m))))
    with pytest.raises(ValueError, match="no bank axis"):
        SE._check(**dict(ep, q=torch.zeros((1, m)),
                         mem_accs=torch.zeros((1, m))))
    with pytest.raises(ValueError, match="1 to 64 banks"):
        SE._check(**dict(ep, q=torch.zeros((1, m, 65)),
                         mem_accs=torch.zeros((1, m, 65))))

    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_card():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(SE, "_plain", no_plain)
    monkeypatch.setattr(SE, "_lib", no_card)
    with FakeTensorMode():
        cuda = {k: (torch.zeros(v.shape, dtype=v.dtype, device="cuda")
                    if torch.is_tensor(v) else v) for k, v in ep.items()
                if k != "counters"}
        cuda["counters"] = {k: torch.zeros(v.shape, device="cuda")
                            for k, v in ep["counters"].items()}
    before = SE.launches
    with pytest.raises(RuntimeError, match="no kernel library"):
        SE.sim_epilogue(**cuda)
    assert SE.launches == before


@pytest.mark.parametrize("cores", [1, 8])
@pytest.mark.parametrize("machine", ["ndp", "cpu"])
def test_banked_scan_operands_of_figure_buckets(machine, cores):
    """The banked figure buckets (11 workloads, 16 banks of 2 KB rows) give
    the kernels operands they take (meta tensors: shapes only)."""
    mach = tbanked(LAUNCH.MACHINES[machine](cores))
    st = TSIM.init_state(mach, 5, batch=11, device="cpu")
    lanes = 11 * cores
    meta = dict(device="meta", dtype=torch.int32)
    args = dict(vpn=torch.zeros(1024, lanes, **meta),
                off=torch.zeros(1024, lanes, **meta),
                is4k=torch.zeros(1024, lanes, device="meta", dtype=torch.bool),
                valid=torch.zeros(1024, lanes, device="meta",
                                  dtype=torch.bool),
                pte=torch.zeros(1024, lanes, 5, 4, **meta),
                flags=torch.zeros(lanes, 5, **meta),
                stamp=torch.zeros(lanes, 5, **meta),
                tables={n: (torch.zeros((lanes, 5, s, w), **meta),
                            torch.zeros((lanes, 5, s, w), **meta))
                        for n, (s, w) in TSIM._table_shapes(mach).items()},
                bank_row=st["bank_row"].to("meta").view(lanes, 5, 16),
                lines_per_row=mach.memory.lines_per_row)
    LS._check(**args)
    assert mach.memory.lines_per_row == 32
    assert tuple(st["mem_accs"].shape) == (11, 5, 16)


def test_launcher_banked_matches_reference(monkeypatch, capsys):
    """``--memory banked`` switches the machines through ``with_kind``;
    the bucket's speedups equal the JAX package's on the same banked
    machine."""
    from repro.workloads import generate_traces as jgenerate_traces
    monkeypatch.setenv("SIM_TRACE_CACHE", "0")
    args = LAUNCH.build_parser().parse_args(
        ["--preset", "smoke", "--device", "cpu", "--machines", "ndp",
         "--cores", "2", "--workloads", "rnd,gen", "--trace-len", "1024",
         "--memory", "banked"])
    (bucket,) = LAUNCH.run(args)
    assert "memory banked" in capsys.readouterr().out
    smoke = JC.PRESETS["smoke"]
    traces = jgenerate_traces(["rnd", "gen"], 2, length=1024, preset=smoke,
                              use_cache=False)
    jm = JC.ndp_machine(2)
    jm = dataclasses.replace(jm, memory=JMM.with_kind(jm.memory, "banked"))
    want = JSIM.simulate_batch(jm, traces, chunk=smoke.chunk)
    for w, r in zip(("rnd", "gen"), want):
        for m, s in r.speedup_vs().items():
            assert bucket["speedups"][w][m] == pytest.approx(s, rel=1e-5)
    with pytest.raises(SystemExit):
        LAUNCH.build_parser().parse_args(["--memory", "flat"])
