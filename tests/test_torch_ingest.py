"""The port's real-trace ingest layer (``repro_torch.workloads.ingest``)
against the JAX package's (``repro.workloads.ingest``): the parsers'
block streams and ``ingest_trace`` on the committed fixtures (ChampSim
xz, Valgrind lackey gz) and on CSV files written here, under every
interleave and option, must give identical arrays; the same inputs must
raise the same errors; the cache keys must be equal; and ``trace:``
specs must simulate through the port's engine and launcher as through
``repro.sim``."""
import dataclasses
import gzip
import lzma
import os

import numpy as np
import pytest

from repro.configs import ndp_sim as JC
from repro.sim import memory_model as JMM
from repro.sim import simulator as JSIM
from repro.workloads import generate_trace as jgenerate_trace
from repro.workloads import ingest as JI
from repro.workloads.ingest import champsim as jchampsim
from repro.workloads.ingest import lackey as jlackey
from repro.workloads.ingest import textcsv as jtextcsv
from repro_torch.configs import ndp_sim as TC
from repro_torch.launch import simulate as LAUNCH
from repro_torch.sim import simulator as TSIM
from repro_torch.workloads import generate_trace as tgenerate_trace
from repro_torch.workloads import ingest as TI
from repro_torch.workloads.ingest import champsim as tchampsim
from repro_torch.workloads.ingest import lackey as tlackey
from repro_torch.workloads.ingest import textcsv as ttextcsv

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "traces")
GUPS_FIX = os.path.join(FIXDIR, "gups_small.champsim.xz")
GRAPH_FIX = os.path.join(FIXDIR, "graph_small.lackey.gz")
RTOL = 1e-5
INT_FIELDS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
              "pte_mem", "data_l1_misses", "data_mem")
FLOAT_FIELDS = ("cycles", "trans_cycles", "walk_cycles")


def assert_traces_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in ("vpn", "off", "work"):
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["pages"] == want["pages"]


def assert_same_error(fn_j, fn_t, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_j()
    with pytest.raises(exc) as got:
        fn_t()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def champsim_records(n=600, seed=0, mem_prob=0.8):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, jchampsim.RECORD_DTYPE)
    rec["ip"] = 0x400000 + 4 * np.arange(n)
    has = rng.random(n) < mem_prob
    addr = 0x7f0000000 + rng.integers(0, 1 << 20, n) * 64
    rec["src_mem"][has, 0] = addr[has]
    rec["dst_mem"][has & (rng.random(n) < 0.3), 1] = 0x10000040
    return rec


def write_champsim(path, rec):
    raw = rec.tobytes()
    opener = (lzma.open if str(path).endswith(".xz") else
              gzip.open if str(path).endswith(".gz") else open)
    with opener(path, "wb") as f:
        f.write(raw)
    return str(path)


@pytest.mark.parametrize("fix,parsers", [
    (GUPS_FIX, (jchampsim, tchampsim)), (GRAPH_FIX, (jlackey, tlackey))])
def test_fixture_block_streams_equal(fix, parsers):
    jmod, tmod = parsers
    assert tmod.parse_blocks.__qualname__ == jmod.parse_blocks.__qualname__
    for kw in ({}, {tmod.parse_blocks.__code__.co_varnames[1]: 1000}):
        want, got = list(jmod.parse_blocks(fix, **kw)), list(
            tmod.parse_blocks(fix, **kw))
        assert len(got) == len(want) >= 1
        for (ga, gw, gt), (wa, ww, wt) in zip(got, want):
            assert np.array_equal(ga, wa) and ga.dtype == wa.dtype
            assert np.array_equal(gw, ww) and gw.dtype == ww.dtype
            assert gt is None and wt is None
    assert TI.detect_format(fix) == JI.detect_format(fix)


@pytest.mark.parametrize("opts", [
    dict(), dict(length=100), dict(length=5000),
    dict(interleave="blocked"), dict(interleave="blocked", length=64),
    dict(page_bytes=8192), dict(page_bytes=128, gap_cap=16),
    dict(work_clip=4), dict(work_clip=0, gap_cap=1),
])
@pytest.mark.parametrize("fix", [GUPS_FIX, GRAPH_FIX])
@pytest.mark.parametrize("cores", [1, 2, 8])
def test_fixture_ingest_equal(fix, cores, opts):
    want = JI.ingest_trace(fix, cores, use_cache=False, **opts)
    got = TI.ingest_trace(fix, cores, use_cache=False, **opts)
    assert_traces_equal(got, want)
    if "length" in opts:
        assert got["vpn"].shape[1] <= opts["length"]
    assert got["vpn"].shape[0] == cores


CSV_FILES = {
    "headered.csv": "# a comment\ntid,addr,work,size\n"
                    + "".join(f"{i % 3},0x{0x7f001000 + 0x40 * i * (i % 5):x},"
                              f"{i % 7},8\n" for i in range(240)),
    "positional.csv": "".join(f"0x{0x2000000 + 0x1000 * (i * 37 % 91):x}\n"
                              for i in range(200)),
    "positional_tid.txt": "".join(f"{0x9000 + 64 * i} {i % 4} {i % 3}\n"
                                  for i in range(160)),
    "spaced.mem": "".join(f"  0x{0x5000 * i:x}   {i % 2}\n"
                          for i in range(64)),
}


@pytest.mark.parametrize("interleave", ["round_robin", "blocked", "thread"])
@pytest.mark.parametrize("name", sorted(CSV_FILES))
def test_csv_ingest_equal(tmp_path, name, interleave):
    p = tmp_path / name
    p.write_text(CSV_FILES[name])
    want = list(jtextcsv.parse_blocks(str(p), block_lines=50))
    got = list(ttextcsv.parse_blocks(str(p), block_lines=50))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b) and a.dtype == b.dtype
    for cores in (1, 2, 3):
        for length in (None, 7):
            def run(mod):
                return mod.ingest_trace(str(p), cores, interleave=interleave,
                                        length=length, use_cache=False)
            try:
                want = run(JI)
            except JI.TraceFormatError:
                assert_same_error(lambda: run(JI), lambda: run(TI))
                continue
            assert_traces_equal(run(TI), want)


def test_same_errors(tmp_path):
    """The same bad inputs raise the same exception types and messages."""
    def both(path, *a, **kw):
        kw.setdefault("use_cache", False)
        assert_same_error(lambda: JI.ingest_trace(str(path), *a, **kw),
                          lambda: TI.ingest_trace(str(path), *a, **kw))

    rec = champsim_records(100)
    trunc = tmp_path / "trunc.champsim"
    trunc.write_bytes(rec.tobytes()[:-13])
    both(trunc, 2)
    empty = tmp_path / "empty.champsim"
    empty.write_bytes(b"")
    both(empty, 2)
    both(write_champsim(tmp_path / "nomem.champsim",
                        champsim_records(50, mem_prob=0.0)), 2)
    bad = tmp_path / "bad.lackey"
    bad.write_text("I  04000000,3\n L 04e2b848,8\nXYZZY 123\n")
    both(bad, 1)
    bad.write_text(" L nothex,8\n")
    both(bad, 1)
    csv = tmp_path / "bad.csv"
    csv.write_text("addr,work\n0x1000,1\n0x2000\n")
    both(csv, 1)
    csv.write_text("addr,nope\n0x1000,1\n")
    both(csv, 1)
    csv.write_text("tid,work\n1,1\n")
    both(csv, 1)
    csv.write_text("0x1000,1,2,3\n")
    both(csv, 1)
    csv.write_text("0x10zz\n")
    both(csv, 1)
    ok = tmp_path / "a.csv"
    ok.write_text("\n".join(f"0x{0x1000 * i:x}" for i in range(10)))
    both(ok, 16)                                      # too short
    both(ok, 2, interleave="thread")                  # no tid column
    both(ok, 1, page_bytes=3000)
    both(ok, 1, gap_cap=0)
    both(ok, 1, work_clip=-5)
    both(ok, 1, interleave="zigzag")
    both(ok, 1, fmt="elf")
    both(ok, 0)
    assert_same_error(lambda: JI.detect_format("mystery.bin"),
                      lambda: TI.detect_format("mystery.bin"))
    for name in ("x.champsim.xz", "runs/app.trace.gz", "mem.lackey.gz",
                 "t.csv", "t.txt.gz", "t.mem"):
        assert TI.detect_format(name) == JI.detect_format(name)
    for spec in ("trace:/tmp/a.csv?nope=1", "trace:", "rnd",
                 "trace:/a?page_bytes=x"):
        assert_same_error(lambda: JI.parse_trace_spec(spec),
                          lambda: TI.parse_trace_spec(spec))
    assert TI.is_trace_spec("trace:/a") and not TI.is_trace_spec(3)
    assert issubclass(TI.TraceFormatError, ValueError)


def test_compression_parity_and_cache(tmp_path, monkeypatch):
    """.xz, .gz and plain files ingest alike; the cache entry has the JAX
    package's key, in the port's own subdirectory, and a warm read
    equals a cold parse."""
    root = tmp_path / "cache"
    monkeypatch.setenv("SIM_TRACE_CACHE", str(root))
    rec = champsim_records(seed=4)
    paths = [write_champsim(tmp_path / n, rec) for n in (
        "a.champsim", "b.champsim.gz", "c.champsim.xz")]
    cold = [TI.ingest_trace(p, 2, length=100) for p in paths]
    for t in cold[1:]:
        assert_traces_equal(t, cold[0])
    want = [JI.ingest_trace(p, 2, length=100) for p in paths]
    for g, w in zip(cold, want):
        assert_traces_equal(g, w)

    def entries(d):
        return sorted(f.name for f in d.iterdir()
                      if f.name.startswith("ingest_"))

    port = entries(root / "repro_torch")
    assert port and port == entries(root)      # same keys, two directories
    assert all(n.endswith(".npz") or n.endswith(".npz.sha256") for n in port)
    warm = TI.ingest_trace(paths[2], 2, length=100)
    assert_traces_equal(warm, cold[2])
    # a cached entry serves only its own options and content
    TI.ingest_trace(paths[0], 2, length=100, page_bytes=8192)
    assert len(entries(root / "repro_torch")) == len(port) + 2


def test_generate_trace_dispatches_specs():
    for spec in (f"trace:{GUPS_FIX}",
                 f"trace:{GRAPH_FIX}?interleave=blocked&gap_cap=64",
                 f"trace:{GUPS_FIX}?page_bytes=8192&work_clip=16"):
        for length in (None, 300):
            want = jgenerate_trace(spec, 4, length=length, use_cache=False)
            got = tgenerate_trace(spec, 4, length=length, use_cache=False)
            assert_traces_equal(got, want)
    # the preset's window clamps a real trace; its seed is ignored
    got = tgenerate_trace(f"trace:{GUPS_FIX}", 2, preset="smoke",
                          use_cache=False)
    assert got["vpn"].shape == (2, TC.PRESETS["smoke"].trace_len)


@pytest.mark.parametrize("memory", ["bounded_linear", "banked"])
def test_trace_specs_simulate_equal(memory):
    """Both fixtures as two lanes of one batch (mixed lengths), through
    the port's engine and repro.sim: integer counters exact, cycles
    within rtol 1e-5."""
    specs = [f"trace:{GUPS_FIX}", f"trace:{GRAPH_FIX}?interleave=blocked"]
    jm = jax_machine(memory)
    tm = LAUNCH.bucket_machine("ndp", 2, memory)
    want = JSIM.simulate_batch(jm, specs, length=600, chunk=256)
    got = TSIM.simulate_batch(tm, specs, length=600, chunk=256, device="cpu")
    for g, w in zip(got, want):
        assert g.accesses == w.accesses == 600
        for f in INT_FIELDS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL, atol=0, err_msg=f)
    one = TSIM.simulate(tm, specs[0], length=600, chunk=256, device="cpu")
    for f in INT_FIELDS:
        assert np.array_equal(getattr(one, f), getattr(got[0], f)), f


def jax_machine(memory):
    """The JAX package's ndp_machine(2) with ``memory``, as the launcher
    switches it."""
    mach = JC.ndp_machine(2)
    if memory == "bounded_linear":
        return mach
    return dataclasses.replace(mach, memory=JMM.with_kind(mach.memory,
                                                          memory))


def test_launcher_takes_trace_specs(monkeypatch, capsys):
    monkeypatch.setenv("SIM_TRACE_CACHE", "0")
    spec = f"trace:{GUPS_FIX}"
    args = LAUNCH.build_parser().parse_args(
        ["--preset", "smoke", "--device", "cpu", "--machines", "ndp",
         "--cores", "1", "--workloads", f"{spec},rnd", "--trace-len", "512"])
    (bucket,) = LAUNCH.run(args)
    out = capsys.readouterr().out
    assert f"fig12_1c_{spec}:" in out
    want = JSIM.simulate(JC.ndp_machine(1), spec, length=512,
                         chunk=JC.PRESETS["smoke"].chunk)
    for m, s in want.speedup_vs().items():
        assert bucket["speedups"][spec][m] == pytest.approx(s, rel=1e-5)
    with pytest.raises(KeyError, match="unknown workload"):
        LAUNCH.run(LAUNCH.build_parser().parse_args(
            ["--device", "cpu", "--workloads", "nope"]))
