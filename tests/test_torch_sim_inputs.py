"""The simulator's inputs in the port against the JAX package: machine
configs and presets, memory model, PTE walk lines, mechanism registry,
trace generation and its integrity-checked cache."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ndp_sim as JC
from repro.core import page_table as JPT
from repro.sim import mechanisms as JMECH
from repro.sim import memory_model as JMM
from repro.workloads import generate_trace as jgenerate_trace
from repro.workloads import generators as JGEN
from repro.workloads import parse_workload_spec as jparse
from repro_torch.configs import ndp_sim as TC
from repro_torch.core import page_table as TPT
from repro_torch.sim import mechanisms as TMECH
from repro_torch.sim import memory_model as TMM
from repro_torch.util import resilience as TRES
from repro_torch.workloads import generate_trace as tgenerate_trace
from repro_torch.workloads import generators as TGEN
from repro_torch.workloads import parse_workload_spec as tparse

MACHINES = ("cpu_machine", "ndp_machine", "zoo_machine")
WALKS = sorted(JPT.WALKS)


# ---------------------------------------------------------------------------
# configs and memory model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cores", [1, 2, 4, 8])
@pytest.mark.parametrize("machine", MACHINES)
def test_machine_configs_equal(machine, cores):
    jm = getattr(JC, machine)(cores)
    tm = getattr(TC, machine)(cores)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tm.memory) == dataclasses.asdict(jm.memory)
    assert tm.memory.shape_key() == jm.memory.shape_key()
    assert tm.l1d.num_sets == jm.l1d.num_sets


def test_workloads_presets_core_counts_equal():
    assert TC.WORKLOADS == JC.WORKLOADS
    assert list(TC.WORKLOADS) == list(JC.WORKLOADS)
    assert TC.CORE_COUNTS == JC.CORE_COUNTS
    assert list(TC.PRESETS) == list(JC.PRESETS)
    for name, preset in JC.PRESETS.items():
        assert dataclasses.asdict(TC.PRESETS[name]) == dataclasses.asdict(
            preset)


@pytest.mark.parametrize("spec", [None, "bounded_linear", "banked",
                                  dict(latency=123.0, service=7.0),
                                  dict(kind="banked", num_banks=8,
                                       row_buffer_bytes=1024)])
def test_memory_model_resolution_equal(spec):
    jm, tm = JMM.resolve_memory_model(spec), TMM.resolve_memory_model(spec)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for f in ("miss_latency", "hit_latency", "row_hit_save", "shape_key"):
        assert getattr(tm, f)() == getattr(jm, f)()
    for contiguous in (False, True):
        assert tm.line_cycles(contiguous) == jm.line_cycles(contiguous)
    for kind in JMM.MEMORY_MODELS:
        assert dataclasses.asdict(TMM.with_kind(tm, kind)) == \
            dataclasses.asdict(JMM.with_kind(jm, kind))
    lines = np.arange(0, 1 << 20, 997)
    assert np.array_equal(TMM.bank_of(lines, tm.num_banks, tm.lines_per_row),
                          JMM.bank_of(lines, jm.num_banks, jm.lines_per_row))
    assert np.array_equal(TMM.row_of(lines, tm.num_banks, tm.lines_per_row),
                          JMM.row_of(lines, jm.num_banks, jm.lines_per_row))


def test_memory_model_registry_and_errors():
    assert list(TMM.MEMORY_MODELS) == list(JMM.MEMORY_MODELS)
    for name, mm in JMM.MEMORY_MODELS.items():
        assert dataclasses.asdict(TMM.MEMORY_MODELS[name]) == \
            dataclasses.asdict(mm)
    assert (TMM.QUEUE_K, TMM.RHO_MAX) == (JMM.QUEUE_K, JMM.RHO_MAX)
    with pytest.raises(ValueError):
        TMM.MemoryModel(kind="flat")
    with pytest.raises(ValueError):
        TMM.MemoryModel(row_buffer_bytes=100)
    with pytest.raises(KeyError):
        TMM.resolve_memory_model("ddr9")
    with pytest.raises(TypeError):
        TMM.resolve_memory_model(3)


def test_queue_delay_equal():
    rng = np.random.default_rng(0)
    rate = rng.random((5, 7), dtype=np.float32) * np.float32(0.05)
    service = np.float32(46.0)
    want = np.asarray(JMM.queue_delay(jnp.asarray(rate), service))
    got = TMM.queue_delay(torch.from_numpy(rate), service).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # past saturation both clip rho at RHO_MAX
    big = torch.full((3,), 10.0)
    assert torch.allclose(TMM.queue_delay(big, 2.0),
                          torch.full((3,), 2.0 * JMM.RHO_MAX * JMM.QUEUE_K))


# ---------------------------------------------------------------------------
# PTE walk lines
# ---------------------------------------------------------------------------
def walk_vpns() -> np.ndarray:
    """vpns from a seed, the edges, and values whose hash has bit 31 set
    at every salt the walks use (the int64 hash must keep its top bit)."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 1 << 23, 4096).astype(np.int64)
    wide = rng.integers(0, 2 ** 31 - 1, 1024).astype(np.int64)
    edges = np.array([0, 1, (1 << 22) - 1, 1 << 22, (1 << 23) - 1,
                      2 ** 31 - 1, 2 ** 30, (1 << 27) - 1, 1 << 27])
    pool = np.concatenate([base, wide])
    top = [pool[(JPT._hash_np(pool >> sh, salt) >> np.uint32(31)) == 1][:64]
           for salt in (0xA0, 0xA1, 0xA2, 0xA3, 0xB0, 0xC0, 0xC1, 0xD5,
                        0xF1, 0xF7) for sh in (0, 9, 18, 27)]
    return np.concatenate([edges, pool] + top).astype(np.int32)


@pytest.mark.parametrize("name", WALKS)
def test_walk_lines_bit_identical(name):
    vpn = walk_vpns()
    want = np.asarray(JPT.WALKS[name](jnp.asarray(vpn)))
    got = TPT.WALKS[name](torch.from_numpy(vpn))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # (T, C) inputs, as the engine passes them
    got2 = TPT.WALKS[name](torch.from_numpy(vpn[:2048].reshape(256, 8)))
    assert np.array_equal(got2.numpy().reshape(want[:2048].shape),
                          want[:2048])


def test_mix_hash_top_bits():
    """The int64 hash keeps 32 bits exactly, also where x * 0x846CA68B
    passes 2^63 and wraps."""
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF,
                  0x12345678, 0xFFFF0000], np.uint32)
    for salt in (0x0, 0xA0, 0xD5, 0xFFFFFFFF):
        want = np.asarray(JPT._mix(jnp.asarray(x), salt))
        got = TPT._mix(torch.from_numpy(x.astype(np.int64)), salt)
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        assert np.array_equal(TPT._hash_np(x, salt), JPT._hash_np(x, salt))
    assert int((TPT._mix(torch.from_numpy(x.astype(np.int64)), 0xA0)
                >> 31).sum()) > 0


def test_page_table_numpy_helpers_equal():
    rng = np.random.default_rng(3)
    vpns = np.unique(rng.integers(0, 1 << 22, 3000))
    for a, b in zip(TPT.inverted_table_insert(vpns, 12),
                    JPT.inverted_table_insert(vpns, 12)):
        assert np.array_equal(a, b)
    starts = np.cumsum(rng.integers(5, 50, 40))
    lengths = rng.integers(1, 5, 40)
    targets = rng.integers(0, 1 << 20, 40)
    addrs = rng.integers(0, int(starts[-1]) + 10, 500)
    want = JPT.range_table_lookup(starts, lengths, targets, addrs)
    assert np.array_equal(
        TPT.range_table_lookup(starts, lengths, targets, addrs), want)
    assert np.array_equal(
        TPT.range_table_lookup_linear(starts, lengths, targets, addrs), want)
    assert TPT.occupancy_by_level(vpns) == JPT.occupancy_by_level(vpns)
    assert TPT.flattened_occupancy(vpns) == JPT.flattened_occupancy(vpns)
    with pytest.raises(ValueError):
        TPT.inverted_table_insert(np.array([1, 1]))


# ---------------------------------------------------------------------------
# mechanism registry
# ---------------------------------------------------------------------------
def test_registry_names_and_order_equal():
    assert TMECH.registered_names() == JMECH.registered_names()
    assert len(TMECH.registered_names()) == 17
    assert TMECH.DEFAULT_MECHS == JMECH.DEFAULT_MECHS
    assert TMECH.ZOO_MECHS == JMECH.ZOO_MECHS
    assert TMECH.MAX_PTE == JMECH.MAX_PTE


@pytest.mark.parametrize("name", JMECH.registered_names())
def test_mechanism_twin(name):
    """Every registered reference mechanism has a port twin: the same
    fields, a walk fn of the same ``__qualname__``, equal tables."""
    js, ts = JMECH.get(name), TMECH.get(name)
    for f in dataclasses.fields(js):
        if f.name != "walk_fn":
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    if js.walk_fn is None:
        assert ts.walk_fn is None
    else:
        assert ts.walk_fn.__qualname__ == js.walk_fn.__qualname__
        assert ts.walk_fn is TPT.WALKS[next(
            k for k, v in JPT.WALKS.items() if v is js.walk_fn)]
    jt, tt = JMECH.tables_for((name,)), TMECH.tables_for((name,))
    for f in dataclasses.fields(jt):
        assert np.array_equal(getattr(tt, f.name), getattr(jt, f.name))


def test_tables_for_all_and_register_checks():
    names = JMECH.registered_names()
    jt, tt = JMECH.tables_for(names), TMECH.tables_for(names)
    for f in dataclasses.fields(jt):
        a, b = getattr(tt, f.name), getattr(jt, f.name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype
    with pytest.raises(ValueError, match="already registered"):
        TMECH.register(TMECH.get("radix"))
    with pytest.raises(ValueError, match="walk_fn returns shape"):
        TMECH.register(dataclasses.replace(
            TMECH.get("radix"), name="bad_width", n_pte=3,
            pwc_levels=(True, True, True, False)))
    with pytest.raises(KeyError):
        TMECH.get("nope")


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cores", [1, 4, 8])
@pytest.mark.parametrize("workload", list(JC.WORKLOADS))
def test_generate_trace_bit_identical(workload, cores):
    want = jgenerate_trace(workload, cores, preset="smoke", use_cache=False)
    got = tgenerate_trace(workload, cores, preset="smoke", use_cache=False)
    for k in ("vpn", "off", "work"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert got["pages"] == want["pages"]


def test_generate_traces_and_explicit_args():
    from repro.workloads import generate_traces as jgen_all
    from repro_torch.workloads import generate_traces as tgen_all
    want = jgen_all(["rnd", "gen"], 2, length=300, seed=5, use_cache=False)
    got = tgen_all(["rnd", "gen"], 2, length=300, seed=5, use_cache=False)
    for a, b in zip(got, want):
        assert all(np.array_equal(a[k], b[k]) for k in ("vpn", "off", "work"))
    with pytest.raises(TypeError):
        tgenerate_trace("rnd", 2, use_cache=False)


def test_trace_cache_round_trip_and_quarantine(tmp_path, monkeypatch):
    monkeypatch.setenv("SIM_TRACE_CACHE", str(tmp_path))
    spec = TC.WORKLOADS["bc"]
    pages = TGEN._pages(spec["footprint_gb"])
    path = TGEN._cache_path("bc", 2, 400, 9, spec, pages)
    # the JAX package's key, in the port's own subdirectory of its cache
    jpath = JGEN._cache_path("bc", 2, 400, 9, JC.WORKLOADS["bc"], pages)
    assert path == os.path.join(os.path.dirname(jpath), TGEN.CACHE_SUBDIR,
                                os.path.basename(jpath))
    fresh = tgenerate_trace("bc", 2, length=400, seed=9)
    assert os.path.exists(path) and os.path.exists(path + ".sha256")
    assert not os.path.exists(jpath)     # the reference's entry untouched
    cached = tgenerate_trace("bc", 2, length=400, seed=9)
    for k in ("vpn", "off", "work"):
        assert np.array_equal(cached[k], fresh[k])

    TRES.recovery_events(clear=True)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    again = tgenerate_trace("bc", 2, length=400, seed=9)
    assert np.array_equal(again["vpn"], fresh["vpn"])
    assert [k for k, _ in TRES.recovery_events()] == ["quarantine"]
    qdir = tmp_path / TGEN.CACHE_SUBDIR / TRES.QUARANTINE_DIR
    assert sorted(p.name for p in qdir.iterdir()) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".sha256"])
    assert os.path.exists(path)          # regenerated and stored again

    monkeypatch.setenv("SIM_TRACE_CACHE", "0")
    assert TGEN.trace_cache_dir() is None
    assert TGEN._cache_path("bc", 2, 400, 9, spec, pages) is None


def test_cache_store_faults(tmp_path, monkeypatch):
    arrays = {"a": np.arange(5), "b": np.ones((2, 3), np.float32)}
    # a cache directory that cannot be created: the write degrades to
    # cache-off, and trace generation runs on without the cache
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"")
    TRES.recovery_events(clear=True)
    assert not TRES.write_npz(str(blocker / "sub" / "entry.npz"), arrays)
    assert [k for k, _ in TRES.recovery_events()] == ["cache_off"]
    monkeypatch.setenv("SIM_TRACE_CACHE", str(blocker))
    got = tgenerate_trace("rnd", 2, length=300, seed=5)
    want = tgenerate_trace("rnd", 2, length=300, seed=5, use_cache=False)
    assert np.array_equal(got["vpn"], want["vpn"])

    path = str(tmp_path / "sub" / "entry.npz")
    assert TRES.write_npz(path, arrays)
    got = TRES.read_npz(path)
    assert all(np.array_equal(got[k], v) for k, v in arrays.items())
    assert TRES.read_bytes(str(tmp_path / "missing")) is None
    with open(path, "wb") as f:                        # torn entry
        f.write(b"PK\x03\x04")
    assert TRES.read_npz(path) is None
    with pytest.raises(ValueError):              # a site neither has
        TRES.Fault("nope")


def test_parse_workload_spec_equal():
    for name in JC.WORKLOADS:
        j, t = jparse(name), tparse(name)
        assert (t.kind, t.name, t.opts, t.canonical()) == (
            j.kind, j.name, j.opts, j.canonical())
    with pytest.raises(KeyError):
        jparse("nope")
    with pytest.raises(KeyError):
        tparse("nope")
    for spec in ("trace:/tmp/x.champsim",
                 "trace:/tmp/a.csv?interleave=thread&page_bytes=8192",
                 "trace:rel/b.lackey.gz?gap_cap=64&work_clip=8&fmt=lackey"):
        j, t = jparse(spec), tparse(spec)
        assert (t.kind, t.name, t.opts, t.canonical()) == (
            j.kind, j.name, j.opts, j.canonical()) == (
            "trace", j.name, j.opts, spec)
        assert t.with_path("/abs/x").canonical() == \
            j.with_path("/abs/x").canonical()
    for bad in ("trace:/tmp/a.csv?nope=1", "trace:", "trace:/a.csv?gap_cap"):
        with pytest.raises(ValueError) as want:
            jparse(bad)
        with pytest.raises(ValueError) as got:
            tparse(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        tgenerate_trace("trace:/nonexistent/x.champsim", 2, use_cache=False)
