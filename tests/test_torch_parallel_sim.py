"""The simulator's ``devices``: the batch's lanes split into groups,
each group through the same two kernels on its own device, the results
gathered in job order (``sim.simulator.run_lane_groups``).  On the CPU
the groups run on CPU devices (the plain scan and epilogue), 2 to 5 of
them over 5 jobs of one bucket: every counter and every float sum equals
the one-group run bit for bit (lanes never meet, and a lane's sums run
in one order whatever the group's width), and equals the JAX
``simulate_batch`` on the same jobs (integer counters exact, cycles rtol
1e-5, the simulator's tolerance).  The device count follows the JAX
rule: 1 by default, every card with ``SIM_DEVICES`` set, clamped to the
cards there are and to the batch, and recorded in ``timings``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ndp_sim as JC
from repro.sim import simulator as JSIM
from repro_torch.configs import ndp_sim as TC
from repro_torch.sim import memory_model as TMM
from repro_torch.sim import run_bucketed
from repro_torch.sim import simulator as TSIM

INT_FIELDS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
              "pte_mem", "data_l1_misses", "data_mem", "accesses",
              "instructions")
FLOAT_FIELDS = ("cycles", "trans_cycles", "walk_cycles")
WORKLOADS = ("rnd", "bfs", "pr", "xs", "dlrm")
LENGTHS = (300, 520, 384, 333, 200)
CHUNK = 128


def _cut(trace, n):
    return {k: (v[:, :n] if k != "pages" else v) for k, v in trace.items()}


@pytest.fixture(scope="module")
def traces(smoke_trace):
    return [_cut(smoke_trace(w, 2), n) for w, n in zip(WORKLOADS, LENGTHS)]


def _machines(pkg):
    base = pkg.ndp_machine(2)
    slow = dataclasses.replace(base, name="ndp-slow", memory=dataclasses
                               .replace(base.memory, latency=150.0))
    return [base, slow, base, slow, base]


def _jobs(traces, memory="bounded_linear"):
    machines = _machines(TC)
    if memory == "banked":      # 16 banks of 2 KB rows
        machines = [dataclasses.replace(m, memory=dataclasses.replace(
            TMM.with_kind(m.memory, "banked"), num_banks=16))
            for m in machines]
    return [TSIM.SimJob(m, t) for m, t in zip(machines, traces)]


@pytest.fixture(scope="module")
def one_group(traces):
    return {mem: TSIM.run_lane_groups(_jobs(traces, mem), ["cpu"],
                                      chunk=CHUNK)
            for mem in ("bounded_linear", "banked")}


@pytest.mark.parametrize("memory", ["bounded_linear", "banked"])
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_lane_groups_equal_one_group_bit_for_bit(traces, one_group, n,
                                                 memory):
    timings = {}
    got = TSIM.run_lane_groups(_jobs(traces, memory), ["cpu"] * n,
                               chunk=CHUNK, timings=timings)
    assert timings["devices"] == n
    assert len(got) == len(WORKLOADS)
    for g, w in zip(got, one_group[memory]):
        assert g.mechs == w.mechs
        for f in INT_FIELDS + FLOAT_FIELDS:
            assert np.array_equal(getattr(g, f), getattr(w, f)), f


@pytest.mark.parametrize("n", [1, 3])
def test_lane_groups_match_the_jax_batch(traces, n):
    got = TSIM.run_lane_groups(_jobs(traces), ["cpu"] * n, chunk=CHUNK)
    want = JSIM.simulate_batch_varied(
        [JSIM.SimJob(m, t) for m, t in zip(_machines(JC), traces)],
        chunk=CHUNK)
    assert [r.accesses for r in got] == list(LENGTHS)
    for g, w in zip(got, want):
        for f in INT_FIELDS:
            assert np.array_equal(np.asarray(getattr(g, f), np.float64),
                                  np.asarray(getattr(w, f), np.float64)), f
        for f in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-5, atol=0, err_msg=f)


def test_lane_groups_split_and_pad():
    assert TSIM.lane_groups(5, 4) == [range(0, 2), range(2, 4), range(4, 6),
                                      range(6, 8)]
    assert TSIM.lane_groups(4, 2) == [range(0, 2), range(2, 4)]
    assert TSIM.lane_groups(3, 1) == [range(0, 3)]


def test_device_count_follows_the_jax_rule(monkeypatch):
    monkeypatch.delenv("SIM_DEVICES", raising=False)
    assert TSIM.sim_devices(None, 8, "cpu") == 1
    assert TSIM.sim_devices(4, 8, "cpu") == 1     # one CPU device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TSIM.sim_devices(None, 8, "cuda") == 1
    assert TSIM.sim_devices(8, 10, "cuda") == 4   # the cards there are
    assert TSIM.sim_devices(8, 3, "cuda") == 3    # the batch
    assert TSIM.sim_devices(2, 10, "cuda") == 2
    assert TSIM.sim_devices(0, 10, "cuda") == 1
    monkeypatch.setenv("SIM_DEVICES", "1")
    assert TSIM.sim_devices(None, 8, "cuda") == 4
    assert TSIM.sim_devices(None, 2, "cuda") == 2


def test_a_clamp_is_recorded(traces):
    """devices=3 on the CPU runs on its one device: the batch result is
    the one-device result, and timings and the sweep engine's bucket
    entries say 1."""
    timings = {}
    got = TSIM.simulate_batch_varied(_jobs(traces)[:2], chunk=CHUNK,
                                     devices=3, timings=timings,
                                     device="cpu")
    assert timings["devices"] == 1
    want = TSIM.run_lane_groups(_jobs(traces)[:2], ["cpu"], chunk=CHUNK)
    for g, w in zip(got, want):
        assert np.array_equal(g.cycles, w.cycles)
    _, stats = run_bucketed(_jobs(traces)[:2], chunk=CHUNK, devices=3,
                            device="cpu")
    assert [b["devices"] for b in stats["per_bucket"]] == [1]
