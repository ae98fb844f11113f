"""The watchdog half of the port's ``util/resilience.py`` against the JAX
package's: ``watchdog_call`` under a deadline, a real Python hang timing
out and then retrying, exhausted retries raising, inline mode retrying
only injected timeouts (with the same recovery events as the reference),
the ``dispatch`` fault site and ``dispatch_hang`` plan, the json entries
of the integrity-checked store, and the bucket-plan count staying
monotone across ``clear_runner_cache``."""
import os
import time

import pytest

from repro.util import resilience as JRES
from repro_torch.configs import ndp_sim as TC
from repro_torch.sim import simulator as TSIM
from repro_torch.util import resilience as RES

CHUNK_PLAN = 200


def test_returns_result_under_deadline():
    assert RES.watchdog_call(lambda: 7, 5.0) == 7
    assert RES.watchdog_call(lambda: 7, 0) == 7


def test_errors_propagate_unchanged():
    def boom():
        raise ValueError("not a timeout")

    for timeout in (0, 5.0):
        with pytest.raises(ValueError, match="not a timeout"):
            RES.watchdog_call(boom, timeout, retries=3)


def test_real_hang_times_out_then_retries():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(3)
        return "ok"

    cleared = []
    RES.recovery_events(clear=True)
    assert RES.watchdog_call(fn, 0.2, tag="t", retries=1,
                             on_timeout=lambda: cleared.append(1)) == "ok"
    assert len(calls) == 2 and cleared == [1]
    assert [k for k, _ in RES.recovery_events()] == [
        "watchdog_timeout", "watchdog_retry"]


def test_exhausted_retries_raise():
    def hang():
        time.sleep(3)

    RES.recovery_events(clear=True)
    with pytest.raises(RES.DispatchTimeout, match="exceeded 0.2s"):
        RES.watchdog_call(hang, 0.2, retries=0)
    assert [k for k, _ in RES.recovery_events()] == ["watchdog_timeout"]
    assert issubclass(RES.DispatchTimeout, RuntimeError)


@pytest.mark.parametrize("retries", (0, 1, 2))
def test_inline_mode_retries_injected_timeouts_as_the_reference(retries):
    """Timeout 0 runs inline: only an injected DispatchTimeout fires; the
    calls made, the result or the raise, and the recovery events are the
    reference's."""
    def drive(mod):
        inj = mod.FaultInjector([mod.Fault("dispatch", at=(0, 1))])
        calls = []

        def fn():
            calls.append(1)
            if inj.fires("dispatch", "bucket0"):
                raise mod.DispatchTimeout("injected")
            return 42

        mod.recovery_events(clear=True)
        try:
            out = mod.watchdog_call(fn, 0, tag="bucket0", retries=retries)
        except mod.DispatchTimeout:
            out = "raised"
        return out, len(calls), mod.recovery_events(), inj.fired

    assert drive(RES) == drive(JRES)


def test_dispatch_site_and_plan():
    inj = RES.FaultInjector.from_plan("dispatch_hang")
    assert inj.faults == (RES.Fault("dispatch", at=(0,)),)
    assert [(f.site, f.at, f.match) for f in inj.faults] == [
        (f.site, f.at, f.match)
        for f in JRES.FaultInjector.from_plan("dispatch_hang").faults]
    assert inj.fires("dispatch", "bucket0:x")
    assert not inj.fires("dispatch", "bucket1:x")
    scoped = RES.FaultInjector([RES.Fault("dispatch", match="bucket1")])
    assert not scoped.fires("dispatch", "bucket0")
    assert scoped.fires("dispatch", "bucket1")
    with pytest.raises(KeyError, match="dispatch_hang"):
        RES.FaultInjector.from_plan("nope")
    with pytest.raises(ValueError, match="unknown fault site"):
        RES.Fault("nope")
    assert RES.FAULT_SITES == ("cache_read", "cache_write", "dispatch",
                               "evict")


def test_json_entries(tmp_path):
    path = str(tmp_path / "sub" / "evals.json")
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    assert RES.write_json(path, obj)
    assert os.path.exists(path + RES.SIDECAR_SUFFIX)
    assert RES.read_json(path) == obj == JRES.read_json(path)
    assert RES.read_json(str(tmp_path / "missing.json")) is None
    # a bit flip fails the sidecar: quarantined, recomputed
    raw = bytearray(open(path, "rb").read())
    raw[3] ^= 0x20
    open(path, "wb").write(bytes(raw))
    RES.recovery_events(clear=True)
    assert RES.read_json(path) is None
    assert not os.path.exists(path)
    assert os.listdir(tmp_path / "sub" / RES.QUARANTINE_DIR)
    assert [k for k, _ in RES.recovery_events()] == ["quarantine"]
    # no sidecar and not json: quarantined as well
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert RES.read_json(str(bad)) is None and not bad.exists()


def test_plan_count_monotone_across_clear():
    mach = TC.ndp_machine(1)
    key = (TSIM.machine_shape(mach), TSIM._walk_fns(TSIM.DEFAULT_MECHS),
           CHUNK_PLAN)
    before = TSIM.runner_cache_info().misses
    plan = TSIM._bucket_plan(*key)
    assert TSIM.runner_cache_info().misses == before + 1
    assert TSIM._bucket_plan(*key) is plan                  # a hit
    assert TSIM.runner_cache_info().misses == before + 1
    TSIM.clear_runner_cache()
    assert TSIM.runner_cache_info().misses == before + 1
    assert TSIM.runner_cache_info().currsize == 0
    assert TSIM._bucket_plan(*key) == plan                  # made anew
    assert TSIM.runner_cache_info().misses == before + 2
    assert (plan.n_hier, plan.has_ctlb, plan.banks, plan.m) == (1, False, 0,
                                                                5)
    assert plan.scan_kernel == "lru_scan_kernel<1, false, false>"
    assert plan.epilogue_kernel == "sim_epilogue_kernel<false>"
