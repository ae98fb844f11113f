"""The port's standalone LRU model (``repro_torch.sim.cache_model``) against
the JAX package's (``repro.sim.cache_model``): seeded sequences of keys,
``insert`` and ``enabled`` bits through both, state and hits identical
after every access."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import cache_model as JCM
from repro_torch.sim import cache_model as TCM


def run_both(num_sets, ways, keys, inserts, enables):
    jstate, tstate = JCM.make(num_sets, ways), TCM.make(num_sets, ways)
    jaccess = jax.jit(JCM.access)
    for k, ins, en in zip(keys, inserts, enables):
        jstate, jhit = jaccess(jstate, jnp.int32(k), insert=jnp.bool_(ins),
                               enabled=jnp.bool_(en))
        tstate, thit = TCM.access(tstate, torch.tensor(k, dtype=torch.int32),
                                  insert=torch.tensor(bool(ins)),
                                  enabled=torch.tensor(bool(en)))
        assert bool(thit) == bool(jhit)
        assert thit.dtype == torch.bool and thit.shape == ()
        for f in ("tags", "lru", "ctr"):
            got, want = tstate[f].numpy(), np.asarray(jstate[f])
            assert got.dtype == want.dtype == np.int32, f
            assert np.array_equal(got, want), f
    return tstate


@pytest.mark.parametrize("num_sets,ways,key_space,seed", [
    (4, 2, 24, 0), (16, 4, 100, 1), (1, 8, 12, 2), (64, 12, 5000, 3)])
def test_access_matches_reference(num_sets, ways, key_space, seed):
    rng = np.random.default_rng(seed)
    n = 300
    keys = rng.integers(0, key_space, n).astype(np.int32)
    inserts = rng.random(n) < 0.8
    enables = rng.random(n) < 0.9
    st = run_both(num_sets, ways, keys, inserts, enables)
    # the sequences hit, filled, and skipped
    assert int(st["ctr"]) == n and bool((st["tags"] > 0).any())


def test_access_negative_and_extreme_keys():
    """Keys anywhere in int32: set and tag by truncating division, a
    negative set index wrapping as in the JAX package."""
    rng = np.random.default_rng(7)
    keys = np.concatenate([
        rng.integers(-40, 40, 120),
        [2 ** 31 - 1, -2 ** 31, 0, -1, 2 ** 31 - 1, -2 ** 31]]).astype(
        np.int32)
    ones = np.ones(keys.size, bool)
    run_both(8, 4, keys, ones, ones)
    run_both(1, 2, keys, rng.random(keys.size) < 0.5, ones)


def test_access_is_pure_and_reports_misses_when_disabled():
    st = TCM.make(4, 2)
    new, hit = TCM.access(st, 5, insert=True, enabled=True)
    assert not bool(hit) and int(st["ctr"]) == 0 and not bool(st["tags"].any())
    _, hit = TCM.access(new, 5, insert=True, enabled=False)
    assert not bool(hit)
    again, hit = TCM.access(new, 5, insert=False, enabled=True)
    assert bool(hit) and int(again["lru"].max()) == 2
