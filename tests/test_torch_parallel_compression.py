"""``repro_torch.parallel.compression`` against
``repro.parallel.compression``: ``quantize_int8``, ``dequantize_int8``
and ``ef_quantize`` leaf by leaf (int8 codes equal exactly; the
dequantized values and errors too, the same float32 operations), and
the int8 all-reduce on 2 and 4 gloo ranks on the CPU (spawned once per
world size for the module).  With the same gradient on every rank it
equals the JAX ``make_dp_int8_allreduce`` run in a subprocess on as many
host devices (as ``tests/test_pipeline.py`` runs the JAX pipeline);
with a different gradient on each rank it equals a numpy version of
the formula (each rank's scale, the largest scale, codes requantized
against it, their int32 sum times the largest scale over the ranks),
exactly.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as JCMP
from repro_torch.launch import mesh as LM
from repro_torch.parallel import compression as CMP

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"vec": (1000,), "mat": (64, 48), "tiny": (3,), "zero": (8,)}


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2)
               ).astype(np.float32) for k, s in SHAPES.items()}
    out["zero"][:] = 0.0
    return out


def _rank_allreduce(rank, world):
    """On each rank: the int8 all-reduce of the shared gradients and of
    the rank's own, over a (world,) data mesh and over its group."""
    mesh = LM.make_mesh((world,), ("data",), "cpu")
    reduce = CMP.make_dp_int8_allreduce(mesh)
    same = reduce({k: torch.from_numpy(v) for k, v in _grads(0).items()})
    own = reduce({k: torch.from_numpy(v)
                  for k, v in _grads(100 + rank).items()})
    return ({k: v.numpy() for k, v in same.items()},
            {k: v.numpy() for k, v in own.items()})


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    return request.param, LM.spawn(_rank_allreduce, request.param)


JAX_ALLREDUCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.compression import make_dp_int8_allreduce
    data = np.load(sys.argv[1])
    mesh = jax.make_mesh((%d,), ("data",))
    out = make_dp_int8_allreduce(mesh)({k: jnp.asarray(data[k])
                                        for k in data.files})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _jax_allreduce(world, grads, tmp_path):
    src, dst = tmp_path / f"g{world}.npz", tmp_path / f"out{world}.npz"
    np.savez(src, **grads)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ALLREDUCE % (world, world), str(src),
         str(dst)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def _formula(per_rank):
    """The all-reduce in numpy float32, for each leaf."""
    out = {}
    for k in per_rank[0]:
        xs = [g[k].astype(np.float32) for g in per_rank]
        scales = [np.float32(np.max(np.abs(x)) / np.float32(127.0))
                  + np.float32(1e-12) for x in xs]
        s_max = np.float32(max(scales))
        total = sum(np.clip(np.round(x / s_max), -127, 127).astype(np.int8)
                    .astype(np.int32) for x in xs)
        out[k] = (total.astype(np.float32) * s_max
                  / np.float32(len(xs))).astype(np.float32)
    return out


def test_equal_gradients_match_the_jax_allreduce(ranks, tmp_path):
    world, results = ranks
    want = _jax_allreduce(world, _grads(0), tmp_path)
    for same, _ in results:
        for k in SHAPES:
            assert same[k].dtype == np.float32
            np.testing.assert_array_equal(same[k], want[k], err_msg=k)


def test_unequal_gradients_match_the_formula(ranks):
    world, results = ranks
    want = _formula([_grads(100 + r) for r in range(world)])
    for _, own in results:
        for k in SHAPES:
            np.testing.assert_array_equal(own[k], want[k], err_msg=k)
    # the mean is close to the float32 mean, within one code a rank
    g = [_grads(100 + r)["vec"] for r in range(world)]
    step = max(np.abs(x).max() for x in g) / 127
    assert np.abs(results[0][1]["vec"] - np.mean(g, axis=0)).max() <= step


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quantize_int8_matches_jax(name):
    x = _grads(7)[name]
    q, s = CMP.quantize_int8(torch.from_numpy(x))
    jq, js = JCMP.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(CMP.dequantize_int8(q, s).numpy(),
                                  np.asarray(JCMP.dequantize_int8(jq, js)))


def test_ef_quantize_matches_jax_over_steps():
    """Three steps of error feedback: the dequantized gradients and the
    carried errors equal the JAX ones, and the error stays under one
    quantization step."""
    err = CMP.zeros_error_like({k: torch.from_numpy(v)
                                for k, v in _grads(0).items()})
    jerr = JCMP.zeros_error_like({k: jnp.asarray(v)
                                  for k, v in _grads(0).items()})
    for step in range(3):
        g = _grads(10 + step)
        dq, err = CMP.ef_quantize({k: torch.from_numpy(v)
                                   for k, v in g.items()}, err)
        jdq, jerr = JCMP.ef_quantize({k: jnp.asarray(v)
                                      for k, v in g.items()}, jerr)
        for k in SHAPES:
            np.testing.assert_array_equal(dq[k].numpy(), np.asarray(jdq[k]))
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]))
            assert err[k].dtype == torch.float32
            bound = float(torch.abs(torch.from_numpy(g[k])).max()) / 127 * 2
            assert float(err[k].abs().max()) <= bound + 1e-12
