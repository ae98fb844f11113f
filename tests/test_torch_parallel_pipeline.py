"""``repro_torch.parallel.pipeline`` on 4 gloo ranks on the CPU, at the
shapes of ``tests/test_pipeline.py`` (4 stages, 6 microbatches of 2 x 8
tokens, d 16, stage ``tanh(x @ w_s)``): every rank's output equals the
sequential stack and the JAX ``pipeline_run`` (run in a subprocess on 4
host devices) on the same numpy inputs within 1e-5; ``bubble_fraction``
equals the JAX one.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.parallel.pipeline import bubble_fraction as jbubble
from repro_torch.launch import mesh as LM
from repro_torch.parallel import comm
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, M, MB, SEQ, D = 4, 6, 2, 8, 16
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, SEQ, D)).astype(np.float32)
    return w, x


def _stage(w_s, x):
    return torch.tanh(x @ w_s)


def _rank_pipeline(rank, world):
    w, x = _inputs()
    mesh = LM.make_mesh((world,), ("stage",), "cpu")
    comm.reset_stats()
    by_mesh = pipeline_run(mesh, "stage", _stage, torch.from_numpy(w),
                           torch.from_numpy(x))
    by_group = pipeline_run(dist.group.WORLD, "stage",
                            lambda p, x: _stage(p["w"], x),
                            {"w": torch.from_numpy(w)},
                            torch.from_numpy(x))
    return by_mesh.numpy(), by_group.numpy(), dict(comm.stats)


@pytest.fixture(scope="module")
def ranks():
    return LM.spawn(_rank_pipeline, S)


JAX_PIPE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import pipeline_run
    data = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("stage",))
    got = pipeline_run(mesh, "stage", lambda w_s, x: jnp.tanh(x @ w_s),
                       jnp.asarray(data["w"]), jnp.asarray(data["x"]))
    np.save(sys.argv[2], np.asarray(got))
""")


def _sequential():
    w, x = _inputs()
    out = torch.from_numpy(x)
    for s in range(S):
        out = _stage(torch.from_numpy(w[s]), out)
    return out.numpy()


def test_pipeline_matches_sequential(ranks):
    want = _sequential()
    for by_mesh, by_group, _ in ranks:
        assert by_mesh.shape == (M, MB, SEQ, D)
        np.testing.assert_allclose(by_mesh, want, atol=TOL, rtol=0)
        np.testing.assert_array_equal(by_group, by_mesh)


def test_pipeline_matches_jax(ranks, tmp_path):
    w, x = _inputs()
    np.savez(tmp_path / "in.npz", w=w, x=x)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_PIPE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                              JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(tmp_path / "out.npy")
    for by_mesh, _, _ in ranks:
        np.testing.assert_allclose(by_mesh, want, atol=TOL, rtol=0)


def test_pipeline_moves_one_activation_a_stage_and_microbatch(ranks):
    """Point-to-point traffic: stage s receives M activations (s > 0) and
    sends M (s < S - 1); then the broadcast of the outputs (two runs)."""
    act = MB * SEQ * D * 4
    for s, (_, _, stats) in enumerate(ranks):
        p2p = (s > 0) * M + (s < S - 1) * M
        assert stats["bytes"] == 2 * (p2p * act + M * act)
        assert stats["calls"] == 2 * (p2p + 1)


@pytest.mark.parametrize("n_stages, n_micro", [(4, 12), (1, 8), (4, 6),
                                               (8, 1)])
def test_bubble_fraction(n_stages, n_micro):
    assert bubble_fraction(n_stages, n_micro) == jbubble(n_stages, n_micro)
    assert bubble_fraction(4, 12) == 3 / 15
