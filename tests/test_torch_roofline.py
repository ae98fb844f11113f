"""The port's config helpers and roofline (``repro_torch.config``,
``repro_torch.roofline.analysis`` and ``report``) against the JAX
package's, on the CPU.  The roofline arithmetic is compared with the JAX
package's v5e ``Hardware`` passed to both, so the same numbers go in;
the port's own default is the H100's."""
import dataclasses
import json
import sys

import pytest

from repro import config as JC
from repro.roofline import analysis as JA
from repro.roofline import report as JR
from repro_torch import config as C
from repro_torch.roofline import analysis as A
from repro_torch.roofline import counts
from repro_torch.roofline import report as R

ARCHS = JC.list_archs()
#: the JAX package's hardware (TPU v5e-like), the reference both get
V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


def test_arch_lists_match():
    assert C.list_archs() == ARCHS
    assert C.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers_match(arch):
    cfg, jcfg = C.get_arch(arch), JC.get_arch(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    assert C.cells_for(cfg) == JC.cells_for(jcfg)
    assert cfg.attn_free == jcfg.attn_free
    smoke, jsmoke = C.smoke_variant(cfg), JC.smoke_variant(jcfg)
    assert smoke.active_param_count() == jsmoke.active_param_count()
    for shape in JC.SHAPES:
        assert A.model_flops(cfg, C.SHAPES[shape]) == JA.model_flops(
            jcfg, JC.SHAPES[shape])


def test_hardware_is_the_h100():
    assert dataclasses.asdict(A.HW) == dict(
        peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
    assert counts.HBM_BYTES_PER_S == A.HW.hbm_bw
    assert [f.name for f in dataclasses.fields(A.Hardware)] == [
        f.name for f in dataclasses.fields(JA.Hardware)]


def _results():
    """Dry-run records in the JAX dry-run's format, at both meshes, some
    collective-bound, some memory-bound, one with no flops."""
    out = {}
    for i, arch in enumerate(ARCHS):
        for j, shape in enumerate(JC.cells_for(JC.get_arch(arch))):
            for mesh in ("16x16", "2x16x16"):
                k = i * 7 + j * 3 + (mesh == "16x16")
                out[f"{arch}|{shape}|{mesh}|paged_flat"] = {
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "flops": 0.0 if k == 5 else 3.7e11 * (k + 1) ** 2,
                    "bytes_accessed": 1.9e9 * (k % 5 + 1) ** 3,
                    "collective_bytes": 2.3e9 * (k % 3) * (k % 4)}
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_roofline_terms_match(mesh):
    hw, jhw = A.Hardware(**V5E), JA.Hardware(**V5E)
    cells = [c for c in _results().values() if c["mesh"] == mesh]
    for cell in cells:
        assert A.roofline_terms(cell, hw=hw) == JA.roofline_terms(
            cell, hw=jhw)
        got = A.roofline_terms(cell, C.get_arch(cell["arch"]),
                               C.SHAPES[cell["shape"]], hw)
        want = JA.roofline_terms(cell, JC.get_arch(cell["arch"]),
                                 JC.SHAPES[cell["shape"]], jhw)
        assert got == want
    assert {A.roofline_terms(c, hw=hw)["dominant"] for c in cells} == {
        "compute", "memory", "collective"}
    for x in (3.2, 0.04, 2e-5):
        assert R.fmt_s(x) == JR.fmt_s(x)


@pytest.mark.parametrize("extra", [[], ["--markdown"],
                                   ["--mesh", "2x16x16"]])
def test_report_prints_the_jax_table(extra, tmp_path, capsys, monkeypatch):
    path = tmp_path / "dryrun_results.json"
    path.write_text(json.dumps(_results()))
    argv = [str(path), *extra]
    # the JAX report reads the module-level HW; give it v5e (its default)
    monkeypatch.setattr(sys, "argv", ["report", *argv])
    JR.main()
    want = capsys.readouterr().out
    R.main(argv, hw=A.Hardware(**V5E))
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) > 10
    rows = R.build_rows(_results(), extra[-1] if "--mesh" in extra
                        else "16x16")
    assert [r[:2] for r in rows] == [r[:2] for r in JR.build_rows(
        _results(), extra[-1] if "--mesh" in extra else "16x16")]
