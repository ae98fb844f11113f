"""The port imports torch, never JAX and nothing of the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)

GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("repro", "jax", "jaxlib")
                and sys.modules[m] is not None)
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import_in_source(path):
    assert not FORBIDDEN.findall(path.read_text())


PARALLEL_MODULES = ["repro_torch.parallel", "repro_torch.parallel.sharding",
                    "repro_torch.parallel.context",
                    "repro_torch.parallel.comm",
                    "repro_torch.parallel.compression",
                    "repro_torch.parallel.pipeline",
                    "repro_torch.parallel.tensor",
                    "repro_torch.launch.mesh"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_import_neither_jax_nor_the_reference(module):
    """``repro_torch.parallel`` and ``launch/mesh.py`` import alone with
    JAX blocked, and leave no module of JAX or of ``repro`` loaded."""
    code = (f"import sys; sys.modules['jax'] = None\n"
            f"import importlib; importlib.import_module({module!r})\n"
            "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib') and sys.modules[m] is not None)\n"
            "assert not leaked, leaked\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path = ROOT / "src" / (module.replace(".", "/") + (
        "/__init__.py" if module.endswith("parallel") else ".py"))
    assert not FORBIDDEN.findall(path.read_text())
