"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes).  :func:`build_all` starts one ``nvcc`` per
kernel, all at once.  The library lives in ``build/repro_torch/`` at
the root of the checkout and is named after a hash of the sources and
flags, so an edit rebuilds.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time (0.0 if found built), "ptxas": ptxas -v
#: report (kept beside the library), "path": library path}
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and any shared .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """Compile kernel ``name`` unless it is built already."""
    lib = _library_path(name)
    if name in build_log and build_log[name]["path"] == str(lib):
        return lib
    report = lib.with_suffix(".ptxas")
    if lib.exists():
        build_log[name] = {"seconds": 0.0, "path": str(lib), "ptxas":
                           report.read_text() if report.exists() else ""}
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    report.write_text(proc.stdout)
    os.replace(tmp, lib)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stdout, "path": str(lib)}
    return lib


def build_all(names: Iterable[str]) -> None:
    """Build every kernel in ``names``, one ``nvcc`` each, in parallel."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(_build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(_build(name)))
    return _libs[name]
