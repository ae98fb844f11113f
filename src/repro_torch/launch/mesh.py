"""Meshes and process groups (the port of ``repro.launch.mesh``, with the
counterpart of ``jax.distributed.initialize``).

:func:`init_distributed` joins this process to a process group: NCCL
when each rank has a card of its own, gloo on the CPU and wherever ranks
share a card (NCCL refuses two ranks on one device); the caller may name
the backend.  The mesh builders are functions, so importing this module
touches no process group.  :func:`spawn` starts ``world`` ranks in
``spawn``ed processes on one host (CUDA cannot be re-initialised in a
forked child), each joined to one group through a file under a fresh
temporary directory (no fixed port, so concurrent runs never collide),
runs a function on each and returns the ranks' results in rank order.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.util.device import DeviceLike


def default_backend(device: DeviceLike, world: int) -> str:
    """NCCL when the ranks run on cards and each has one of its own,
    else gloo."""
    dev = torch.device(device)
    return ("nccl" if dev.type == "cuda"
            and torch.cuda.device_count() >= world else "gloo")


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of ``rank``: its own card where there are enough
    (``cuda:rank``), else the cards in turn (ranks may share one)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0, *,
                     device: DeviceLike = "cuda",
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     threads: Optional[int] = None) -> str:
    """Join the default process group as rank ``process_id`` of
    ``num_processes``, rendezvousing at ``coordinator`` (``host:port``,
    or a ``file://`` / ``tcp://`` URL) or ``init_method``.  Returns the
    backend.  On a card, the rank's device becomes the current one; on
    the CPU the rank takes ``threads`` intra-op threads (default: its
    share of the host's cores; ranks whose thread pools overlap spin
    against each other, which slows a small step tenfold)."""
    backend = backend or default_backend(device, num_processes)
    if init_method is None:
        if not coordinator:
            raise ValueError("give coordinator (host:port) or init_method")
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads or max(
            1, (os.cpu_count() or 1) // num_processes))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return backend


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = "cuda") -> DeviceMesh:
    """A mesh of the ranks of the default group, rank-major."""
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(devices: int = 8, device: DeviceLike = "cpu"
                   ) -> DeviceMesh:
    """A small (devices // 2, 2) ("data", "model") mesh for tests."""
    return make_mesh((devices // 2, 2), ("data", "model"), device)


def _rank_main(fn: Callable, rank: int, world: int, init_method: str,
               device: str, backend: Optional[str], args: Tuple, results,
               collected) -> None:
    try:
        init_distributed(num_processes=world, process_id=rank,
                         device=device, backend=backend,
                         init_method=init_method, threads=1)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    # a tensor in the result travels as a handle to this process's
    # memory: stay until the parent has taken it
    collected.wait(timeout=600)


def spawn(fn: Callable, world: int, *args, device: DeviceLike = "cpu",
          backend: Optional[str] = None, timeout: float = 600.0
          ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each a spawned
    process joined to one process group (:func:`init_distributed` with
    ``device`` and ``backend``), and return their results in rank order.
    ``fn`` and ``args`` are pickled (``fn`` by its import path), and so
    is each result.  A CPU rank takes one intra-op thread.  A rank that raises stops the others, and this
    raises with its traceback; so does a rank that dies without a
    report, at once, and a rank silent for ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results, collected = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_method, str(device),
                               backend, args, results, collected))
             for r in range(world)]
    out: List[Any] = [None] * world
    done = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        reported = set()
        while len(reported) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before "
                                       "reporting")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"no rank reported within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            reported.add(rank)
        done = True
    finally:
        collected.set()
        for p in procs:
            p.join(timeout=30 if done else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    return out
