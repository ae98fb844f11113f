"""Training launcher of the port (one card).

Full width on the card, the default:
  python -m repro_torch.launch.train [--arch internlm2-1.8b] [--steps 3] \
      [--profile]
trains the published config (bf16, random weights from ``--seed``) on
``--shape`` train_4k's 4,096-token sequences with the global batch cut
from 256 to :data:`GLOBAL_BATCH` (8 sequences, 32,768 tokens a step) in
``--microbatches`` 4: one card holds the bf16 weights, float32
gradients and AdamW moments and one 2-sequence microbatch's activations
and float32 logits.  Every attention layer runs the CUDA flash
attention kernels, forward and backward (gemma3-1b's head_dim 256, 22
of its 26 layers with a 512-key window, on the d256 route:
``--arch gemma3-1b``; granite-moe-1b-a400m's routed experts with the
MoE aux loss in the loss: ``--arch granite-moe-1b-a400m``).  A vlm
config (internvl2) gets the stub frontend's vision embeddings,
prepended to the tokens, and an encoder-decoder (whisper-tiny) its
1,500 stub audio frames a sequence, which its encoder reads in float32
through the bf16 weights, as the JAX launcher does (``--arch
whisper-tiny``: the decoder's self-attention on the sm90 kernels at 6 /
6 heads of 64, the encoder and the cross-attention on the masked
softmax).  ``--profile``
traces every step after the first (warm-up) with torch.profiler and
prints the time by operator and the card's busy share.

Reduced run on the CPU (smoke config in float32 at 64 tokens, plain
PyTorch path), as the JAX launcher's ``--local-smoke``:
  python -m repro_torch.launch.train --local-smoke --device cpu \
      [--arch granite-moe-1b-a400m | deepseek-v2-236b | jamba-1.5-large-398b
       | rwkv6-3b | whisper-tiny]
A Mamba layer's time recurrence runs the hand-written selective-scan
kernels on the card (``kernels/selective_scan.py``), an RWKV layer's the
WKV kernels (``kernels/wkv.py``; rwkv6-3b trains at full width and
depth: ``--arch rwkv6-3b``), the plain step loops on the CPU.

Without ``--device cpu`` the launcher needs a card and raises otherwise.

Data-parallel training, one process a rank, as the JAX launcher runs
one a host:
  python -m repro_torch.launch.train --num-processes N --process-id I \
      --coordinator HOST:PORT [--multi-pod] [--compress-grads] \
      [--local-smoke --device cpu]
joins a process group (``launch.mesh.init_distributed``: NCCL with a
card a rank, gloo on the CPU or where ranks share a card) and trains on
a ``(N, 1)`` ``("data", "model")`` mesh (``--multi-pod``: ``(2, N / 2,
1)`` ``("pod", "data", "model")``).  Each rank reads its own rows of
the global batch (``batch_at(step, rank=I, world=N)``) in
``--microbatches`` of its own; the gradients are averaged over the
ranks (``--compress-grads``: by the int8 all-reduce of
``parallel.compression``), and with ``cfg.fsdp`` (every full config)
the parameters and AdamW moments are stored sharded over ``data``
(``train_loop.shard_train_state``).  Rank 0 writes the checkpoints, each
the whole logical state, so a restart at another world size resumes.
``--layers`` cuts the config to its first layers.  Each rank reads the
rows of its coordinate on the mesh's batch axes, so the ranks of one
``model`` group read the same rows.  The launcher's ``model`` axis is 1:
tensor parallelism (``train_loop.make_train_step`` on a mesh with a
``model`` axis above 1, ``parallel.tensor``) gets a launcher flag with
ROADMAP item 10c.  With several
ranks the last line a rank prints is a JSON summary of its run (s/step,
tokens/s of the whole mesh, peak memory, collective bytes a step, flash
launches).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch import config as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import mesh as LM
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.context import axis_rank, axis_size
from repro_torch.util.profile import print_profile
from repro_torch.train.data import SyntheticLM, add_modality_stubs
from repro_torch.train.fault_tolerance import FaultConfig, GuardedTrainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import (init_train_state, logical_state,
                                          make_train_step, shard_train_state)
from repro_torch.util.device import resolve_device

#: train_4k's global batch of 256 sequences, cut to one card's
GLOBAL_BATCH = 8
DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "train_ckpt")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--local-smoke", action="store_true",
                    help="reduced config in float32 (use with --device cpu)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the steps after the first with "
                         "torch.profiler and print the time by operator")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers (0: all)")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT where the ranks meet (or a file:// "
                         "URL on a shared file system)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true",
                    help="a (2, N / 2, 1) (pod, data, model) mesh")
    ap.add_argument("--compress-grads", action="store_true",
                    help="average the gradients by the int8 all-reduce")
    return ap


def _mesh(args, device: torch.device):
    """The data-parallel mesh of the ranks."""
    n = args.num_processes
    if args.multi_pod:
        if n % 2:
            raise ValueError(f"--multi-pod needs an even --num-processes, "
                             f"got {n}")
        return LM.make_mesh((2, n // 2, 1), ("pod", "data", "model"),
                            device)
    return LM.make_mesh((n, 1), ("data", "model"), device)


def train(args: argparse.Namespace) -> Dict:
    """Build the state, run ``--steps`` guarded steps and return the
    config, the state, each step's metrics and wall seconds (set-up
    excluded) and the trainer's fault stats."""
    if args.profile and args.steps < 2:
        raise ValueError("--profile traces the steps after the first: "
                         "give --steps 2 or more")
    device = resolve_device(args.device)
    world, rank = args.num_processes, args.process_id
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"--process-id {rank} of --num-processes {world}")
    if world > 1 or args.coordinator:
        LM.init_distributed(args.coordinator, world, rank, device=device)
        device = LM.rank_device(device, rank)
        mesh = _mesh(args, device)
    elif args.compress_grads or args.multi_pod:
        raise ValueError("--compress-grads and --multi-pod need ranks: "
                         "give --num-processes and --coordinator")
    else:
        mesh = None
    if args.local_smoke:
        cfg = dataclasses.replace(C.smoke_variant(C.get_arch(args.arch)),
                                  dtype="float32")
        shape = dataclasses.replace(C.SHAPES[args.shape], global_batch=8,
                                    seq_len=64)
        micro = min(args.microbatches, 2)
    else:
        cfg = C.get_arch(args.arch)
        shape = dataclasses.replace(C.SHAPES[args.shape],
                                    global_batch=GLOBAL_BATCH)
        micro = args.microbatches
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    compress = None
    if args.compress_grads:
        from repro_torch.parallel.compression import make_dp_int8_allreduce
        compress = make_dp_int8_allreduce(mesh, ("pod", "data")
                                          if args.multi_pod else "data")
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=args.steps),
                              num_microbatches=micro, mesh=mesh,
                              compress=compress)
    state = init_train_state(cfg, args.seed, device)
    data = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    multi = mesh is not None
    # the rows of this rank's batch-axes coordinate (a model group's
    # ranks share them)
    axes = SH.batch_axes(mesh) if multi else ()
    row, rows = ((axis_rank(mesh, axes), axis_size(mesh, axes)) if axes
                 else (0, 1))
    guard = GuardedTrainer(
        FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    writer=rank == 0), step_fn, state,
        gather=(lambda st: logical_state(st, mesh)) if multi else None,
        barrier=(lambda: comm.barrier(device=device)) if multi else None)
    guard.install_signal_handler()
    guard.maybe_restore()           # the whole state, before sharding
    if multi:
        guard.state = shard_train_state(guard.state, mesh, cfg)
    history: List[Dict] = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=args.steps - 1, repeat=1)
    ) if args.profile else None
    try:
        with prof or contextlib.nullcontext():
            while guard.step < args.steps:
                raw = add_modality_stubs(
                    data.batch_at(guard.step, rank=row, world=rows), cfg,
                    seed=guard.step)
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in raw.items()}
                comm.reset_stats()
                t0 = time.perf_counter()
                metrics = guard.run_step(batch)
                if metrics is None:
                    break
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                metrics["seconds"] = time.perf_counter() - t0
                metrics["comm_bytes"] = comm.stats["bytes"]
                history.append(metrics)
                if prof is not None:
                    prof.step()
                print(f"step {guard.step}: loss={metrics['loss']:.4f} "
                      f"grad_norm={metrics['grad_norm']:.4f} "
                      f"lr={metrics['lr']:.3e} {metrics['seconds']:.3f} s",
                      flush=True)
    finally:
        guard.remove_signal_handler()
    return {"cfg": cfg, "shape": shape, "microbatches": micro,
            "state": guard.state, "history": history, "stats": guard.stats,
            "profile": prof, "mesh": mesh, "rank": rank, "world": world,
            "device": device}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    FA.launches_fwd = FA.launches_bwd = 0
    FA.launches_sm90_fwd = FA.launches_sm90_bwd = 0
    try:
        out = train(args)
        hist, shape = out["history"], out["shape"]
        tokens = shape.global_batch * shape.seq_len
        secs = sum(m["seconds"] for m in hist)
        world = out["world"]
        print(f"finished {len(hist)} steps of {out['cfg'].name} "
              f"({shape.global_batch} x {shape.seq_len} tokens"
              + (f", {shape.global_batch // world} a rank on {world} ranks"
                 if world > 1 else "")
              + f" in {out['microbatches']} microbatches"
              + (" a rank" if world > 1 else "") + "); "
              f"{tokens * len(hist) / max(secs, 1e-9):.1f} tokens/s; "
              f"stats={out['stats']}")
        if out["profile"] is not None:
            print_profile(out["profile"], secs - hist[0]["seconds"])
        if out["mesh"] is not None:
            print(json.dumps(_rank_summary(out, tokens)), flush=True)
        return out
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _rank_summary(out: Dict, tokens: int) -> Dict:
    """A rank's run as one JSON object: the mesh, its steps' seconds,
    the tokens/s of the whole mesh after the first step, its peak
    memory, the bytes it handed to collectives a step, its flash
    launches."""
    hist, dev = out["history"], out["device"]
    secs = [m["seconds"] for m in hist]
    later = secs[1:] or secs
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)     # since the process began
    return {"rank": out["rank"], "world": out["world"],
            "mesh": dict(zip(out["mesh"].mesh_dim_names,
                             out["mesh"].shape)),
            "backend": torch.distributed.get_backend(),
            "device": str(dev), "steps": len(hist), "seconds": secs,
            "losses": [m["loss"] for m in hist],
            "grad_norms": [m["grad_norm"] for m in hist],
            "tokens_per_s": tokens / (sum(later) / len(later)),
            "peak_gib": peak,
            "comm_bytes_per_step": [m["comm_bytes"] for m in hist],
            "flash_launches": [FA.launches_fwd, FA.launches_bwd],
            "sm90_launches": [FA.launches_sm90_fwd, FA.launches_sm90_bwd]}


if __name__ == "__main__":
    main()
