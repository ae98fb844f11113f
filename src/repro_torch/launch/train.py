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
The multi-host flags of the JAX launcher (``--coordinator``,
``--num-processes``, ``--process-id``, ``--multi-pod``,
``--compress-grads``) raise: they belong to the parallel slice.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch import config as C
from repro_torch.util.profile import print_profile
from repro_torch.train.data import SyntheticLM, add_modality_stubs
from repro_torch.train.fault_tolerance import FaultConfig, GuardedTrainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import init_train_state, make_train_step
from repro_torch.util.device import resolve_device

#: train_4k's global batch of 256 sequences, cut to one card's
GLOBAL_BATCH = 8
DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "train_ckpt")
_PARALLEL = "ROADMAP module queue item 10, parallel/launch/roofline"


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
    for flag in ("--coordinator", "--num-processes", "--process-id"):
        ap.add_argument(flag, default=None, help="not ported yet")
    for flag in ("--multi-pod", "--compress-grads"):
        ap.add_argument(flag, action="store_true", help="not ported yet")
    return ap


def train(args: argparse.Namespace) -> Dict:
    """Build the state, run ``--steps`` guarded steps and return the
    config, the state, each step's metrics and wall seconds (set-up
    excluded) and the trainer's fault stats."""
    multi = [f for f, v in (("--coordinator", args.coordinator),
                            ("--num-processes", args.num_processes),
                            ("--process-id", args.process_id),
                            ("--multi-pod", args.multi_pod),
                            ("--compress-grads", args.compress_grads)) if v]
    if multi:
        raise NotImplementedError(f"{', '.join(multi)}: multi-host training "
                                  f"is not ported yet ({_PARALLEL})")
    if args.profile and args.steps < 2:
        raise ValueError("--profile traces the steps after the first: "
                         "give --steps 2 or more")
    device = resolve_device(args.device)
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

    step_fn = make_train_step(cfg, AdamWConfig(total_steps=args.steps),
                              num_microbatches=micro)
    state = init_train_state(cfg, args.seed, device)
    data = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch)
    guard = GuardedTrainer(FaultConfig(ckpt_dir=args.ckpt_dir,
                                       ckpt_every=args.ckpt_every),
                           step_fn, state)
    guard.install_signal_handler()
    guard.maybe_restore()
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
                raw = add_modality_stubs(data.batch_at(guard.step), cfg,
                                         seed=guard.step)
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in raw.items()}
                t0 = time.perf_counter()
                metrics = guard.run_step(batch)
                if metrics is None:
                    break
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                metrics["seconds"] = time.perf_counter() - t0
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
            "profile": prof}


def main(argv: Optional[List[str]] = None) -> Dict:
    out = train(build_parser().parse_args(argv))
    hist, shape = out["history"], out["shape"]
    tokens = shape.global_batch * shape.seq_len
    secs = sum(m["seconds"] for m in hist)
    print(f"finished {len(hist)} steps of {out['cfg'].name} "
          f"({shape.global_batch} x {shape.seq_len} tokens in "
          f"{out['microbatches']} microbatches); "
          f"{tokens * len(hist) / max(secs, 1e-9):.1f} tokens/s; "
          f"stats={out['stats']}")
    if out["profile"] is not None:
        print_profile(out["profile"], secs - hist[0]["seconds"])
    return out


if __name__ == "__main__":
    main()
