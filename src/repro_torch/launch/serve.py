"""Serving launcher of the port (decode with paged KV + NDPage tables).

Full width on the card, the default:
  python -m repro_torch.launch.serve [--arch internlm2-1.8b] \
      [--kv-mode auto|paged_flat|paged_radix] [--requests 8] [--profile]
serves ``--requests`` requests (prompts of 64-256 tokens, 32 new tokens
each) with random weights from ``--seed`` in the config's dtype (bf16).

Reduced run on the CPU (smoke config in float32, plain PyTorch path):
  python -m repro_torch.launch.serve --local-smoke --device cpu

Without ``--device cpu`` the launcher needs a card and raises otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import config as C
from repro_torch.models import init_params
from repro_torch.serving import Request, ServeEngine
from repro_torch.util.device import resolve_device
from repro_torch.util.profile import print_profile

#: engine and request shapes: (max_batch, max_len, page_size,
#: prompt length range, new tokens per request)
FULL = dict(max_batch=4, max_len=512, page_size=16, prompt=(64, 256),
            new_tokens=32)
SMOKE = dict(max_batch=4, max_len=96, page_size=8, prompt=(4, 9),
             new_tokens=8)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--kv-mode", default="auto",
                    choices=["auto", "paged_flat", "paged_radix"],
                    help="block table organization; auto picks it from "
                         "occupancy every step")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-smoke", action="store_true",
                    help="reduced config in float32 (use with --device cpu)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler and print the "
                         "time by operator (use few --requests)")
    return ap


def make_requests(n: int, vocab: int, prompt_range, new_tokens: int,
                  seed: int) -> List[Request]:
    rng = np.random.default_rng(seed)
    lo, hi = prompt_range
    return [Request.build(i, rng.integers(1, vocab, rng.integers(lo, hi + 1)),
                          max_new_tokens=new_tokens)
            for i in range(n)]


def serve(args: argparse.Namespace) -> Dict:
    """Build the model and engine, serve the requests, and return the
    engine, the finished requests and the wall-clock seconds of the run
    (model build excluded)."""
    device = resolve_device(args.device)
    cfg = C.get_arch(args.arch)
    shape = FULL
    if args.local_smoke:
        cfg = dataclasses.replace(C.smoke_variant(cfg), dtype="float32")
        shape = SMOKE
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    mode = None if args.kv_mode == "auto" else args.kv_mode
    eng = ServeEngine(cfg, params, max_batch=shape["max_batch"],
                      max_len=shape["max_len"],
                      page_size=shape["page_size"], table_mode=mode,
                      device=device)
    for req in make_requests(args.requests, cfg.vocab_size, shape["prompt"],
                             shape["new_tokens"], args.seed):
        eng.submit(req)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if args.profile else None
    t0 = time.perf_counter()
    with prof or contextlib.nullcontext():
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return {"cfg": cfg, "engine": eng, "done": done,
            "seconds": time.perf_counter() - t0, "profile": prof}


def main(argv: Optional[List[str]] = None) -> Dict:
    out = serve(build_parser().parse_args(argv))
    eng, done = out["engine"], out["done"]
    tokens = sum(len(r.generated) for r in done)
    steps = eng.sched.stats["steps"]
    print(f"served {len(done)} requests of {out['cfg'].name} on "
          f"{eng.device}; {tokens} tokens in {steps} steps, "
          f"{out['seconds']:.3f} s ({tokens / out['seconds']:.1f} tokens/s); "
          f"scheduler={eng.sched.stats}; "
          f"tcache={eng.sched.tcache.hit_rate:.2%}")
    if out["profile"] is not None:
        print_profile(out["profile"], out["seconds"])
    return out


if __name__ == "__main__":
    main()
