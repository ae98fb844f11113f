"""Serving launcher of the port (decode with paged KV + NDPage tables).

Full width on the card, the default:
  python -m repro_torch.launch.serve [--arch internlm2-1.8b] \
      [--kv-mode auto|paged_flat|paged_radix|dense] [--requests 8] \
      [--profile]
serves ``--requests`` requests (prompts of 64-256 tokens, 32 new tokens
each) with random weights from ``--seed`` in the config's dtype (bf16).
A config with sliding-window layers gets prompts that cross its window
(:func:`full_shape`: gemma3-1b's window of 512 with prompts of 520-640
tokens, max_len 768), so its local layers attend differently from its
global ones:
  python -m repro_torch.launch.serve --arch gemma3-1b --requests 4
The mixture-of-experts configs serve the same way: granite-moe-1b-a400m
at full width (every expert's weights read in every step, the JAX
package's dense dispatch), deepseek-v2-236b through its MLA latent cache
(no KV pool; 236 B parameters do not fit one card at full depth, so at
full width only with its depth cut, as ``chip_smoke.py`` phase 12d
does):
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
jamba-1.5-large-398b's Mamba layers decode with the single-step update
and its attention layers through the paged kernel; at 398 B parameters
it too runs on one card only with its depth cut (``chip_smoke.py`` phase
13c serves the period's first 4 layers).  rwkv6-3b serves at full width
and depth; its layers keep a recurrent state and no KV cache, so no step
makes a paged-attention call:
  python -m repro_torch.launch.serve --arch rwkv6-3b
whisper-tiny (the encoder-decoder) serves at full width and depth: its
decoder's self-attention decodes through the paged kernel at 6 / 6
heads of 64, and its cross-attention reads the decode state's zero
encoder output, as the JAX engine serves it (neither engine has an
audio path; ``models.prefill(audio_frames=)`` encodes frames):
  python -m repro_torch.launch.serve --arch whisper-tiny

Reduced run on the CPU (smoke config in float32, plain PyTorch path):
  python -m repro_torch.launch.serve --local-smoke --device cpu \
      [--arch granite-moe-1b-a400m | deepseek-v2-236b | jamba-1.5-large-398b
       | rwkv6-3b | whisper-tiny]

Translation-costed serving: ``--cost-model pinned`` prices every step
with the committed cost table, ``--cost-model sweep`` derives the table
through the simulator on the launcher's device (memoized in the port's
trace cache; ``SIM_TRACE_CACHE=0`` turns the cache off, so the table is
derived afresh).  The run then prints the SIMULATED machine's tokens/s
per mechanism beside the card's wall tokens/s:
  python -m repro_torch.launch.serve --local-smoke --device cpu \
      --cost-model pinned

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
from repro_torch.sim.cost_model import TranslationCostModel
from repro_torch.util.device import resolve_device
from repro_torch.util.profile import print_profile

#: engine and request shapes: (max_batch, max_len, page_size,
#: prompt length range, new tokens per request)
FULL = dict(max_batch=4, max_len=512, page_size=16, prompt=(64, 256),
            new_tokens=32)
SMOKE = dict(max_batch=4, max_len=96, page_size=8, prompt=(4, 9),
             new_tokens=8)


def full_shape(cfg) -> Dict:
    """:data:`FULL`, or for a config with a sliding window prompts of 8
    to 128 tokens past the window and max_len 256 past it (768 for
    gemma3-1b's 512: 48 pages, a whole number of the radix table's
    16-entry leaves)."""
    if not cfg.window_size:
        return FULL
    w = cfg.window_size
    return dict(FULL, max_len=w + 256, prompt=(w + 8, w + 128))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--kv-mode", default="auto",
                    choices=["auto", "paged_flat", "paged_radix", "dense"],
                    help="block table organization; auto picks it from "
                         "occupancy every step, and dense is served as "
                         "auto (the engine's KV is always paged), as the "
                         "JAX launcher does")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-smoke", action="store_true",
                    help="reduced config in float32 (use with --device cpu)")
    ap.add_argument("--cost-model", choices=["pinned", "sweep"],
                    help="price every step's translations under the "
                         "paper's mechanisms: the committed table, or one "
                         "derived through the simulator on --device")
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
    """Build the model and engine (and the cost table with
    ``--cost-model``), serve the requests, and return the engine, the
    finished requests, the cost model and the wall-clock seconds of the
    run (model build and cost derivation excluded) and of the cost
    derivation."""
    device = resolve_device(args.device)
    cost_model, cost_seconds = None, 0.0
    if args.cost_model:
        t0 = time.perf_counter()
        cost_model = TranslationCostModel.for_machine(
            source=args.cost_model, device=device)
        cost_seconds = time.perf_counter() - t0
    cfg = C.get_arch(args.arch)
    shape = full_shape(cfg)
    if args.local_smoke:
        cfg = dataclasses.replace(C.smoke_variant(cfg), dtype="float32")
        shape = SMOKE
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    mode = None if args.kv_mode in ("auto", "dense") else args.kv_mode
    eng = ServeEngine(cfg, params, max_batch=shape["max_batch"],
                      max_len=shape["max_len"],
                      page_size=shape["page_size"], table_mode=mode,
                      cost_model=cost_model, device=device)
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
            "seconds": time.perf_counter() - t0, "profile": prof,
            "cost_model": cost_model, "cost_seconds": cost_seconds}


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
    model = out["cost_model"]
    if model is not None:
        rep = eng.throughput()
        print(f"cost model: {model.source} table of {model.machine} "
              f"({out['cost_seconds']:.3f} s); simulated machine at "
              f"{model.freq_ghz} GHz, {model.model_cycles_per_token:g} "
              f"model cycles/token; {rep['tokens']} priced tokens in "
              f"{rep['steps']} steps, tcache hits {rep['tcache_hits']}, "
              f"misses {rep['tcache_misses']}")
        for m in model.mechs:
            print(f"  {m:>9}: simulated {rep['tokens_per_sec'][m]:.1f} "
                  f"tokens/s, {rep['translation_cycles'][m]:.1f} "
                  f"translation cycles")
        print(f"  wall clock on {eng.device}: "
              f"{tokens / out['seconds']:.1f} tokens/s")
    if out["profile"] is not None:
        print_profile(out["profile"], out["seconds"])
    return out


if __name__ == "__main__":
    main()
