#!/usr/bin/env python3
"""Check that the PyTorch/CUDA port (src/repro_torch) runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel (serving, training and simulator
     paths), one nvcc per kernel, all started together, with its time;
  3. the paged-attention kernel (split-K over pages, then a combine
     pass) against its plain PyTorch version on the card, at the serving
     path's shapes, with its time, the plain version's, a PyTorch library
     yardstick's and the least time the card could take; the split plan
     (pages a split, splits, blocks, shared memory) at the serve,
     costed-mix (page 8) and B 8 shapes, and every split size held and
     timed there; the same at the dense attention variants' decode
     shapes (gemma3-1b: D 256, 4 / 1 heads, window 512, lengths on both
     sides of it, pages 16 and 64, where shared memory bounds the split
     size; granite-34b: 48 query heads on one KV head; granite-moe: D 64,
     16 / 8; jamba-1.5-large: 64 / 8 heads of 128 at phase 13c's engine
     shape; whisper-tiny: 6 / 6 heads of 64, G 1, at phase 15b's serve
     shape), float32 and bf16, at every split size the card's shared
     memory allows;
  4. full-width internlm2-1.8b (bf16, random weights from a seed) served
     through the port's launcher: 8 requests, 32 new tokens each, every
     attention layer of every step through the paged-attention kernel;
  5. engine parity in float32 at full width and 2 layers: ServeEngine's
     token streams equal greedy_reference's in every table mode, and the
     card's logits agree with the CPU's plain path;
  6. the design of the float32 kernels (forward and backward, 3xTF32
     tensor-core products) and the ptxas report of each (a forward at any
     head_dim, or any kernel at NT 24 or 32, that spills, or that ptxas
     did not report, fails), and each instantiation's resident blocks,
     registers and shared memory; the ptxas lines of every d256 / d192
     kernel (TMA and wgmma, both head dims, and the reduction of the
     split dK/dV partials: one that spills, or that ptxas did not
     report, fails); the
     flash-attention kernels of both routes (bf16: the sm90 wgmma
     kernels; float32: the simt 3xTF32 mma.sync kernels), forward and
     backward, against their plain versions (and the backward against
     autograd of the plain forward) at the training shape and at window,
     non-causal, MQA and ragged cases, and in float32 at head_dim 36 from
     unaligned rows (head_dim padding and 4-byte copies); in float32
     above head_dim 128 (the simt kernels' NT 32 and NT 24
     instantiations) at gemma3-1b's global and local layers (B 2, S
     4,096, 4 / 1 heads of 256, window 512 and none) and its global
     layer at 8c's B 1 (the forward on 64-row blocks), deepseek-v2's
     layer (B 1, S 4,096, 128 / 128 heads of 192), a non-causal S 777 at
     192, a GQA windowed ragged case at 256 (8 / 2 heads, S 1,000, window
     100), head_dim 200 from unaligned rows and G = 3 at 192 (6 / 2
     heads, S 1,000) with the dK/dV work split 4 ways (chunks crossing
     heads), each forward and backward run twice and held bit-identical;
     in bf16 at
     head_dim 256 (the d256 kernels) at gemma3-1b's training shape (B 2,
     S 4,096, 4 / 1 heads, causal, window 512 and none), a ragged
     windowed case (8 / 2 heads: a 3-way dK/dV split over G = 4 heads),
     MQA (8 / 1 heads), G = 3 (6 / 2 heads, ragged, window 100) and a
     non-causal case; in bf16 at head_dim 192 (the d192 instantiation of
     the same template) at deepseek-v2's sequence length (S 4,096, 16 /
     16 heads, causal), a non-causal S 777 and a GQA windowed case; the
     sm90 kernels at whisper-tiny's training call (B 2, S 4,096, 6 / 6
     heads of 64), held, timed and run twice as a route is; each
     route timed at its own path's shape with the same four times, the
     backend SDPA picked and the achieved TFLOP/s (the float32 NT 32 and
     NT 24 kernels at 8c's calls: gemma3-1b's global layer, also with
     the window, at 8c's B 1 and at B 2, and deepseek-v2's layer; d256
     also with the window; d192
     at
     deepseek-v2's B 1, S 4,096, 128 / 128 heads of 192; the d256
     backward also with its dK/dV work split 1, 2 and 4 ways); the sm90,
     d256, d192 and simt backwards run twice and held bit-identical, and
     the
     d256 and d192 backwards and the float32 ones above head_dim 128 split
     by kernel (torch.profiler: delta, dK/dV, the reduction of split
     partials where the plan splits, dQ; each must have run);
  7. full-width internlm2-1.8b trained through the port's launcher: 3
     steps of 8 x 4,096 tokens in 4 microbatches, every attention layer
     through the sm90 flash kernels (forward twice a step per layer and
     microbatch, with the recompute of activation checkpointing;
     backward once);
  8. training parity in float32 at full width, 2 layers, one 3,072-token
     sequence, through the simt flash kernels: the card's loss and
     gradients agree with the CPU's plain path;
     b. float32 above head_dim 128, TF32 off, one 2,304-token sequence
        (past the blockwise threshold), card against the port's CPU
        path: gemma3-1b at full width and 8 layers (both prefix layers,
        five local layers and one global) through ``loss_fn``, loss 1e-4
        and every gradient 5e-5 of its scale, 16 + 8 flash launches all
        simt; deepseek-v2's MLA layer at full width (d_model 5,120, 128
        heads of 192) through ``mla_apply``, the output and the
        gradients of x and every weight 5e-5 of their scale, 1 + 1 simt
        launches;
     c. float32 training at full width above head_dim 128 through
        ``make_train_step``, 2 steps of 1 x 4,096 tokens in one
        microbatch: gemma3-1b at full depth (26 layers; 104 + 52 simt
        launches) and deepseek-v2 cut to its dense first layer (MLA and
        the 12,288-wide FFN; 4 + 2), no other flash route; s/step,
        tokens/s, peak memory;
  9. the translation simulator (the paper's Figs 12-14 experiment):
     a. the LRU-scan and timing-epilogue kernels against their plain
        versions on the card at the smoke preset's 2,048-entry windows,
        every chunk, in the ndp_machine(8) and cpu_machine(4) buckets (11
        workloads, the paper's five mechanisms) and zoo_machine(4) with
        all 17 registered mechanisms: packed hit bits, tables and stamps
        identical; counters of events equal, cycles within rtol 1e-5;
        then the epilogue alone at the shapes where its tiling can break
        (T 1 and 1,000, C 1 and 256, M 17, 64 banks, a lane invalid
        throughout; seeded random hit bits), held the same way and
        launched twice from one state (bit-identical), with its ptxas
        registers and spills and each instantiation's resident blocks an
        SM;
     b. the six full-preset buckets (ndp and cpu machines at 1, 4 and 8
        cores, 11 workloads, 8,000-entry windows) through the port's
        launcher: the Fig 12-14 rows, the orderings (on NDP ideal >
        ndpage > 1.0 at every core count, hugepage < radix at 8 cores),
        exactly 48 launches of each kernel, the CUDA kernels a chunk of
        the ndp(8) bucket from torch.profiler (at most 12), and per
        bucket wall s, entries/s and both kernels' and their plain
        versions' times on one 1,024-step chunk (L2 flushed), with the
        least time the card could take, the epilogue's grid and the
        scan's registers and spills; on that chunk each kernel is held
        against its plain
        version again; at 8 cores the scan also timed with no step valid
        and with every chain one mechanism;
     c. the ndp_machine(4) bucket at the full preset on the card against
        the port's CPU path: integer counters equal, cycles within rtol
        1e-5;
     d. the ndp(8) and cpu(8) buckets at 65,536-entry windows;
     e. banked DRAM memory and real traces: the six full-preset buckets
        with every machine's memory banked (16 banks of 2 KB rows)
        through the launcher (exactly 48 launches of each kernel, the
        average speedups at each core count, wall s and entries/s beside
        the bounded ones); both kernels held against their plain
        versions and timed (L2 flushed) on the middle chunk of the banked
        ndp(8) and cpu(8) buckets (packed bits, tables, stamps and open
        rows identical; counters and per-bank accesses equal, cycles
        within rtol 1e-5); the banked ndp(4) bucket card vs CPU; the two
        fixture traces (ChampSim xz, Valgrind lackey gz) as ``trace:``
        specs at 1 and 8 cores with both memory models, card vs CPU
        (integer counters equal, cycles within rtol 1e-5);
     f. the paper's sensitivity sweeps: the nine named sweeps at the full
        preset (180 points, 21 shape buckets) through the launcher's
        ``--sweep``, every bucket at most one bucket plan, and once more
        under torch.profiler (the card's busy share); the orderings of
        the JAX package's sweep benchmark (NDPage >= radix at every PWC
        size, L1-DTLB size, memory latency and banked timing point, and
        cycles monotone in tCAS; bypass off degrades toward radix; both
        flattenings beat radix; the radix walk latency grows with cores
        and huge pages fall below radix by 8 cores; ideal bounds the zoo
        and the Victima reach, Victima within 0.9 of radix); both
        kernels held against their plain
        versions and timed on the middle chunk of the ndp(8) bucket at
        the table geometries only the sweeps and the search reach (PWC
        of 64 and of 8 ways, a 512 KB cache-as-TLB, the search's largest
        TLBs); the l1_bypass sweep (bypassing and polluting lanes in one
        launch) card vs CPU;
     g. the design-space search: the seeded ``quick`` search on the card
        and on the CPU (the same evaluated genomes and frontier,
        objectives within rtol 1e-5), eight genomes of the ``default``
        space that differ only in per-lane data (PWC latency, bypass,
        huge pages) in one bucket card vs CPU, and the seeded
        ``default`` search on the card (>= 200 evaluated, at most one
        bucket plan a bucket, a frontier, one launch of each kernel a
        dispatch), with the verdict on the paper's design point, and
        once more under torch.profiler;
 10. translation-costed serving and the fleet:
     a. the serving cost table (``SERVING_COST``: ndp_machine(4), dlrm,
        the paper's five mechanisms) derived through the simulator
        kernels on the card at the smoke preset (exactly 4 launches of
        each kernel, one bucket plan) and the full one (8 each): both
        tables within 2e-3 cycles of the port's CPU derivation (its
        seconds printed), the smoke one within rtol 0.05 of
        ``PINNED_COSTS``, ndpage's walk below radix's, ideal free;
     b. phase 4's requests served again through the launcher with
        ``--cost-model sweep``: the same tokens, 24 x steps paged
        launches, and ``throughput()``'s checks (hits + misses = priced
        tokens, ndpage >= radix, ideal the upper bound, per-request
        budgets partition the totals); then the costed serving
        benchmark's decode-heavy and prefill-heavy mixes at full width
        with the same checks; the card's wall tokens/s beside the
        simulated machine's tokens/s per mechanism;
     c. the fleet at ``SERVING_FLEET`` scale (1,024 slots, 1,536
        requests), the four runs of the fleet benchmark (shared,
        unshared, independent, budget) with its gates restated and the
        surrogate decode on the card; the shared run again on the CPU
        (identical tokens, stats and meter totals); the CUDA kernels a
        decode step launches;
 11. the dense attention variants:
     a. full-width gemma3-1b (vocab 262,144, bf16, random weights from
        a seed) with its depth cut to 8 of its 26 layers
        (``GEMMA_SERVE_LAYERS``: both prefix layers and one period; the
        script's time; 11c trains all 26) served through the launcher at
        its window-crossing shape (prompts of 520-640 tokens, max_len
        768, page 16), 4 requests in the flat and the radix table mode:
        paged launches 8 x steps, every request complete, tokens in
        range and equal across the two modes;
     b. gemma3 in float32 at 8 layers (both prefix layers, five local,
        one global), prompts past the window: engine streams equal
        greedy_reference's in every table mode, card logits vs CPU 1e-3;
     c. full-width gemma3-1b trained through the launcher at train_4k
        (8 x 4,096 tokens in 4 microbatches, 3 steps): finite losses,
        every attention layer through the d256 flash kernels, peak
        memory, and a fourth step under torch.profiler (time by
        operator);
     d. phi3-medium-14b and granite-34b (4 layers each at full width)
        decode 4 requests through the paged kernel; internvl2-76b (2
        layers at full width) one train forward with 256 stub vision
        tokens;
 12. mixture of experts and MLA:
     a. full-width granite-moe-1b-a400m (32 experts top 8, bf16, random
        weights from a seed) served through the launcher with its depth
        cut to 12 of its 24 layers (``GRANITE_MOE_SERVE_LAYERS``: the
        script's time; 12c trains all 24), 4 requests, flat and radix
        tables: paged launches 12 x steps, the same tokens in both
        modes;
     b. granite-moe and deepseek-v2 at smoke width in float32: engine
        streams equal greedy_reference's in every table mode, logits
        card vs CPU 1e-3, the first train step's loss card vs CPU 1e-4,
        and each MoE layer's routing of one input card vs CPU (a flip
        printed, and failed unless a near-tie);
     c. full-width granite-moe trained through the launcher at train_4k
        (8 x 4,096 tokens in 4 microbatches, 3 steps): 576 + 288 sm90
        flash launches, s/step, tokens/s, peak memory;
     d. deepseek-v2 at full width, 2 of 60 layers (the dense prefix
        layer and one MoE layer of 160 experts, 5.36 B parameters):
        4 requests served through the MLA latent cache (no paged
        launch), then 3 train steps of one 4,096-token sequence with
        bf16 gradients and float32 AdamW moments, both layers through
        the d192 flash kernels (12 + 6 launches), peak memory, and a
        fourth step under torch.profiler (time by operator);
 13. Mamba and the jamba hybrid:
     a. the selective-scan kernels (``csrc/selective_scan.cu``), forward
        and backward, against their plain versions: jamba's training
        shape (B 1, S 4,096, d_inner 16,384, N 16, bf16 x), float32 and
        bf16, N 16 and 4, B 1, 2 and 3, S 4,096 (16 chunks) and a
        ragged 200, 600 or 203, a D not a whole channel block; the
        forward (and its chunk states) allclose 2e-5, the backward's
        five gradients to 2e-5 of their largest element against
        ``selective_scan_bwd_ref``
        and against autograd of the plain forward (a bf16 dx beyond one
        bf16 rounding step), two backwards bit-identical; ptxas
        registers and spills, and each kernel's resident blocks an SM;
        both timed at jamba's shape (L2 flushed) beside the plain
        versions and the least time (bytes, or the exps at the SFU's
        rate);
     b. jamba at smoke width in float32 (8 layers): engine streams equal
        greedy_reference's in every table mode with slots reused (4
        requests on 2), logits card vs CPU 1e-3, the first train step's
        loss card vs CPU 1e-4 (through the scan kernels at N 4);
     c. the serve cut at full width (the period's first 4 layers: three
        Mamba, one attention, all 16 experts; 23.02 B parameters, bf16,
        random weights from a seed): 4 requests of 64-128 prompt and 16
        new tokens, flat and radix tables, paged launches 1 x steps, the
        same tokens in both modes, ms/step, tokens/s, peak memory;
     d. the train cut at full width (mamba+ff, attn+moe with 4 of 16
        experts; 4.66 B parameters): 3 steps of one 4,096-token sequence
        with bf16 gradients and float32 AdamW moments, selective-scan
        launches 6 + 3 and sm90 flash launches 6 + 3, peak memory, and a
        fourth step under torch.profiler (time by operator);
 14. RWKV6 (rwkv6-3b):
     a. the WKV kernels (``csrc/wkv.cu``, the chunks side by side),
        forward and backward, against their plain versions: rwkv6-3b's
        training call (B 2, S 4,096, 40 heads of 64), S 1, 17, 256 and
        512, B 1, head size 16, and slow (``w0`` -6) and underflowing
        (+2) decay at the training call; the forward (and its chunk
        states, the forward's chain, also against ``wkv_chunk_ref``)
        allclose 2e-5 (2e-5 of the largest element at slow and
        underflowing decay), the backward's chain (G at every chunk's
        end) against ``wkv_bwd_chunk_ref`` and its five gradients
        against ``wkv_bwd_ref`` and autograd of the plain forward to
        2e-5 of their largest element, two backwards bit-identical;
        ptxas registers and spills and the resident warps an SM of each
        kernel; both timed at the training call (L2 flushed) beside the
        plain versions and the least time (bytes, or the FMAs at the
        float32 rate), and each stage's kernels by torch.profiler;
     b. rwkv6-3b at smoke width in float32 (2 layers, head size 16):
        engine streams equal greedy_reference's in every table mode with
        slots reused (4 requests on 2), and on a 2 x 512-token batch
        logits card vs CPU 1e-3, loss 1e-4 and every gradient 5e-5 of
        its scale (through the WKV kernels at head size 16);
     c. full-width rwkv6-3b (bf16, random weights from a seed) served
        through the launcher at phase 4's shape with its depth cut to 4
        of its 32 layers (``RWKV_SERVE_LAYERS``: the script's time;
        14d trains 8), flat and radix tables: exactly 0 paged
        launches (no layer holds a KV cache), the same tokens in both
        modes, ms/step, tokens/s, peak memory;
     d. full-width rwkv6-3b at 8 of its 32 layers
        (``RWKV_TRAIN_LAYERS``: the cut that pays for phase 17) trained
        through the launcher at phase 7's shape (8 x 4,096 tokens in 4
        microbatches, 3 steps) with bf16 gradients and float32 AdamW
        moments: WKV launches exactly 192 + 96, finite nonzero losses
        and gradient norms, s/step, tokens/s,
        peak memory, and a fourth step under torch.profiler (time by
        operator);
 15. whisper-tiny, the encoder-decoder (4 + 4 layers, d_model 384, 6
     heads of 64, 36.4 M parameters; no new kernel: its decoder's
     self-attention decodes through the paged kernel and trains through
     the sm90 flash kernels, its encoder's 1,500 frames and the
     cross-attention take the masked softmax):
     a. smoke width in float32 card vs CPU on a 2 x 512-token batch with
        16 stub frames: logits 1e-3, loss 1e-4, every gradient 5e-5 of
        its scale; then ``prefill(audio_frames=)`` and a ``decode_step``
        on the card in the dense, flat and radix modes, whose logits
        equal ``forward_train``'s last position within 2e-4;
     b. full width and depth (bf16, random weights from a seed) served
        through the launcher at phase 4's shape, flat and radix tables
        (the engine at the decode state's zero encoder output, as the
        JAX engine has no audio path): paged launches 4 x steps, the
        same tokens in both modes, ms/step, tokens/s, peak memory;
     c. the audio path at full width: 4 sequences of 1,500 stub frames
        (``add_modality_stubs``), ``prefill(audio_frames=)`` of a
        64-token prompt and 32 greedy decode steps in the flat and
        radix modes (paged launches 4 x steps, the same tokens, the
        encoder output float32 from bf16 weights); a float32 copy of
        the model: prefill's last logits against ``forward_train``'s
        within 2e-4;
     d. full width trained through the launcher at phase 7's shape (8 x
        4,096 tokens in 4 microbatches, 1,500 frames a sequence, 3
        steps): sm90 flash launches exactly 96 + 48 and no other route
        (the encoder launches none), finite losses, s/step, tokens/s,
        peak memory, and a fourth step under torch.profiler;
 16. the roofline (``repro_torch.roofline``):
     a. one train step of phase 7's configuration counted on the card
        under ``flop_stats`` (the aten products and each hand kernel's
        operations as its wrapper records them), then the same step
        counted by ``step_flops`` on fake CUDA tensors on the host: the
        two dicts equal op by op, and the specs allocate nothing on the
        card;
     b. for each training path timed above (7, 11c, 12c, 12d, 13d, 14d,
        15d), the model FLOPs and the fake-tensor count at its shape
        beside its s/step after the first step, each as a share of the
        card's peak, with the card's name and power limit (printed, not
        gated);
 17. the parallel paths (``repro_torch.parallel``), two ranks spawned
     on the one card over gloo (NCCL refuses two ranks on one device;
     gloo takes CUDA tensors for all-reduce, broadcast and all-gather):
     a. data-parallel parity: full-width internlm2-1.8b at 2 layers in
        float32, TF32 off, phase 8's 3,072-token sequence, one a rank:
        the two-rank step's loss (1e-4), averaged gradients and AdamW
        update (5e-5 of their scale) against one rank's step on both
        sequences in two microbatches, both ranks' parameters equal, the
        simt flash launches of each rank; then with ``compress`` (the
        int8 all-reduce) each rank's float32 gradients and int8 codes
        gathered to rank 0, the codes equal the formula's exactly and
        the update equals AdamW of the formula's mean;
     b. the launcher as two processes (``--num-processes 2
        --process-id i --coordinator 127.0.0.1:<free port>
        --compress-grads``) at full width, bf16, fsdp on, 4 of
        internlm2's 24 layers, 2 steps of 4 x 4,096 tokens a rank in 2
        microbatches: sm90 flash launches 32 + 16 a rank, equal losses
        on both ranks, s/step, tokens/s, each rank's peak memory (their
        sum under 70 GiB), the bytes each rank handed to collectives a
        step (gloo's trip through host memory included: a figure for
        this one-card arrangement, not a speed);
     c. the paged decode's mesh branch on a (1, 2) mesh, phase 5's
        engine and requests at full width, 2 layers, float32:
        internlm2-1.8b with its kv heads split (8 / 4 heads a rank) and
        gemma3-1b in query-head mode (2 / 1 heads a rank): streams equal
        the one-rank engine's and greedy_reference's, prefill logits vs
        one rank 1e-3, paged kernel launches 2 x steps a rank;
     d. tensor parallelism on the same (1, 2) mesh in the same ranks:
        one float32 train step of 17a's shape (2 layers at full width,
        TF32 off, one 3,072-token sequence read by both ranks) of
        internlm2-1.8b (8 / 4 heads of 128 a rank, the simt route) and
        gemma3-1b (2 / 1 heads of 256 a rank, its one kv head whole on
        both, simt NT 32; its tied vocab of 262,144 split), against the
        one-rank step computed once in the parent (its gradients and
        parameters passed to the ranks in a file): loss 1e-4, the
        gradient norm, each rank's gradients (its blocks) and AdamW
        moments 5e-5 of their scale, both ranks' replicated parameters
        equal, simt flash launches 4 + 2 a rank and no other route; the
        update's error printed, s/step, the bytes each rank handed to
        collectives, peak memory a rank;
 18. one JSON line describing every kernel, then the final ``ok`` line.

It imports nothing of JAX.  Without a card it exits non-zero and prints
no result.

    python3 chip_smoke.py --sim-times
    CHIP_SMOKE_SRC=<other checkout>/src python3 chip_smoke.py --sim-times

time only the simulator's epilogue kernel at 9b's, 9e's and 9f's chunks
and the walls of 9b, 9f and 9g, for this checkout's port or another's:
run both in turns in one call to compare two trees on one card.

    python3 chip_smoke.py --wkv-times
    CHIP_SMOKE_SRC=<other checkout>/src python3 chip_smoke.py --wkv-times

time only the WKV forward and backward at rwkv6-3b's training call, the
same way, for this checkout's port or another's.

    python3 chip_smoke.py --simt-wide-times
    CHIP_SMOKE_SRC=<other checkout>/src python3 chip_smoke.py --simt-wide-times

hold and time only the float32 flash forward and backward above
head_dim 128 at phase 8c's calls, and the forward at head_dim 128 at
phase 6's, the same way, for this checkout's port or another's;
``--simt-wide-times --forward`` holds and times the forwards alone.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
from torch.nn import functional as F
from torch.nn.attention import SDPBackend

#: the port's sources: this checkout's, or the ``src`` of another checkout
#: named by CHIP_SMOKE_SRC (``--sim-times`` times two trees' simulator
#: kernels with this harness in one call)
sys.path.insert(0, os.environ.get("CHIP_SMOKE_SRC") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import config as C  # noqa: E402
from repro_torch.configs.ndp_sim import (PRESETS,  # noqa: E402
                                         SERVING_COST, SERVING_FLEET,
                                         SWEEPS, WORKLOADS, cpu_machine,
                                         ndp_machine, zoo_machine)
from repro_torch.core import block_table as BT  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as KOPS  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import lru_scan as LS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402
from repro_torch.kernels import sim_epilogue as SE  # noqa: E402
from repro_torch.kernels import wkv as WK  # noqa: E402
from repro_torch.launch import serve as SERVE  # noqa: E402
from repro_torch.launch import simulate as SIMLAUNCH  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.models import (decode_step, forward_train,  # noqa: E402
                                init_params, prefill)
from repro_torch.serving import (FleetEngine, Request,  # noqa: E402
                                 ServeEngine, greedy_reference)
from repro_torch.serving import fleet as FLEET  # noqa: E402
from repro_torch.sim import _search as SEARCH  # noqa: E402
from repro_torch.sim import apply_param, run_bucketed, sweep  # noqa: E402
from repro_torch.sim import simulator as SIM  # noqa: E402
from repro_torch.sim.cost_model import (PINNED_COSTS,  # noqa: E402
                                        TranslationCostModel,
                                        TranslationMeter)
from repro_torch.sim.mechanisms import (DEFAULT_MECHS,  # noqa: E402
                                        registered_names)
from repro_torch.models import attention as AT  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.layers import rope_tables  # noqa: E402
from repro_torch.roofline import counts as RC  # noqa: E402
from repro_torch.roofline.analysis import model_flops  # noqa: E402
from repro_torch.roofline.flop_stats import (flop_stats,  # noqa: E402
                                             step_flops)
from repro_torch.train import data as DATA  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_init)
from repro_torch.train import train_loop as TL  # noqa: E402
from repro_torch.train.train_loop import (TrainState,  # noqa: E402
                                          init_train_state, loss_fn,
                                          make_train_step, trainable)
from repro_torch.util.profile import print_profile  # noqa: E402
from repro_torch.workloads import generate_traces  # noqa: E402

#: the card's rates (H100 SXM data sheet, at the 700 W limit) and the hand
#: kernels' operation counts: repro_torch.roofline.counts, which the port's
#: FLOP counter reads too
HBM_BYTES_PER_S = RC.HBM_BYTES_PER_S
PEAK_FLOPS = RC.PEAK_FLOPS
#: allclose tolerance (atol = rtol) of the kernel against its plain
#: version: the JAX package's kernel tests use the same
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: the bf16 cases are held a second time to a max abs error of 5e-3,
#: 2.5x the largest seen on the H100 (1.953e-3): on a long row |out| is
#: about 0.05, where 2e-2 would let a dropped page through.  No rtol
#: term: the kernel and the plain version round the probabilities to
#: bf16 after different max subtractions, so a small output can differ
#: by several of its own rounding steps
TIGHT_BF16_ATOL = 5e-3
#: ... plus this share of |plain| for the costed mixes' short rows (at
#: most 43 tokens), whose outputs reach 2.19 (seed 6): there the two
#: versions differ by one bf16 step of the output (7.812e-3 = 2**-7 at
#: |out| in [1, 2) on the H100), which 2**-7 x |plain| covers.  The same
#: rows in float32 (mix_f32) hold the kernel's page-8 indexing at TOL
TIGHT_BF16_RTOL = {"mix_bf16": 2.0 ** -7}
#: CPU vs card logits, float32, 2 layers at full width: both sum in
#: float32 in different orders over K = 2048 / 8192
LOGIT_TOL = 1e-3
#: flash backward: max |kernel - plain| over the largest |plain| of each
#: of dQ, dK, dV.  A dK / dV element sums S x G products (32,768 for the
#: MQA case) whose rounding scales with the largest terms, not with the
#: element, so the error is held against the tensor's scale.  Seen on
#: the H100: float32 up to 5.4e-6 of it (MQA), bf16 up to 6.2e-3 on
#: sm90 (MQA) and, on the d256 / d192 wgmma kernels, up to 6.9e-3 (d256,
#: MQA) and 6.0e-3 (d192) (dS rounded to bf16 for the dQ and dK products,
#: as on sm90; the mma.sync kernels they replaced: 7.7e-3 and 5.3e-3).
#: Against autograd of the plain forward, which rounds to bf16 at other
#: places, bf16 keeps the bf16 2e-2 (7.7e-3 seen)
FLASH_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
FLASH_AUTOGRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: bf16 forward held a second time to a max abs error: the kernel rounds
#: p to bf16 after a 64-key (sm90 forward: 128-key) tile's running max,
#: the plain version after a 512-key block's, so the outputs can differ by
#: a bf16 step.  Seen on the H100: 3.9e-3 on most sm90, d256 and d192
#: cases, and 7.8e-3 = 2^-7 (one step at |out| in [1, 2)) on d256 with G =
#: 3 (S 1,000, window 100) and on the mma.sync d192 kernel at S 4,096.  The
#: float32 cases (2e-5) are the ones that catch a dropped key tile
FLASH_TIGHT_BF16 = 1e-2
#: training parity, float32, TF32 off, 2 layers at full width, 3,072
#: tokens: loss abs difference, and each selected gradient's max abs
#: difference relative to its largest element (sums over 3,072 tokens,
#: K = 2048 / 8192 and a 92,544-way softmax in other orders; seen on the
#: H100: loss equal to 6 decimals, gradients up to 5.4e-6)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-5
L2_FLUSH_BYTES = 128 << 20       # > the 50 MB L2
SLEEP_CYCLES = 10_000_000        # about 5 ms at the H100's clock


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def train_run(cfg, batch: int, seq_len: int, microbatches: int,
              secs) -> dict:
    """What phase 16b reads of a training phase: the config it trained
    (depth cut included), its shape, and its s/step after the first."""
    return {"cfg": cfg, "shape": C.ShapeConfig("train", seq_len, batch,
                                               "train"),
            "microbatches": microbatches,
            "s_per_step": float(np.mean(secs[1:] or secs))}


def ptxas_lines(name: str, kernels) -> list:
    """The ``ptxas -v`` register and spill lines of the kernels of
    library ``name`` whose mangled names contain one of ``kernels``,
    each prefixed by that kernel's name."""
    out, entry = [], None
    for line in _build.build_log.get(name, {}).get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in kernels if k in line), None)
            if entry:   # the template arguments, as the mangled name has them
                args = re.search(entry + r"I(?:Li)?(\w+?)E+v", line)
                entry += f"<{args.group(1)}>" if args else ""
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each
    call (the serving path meets K/V pools cold: a step streams 3.8 GB
    of weights between two layers' attention calls).  The card idles on
    a sleep kernel before each start event, so the host has queued all
    of ``fn``'s launches by the time the timed window opens and the
    window holds device time, not Python launch overhead."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in pairs]))


# ---------------------------------------------------------------------------
# phase 3: paged attention against its plain version
# ---------------------------------------------------------------------------
def paged_case(*, b, h, kh, d, page, maxp, n, lengths, dtype, seed,
               holes=(), radix=False, window=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d), np.float32)
    kp = rng.standard_normal((n, page, kh, d), np.float32)
    vp = rng.standard_normal((n, page, kh, d), np.float32)
    tab = np.full((b, maxp), -1, np.int32)
    perm = rng.permutation(n)
    k = 0
    for i, ln in enumerate(lengths):
        used = -(-int(ln) // page)
        tab[i, :used] = perm[k:k + used]
        k += used
    for i, p in holes:
        tab[i, p] = -1
    cuda = lambda a, dt: torch.tensor(a, device="cuda").to(dt)  # noqa: E731
    table = cuda(tab, torch.int32)
    if radix:
        table = BT.translate_all(
            BT.radix_from_flat(table, BT.leaf_size_for(maxp)),
            BT.RADIX).contiguous()
        check(torch.equal(table.cpu(), torch.from_numpy(tab)),
              "radix translate changed the mapping")
    lens = cuda(np.asarray(lengths, np.int32), torch.int32)
    return dict(args=(cuda(q, dtype), cuda(kp, dtype), cuda(vp, dtype),
                      table, lens), window=window)


def within_tight(name: str, err, mag) -> bool:
    """The bf16 cases' second bound: abs error <= TIGHT_BF16_ATOL (+ the
    case's TIGHT_BF16_RTOL x |plain|) everywhere."""
    rtol = TIGHT_BF16_RTOL.get(name, 0.0)
    return bool((err <= TIGHT_BF16_ATOL + rtol * mag).all())


def run(fn, case):
    """Call a paged-attention implementation on a case."""
    return fn(*case["args"], window=case["window"])


def attended_tokens(case) -> int:
    _, kp, _, table, lengths = case["args"]
    tab = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    page = kp.shape[1]
    pos = np.arange(tab.shape[1] * page)
    mask = pos[None] < lens[:, None]
    if case["window"] > 0:
        mask &= pos[None] >= lens[:, None] - case["window"]
    mask &= np.repeat(tab >= 0, page, axis=1)
    return int(mask.sum())


def bound(case):
    """(ms, "bytes"|"operations"): inputs read once (K/V of attended
    tokens only), output written once, against HBM rate and peak
    FLOP/s."""
    q, kp, _, table, _ = case["args"]
    b, _, h, d = q.shape
    kh = kp.shape[2]
    tokens = attended_tokens(case)
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * tokens * kh * d * item
              + table.numel() * 4 + b * 4)
    flops = RC.paged_flops(tokens, h, d)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_paged_attention(q, k_pages, v_pages, block_table, lengths,
                            window=0):
    """The yardstick: page gather + scaled_dot_product_attention."""
    b, _, h, d = q.shape
    n, page, kh, _ = k_pages.shape
    t = block_table.shape[1] * page
    safe = block_table.clamp_min(0).long()
    ks = k_pages[safe].reshape(b, t, kh, d).transpose(1, 2)
    vs = v_pages[safe].reshape(b, t, kh, d).transpose(1, 2)
    pos = torch.arange(t, device=q.device)
    lens = lengths.long()[:, None]
    mask = pos[None] < lens
    if window > 0:
        mask &= pos[None] >= lens - window
    mask &= (block_table >= 0).repeat_interleave(page, dim=1)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), ks, vs, attn_mask=mask[:, None, None, :],
        enable_gqa=True)
    return out.transpose(1, 2)


def phase_kernel():
    spread = np.linspace(1, 1024, 8).round().astype(int).tolist()
    wide = dict(b=8, h=16, kh=8, d=128, page=16, maxp=64, n=8 * 64 + 8,
                lengths=spread)
    cases = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases[f"b8_{tag}"] = paged_case(**wide, dtype=dt, seed=0)
        cases[f"holes_{tag}"] = paged_case(
            **wide, dtype=dt, seed=1, holes=((3, 2), (5, 0), (7, 40)))
        cases[f"radix_{tag}"] = paged_case(**wide, dtype=dt, seed=2,
                                           radix=True)
        cases[f"window_{tag}"] = paged_case(**wide, dtype=dt, seed=3,
                                            window=256)
    empty = dict(wide, lengths=[0] + spread[1:])
    cases["empty_row_f32"] = paged_case(**empty, dtype=torch.float32, seed=4)
    # the serve phase's shapes: max_batch 4, max_len 512 / page 16,
    # pool of 4 * 32 + 8 pages, lengths a mid-run step sees
    cases["serve_bf16"] = paged_case(b=4, h=16, kh=8, d=128, page=16,
                                     maxp=32, n=136,
                                     lengths=[72, 150, 220, 288],
                                     dtype=torch.bfloat16, seed=5)
    # the costed mixes' shapes (phase 10b, COSTED_ENGINE): max_batch 4,
    # max_len 96 / page 8, pool of 4 * 12 + 8 pages, lengths a mid-run
    # step of the two mixes sees (one row ends on a page boundary)
    mix = dict(b=4, h=16, kh=8, d=128, page=8, maxp=12, n=56,
               lengths=[6, 19, 40, 43], seed=6)
    cases["mix_f32"] = paged_case(**mix, dtype=torch.float32)
    cases["mix_bf16"] = paged_case(**mix, dtype=torch.bfloat16)
    for name, shape in VARIANT_PAGED.items():
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            cases[f"{name}_{tag}"] = paged_case(**shape, dtype=dt)
    results = {}
    for name, case in cases.items():
        got = run(PA.paged_attention_cuda, case)
        want = run(ref.paged_attention_ref, case)
        torch.cuda.synchronize()
        tol = TOL[got.dtype]
        err = (got.float() - want.float()).abs()
        mag = want.float().abs()
        ok = bool((err <= tol + tol * mag).all())
        tight = ""
        if got.dtype == torch.bfloat16:
            ok &= within_tight(name, err, mag)
            rtol = TIGHT_BF16_RTOL.get(name, 0.0)
            tight = (f"; and abs_err <= {TIGHT_BF16_ATOL:g}"
                     + (f" + {rtol:g} x |plain|" if rtol else "")
                     + f"; |plain| {float(mag.flatten()[err.argmax()]):.3g}"
                     f" at the max, {float(mag.max()):.3g} at most")
        if name == "empty_row_f32":
            ok &= bool((got[0] == 0).all())
        results[name] = {"max_abs_err": float(err.max()), "tol": tol,
                         "ok": ok}
        print(f"paged_attention {name}: max_abs_err "
              f"{results[name]['max_abs_err']:.3e} (allclose atol=rtol="
              f"{tol:g}{tight}) {'ok' if ok else 'FAIL'}")
    check(all(r["ok"] for r in results.values()),
          "paged_attention kernel disagrees with its plain version")

    for line in ptxas_lines("paged_attention", ("paged_split_kernel",
                                                "paged_combine_kernel")):
        print(f"  paged_attention ptxas: {line}")
    variants = [f"{n}_{t}" for n in VARIANT_PAGED for t in ("bf16", "f32")]
    for name in ("serve_bf16", "mix_bf16", "b8_bf16", *variants):
        q, kp, _, table, _ = cases[name]["args"]
        pps, n_splits, blocks = PA.call_plan(q, kp, table)
        combine = q.shape[0] * q.shape[2] if n_splits > 1 else 0
        smem = PA.split_smem_bytes(q.shape[2] // kp.shape[2], q.shape[3],
                                   kp.shape[1], kp.element_size(), pps)
        print(f"paged_attention {name} split plan: {pps} pages a split, "
              f"{n_splits} splits, {blocks} split blocks + {combine} "
              f"combine blocks, {smem} bytes of shared memory a block")
    # every split size the kernel takes, against the plain version, and
    # timed: the data behind PAGES_PER_SPLIT (not on the main path, so
    # these launches are not counted)
    for name in ("serve_bf16", "mix_bf16", "b8_bf16"):
        case = cases[name]
        want = run(ref.paged_attention_ref, case)
        for pps in (1, 2, 4, PA.MAX_PAGES_PER_SPLIT):
            fn = lambda: PA._launch(*case["args"], case["window"],  # noqa
                                    pps)
            diff = (fn().float() - want.float()).abs()
            err = float(diff.max())
            check(within_tight(name, diff, want.float().abs()),
                  f"paged_attention {name} at {pps} pages a split: "
                  f"max_abs_err {err}")
            print(f"paged_attention {name} at {pps} pages a split: "
                  f"max_abs_err {err:.3e}, {time_cold_ms(fn, 100):.4f} ms "
                  f"(L2 flushed)")
    # the variants' shapes at every split size their shared memory allows
    # (gemma3 at page 64 in bf16: 3, where the unbounded plan's 4 would
    # be refused), held as above; float32 to TOL
    for name in variants:
        case = cases[name]
        q, kp, _, table, _ = case["args"]
        top = PA.max_pages_per_split(q.shape[2] // kp.shape[2], q.shape[3],
                                     kp.shape[1], kp.element_size())
        want = run(ref.paged_attention_ref, case)
        errs = []
        for pps in range(1, top + 1):
            got = PA._launch(*case["args"], case["window"], pps)
            diff = (got.float() - want.float()).abs()
            mag = want.float().abs()
            ok = (within_tight(name, diff, mag) if q.dtype == torch.bfloat16
                  else bool((diff <= TOL[q.dtype] * (1 + mag)).all()))
            check(ok, f"paged_attention {name} at {pps} pages a split: "
                      f"max_abs_err {float(diff.max())}")
            errs.append(f"{float(diff.max()):.3e}")
        print(f"paged_attention {name} at 1..{top} pages a split: "
              f"max_abs_err {', '.join(errs)}")

    lib = run(library_paged_attention, cases["serve_bf16"])
    want = run(ref.paged_attention_ref, cases["serve_bf16"])
    print(f"library yardstick vs plain (serve_bf16): max_abs_err "
          f"{float((lib.float() - want.float()).abs().max()):.3e}")

    timed = {}
    for name in ("serve_bf16", "b8_bf16", "b8_f32", "gemma3_p16_bf16",
                 "granite34b_bf16", "jamba_bf16", "whisper_bf16"):
        case = cases[name]
        ms = time_cold_ms(lambda: run(PA.paged_attention_cuda, case), 200)
        plain_ms = time_cold_ms(lambda: run(ref.paged_attention_ref, case),
                                50)
        library_ms = time_cold_ms(
            lambda: run(library_paged_attention, case), 50)
        bound_ms, bound_by = bound(case)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           attended_tokens=attended_tokens(case))
        print(f"paged_attention {name} timing (L2 flushed): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{timed[name]['attended_tokens']} attended tokens), "
              f"{bound_ms / ms:.1%} of bound")
    return results, timed


#: the decode shapes of the dense attention variants (phase 3): gemma3-1b
#: (D 256, 4 / 1 heads, window 512) at its serve shape (max_batch 4,
#: max_len 768 / page 16) and at page 64 (the default page, where the
#: shared memory bounds the split plan), lengths on both sides of the
#: window; granite-34b (MQA: 48 query heads on one KV head) and
#: granite-moe (D 64, 16 / 8) at the serve shape's pages
_GEMMA_LENS = [300, 511, 513, 700]
_SERVE_LENS = [72, 150, 220, 288]
VARIANT_PAGED = {
    "gemma3_p16": dict(b=4, h=4, kh=1, d=256, page=16, maxp=48, n=200,
                       lengths=_GEMMA_LENS, window=512, seed=7),
    "gemma3_p64": dict(b=4, h=4, kh=1, d=256, page=64, maxp=12, n=56,
                       lengths=_GEMMA_LENS, window=512, seed=8),
    "granite34b": dict(b=4, h=48, kh=1, d=128, page=16, maxp=32, n=136,
                       lengths=_SERVE_LENS, seed=9),
    "granite_moe": dict(b=4, h=16, kh=8, d=64, page=16, maxp=32, n=136,
                        lengths=_SERVE_LENS, seed=10),
    # jamba-1.5-large's attention layer at phase 13c's engine shape
    # (max_batch 4, max_len 256 / page 16, pool of 4 * 16 + 8 pages)
    "jamba": dict(b=4, h=64, kh=8, d=128, page=16, maxp=16, n=72,
                  lengths=[70, 101, 129, 143], seed=11),
    # whisper-tiny's decoder at phase 15b's engine shape (phase 4's:
    # max_batch 4, max_len 512 / page 16): 6 query heads on 6 KV heads
    # of 64 (G 1)
    "whisper": dict(b=4, h=6, kh=6, d=64, page=16, maxp=32, n=136,
                    lengths=_SERVE_LENS, seed=12),
}


# ---------------------------------------------------------------------------
# phase 4: full-width serve
# ---------------------------------------------------------------------------
def phase_serve():
    args = SERVE.build_parser().parse_args([])          # full width, cuda
    torch.cuda.reset_peak_memory_stats()
    PA.launches = 0
    out = SERVE.serve(args)
    launches = PA.launches
    cfg, eng, done = out["cfg"], out["engine"], out["done"]
    steps = eng.sched.stats["steps"]
    new = SERVE.FULL["new_tokens"]
    check(len(done) == args.requests,
          f"served {len(done)} of {args.requests} requests")
    check(all(len(r.generated) == new for r in done),
          "a request finished without its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.generated),
          "a generated token lies outside the vocabulary")
    check(launches == cfg.num_layers * steps,
          f"paged_attention launches {launches} != {cfg.num_layers} "
          f"layers x {steps} steps")
    tokens = sum(len(r.generated) for r in done)
    prompt_tokens = sum(len(r.prompt) for r in done)
    print(f"serve {cfg.name} ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.dtype}): {len(done)} requests, {prompt_tokens} prompt + "
          f"{tokens} generated tokens in {steps} steps, "
          f"{out['seconds']:.3f} s; {tokens / out['seconds']:.1f} generated "
          f"tokens/s, {(prompt_tokens + tokens) / out['seconds']:.1f} "
          f"tokens/s in all; {out['seconds'] / steps * 1e3:.3f} ms/step; "
          f"paged_attention launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"scheduler={eng.sched.stats}")
    tokens_by_req = {r.req_id: list(r.generated) for r in done}
    del out, eng
    torch.cuda.empty_cache()
    return launches, tokens_by_req


# ---------------------------------------------------------------------------
# phase 5: engine parity in float32
# ---------------------------------------------------------------------------
def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("parity: float32, allow_tf32 = False for matmul and cudnn")
    cfg = dataclasses.replace(C.get_arch("internlm2-1.8b"), num_layers=2,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = init_params(cfg, gen, "cuda")
    shape = dict(max_batch=3, max_len=64, page_size=16, device="cuda")
    reqs = SERVE.make_requests(4, cfg.vocab_size, (8, 24), 8, seed=1)
    want = {r.req_id: greedy_reference(
        cfg, model, r.prompt, 8, kv_mode=BT.FLAT, max_len=shape["max_len"],
        page_size=shape["page_size"], device="cuda") for r in reqs}
    for mode in (None, BT.FLAT, BT.RADIX):
        eng = ServeEngine(cfg, model, table_mode=mode, **shape)
        for r in SERVE.make_requests(4, cfg.vocab_size, (8, 24), 8, seed=1):
            eng.submit(r)
        got = {r.req_id: r.generated for r in eng.run()}
        check(got == want, f"table_mode {mode}: engine {got} != "
                           f"greedy_reference {want}")
        print(f"parity table_mode={mode}: {len(got)} token streams equal "
              f"greedy_reference")

    prompt = torch.tensor(reqs[0].prompt[None])
    cpu_model = copy.deepcopy(model).cpu()
    logits_gpu, _ = prefill(model, cfg, prompt.cuda(), kv_mode=BT.FLAT,
                            max_len=64, page_size=16)
    logits_cpu, _ = prefill(cpu_model, cfg, prompt, kv_mode=BT.FLAT,
                            max_len=64, page_size=16)
    diff = float((logits_gpu.cpu() - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
    check(diff <= LOGIT_TOL, f"card vs CPU logits differ by {diff}")
    print(f"parity card kernel path vs CPU plain path: logits "
          f"{tuple(logits_gpu.shape)} max_abs_diff {diff:.3e} "
          f"(tol {LOGIT_TOL:g})")


# ---------------------------------------------------------------------------
# phase 6: flash attention, forward and backward, against plain versions
# ---------------------------------------------------------------------------
#: the training path's attention call: one microbatch of 2 sequences
TRAIN_ATTN = dict(b=2, s=4096, h=16, kh=8, d=128, causal=True, window=0)
#: phase 8's attention call (float32, the simt route's path)
PARITY_ATTN = dict(TRAIN_ATTN, b=1, s=3072)
#: gemma3-1b's training attention (phase 11c, the d256 route): a global
#: layer; its 22 local layers add window=512
GEMMA_ATTN = dict(b=2, s=4096, h=4, kh=1, d=256, causal=True, window=0)
#: phase 8c's gemma3-1b float32 calls (the simt NT 32 kernels): one
#: sequence a step; its 22 local layers add window=512
GEMMA_F32_ATTN = dict(GEMMA_ATTN, b=1)
#: deepseek-v2's training attention (phase 12d, the d192 route): MLA's
#: 128 + 64 query / key columns in one head, 128 heads each with its own
#: key, one 4,096-token sequence
DEEPSEEK_ATTN = dict(b=1, s=4096, h=128, kh=128, d=192, causal=True,
                     window=0)
#: jamba-1.5-large's training attention (phase 13d, the sm90 route): 64
#: query heads over 8 KV heads of 128 (G = 8), one 4,096-token sequence
JAMBA_ATTN = dict(b=1, s=4096, h=64, kh=8, d=128, causal=True, window=0)
#: whisper-tiny's training attention (phase 15d, the sm90 route): its
#: decoder's 6 query heads on 6 KV heads of 64 (G 1), 2 sequences of
#: 4,096 tokens a microbatch
WHISPER_ATTN = dict(b=2, s=4096, h=6, kh=6, d=64, causal=True, window=0)
#: each route is timed at its own path's shape and dtype
ROUTE_CASES = {"sm90": (TRAIN_ATTN, torch.bfloat16),
               "simt": (PARITY_ATTN, torch.float32),
               "d256": (GEMMA_ATTN, torch.bfloat16),
               "d192": (DEEPSEEK_ATTN, torch.bfloat16)}
#: bf16 (the float32 cases at head_dim 256 are SIMT_WIDE_HELD's): the d256
#: route at gemma3's training shape, its local (window 512) and global
#: layers, at a
#: ragged S with a window (G = 4 query heads over a 3-way dK/dV split:
#: chunks cross heads), with one KV head for 8 query heads (MQA), with G =
#: 3 and without the causal mask
D256_CASES = {
    "gemma3_local": dict(GEMMA_ATTN, window=512),
    "gemma3_global": GEMMA_ATTN,
    "d256_ragged": dict(GEMMA_ATTN, b=1, s=1000, h=8, kh=2, window=100),
    "d256_mqa": dict(GEMMA_ATTN, b=1, s=2048, h=8, kh=1),
    "d256_g3": dict(GEMMA_ATTN, b=1, s=1000, h=6, kh=2, window=100),
    "d256_noncausal": dict(GEMMA_ATTN, b=1, s=777, causal=False),
}
#: bf16 (the float32 cases at head_dim 192 are SIMT_WIDE_HELD's): the d192
#: route at deepseek-v2's sequence length with 16 of its heads, at an odd S
#: without
#: the causal mask, and with GQA and a window (the kernel takes both; MLA
#: uses neither)
D192_CASES = {
    "d192_s4096": dict(DEEPSEEK_ATTN, h=16, kh=16),
    "d192_noncausal": dict(DEEPSEEK_ATTN, s=777, h=16, kh=16, causal=False),
    "d192_ragged": dict(DEEPSEEK_ATTN, s=1000, h=8, kh=2, window=100),
}
#: float32 above head_dim 128, the simt kernels' NT 32 (head_dim 193-256)
#: and NT 24 (129-192) instantiations: gemma3-1b's global and local layers
#: at 2 sequences (128-row forward blocks) and its global layer at 8c's
#: one (64-row blocks), deepseek-v2's MLA layer at its full 128 heads, a non-causal S 777 at 192,
#: GQA with a window at a ragged S at 256, head_dim 200 (padded to 256
#: inside the kernel) from rows 4 bytes off 16-byte alignment (4-byte
#: copies), and G = 3 at 192 where the dK/dV plan splits 4 ways (chunks
#: cross heads)
SIMT_WIDE_HELD = {
    "gemma3_global": GEMMA_ATTN,
    "gemma3_local": dict(GEMMA_ATTN, window=512),
    "gemma3_global_b1": GEMMA_F32_ATTN,
    "deepseek": DEEPSEEK_ATTN,
    "d192_noncausal": dict(DEEPSEEK_ATTN, s=777, h=16, kh=16, causal=False),
    "d256_ragged": dict(GEMMA_ATTN, b=1, s=1000, h=8, kh=2, window=100),
    "d200": dict(b=2, s=777, h=6, kh=3, d=200, causal=True, window=100,
                 unaligned=True),
    "d192_g3_split": dict(b=1, s=1000, h=6, kh=2, d=192, causal=True,
                          window=0),
}
#: the same instantiations timed at the calls of phase 8c's paths (the
#: NT 32 one also at gemma3's local layers, window 512), each a row of the
#: kernels line with its path's launches: (label, shape, 8c's path).  The
#: NT 32 one also at 2 sequences (simt_d256, phase 6's timing shape):
#: there the forward takes 128-row blocks, at 8c's one sequence 64-row
#: blocks
SIMT_WIDE_CASES = {
    "simt_d256": ("gemma3-1b B 2", GEMMA_ATTN, "simt_d256"),
    "simt_d256_b1": ("gemma3-1b", GEMMA_F32_ATTN, "simt_d256"),
    "simt_d192": ("deepseek-v2", DEEPSEEK_ATTN, "simt_d192")}
#: the simt kernels whose ptxas lines must report no spill: the forward at
#: every head_dim (at NT 32 also on 64-row blocks), every kernel of the
#: instantiations above 128 (the dK/dV kernel also as its split form),
#: and the reduction of the split dK/dV partials
SIMT_NO_SPILL = ("flash_fwd_kernel<4>", "flash_fwd_kernel<8>",
                 "flash_fwd_kernel<16>",
                 "flash_fwd_rows64_kernel<32>") + tuple(
    f"{k}<{nt}>" for nt in (24, 32)
    for k in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
              "flash_bwd_dkdv_split_kernel", "flash_bwd_dq_kernel")) + (
    "flash_bwd_reduce_kernel",)
_CSRC = "src/repro_torch/kernels/csrc"
FLASH_SOURCES = {"sm90": f"{_CSRC}/flash_attention_sm90.cu",
                 "simt": f"{_CSRC}/flash_attention.cu",
                 "d256": f"{_CSRC}/flash_attention_d256.cu",
                 "d192": f"{_CSRC}/flash_attention_d256.cu"}


def flash_case(*, b, s, h, kh, d, causal, window, dtype, seed,
               unaligned=False):
    """Inputs of one flash call; ``unaligned`` starts every tensor one
    element past a 16-byte boundary, so the kernels take their 4-byte
    copies."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if not unaligned:
            return x
        flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        flat[1:].copy_(x.reshape(-1))
        return flat[1:].view(shape)

    return dict(q=draw(b, s, h, d), k=draw(b, s, kh, d), v=draw(b, s, kh, d),
                do=draw(b, s, h, d), causal=causal, window=window)


def attended_pairs(case) -> int:
    """(query, key) pairs the mask leaves, per (sequence, head)."""
    return RC.attended_pairs(case["q"].shape[1], case["causal"],
                             case["window"])


def flash_bound(case, backward: bool):
    """(ms, "bytes"|"operations"): each input read once, each output
    written once; 4 D operations per attended pair and head forward (QK^T
    and PV), 10 D backward (the five products of the flash backward)."""
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    item = q.element_size()
    big = 2 * q.numel() + 2 * k.numel()           # q, o and k, v
    lse = b * h * s * 4
    if backward:        # read q k v o do lse; write dq dk dv
        nbytes = (big + q.numel() + q.numel() + 2 * k.numel()) * item + lse
    else:               # read q k v; write o lse
        nbytes = big * item + lse
    flops = RC.flash_flops(b, s, h, d, case["causal"], case["window"],
                           backward)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_flops(case, backward: bool) -> int:
    """Operations of the products the kernels run: 4 D an attended pair
    and head forward, 14 D backward (the dQ kernel recomputes S and dP:
    seven products where the bound counts five)."""
    b, s, h, d = case["q"].shape
    return RC.flash_kernel_flops(b, s, h, d, case["causal"], case["window"],
                                 backward)


def flash_fwd(impl, case):
    kw = dict(causal=case["causal"], window=case["window"])
    if impl == "kernel":
        return FA.flash_attention_fwd_cuda(case["q"], case["k"], case["v"],
                                           **kw)
    return ref.flash_attention_ref(case["q"], case["k"], case["v"],
                                   return_lse=True, **kw)


def flash_bwd(impl, case, o, lse):
    fn = (FA.flash_attention_bwd_cuda if impl == "kernel"
          else ref.flash_attention_bwd_ref)
    return fn(case["q"], case["k"], case["v"], o, lse, case["do"],
              causal=case["causal"], window=case["window"])


def autograd_of_plain(case):
    leaves = [case[n].detach().clone().requires_grad_(True)
              for n in ("q", "k", "v")]
    out = ref.flash_attention_ref(*leaves, causal=case["causal"],
                                  window=case["window"])
    return torch.autograd.grad(out, leaves, case["do"])


def library_attention(case):
    """The yardstick: scaled_dot_product_attention over (B, H, S, D)
    views made once; returns (forward fn, backward fn, the name of the
    backend PyTorch picks for it)."""
    q, k, v = (case[n].transpose(1, 2).contiguous().requires_grad_(True)
               for n in ("q", "k", "v"))
    do = case["do"].transpose(1, 2).contiguous()
    backends = {int(b): n for n, b in SDPBackend.__members__.items()}
    backend = backends.get(torch._fused_sdp_choice(
        q, k, v, is_causal=True, enable_gqa=True), "unknown")
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)

    @torch.no_grad()
    def fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    return fwd, lambda: torch.autograd.grad(out, (q, k, v), do,
                                            retain_graph=True), backend


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def scaled_err(grads, want) -> float:
    """The worst of max |g - w| / max |w| over (dq, dk, dv)."""
    return max(max_err(g, w) / float(w.float().abs().max())
               for g, w in zip(grads, want))


def within(got, want, tol: float) -> bool:
    err = (got.float() - want.float()).abs()
    return bool((err <= tol + tol * want.float().abs()).all())


def zero_flash_counts() -> None:
    """Sets every flash launch count, all routes and each, to 0."""
    FA.launches_fwd = FA.launches_bwd = 0
    FA.launches_sm90_fwd = FA.launches_sm90_bwd = 0
    FA.launches_d256_fwd = FA.launches_d256_bwd = 0
    FA.launches_d192_fwd = FA.launches_d192_bwd = 0


def route_launches() -> dict:
    """(forward, backward) launches so far of the routes counted apart."""
    return {"sm90": (FA.launches_sm90_fwd, FA.launches_sm90_bwd),
            "d256": (FA.launches_d256_fwd, FA.launches_d256_bwd),
            "d192": (FA.launches_d192_fwd, FA.launches_d192_bwd)}


def phase_flash():
    for direction, design in FA.simt_design().items():
        print(f"flash_attention simt {direction} design: {design}")
    tiling = FA.simt_fwd_tiling()
    print(f"flash_attention simt fwd tiling: {tiling}")
    check(tiling == {"key_step": ref.FLASH_FWD_STEP,
                     "pair_min_head_dim": FA.SIMT_PAIR_MIN_HEAD_DIM},
          f"the float32 forward's tiling {tiling} is not the plain "
          f"version's key step ({ref.FLASH_FWD_STEP}) and the wrapper's "
          f"pair cutoff ({FA.SIMT_PAIR_MIN_HEAD_DIM})")
    lines = ptxas_lines("flash_attention", (
        "flash_fwd_kernel", "flash_fwd_rows64_kernel",
        "flash_bwd_delta_kernel",
        "flash_bwd_dkdv_kernel", "flash_bwd_dkdv_split_kernel",
        "flash_bwd_dq_kernel", "flash_bwd_reduce_kernel"))
    for line in lines:
        print(f"  flash_attention ptxas: {line}")
    for kernel in SIMT_NO_SPILL:
        spills = [int(n) for line in lines if line.startswith(f"{kernel}:")
                  for n in re.findall(r"(\d+) bytes spill", line)]
        check(bool(spills) and not any(spills), f"the float32 {kernel} "
              f"spills registers, or ptxas reported nothing for it")
    for d in (32, 64, 128, 192, 256):     # one instantiation each, NT d / 8
        occ = FA.simt_occupancy(d)
        print(f"flash_attention simt occupancy at head_dim {d} (NT {d // 8}): "
              + "; ".join(
                  f"{k} {o['threads']} threads, {o['blocks_per_sm']} blocks "
                  f"({o['blocks_per_sm'] * o['threads'] // 32} warps) an SM, "
                  f"{o['registers']} registers, {o['local_bytes']} local "
                  f"bytes, {o['smem_bytes']} B shared"
                  for k, o in occ.items()))
        check(all(o["blocks_per_sm"] >= 1 for o in occ.values()),
              f"a float32 kernel at head_dim {d} cannot be resident")
    check_d256_ptxas()
    ragged = dict(b=1, s=1000, h=8, kh=2, d=64, causal=True, window=0)
    shapes = {
        "train": TRAIN_ATTN,
        "window": dict(TRAIN_ATTN, b=1, s=2048, window=512),
        "noncausal": dict(TRAIN_ATTN, b=1, s=1024, causal=False),
        "mqa": dict(TRAIN_ATTN, b=1, s=2048, kh=1),
        "ragged": ragged,
    }
    # float32 only (bf16 has no kernel at head_dim 36): head_dim padded to
    # 64 inside the kernel, rows 4 bytes off 16-byte alignment; and the
    # head dims above 128
    f32_only = {"d36": dict(b=2, s=777, h=6, kh=3, d=36, causal=True,
                            window=100, unaligned=True), **SIMT_WIDE_HELD}
    results = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        cases = ({**shapes, **D256_CASES, **D192_CASES,
                  "jamba_train": JAMBA_ATTN, "whisper_train": WHISPER_ATTN}
                 if dt == torch.bfloat16 else {**shapes, **f32_only})
        for i, (name, shape) in enumerate(cases.items()):
            case = flash_case(**shape, dtype=dt, seed=10 + i)
            route = FA._route(dt, shape["d"])
            before = route_launches()
            o, lse = flash_fwd("kernel", case)
            ro, rlse = flash_fwd("plain", case)
            grads = flash_bwd("kernel", case, o, lse)
            after = route_launches()
            got = {r: (after[r][0] - before[r][0], after[r][1] - before[r][1])
                   for r in after}
            check(got == {r: (1, 1) if r == route else (0, 0) for r in got},
                  f"{name}_{tag}: launches {got} on the {route} route")
            want = flash_bwd("plain", case, ro, rlse)
            auto = autograd_of_plain(case)
            torch.cuda.synchronize()
            fwd_tol, bwd_tol = TOL[dt], FLASH_BWD_TOL[dt]
            r = {"fwd_err": max_err(o, ro),
                 "lse_err": max_err(lse, rlse),
                 "bwd_err": max(max_err(g, w) for g, w in zip(grads, want)),
                 "bwd_scaled": scaled_err(grads, want),
                 "auto_scaled": scaled_err(grads, auto)}
            ok = (within(o, ro, fwd_tol) and within(lse, rlse, 2e-5)
                  and r["bwd_scaled"] <= bwd_tol
                  and r["auto_scaled"] <= FLASH_AUTOGRAD_TOL[dt])
            if dt == torch.bfloat16:
                ok &= r["fwd_err"] <= FLASH_TIGHT_BF16
            if dt == torch.float32 and shape["d"] > 128:   # NT 24 and 32
                o2, lse2 = flash_fwd("kernel", case)
                r["fwd_twice_equal"] = (torch.equal(o, o2)
                                        and torch.equal(lse, lse2))
                again = flash_bwd("kernel", case, o, lse)
                r["twice_equal"] = all(torch.equal(a, b)
                                       for a, b in zip(grads, again))
                ok &= r["twice_equal"] and r["fwd_twice_equal"]
                del again, o2, lse2
            r["ok"] = ok
            results[f"{name}_{tag}"] = r
            twice = ("" if "twice_equal" not in r else
                     ", two forwards " + ("bit-identical"
                                          if r["fwd_twice_equal"]
                                          else "DIFFER")
                     + ", two backwards " + ("bit-identical"
                                             if r["twice_equal"]
                                             else "DIFFER")
                     + ", forward on %d-row blocks" % FA.simt_fwd_plan(
                         *case["q"].shape, causal=shape["causal"],
                         window=shape["window"]))
            print(f"flash_attention {name}_{tag} ({route}) {shape}: fwd "
                  f"max_abs_err {r['fwd_err']:.3e} (allclose {fwd_tol:g}), "
                  f"lse "
                  f"{r['lse_err']:.3e} (2e-05), bwd vs bwd_ref max_abs_err "
                  f"{r['bwd_err']:.3e}, of scale {r['bwd_scaled']:.3e} "
                  f"({bwd_tol:g}), bwd vs autograd of plain, of scale "
                  f"{r['auto_scaled']:.3e} ({FLASH_AUTOGRAD_TOL[dt]:g})"
                  f"{twice} {'ok' if ok else 'FAIL'}")
            del case, o, lse, ro, rlse, grads, want, auto
            torch.cuda.empty_cache()
    check(all(r["ok"] for r in results.values()),
          "flash_attention kernels disagree with their plain versions")

    timed = {route: time_route(route) for route in ROUTE_CASES}
    timed["whisper"] = time_route("sm90", WHISPER_ATTN, "whisper")
    for key, (label, shape, _) in SIMT_WIDE_CASES.items():
        timed[key] = time_route("simt", shape, label, torch.float32)
    torch.cuda.empty_cache()
    return timed


#: the kernels of flash_attention_d256.cu, each at both head dims but the
#: reduction of the split dK/dV partials
D256_KERNELS = tuple(f"{k}<{d}>" for d in (256, 192) for k in (
    "fwd_kernel", "delta_kernel", "dkdv_kernel", "dq_kernel")) + (
    "dkdv_reduce_kernel",)


def check_d256_ptxas() -> None:
    """Prints the ptxas register and spill lines of every d256 / d192
    kernel and fails if one spills or ptxas reported nothing for it."""
    lines = ptxas_lines("flash_attention_d256", (
        "fwd_kernel", "delta_kernel", "dkdv_reduce_kernel", "dkdv_kernel",
        "dq_kernel"))
    for line in lines:
        print(f"  flash_attention_d256 ptxas: {line}")
    for kernel in D256_KERNELS:
        spills = [int(n) for line in lines
                  if line.startswith(f"{kernel}:")
                  for n in re.findall(r"(\d+) bytes spill", line)]
        check(bool(spills) and not any(spills),
              f"flash_attention_d256 {kernel} spills registers, or ptxas "
              f"reported nothing for it")


def time_route(route: str, shape=None, label: str = "",
               dtype=torch.bfloat16) -> dict:
    """A route's kernels, plain versions and SDPA at its path's shape
    (or at ``shape`` in ``dtype``, another path's call on the route,
    named by ``label``): the kernels held against the plain versions
    with phase 6's gates, times with L2 flushed, bound, achieved
    TFLOP/s, max abs errors, SDPA's backend; the backward is also run
    twice and held bit-identical.  At gemma3's global layer also its
    local one (window 512)."""
    if shape is None:
        shape, dtype = ROUTE_CASES[route]
    name = f"{route} at {label}'s call" if label else route
    case = flash_case(**shape, dtype=dtype, seed=10)
    check(FA._route(dtype, shape["d"]) == route, f"{route} case is routed "
                                                 f"elsewhere")
    o, lse = flash_fwd("kernel", case)
    ro, rlse = flash_fwd("plain", case)
    grads = flash_bwd("kernel", case, o, lse)
    want = flash_bwd("plain", case, ro, rlse)
    errs = {"fwd": max_err(o, ro),
            "bwd": max(max_err(g, w) for g, w in zip(grads, want))}
    # the gates of phase 6, here at the shape the main path gives the route
    fwd_tol, bwd_tol = TOL[dtype], FLASH_BWD_TOL[dtype]
    lse_err, bwd_scaled = max_err(lse, rlse), scaled_err(grads, want)
    ok = (within(o, ro, fwd_tol) and within(lse, rlse, 2e-5)
          and bwd_scaled <= bwd_tol)
    if dtype == torch.bfloat16:
        ok &= errs["fwd"] <= FLASH_TIGHT_BF16
    print(f"flash_attention {name} at its path's shape {shape}: fwd "
          f"max_abs_err {errs['fwd']:.3e} (allclose {fwd_tol:g}), lse "
          f"{lse_err:.3e} (2e-05), bwd vs bwd_ref max_abs_err "
          f"{errs['bwd']:.3e}, of scale {bwd_scaled:.3e} ({bwd_tol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"the {name} kernels disagree with their plain versions at "
              f"their path's shape")
    again = flash_bwd("kernel", case, o, lse)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    check(same, f"two {name} backward runs on the same inputs differ")
    print(f"flash_attention {name} backward deterministic: two runs "
          f"give bit-identical dq, dk, dv")
    del again, grads, want
    lib_fwd, lib_bwd, backend = library_attention(case)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"library yardstick vs plain ({name}, {tag}, SDPA backend "
          f"{backend}): max_abs_err "
          f"{max_err(lib_fwd().transpose(1, 2), ro):.3e}")
    timed = {}
    for direction in ("fwd", "bwd"):
        if direction == "fwd":
            kern = lambda: flash_fwd("kernel", case)  # noqa: E731
            plain = lambda: flash_fwd("plain", case)  # noqa: E731
            lib = lib_fwd
        else:
            kern = lambda: flash_bwd("kernel", case, o, lse)  # noqa: E731
            plain = lambda: flash_bwd("plain", case, ro, rlse)  # noqa: E731
            lib = lib_bwd
        backward = direction == "bwd"
        ms = time_cold_ms(kern, 10)
        plain_ms = time_cold_ms(plain, 3)
        library_ms = time_cold_ms(lib, 10)
        bound_ms, bound_by = flash_bound(case, backward)
        tflops = kernel_flops(case, backward) / (ms * 1e-3) / 1e12
        timed[direction] = dict(ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms,
                                bound_by=bound_by, tflops=tflops,
                                max_abs_err=errs[direction],
                                library_backend=backend)
        print(f"flash_attention {name} {direction} {tag} {shape} timing (L2 "
              f"flushed): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms (SDPA {backend}), bound "
              f"{bound_ms:.4f} ms "
              f"({bound_by}; {attended_pairs(case)} attended pairs a head), "
              f"{bound_ms / ms:.1%} of bound, {tflops:.1f} TFLOP/s achieved "
              f"({14 if backward else 4}·D an attended pair)")
    if route in ("d256", "d192") or shape["d"] > 128:
        q = case["q"]
        plan = FA.d256_bwd_plan if route != "simt" else FA.simt_bwd_plan
        backward_split(route, lambda: flash_bwd("kernel", case, o, lse),
                       plan(*q.shape[:3], case["k"].shape[2], q.shape[3],
                            causal=case["causal"],
                            window=case["window"])["splits"])
    if shape in (GEMMA_ATTN, GEMMA_F32_ATTN):   # 22 local layers: window 512
        local = dict(case, window=512)
        lo, llse = flash_fwd("kernel", local)
        if route == "d256":
            split_sweep("global", case, o, lse)
            split_sweep("window 512", local, lo, llse)
        for direction, fn in (
                ("fwd", lambda: flash_fwd("kernel", local)),
                ("bwd", lambda: flash_bwd("kernel", local, lo, llse))):
            ms = time_cold_ms(fn, 10)
            bound_ms, bound_by = flash_bound(local, direction == "bwd")
            timed[direction].update(window_ms=ms, window_bound_ms=bound_ms)
            print(f"flash_attention {name} {direction} {tag} window 512 "
                  f"timing (L2 flushed): kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {attended_pairs(local)} "
                  f"attended pairs a head), {bound_ms / ms:.1%} of bound")
    return timed


def split_sweep(tag: str, case, o, lse) -> None:
    """The d256 backward's time (L2 flushed) with its dK/dV work split 1,
    2 and 4 ways, the plan's choice marked: the measurement behind
    ``d256_bwd_plan``'s rule, printed, not gated."""
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    plan = FA.d256_bwd_plan(b, s, h, k.shape[2], d, causal=case["causal"],
                            window=case["window"])
    times = []
    for n in (1, 2, 4):
        forced = dict(plan, splits=n, partials=(
            (2, n, b, s, k.shape[2], d) if n > 1 else None))
        with mock.patch.object(FA, "d256_bwd_plan",
                               lambda *a, forced=forced, **kw: forced):
            ms = time_cold_ms(lambda: flash_bwd("kernel", case, o, lse), 10)
        times.append(f"{n}{'*' if n == plan['splits'] else ''}: {ms:.4f}")
    print(f"flash_attention d256 bwd {tag}, dK/dV split n ways (* the "
          f"plan's), ms (L2 flushed): {', '.join(times)}")


#: the kernels of each backward that backward_split requires to have run:
#: the delta pre-pass, dK/dV (split or not) and dQ, then the reduction of
#: split partials
BACKWARD_KERNELS = {
    "d256": ("delta_kernel<", "dkdv_kernel<", "dq_kernel<",
             "dkdv_reduce_kernel"),
    "simt": ("flash_bwd_delta_kernel", "flash_bwd_dkdv",
             "flash_bwd_dq_kernel<", "flash_bwd_reduce_kernel")}


def backward_split(route: str, bwd, splits: int, calls: int = 3) -> None:
    """Where the d256 / d192 backward, or the float32 one above head_dim
    128 (simt), spends its time: each kernel's device time over ``calls``
    backward calls (torch.profiler, L2 warm), printed, not gated.  Four
    kernels: the delta pre-pass, dK/dV, the reduction of the split dK/dV
    partials (where the plan splits, as at gemma3's global layer) and dQ;
    fails if one of them did not run."""
    bwd()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bwd()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    total = sum(kernels.values())
    parts = ", ".join(
        f"{re.sub(r'^void |[(]anonymous namespace[)]::', '', k)[:40]} "
        f"{ms:.4f} ms ({ms / total:.1%})"
        for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1]))
    print(f"flash_attention {route} backward by kernel (torch.profiler, "
          f"{calls} calls, L2 warm; dK/dV split {splits} ways): {total:.4f} "
          f"ms a call: {parts}")
    names = BACKWARD_KERNELS["simt" if route == "simt" else "d256"]
    for name in names[:3] + names[3:] * (splits > 1):
        check(any(name in k for k in kernels),
              f"the {route} backward ran no {name.rstrip('<')}")


# ---------------------------------------------------------------------------
# phase 7: full-width training
# ---------------------------------------------------------------------------
def phase_train():
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = TRAIN.build_parser().parse_args(["--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    out = TRAIN.train(args)
    launches = (FA.launches_fwd, FA.launches_bwd)
    sm90 = (FA.launches_sm90_fwd, FA.launches_sm90_bwd)
    cfg, hist, shape = out["cfg"], out["history"], out["shape"]
    micro = out["microbatches"]
    check(len(hist) == args.steps, f"trained {len(hist)} of {args.steps} "
                                   "steps")
    for m in hist:
        for key in ("loss", "grad_norm"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    layers = cfg.num_layers
    want = (2 * layers * micro * args.steps, layers * micro * args.steps)
    check(launches == want, f"flash_attention launches (fwd, bwd) "
                            f"{launches} != {want}")
    check(sm90 == want, f"sm90 flash_attention launches (fwd, bwd) {sm90} "
                        f"!= {want}: the bf16 train left the sm90 route")
    tokens = shape.global_batch * shape.seq_len
    secs = [m["seconds"] for m in hist]
    later = secs[1:] or secs
    print(f"train {cfg.name} ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.dtype}): {args.steps} steps of {shape.global_batch} x "
          f"{shape.seq_len} tokens in {micro} microbatches; losses "
          f"{[round(m['loss'], 4) for m in hist]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(later):.3f} s/step and {tokens / np.mean(later):.1f} "
          f"tokens/s after the first; flash_attention launches fwd "
          f"{launches[0]}, bwd {launches[1]} (sm90 {sm90[0]}, {sm90[1]}); "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, train_run(cfg, shape.global_batch, shape.seq_len, micro,
                               secs)


# ---------------------------------------------------------------------------
# phase 8: training parity in float32
# ---------------------------------------------------------------------------
def phase_train_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(C.get_arch("internlm2-1.8b"), num_layers=2,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    model = trainable(init_params(cfg, gen, "cuda"))
    cpu_model = copy.deepcopy(model).cpu()
    raw = DATA.SyntheticLM(cfg.vocab_size, 3072, 1).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    zero_flash_counts()
    loss_gpu, _ = loss_fn(model, cfg, {k: v.cuda() for k, v in batch.items()})
    loss_gpu.backward()
    launches = (FA.launches_fwd, FA.launches_bwd)
    check(FA.launches_bwd == cfg.num_layers and FA.launches_fwd > 0,
          "the card's parity run did not go through the flash kernels")
    check(FA.launches_sm90_fwd == FA.launches_sm90_bwd == 0,
          "the float32 parity run went through the sm90 kernels")
    print(f"train parity flash_attention launches: simt fwd {launches[0]}, "
          f"bwd {launches[1]}; sm90 0, 0")
    loss_cpu, _ = loss_fn(cpu_model, cfg, batch)
    loss_cpu.backward()
    loss_gpu, loss_cpu = float(loss_gpu.detach()), float(loss_cpu.detach())
    diff = abs(loss_gpu - loss_cpu)
    check(bool(np.isfinite(loss_gpu)), "non-finite loss")
    check(diff <= TRAIN_LOSS_TOL, f"card vs CPU loss differ by {diff}")
    print(f"train parity float32 (2 layers, 1 x 3072 tokens, allow_tf32 = "
          f"False): loss card {loss_gpu:.6f} CPU {loss_cpu:.6f}, diff "
          f"{diff:.3e} (tol {TRAIN_LOSS_TOL:g})")
    cpu_params = dict(cpu_model.named_parameters())
    for name in ("embed", "lm_head", "final_norm.scale",
                 "stack.layers.0.norm1.scale", "stack.layers.0.mixer.wq",
                 "stack.layers.0.mixer.wk", "stack.layers.1.mixer.wv",
                 "stack.layers.1.mixer.wo", "stack.layers.1.ffn.w_down"):
        g_gpu = dict(model.named_parameters())[name].grad.cpu()
        g_cpu = cpu_params[name].grad
        rel = float((g_gpu - g_cpu).abs().max() / g_cpu.abs().max())
        check(rel <= TRAIN_GRAD_TOL, f"gradient of {name}: card vs CPU "
                                     f"relative max error {rel:.3e}")
        print(f"  grad {name} {tuple(g_cpu.shape)}: max|card - CPU| / "
              f"max|CPU| = {rel:.3e} (tol {TRAIN_GRAD_TOL:g})")
    del model, cpu_model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 8b and 8c: float32 above head_dim 128 (the simt NT 24 / 32 kernels)
# ---------------------------------------------------------------------------
#: 8b: one sequence just past BLOCKWISE_THRESHOLD, where both models leave
#: the masked softmax for flash attention
WIDE_PARITY_TOKENS = 2304
#: 8b: gemma3-1b's first 8 layers: both prefix layers and one period (five
#: local layers, window 512, and one global)
WIDE_GEMMA_LAYERS = 8
#: 8c: steps of one 4,096-token sequence in one microbatch; deepseek-v2
#: cut to its first layer (dense: MLA and the 12,288-wide FFN)
WIDE_TRAIN_STEPS = 2
WIDE_TRAIN_TOKENS = 4096
WIDE_DEEPSEEK_LAYERS = 1


def simt_only(what: str, want: tuple) -> tuple:
    """The (forward, backward) flash launches since
    :func:`zero_flash_counts`; fails unless they are ``want``, none of
    them on the sm90, d256 or d192 route (so all on the simt route)."""
    got = (FA.launches_fwd, FA.launches_bwd)
    others = route_launches()
    check(got == want and all(n == (0, 0) for n in others.values()),
          f"{what}: flash launches (fwd, bwd) {got}, want {want} all on "
          f"the simt route; the bf16 routes {others}")
    return got


def worst_rel(pairs) -> tuple:
    """(name, max |card - CPU| / max |CPU|) of the worst of ``pairs``, an
    iterable of (name, card tensor, CPU tensor)."""
    rels = {n: float((g.cpu() - c).abs().max() / c.abs().max())
            for n, g, c in pairs}
    name = max(rels, key=rels.get)
    return name, rels[name], len(rels)


def phase_wide_parity() -> tuple:
    """8b: float32 training parity above the blockwise threshold at the
    head dims above 128, card (the simt NT 32 / 24 kernels) against the
    port's CPU path (the plain flash pair), TF32 off: gemma3-1b at full
    width and 8 layers through ``loss_fn``, and deepseek-v2's MLA layer
    at full width through ``mla_apply``; every gradient is held."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = WIDE_PARITY_TOKENS
    cfg = dataclasses.replace(C.get_arch(GEMMA), num_layers=WIDE_GEMMA_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(4)
    model = trainable(init_params(cfg, gen, "cuda"))
    cpu_model = copy.deepcopy(model).cpu()
    raw = DATA.SyntheticLM(cfg.vocab_size, s, 1).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    zero_flash_counts()
    loss_gpu, _ = loss_fn(model, cfg, {k: v.cuda() for k, v in batch.items()})
    loss_gpu.backward()
    # a layer's attention runs forward, again in its checkpoint's
    # recompute, and backward: (2 L, L)
    gemma = simt_only(f"8b {cfg.name}", (2 * cfg.num_layers, cfg.num_layers))
    loss_cpu, _ = loss_fn(cpu_model, cfg, batch)
    loss_cpu.backward()
    loss_gpu, loss_cpu = float(loss_gpu.detach()), float(loss_cpu.detach())
    diff = abs(loss_gpu - loss_cpu)
    cpu_params = dict(cpu_model.named_parameters())
    name, rel, n = worst_rel((k, p.grad, cpu_params[k].grad)
                             for k, p in model.named_parameters())
    print(f"8b {cfg.name} float32 ({cfg.num_layers} layers at full width, "
          f"head_dim {cfg.head_dim}, window {cfg.window_size} in the local "
          f"layers, 1 x {s} tokens, allow_tf32 = False): loss card "
          f"{loss_gpu:.6f} CPU {loss_cpu:.6f}, diff {diff:.3e} (tol "
          f"{TRAIN_LOSS_TOL:g}); the worst of {n} gradients {name}: "
          f"max|card - CPU| / max|CPU| = {rel:.3e} (tol {TRAIN_GRAD_TOL:g}); "
          f"simt launches fwd {gemma[0]}, bwd {gemma[1]} (2 L, L); sm90, "
          f"d256, d192 0")
    check(bool(np.isfinite(loss_gpu)) and diff <= TRAIN_LOSS_TOL,
          f"8b {cfg.name}: card vs CPU loss {loss_gpu} vs {loss_cpu}")
    check(rel <= TRAIN_GRAD_TOL, f"8b {cfg.name}: gradient of {name} card "
                                 f"vs CPU relative max error {rel:.3e}")
    del model, cpu_model, cpu_params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(C.get_arch(DEEPSEEK), num_layers=1,
                              dtype="float32")
    m = cfg.mla
    gen = torch.Generator(device="cuda").manual_seed(5)
    mla = trainable(AT.MLA(cfg, torch.float32, torch.device("cuda"), gen))
    cpu_mla = copy.deepcopy(mla).cpu()
    x, dy = (torch.randn((1, s, cfg.d_model), generator=gen, device="cuda")
             for _ in range(2))
    cos, sin = rope_tables(torch.arange(s, device="cuda")[None],
                           m.qk_rope_head_dim, cfg.rope_theta)

    def run(layer, dev):
        leaf = x.to(dev).clone().requires_grad_(True)
        y = AT.mla_apply(layer, leaf, cos.to(dev), sin.to(dev), cfg)
        names = ["x"] + [n for n, _ in layer.named_parameters()]
        grads = torch.autograd.grad(y, [leaf, *layer.parameters()],
                                    dy.to(dev))
        return {"out": y.detach(), **dict(zip(names, grads))}

    zero_flash_counts()
    got = run(mla, "cuda")
    torch.cuda.synchronize()
    deepseek = simt_only(f"8b {cfg.name} MLA", (1, 1))
    want = run(cpu_mla, "cpu")
    name, rel, n = worst_rel((k, got[k], want[k]) for k in want)
    print(f"8b {cfg.name} MLA layer float32 (full width: d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of "
          f"{m.qk_nope_head_dim} + {m.qk_rope_head_dim}, v "
          f"{m.v_head_dim} padded to 192; 1 x {s} tokens): the worst of the "
          f"output and {n - 1} gradients (x and every weight) {name}: "
          f"max|card - CPU| / max|CPU| = {rel:.3e} (tol {TRAIN_GRAD_TOL:g}); "
          f"simt launches fwd {deepseek[0]}, bwd {deepseek[1]}")
    check(rel <= TRAIN_GRAD_TOL, f"8b {cfg.name} MLA: {name} card vs CPU "
                                 f"relative max error {rel:.3e}")
    del mla, cpu_mla, got, want
    torch.cuda.empty_cache()
    return gemma, deepseek


def phase_wide_train() -> dict:
    """8c: float32 training at full width past the blockwise threshold,
    every attention call on the simt NT 32 (gemma3-1b, all 26 layers) or
    NT 24 (deepseek-v2, its dense first layer) kernels: steps of one
    4,096-token sequence in one microbatch through ``make_train_step``;
    s/step, tokens/s and peak memory.  Returns each path's (forward,
    backward) simt launches, keyed as SIMT_WIDE_CASES's paths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, arch, layers in (("simt_d256", GEMMA, None),
                              ("simt_d192", DEEPSEEK, WIDE_DEEPSEEK_LAYERS)):
        cfg = C.get_arch(arch)
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  num_layers=layers or cfg.num_layers)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, 0, "cuda")
        step = make_train_step(cfg, AdamWConfig(total_steps=WIDE_TRAIN_STEPS))
        zero_flash_counts()
        hist = []
        for i in range(WIDE_TRAIN_STEPS):
            raw = DATA.SyntheticLM(cfg.vocab_size, WIDE_TRAIN_TOKENS,
                                   1).batch_at(i)
            batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            metrics["seconds"] = time.perf_counter() - t0
            hist.append(metrics)
        # forward, the checkpoint's recompute and backward a layer and step
        n = WIDE_TRAIN_STEPS * cfg.num_layers
        out[key] = simt_only(f"8c {cfg.name}", (2 * n, n))
        for m in hist:
            for k in ("loss", "grad_norm"):
                check(bool(np.isfinite(m[k])) and m[k] != 0,
                      f"8c {cfg.name}: {k} {m[k]} is not finite and nonzero")
        secs = [m["seconds"] for m in hist]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"8c train {cfg.name} float32 (full width, layers "
              f"{cfg.num_layers}, {cfg.param_count() / 1e9:.2f} B params, "
              f"allow_tf32 = "
              f"False): {WIDE_TRAIN_STEPS} steps of 1 x {WIDE_TRAIN_TOKENS} "
              f"tokens in one microbatch; losses "
              f"{[round(m['loss'], 4) for m in hist]}, grad_norms "
              f"{[round(m['grad_norm'], 4) for m in hist]}; s/step "
              f"{[round(x, 3) for x in secs]} (first includes warm-up); "
              f"{secs[-1]:.3f} s/step and {WIDE_TRAIN_TOKENS / secs[-1]:.1f} "
              f"tokens/s at the last; simt launches fwd {out[key][0]}, bwd "
              f"{out[key][1]} (2 L steps, L steps); peak memory {peak:.2f} "
              f"GiB")
        del state, step, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: the dense attention variants (gemma3-1b served and trained)
# ---------------------------------------------------------------------------
GEMMA = "gemma3-1b"
#: 11a: the serve's depth, cut from 26 layers to keep the script within
#: its time (the two full-depth serves took 38.2-49.0 s): both prefix
#: layers and one period (five local layers, window 512, and one
#: global), as 11b; 11c trains all 26
GEMMA_SERVE_LAYERS = 8
#: 11b: gemma3 float32 at 8 layers (both prefix layers, one period: five
#: local, one global), prompts past the window of 512; max_len 768 gives
#: 48 pages, a whole number of the radix table's 16-entry leaves
GEMMA_PARITY = dict(layers=8, requests=2, prompt=(520, 544), new_tokens=4,
                    max_batch=2, max_len=768, page_size=16)
#: 11d: full widths at reduced depth: (arch, layers); phi3-medium-14b and
#: granite-34b decode, internvl2-76b one train forward
VARIANT_DEPTHS = (("phi3-medium-14b", 4), ("granite-34b", 4))
VLM_DEPTH = 2


def phase_gemma_serve() -> dict:
    """11a: full-width gemma3-1b at :data:`GEMMA_SERVE_LAYERS` of its 26
    layers served through the launcher at its window-crossing shape, in
    the flat and the radix table mode: every attention layer of every
    step through the paged kernel, 7 of the 8 windowed; both modes give
    the same tokens."""
    full = C.get_arch(GEMMA)
    cut = dataclasses.replace(full, num_layers=GEMMA_SERVE_LAYERS)
    launches, tokens = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        args = SERVE.build_parser().parse_args(
            ["--arch", GEMMA, "--requests", "4", "--kv-mode", mode])
        torch.cuda.reset_peak_memory_stats()
        PA.launches = 0
        with mock.patch.object(SERVE.C, "get_arch",
                               lambda name, get=C.get_arch:
                               cut if name == GEMMA else get(name)):
            out = SERVE.serve(args)
        n = PA.launches
        cfg, eng, done = out["cfg"], out["engine"], out["done"]
        shape = SERVE.full_shape(cfg)
        steps = eng.sched.stats["steps"]
        check(len(done) == args.requests,
              f"{mode}: served {len(done)} of {args.requests} requests")
        check(all(len(r.generated) == shape["new_tokens"] for r in done),
              f"{mode}: a request finished without its new tokens")
        check(all(0 <= t < cfg.vocab_size for r in done
                  for t in r.generated),
              f"{mode}: a generated token lies outside the vocabulary")
        check(all(len(r.prompt) > cfg.window_size for r in done),
              "a prompt does not cross the window")
        check(cfg.num_layers == GEMMA_SERVE_LAYERS,
              f"{GEMMA} served {cfg.num_layers} layers")
        check(n == cfg.num_layers * steps and n > 0,
              f"{mode}: paged_attention launches {n} != {cfg.num_layers} "
              f"layers x {steps} steps")
        generated = sum(len(r.generated) for r in done)
        prompts = sum(len(r.prompt) for r in done)
        secs = out["seconds"]
        print(f"serve {cfg.name} {mode} (full width, {cfg.num_layers} of "
              f"{full.num_layers} layers, {cfg.param_count() / 1e9:.2f} B "
              f"params, {cfg.dtype}, window {cfg.window_size}, max_len "
              f"{shape['max_len']}): {len(done)} requests, {prompts} prompt "
              f"+ {generated} generated tokens in {steps} steps, "
              f"{secs:.3f} s; {generated / secs:.1f} generated tokens/s, "
              f"{(prompts + generated) / secs:.1f} tokens/s in all; "
              f"{secs / steps * 1e3:.3f} ms/step; "
              f"paged_attention launches {n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches[mode] = n
        tokens[mode] = {r.req_id: list(r.generated) for r in done}
        del out, eng
        torch.cuda.empty_cache()
    check(tokens[BT.FLAT] == tokens[BT.RADIX],
          "gemma3 flat and radix tables generated different tokens")
    print("serve gemma3-1b: flat and radix tables generate the same tokens")
    return launches


def phase_gemma_parity() -> None:
    """11b: gemma3 in float32 at 8 layers, prompts past the window:
    ServeEngine's streams equal greedy_reference's in every table mode,
    and the card's logits agree with the CPU's plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = GEMMA_PARITY
    cfg = dataclasses.replace(C.get_arch(GEMMA), num_layers=p["layers"],
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = init_params(cfg, gen, "cuda")
    shape = dict(max_batch=p["max_batch"], max_len=p["max_len"],
                 page_size=p["page_size"], device="cuda")

    def requests():
        return SERVE.make_requests(p["requests"], cfg.vocab_size,
                                   p["prompt"], p["new_tokens"], seed=3)

    want = {r.req_id: greedy_reference(
        cfg, model, r.prompt, p["new_tokens"], kv_mode=BT.FLAT,
        max_len=p["max_len"], page_size=p["page_size"], device="cuda")
        for r in requests()}
    for mode in (None, BT.FLAT, BT.RADIX):
        eng = ServeEngine(cfg, model, table_mode=mode, **shape)
        for r in requests():
            eng.submit(r)
        got = {r.req_id: r.generated for r in eng.run()}
        check(got == want, f"gemma3 table_mode {mode}: engine {got} != "
                           f"greedy_reference {want}")
        print(f"gemma3 parity table_mode={mode}: {len(got)} token streams "
              f"equal greedy_reference")
    prompt = torch.tensor(requests()[0].prompt[None])
    cpu_model = copy.deepcopy(model).cpu()
    kw = dict(kv_mode=BT.FLAT, max_len=p["max_len"],
              page_size=p["page_size"])
    logits_gpu, _ = prefill(model, cfg, prompt.cuda(), **kw)
    logits_cpu, _ = prefill(cpu_model, cfg, prompt, **kw)
    diff = float((logits_gpu.cpu() - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
    check(diff <= LOGIT_TOL, f"gemma3 card vs CPU logits differ by {diff}")
    print(f"gemma3 parity ({p['layers']} layers, float32, a "
          f"{prompt.shape[1]}-token prompt) card kernel path vs CPU plain "
          f"path: logits {tuple(logits_gpu.shape)} max_abs_diff {diff:.3e} "
          f"(tol {LOGIT_TOL:g})")
    del model, cpu_model
    torch.cuda.empty_cache()


def phase_gemma_train() -> tuple:
    """11c: full-width gemma3-1b trained through the launcher at
    train_4k, every attention layer through the d256 flash kernels; one
    more step traced by torch.profiler."""
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = TRAIN.build_parser().parse_args(["--arch", GEMMA,
                                            "--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    out = TRAIN.train(args)
    launches = (FA.launches_fwd, FA.launches_bwd)
    d256 = (FA.launches_d256_fwd, FA.launches_d256_bwd)
    cfg, hist, shape = out["cfg"], out["history"], out["shape"]
    micro = out["microbatches"]
    check(len(hist) == args.steps, f"trained {len(hist)} of {args.steps} "
                                   "steps")
    for m in hist:
        for key in ("loss", "grad_norm"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    layers = cfg.num_layers
    want = (2 * layers * micro * args.steps, layers * micro * args.steps)
    check(launches == want == d256,
          f"flash_attention launches (fwd, bwd) {launches}, d256 {d256}, "
          f"!= {want}: gemma3's training left the d256 route")
    tokens = shape.global_batch * shape.seq_len
    secs = [m["seconds"] for m in hist]
    later = secs[1:] or secs
    print(f"train {cfg.name} ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.dtype}, head_dim {cfg.head_dim}, window {cfg.window_size} "
          f"in 22 of {layers} layers): {args.steps} steps of "
          f"{shape.global_batch} x {shape.seq_len} tokens in {micro} "
          f"microbatches; losses {[round(m['loss'], 4) for m in hist]}, "
          f"grad_norms {[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(later):.3f} s/step and {tokens / np.mean(later):.1f} "
          f"tokens/s after the first; flash_attention d256 launches fwd "
          f"{d256[0]}, bwd {d256[1]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # one more step traced: where the step's time goes (not gated)
    step = make_train_step(cfg, AdamWConfig(total_steps=args.steps), micro)
    raw = DATA.SyntheticLM(cfg.vocab_size, shape.seq_len,
                           shape.global_batch).batch_at(args.steps)
    raw = DATA.add_modality_stubs(raw, cfg, seed=args.steps)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(out["state"], batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    print(f"train {cfg.name}: a fourth step under torch.profiler, "
          f"{traced:.3f} s:")
    print_profile(prof, traced)
    del out, step, batch, prof
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return d256, train_run(cfg, shape.global_batch, shape.seq_len, micro,
                           secs)


def phase_variants() -> dict:
    """11d: phi3-medium-14b and granite-34b decode at full width and
    reduced depth (every layer of every step through the paged kernel:
    GQA 40 / 10, MQA 48 / 1); internvl2-76b one train forward at reduced
    depth with its 256 stub vision tokens (flash sm90)."""
    out = {}
    for name, layers in VARIANT_DEPTHS:
        cfg = dataclasses.replace(C.get_arch(name), num_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(4)
        model = init_params(cfg, gen, "cuda")
        eng = ServeEngine(cfg, model, max_batch=4, max_len=512, page_size=16,
                          device="cuda")
        for r in SERVE.make_requests(4, cfg.vocab_size, (64, 128), 8, seed=4):
            eng.submit(r)
        PA.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = eng.sched.stats["steps"]
        check(len(done) == 4 and all(len(r.generated) == 8 for r in done),
              f"{name}: not every request finished with its tokens")
        check(all(0 <= t < cfg.vocab_size for r in done
                  for t in r.generated), f"{name}: a token out of range")
        check(PA.launches == layers * steps and steps > 0,
              f"{name}: paged_attention launches {PA.launches} != "
              f"{layers} x {steps}")
        print(f"decode {name} (full width, {layers} of "
              f"{C.get_arch(name).num_layers} layers, "
              f"{cfg.num_heads} / {cfg.num_kv_heads} heads, "
              f"{cfg.param_count() / 1e9:.2f} B params here): 4 requests, "
              f"{steps} steps in {secs:.3f} s, {secs / steps * 1e3:.3f} "
              f"ms/step; paged_attention launches {PA.launches}")
        out[name] = PA.launches
        del model, eng
        torch.cuda.empty_cache()
    name = "internvl2-76b"
    cfg = dataclasses.replace(C.get_arch(name), num_layers=VLM_DEPTH)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = init_params(cfg, gen, "cuda")
    raw = DATA.add_modality_stubs(
        DATA.SyntheticLM(cfg.vocab_size, 4096, 1).batch_at(0), cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    FA.launches_sm90_fwd = 0
    with torch.no_grad():
        logits, _ = forward_train(model, cfg, batch)
        loss, _ = loss_fn(model, cfg, batch)
    want = (1, cfg.vision_tokens + 4096, cfg.vocab_size)
    check(tuple(logits.shape) == want, f"{name}: logits "
                                       f"{tuple(logits.shape)} != {want}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss)),
          f"{name}: non-finite logits or loss")
    # two forwards (forward_train, then loss_fn's), VLM_DEPTH layers each
    check(FA.launches_sm90_fwd == 2 * VLM_DEPTH,
          f"{name}: sm90 flash launches {FA.launches_sm90_fwd} != "
          f"{2 * VLM_DEPTH}")
    print(f"train forward {name} (full width, {VLM_DEPTH} of "
          f"{C.get_arch(name).num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params here): "
          f"{cfg.vision_tokens} stub vision tokens + 4096 tokens, logits "
          f"{tuple(logits.shape)}, loss {float(loss):.4f}, sm90 flash "
          f"launches {FA.launches_sm90_fwd}")
    del model, logits, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: mixture of experts and MLA (granite-moe-1b-a400m, deepseek-v2)
# ---------------------------------------------------------------------------
GRANITE_MOE = "granite-moe-1b-a400m"
DEEPSEEK = "deepseek-v2-236b"
#: 12a: the serve's depth, cut from 24 layers to keep the script within
#: its time (the two full-depth serves took 31.1-32.2 s); every layer is
#: the same attention + MoE block, and 12c trains all 24
GRANITE_MOE_SERVE_LAYERS = 12
#: 12d: deepseek-v2 at full width, depth cut to its dense prefix layer
#: and one MoE layer (5.36 B parameters, 10.7 GB in bf16); 4 requests of
#: 64-128 prompt and 16 new tokens; one 4,096-token sequence a train step
DEEPSEEK_DEPTH = 2
DEEPSEEK_SERVE = dict(requests=4, prompt=(64, 128), new_tokens=16,
                      max_batch=4, max_len=256, page_size=16)
#: 12b: smoke-width engines (float32): 3 requests of 6-12 prompt and 6
#: new tokens; one train step of 4 x 64 tokens in 2 microbatches
MOE_PARITY = dict(requests=3, prompt=(6, 12), new_tokens=6, max_batch=2,
                  max_len=32, page_size=4)
#: 12b: probability gap under which a routing flip between the card and
#: the CPU is a near-tie of the float32 softmax (a few ulps of 1/E), not
#: a fault
ROUTE_TIE = 1e-6


def serve_checks(cfg, done, n: int, new: int, what: str) -> None:
    check(len(done) == n, f"{what}: served {len(done)} of {n} requests")
    check(all(len(r.generated) == new for r in done),
          f"{what}: a request finished without its new tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.generated),
          f"{what}: a generated token lies outside the vocabulary")


def phase_moe_serve() -> dict:
    """12a: full-width granite-moe-1b-a400m at
    :data:`GRANITE_MOE_SERVE_LAYERS` of its 24 layers served through the
    launcher in the flat and the radix table mode: every attention layer
    of every step through the paged kernel, the same tokens in both
    modes."""
    full = C.get_arch(GRANITE_MOE)
    cut = dataclasses.replace(full, num_layers=GRANITE_MOE_SERVE_LAYERS)
    launches, tokens = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        args = SERVE.build_parser().parse_args(
            ["--arch", GRANITE_MOE, "--requests", "4", "--kv-mode", mode])
        torch.cuda.reset_peak_memory_stats()
        PA.launches = 0
        with mock.patch.object(SERVE.C, "get_arch",
                               lambda name, get=C.get_arch:
                               cut if name == GRANITE_MOE else get(name)):
            out = SERVE.serve(args)
        n = PA.launches
        cfg, eng, done = out["cfg"], out["engine"], out["done"]
        steps = eng.sched.stats["steps"]
        serve_checks(cfg, done, args.requests, SERVE.FULL["new_tokens"],
                     f"{cfg.name} {mode}")
        check(cfg.num_layers == GRANITE_MOE_SERVE_LAYERS,
              f"{GRANITE_MOE} served {cfg.num_layers} layers")
        check(n == cfg.num_layers * steps and n > 0,
              f"{mode}: paged_attention launches {n} != {cfg.num_layers} "
              f"layers x {steps} steps")
        generated = sum(len(r.generated) for r in done)
        prompts = sum(len(r.prompt) for r in done)
        secs = out["seconds"]
        print(f"serve {cfg.name} {mode} (full width, {cfg.num_layers} of "
              f"{full.num_layers} layers, {cfg.param_count() / 1e9:.2f} B "
              f"params, {cfg.dtype}, {cfg.moe.num_experts} experts top "
              f"{cfg.moe.num_experts_per_tok}): {len(done)} requests, "
              f"{prompts} prompt + {generated} generated tokens in {steps} "
              f"steps, {secs:.3f} s; {generated / secs:.1f} generated "
              f"tokens/s, {(prompts + generated) / secs:.1f} tokens/s in "
              f"all; {secs / steps * 1e3:.3f} ms/step; paged_attention "
              f"launches {n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches[mode] = n
        tokens[mode] = {r.req_id: list(r.generated) for r in done}
        del out, eng
        torch.cuda.empty_cache()
    check(tokens[BT.FLAT] == tokens[BT.RADIX],
          f"{GRANITE_MOE} flat and radix tables generated different tokens")
    print(f"serve {GRANITE_MOE}: flat and radix tables generate the same "
          f"tokens")
    return launches


def routing_flips(cfg, model, cpu_model) -> int:
    """Each MoE layer's routing of the same float32 input on the card and
    on the CPU.  A (token, slot) whose expert differs is printed with the
    gap between the two experts' probabilities; it must be a near-tie
    (below ROUTE_TIE).  Returns the count of such flips."""
    flips = 0
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((2, 256, cfg.d_model), np.float32))
    for i, (block, cblock) in enumerate(zip(model.stack.layers,
                                            cpu_model.stack.layers)):
        if not block.moe:
            continue
        gpu = MOE.route(block.ffn, x.cuda(), cfg)
        cpu = MOE.route(cblock.ffn, x, cfg)
        top_gpu, top_cpu = gpu[2].cpu(), cpu[2]
        for n, g, k in torch.nonzero(top_gpu != top_cpu).tolist():
            probs = cpu[0][n, g]
            gap = float((probs[top_gpu[n, g, k]]
                         - probs[top_cpu[n, g, k]]).abs())
            print(f"  routing flip, layer {i}, group {n}, token {g}, slot "
                  f"{k}: card expert {int(top_gpu[n, g, k])}, CPU expert "
                  f"{int(top_cpu[n, g, k])}, probability gap {gap:.3e}")
            check(gap <= ROUTE_TIE, f"layer {i}: card and CPU route token "
                                    f"{g} apart by {gap:.3e}, no near-tie")
            flips += 1
        same_pos = bool(torch.equal(gpu[3].cpu(), cpu[3]))
        print(f"  routing layer {i}: {top_cpu.numel()} (token, slot) "
              f"choices, {int((top_gpu != top_cpu).sum())} differ card vs "
              f"CPU; queue positions {'equal' if same_pos else 'differ'}")
    return flips


def phase_moe_parity() -> dict:
    """12b: granite-moe and deepseek-v2 at smoke width in float32: the
    engine's streams equal greedy_reference's in every table mode, the
    card's logits and first train step's loss agree with the CPU's, and
    the routing of the same input card vs CPU (a flip shown, never
    hidden)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = MOE_PARITY
    out = {}
    for name in (GRANITE_MOE, DEEPSEEK):
        cfg = dataclasses.replace(C.smoke_variant(C.get_arch(name)),
                                  dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(6)
        model = init_params(cfg, gen, "cuda")
        shape = dict(max_batch=p["max_batch"], max_len=p["max_len"],
                     page_size=p["page_size"], device="cuda")

        def requests():
            return SERVE.make_requests(p["requests"], cfg.vocab_size,
                                       p["prompt"], p["new_tokens"], seed=6)

        want = {r.req_id: greedy_reference(
            cfg, model, r.prompt, p["new_tokens"], kv_mode=BT.FLAT,
            max_len=p["max_len"], page_size=p["page_size"], device="cuda")
            for r in requests()}
        for mode in (None, BT.FLAT, BT.RADIX):
            eng = ServeEngine(cfg, model, table_mode=mode, **shape)
            for r in requests():
                eng.submit(r)
            got = {r.req_id: r.generated for r in eng.run()}
            check(got == want, f"{name} table_mode {mode}: engine {got} != "
                               f"greedy_reference {want}")
        print(f"{name} parity (smoke width, float32): engine streams equal "
              f"greedy_reference in table modes auto, flat, radix")
        cpu_model = copy.deepcopy(model).cpu()
        flips = routing_flips(cfg, model, cpu_model)
        prompt = torch.tensor(requests()[0].prompt[None])
        kw = dict(kv_mode=BT.FLAT, max_len=p["max_len"],
                  page_size=p["page_size"])
        logits_gpu, _ = prefill(model, cfg, prompt.cuda(), **kw)
        logits_cpu, _ = prefill(cpu_model, cfg, prompt, **kw)
        diff = float((logits_gpu.cpu() - logits_cpu).abs().max())
        check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
        check(diff <= LOGIT_TOL, f"{name} card vs CPU logits differ by "
                                 f"{diff}")
        raw = DATA.SyntheticLM(cfg.vocab_size, 64, 4).batch_at(0)
        losses = {}
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            state = TrainState(trainable(m), adamw_init(
                dict(m.named_parameters())), 0)
            step = make_train_step(cfg, AdamWConfig(total_steps=3), 2)
            _, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in raw.items()})
            losses[dev] = (metrics["loss"], metrics["aux"])
        loss_diff = abs(losses["cuda"][0] - losses["cpu"][0])
        check(bool(np.isfinite(losses["cuda"][0])), "non-finite loss")
        check(loss_diff <= TRAIN_LOSS_TOL, f"{name} card vs CPU first-step "
                                           f"loss differ by {loss_diff}")
        print(f"{name} parity card vs CPU: prefill logits "
              f"{tuple(logits_gpu.shape)} max_abs_diff {diff:.3e} (tol "
              f"{LOGIT_TOL:g}); first train step loss card "
              f"{losses['cuda'][0]:.6f} CPU {losses['cpu'][0]:.6f}, diff "
              f"{loss_diff:.3e} (tol {TRAIN_LOSS_TOL:g}), aux card "
              f"{losses['cuda'][1]:.6f} CPU {losses['cpu'][1]:.6f}; routing "
              f"flips {flips}")
        out[name] = dict(logits=diff, loss=loss_diff, flips=flips)
        del model, cpu_model
        torch.cuda.empty_cache()
    return out


def phase_moe_train() -> tuple:
    """12c: full-width granite-moe-1b-a400m trained through the launcher
    at train_4k, every attention layer through the sm90 flash kernels
    (head_dim 64)."""
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = TRAIN.build_parser().parse_args(["--arch", GRANITE_MOE,
                                            "--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    out = TRAIN.train(args)
    sm90 = (FA.launches_sm90_fwd, FA.launches_sm90_bwd)
    cfg, hist, shape = out["cfg"], out["history"], out["shape"]
    micro = out["microbatches"]
    check(len(hist) == args.steps, f"trained {len(hist)} of {args.steps} "
                                   "steps")
    for m in hist:
        for key in ("loss", "grad_norm", "aux"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    layers = cfg.num_layers
    want = (2 * layers * micro * args.steps, layers * micro * args.steps)
    check(sm90 == (FA.launches_fwd, FA.launches_bwd) == want,
          f"sm90 flash_attention launches (fwd, bwd) {sm90} != {want}")
    tokens = shape.global_batch * shape.seq_len
    secs = [m["seconds"] for m in hist]
    later = secs[1:] or secs
    print(f"train {cfg.name} ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.dtype}, {cfg.moe.num_experts} experts top "
          f"{cfg.moe.num_experts_per_tok}): {args.steps} steps of "
          f"{shape.global_batch} x {shape.seq_len} tokens in {micro} "
          f"microbatches; losses {[round(m['loss'], 4) for m in hist]}, aux "
          f"{[round(m['aux'], 4) for m in hist]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(later):.3f} s/step and {tokens / np.mean(later):.1f} "
          f"tokens/s after the first; flash_attention sm90 launches fwd "
          f"{sm90[0]}, bwd {sm90[1]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return sm90, train_run(cfg, shape.global_batch, shape.seq_len, micro,
                           secs)


class PlainFlash(torch.autograd.Function):
    """The plain flash pair phase 6 holds the kernels against:
    ``flash_attention_ref`` forward, ``flash_attention_bwd_ref``
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, do.contiguous(),
                                            causal=ctx.causal,
                                            window=ctx.window)
        return (*grads, None, None)


def plain_flash(q, k, v, *, causal=True, window=0):
    return PlainFlash.apply(q, k, v, causal, window)


def mla_layer_parity(cfg, mla) -> None:
    """12d: one full-width MLA layer over deepseek's 4,096 tokens, its
    attention through the d192 kernels and through the plain pair on the
    same inputs: ``mla_apply``'s wiring into the kernel (the joined q/k,
    k_rope broadcast to every head, v padded to 192, the output sliced
    back) held at phase 6's bf16 gates, the output allclose at TOL and
    dL/dx of scale at FLASH_BWD_TOL."""
    s = DEEPSEEK_ATTN["s"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, dy = (torch.randn((1, s, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.torch_dtype)
             for _ in range(2))
    cos, sin = rope_tables(torch.arange(s, device="cuda")[None],
                           cfg.mla.qk_rope_head_dim, cfg.rope_theta)

    def run():
        leaf = x.clone().requires_grad_(True)
        y = AT.mla_apply(mla, leaf, cos, sin, cfg)
        (dx,) = torch.autograd.grad(y, leaf, dy)
        return y.detach(), dx

    before = route_launches()["d192"]
    got = run()
    mid = route_launches()["d192"]
    with mock.patch.object(KOPS, "flash_attention", plain_flash):
        want = run()
    after = route_launches()["d192"]
    torch.cuda.synchronize()
    check((mid[0] - before[0], mid[1] - before[1]) == (1, 1) and
          after == mid, f"MLA layer parity: d192 launches {before} -> {mid} "
                        f"-> {after}, want one each through the kernel and "
                        f"none through the plain pair")
    dt = cfg.torch_dtype
    r = {"out_err": max_err(got[0], want[0]),
         "out_scaled": scaled_err(got[:1], want[:1]),
         "dx_err": max_err(got[1], want[1]),
         "dx_scaled": scaled_err(got[1:], want[1:])}
    ok = (within(got[0], want[0], TOL[dt])
          and r["dx_scaled"] <= FLASH_BWD_TOL[dt])
    print(f"MLA layer {cfg.name} (full width, {s} tokens, 128 heads of "
          f"192): d192 kernels vs the plain pair: out max_abs_err "
          f"{r['out_err']:.3e}, of scale {r['out_scaled']:.3e} (allclose "
          f"{TOL[dt]:g}); dL/dx max_abs_err {r['dx_err']:.3e}, of scale "
          f"{r['dx_scaled']:.3e} ({FLASH_BWD_TOL[dt]:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "MLA through the d192 kernels disagrees with MLA through the "
              "plain pair")


def phase_deepseek() -> dict:
    """12d: deepseek-v2 at full width, depth cut to 2 of 60 layers (the
    dense prefix layer and one MoE layer): served (the MLA latent cache,
    no KV pool, so no paged launch), then trained 3 steps of one
    4,096-token sequence, both layers' attention through the d192 flash
    kernels."""
    cfg = dataclasses.replace(C.get_arch(DEEPSEEK), num_layers=DEEPSEEK_DEPTH)
    p = DEEPSEEK_SERVE
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(cfg, gen, "cuda")
    eng = ServeEngine(cfg, model, max_batch=p["max_batch"],
                      max_len=p["max_len"], page_size=p["page_size"],
                      device="cuda")
    for r in SERVE.make_requests(p["requests"], cfg.vocab_size, p["prompt"],
                                 p["new_tokens"], seed=0):
        eng.submit(r)
    PA.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = eng.sched.stats["steps"]
    serve_checks(cfg, done, p["requests"], p["new_tokens"], cfg.name)
    check(PA.launches == 0, f"{cfg.name}: {PA.launches} paged launches; an "
                            f"MLA layer has no KV pool")
    generated = sum(len(r.generated) for r in done)
    print(f"serve {cfg.name} (full width, {DEEPSEEK_DEPTH} of "
          f"{C.get_arch(DEEPSEEK).num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params here, "
          f"{cfg.moe.num_experts} experts top {cfg.moe.num_experts_per_tok} "
          f"+ {cfg.moe.num_shared_experts} shared): {len(done)} requests, "
          f"{generated} generated tokens in {steps} steps, {secs:.3f} s, "
          f"{secs / steps * 1e3:.3f} ms/step; paged_attention launches "
          f"{PA.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eng
    mla_layer_parity(cfg, model.stack.layers[0].mixer)
    del model
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, 0, "cuda")
    step = make_train_step(cfg, AdamWConfig(total_steps=3), 1)
    zero_flash_counts()
    hist = []
    for i in range(3):
        raw = DATA.SyntheticLM(cfg.vocab_size, 4096, 1).batch_at(i)
        batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        metrics["seconds"] = time.perf_counter() - t0
        hist.append(metrics)
    d192 = (FA.launches_d192_fwd, FA.launches_d192_bwd)
    for m in hist:
        for key in ("loss", "grad_norm", "aux"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    want = (2 * DEEPSEEK_DEPTH * 3, DEEPSEEK_DEPTH * 3)
    check(d192 == (FA.launches_fwd, FA.launches_bwd) == want,
          f"d192 flash_attention launches (fwd, bwd) {d192} != {want}")
    secs = [m["seconds"] for m in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step traced: where the step's time goes (not gated)
    raw = DATA.SyntheticLM(cfg.vocab_size, 4096, 1).batch_at(3)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    print(f"train {cfg.name}: a fourth step under torch.profiler, "
          f"{traced:.3f} s:")
    print_profile(prof, traced)
    print(f"train {cfg.name} (full width, {DEEPSEEK_DEPTH} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params, bf16 gradients, float32 "
          f"AdamW moments): 3 steps of 1 x 4096 tokens; losses "
          f"{[round(m['loss'], 4) for m in hist]}, aux "
          f"{[round(m['aux'], 4) for m in hist]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(secs[1:]):.3f} s/step and "
          f"{4096 / np.mean(secs[1:]):.1f} tokens/s after the first; "
          f"flash_attention d192 launches fwd {d192[0]}, bwd {d192[1]}; "
          f"peak memory {peak:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return {"launches": d192, "peak_gib": peak,
            "train": train_run(cfg, 1, 4096, 1, secs)}


# ---------------------------------------------------------------------------
# phase 13: Mamba and the jamba hybrid (the selective-scan kernel)
# ---------------------------------------------------------------------------
JAMBA = "jamba-1.5-large-398b"
#: 13a: the selective-scan kernel's cases (B, S, D, N, x dtype): jamba's
#: training shape (B 1, S 4,096 = 16 chunks, d_inner 16,384, N 16, bf16),
#: then float32 / bf16, N 16 / 4, B 1 / 2 / 3, S 4,096, a ragged 200
#: or 600 (not a whole 16-step forward tile or 256-step chunk) and 203
#: (not a whole 8-step backward sub-chunk either), a D not a whole
#: 128-channel backward block or 32-channel forward block
SCAN_CASES = {
    "jamba_bf16": (1, 4096, 16384, 16, torch.bfloat16),
    "b2_n16_f32": (2, 4096, 2048, 16, torch.float32),
    "b2_n4_bf16": (2, 4096, 512, 4, torch.bfloat16),
    "ragged_n4_f32": (2, 200, 1000, 4, torch.float32),
    "ragged_n16_bf16": (1, 200, 4096, 16, torch.bfloat16),
    "ragged_b3_n16_f32": (3, 600, 1000, 16, torch.float32),
    "ragged_s203_n16_f32": (2, 203, 1000, 16, torch.float32),
}
#: the scan kernel against its plain version: the forward allclose at the
#: float32 2e-5 (atol = rtol), the backward's five gradients to 2e-5 of
#: their largest element (sums over 16,384 channels and 4,096 steps in
#: other orders), against selective_scan_bwd_ref and against autograd of
#: the plain forward
SCAN_TOL = 2e-5
#: ... but a bf16 dx may differ by this many bf16 steps of its element
#: (one step is at most 2**-7 of it: 8 significant bits): both sides
#: round a float32 value to bf16 at the end, and a float32 difference of
#: a few ulps flips the rounding of an element near a rounding boundary.
#: Seen on the H100 (jamba's shape, the kernel's exps by ex2.approx):
#: 17,203 of 67.1 M elements one step apart against the plain backward
#: (17,222 against autograd), 2.20e-3 of scale raw (the step at |dx| in
#: [2, 4) is 2**-6); beyond one step 0.  The raw error and the count of
#: elements apart are printed beside the residue
SCAN_BF16_DX_STEPS = 1
#: special-function unit results an SM takes a clock (expf is one ex2):
#: NVIDIA's arithmetic-instruction throughput table, compute capability
#: 9.0
SFU_PER_CLOCK = 16
H100_SMS = 132
#: 13b: smoke width in float32, 4 requests on 2 slots (slots reused)
JAMBA_PARITY = dict(MOE_PARITY, requests=4)
#: 13c: the serve cut: the first 4 layers of the period at full width
#: (mamba+ff, mamba+moe, mamba+ff, attn+moe: every block kind, all 16
#: experts), 23.02 B parameters; 4 requests of 64-128 prompt and 16 new
#: tokens
JAMBA_SERVE_LAYERS = 4
JAMBA_SERVE = DEEPSEEK_SERVE
#: 13d: the train cut: layers 2 and 3 of the period (mamba+ff, attn+moe)
#: with 4 of the 16 experts (top 2 kept), 4.66 B parameters; 3 steps of
#: one 4,096-token sequence
JAMBA_TRAIN_EXPERTS = 4


def jamba_cut(what: str):
    """The serve cut or the train cut of jamba-1.5-large (depth cuts of
    one period; num_periods stays 1)."""
    from repro_torch.configs.jamba_1_5_large_398b import PATTERN
    full = C.get_arch(JAMBA)
    if what == "serve":
        return dataclasses.replace(full, num_layers=JAMBA_SERVE_LAYERS,
                                   layer_pattern=PATTERN[:4])
    return dataclasses.replace(
        full, num_layers=2, layer_pattern=PATTERN[2:4],
        moe=dataclasses.replace(full.moe, num_experts=JAMBA_TRAIN_EXPERTS))


def scan_inputs(b, s, d, n, dtype, seed):
    """Scan operands at a Mamba layer's scale on the card: dt in [1e-3,
    0.1] (its init's range), a = -(1..N) jittered, x, b, c, dy normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    a = -(torch.arange(1, n + 1, device="cuda", dtype=torch.float32)[None]
          * (0.5 + torch.rand((d, n), generator=gen, device="cuda")))
    return {"x": randn(b, s, d).to(dtype),
            "dt": 1e-3 + 0.099 * torch.rand((b, s, d), generator=gen,
                                             device="cuda"),
            "b": randn(b, s, n), "c": randn(b, s, n), "a": a.contiguous(),
            "dy": randn(b, s, d)}


def scan_args(t):
    return [t[k] for k in ("x", "dt", "b", "c", "a")]


def bf16_step(w: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding step at each element of ``w`` (8 significant
    bits: 2**(e - 8) for |w| in [2**(e - 1), 2**e))."""
    _, e = torch.frexp(w.float())
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def scan_bwd_errs(got, want, x_dtype) -> tuple:
    """(each gradient's max |got - want| over its largest |want|, with a
    bf16 dx's error beyond :data:`SCAN_BF16_DX_STEPS` bf16 steps of its
    element instead, and a gradient that is 0 throughout, as da is at S
    1, by its largest |got|; for a bf16 dx its raw error of scale and the
    count of elements that differ, else None)."""
    out, raw = {}, None
    for name, g, w in zip(("dx", "ddt", "db", "dc", "da"), got, want):
        err = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max())
        if name == "dx" and x_dtype == torch.bfloat16:
            raw = (float(err.max()) / scale, int((err > 0).sum()))
            err = (err - SCAN_BF16_DX_STEPS * bf16_step(w)).clamp_min(0)
        out[name] = float(err.max()) / (scale or 1.0)
    return out, raw


def autograd_of_plain_scan(t):
    leaves = [v.detach().clone().requires_grad_(True) for v in scan_args(t)]
    y = ref.selective_scan_ref(*leaves)
    grads = torch.autograd.grad(y, leaves, t["dy"])
    del y, leaves
    return grads


def scan_bound(b, s, d, n, x_bytes: int, backward: bool):
    """(ms, "bytes" or "operations"): the least time of the forward or
    the backward.  Bytes: each input read once and each output written
    once (forward: x, dt, b, c, a in, y and the chunk states out;
    backward: those inputs, the states and dy in, dx, d(dt), db, dc, da
    out).  Operations: the B S D N exps of exp(dt a), at the SFU's rate
    at the card's top SM clock."""
    elems, states = b * s * d, b * SS.geometry(s, d)[0] * d * n
    small = 4 * (2 * b * s * n + d * n)
    if backward:
        nbytes = (elems * (2 * x_bytes + 4 + 4 + 4) + 4 * states
                  + 2 * small)
    else:
        nbytes = elems * (x_bytes + 4 + 4) + 4 * states + small
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    exp_ms = RC.scan_exps(b, s, d, n) / (H100_SMS * SFU_PER_CLOCK
                              * float(clock) * 1e6) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= exp_ms else (exp_ms,
                                                          "operations")


def phase_scan_kernel() -> dict:
    """13a: the selective-scan kernels, forward and backward, against
    their plain versions on the card, and timed at jamba's shape."""
    for line in ptxas_lines("selective_scan", ("scan_fwd_kernel",
                                               "scan_bwd_kernel",
                                               "scan_bwd_reduce_kernel")):
        print(f"  selective_scan ptxas: {line}")
    b, s, d, n, dtype = SCAN_CASES["jamba_bf16"]
    for direction, o in SS.occupancy(n, dtype).items():
        warps = b * d * (n // 4) / 32 / H100_SMS   # 4 states a lane
        print(f"selective_scan {direction} (N {n}, bf16 x): "
              f"{o['threads']} threads a block, {o['registers']} "
              f"registers, {o['local_bytes']} local bytes a thread, "
              f"{o['blocks_per_sm']} blocks an SM resident "
              f"({o['blocks_per_sm'] * o['threads'] // 32} warps); jamba's "
              f"B {b}, D {d} gives {warps:.1f} warps an SM")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, (b, s, d, n, dtype) in SCAN_CASES.items():
        t = scan_inputs(b, s, d, n, dtype, seed=len(name))
        y, hs = SS.forward(*scan_args(t))
        want_y, want_hs = ref.selective_scan_ref(*scan_args(t),
                                                 return_states=True)
        fwd_ok = (hs.shape == want_hs.shape and within(y, want_y, SCAN_TOL)
                  and within(hs, want_hs, SCAN_TOL))
        y_err, hs_err = max_err(y, want_y), max_err(hs, want_hs)
        del want_y, want_hs
        got = SS.backward(*scan_args(t), hs, t["dy"])
        again = SS.backward(*scan_args(t), hs, t["dy"])
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        del again
        vs_ref, raw_ref = scan_bwd_errs(got, ref.selective_scan_bwd_ref(
            *scan_args(t), hs, t["dy"]), dtype)
        vs_auto, raw_auto = scan_bwd_errs(got, autograd_of_plain_scan(t),
                                          dtype)
        bwd_worst = max(*vs_ref.values(), *vs_auto.values())
        ok = fwd_ok and same and bwd_worst <= SCAN_TOL
        errs["fwd"] = max(errs["fwd"], y_err)
        errs["bwd"] = max(errs["bwd"], bwd_worst)
        print(f"selective_scan {name} (B {b}, S {s}, D {d}, N {n}, x "
              f"{str(dtype)[6:]}): forward y max_abs_err {y_err:.3e}, chunk "
              f"states {hs_err:.3e} (allclose {SCAN_TOL:g}); backward of "
              f"scale vs bwd_ref "
              + ", ".join(f"{k} {v:.2e}" for k, v in vs_ref.items())
              + "; vs autograd of the plain forward "
              + ", ".join(f"{k} {v:.2e}" for k, v in vs_auto.items())
              + f" ({SCAN_TOL:g}"
              + (f", dx beyond {SCAN_BF16_DX_STEPS} bf16 step; dx raw of "
                 f"scale {raw_ref[0]:.2e} vs bwd_ref with {raw_ref[1]} "
                 f"elements apart, {raw_auto[0]:.2e} vs autograd with "
                 f"{raw_auto[1]} apart" if raw_ref else "")
              + f"); two backwards {'bit-identical' if same else 'DIFFER'}"
              f" {'ok' if ok else 'FAIL'}")
        check(ok, f"selective_scan {name} disagrees with its plain version")
        del t, y, hs, got
        torch.cuda.empty_cache()

    # b and c as mamba_apply hands them over at B S == 1: views of one
    # projection row, 4 bytes past a 16-byte boundary (the backward
    # reads them as float4s, so its wrapper copies them)
    t = scan_inputs(1, 1, 1000, 16, torch.float32, seed=7)
    proj = torch.randn((1, 1, 33), device="cuda")
    t["b"], t["c"] = proj[..., 1:17], proj[..., 17:]
    y, hs = SS.forward(*scan_args(t))
    got = SS.backward(*scan_args(t), hs, t["dy"])
    vs_ref, _ = scan_bwd_errs(got, ref.selective_scan_bwd_ref(
        *scan_args(t), hs, t["dy"]), torch.float32)
    ok = (t["b"].data_ptr() % 16 != 0
          and within(y, ref.selective_scan_ref(*scan_args(t)), SCAN_TOL)
          and max(vs_ref.values()) <= SCAN_TOL)
    print(f"selective_scan b, c off a 16-byte boundary (B 1, S 1, D 1000, "
          f"N 16): backward of scale vs bwd_ref "
          + ", ".join(f"{k} {v:.2e}" for k, v in vs_ref.items())
          + f" {'ok' if ok else 'FAIL'}")
    check(ok, "selective_scan disagrees on b, c off a 16-byte boundary")
    del t, proj, y, hs, got

    b, s, d, n, dtype = SCAN_CASES["jamba_bf16"]
    t = scan_inputs(b, s, d, n, dtype, seed=0)
    _, hs = SS.forward(*scan_args(t))
    timed = {}
    for direction, fn, plain in (
            ("fwd", lambda: SS.forward(*scan_args(t)),
             lambda: ref.selective_scan_ref(*scan_args(t))),
            ("bwd", lambda: SS.backward(*scan_args(t), hs, t["dy"]),
             lambda: ref.selective_scan_bwd_ref(*scan_args(t), hs,
                                                t["dy"]))):
        ms = time_cold_ms(fn, 10)
        plain_ms = time_plain_ms(plain)
        bound_ms, bound_by = scan_bound(b, s, d, n, 2, direction == "bwd")
        timed[direction] = dict(max_abs_err=errs[direction], ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
        print(f"selective_scan {direction} timing at jamba's shape (B {b}, "
              f"S {s}, D {d}, N {n}, bf16 x; L2 flushed): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}), {bound_ms / ms:.1%} of bound; no PyTorch "
              f"call computes the scan (library: none)")
    del t, hs
    torch.cuda.empty_cache()
    return timed


def phase_jamba_parity() -> dict:
    """13b: jamba at smoke width in float32 (8 layers, N 4): the engine's
    streams equal greedy_reference's in every table mode with slots
    reused, the card's logits and first train step's loss agree with the
    CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = JAMBA_PARITY
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(JAMBA)),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = init_params(cfg, gen, "cuda")
    shape = dict(max_batch=p["max_batch"], max_len=p["max_len"],
                 page_size=p["page_size"], device="cuda")

    def requests():
        return SERVE.make_requests(p["requests"], cfg.vocab_size,
                                   p["prompt"], p["new_tokens"], seed=6)

    want = {r.req_id: greedy_reference(
        cfg, model, r.prompt, p["new_tokens"], kv_mode=BT.FLAT,
        max_len=p["max_len"], page_size=p["page_size"], device="cuda")
        for r in requests()}
    for mode in (None, BT.FLAT, BT.RADIX):
        eng = ServeEngine(cfg, model, table_mode=mode, **shape)
        for r in requests():
            eng.submit(r)
        got = {r.req_id: r.generated for r in eng.run()}
        check(eng.sched.stats["admitted"] > p["max_batch"],
              "jamba parity: no slot was reused")
        check(got == want, f"{JAMBA} table_mode {mode}: engine {got} != "
                           f"greedy_reference {want}")
    print(f"{JAMBA} parity (smoke width, float32, {p['requests']} requests "
          f"on {p['max_batch']} slots): engine streams equal "
          f"greedy_reference in table modes auto, flat, radix")
    cpu_model = copy.deepcopy(model).cpu()
    prompt = torch.tensor(requests()[0].prompt[None])
    kw = dict(kv_mode=BT.FLAT, max_len=p["max_len"],
              page_size=p["page_size"])
    logits_gpu, _ = prefill(model, cfg, prompt.cuda(), **kw)
    logits_cpu, _ = prefill(cpu_model, cfg, prompt, **kw)
    diff = float((logits_gpu.cpu() - logits_cpu).abs().max())
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits")
    check(diff <= LOGIT_TOL, f"{JAMBA} card vs CPU logits differ by {diff}")
    raw = DATA.SyntheticLM(cfg.vocab_size, 64, 4).batch_at(0)
    losses = {}
    SS.launches_fwd = SS.launches_bwd = 0
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        state = TrainState(trainable(m), adamw_init(
            dict(m.named_parameters())), 0)
        step = make_train_step(cfg, AdamWConfig(total_steps=3), 2)
        _, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                  for k, v in raw.items()})
        losses[dev] = (metrics["loss"], metrics["aux"])
    mamba_layers = sum(b.mamba for b in model.stack.layers)
    scan = (SS.launches_fwd, SS.launches_bwd)
    check(scan == (2 * mamba_layers, 2 * mamba_layers),
          f"smoke train step: selective_scan launches {scan}, want one "
          f"each per Mamba layer and microbatch")
    loss_diff = abs(losses["cuda"][0] - losses["cpu"][0])
    check(bool(np.isfinite(losses["cuda"][0])), "non-finite loss")
    check(loss_diff <= TRAIN_LOSS_TOL, f"{JAMBA} card vs CPU first-step "
                                       f"loss differ by {loss_diff}")
    print(f"{JAMBA} parity card vs CPU: prefill logits "
          f"{tuple(logits_gpu.shape)} max_abs_diff {diff:.3e} (tol "
          f"{LOGIT_TOL:g}); first train step loss card "
          f"{losses['cuda'][0]:.6f} CPU {losses['cpu'][0]:.6f}, diff "
          f"{loss_diff:.3e} (tol {TRAIN_LOSS_TOL:g}), aux card "
          f"{losses['cuda'][1]:.6f} CPU {losses['cpu'][1]:.6f}; "
          f"selective_scan launches fwd {scan[0]}, bwd {scan[1]} (N 4)")
    del model, cpu_model
    torch.cuda.empty_cache()
    return {"logits": diff, "loss": loss_diff}


def phase_jamba_serve() -> dict:
    """13c: the serve cut at full width in bf16 served through the
    engine in the flat and the radix table mode: the attention layer of
    every step through the paged kernel (1 x steps launches), the Mamba
    layers' single-step update in plain torch, the same tokens in both
    modes."""
    cfg = jamba_cut("serve")
    p = JAMBA_SERVE
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    print(f"{JAMBA} serve cut ({cfg.num_layers} of "
          f"{C.get_arch(JAMBA).num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params): random weights in "
          f"{time.perf_counter() - t0:.1f} s")
    attn_layers = sum(not b.mamba for b in model.stack.layers)
    launches, tokens = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        eng = ServeEngine(cfg, model, max_batch=p["max_batch"],
                          max_len=p["max_len"], page_size=p["page_size"],
                          table_mode=mode, device="cuda")
        for r in SERVE.make_requests(p["requests"], cfg.vocab_size,
                                     p["prompt"], p["new_tokens"], seed=0):
            eng.submit(r)
        PA.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n, steps = PA.launches, eng.sched.stats["steps"]
        serve_checks(cfg, done, p["requests"], p["new_tokens"],
                     f"{JAMBA} {mode}")
        check(n == attn_layers * steps and n > 0,
              f"{mode}: paged_attention launches {n} != {attn_layers} "
              f"attention layer(s) x {steps} steps")
        generated = sum(len(r.generated) for r in done)
        prompts = sum(len(r.prompt) for r in done)
        print(f"serve {JAMBA} {mode} (full width, {cfg.num_layers} layers: "
              f"{cfg.num_layers - attn_layers} Mamba, {attn_layers} "
              f"attention; {cfg.moe.num_experts} experts top "
              f"{cfg.moe.num_experts_per_tok}; {cfg.param_count() / 1e9:.2f}"
              f" B params, bf16): {len(done)} requests, {prompts} prompt + "
              f"{generated} generated tokens in {steps} steps, {secs:.3f} s;"
              f" {generated / secs:.1f} generated tokens/s, "
              f"{(prompts + generated) / secs:.1f} tokens/s in all; "
              f"{secs / steps * 1e3:.3f} ms/step; paged_attention launches "
              f"{n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches[mode] = n
        tokens[mode] = {r.req_id: list(r.generated) for r in done}
        del eng
    check(tokens[BT.FLAT] == tokens[BT.RADIX],
          f"{JAMBA} flat and radix tables generated different tokens")
    print(f"serve {JAMBA}: flat and radix tables generate the same tokens")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_jamba_train() -> dict:
    """13d: the train cut at full width: 3 steps of one 4,096-token
    sequence, bf16 gradients and float32 AdamW moments, the Mamba layer
    through the selective-scan kernels and the attention layer through
    the sm90 flash kernels (forward twice a step with the recompute of
    activation checkpointing, backward once)."""
    cfg = jamba_cut("train")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, 0, "cuda")
    step = make_train_step(cfg, AdamWConfig(total_steps=3), 1)
    SS.launches_fwd = SS.launches_bwd = 0
    zero_flash_counts()
    hist = []
    for i in range(3):
        raw = DATA.SyntheticLM(cfg.vocab_size, 4096, 1).batch_at(i)
        batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        metrics["seconds"] = time.perf_counter() - t0
        hist.append(metrics)
    scan = (SS.launches_fwd, SS.launches_bwd)
    sm90 = (FA.launches_sm90_fwd, FA.launches_sm90_bwd)
    for m in hist:
        for key in ("loss", "grad_norm", "aux"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    check(scan == (6, 3), f"selective_scan launches (fwd, bwd) {scan} != "
                          f"(6, 3)")
    check(sm90 == (FA.launches_fwd, FA.launches_bwd) == (6, 3),
          f"sm90 flash_attention launches (fwd, bwd) {sm90} != (6, 3)")
    secs = [m["seconds"] for m in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    raw = DATA.SyntheticLM(cfg.vocab_size, 4096, 1).batch_at(3)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    print(f"train {JAMBA}: a fourth step under torch.profiler, "
          f"{traced:.3f} s:")
    print_profile(prof, traced)
    print(f"train {JAMBA} (full width, 2 layers: mamba+ff, attn+moe with "
          f"{cfg.moe.num_experts} of 16 experts, top "
          f"{cfg.moe.num_experts_per_tok}; {cfg.param_count() / 1e9:.2f} B "
          f"params, bf16 gradients, float32 AdamW moments): 3 steps of 1 x "
          f"4096 tokens; losses {[round(m['loss'], 4) for m in hist]}, aux "
          f"{[round(m['aux'], 4) for m in hist]}, grad_norms "
          f"{[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(secs[1:]):.3f} s/step and "
          f"{4096 / np.mean(secs[1:]):.1f} tokens/s after the first; "
          f"selective_scan launches fwd {scan[0]}, bwd {scan[1]}; "
          f"flash_attention sm90 launches fwd {sm90[0]}, bwd {sm90[1]}; "
          f"peak memory {peak:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return {"scan": scan, "sm90": sm90, "peak_gib": peak,
            "train": train_run(cfg, 1, 4096, 1, secs)}


# ---------------------------------------------------------------------------
# phase 14: RWKV6 (rwkv6-3b)
# ---------------------------------------------------------------------------
RWKV = "rwkv6-3b"
#: 14a: the WKV kernels' cases (B, S, heads, head size): rwkv6-3b's
#: training call (B 2, S 4,096 = 16 chunks, 40 heads of 64), then S 1,
#: a ragged 17 (not a whole 32-step forward tile or 8-step backward
#: sub-chunk), exactly one chunk (256) and two (512), B 1, and the
#: smoke width's head size 16; the decay's ``w0`` is -0.5 (w about
#: 0.2-0.8, a state forgets within about 10 steps)
WKV_CASES = {
    "rwkv6_train": (2, 4096, 40, 64),
    "s1": (2, 1, 40, 64),
    "s17": (2, 17, 8, 64),
    "s256_b1": (1, 256, 40, 64),
    "s512_b1": (1, 512, 40, 64),
    "hs16_s512": (2, 512, 4, 16),
    "hs16_s17_b3": (3, 17, 4, 16),
}
#: 14a's slow-decay cases, ``w0`` -6 (w about 0.997): a state sums
#: hundreds of steps and the backward's G crosses the 256-step chunks at
#: nearly full weight, at the training call and at two chunks.  Outputs
#: near 0 then come from float32 sums of terms of |S| in the tens, where
#: the plain float32 loop itself misses an elementwise 2e-5 against a
#: float64 one; so the forward (o and the chunk states) is held to
#: WKV_TOL of its largest element, as the backward is everywhere, and
#: the kernel's and the plain loop's errors against the float64 loop
#: are printed
WKV_SLOW_CASES = {"slow_train": (2, 4096, 40, 64),
                  "slow_s512_b1": (1, 512, 40, 64)}
WKV_SLOW_W0 = -6.0
#: 14a's underflowing-decay case, ``w0`` +2 (w about 6e-4), at the
#: training call: a chunk's decay and most products of w inside it are
#: exactly 0 in float32, which the stages must carry without 0 x inf or
#: NaN; held as the slow cases are
WKV_UNDERFLOW_CASES = {"underflow_train": (2, 4096, 40, 64)}
WKV_UNDERFLOW_W0 = 2.0
#: each stage's kernels, by the names torch.profiler gives them
WKV_STAGES = {"fwd": (("F1 chunk walks", "wkv_chunk_kernel<64, false>"),
                      ("F2 chain", "wkv_chain_kernel<false>"),
                      ("F3 chunks from their states", "wkv_fwd_kernel<64>")),
              "bwd": (("B1 chunk walks", "wkv_chunk_kernel<64, true>"),
                      ("B2 chain", "wkv_chain_kernel<true>"),
                      ("B3 chunks from their states", "wkv_bwd_kernel<64>"),
                      ("du fold", "wkv_du_kernel"))}
#: the WKV kernels against their plain versions: the forward (and its
#: chunk states) allclose at the float32 2e-5 (atol = rtol); the
#: backward's five gradients to 2e-5 of their largest element (du sums
#: over B x S steps and dr, dk, dw over 64 columns, in other orders),
#: against wkv_bwd_ref and against autograd of the plain forward
WKV_TOL = 2e-5
#: 14b: smoke width in float32 (2 layers, head size 16): 4 requests on 2
#: slots (slots reused), and one 2 x 512-token batch (two scan chunks)
#: for logits, loss and gradients card vs CPU
RWKV_PARITY = dict(MOE_PARITY, requests=4)
RWKV_PARITY_TOKENS = (2, 512)
#: 14c: the serve's depth, cut from 32 layers to keep the script within
#: its time (its two full-depth serves took 66.5-96.9 s, at 16 layers
#: 38.9 s); every layer is the same RWKV block
RWKV_SERVE_LAYERS = 4
#: 14d trains rwkv6-3b at 8 of its 32 layers: the script's time (the cut
#: pays for phase 17's two-rank runs, about 90 s on the card; 14d was the
#: largest training path, 62 s at full depth); every layer is the same
#: RWKV block
RWKV_TRAIN_LAYERS = 8


def wkv_inputs(b, s, h, hs, seed, w0=-0.5):
    """WKV operands at an RWKV layer's scale on the card: r, k, v and do
    normal, w = exp(-exp(w0 + 0.5 n)) (a decay lora's spread), u 0.1 n
    (``rwkv_init``'s)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return {"r": randn(b, s, h * hs), "k": randn(b, s, h * hs),
            "v": randn(b, s, h * hs),
            "w": torch.exp(-torch.exp(w0 + 0.5 * randn(b, s, h * hs))),
            "u": 0.1 * randn(h, hs), "do": randn(b, s, h * hs)}


def wkv_args(t):
    return [t[k] for k in ("r", "k", "v", "w", "u")]


def err_of_scale(got, want) -> float:
    """max |got - want| over max |want|."""
    return max_err(got, want) / (float(want.abs().max()) or 1.0)


def wkv_scaled_errs(got, want) -> dict:
    """Each gradient's max |got - want| over its largest |want|."""
    return {name: err_of_scale(g, w)
            for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want)}


def autograd_of_plain_wkv(t):
    leaves = [x.detach().clone().requires_grad_(True) for x in wkv_args(t)]
    o = ref.wkv_ref(*leaves)
    # at S 1 the decay reaches no output: its gradient is 0
    grads = torch.autograd.grad(o, leaves, t["do"], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    del o, leaves
    return grads


def wkv_bound(b, s, h, hs, backward: bool):
    """(ms, "bytes" or "operations"): the least time of the forward or
    the backward.  Bytes: each input read once and each output written
    once (forward: r, k, v, w, u in, o and the chunk states out;
    backward: those inputs, the states and do in, dr, dk, dv, dw, du
    out).  Operations: ``RC.WKV_FLOPS`` a state element and step at the
    card's float32 rate outside the tensor cores."""
    elems = b * s * h * hs
    states = b * -(-s // ref.SCAN_CHUNK) * h * hs * hs
    nbytes = 4 * ((9 if backward else 5) * elems + states
                  + (2 if backward else 1) * h * hs)
    flops = RC.wkv_flops(elems, hs, backward)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / RC.FP32_SIMT_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def wkv_close(got, want, scaled: bool) -> tuple:
    """(ok, note): allclose WKV_TOL, or with ``scaled`` within WKV_TOL of
    the largest element."""
    if scaled:
        err = err_of_scale(got, want)
        return err <= WKV_TOL, f"{err:.2e} of scale"
    return within(got, want, WKV_TOL), f"max_abs_err {max_err(got, want):.3e}"


def wkv_stage_split(direction: str, fn, chain, calls: int = 3) -> None:
    """Each stage's device time over ``calls`` calls of the forward or the
    backward (torch.profiler, L2 warm), printed, not gated; fails if the
    profiler saw kernels but not a stage's.  Where it records no kernel
    at all, the first two stages (``chain``) and the rest are timed apart
    by CUDA events instead."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    if not kernels:
        whole, first = time_cold_ms(fn, calls), time_cold_ms(chain, calls)
        print(f"wkv {direction} by stage (CUDA events, L2 flushed; "
              f"torch.profiler recorded no kernel): the chunk walks and "
              f"the chain {first:.4f} ms, the rest {whole - first:.4f} ms")
        return
    stages = {}
    for label, name in WKV_STAGES[direction]:
        hits = [ms for k, ms in kernels.items() if name in k]
        check(bool(hits), f"the wkv {direction} ran no {name} (recorded: "
                          f"{sorted(kernels)})")
        stages[label] = sum(hits)
    total = sum(stages.values())
    print(f"wkv {direction} by stage (torch.profiler, {calls} calls, L2 "
          f"warm): {total:.4f} ms a call: "
          + ", ".join(f"{k} {ms:.4f} ms ({ms / total:.1%})"
                      for k, ms in stages.items()))


def phase_wkv_kernel() -> dict:
    """14a: the WKV kernels, forward and backward, against their plain
    versions on the card, and timed at rwkv6-3b's training call."""
    for line in ptxas_lines("wkv", ("wkv_chunk_kernel", "wkv_chain_kernel",
                                    "wkv_fwd_kernel", "wkv_bwd_kernel",
                                    "wkv_du_kernel")):
        print(f"  wkv ptxas: {line}")
    for hs in WK.HEAD_SIZES:
        occ = WK.occupancy(hs)
        print(f"wkv occupancy at head size {hs}: " + "; ".join(
            f"{name} {o['threads']} threads, {o['registers']} registers, "
            f"{o['local_bytes']} local bytes, {o['blocks_per_sm']} blocks "
            f"and {o['blocks_per_sm'] * o['threads'] / 32:g} warps an SM"
            for name, o in occ.items())
            + f"; B3 clusters on the card {occ['b3']['clusters']}")
    # (max |got - want|, the worst of max |got - want| over max |want|)
    errs = {"fwd": (0.0, 0.0), "bwd": (0.0, 0.0)}
    cases = [(name, shape, -0.5) for name, shape in WKV_CASES.items()]
    cases += [(name, shape, WKV_SLOW_W0)
              for name, shape in WKV_SLOW_CASES.items()]
    cases += [(name, shape, WKV_UNDERFLOW_W0)
              for name, shape in WKV_UNDERFLOW_CASES.items()]
    for name, (b, s, h, hs), w0 in cases:
        scaled = w0 != -0.5
        t = wkv_inputs(b, s, h, hs, seed=len(name), w0=w0)
        o, st = WK.forward(*wkv_args(t))
        want_o, want_st = ref.wkv_ref(*wkv_args(t), return_states=True)
        o_err, st_err = max_err(o, want_o), max_err(st, want_st)
        o_sc, st_sc = err_of_scale(o, want_o), err_of_scale(st, want_st)
        fwd_ok = all(wkv_close(got, want, scaled)[0]
                     for got, want in ((o, want_o), (st, want_st)))
        chain_ok, chain_note = wkv_close(st, ref.wkv_chunk_ref(
            t["k"], t["v"], t["w"], t["u"])[2], scaled)
        if scaled:
            o64 = ref.wkv_ref(*(x.double() for x in wkv_args(t)))
            note = (f"of scale: o {o_sc:.2e}, states {st_sc:.2e} "
                    f"({WKV_TOL:g}); elementwise allclose "
                    f"{'holds' if within(o, want_o, WKV_TOL) else 'fails'}"
                    f"; o against the float64 loop, of scale: kernel "
                    f"{err_of_scale(o.double(), o64):.2e}, plain float32 "
                    f"{err_of_scale(want_o.double(), o64):.2e}")
            del o64
        else:
            note = f"allclose {WKV_TOL:g}"
        finite = bool(torch.isfinite(o).all() and torch.isfinite(st).all())
        fwd_ok = fwd_ok and chain_ok and finite and st.shape == want_st.shape
        del want_o, want_st
        g_end = WK.chain(t["r"], t["do"], t["w"], t["u"], reverse=True)
        g_sc = err_of_scale(g_end, ref.wkv_bwd_chunk_ref(
            t["r"], t["w"], t["do"], t["u"])[2])
        del g_end
        got = WK.backward(*wkv_args(t), st, t["do"])
        again = WK.backward(*wkv_args(t), st, t["do"])
        torch.cuda.synchronize()
        same = all(torch.equal(g, x) for g, x in zip(got, again))
        finite = finite and all(bool(torch.isfinite(g).all()) for g in got)
        del again
        wants = (ref.wkv_bwd_ref(*wkv_args(t), st, t["do"]),
                 autograd_of_plain_wkv(t))
        vs_ref, vs_auto = (wkv_scaled_errs(got, want) for want in wants)
        bwd_worst = max(*vs_ref.values(), *vs_auto.values())
        bwd_abs = max(max_err(g, w) for want in wants
                      for g, w in zip(got, want))
        del wants
        ok = (fwd_ok and same and finite and bwd_worst <= WKV_TOL
              and g_sc <= WKV_TOL)
        for direction, case in (("fwd", (o_err, o_sc)),
                                ("bwd", (bwd_abs, bwd_worst))):
            errs[direction] = tuple(map(max, errs[direction], case))
        print(f"wkv {name} (B {b}, S {s}, {h} heads of {hs}, w0 {w0:g}): "
              f"forward o max_abs_err {o_err:.3e} (max |o| "
              f"{float(o.abs().max()):.3g}), chunk states {st_err:.3e} "
              f"({note}); the chain vs wkv_chunk_ref {chain_note}; "
              f"backward: G_end vs wkv_bwd_chunk_ref {g_sc:.2e} of scale; "
              f"of scale vs bwd_ref "
              + ", ".join(f"{k} {v:.2e}" for k, v in vs_ref.items())
              + "; vs autograd of the plain forward "
              + ", ".join(f"{k} {v:.2e}" for k, v in vs_auto.items())
              + f" ({WKV_TOL:g}); {'all finite' if finite else 'NOT FINITE'}"
              f"; two backwards {'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"wkv {name} disagrees with its plain version")
        del t, o, st, got
        torch.cuda.empty_cache()

    b, s, h, hs = WKV_CASES["rwkv6_train"]
    t = wkv_inputs(b, s, h, hs, seed=0)
    _, st = WK.forward(*wkv_args(t))
    timed = {}
    for direction, fn, plain, chain in (
            ("fwd", lambda: WK.forward(*wkv_args(t)),
             lambda: ref.wkv_ref(*wkv_args(t)),
             lambda: WK.chain(t["k"], t["v"], t["w"], t["u"], False)),
            ("bwd", lambda: WK.backward(*wkv_args(t), st, t["do"]),
             lambda: ref.wkv_bwd_ref(*wkv_args(t), st, t["do"]),
             lambda: WK.chain(t["r"], t["do"], t["w"], t["u"], True))):
        ms = time_cold_ms(fn, 10)
        plain_ms = time_plain_ms(plain)
        bound_ms, bound_by = wkv_bound(b, s, h, hs, direction == "bwd")
        wkv_stage_split(direction, fn, chain)
        timed[direction] = dict(max_abs_err=errs[direction][0],
                                max_err_of_scale=errs[direction][1], ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
        print(f"wkv {direction} timing at rwkv6-3b's training call (B {b}, "
              f"S {s}, {h} heads of {hs}; L2 flushed): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of bound; no PyTorch call "
              f"computes the recurrence (library: none)")
    del t, st
    torch.cuda.empty_cache()
    return timed


def wkv_times() -> None:
    """``--wkv-times``: the WKV forward and backward at rwkv6-3b's training
    call (L2 flushed), 10 calls each, twice.  It calls only what the
    port's package has had since the kernels' first design, so with
    CHIP_SMOKE_SRC it times another checkout's kernels in the same way."""
    print(f"wkv-times: the port from {WK.__file__}")
    _build.build_all(["wkv"])
    b, s, h, hs = WKV_CASES["rwkv6_train"]
    t = wkv_inputs(b, s, h, hs, seed=0)
    _, st = WK.forward(*wkv_args(t))
    for rep in range(2):
        fwd = time_cold_ms(lambda: WK.forward(*wkv_args(t)), 10)
        bwd = time_cold_ms(lambda: WK.backward(*wkv_args(t), st, t["do"]),
                           10)
        print(f"wkv-times {rep}: forward {fwd:.4f} ms, backward {bwd:.4f} ms "
              f"(B {b}, S {s}, {h} heads of {hs}; L2 flushed)")


def simt_wide_times(forward_only: bool = False) -> None:
    """``--simt-wide-times``: the float32 flash forward and backward above
    head_dim 128 at phase 8c's calls (gemma3-1b's global and local
    layers, deepseek-v2's MLA layer), and the forward at head_dim 128 at
    phase 6's simt call.  Each forward is held against the plain forward
    (allclose 2e-5, its LSE too) and run twice bit-identical; each
    backward against the plain backward from the kernel's own forward
    (2e-5 of scale) and run twice bit-identical; then each is timed (L2
    flushed, 10 calls) twice, beside its bound.  ``forward_only``
    (``--simt-wide-times --forward``) skips the backwards.  It calls only
    what the port's package has had since the float32 route took head
    dims above 128, so with CHIP_SMOKE_SRC it times another checkout's
    kernels the same way."""
    print(f"simt-wide-times: the port from {FA.__file__}")
    _build.build_all(["flash_attention"])
    for direction, design in FA.simt_design().items():
        print(f"simt-wide-times {direction} design: {design}")
    for line in ptxas_lines("flash_attention", (
            "flash_fwd_kernel", "flash_fwd_rows64_kernel",
            "flash_bwd_dkdv_kernel",
            "flash_bwd_dkdv_split_kernel", "flash_bwd_dq_kernel",
            "flash_bwd_reduce_kernel")):
        if re.search(r"<(16|24|32)>|reduce", line):
            print(f"  simt-wide-times ptxas: {line}")
    for d in (128, 192, 256):
        occ = FA.simt_occupancy(d)
        print(f"simt-wide-times occupancy at head_dim {d}: " + "; ".join(
            f"{k} {o['threads']} threads, {o['blocks_per_sm']} blocks "
            f"({o['blocks_per_sm'] * o['threads'] // 32} warps) an SM, "
            f"{o['registers']} registers, {o['local_bytes']} local bytes, "
            f"{o['smem_bytes']} B shared" for k, o in occ.items()))
    calls = {"gemma3 global": GEMMA_ATTN,
             "gemma3 window 512": dict(GEMMA_ATTN, window=512),
             "deepseek": DEEPSEEK_ATTN,
             "head_dim 128": PARITY_ATTN,
             # 8c trains one sequence a step: its gemma3-1b calls at B 1
             "gemma3 global B 1": GEMMA_F32_ATTN,
             "gemma3 window 512 B 1": dict(GEMMA_F32_ATTN, window=512)}
    f32 = torch.float32
    for name, shape in calls.items():
        case = flash_case(**shape, dtype=f32, seed=10)
        o, lse = flash_fwd("kernel", case)
        ro, rlse = flash_fwd("plain", case)
        o2, lse2 = flash_fwd("kernel", case)
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        ok = within(o, ro, TOL[f32]) and within(lse, rlse, 2e-5) and same
        rows = ""
        if hasattr(FA, "simt_fwd_plan"):    # the forward's rows a block
            rows = FA.simt_fwd_plan(*case["q"].shape, causal=case["causal"],
                                    window=case["window"])
            rows = f", {rows}-row blocks"
        print(f"simt-wide-times {name}: fwd vs plain max_abs_err "
              f"{max_err(o, ro):.3e}, lse {max_err(lse, rlse):.3e} "
              f"(allclose 2e-05), two forwards "
              f"{'bit-identical' if same else 'DIFFER'}{rows}")
        check(ok, f"the float32 forward at {name} is wrong")
        del ro, rlse, o2, lse2
        wide = shape["d"] > 128 and not forward_only
        if wide:
            grads = flash_bwd("kernel", case, o, lse)
            err = scaled_err(grads, flash_bwd("plain", case, o, lse))
            same = all(torch.equal(a, b) for a, b in
                       zip(grads, flash_bwd("kernel", case, o, lse)))
            print(f"simt-wide-times {name}: bwd vs plain of scale "
                  f"{err:.3e} (2e-05), two backwards "
                  f"{'bit-identical' if same else 'DIFFER'}")
            check(err <= FLASH_BWD_TOL[f32] and same,
                  f"the float32 backward at {name} is wrong")
            del grads
            if hasattr(FA, "simt_bwd_plan"):    # the split dK/dV plan
                backward_split(
                    "simt", lambda: flash_bwd("kernel", case, o, lse),
                    FA.simt_bwd_plan(*case["q"].shape[:3],
                                     case["k"].shape[2], case["q"].shape[3],
                                     causal=case["causal"],
                                     window=case["window"])["splits"])
        for backward in (False, True)[:1 + wide]:
            bound_ms, bound_by = flash_bound(case, backward)
            what = "backward" if backward else "forward"
            run = ((lambda: flash_bwd("kernel", case, o, lse)) if backward
                   else (lambda: flash_fwd("kernel", case)))
            for rep in range(2):
                ms = time_cold_ms(run, 10)
                print(f"simt-wide-times {name} {rep}: {what} {ms:.4f} ms, "
                      f"bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{bound_ms / ms:.1%} of bound (L2 flushed)")
        del case, o, lse
        torch.cuda.empty_cache()


def phase_rwkv_parity() -> dict:
    """14b: rwkv6-3b at smoke width in float32 (2 layers, head size 16):
    the engine's streams equal greedy_reference's in every table mode
    with slots reused; the card's logits, loss and gradients on a
    512-token batch agree with the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = RWKV_PARITY
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(RWKV)),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = init_params(cfg, gen, "cuda")
    shape = dict(max_batch=p["max_batch"], max_len=p["max_len"],
                 page_size=p["page_size"], device="cuda")

    def requests():
        return SERVE.make_requests(p["requests"], cfg.vocab_size,
                                   p["prompt"], p["new_tokens"], seed=7)

    want = {r.req_id: greedy_reference(
        cfg, model, r.prompt, p["new_tokens"], kv_mode=BT.FLAT,
        max_len=p["max_len"], page_size=p["page_size"], device="cuda")
        for r in requests()}
    for mode in (None, BT.FLAT, BT.RADIX):
        eng = ServeEngine(cfg, model, table_mode=mode, **shape)
        for r in requests():
            eng.submit(r)
        got = {r.req_id: r.generated for r in eng.run()}
        check(eng.sched.stats["admitted"] > p["max_batch"],
              "rwkv parity: no slot was reused")
        check(got == want, f"{RWKV} table_mode {mode}: engine {got} != "
                           f"greedy_reference {want}")
    print(f"{RWKV} parity (smoke width, float32, {p['requests']} requests "
          f"on {p['max_batch']} slots): engine streams equal "
          f"greedy_reference in table modes auto, flat, radix")
    cpu_model = copy.deepcopy(model).cpu()
    b, s = RWKV_PARITY_TOKENS
    raw = DATA.SyntheticLM(cfg.vocab_size, s, b).batch_at(0)
    out = {}
    WK.launches_fwd = WK.launches_bwd = 0
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        m = trainable(m)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        logits, _ = forward_train(m, cfg, batch)
        loss, _ = loss_fn(m, cfg, batch)
        loss.backward()
        out[dev] = (logits.detach().cpu(), float(loss.detach()),
                    {n: q.grad.detach().cpu() for n, q in
                     m.named_parameters()})
    wkv = (WK.launches_fwd, WK.launches_bwd)
    layers = cfg.num_layers
    check(wkv == (2 * layers, layers), f"smoke parity: wkv launches {wkv}, "
                                       f"want ({2 * layers}, {layers})")
    logit_diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    loss_diff = abs(out["cuda"][1] - out["cpu"][1])
    grad_errs = {n: float((g - out["cpu"][2][n]).abs().max())
                 / (float(out["cpu"][2][n].abs().max()) or 1.0)
                 for n, g in out["cuda"][2].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(bool(torch.isfinite(out["cuda"][0]).all()), "non-finite logits")
    check(logit_diff <= LOGIT_TOL, f"{RWKV} card vs CPU logits differ by "
                                   f"{logit_diff}")
    check(loss_diff <= TRAIN_LOSS_TOL, f"{RWKV} card vs CPU loss differ by "
                                       f"{loss_diff}")
    check(grad_errs[worst] <= TRAIN_GRAD_TOL,
          f"{RWKV} card vs CPU gradient {worst} differs by "
          f"{grad_errs[worst]:.3e} of its scale")
    print(f"{RWKV} parity card vs CPU ({b} x {s} tokens, two scan chunks): "
          f"logits max_abs_diff {logit_diff:.3e} (tol {LOGIT_TOL:g}); loss "
          f"card {out['cuda'][1]:.6f} CPU {out['cpu'][1]:.6f}, diff "
          f"{loss_diff:.3e} (tol {TRAIN_LOSS_TOL:g}); gradients of scale: "
          f"worst {worst} {grad_errs[worst]:.3e} over {len(grad_errs)} "
          f"(tol {TRAIN_GRAD_TOL:g}); wkv launches fwd {wkv[0]}, bwd "
          f"{wkv[1]} (head size 16)")
    del model, cpu_model, out
    torch.cuda.empty_cache()
    return {"logits": logit_diff, "loss": loss_diff,
            "grad": grad_errs[worst]}


def phase_rwkv_serve() -> dict:
    """14c: full-width rwkv6-3b (bf16) at :data:`RWKV_SERVE_LAYERS` of
    its 32 layers served through the launcher at phase 4's shape in the
    flat and the radix table mode: no layer holds a KV cache, so no step
    launches the paged kernel; both modes give the same tokens."""
    full = C.get_arch(RWKV)
    cut = dataclasses.replace(full, num_layers=RWKV_SERVE_LAYERS)
    launches, tokens = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        args = SERVE.build_parser().parse_args(["--arch", RWKV,
                                                "--kv-mode", mode])
        torch.cuda.reset_peak_memory_stats()
        PA.launches = 0
        WK.launches_fwd = WK.launches_bwd = 0
        with mock.patch.object(SERVE.C, "get_arch",
                               lambda name, get=C.get_arch:
                               cut if name == RWKV else get(name)):
            out = SERVE.serve(args)
        n = PA.launches
        cfg, eng, done = out["cfg"], out["engine"], out["done"]
        steps = eng.sched.stats["steps"]
        serve_checks(cfg, done, args.requests, SERVE.FULL["new_tokens"],
                     f"{RWKV} {mode}")
        check(n == 0, f"{mode}: paged_attention launches {n} != 0 (rwkv6-3b "
                      f"has no attention layer)")
        generated = sum(len(r.generated) for r in done)
        prompts = sum(len(r.prompt) for r in done)
        secs = out["seconds"]
        check(cfg.num_layers == RWKV_SERVE_LAYERS,
              f"{RWKV} served {cfg.num_layers} layers")
        print(f"serve {RWKV} {mode} (full width, {cfg.num_layers} of "
              f"{full.num_layers} layers, {cfg.param_count() / 1e9:.2f} B "
              f"params, {cfg.dtype}): "
              f"{len(done)} requests, {prompts} prompt + {generated} "
              f"generated tokens in {steps} steps, {secs:.3f} s; "
              f"{generated / secs:.1f} generated tokens/s, "
              f"{(prompts + generated) / secs:.1f} tokens/s in all; "
              f"{secs / steps * 1e3:.3f} ms/step; paged_attention launches "
              f"{n}, wkv launches {WK.launches_fwd} (decode is the "
              f"single-step update); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches[mode] = n
        tokens[mode] = {r.req_id: list(r.generated) for r in done}
        del out, eng
        torch.cuda.empty_cache()
    check(tokens[BT.FLAT] == tokens[BT.RADIX],
          f"{RWKV} flat and radix tables generated different tokens")
    print(f"serve {RWKV}: flat and radix tables generate the same tokens")
    return launches


def phase_rwkv_train() -> dict:
    """14d: full-width rwkv6-3b at :data:`RWKV_TRAIN_LAYERS` of its 32
    layers trained through the launcher (``--layers``) at phase 7's
    shape (8 x 4,096 tokens in 4 microbatches, 3 steps),
    bf16 gradients and float32 AdamW moments, every layer's recurrence
    through the WKV kernels (forward twice a step with the recompute of
    activation checkpointing, backward once); then a fourth step under
    torch.profiler."""
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = TRAIN.build_parser().parse_args(
        ["--arch", RWKV, "--layers", str(RWKV_TRAIN_LAYERS),
         "--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    WK.launches_fwd = WK.launches_bwd = 0
    FA.launches_fwd = FA.launches_bwd = 0
    out = TRAIN.train(args)
    wkv = (WK.launches_fwd, WK.launches_bwd)
    cfg, hist, shape = out["cfg"], out["history"], out["shape"]
    micro = out["microbatches"]
    check(len(hist) == args.steps, f"trained {len(hist)} of {args.steps} "
                                   "steps")
    for m in hist:
        for key in ("loss", "grad_norm"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    check(cfg.num_layers == RWKV_TRAIN_LAYERS,
          f"14d trained {cfg.num_layers} layers")
    want = (2 * cfg.num_layers * micro * args.steps,
            cfg.num_layers * micro * args.steps)
    check(wkv == want, f"wkv launches (fwd, bwd) {wkv} != {want}")
    check((FA.launches_fwd, FA.launches_bwd) == (0, 0),
          "rwkv6-3b launched flash attention")
    tokens = shape.global_batch * shape.seq_len
    secs = [m["seconds"] for m in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    raw = DATA.SyntheticLM(cfg.vocab_size, shape.seq_len,
                           shape.global_batch).batch_at(args.steps)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    step = make_train_step(cfg, AdamWConfig(total_steps=args.steps + 1),
                           micro)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(out["state"], batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    print(f"train {RWKV}: a fourth step under torch.profiler, "
          f"{traced:.3f} s:")
    print_profile(prof, traced)
    print(f"train {RWKV} (full width, {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params, bf16 weights and "
          f"gradients, float32 AdamW moments): {args.steps} steps of "
          f"{shape.global_batch} x {shape.seq_len} tokens in {micro} "
          f"microbatches; losses {[round(m['loss'], 4) for m in hist]}, "
          f"grad_norms {[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(secs[1:]):.3f} s/step and "
          f"{tokens / np.mean(secs[1:]):.1f} tokens/s after the first; "
          f"wkv launches fwd {wkv[0]}, bwd {wkv[1]}; peak memory "
          f"{peak:.2f} GiB")
    del out, step
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"wkv": wkv, "peak_gib": peak,
            "train": train_run(cfg, shape.global_batch, shape.seq_len,
                               micro, secs)}


# ---------------------------------------------------------------------------
# phase 15: whisper-tiny, the encoder-decoder
# ---------------------------------------------------------------------------
WHISPER = "whisper-tiny"
#: 15a: smoke width in float32 card vs CPU, a 2 x 512-token batch (the
#: smoke config's 16 stub frames); then the decode check on its first
#: 16 tokens
WHISPER_PARITY_TOKENS = (2, 512)
WHISPER_DECODE_TOKENS = 16
#: decode after prefill against the training forward's last position:
#: the JAX package's own invariant (tests/test_models.py, rtol = atol)
WHISPER_DECODE_TOL = 2e-4
#: 15c: the audio path at full width: 4 sequences of 1,500 stub frames,
#: a 64-token prompt and 32 greedy decode steps
WHISPER_AUDIO = dict(batch=4, prompt=64, new_tokens=32, max_len=128,
                     page_size=16)


def phase_whisper_parity() -> dict:
    """15a: whisper-tiny at smoke width in float32: the card's logits,
    loss and gradients on a 2 x 512-token batch with the audio stubs
    against the CPU's; then ``prefill(audio_frames=)`` and one
    ``decode_step`` on the card in every KV mode against the training
    forward's last position."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(WHISPER)),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(8)
    model = init_params(cfg, gen, "cuda")
    cpu_model = copy.deepcopy(model).cpu()
    b, s = WHISPER_PARITY_TOKENS
    raw = DATA.add_modality_stubs(
        DATA.SyntheticLM(cfg.vocab_size, s, b).batch_at(0), cfg)
    out = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        m = trainable(m)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        logits, _ = forward_train(m, cfg, batch)
        loss, _ = loss_fn(m, cfg, batch)
        loss.backward()
        out[dev] = (logits.detach().cpu(), float(loss.detach()),
                    {n: q.grad.detach().cpu() for n, q in
                     m.named_parameters()})
        m.requires_grad_(False)
    logit_diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    loss_diff = abs(out["cuda"][1] - out["cpu"][1])
    grad_errs = {n: float((g - out["cpu"][2][n]).abs().max())
                 / (float(out["cpu"][2][n].abs().max()) or 1.0)
                 for n, g in out["cuda"][2].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(bool(torch.isfinite(out["cuda"][0]).all()), "non-finite logits")
    check(logit_diff <= LOGIT_TOL, f"{WHISPER} card vs CPU logits differ "
                                   f"by {logit_diff}")
    check(loss_diff <= TRAIN_LOSS_TOL, f"{WHISPER} card vs CPU loss differ "
                                       f"by {loss_diff}")
    check(grad_errs[worst] <= TRAIN_GRAD_TOL,
          f"{WHISPER} card vs CPU gradient {worst} differs by "
          f"{grad_errs[worst]:.3e} of its scale")
    check(any(n.startswith("encoder.") for n in grad_errs)
          and any(".cross." in n for n in grad_errs),
          "the parity run held no encoder or cross-attention gradient")
    print(f"{WHISPER} parity card vs CPU (smoke width, float32, {b} x {s} "
          f"tokens, {cfg.encoder_seq_len} stub frames): logits "
          f"max_abs_diff {logit_diff:.3e} (tol {LOGIT_TOL:g}); loss card "
          f"{out['cuda'][1]:.6f} CPU {out['cpu'][1]:.6f}, diff "
          f"{loss_diff:.3e} (tol {TRAIN_LOSS_TOL:g}); gradients of scale: "
          f"worst {worst} {grad_errs[worst]:.3e} over {len(grad_errs)} "
          f"(tol {TRAIN_GRAD_TOL:g})")
    n = WHISPER_DECODE_TOKENS
    toks = torch.from_numpy(raw["tokens"][:, :n]).cuda()
    frames = torch.from_numpy(raw["audio_frames"]).cuda()
    with torch.no_grad():
        ref, _ = forward_train(model, cfg, {"tokens": toks,
                                            "audio_frames": frames})
    errs = {}
    PA.launches = 0
    for mode in ("dense", BT.FLAT, BT.RADIX):
        _, st = prefill(model, cfg, toks[:, :-1].int(), kv_mode=mode,
                        max_len=32, page_size=4, audio_frames=frames)
        last, _ = decode_step(model, cfg, st, toks[:, -1].int(),
                              kv_mode=mode)
        check(within(last, ref[:, -1], WHISPER_DECODE_TOL),
              f"{WHISPER} {mode}: decode after prefill differs from "
              f"forward_train's last position by "
              f"{max_err(last, ref[:, -1]):.3e}")
        errs[mode] = max_err(last, ref[:, -1])
    want = 2 * n * cfg.num_layers
    check(PA.launches == want, f"{WHISPER} parity: paged_attention "
                               f"launches {PA.launches} != {want}")
    print(f"{WHISPER} decode on the card (prefill of {n - 1} tokens with "
          f"the audio frames, then a decode_step) against forward_train's "
          f"last position: max_abs_err "
          + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
          + f" (allclose {WHISPER_DECODE_TOL:g}); paged_attention launches "
          f"{PA.launches}")
    del model, cpu_model, out
    torch.cuda.empty_cache()
    return {"logits": logit_diff, "loss": loss_diff,
            "grad": grad_errs[worst], "decode": errs}


def phase_whisper_serve() -> dict:
    """15b: full-width whisper-tiny (4 + 4 layers, bf16) served through
    the launcher at phase 4's shape in the flat and the radix table
    mode: every decoder layer of every step through the paged kernel at
    6 / 6 heads of 64, the cross-attention over the decode state's zero
    encoder output (the engine has no audio path, as the JAX engine has
    none); both modes give the same tokens."""
    launches, tokens = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        args = SERVE.build_parser().parse_args(["--arch", WHISPER,
                                                "--kv-mode", mode])
        torch.cuda.reset_peak_memory_stats()
        PA.launches = 0
        out = SERVE.serve(args)
        n = PA.launches
        cfg, eng, done = out["cfg"], out["engine"], out["done"]
        steps = eng.sched.stats["steps"]
        serve_checks(cfg, done, args.requests, SERVE.FULL["new_tokens"],
                     f"{WHISPER} {mode}")
        check(n == cfg.num_layers * steps and n > 0,
              f"{mode}: paged_attention launches {n} != {cfg.num_layers} "
              f"layers x {steps} steps")
        enc = eng.state["enc_out"]
        check(enc.dtype == torch.bfloat16 and not bool(enc.any()),
              "the engine's encoder output is not the zero bf16 state")
        generated = sum(len(r.generated) for r in done)
        prompts = sum(len(r.prompt) for r in done)
        secs = out["seconds"]
        print(f"serve {WHISPER} {mode} (full width, {cfg.encoder_layers} + "
              f"{cfg.num_layers} layers, {cfg.param_count() / 1e6:.2f} M "
              f"params, {cfg.dtype}): {len(done)} requests, {prompts} "
              f"prompt + {generated} generated tokens in {steps} steps, "
              f"{secs:.3f} s; {generated / secs:.1f} generated tokens/s, "
              f"{(prompts + generated) / secs:.1f} tokens/s in all; "
              f"{secs / steps * 1e3:.3f} ms/step; paged_attention launches "
              f"{n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        launches[mode] = n
        tokens[mode] = {r.req_id: list(r.generated) for r in done}
        del out, eng
        torch.cuda.empty_cache()
    check(tokens[BT.FLAT] == tokens[BT.RADIX],
          f"{WHISPER} flat and radix tables generated different tokens")
    print(f"serve {WHISPER}: flat and radix tables generate the same tokens")
    return launches


def phase_whisper_audio() -> dict:
    """15c: the audio path at full width: ``prefill(audio_frames=)`` of
    4 prompts with 1,500 stub frames each and 32 greedy decode steps in
    the flat and the radix mode (every decoder layer of every step
    through the paged kernel; the same tokens); then a float32 copy of
    the model, whose prefill's last logits equal ``forward_train``'s
    last position within 2e-4."""
    p = WHISPER_AUDIO
    cfg = C.get_arch(WHISPER)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(cfg, gen, "cuda")
    raw = DATA.add_modality_stubs(DATA.SyntheticLM(
        cfg.vocab_size, p["prompt"], p["batch"]).batch_at(0), cfg)
    toks = torch.from_numpy(raw["tokens"]).cuda()
    frames = torch.from_numpy(raw["audio_frames"]).cuda()
    check(tuple(frames.shape) == (p["batch"], cfg.encoder_seq_len,
                                  cfg.d_model),
          f"audio stubs of shape {tuple(frames.shape)}")
    tokens, launches = {}, {}
    for mode in (BT.FLAT, BT.RADIX):
        torch.cuda.reset_peak_memory_stats()
        PA.launches = 0
        t0 = time.perf_counter()
        logits, st = prefill(model, cfg, toks, kv_mode=mode,
                             max_len=p["max_len"],
                             page_size=p["page_size"], audio_frames=frames)
        check(st["enc_out"].dtype == torch.float32,
              f"the encoder output is {st['enc_out'].dtype}, not float32 "
              f"(float32 frames through bf16 weights promote)")
        out = []
        for _ in range(p["new_tokens"]):
            tok = torch.argmax(logits, dim=-1).int()
            out.append(tok)
            logits, st = decode_step(model, cfg, st, tok, kv_mode=mode)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = p["prompt"] + p["new_tokens"]
        n = PA.launches
        check(n == cfg.num_layers * steps,
              f"{mode}: paged_attention launches {n} != {cfg.num_layers} "
              f"layers x {steps} steps")
        gen_toks = torch.stack(out, dim=1).cpu()
        check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
              "a generated token lies outside the vocabulary")
        tokens[mode], launches[mode] = gen_toks, n
        print(f"{WHISPER} audio path {mode} (full width, bf16, {p['batch']} "
              f"x {frames.shape[1]} stub frames, prompt {p['prompt']}, "
              f"{p['new_tokens']} greedy steps): {steps} decode steps in "
              f"{secs:.3f} s, {secs / steps * 1e3:.3f} ms/step (the encoder "
              f"once, its K/V recomputed in each layer and step); "
              f"paged_attention launches {n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(torch.equal(tokens[BT.FLAT], tokens[BT.RADIX]),
          f"{WHISPER} audio path: flat and radix generated different tokens")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = copy.deepcopy(model).float()
    with torch.no_grad():
        ref, _ = forward_train(f32, f32cfg, {"tokens": toks,
                                             "audio_frames": frames})
    last, _ = prefill(f32, f32cfg, toks, kv_mode=BT.FLAT,
                      max_len=p["max_len"], page_size=p["page_size"],
                      audio_frames=frames)
    err = max_err(last, ref[:, -1])
    check(within(last, ref[:, -1], WHISPER_DECODE_TOL),
          f"{WHISPER} float32 full width: prefill's last logits differ from "
          f"forward_train's by {err:.3e}")
    print(f"{WHISPER} audio path: flat and radix generate the same tokens; "
          f"float32 copy at full width: prefill's last logits against "
          f"forward_train's last position max_abs_err {err:.3e} (allclose "
          f"{WHISPER_DECODE_TOL:g})")
    del model, f32, st
    torch.cuda.empty_cache()
    return {"launches": launches, "f32_err": err}


def phase_whisper_train() -> dict:
    """15d: full-width whisper-tiny trained through the launcher at
    phase 7's shape (8 x 4,096 tokens in 4 microbatches, 1,500 stub
    frames a sequence, 3 steps): every decoder layer's self-attention
    through the sm90 flash kernels (forward twice a step with the
    recompute of activation checkpointing, backward once), the encoder's
    1,500 frames and the cross-attention on the masked softmax (no
    flash launch); then a fourth step under torch.profiler."""
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = TRAIN.build_parser().parse_args(["--arch", WHISPER,
                                            "--ckpt-dir", ckpt_dir])
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    out = TRAIN.train(args)
    sm90 = (FA.launches_sm90_fwd, FA.launches_sm90_bwd)
    total = (FA.launches_fwd, FA.launches_bwd)
    cfg, hist, shape = out["cfg"], out["history"], out["shape"]
    micro = out["microbatches"]
    check(len(hist) == args.steps, f"trained {len(hist)} of {args.steps} "
                                   "steps")
    for m in hist:
        for key in ("loss", "grad_norm"):
            check(bool(np.isfinite(m[key])) and m[key] != 0,
                  f"{key} {m[key]} is not finite and nonzero")
    want = (2 * cfg.num_layers * micro * args.steps,
            cfg.num_layers * micro * args.steps)
    check(sm90 == want, f"sm90 flash_attention launches (fwd, bwd) {sm90} "
                        f"!= {want}")
    check(total == want, f"flash_attention launches (fwd, bwd) {total} "
                         f"!= {want}: another route or the encoder ran")
    tokens = shape.global_batch * shape.seq_len
    secs = [m["seconds"] for m in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    raw = DATA.add_modality_stubs(DATA.SyntheticLM(
        cfg.vocab_size, shape.seq_len, shape.global_batch).batch_at(
        args.steps), cfg, seed=args.steps)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    step = make_train_step(cfg, AdamWConfig(total_steps=args.steps + 1),
                           micro)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(out["state"], batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    print(f"train {WHISPER}: a fourth step under torch.profiler, "
          f"{traced:.3f} s:")
    print_profile(prof, traced)
    print(f"train {WHISPER} (full width, {cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, {cfg.param_count() / 1e6:.2f} M params, "
          f"bf16 weights and gradients, float32 AdamW moments, float32 "
          f"encoder over float32 frames): {args.steps} steps of "
          f"{shape.global_batch} x {shape.seq_len} tokens and "
          f"{cfg.encoder_seq_len} frames a sequence in {micro} "
          f"microbatches; losses {[round(m['loss'], 4) for m in hist]}, "
          f"grad_norms {[round(m['grad_norm'], 4) for m in hist]}; s/step "
          f"{[round(x, 3) for x in secs]} (first includes warm-up); "
          f"{np.mean(secs[1:]):.3f} s/step and "
          f"{tokens / np.mean(secs[1:]):.1f} tokens/s after the first; "
          f"flash_attention sm90 launches fwd {sm90[0]}, bwd {sm90[1]}; "
          f"peak memory {peak:.2f} GiB")
    del out, step, batch
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"sm90": sm90, "peak_gib": peak,
            "train": train_run(cfg, shape.global_batch, shape.seq_len,
                               micro, secs)}


# ---------------------------------------------------------------------------
# phase 16: the roofline (FLOPs counted on the card and on fake tensors)
# ---------------------------------------------------------------------------
def train_paths() -> dict:
    """The (config, shape) of each training path phase 16b reads, as its
    phase trains it: 7, 11c, 12c, 14d and 15d through the launcher
    (train_4k's 4,096 tokens, ``TRAIN.GLOBAL_BATCH`` sequences), 12d and
    13d their depth cuts on one sequence."""
    launcher = C.ShapeConfig("train", 4096, TRAIN.GLOBAL_BATCH, "train")
    one = C.ShapeConfig("train", 4096, 1, "train")
    return {"7": (C.get_arch("internlm2-1.8b"), launcher),
            "11c": (C.get_arch(GEMMA), launcher),
            "12c": (C.get_arch(GRANITE_MOE), launcher),
            "12d": (dataclasses.replace(C.get_arch(DEEPSEEK),
                                        num_layers=DEEPSEEK_DEPTH), one),
            "13d": (jamba_cut("train"), one),
            "14d": (dataclasses.replace(C.get_arch(RWKV),
                                        num_layers=RWKV_TRAIN_LAYERS),
                    launcher),
            "15d": (C.get_arch(WHISPER), launcher)}


def host_counts(paths: dict) -> dict:
    """16b's fake-tensor counts, ``step_flops`` of each path in one
    microbatch, made in a process of their own while phases 3-15 hold the
    card.  Fake CPU tensors, so that process never touches the card; the
    kernels' wrappers route fake tensors by type, not device, and 16a
    holds the "7" count to the card's.  One microbatch does not change a
    count at these shapes: every product's work is linear in its rows,
    and an MoE layer's routing groups stay 512 tokens."""
    return {label: step_flops(cfg, shape, device="cpu")
            for label, (cfg, shape) in paths.items()}


def phase_roofline(runs: dict, card: str, paths: dict,
                   counted: dict) -> None:
    """16a: one train step of phase 7's configuration (internlm2-1.8b at
    full width, 8 x 4,096 tokens in 4 microbatches) counted on the card
    under ``flop_stats`` (the sm90 flash pair records through its real
    route), then the same step counted by ``step_flops`` on fake CUDA
    tensors on the host: the two dicts must be equal op by op and kernel
    by kernel, and to :func:`host_counts`' count of it, and building the
    specs must leave the card's allocated memory unchanged.  16b: for
    each training path timed above, the model FLOPs (6 N D) and
    :func:`host_counts`' count at its shape beside its s/step after the
    first step, as shares of the card's peak for the run's dtype
    (printed, not gated)."""
    for label, run in runs.items():
        check((run["cfg"], run["shape"]) == paths[label],
              f"16b: phase {label} trained another config or shape than "
              f"the one counted")
    run = runs["7"]
    cfg, shape, micro = run["cfg"], run["shape"], run["microbatches"]
    torch.cuda.empty_cache()
    state = init_train_state(cfg, 0, "cuda")
    step = make_train_step(cfg, AdamWConfig(), micro)
    raw = DATA.SyntheticLM(cfg.vocab_size, shape.seq_len,
                           shape.global_batch).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    t0 = time.perf_counter()
    with flop_stats() as on_card:
        step(state, batch)
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del state, step, batch
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    on_host = step_flops(cfg, shape, device="cuda", microbatches=micro)
    host_s = time.perf_counter() - t0
    check(torch.cuda.memory_allocated() == allocated,
          f"building the specs allocated "
          f"{torch.cuda.memory_allocated() - allocated} bytes on the card")
    check(on_card == on_host == counted["7"],
          f"16a: the card counted {on_card}, fake CUDA tensors on the host "
          f"{on_host}, fake CPU tensors in one microbatch {counted['7']}")
    print(f"16a {cfg.name} train step ({shape.global_batch} x "
          f"{shape.seq_len} tokens in {micro} microbatches): counted on the "
          f"card ({card_s:.2f} s, under flop_stats) and on fake CUDA "
          f"tensors on the host ({host_s:.2f} s), and on fake CPU tensors "
          f"in one microbatch, equal op by op: "
          f"{json.dumps(on_card)}; card memory allocated "
          f"{allocated} bytes before and after the specs")
    for label, run in runs.items():
        cfg, shape = run["cfg"], run["shape"]
        got = counted[label]
        model = model_flops(cfg, shape)
        peak = RC.PEAK_FLOPS[cfg.torch_dtype]
        secs = run["s_per_step"]
        parts = ", ".join(f"{k} {v:.4e}" for k, v in got.items()
                          if k != "total")
        print(f"16b {label} {cfg.name} ({cfg.num_layers} layers, "
              f"{cfg.dtype}, {shape.global_batch} x {shape.seq_len} "
              f"tokens): model flops {model:.4e}, counted {got['total']:.4e} "
              f"({parts}); {secs:.4f} s/step after the first; "
              f"{got['total'] / (secs * peak):.2%} of the {peak / 1e12:.1f} "
              f"TFLOP/s peak counted, {model / (secs * peak):.2%} in model "
              f"flops; card {card}")


# ---------------------------------------------------------------------------
# phase 9: the translation simulator
# ---------------------------------------------------------------------------
SIM_MACHINES = {"ndp": ndp_machine, "cpu": cpu_machine, "zoo": zoo_machine}
#: the JAX package's average NDP speedups over radix at the full preset
#: (benchmarks/sim_figures.py, repro.sim on a CPU), printed for the reader
#: beside the port's; the orderings are the gate
JAX_NDP_AVG = {1: {"ech": 1.132, "hugepage": 1.151, "ndpage": 1.280,
                   "ideal": 2.425},
               4: {"ech": 1.088, "hugepage": 1.039, "ndpage": 1.277,
                   "ideal": 2.409},
               8: {"ech": 1.034, "hugepage": 0.849, "ndpage": 1.277,
                   "ideal": 2.411}}
#: card vs CPU: the counters of events are integers in float32 and must be
#: equal; the cycle sums are float32 sums in other orders
SIM_RTOL = 1e-5
SIM_INT_COUNTERS = ("walks", "l1tlb_misses", "pte_accesses", "pte_l1_hits",
                    "pte_mem", "data_l1_misses", "data_mem")
SIM_FLOAT_COUNTERS = ("cycles", "trans_cycles", "walk_cycles")
#: the buckets of 9b, each 8 chunks of 1,024 (8,000 entries padded)
SIM_LAUNCHES = 6 * 8
#: CUDA kernels a chunk of the simulator on the card: the queue delay's
#: few torch ops, the scan and the epilogue
SIM_KERNELS_A_CHUNK = 12
SIM_LONG_WINDOW = 65536
#: the real traces of phase 9e, committed beside the tests
FIXTURE_TRACES = tuple(
    "trace:" + os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "traces", name)
    for name in ("gups_small.champsim.xz", "graph_small.lackey.gz"))


def sim_bucket(machine: str, cores: int, preset, mechs=DEFAULT_MECHS,
               trace_len=None, memory="bounded_linear", params=()):
    """The inputs of a bucket (every workload) on the card, and its zeroed
    engine state; ``params`` are (path, value) overrides of the machine
    (``apply_param``)."""
    mach = SIMLAUNCH.with_memory(SIM_MACHINES[machine](cores), memory)
    for path, value in params:
        mach = apply_param(mach, path, value)
    traces = generate_traces(list(WORKLOADS), cores, length=trace_len,
                             preset=preset)
    bk, _ = SIM._prepare([SIM.SimJob(mach, tr, tuple(mechs))
                          for tr in traces], None, preset.chunk,
                         torch.device("cuda"))
    return bk, SIM.init_state(mach, bk.m, batch=bk.b, device="cuda")


def scan_state(args) -> list:
    """The tensors a scan updates in place: the stamp, each table's tags
    and stamps, and (banked memory) the open rows."""
    return [args["stamp"]] + [t for pair in args["tables"].values()
                              for t in pair] + (
        [args["bank_row"]] if "bank_row" in args else [])


def plain_copy(args) -> dict:
    """The scan's arguments with the state it updates cloned."""
    out = dict(args, stamp=args["stamp"].clone(),
               tables={n: (t.clone(), s.clone())
                       for n, (t, s) in args["tables"].items()})
    if "bank_row" in args:
        out["bank_row"] = args["bank_row"].clone()
    return out


def state_out(state) -> list:
    """The state an epilogue adds into: the counters, clock, mem_accs."""
    return [state["counters"][k] for k in ref.COUNTERS] + [
        state["clock"], state["mem_accs"]]


def epilogue_args(bk, state, args, packed) -> dict:
    """The epilogue's arguments for a chunk whose scan gave ``packed``."""
    ep = dict(packed=packed, work=args["work"], is4k=args["is4k"],
              valid=args["valid"],
              q=SIM._queue(state["clock"], state["mem_accs"],
                           bk.dp["service"]),
              flags=bk.flags, params=bk.params, clock=state["clock"],
              mem_accs=state["mem_accs"], counters=state["counters"],
              n_hier=len(bk.shape.hier), has_ctlb="ctlb" in args["tables"])
    if "bank_row" in args:
        ep.update({k: args[k] for k in ("pte", "vpn", "off",
                                        "lines_per_row")})
    return ep


def plain_state(ep: dict) -> dict:
    """The epilogue's arguments with the state it adds into cloned."""
    return dict(ep, clock=ep["clock"].clone(), mem_accs=ep["mem_accs"].clone(),
                counters={k: v.clone() for k, v in ep["counters"].items()})


def epilogue_diff(got: dict, want: dict) -> tuple:
    """(mismatches, compared, max abs error, max relative error) of two
    states after an epilogue: counters of events and memory accesses must
    be equal, the cycle sums within SIM_RTOL."""
    floats = {"trans", "walk_cyc"}
    mism = compared = 0
    err = rel = 0.0
    pairs = [(k, got["counters"][k], want["counters"][k])
             for k in ref.COUNTERS] + [
        ("clock", got["clock"], want["clock"]),
        ("mem_accs", got["mem_accs"], want["mem_accs"])]
    for k, a, b in pairs:
        compared += a.numel()
        if k in floats or k == "clock":
            d = (a - b).abs()
            err = max(err, float(d.max()))
            r = d / b.abs().clamp_min(1e-30)
            rel = max(rel, float(r.max()))
            mism += int((d > SIM_RTOL * b.abs()).sum())
        else:
            mism += int((a != b).sum())
    return mism, compared, err, rel


def phase_sim_kernel() -> dict:
    """9a: every chunk of three smoke-preset buckets through both kernels
    and their plain versions from the same state; counts the differing
    packed bits, table entries and stamps, and the epilogue's counters
    that differ (cycles: beyond SIM_RTOL)."""
    smoke = PRESETS["smoke"]
    cases = (("ndp", 8, DEFAULT_MECHS, "bounded_linear"),
             ("cpu", 4, DEFAULT_MECHS, "bounded_linear"),
             ("zoo", 4, registered_names(), "bounded_linear"),
             ("zoo", 4, registered_names(), "banked"))
    out = {"mismatches": 0, "max_abs_err": 0.0, "ep_mismatches": 0,
           "ep_max_abs_err": 0.0, "ep_max_rel_err": 0.0}
    for machine, cores, mechs, memory in cases:
        t0 = time.perf_counter()
        bk, state = sim_bucket(machine, cores, smoke, mechs, memory=memory)
        mism = compared = ep_mism = ep_compared = 0
        for i in range(bk.n_chunks):
            args = SIM._scan_inputs(bk, state, i)
            work = args.pop("work")
            plain = plain_copy(args)
            got = LS.lru_scan(**args)
            want = ref.lru_scan_ref(**plain)
            pairs = [(got, want)] + list(zip(scan_state(args),
                                             scan_state(plain)))
            mism += sum(int((a != b).sum()) for a, b in pairs)
            compared += sum(a.numel() for a, _ in pairs)
            out["max_abs_err"] = max(out["max_abs_err"], max_err(got, want))
            ep = epilogue_args(bk, state, dict(args, work=work), got)
            ep_plain = plain_state(ep)
            SE.sim_epilogue(**ep)
            SE._plain(**ep_plain)
            d = epilogue_diff(ep, ep_plain)
            ep_mism += d[0]
            ep_compared += d[1]
            out["ep_max_abs_err"] = max(out["ep_max_abs_err"], d[2])
            out["ep_max_rel_err"] = max(out["ep_max_rel_err"], d[3])
        torch.cuda.synchronize()
        print(f"lru_scan vs plain, {machine}_machine({cores}) {memory}, "
              f"{bk.b} workloads x {len(mechs)} mechanisms, {bk.n_chunks} "
              f"chunks of "
              f"{bk.chunk}: {mism} mismatches in {compared} packed bits, "
              f"table entries and stamps; sim_epilogue vs plain: {ep_mism} "
              f"mismatches in {ep_compared} counters, cycle sums and memory "
              f"accesses (cycles max relative error "
              f"{out['ep_max_rel_err']:.3e}, rtol {SIM_RTOL:g}) "
              f"({time.perf_counter() - t0:.1f} s)")
        out["mismatches"] += mism
        out["ep_mismatches"] += ep_mism
        del bk, state
    check(out["mismatches"] == 0,
          "lru_scan kernel disagrees with its plain version")
    check(out["ep_mismatches"] == 0,
          "sim_epilogue kernel disagrees with its plain version")
    return out


#: shapes at which the epilogue's tiling can break (9a): (tag, steps,
#: simulations, cores, machine, mechanisms, banks, lines a row); each case
#: has lane 1 invalid throughout.  T 1 and 1,000 are not whole step
#: tiles, C 256 is MAX_CORES (80 column tiles), M 17 the zoo's, 24 lines
#: a row not a power of two
SIM_EDGE_CASES = (
    ("t1_ndp8", 1, 11, 8, "ndp", DEFAULT_MECHS, 0, 0),
    ("t1000_cpu8", 1000, 11, 8, "cpu", DEFAULT_MECHS, 0, 0),
    ("c1_ndp", 1024, 11, 1, "ndp", DEFAULT_MECHS, 0, 0),
    ("c256_ndp", 1000, 2, SE.MAX_CORES, "ndp", DEFAULT_MECHS, 0, 0),
    ("m17_zoo4", 1000, 11, 4, "zoo", registered_names(), 0, 0),
    ("banked64_ndp8", 1000, 11, 8, "ndp", DEFAULT_MECHS, SE.MAX_BANKS, 32),
    ("banked64_zoo1_t1", 1, 11, 1, "zoo", registered_names(), SE.MAX_BANKS,
     24),
)


def edge_operands(t_len, b, c, machine, mechs, banks, lines_per_row,
                  seed) -> dict:
    """Seeded epilogue operands on the card: random hit bits (every gate
    and site reached), the mechanisms' flag words, per-lane latencies
    jittered around ``machine``'s (a multi-stack penalty on every other
    lane), lane 1 invalid throughout, and a state of random integer
    counts and zero cycle sums (so the cycles compare as the chunk's
    sums)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lanes, m = b * c, len(mechs)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    mach = SIM_MACHINES[machine](c)
    mt = {k: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        v, (lanes,) + v.shape))).cuda()
        for k, v in SIM._mech_arrays(tuple(mechs)).items()}
    dp = {k: torch.full((lanes,), float(v), device="cuda")
          * (1.0 + 0.1 * rand(lanes))
          for k, v in SIM._data_params(mach).items()}
    dp["stack_pen"] = torch.where(torch.arange(lanes, device="cuda") % 2 == 1,
                                  25.0 * rand(lanes), 0.0)
    valid = rand(t_len, lanes) < 0.9
    valid[:, 1] = False
    nb = (banks,) if banks else ()
    ep = dict(packed=randint(2 ** 31 - 1, t_len, lanes, m),
              work=8.0 * rand(t_len, lanes), is4k=rand(t_len, lanes) < 0.5,
              valid=valid, q=40.0 * rand(b, m, *nb), flags=LS.mech_flags(mt),
              params=SE.lane_params(dp),
              clock=torch.zeros(b, m, c, device="cuda"),
              mem_accs=randint(1 << 20, b, m, *nb).float(),
              counters={k: (torch.zeros(b, m, c, device="cuda")
                            if k in ("trans", "walk_cyc")
                            else randint(1 << 16, b, m, c).float())
                        for k in ref.COUNTERS},
              n_hier=3 if machine == "cpu" else 1,
              has_ctlb=machine == "zoo")
    if banks:
        ep.update(pte=randint(1 << 30, t_len, lanes, m, 4),
                  vpn=randint(1 << 25, t_len, lanes),
                  off=randint(64, t_len, lanes), lines_per_row=lines_per_row)
    return ep


def epilogue_ptxas() -> dict:
    """The epilogue's ptxas lines and what the card makes of each
    instantiation (resident blocks an SM, registers, local bytes),
    printed; returns the registers and spill bytes for the kernels
    line."""
    for line in ptxas_lines("sim_epilogue", ["sim_epilogue_kernel"]):
        print(f"  ptxas {line}")
    occ = SE.occupancy()
    for kind, o in occ.items():
        print(f"sim_epilogue_kernel ({kind}): {o['threads']} threads a "
              f"block, {o['registers']} registers, {o['local_bytes']} local "
              f"bytes a thread, {o['blocks_per_sm']} blocks an SM resident "
              f"({o['blocks_per_sm'] * o['threads'] // 32} warps)")
    return {f"{kind}_{k}": o[k] for kind, o in occ.items()
            for k in ("registers", "local_bytes")}


def phase_sim_edges() -> dict:
    """9a's edge cases: the epilogue kernel against its plain version at
    SIM_EDGE_CASES from the same state (counters and memory accesses
    equal, cycles within SIM_RTOL), launched twice from that state and
    held bit-identical."""
    out = {"ep_mismatches": 0, "ep_max_abs_err": 0.0, "ep_max_rel_err": 0.0,
           "not_identical": 0}
    for seed, (tag, t_len, b, c, machine, mechs, banks, lpr) in enumerate(
            SIM_EDGE_CASES):
        ep = edge_operands(t_len, b, c, machine, mechs, banks, lpr, seed)
        start = [t.clone() for t in state_out(ep)]

        def restore():
            for t, s in zip(state_out(ep), start):
                t.copy_(s)

        plain = plain_state(ep)
        SE._plain(**plain)
        runs = []
        for _ in range(2):
            restore()
            SE._launch(**ep)
            runs.append([t.clone() for t in state_out(ep)])
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        mism, compared, err, rel = epilogue_diff(ep, plain)
        geo = SE.geometry(torch.cuda.current_device(), t_len, b, c,
                          len(mechs), banks)
        print(f"sim_epilogue edge case {tag} (T {t_len}, B {b}, C {c}, M "
              f"{len(mechs)}, "
              + (f"{banks} banks of {lpr} lines" if banks else "bounded")
              + f", lane 1 invalid; grid {geo['col_tiles']} x "
              f"{geo['step_tiles']} blocks, {geo['steps']} steps a thread): "
              f"{mism} mismatches in {compared} counters, cycle sums and "
              f"memory accesses, cycles max relative error {rel:.3e} (rtol "
              f"{SIM_RTOL:g}); two launches bit-identical: {same}")
        out["ep_mismatches"] += mism
        out["not_identical"] += not same
        out["ep_max_abs_err"] = max(out["ep_max_abs_err"], err)
        out["ep_max_rel_err"] = max(out["ep_max_rel_err"], rel)
        del ep, plain, runs, start
    check(out["ep_mismatches"] == 0, "sim_epilogue kernel disagrees with its "
                                     "plain version at an edge case")
    check(out["not_identical"] == 0, "two sim_epilogue launches from the "
                                     "same state differ")
    return out


def scan_bytes(args) -> int:
    """Bytes a chunk of the scan must move: the inputs, walk lines and
    packed bits once, the stamps and the tables read once and written
    once."""
    t, lanes = args["vpn"].shape
    m = args["stamp"].shape[1]
    once = sum(args[k].numel() * args[k].element_size()
               for k in ("vpn", "off", "is4k", "valid", "pte", "flags"))
    twice = sum(x.numel() * x.element_size() for x in scan_state(args))
    return once + 2 * twice + t * lanes * m * 4


def epilogue_bytes(ep) -> int:
    """Bytes a chunk of the epilogue must move: its inputs once, the state
    it adds into read once and written once."""
    names = ("packed", "work", "is4k", "valid", "q", "flags", "params") + (
        ("pte", "vpn", "off") if "pte" in ep else ())
    once = sum(ep[k].numel() * ep[k].element_size() for k in names)
    return once + 2 * sum(t.numel() * 4 for t in state_out(ep))


def time_device_ms(fn, restore, iters: int = 10) -> float:
    """Mean device time of ``fn`` with ``restore()`` run and L2 flushed
    before each call, outside the timed window, and the card idling on a
    sleep kernel before the start event (see time_cold_ms)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        restore()
        fn()
    pairs = []
    for _ in range(iters):
        restore()
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in pairs]))


def time_plain_ms(fn) -> float:
    """Device time of one call of a plain version, L2 flushed first."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def probe_scan(args, restore, machine: str, cores: int, chunk: int
               ) -> None:
    """What the scan's time moves with, on the same chunk: no step valid
    (no lookup at all: the step's fixed instructions), and every chain set
    to one mechanism (its lookups a step: ideal 1, ndpage 7 at most, radix
    11 at most on an NDP machine)."""
    idle = dict(args, valid=torch.zeros_like(args["valid"]))
    ms = time_device_ms(lambda: LS._launch(**idle), restore)
    print(f"lru_scan probe, {machine}_machine({cores}): no step valid "
          f"{ms:.4f} ms ({ms * 1e6 / chunk:.1f} ns a step)")
    flags = args["flags"]
    for col, mech in enumerate(DEFAULT_MECHS):
        one = dict(args, flags=flags[:, col:col + 1].expand_as(flags)
                   .contiguous())
        ms = time_device_ms(lambda: LS._launch(**one), restore)
        print(f"lru_scan probe, {machine}_machine({cores}): every chain "
              f"{mech} {ms:.4f} ms ({ms * 1e6 / chunk:.1f} ns a step)")
    restore()


def time_sim_chunk(machine: str, cores: int, probe: bool = False,
                   memory: str = "bounded_linear", params=(),
                   mechs=DEFAULT_MECHS) -> dict:
    """Both kernels and their plain versions on the middle 1,024-step
    chunk of a full-preset bucket, from the state the earlier chunks
    left; the state is restored before each timed call, and L2 flushed.
    Each plain version is held against one kernel launch from the same
    state; the differences are counted.  ``params`` overrides the
    machine, ``mechs`` the mechanisms."""
    bk, state = sim_bucket(machine, cores, PRESETS["full"], mechs,
                           memory=memory, params=params)
    where = (f"{machine}_machine({cores}) {memory}"
             + "".join(f" {p}={v}" for p, v in params) + " full preset")
    k = bk.n_chunks // 2
    for i in range(k):
        SIM._run_chunk(bk, state, i)
    args = SIM._scan_inputs(bk, state, k)
    work = args.pop("work")
    saved = [t.clone() for t in scan_state(args)]

    def restore():
        for t, s in zip(scan_state(args), saved):
            t.copy_(s)

    restore()
    packed = LS._launch(**args)
    got = [packed] + [t.clone() for t in scan_state(args)]
    ms = time_device_ms(lambda: LS._launch(**args), restore)
    restore()
    want = []
    plain_ms = time_plain_ms(lambda: want.extend(
        [ref.lru_scan_ref(**args)] + scan_state(args)))
    mism = sum(int((a != b).sum()) for a, b in zip(got, want))
    compared = sum(a.numel() for a in got)
    nbytes = scan_bytes(args)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lanes, m = args["stamp"].shape
    print(f"lru_scan timing, {where}, chunk {k} of {bk.n_chunks} "
          f"({bk.chunk} steps, {lanes} lanes x {m} mechanisms = "
          f"{lanes * m} chains; L2 flushed): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: "
          f"{nbytes / 1e6:.2f} MB), {bound_ms / ms:.2%} of bound, "
          f"{ms * 1e6 / bk.chunk:.1f} ns a step; no library call computes "
          f"an LRU scan; kernel vs plain: {mism} mismatches in {compared} "
          f"packed bits, table entries and stamps")
    scan = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, mismatches=mism)
    if probe:
        probe_scan(args, restore, machine, cores, bk.chunk)

    # the epilogue on the kernel's packed bits
    ep = epilogue_args(bk, state, dict(args, work=work), packed)
    out = state_out(ep)
    ep_saved = [t.clone() for t in out]

    def ep_restore():
        for t, s in zip(out, ep_saved):
            t.copy_(s)

    def ep_kernel():
        SE._launch(**ep)

    ep_restore()
    ep_kernel()
    got_state = plain_state(ep)
    ep_ms = time_device_ms(ep_kernel, ep_restore)
    ep_restore()
    ep_plain = plain_state(ep)
    ep_plain_ms = time_plain_ms(lambda: SE._plain(**ep_plain))
    ep_mism, ep_compared, ep_err, ep_rel = epilogue_diff(got_state, ep_plain)
    ep_bytes = epilogue_bytes(ep)
    ep_bound = ep_bytes / HBM_BYTES_PER_S * 1e3
    geo = SE.geometry(torch.cuda.current_device(), bk.chunk, bk.b,
                      lanes // bk.b, m,
                      ep["q"].shape[2] if ep["q"].dim() == 3 else 0)
    print(f"sim_epilogue timing, {where}, the same chunk (grid "
          f"{geo['col_tiles']} x {geo['step_tiles']} blocks, "
          f"{geo['steps']} steps a thread; L2 flushed): kernel {ep_ms:.4f} "
          f"ms, plain "
          f"{ep_plain_ms:.4f} ms, bound {ep_bound:.4f} ms (bytes: "
          f"{ep_bytes / 1e6:.3f} MB), {ep_bound / ep_ms:.2%} of bound; no "
          f"library call computes the epilogue; kernel vs plain: "
          f"{ep_mism} mismatches in {ep_compared} counters and sums, cycles "
          f"max relative error {ep_rel:.3e}")
    epilogue = dict(ms=ep_ms, plain_ms=ep_plain_ms, bound_ms=ep_bound,
                    bound_by="bytes", library_ms=None, mismatches=ep_mism,
                    max_abs_err=ep_err)
    del bk, state, saved, got, want, ep_saved, got_state, ep_plain
    torch.cuda.empty_cache()
    return {"lru_scan": scan, "sim_epilogue": epilogue}


def count_chunk_kernels(machine: str, cores: int) -> dict:
    """CUDA kernels (device-side events of torch.profiler: kernels,
    memsets and copies) a chunk of a full-preset bucket: over the chunk
    loop alone (the gate), and over a whole simulate_batch with its
    set-up (traces to the card, zeroed state, the walk lines)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def device_events(prof) -> dict:
        names: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        return names

    bk, state = sim_bucket(machine, cores, PRESETS["full"])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(bk.n_chunks):
            SIM._run_chunk(bk, state, i)
        torch.cuda.synchronize()
    loop = device_events(prof)
    n_chunks = bk.n_chunks
    mach = SIM_MACHINES[machine](cores)
    traces = generate_traces(list(WORKLOADS), cores, preset=PRESETS["full"])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        SIM.simulate_batch(mach, traces, chunk=PRESETS["full"].chunk,
                           device="cuda")
        torch.cuda.synchronize()
    whole = device_events(prof)
    a_chunk = sum(loop.values()) / n_chunks
    print(f"CUDA kernels a chunk, {machine}_machine({cores}) full preset "
          f"(torch.profiler): {a_chunk:.2f} over the chunk loop "
          f"({sum(loop.values())} in {n_chunks} chunks: "
          + ", ".join(f"{v} x {k[:60]}" for k, v in sorted(
              loop.items(), key=lambda kv: -kv[1]))
          + f"); {sum(whole.values()) / n_chunks:.2f} over simulate_batch "
          f"with its set-up ({sum(whole.values())})")
    del bk, state
    return {"loop": a_chunk, "whole": sum(whole.values()) / n_chunks}


def check_sim_results(buckets, reference=JAX_NDP_AVG) -> None:
    """Finite positive cycles of the expected shapes, counters of events
    within the trace's accesses, and the figure orderings; the NDP
    averages printed beside ``reference``'s where one is given."""
    for bk in buckets:
        for w, r in bk["results"].items():
            shape = (len(DEFAULT_MECHS), bk["cores"])
            check(r.cycles.shape == shape and r.walks.shape == shape,
                  f"{bk['machine']} {bk['cores']}c {w}: result shape "
                  f"{r.cycles.shape} != {shape}")
            check(bool(np.isfinite(r.cycles).all() and (r.cycles > 0).all()),
                  f"{bk['machine']} {bk['cores']}c {w}: cycles not finite "
                  "and positive")
            check(bool((r.walks <= r.l1tlb_misses).all()
                       and (r.l1tlb_misses <= r.accesses).all()),
                  f"{bk['machine']} {bk['cores']}c {w}: walks > L1-TLB "
                  "misses or misses > accesses")
        if bk["machine"] != "ndp":
            continue
        avg = SIMLAUNCH.averages(bk)
        cores = bk["cores"]
        check(avg["ideal"] > avg["ndpage"] > 1.0,
              f"ndp {cores}c: not ideal > ndpage > 1.0: {avg}")
        if cores == 8:
            check(avg["hugepage"] < 1.0, f"ndp 8c: hugepage not below "
                                         f"radix: {avg}")
        if reference is not None:
            print(f"ndp {cores}c average speedup over radix, port on the "
                  f"card vs the JAX package at the full preset: "
                  + ", ".join(f"{m} {avg[m]:.3f} vs "
                              f"{reference[cores][m]:.3f}"
                              for m in SIMLAUNCH.SHOWN))


def hold_card_vs_cpu(names, card, cpu, what: str) -> float:
    """Results of the same jobs on the card and on the CPU: counters of
    events equal, cycles within SIM_RTOL; returns the largest relative
    difference of the cycles."""
    worst = 0.0
    check(len(card) == len(cpu), f"{what}: {len(card)} results on the "
                                 f"card, {len(cpu)} on the CPU")
    for w, a, b in zip(names, card, cpu):
        check(a.mechs == b.mechs and a.accesses == b.accesses
              and a.accesses > 0,
              f"{what} {w}: {a.mechs} x {a.accesses} entries on the card, "
              f"{b.mechs} x {b.accesses} on the CPU")
        for f in SIM_INT_COUNTERS:
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"{what} {w}: {f} differs between the card and the CPU")
        for f in SIM_FLOAT_COUNTERS:
            x, y = getattr(a, f), getattr(b, f)
            check(bool(np.isfinite(x).all()) and x.shape == y.shape,
                  f"{what} {w}: {f} not finite or of another shape")
            check(np.allclose(x, y, rtol=SIM_RTOL, atol=0.0),
                  f"{what} {w}: {f} card vs CPU beyond rtol {SIM_RTOL:g}")
            worst = max(worst, float(np.max(np.abs(x - y)
                                            / np.maximum(np.abs(y), 1e-30))))
    return worst


def card_vs_cpu(mach, traces, names, what: str, length=None) -> float:
    """``traces`` through simulate_batch on the card and on the CPU:
    counters of events equal, cycles within SIM_RTOL; returns the largest
    relative difference of the cycles."""
    chunk = PRESETS["full"].chunk
    t0 = time.perf_counter()
    card = SIM.simulate_batch(mach, traces, length, chunk=chunk,
                              device="cuda")
    t1 = time.perf_counter()
    cpu = SIM.simulate_batch(mach, traces, length, chunk=chunk, device="cpu")
    t2 = time.perf_counter()
    worst = hold_card_vs_cpu(names, card, cpu, what)
    print(f"simulator card vs CPU, {what} ({len(traces)} traces, "
          f"{', '.join(str(r.accesses) for r in card[:2])}"
          f"{' ...' if len(card) > 2 else ''} entries): "
          f"{', '.join(SIM_INT_COUNTERS)} equal; "
          f"{', '.join(SIM_FLOAT_COUNTERS)} max relative difference "
          f"{worst:.3e} (rtol {SIM_RTOL:g}); card {t1 - t0:.2f} s, CPU "
          f"{t2 - t1:.2f} s")
    return worst


def phase_sim_parity(memory: str = "bounded_linear") -> float:
    """9c: the ndp_machine(4) bucket at the full preset, card vs CPU."""
    traces = generate_traces(list(WORKLOADS), 4, preset=PRESETS["full"])
    mach = SIMLAUNCH.bucket_machine("ndp", 4, memory)
    return card_vs_cpu(mach, traces, list(WORKLOADS),
                       f"ndp_machine(4) {memory} bucket, full preset")


def phase_sim() -> dict:
    t0 = time.perf_counter()
    kernel = phase_sim_kernel()
    edges = phase_sim_edges()
    kernel["ep_mismatches"] += edges["ep_mismatches"]
    for k in ("ep_max_abs_err", "ep_max_rel_err"):
        kernel[k] = max(kernel[k], edges[k])
    kernel["ep_build"] = epilogue_ptxas()
    print(f"phase 9a (lru_scan and sim_epilogue vs plain, the epilogue's "
          f"edge cases): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    LS.launches = SE.launches = 0
    buckets = SIMLAUNCH.run(SIMLAUNCH.build_parser().parse_args([]))
    launches, ep_launches = LS.launches, SE.launches
    chunks = sum(bk["chunks"] for bk in buckets)
    check(launches == ep_launches == chunks == SIM_LAUNCHES,
          f"lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches} over {chunks} chunks, not {SIM_LAUNCHES} each")
    check_sim_results(buckets)
    print(f"simulator: 6 full-preset buckets in "
          f"{sum(bk['wall_s'] for bk in buckets):.3f} s of simulate_batch, "
          f"lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches}")
    for line in ptxas_lines("lru_scan", ["lru_scan_kernel"]):
        print(f"  ptxas {line}")
    per_chunk = count_chunk_kernels("ndp", 8)
    check(per_chunk["loop"] <= SIM_KERNELS_A_CHUNK,
          f"{per_chunk['loop']:.2f} CUDA kernels a chunk, more than "
          f"{SIM_KERNELS_A_CHUNK}")
    # every bucket's chunk, both kernels held against their plain versions;
    # at 8 cores what the scan's time moves with
    timed = {(bk["machine"], bk["cores"]): time_sim_chunk(
        bk["machine"], bk["cores"], probe=bk["cores"] == 8) for bk in buckets}
    chunk_mism = sum(t["lru_scan"].pop("mismatches") for t in timed.values())
    ep_mism = sum(t["sim_epilogue"].pop("mismatches")
                  for t in timed.values())
    kernel["mismatches"] += chunk_mism
    kernel["ep_mismatches"] += ep_mism
    kernel["ep_max_abs_err"] = max(
        [kernel["ep_max_abs_err"]] + [t["sim_epilogue"].pop("max_abs_err")
                                      for t in timed.values()])
    check(chunk_mism == 0, "lru_scan kernel disagrees with its plain "
                           "version on a full-preset chunk")
    check(ep_mism == 0, "sim_epilogue kernel disagrees with its plain "
                        "version on a full-preset chunk")
    for bk in buckets:
        t = timed[(bk["machine"], bk["cores"])]
        print(f"bucket {bk['machine']} {bk['cores']}c, full preset: wall "
              f"{bk['wall_s']:.3f} s, {bk['entries_per_s']:.0f} trace "
              f"entries/s, lru_scan {t['lru_scan']['ms']:.4f} ms and "
              f"sim_epilogue {t['sim_epilogue']['ms']:.4f} ms a chunk x "
              f"{bk['chunks']} chunks")
    print(f"phase 9b (figures 12-14, full preset): "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_sim_parity()
    print(f"phase 9c (card vs CPU): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    long = SIMLAUNCH.run(SIMLAUNCH.build_parser().parse_args(
        ["--cores", "8", "--trace-len", str(SIM_LONG_WINDOW)]))
    for bk in long:
        print(f"simulator long window, {bk['machine']} 8c, "
              f"{SIM_LONG_WINDOW} entries: {bk['entries_per_s']:.0f} trace "
              f"entries/s, {bk['wall_s']:.3f} s, {bk['launches']} + "
              f"{bk['epilogue_launches']} launches")
    print(f"simulator long window peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"phase 9d (long window): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    banked = phase_sim_banked(buckets, timed)
    kernel["mismatches"] += banked.pop("mismatches")
    kernel["ep_mismatches"] += banked.pop("ep_mismatches")
    kernel["ep_max_abs_err"] = max(kernel["ep_max_abs_err"],
                                   banked.pop("ep_max_abs_err"))
    print(f"phase 9e (banked memory and real traces): "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sweeps = phase_sim_sweeps()
    kernel["mismatches"] += sweeps.pop("mismatches")
    kernel["ep_mismatches"] += sweeps.pop("ep_mismatches")
    kernel["ep_max_abs_err"] = max(kernel["ep_max_abs_err"],
                                   sweeps.pop("ep_max_abs_err"))
    print(f"phase 9f (sensitivity sweeps): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    search = phase_sim_search()
    print(f"phase 9g (design-space search): {time.perf_counter() - t0:.1f} s")
    return dict(kernel, launches=launches, ep_launches=ep_launches,
                timed=timed, banked=banked, sweeps=sweeps, search=search)


def phase_sim_banked(bounded, bounded_timed) -> dict:
    """9e: the six full-preset buckets on banked memory through the
    launcher, both kernels against their plain versions on the middle
    chunk of the banked ndp(8) and cpu(8) buckets, the banked ndp(4)
    bucket card vs CPU, and the fixture traces card vs CPU."""
    LS.launches = SE.launches = 0
    buckets = SIMLAUNCH.run(SIMLAUNCH.build_parser().parse_args(
        ["--memory", "banked"]))
    launches, ep_launches = LS.launches, SE.launches
    chunks = sum(bk["chunks"] for bk in buckets)
    check(launches == ep_launches == chunks == SIM_LAUNCHES,
          f"banked: lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches} over {chunks} chunks, not {SIM_LAUNCHES} each")
    check_sim_results(buckets, reference=None)
    before = {(bk["machine"], bk["cores"]): bk for bk in bounded}
    for bk in buckets:
        avg = SIMLAUNCH.averages(bk)
        b = before[(bk["machine"], bk["cores"])]
        print(f"banked {bk['machine']} {bk['cores']}c average speedup over "
              f"radix: radix 1.000, "
              + ", ".join(f"{m} {avg[m]:.3f}" for m in SIMLAUNCH.SHOWN)
              + f"; wall {bk['wall_s']:.3f} s, {bk['entries_per_s']:.0f} "
              f"entries/s (bounded {b['wall_s']:.3f} s, "
              f"{b['entries_per_s']:.0f} entries/s)")
    print(f"simulator banked: 6 full-preset buckets in "
          f"{sum(bk['wall_s'] for bk in buckets):.3f} s of simulate_batch "
          f"(bounded {sum(bk['wall_s'] for bk in bounded):.3f} s), "
          f"lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches}")

    timed = {mc: time_sim_chunk(*mc, memory="banked")
             for mc in (("ndp", 8), ("cpu", 8))}
    for (machine, cores), t in timed.items():
        b = bounded_timed[(machine, cores)]
        print(f"banked vs bounded, {machine}_machine({cores}) chunk: lru_scan "
              f"{t['lru_scan']['ms']:.4f} vs {b['lru_scan']['ms']:.4f} ms "
              f"({t['lru_scan']['ms'] / b['lru_scan']['ms'] - 1:+.1%}), "
              f"sim_epilogue {t['sim_epilogue']['ms']:.4f} vs "
              f"{b['sim_epilogue']['ms']:.4f} ms")
    mism = sum(t["lru_scan"].pop("mismatches") for t in timed.values())
    ep_mism = sum(t["sim_epilogue"].pop("mismatches")
                  for t in timed.values())
    ep_err = max(t["sim_epilogue"].pop("max_abs_err") for t in timed.values())
    check(mism == 0, "banked lru_scan kernel disagrees with its plain "
                     "version on a full-preset chunk")
    check(ep_mism == 0, "banked sim_epilogue kernel disagrees with its "
                        "plain version on a full-preset chunk")

    parity = phase_sim_parity("banked")
    names = [spec.rsplit("/", 1)[1] for spec in FIXTURE_TRACES]
    for cores in (1, 8):
        for memory in ("bounded_linear", "banked"):
            parity = max(parity, card_vs_cpu(
                SIMLAUNCH.bucket_machine("ndp", cores, memory),
                list(FIXTURE_TRACES), names,
                f"fixture traces, ndp_machine({cores}) {memory}"))
    return dict(launches=launches, ep_launches=ep_launches, timed=timed,
                mismatches=mism, ep_mismatches=ep_mism, ep_max_abs_err=ep_err,
                parity_max_rel=parity)


#: the nine named sweeps at the full preset: points and shape buckets
SWEEP_POINTS = 180
SWEEP_BUCKETS = 21
#: bypass-off NDPage may beat bypass-on on one workload by at most this
#: much (the JAX package's sweep benchmark: the suite mean must order)
BYPASS_WL_TOL = 0.02
#: table geometries that only the sweeps and the search reach, held and
#: timed on the middle chunk of the full-preset ndp(8) bucket: (tag,
#: machine overrides, mechanisms)
SWEEP_GEOMETRIES = (
    ("pwc64", (("pwc_entries", 64),), DEFAULT_MECHS),
    ("pwc8", (("pwc_entries", 8),), DEFAULT_MECHS),
    ("ctlb512", (("ctlb_kb", 512),), ("radix", "victima", "ideal")),
    ("tlb256_l2tlb3072", (("l1_dtlb.entries", 256), ("l1_dtlb.ways", 8),
                          ("l2_tlb.entries", 3072)), DEFAULT_MECHS),
)


def profiled(what: str, fn) -> None:
    """``fn()`` once more under torch.profiler: time by operator and the
    share of the wall in which the card ran a kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{what} under torch.profiler:")
    print_profile(prof, wall)


def check_sweep_orderings(by: dict) -> None:
    """The orderings the JAX package's sweep benchmark checks
    (``benchmarks/sim_sweep.py``), restated on the port's results."""
    for name in ("pwc_size", "tlb_size", "mem_latency", "banked_timing"):
        sp = by[name].speedup("ndpage")
        check(bool((sp >= 1.0).all()), f"sweep {name}: ndpage below radix "
                                       f"at a point (min {sp.min():.3f})")
        print(f"sweep {name}: ndpage >= radix at all {sp.size} points "
              f"(min {sp.min():.3f}, mean {sp.mean():.3f})")
    r = by["banked_timing"]
    cyc = r.map(lambda x: float(x.cycles.mean()))
    check(bool((np.diff(cyc, axis=1) >= -1e-6).all()),
          "sweep banked_timing: cycles fall as t_cas grows")
    r = by["l1_bypass"]
    m_on, m_off = r.axes["mechs"]
    on = r.select(mechs=m_on).map(lambda x: x.speedup_vs()["ndpage"])
    off = r.select(mechs=m_off).map(
        lambda x: x.speedup_vs()["ndpage_nobyp"])
    check(bool(off.mean() < on.mean() and (off >= 1.0).all()
               and (off <= on + BYPASS_WL_TOL).all()),
          f"sweep l1_bypass: bypass off does not degrade toward radix "
          f"(on {on}, off {off})")
    print(f"sweep l1_bypass: bypass on {on.mean():.4f}, off {off.mean():.4f} "
          f"(suite means; off >= 1.0 everywhere, worst inversion "
          f"{(off - on).max():+.4f} <= {BYPASS_WL_TOL})")
    r = by["flatten_level"]
    m2, m3 = r.axes["mechs"]
    pl2 = r.select(mechs=m2).map(lambda x: x.speedup_vs()["ndpage"])
    pl3 = r.select(mechs=m3).map(lambda x: x.speedup_vs()["ndpage_pl3"])
    check(bool((pl2 >= 1.0).all() and (pl3 >= 1.0).all()),
          f"sweep flatten_level: a flattening below radix ({pl2}, {pl3})")
    print(f"sweep flatten_level: pl2 {pl2.mean():.4f}, pl3 {pl3.mean():.4f}, "
          f"both >= radix everywhere")
    r = by["core_scaling"]
    ptw = r.scalar("avg_ptw_latency", "radix").mean(axis=1)
    hp = r.map(lambda x: x.speedup_vs()["hugepage"]).mean(axis=1)
    check(bool((np.diff(ptw) > 0).all() and hp[0] > 1.0 > hp[-1]),
          f"sweep core_scaling: radix walk latency {ptw} not growing with "
          f"cores or huge pages {hp} not collapsing by 8 cores")
    print(f"sweep core_scaling: radix walk latency {np.round(ptw, 1)} cycles "
          f"at {r.axes['cores']} cores, hugepage {np.round(hp, 3)}")
    for name in ("zoo", "victima_reach"):
        r = by[name]
        mechs = [m for m in r.results.flat[0].mechs if m != "radix"]
        sp = {m: r.map(lambda x, m=m: x.speedup_vs()[m]) for m in mechs}
        check(all(bool((sp["ideal"] >= sp[m] - 1e-6).all()) for m in mechs)
              and bool((sp["victima"] >= 0.9).all()),
              f"sweep {name}: ideal not the upper bound or victima below "
              f"0.9: " + ", ".join(f"{m} {v.min():.3f}-{v.max():.3f}"
                                   for m, v in sp.items()))
        print(f"sweep {name}: ideal bounds every mechanism; "
              + ", ".join(f"{m} {v.mean():.3f}" for m, v in sp.items()))


def phase_sim_sweeps() -> dict:
    """9f: the nine named sweeps at the full preset through the
    launcher, on the card; the orderings and the bucket plans; both
    kernels held and timed at the sweeps' and the search's table
    geometries; the l1_bypass sweep card vs CPU."""
    full = PRESETS["full"]
    args = SIMLAUNCH.build_parser().parse_args(
        ["--sweep", ",".join(SWEEPS)])
    LS.launches = SE.launches = 0
    t0 = time.perf_counter()
    by = SIMLAUNCH.run_sweeps(args, show_points=False)
    wall = time.perf_counter() - t0
    launches, ep_launches = LS.launches, SE.launches
    points = sum(r.stats["points"] for r in by.values())
    buckets = sum(r.stats["buckets"] for r in by.values())
    chunks = -(-full.trace_len // full.chunk)
    check(points == SWEEP_POINTS and buckets == SWEEP_BUCKETS,
          f"sweeps: {points} points in {buckets} buckets, not "
          f"{SWEEP_POINTS} in {SWEEP_BUCKETS}")
    check(launches == ep_launches == buckets * chunks,
          f"sweeps: lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches}, not {buckets} buckets x {chunks} chunks")
    for name, r in by.items():
        per = [b["compiles"] for b in r.stats["per_bucket"]]
        check(all(c <= 1 for c in per),
              f"sweep {name}: more than one bucket plan a bucket: {per}")
        check(all(bool(np.isfinite(x.cycles).all() and (x.cycles > 0).all())
                  for x in r.results.flat),
              f"sweep {name}: cycles not finite and positive")
    check_sweep_orderings(by)
    dispatch = sum(r.stats["wall_s"] for r in by.values())
    loops = sum(b["total_s"] for r in by.values()
                for b in r.stats["per_bucket"])
    print(f"sweeps (full preset, card): {points} points, {buckets} buckets, "
          f"{sum(r.stats['runner_compiles'] for r in by.values())} bucket "
          f"plans, {wall:.3f} s in all ({dispatch:.3f} s dispatching, of "
          f"which the chunk loops {loops:.3f} s and the buckets' set-up "
          f"the rest); lru_scan launches {launches}, sim_epilogue launches "
          f"{ep_launches}")
    profiled("the nine sweeps",
             lambda: SIMLAUNCH.run_sweeps(args, show_points=False))

    timed = {tag: time_sim_chunk("ndp", 8, params=params, mechs=mechs)
             for tag, params, mechs in SWEEP_GEOMETRIES}
    mism = sum(t["lru_scan"].pop("mismatches") for t in timed.values())
    ep_mism = sum(t["sim_epilogue"].pop("mismatches")
                  for t in timed.values())
    ep_err = max(t["sim_epilogue"].pop("max_abs_err") for t in timed.values())
    check(mism == 0, "lru_scan kernel disagrees with its plain version at a "
                     "sweep or search table geometry")
    check(ep_mism == 0, "sim_epilogue kernel disagrees with its plain "
                        "version at a sweep or search table geometry")

    t0 = time.perf_counter()
    cpu = sweep("l1_bypass", preset=full.name, device="cpu")
    card = by["l1_bypass"]
    names = [SIMLAUNCH.point_label(card.axes, idx)
             for idx in np.ndindex(*card.results.shape)]
    parity = hold_card_vs_cpu(names, list(card.results.flat),
                              list(cpu.results.flat),
                              "l1_bypass sweep, full preset")
    print(f"l1_bypass sweep card vs CPU ({len(names)} points, bypassing and "
          f"polluting lanes in one launch): "
          f"{', '.join(SIM_INT_COUNTERS)} equal; cycles max relative "
          f"difference {parity:.3e} (rtol {SIM_RTOL:g}); CPU "
          f"{time.perf_counter() - t0:.2f} s")
    return dict(launches=launches, ep_launches=ep_launches, timed=timed,
                mismatches=mism, ep_mismatches=ep_mism, ep_max_abs_err=ep_err,
                parity_max_rel=parity)


def same_search(card, cpu, what: str) -> float:
    """The same genomes evaluated in the same order and the same frontier
    on the card and on the CPU, objectives within SIM_RTOL; returns the
    largest relative difference of an objective."""
    check([dict(c.genome) for c in card.candidates]
          == [dict(c.genome) for c in cpu.candidates],
          f"{what}: the card and the CPU evaluated other genomes")
    check([dict(c.genome) for c in card.frontier]
          == [dict(c.genome) for c in cpu.frontier],
          f"{what}: the frontier differs between the card and the CPU")
    worst = 0.0
    for a, b in zip(card.candidates, cpu.candidates):
        for k, v in a.objectives.items():
            rel = abs(v - b.objectives[k]) / max(abs(b.objectives[k]), 1e-30)
            worst = max(worst, rel)
    check(worst <= SIM_RTOL, f"{what}: objectives differ by {worst:.3e}")
    return worst


def print_search(res, device: str, wall: float) -> None:
    p, v = res.provenance, res.verdict
    print(f"search {res.space.name} on {device}: {p['evaluated']} of "
          f"{res.space.size()} genomes evaluated in {p['generations']} "
          f"generations, {p['lanes_dispatched']} lanes in "
          f"{p['dispatch_buckets']} dispatches, {p['distinct_buckets']} "
          f"distinct buckets, {p['runner_compiles']} bucket plans, "
          f"{len(res.frontier)} on the frontier, {wall:.3f} s")
    print(f"search {res.space.name} verdict: paper config "
          f"{v['paper_objectives']} "
          + (f"dominated by {v['n_dominating']} discovered point(s), e.g. "
             f"{v['dominating_points'][0]['genome']}"
             if v["dominates_paper"] else
             "not dominated by any discovered point")
          + f"; on the frontier: {v['paper_on_frontier']}")


def phase_sim_search() -> dict:
    """9g: the seeded quick search card vs CPU, eight default-space genomes
    that differ only in lane data card vs CPU in one bucket, and the
    seeded default search on the card."""
    LS.launches = SE.launches = 0
    t0 = time.perf_counter()
    quick = SEARCH.search("quick", use_cache=False, device="cuda")
    quick_s = time.perf_counter() - t0
    quick_launches = LS.launches
    check(quick_launches == SE.launches
          == quick.provenance["dispatch_buckets"],
          f"quick search: {quick_launches} lru_scan and {SE.launches} "
          f"sim_epilogue launches, not one a dispatch "
          f"({quick.provenance['dispatch_buckets']})")
    print_search(quick, "the card", quick_s)
    t0 = time.perf_counter()
    quick_cpu = SEARCH.search("quick", use_cache=False, device="cpu")
    print_search(quick_cpu, "the CPU", time.perf_counter() - t0)
    worst = same_search(quick, quick_cpu, "quick search")
    print(f"quick search card vs CPU: the same {len(quick.candidates)} "
          f"genomes and {len(quick.frontier)} frontier genomes; objectives "
          f"max relative difference {worst:.3e} (rtol {SIM_RTOL:g})")

    # lanes of one bucket that differ in PWC latency, bypass and huge pages,
    # at the default space's largest geometry
    space = SEARCH.resolve_space("default")
    genomes = [(64, lat, (256, 8), 3072, "pl2", byp, huge)
               for lat in (2, 4) for byp in (True, False)
               for huge in (False, True)]
    traces = SEARCH._trace_table(space)
    jobs = [SIM.SimJob(SEARCH.build_machine(space, g), traces[w],
                       ("radix", SEARCH.mech_for(space, g)))
            for g in genomes for w in space.workloads]
    card, st = run_bucketed(jobs, chunk=space.chunk, device="cuda")
    cpu, _ = run_bucketed(jobs, chunk=space.chunk, device="cpu")
    check(st["buckets"] == 1, f"mixed-lane jobs in {st['buckets']} buckets")
    mixed = hold_card_vs_cpu(
        [f"{g} {w}" for g in genomes for w in space.workloads], card, cpu,
        "default-space genomes in one bucket")
    print(f"default-space genomes in one bucket card vs CPU ({len(jobs)} "
          f"jobs, PWC latency, bypass and huge pages per lane): counters "
          f"equal; cycles max relative difference {mixed:.3e}")

    LS.launches = SE.launches = 0
    t0 = time.perf_counter()
    res = SEARCH.search("default", use_cache=False, device="cuda")
    wall = time.perf_counter() - t0
    launches, ep_launches = LS.launches, SE.launches
    p = res.provenance
    check(p["evaluated"] >= 200, f"default search evaluated {p['evaluated']}"
                                 f", fewer than 200")
    check(p["runner_compiles"] <= p["distinct_buckets"],
          f"default search: {p['runner_compiles']} bucket plans for "
          f"{p['distinct_buckets']} distinct buckets")
    check(bool(res.frontier), "default search: empty frontier")
    check(launches == ep_launches == p["dispatch_buckets"],
          f"default search: {launches} lru_scan and {ep_launches} "
          f"sim_epilogue launches, not one a dispatch "
          f"({p['dispatch_buckets']})")
    print_search(res, "the card", wall)
    profiled("the default search",
             lambda: SEARCH.search("default", use_cache=False,
                                   device="cuda"))
    for c in res.frontier:
        o = c.objectives
        print(f"  frontier: {o['mean_speedup']:.4f} / {o['sram_kb']:.2f} KB "
              f"/ {o['worst_ptw']:.1f} cycles  {c.mech}  {dict(c.genome)}")
    return dict(launches=launches, ep_launches=ep_launches,
                quick_launches=quick_launches, evaluated=p["evaluated"],
                wall_s=wall, parity_max_rel=max(worst, mixed))


# ---------------------------------------------------------------------------
# phase 10: translation-costed serving and the fleet
# ---------------------------------------------------------------------------
#: derived costs are rounded to 3 decimals from float sums that agree to
#: rtol 1e-5 (card vs CPU), so the last digit may flip
COST_ATOL = 2e-3
#: the committed table against a fresh derivation: the reference's own
#: tolerance (tests/test_cost_model.py:48)
PINNED_RTOL = 0.05
#: lru_scan and sim_epilogue launches of one derivation at the
#: SERVING_COST point: 2,048 entries in chunks of 512, 8,000 in 1,024
COST_LAUNCHES = {"smoke": 4, "full": 8}
#: the request mixes and engine shape of the JAX package's costed serving
#: benchmark (benchmarks/serving_translation.py:56-59, :120), restated
COSTED_MIXES = {
    "decode_heavy": dict(n_requests=8, prompt=(3, 8), new_tokens=16),
    "prefill_heavy": dict(n_requests=6, prompt=(24, 40), new_tokens=4),
}
#: the benchmark's engine shape (phase 3's mix_bf16 case holds the paged
#: kernel at it)
COSTED_ENGINE = dict(max_batch=4, max_len=96, page_size=8)
#: the meter's per-request budgets partition its totals (the fleet
#: benchmark's own tolerance, benchmarks/serving_fleet.py:127)
METER_RTOL, METER_ATOL = 1e-9, 1e-6
#: surrogate decode steps traced with torch.profiler in 10c
FLEET_PROFILE_STEPS = 5


def hold_costs(got, want, what: str, *, atol: float = 0.0,
               rtol: float = 0.0) -> float:
    """``tlb_hit`` and ``org`` equal; ``walk`` and ``pte_line`` within
    ``atol`` + ``rtol`` x |want|.  Returns the largest difference."""
    check(got.mechs == want.mechs, f"{what}: mechanisms {got.mechs} != "
                                   f"{want.mechs}")
    worst = 0.0
    for m in want.mechs:
        g, w = got.cost(m), want.cost(m)
        check(g.tlb_hit == w.tlb_hit and g.org == w.org,
              f"{what}: {m} tlb_hit/org {g.tlb_hit}/{g.org} != "
              f"{w.tlb_hit}/{w.org}")
        for a, b in ((g.walk, w.walk), (g.pte_line, w.pte_line)):
            check(abs(a - b) <= atol + rtol * abs(b),
                  f"{what}: {m} cost {a} vs {b} beyond atol {atol} rtol "
                  f"{rtol}")
            worst = max(worst, abs(a - b))
    return worst


def print_cost_tables(tables: dict) -> None:
    first = next(iter(tables.values()))
    print(f"cost tables (simulated cycles of {first.machine}), "
          + " | ".join(tables))
    for m in first.mechs:
        print(f"  {m:>9}: " + " | ".join(
            f"tlb_hit {t.cost(m).tlb_hit:g}, walk {t.cost(m).walk:.3f}, "
            f"pte_line {t.cost(m).pte_line:.3f}, org {t.cost(m).org}"
            for t in tables.values()))


def phase_cost_table() -> dict:
    """10a: the SERVING_COST table derived through the simulator kernels
    on the card, at the smoke preset and the full one, each held against
    the port's CPU derivation at COST_ATOL."""
    mach = ndp_machine(int(SERVING_COST["cores"]))
    SIM.clear_runner_cache()                 # count this phase's plans
    tables, out = {}, {}
    for preset in ("smoke", "full"):
        plans0 = SIM.runner_cache_info().misses
        LS.launches = SE.launches = 0
        t0 = time.perf_counter()
        model = TranslationCostModel.from_sim(
            mach, preset=preset, use_cache=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (LS.launches, SE.launches)
        plans = SIM.runner_cache_info().misses - plans0
        check(model.source == "sweep", f"cost table source {model.source}")
        check(launches == (COST_LAUNCHES[preset],) * 2,
              f"{preset} cost table: lru_scan, sim_epilogue launches "
              f"{launches}, not {COST_LAUNCHES[preset]} each")
        check(plans == 1, f"{preset} cost table: {plans} bucket plans")
        print(f"cost table, {preset} preset, on the card: {wall:.3f} s "
              f"(trace included), lru_scan {launches[0]} and sim_epilogue "
              f"{launches[1]} launches, {plans} bucket plan")
        tables[f"card {preset}"] = model
        out[preset] = dict(launches=launches[0], ep_launches=launches[1],
                           wall_s=wall)
    # both tables card vs the port's CPU derivation (the full one's walks
    # come through the same two kernels at 1,024-step chunks)
    diff = {}
    for preset in ("smoke", "full"):
        t0 = time.perf_counter()
        cpu = TranslationCostModel.from_sim(mach, preset=preset,
                                            use_cache=False, device="cpu")
        print(f"cost table, {preset} preset, on the CPU: "
              f"{time.perf_counter() - t0:.3f} s")
        diff[preset] = hold_costs(tables[f"card {preset}"], cpu,
                                  f"{preset} card vs CPU", atol=COST_ATOL)
        tables[f"CPU {preset}"] = cpu
    card = tables["card smoke"]
    hold_costs(card, TranslationCostModel.pinned(), "card vs PINNED_COSTS",
               rtol=PINNED_RTOL)
    check(card.cost("ndpage").walk < card.cost("radix").walk,
          "ndpage's walk is not cheaper than radix's")
    ideal = card.cost("ideal")
    check((ideal.tlb_hit, ideal.walk, ideal.pte_line) == (0.0, 0.0, 0.0),
          f"ideal costs {ideal}")
    print_cost_tables(tables)
    print(f"cost table card vs CPU: max |diff| {diff['smoke']:.3g} cycles "
          f"at the smoke preset, {diff['full']:.3g} at the full one (atol "
          f"{COST_ATOL:g}); the smoke table vs PINNED_COSTS "
          f"({PINNED_COSTS['machine']}) within rtol {PINNED_RTOL:g}")
    return dict(model=card, **out)


def meter_conserved(meter) -> bool:
    """The meter's per-request budgets partition its totals."""
    budgets = meter.request_budgets()
    if not budgets:
        return bool(meter.total.sum() == 0.0)
    acc = np.sum(list(budgets.values()), axis=0)
    return bool(np.allclose(acc, meter.total, rtol=METER_RTOL,
                            atol=METER_ATOL))


def check_costed(eng, done, n_requests: int, what: str) -> dict:
    """The checks of the JAX package's costed serving benchmark, and the
    meter's own accounting; returns ``throughput()``."""
    rep = eng.throughput()
    tps = rep["tokens_per_sec"]
    check(len(done) == n_requests,
          f"{what}: {len(done)} of {n_requests} requests finished")
    check(rep["tcache_hits"] + rep["tcache_misses"] == rep["tokens"],
          f"{what}: hits {rep['tcache_hits']} + misses "
          f"{rep['tcache_misses']} != {rep['tokens']} priced tokens")
    check(tps["ndpage"] >= tps["radix"], f"{what}: ndpage below radix")
    check(all(tps["ideal"] >= v - 1e-9 for v in tps.values()),
          f"{what}: ideal is not the upper bound")
    check(meter_conserved(eng.meter),
          f"{what}: per-request budgets do not partition the totals")
    return rep


def print_costed(what: str, rep: dict, wall: float, generated: int) -> None:
    print(f"{what}: {wall:.3f} s wall, {rep['steps']} steps, card "
          f"{generated / wall:.1f} generated tokens/s; {rep['tokens']} "
          f"priced tokens, tcache hits {rep['tcache_hits']}, misses "
          f"{rep['tcache_misses']}; simulated tokens/s of the NDP machine: "
          + ", ".join(f"{m} {v:.1f}" for m, v in
                      rep["tokens_per_sec"].items())
          + "; translation cycles: "
          + ", ".join(f"{m} {v:.1f}" for m, v in
                      rep["translation_cycles"].items()))


def phase_costed_serve(cost: dict, uncosted: dict) -> dict:
    """10b: phase 4's requests through the launcher with ``--cost-model
    sweep``, then the costed serving benchmark's two mixes, at full
    width on the card."""
    args = SERVE.build_parser().parse_args(["--cost-model", "sweep"])
    # the meter's own host time, summed around its calls
    record_step, meter_s = TranslationMeter.record_step, [0.0]

    def timed_record_step(self, *a, **kw):
        t0 = time.perf_counter()
        record_step(self, *a, **kw)
        meter_s[0] += time.perf_counter() - t0

    TranslationMeter.record_step = timed_record_step
    PA.launches = 0
    try:
        out = SERVE.serve(args)
    finally:
        TranslationMeter.record_step = record_step
    launches = PA.launches
    cfg, eng, done = out["cfg"], out["engine"], out["done"]
    steps = eng.sched.stats["steps"]
    got = {r.req_id: list(r.generated) for r in done}
    check(got == uncosted, "costed serving changed the generated tokens")
    check(launches == cfg.num_layers * steps,
          f"costed paged_attention launches {launches} != "
          f"{cfg.num_layers} layers x {steps} steps")
    rep = check_costed(eng, done, args.requests, "costed serve")
    print(f"costed serve: cost table {out['cost_model'].source} "
          f"({out['cost_seconds']:.3f} s), tokens equal phase 4's, "
          f"paged_attention launches {launches} = {cfg.num_layers} x "
          f"{steps} steps")
    print_costed("costed serve", rep, out["seconds"],
                 sum(len(t) for t in got.values()))
    print(f"costed serve: the meter's host time {meter_s[0]:.4f} s of "
          f"{out['seconds']:.3f} s ({meter_s[0] / steps * 1e6:.1f} us a "
          f"step)")
    del out, eng
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(cfg, gen, "cuda")
    mix_launches = {}
    for mi, (name, mix) in enumerate(COSTED_MIXES.items()):
        rng = np.random.default_rng(args.seed * 1000 + mi)
        eng = ServeEngine(cfg, params, **COSTED_ENGINE,
                          cost_model=cost["model"], device="cuda")
        lo, hi = mix["prompt"]
        for i in range(mix["n_requests"]):
            prompt = rng.integers(1, cfg.vocab_size,
                                  rng.integers(lo, hi)).astype(np.int32)
            eng.submit(Request(req_id=i, prompt=prompt,
                               max_new_tokens=mix["new_tokens"]))
        PA.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.sched.stats["steps"]
        check(PA.launches == cfg.num_layers * steps,
              f"{name}: paged_attention launches {PA.launches} != "
              f"{cfg.num_layers} x {steps} steps")
        check(all(len(r.generated) == mix["new_tokens"] for r in done),
              f"{name}: a request finished without its new tokens")
        rep = check_costed(eng, done, mix["n_requests"], name)
        mix_launches[name] = PA.launches
        print_costed(f"costed {name} (full width)", rep, wall,
                     sum(len(r.generated) for r in done))
        del eng
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, mix_launches=mix_launches)


def fleet_mix(p: dict, seed: int, shared: bool) -> list:
    """One run's requests (benchmarks/serving_fleet.py:_mix, restated)."""
    rng = np.random.default_rng(seed)
    reqs = []
    if shared:
        prefixes = {g: rng.integers(1, 30_000, p["prefix_len"])
                    for g in range(p["prefix_groups"])}
        for i in range(p["num_requests"]):
            g = i % p["prefix_groups"]
            tail = rng.integers(1, 30_000, p["tail_tokens"])
            reqs.append(Request.build(
                i, np.concatenate([prefixes[g], tail]),
                max_new_tokens=p["new_tokens"], prefix_id=g,
                prefix_len=p["prefix_len"]))
    else:
        lo, hi = p["independent_prompt"]
        for i in range(p["num_requests"]):
            prompt = rng.integers(1, 30_000, rng.integers(lo, hi))
            reqs.append(Request.build(i, prompt,
                                      max_new_tokens=p["new_tokens"]))
    return reqs


def fleet_run(p: dict, model, reqs, *, prefix_sharing: bool,
              translation_budget=None, device="cuda"):
    eng = FleetEngine(max_batch=p["max_batch"], max_len=p["max_len"],
                      page_size=p["page_size"], leaf_size=p["leaf_size"],
                      cost_model=model, prefix_sharing=prefix_sharing,
                      translation_budget=translation_budget,
                      budget_mech=p["budget_mech"], device=device)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    rep = eng.throughput()
    rep["finished"] = done
    rep["wall_s"] = time.perf_counter() - t0
    return rep, eng


def profile_fleet_decode(p: dict) -> None:
    """The CUDA kernels, memsets and copies of a surrogate decode step at
    the fleet's slot count, the host copies in and out included."""
    decode = FLEET._decode_fn(FLEET.VOCAB, torch.device("cuda"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, 30_000, p["max_batch"]).astype(np.int32))
    pos = torch.from_numpy(
        rng.integers(0, p["max_len"], p["max_batch"]).astype(np.int32))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    decode(tokens, pos).cpu()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(FLEET_PROFILE_STEPS):
            decode(tokens, pos).cpu()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    print(f"fleet decode step on the card (torch.profiler over "
          f"{FLEET_PROFILE_STEPS} steps of {p['max_batch']} slots): "
          f"{sum(names.values()) / FLEET_PROFILE_STEPS:.1f} CUDA kernels "
          f"and copies a step: " + ", ".join(
              f"{v} x {k[:60]}" for k, v in sorted(
                  names.items(), key=lambda kv: -kv[1])))


def phase_fleet(cost: dict) -> dict:
    """10c: the four runs of the JAX package's fleet benchmark at the
    SERVING_FLEET scale (1,024 slots, 1,536 requests), seed 0, decode on
    the card, with its gates restated; the shared run again with the
    decode on the CPU."""
    p = {k: v for k, v in SERVING_FLEET.items() if k != "smoke"}
    model, seed = cost["model"], 0
    fns0 = FLEET.decode_trace_count()
    runs, engines = {}, {}
    runs["shared"], engines["shared"] = fleet_run(
        p, model, fleet_mix(p, seed, True), prefix_sharing=True)
    runs["unshared"], engines["unshared"] = fleet_run(
        p, model, fleet_mix(p, seed, True), prefix_sharing=False)
    runs["independent"], engines["independent"] = fleet_run(
        p, model, fleet_mix(p, seed + 1, False), prefix_sharing=True)
    runs["budget"], engines["budget"] = fleet_run(
        p, model, fleet_mix(p, seed, True), prefix_sharing=True,
        translation_budget=p["translation_budget"])
    fns = FLEET.decode_trace_count() - fns0

    n = p["num_requests"]
    target = min(p["max_batch"], n)
    sh, un, bud = runs["shared"], runs["unshared"], runs["budget"]
    gen = {name: {r.req_id: list(r.generated) for r in rep["finished"]}
           for name, rep in runs.items()}
    tps_sh, tps_un = sh["tokens_per_sec"], un["tokens_per_sec"]
    cyc_sh, cyc_un = sh["translation_cycles"], un["translation_cycles"]
    bs = bud["stats"]
    checks = {
        "fleet_concurrency": all(runs[r]["peak_running"] >= target
                                 for r in ("shared", "unshared",
                                           "independent")),
        "one_decode_function": fns <= 1,
        "all_completed": all(len(gen[r]) == n for r in (
            "shared", "unshared", "independent")),
        "tokens_exact_on_off": gen["shared"] == gen["unshared"],
        "ndpage_ge_radix": all(rep["tokens_per_sec"]["ndpage"]
                               >= rep["tokens_per_sec"]["radix"]
                               for rep in runs.values()),
        "ideal_upper_bound": all(rep["tokens_per_sec"]["ideal"] >= v - 1e-9
                                 for rep in runs.values()
                                 for v in rep["tokens_per_sec"].values()),
        "radix_gains_cycles": cyc_sh["radix"] < cyc_un["radix"],
        "radix_gains_tps": tps_sh["radix"] > tps_un["radix"],
        "flat_immune": cyc_sh["ndpage"] == cyc_un["ndpage"],
        "sharing_gap_radix_over_flat": (
            tps_sh["radix"] / tps_un["radix"]
            > tps_sh["ndpage"] / tps_un["ndpage"]),
        "budget_caps_concurrency":
            bud["peak_running"] < sh["peak_running"],
        "budget_conserves_requests": bs["completed"] + bs["shed"] == n,
        "meter_conserved": all(meter_conserved(e.meter)
                               for e in engines.values()),
    }
    meter = engines["shared"].meter
    speedups = []
    for mcpt in p["mcpt_grid"]:
        tps = meter.tokens_per_sec(model_cycles_per_token=mcpt)
        speedups.append(tps["ndpage"] / tps["radix"])
    checks["mcpt_speedup_monotone"] = all(
        a >= b - 1e-9 for a, b in zip(speedups, speedups[1:]))
    checks["translation_matters_at_low_mcpt"] = speedups[0] > speedups[-1]
    failed = [k for k, v in checks.items() if not v]
    check(not failed, f"fleet gates failed: {failed}")

    for name, rep in runs.items():
        st, tps = rep["stats"], rep["tokens_per_sec"]
        print(f"fleet {name}: {rep['wall_s']:.3f} s wall, {rep['steps']} "
              f"steps, peak running {rep['peak_running']}, completed "
              f"{st['completed']}/{n}, shed {st['shed']}, preempted "
              f"{st['preempted']}; {rep['tokens']} priced tokens (hits "
              f"{rep['tcache_hits']}, misses {rep['tcache_misses']}); "
              f"simulated tokens/s: "
              + ", ".join(f"{m} {v:.1f}" for m, v in tps.items())
              + f"; ndpage/radix {tps['ndpage'] / tps['radix']:.4f}")
    print(f"fleet sharing gap in simulated tokens/s: radix "
          f"{(tps_sh['radix'] / tps_un['radix'] - 1) * 100:.3f}%, ndpage "
          f"{(tps_sh['ndpage'] / tps_un['ndpage'] - 1) * 100:.3f}%")
    print("fleet mcpt sweep (ndpage/radix of the shared run's totals): "
          + ", ".join(f"{m:g} {s:.4f}" for m, s in
                      zip(p["mcpt_grid"], speedups)))
    print(f"fleet gates: all {len(checks)} passed; decode functions built "
          f"for the four card runs: {fns}")

    cpu, cpu_eng = fleet_run(p, model, fleet_mix(p, seed, True),
                             prefix_sharing=True, device="cpu")
    cpu_gen = {r.req_id: list(r.generated) for r in cpu["finished"]}
    check(cpu_gen == gen["shared"], "fleet card vs CPU: tokens differ")
    check(cpu_eng.meter.total.tolist() == meter.total.tolist()
          and cpu["stats"] == sh["stats"],
          "fleet card vs CPU: meter totals or stats differ")
    print(f"fleet shared run card vs CPU: tokens, stats and meter totals "
          f"identical (CPU decode: {cpu['wall_s']:.3f} s wall)")
    profile_fleet_decode(p)
    return {name: dict(wall_s=rep["wall_s"], steps=rep["steps"],
                       peak_running=rep["peak_running"])
            for name, rep in runs.items()}


#: cuts of csrc/sim_epilogue.cu that time its parts (--sim-times): the
#: launch alone (the kernel returns at once) and the launch with the step
#: pass (it returns before the fold); each inserts a line before an anchor
EPILOGUE_CUTS = {
    "launch": ("  // the state the fold adds into, brought to L2",
               "  if (p.T > 0) return;\n"),
    "step_pass": ("  // the last block of this column tile folds its tiles",
                  "  return;\n"),
}


def build_epilogue_cuts() -> dict:
    """EPILOGUE_CUTS built, one nvcc each, in parallel: name -> library
    path; empty where the source has no anchors (another tree's)."""
    src = (_build.CSRC / "sim_epilogue.cu").read_text()
    if not all(anchor in src for anchor, _ in EPILOGUE_CUTS.values()):
        return {}
    out_dir = _build.BUILD_DIR / "cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (anchor, line) in EPILOGUE_CUTS.items():
        cu = out_dir / f"sim_epilogue_{name}.cu"
        cu.write_text(src.replace(anchor, line + anchor, 1))
        lib = cu.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"epilogue cut {name}: nvcc failed\n{log}")
    return {name: lib for name, (lib, _) in procs.items()}


def use_epilogue_library(path=None) -> None:
    """Route SE's launches through the library at ``path`` (a cut), or
    back to the built kernel with None."""
    _build._libs.pop("sim_epilogue", None)
    if path is not None:
        _build._libs["sim_epilogue"] = ctypes.CDLL(str(path))
    SE._lib_handle = None
    SE.geometry.cache_clear()
    SE._lib()


def sim_times() -> None:
    """``--sim-times``: the epilogue kernel on the middle chunk of each
    9b bucket, the banked ndp(8) and cpu(8) buckets and the sweep
    geometries (L2 flushed), and the same with the kernel cut after its
    launch and after its step pass (this tree's source only), then the
    walls of 9b's six buckets, 9f's nine sweeps and 9g's default search.
    It calls only what the port's package has had since the epilogue's
    first design, so with CHIP_SMOKE_SRC it times another checkout's
    kernels in the same way."""
    print(f"sim-times: the port from {SIM.__file__}")
    _build.build_all(["lru_scan", "sim_epilogue"])
    cases = [(f"{m}{c}", m, c, "bounded_linear", (), DEFAULT_MECHS)
             for c in (1, 4, 8) for m in ("ndp", "cpu")] + [
        (f"banked_{m}8", m, 8, "banked", (), DEFAULT_MECHS)
        for m in ("ndp", "cpu")] + [
        (tag, "ndp", 8, "bounded_linear", params, mechs)
        for tag, params, mechs in SWEEP_GEOMETRIES]
    chunks = {}
    for tag, machine, cores, memory, params, mechs in cases:
        bk, state = sim_bucket(machine, cores, PRESETS["full"], mechs,
                               memory=memory, params=params)
        k = bk.n_chunks // 2
        for i in range(k):
            SIM._run_chunk(bk, state, i)
        args = SIM._scan_inputs(bk, state, k)
        work = args.pop("work")
        packed = LS._launch(**args)
        chunks[tag] = epilogue_args(bk, state, dict(args, work=work), packed)

    def time_chunks() -> dict:
        out = {}
        for tag, ep in chunks.items():
            saved = [t.clone() for t in state_out(ep)]

            def restore():
                for t, s in zip(state_out(ep), saved):
                    t.copy_(s)

            out[tag] = time_device_ms(lambda: SE._launch(**ep), restore,
                                      iters=20)
            restore()
        return out

    whole = time_chunks()
    cuts = build_epilogue_cuts()
    parts = {}
    for name, lib in cuts.items():
        use_epilogue_library(lib)
        parts[name] = time_chunks()
    if cuts:
        use_epilogue_library()
    for tag, ms in whole.items():
        line = (f"sim-times {tag}: sim_epilogue {ms:.4f} ms a 1,024-step "
                f"chunk (L2 flushed)")
        if parts:
            launch, pass_ = parts["launch"][tag], parts["step_pass"][tag]
            line += (f"; cut after the launch {launch:.4f} ms, after the "
                     f"step pass {pass_:.4f} ms: launch {launch:.4f}, step "
                     f"pass {pass_ - launch:.4f}, fold {ms - pass_:.4f}")
        print(line)
    del chunks
    parser = SIMLAUNCH.build_parser()
    for _ in range(2):           # the second: bucket plans made
        buckets = SIMLAUNCH.run(parser.parse_args([]))
        print(f"sim-times 9b: 6 full-preset buckets in "
              f"{sum(bk['wall_s'] for bk in buckets):.3f} s of "
              f"simulate_batch")
    t0 = time.perf_counter()
    SIMLAUNCH.run_sweeps(parser.parse_args(["--sweep", ",".join(SWEEPS)]),
                         show_points=False)
    print(f"sim-times 9f: the nine sweeps in {time.perf_counter() - t0:.3f} "
          f"s")
    t0 = time.perf_counter()
    SEARCH.search("default", use_cache=False, device="cuda")
    print(f"sim-times 9g: the default search in "
          f"{time.perf_counter() - t0:.3f} s")


def banked_keys(banked: dict, kernel: str) -> dict:
    """The banked path's launches and chunk times of one simulator kernel,
    for its row of the kernels line."""
    out = {"banked_launches": banked["launches" if kernel == "lru_scan"
                                     else "ep_launches"]}
    for (machine, cores), t in banked["timed"].items():
        tag = "banked" if machine == "ndp" else f"banked_{machine}{cores}"
        out.update({f"{tag}_{k}": v for k, v in t[kernel].items()
                    if k.endswith("ms")})
    return out


def sweep_search_keys(sim: dict, kernel: str) -> dict:
    """The launches of one simulator kernel on the sweep and search paths
    (9f, 9g) and its chunk times at the sweep and search geometries."""
    key = "launches" if kernel == "lru_scan" else "ep_launches"
    out = {"sweep_launches": sim["sweeps"][key],
           "search_launches": sim["search"][key]}
    for tag, t in sim["sweeps"]["timed"].items():
        out.update({f"{tag}_{k}": v for k, v in t[kernel].items()
                    if k.endswith("ms")})
    return out


# ---------------------------------------------------------------------------
# phase 17: the parallel paths, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------
#: two ranks, both on cuda:0: NCCL refuses two ranks on one device, so the
#: group is gloo, which takes CUDA tensors for its all-reduce, broadcast
#: and all-gather (send and receive are staged through the host,
#: ``parallel/comm.py``); every collective's time includes gloo's own trip
#: through host memory
PAR_WORLD = 2
#: 17a: phase 8's 3,072-token sequence, one a rank, 2 layers at full width
PAR_TRAIN_TOKENS = 3072
#: 17b: the launcher at full width, 4 of internlm2's 24 layers (8 until
#: 17d was added), 2 steps of 4 x 4,096 tokens a rank in 2 microbatches;
#: the ranks' peaks must sum under
PAR_LAUNCHER = dict(layers=4, steps=2, microbatches=2)
PAR_LAUNCHER_PEAK_GIB = 70.0
#: 17c: phase 5's engine and requests, 2 layers at full width in float32,
#: on a (1, 2) mesh: internlm2's 8 kv heads divide the model axis (each
#: rank 8 / 4 heads); gemma3-1b's one kv head does not, and its pools fit
#: the budget: query-head mode (each rank 2 / 1 heads)
PAR_ENGINE = dict(max_batch=3, max_len=64, page_size=16)
PAR_REQUESTS = dict(n=4, prompt_range=(8, 24), new_tokens=8, seed=1)
PAR_DECODE = {"internlm2-1.8b": "kv", GEMMA: "qhead"}
PAR_DECODE_LAYERS = 2
#: 17d: tensor parallelism on a (1, 2) mesh, one float32 step of 17a's
#: shape (2 layers at full width, one 3,072-token sequence, read by both
#: ranks): internlm2-1.8b's kv heads split (8 / 4 heads of 128 a rank,
#: the simt route at D 128), gemma3-1b's one kv head whole on both ranks
#: (2 / 1 heads of 256, simt NT 32, its window layers) and its tied vocab
#: of 262,144 split; each rank's simt launches (forward with the remat
#: recompute, backward)
PAR_TP = ("internlm2-1.8b", GEMMA)
PAR_TP_SEED = 3
PAR_TP_LAUNCHES = (2 * PAR_DECODE_LAYERS, PAR_DECODE_LAYERS)
#: 17d's update gate reads the elements whose clipped gradient c g is at
#: least this many times AdamW's eps: there step 1's g / (|g| + eps) is
#: sign(g) to within eps |dg| / g^2, under 1e-5 of the update for the
#: gradients' summation-order noise; nearer 0 that noise moves it by up
#: to the whole update
PAR_TP_UPDATE_MIN_EPS = 1e3


def par_cfg(arch: str) -> C.ArchConfig:
    return dataclasses.replace(C.get_arch(arch), num_layers=PAR_DECODE_LAYERS,
                               dtype="float32")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def par_requests(cfg) -> list:
    p = PAR_REQUESTS
    return SERVE.make_requests(p["n"], cfg.vocab_size, p["prompt_range"],
                               p["new_tokens"], seed=p["seed"])


def par_decode_reference() -> dict:
    """17c's one-rank side, on the card in this process: the engine's
    streams, greedy_reference's and the prefill logits of request 0."""
    out = {}
    for arch in PAR_DECODE:
        cfg = par_cfg(arch)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
        eng = ServeEngine(cfg, model, **PAR_ENGINE, device="cuda")
        reqs = par_requests(cfg)
        for r in reqs:
            eng.submit(r)
        engine = {r.req_id: list(r.generated) for r in eng.run()}
        greedy = {r.req_id: greedy_reference(
            cfg, model, r.prompt, PAR_REQUESTS["new_tokens"],
            kv_mode=BT.FLAT, max_len=PAR_ENGINE["max_len"],
            page_size=PAR_ENGINE["page_size"], device="cuda") for r in reqs}
        logits, _ = prefill(model, cfg, torch.tensor(
            reqs[0].prompt[None], device="cuda"), kv_mode=BT.FLAT,
            max_len=PAR_ENGINE["max_len"], page_size=PAR_ENGINE["page_size"])
        out[arch] = {"engine": engine, "greedy": greedy,
                     "logits": logits.cpu().numpy()}
        del model, eng
    torch.cuda.empty_cache()
    return out


def par_train_rank(rank: int, world: int, dev, mesh) -> dict:
    """17a on one rank: the averaged gradients and the data-parallel
    step, then rank 0's one-rank step on both sequences in two
    microbatches; then the step with ``compress``, each rank's float32
    gradients and int8 codes gathered to rank 0 and the formula applied
    there."""
    from repro_torch.parallel import comm
    from repro_torch.parallel import compression as CMP
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_loop import decayed_names

    cfg = par_cfg("internlm2-1.8b")
    opt = AdamWConfig(total_steps=10)
    group = mesh.get_group("data")
    data = DATA.SyntheticLM(cfg.vocab_size, PAR_TRAIN_TOKENS, world)
    mine = {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(0, rank, world).items()}
    out = {}

    # the data-parallel step, its flash launches counted and the averaged
    # gradients it hands to AdamW recorded (the update overwrites them)
    state = init_train_state(cfg, 2, dev)
    p0 = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    avg = {}

    def recorded(opt_cfg, params, grads, *args, **kw):
        avg.update({n: g.detach().clone() for n, g in grads.items()})
        return adamw_update(opt_cfg, params, grads, *args, **kw)

    comm.reset_stats()
    zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(TL, "adamw_update", recorded):
        state, m = make_train_step(cfg, opt, 1, mesh=mesh)(state, mine)
    torch.cuda.synchronize()
    out["dp_s"] = time.perf_counter() - t0
    out["simt_launches"] = (FA.launches_fwd, FA.launches_bwd)
    out["sm90_launches"] = (FA.launches_sm90_fwd, FA.launches_sm90_bwd)
    out["dp_bytes"] = comm.stats["bytes"]
    out["loss"] = m["loss"]
    out["checksum"] = sum(float(p.detach().double().sum())
                          for p in state.params.parameters())
    if rank == 0:
        both = {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(0).items()}
        ref = init_train_state(cfg, 2, dev)
        g_ref = {n: torch.zeros(p.shape, device=dev)
                 for n, p in ref.params.named_parameters()}
        for i in range(world):
            mb = {k: v[i:i + 1] for k, v in both.items()}
            l_i, _ = loss_fn(ref.params, cfg, mb)
            l_i.backward()
            for n, p in ref.params.named_parameters():
                g_ref[n].add_(p.grad)
                p.grad = None
        out["grad_rel"] = max(rel_err(avg[n], g / world)
                              for n, g in g_ref.items())
        check(sorted(avg) == sorted(g_ref), "17a: the step's gradients "
                                            "were not recorded")
        del g_ref
        ref, m_ref = make_train_step(cfg, opt, world)(ref, both)
        out["ref_loss"] = m_ref["loss"]
        params = dict(state.params.named_parameters())
        out["update_rel"] = max(
            rel_err(params[n].detach() - p0[n], p.detach() - p0[n])
            for n, p in ref.params.named_parameters())
        del ref
    del avg, state
    torch.cuda.empty_cache()

    # the step with compress: record this rank's float32 gradients as the
    # int8 all-reduce receives them
    seen = {}
    reduce = CMP.make_dp_int8_allreduce(mesh)

    def recording(grads):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return reduce(grads)

    state = init_train_state(cfg, 2, dev)
    state, _ = make_train_step(cfg, opt, 1, mesh=mesh,
                               compress=recording)(state, mine)
    codes_equal, mean = True, {}
    for n, g in seen.items():
        s_max = comm.all_reduce(CMP.quantize_int8(g)[1].clone(), group,
                                torch.distributed.ReduceOp.MAX)
        codes = comm.all_gather(CMP.requantize_int8(g, s_max)[None], group)
        grads = comm.all_gather(g[None], group)
        if rank == 0:
            # the formula, written out: each rank's scale, the largest,
            # the codes against it, their int32 sum, times it over world
            scales = [x.abs().max() / 127.0 + 1e-12 for x in grads]
            big = torch.stack(scales).max()
            q = [torch.clamp(torch.round(x / big), -127, 127).to(torch.int8)
                 for x in grads]
            codes_equal &= all(torch.equal(a, b) for a, b in zip(q, codes))
            total = sum(c.to(torch.int32) for c in q)
            mean[n] = total.float() * big / float(world)
        del codes, grads
    if rank == 0:
        ref = init_train_state(cfg, 2, dev)
        params = dict(ref.params.named_parameters())
        adamw_update(opt, params, mean, ref.opt,
                     decay=decayed_names(ref.params))
        got = dict(state.params.named_parameters())
        out["compress_codes_equal"] = codes_equal
        out["compress_update_max_abs"] = max(
            float((got[n].detach() - p.detach()).abs().max())
            for n, p in params.items())
    del seen, state, mean
    torch.cuda.empty_cache()
    return out


def par_decode_rank(rank: int, world: int, dev, mesh) -> dict:
    """17c on one rank: the engine over the (1, world) mesh, the prefill
    logits under it, the paged kernel's launches."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.context import use_mesh
    from repro_torch.serving import shard_requests

    out = {}
    for arch, mode in PAR_DECODE.items():
        cfg = par_cfg(arch)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                            dev)
        eng = ServeEngine(cfg, model, **PAR_ENGINE, device=dev, mesh=mesh)
        kp = eng.state["stack"][0]["kp"]
        got_mode = SH.paged_mode(mesh, cfg, n_pages=kp.shape[0],
                                 page=kp.shape[1])
        for r in shard_requests(par_requests(cfg), mesh):
            eng.submit(r)
        PA.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = PA.launches
        prompt = torch.tensor(par_requests(cfg)[0].prompt[None], device=dev)
        with use_mesh(mesh):
            logits, _ = prefill(model, cfg, prompt, kv_mode=BT.FLAT,
                                max_len=PAR_ENGINE["max_len"],
                                page_size=PAR_ENGINE["page_size"])
        out[arch] = {"mode": got_mode, "pool": tuple(kp.shape),
                     "streams": {r.req_id: list(r.generated) for r in done},
                     "launches": launches, "steps": eng.sched.stats["steps"],
                     "seconds": secs, "logits": logits.cpu().numpy()}
        del model, eng
    return out


def par_tp_batch(cfg, dev) -> dict:
    data = DATA.SyntheticLM(cfg.vocab_size, PAR_TRAIN_TOKENS, 1)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(0).items()}


def par_tp_step(cfg, state, dev, mesh=None):
    """One step of 17d, the gradients handed to AdamW recorded, timed,
    its flash launches and collective bytes counted."""
    from repro_torch.parallel import comm

    handed, update = {}, TL.adamw_update

    def recorded(opt_cfg, params, grads, *args, **kw):
        handed.update({n: g.detach().clone() for n, g in grads.items()})
        return update(opt_cfg, params, grads, *args, **kw)

    step = make_train_step(cfg, AdamWConfig(total_steps=10), 1, mesh=mesh)
    batch = par_tp_batch(cfg, dev)
    comm.reset_stats()
    zero_flash_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with mock.patch.object(TL, "adamw_update", recorded):
        state, m = step(state, batch)
    torch.cuda.synchronize(dev)
    return state, handed, {
        "loss": m["loss"], "grad_norm": m["grad_norm"],
        "s": time.perf_counter() - t0,
        "bytes": comm.stats["bytes"], "calls": comm.stats["calls"],
        "simt": (FA.launches_fwd, FA.launches_bwd),
        "other_routes": route_launches()}


def par_tp_reference(ref_dir: str) -> dict:
    """17d's one-rank step of each arch, computed once in this process
    before the ranks start (TF32 off, as in the ranks): the gradients it
    hands to AdamW and the parameters after it saved to ``ref_dir`` (the
    ranks read their blocks), its loss, time and launches returned."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(ref_dir, exist_ok=True)
    out = {}
    for arch in PAR_TP:
        cfg = par_cfg(arch)
        state = init_train_state(cfg, PAR_TP_SEED, "cuda")
        state, grads, info = par_tp_step(cfg, state, "cuda")
        torch.save({"grads": {n: g.cpu() for n, g in grads.items()},
                    "params": {n: p.detach().cpu() for n, p in
                               state.params.named_parameters()}},
                   os.path.join(ref_dir, f"{arch}.pt"))
        out[arch] = info
        del state, grads
        torch.cuda.empty_cache()
    return out


def par_tp_rank(rank: int, world: int, dev, mesh, ref_dir: str,
                norms: dict) -> dict:
    """17d on one rank: each arch's tensor-parallel step from the same
    seed as the one-rank step, its gradients, AdamW moments and update
    against the rank's blocks of the one-rank step's (``norms``: its
    gradient norms)."""
    from repro_torch.parallel import tensor as TPAR

    tp = TPAR.tensor_parallel(mesh)
    out = {}
    for arch in PAR_TP:
        ref_norm = norms[arch]
        cfg = par_cfg(arch)
        state = TL.shard_train_state(init_train_state(cfg, PAR_TP_SEED, dev),
                                     mesh, cfg)
        layout = getattr(state.params, TL.MODEL_LAYOUT)
        p0 = {n: p.detach().clone()
              for n, p in state.params.named_parameters()}
        torch.cuda.reset_peak_memory_stats(dev)
        state, grads, info = par_tp_step(cfg, state, dev, mesh)
        info["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        ref = torch.load(os.path.join(ref_dir, f"{arch}.pt"), mmap=True,
                         weights_only=True)

        def mine(t, name):
            if name in layout:
                t = t.chunk(tp.size, layout[name])[tp.rank]
            return t.to(dev)

        params = dict(state.params.named_parameters())
        info["grad_rel"] = max(rel_err(g, mine(ref["grads"][n], n))
                               for n, g in grads.items())
        # AdamW's moments after its first step, the state step 2 reads,
        # from the one-rank step's gradients and clip (its norm): mu =
        # (1 - b1) c g, nu = (1 - b2) (c g)^2
        opt = AdamWConfig()
        clip = min(1.0, opt.clip_norm / ref_norm)
        info["mu_rel"] = max(rel_err(state.opt["mu"][n], mine(
            ref["grads"][n], n) * (1 - opt.b1) * clip) for n in params)
        info["nu_rel"] = max(rel_err(state.opt["nu"][n], torch.square(
            mine(ref["grads"][n], n) * clip) * (1 - opt.b2)) for n in params)
        # the update AdamW applied to the rank's blocks against the one
        # rank's, of its largest element, where |c g| >= 1e3 eps
        # (PAR_TP_UPDATE_MIN_EPS), less one float32 spacing of the new
        # weight (p + lr u rounds to a neighbour when u moves by the
        # noise); the share of elements read
        worst, kept, total = 0.0, 0, 0
        for n, p in params.items():
            want_p = mine(ref["params"][n], n)
            want = want_p - p0[n]
            keep = (mine(ref["grads"][n], n) * clip).abs() >= (
                PAR_TP_UPDATE_MIN_EPS * opt.eps)
            mag = want_p.abs()
            spacing = torch.nextafter(mag, torch.full_like(
                mag, float("inf"))) - mag
            off = ((p.detach() - want_p).abs() - spacing).clamp_min(0)
            if keep.any():
                worst = max(worst, float(off[keep].max()
                                         / want.abs().max().clamp_min(1e-30)))
            kept += int(keep.sum())
            total += keep.numel()
        info["update_rel"], info["update_share"] = worst, kept / total
        info["replicated_sum"] = sum(
            float(p.detach().double().sum()) for n, p in params.items()
            if n not in layout)
        info["heads"] = (state.params.stack.layers[0].mixer.wq.shape[1]
                         // cfg.head_dim,
                         state.params.stack.layers[0].mixer.wk.shape[1]
                         // cfg.head_dim)
        info["partial"] = len(getattr(state.params, TL.MODEL_PARTIAL))
        info["vocab_block"] = tuple(state.params.embed.shape)
        out[arch] = info
        del state, grads, p0, ref, params
        torch.cuda.empty_cache()
    return out


def parallel_rank(rank: int, world: int, tp_ref_dir: str,
                  tp_norms: dict) -> dict:
    """17a, 17c and 17d on one of the two ranks (spawned; ``cuda:0``)."""
    from repro_torch.launch import mesh as LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    mesh = LM.make_mesh((world, 1), ("data", "model"), "cuda")
    train = par_train_rank(rank, world, dev, mesh)
    train["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_mesh = LM.make_mesh((1, world), ("data", "model"), "cuda")
    decode = par_decode_rank(rank, world, dev, model_mesh)
    decode_seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    tensor = par_tp_rank(rank, world, dev, model_mesh, tp_ref_dir,
                         tp_norms)
    return {"train": train, "decode": decode,
            "decode_seconds": decode_seconds, "tensor": tensor,
            "tensor_seconds": time.perf_counter() - t0,
            "backend": torch.distributed.get_backend(), "device": str(dev),
            "peak_gib": peak}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_launcher() -> list:
    """17b: the training launcher as two processes, one a rank, meeting at
    a free local port; each prints its summary as the last line."""
    ckpt_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_ckpt_17b")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    port = free_port()
    src = os.environ.get("CHIP_SMOKE_SRC") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    p = PAR_LAUNCHER
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--num-processes", str(PAR_WORLD), "--process-id", str(i),
         "--coordinator", f"127.0.0.1:{port}", "--compress-grads",
         "--layers", str(p["layers"]),
         "--steps", str(p["steps"]), "--microbatches", str(p["microbatches"]),
         "--ckpt-dir", ckpt_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(PAR_WORLD)]
    outs = []
    try:
        outs = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    summaries = []
    for i, (proc, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, f"17b: launcher rank {i} exited "
                                    f"{proc.returncode}:\n{stderr[-3000:]}")
        summaries.append(json.loads(stdout.strip().splitlines()[-1]))
    return summaries


def phase_parallel(card: str) -> dict:
    """17: data-parallel training (17a parity, 17b the launcher), the
    paged decode's mesh branch (17c) and tensor-parallel training (17d),
    two ranks sharing the card."""
    from repro_torch.launch import mesh as LM

    t0 = time.perf_counter()
    refs = par_decode_reference()
    tp_ref_dir = os.path.join(_build.BUILD_DIR.parent, "chip_smoke_tp_ref")
    shutil.rmtree(tp_ref_dir, ignore_errors=True)
    try:
        t_tp = time.perf_counter()
        tp_refs = par_tp_reference(tp_ref_dir)
        t_tp = time.perf_counter() - t_tp
        t_ref = time.perf_counter() - t0
        ranks = LM.spawn(parallel_rank, PAR_WORLD, tp_ref_dir,
                         {a: r["grad_norm"] for a, r in tp_refs.items()},
                         device="cuda", backend="gloo", timeout=900)
    finally:
        shutil.rmtree(tp_ref_dir, ignore_errors=True)
    t_spawn = time.perf_counter() - t0 - t_ref
    print(f"parallel: {PAR_WORLD} ranks on {ranks[0]['device']} ({card}) "
          f"over {ranks[0]['backend']} (NCCL refuses two ranks on one "
          "device; gloo takes CUDA tensors for all-reduce, broadcast and "
          "all-gather, send / receive are staged through the host); peak "
          f"memory a rank {[round(r['peak_gib'], 2) for r in ranks]} GiB")

    # 17a
    tr = [r["train"] for r in ranks]
    a = tr[0]
    for i, t in enumerate(tr):
        check(t["simt_launches"][1] == 2 and t["simt_launches"][0] >= 2
              and t["sm90_launches"] == (0, 0),
              f"17a: rank {i} flash launches simt {t['simt_launches']} sm90 "
              f"{t['sm90_launches']}: the float32 step left the simt route")
    check(abs(tr[0]["checksum"] - tr[1]["checksum"]) == 0.0,
          "17a: the ranks' parameters differ after the step")
    dl = abs(a["loss"] - a["ref_loss"])
    check(dl <= TRAIN_LOSS_TOL, f"17a: loss {a['loss']} vs one rank "
                                f"{a['ref_loss']}")
    check(a["grad_rel"] <= TRAIN_GRAD_TOL,
          f"17a: averaged gradients {a['grad_rel']:.3e} of scale")
    check(a["update_rel"] <= TRAIN_GRAD_TOL,
          f"17a: AdamW update {a['update_rel']:.3e} of scale")
    check(a["compress_codes_equal"], "17a: int8 codes differ")
    check(a["compress_update_max_abs"] == 0.0,
          f"17a: compressed update off the formula by "
          f"{a['compress_update_max_abs']:.3e}")
    print(f"17a data-parallel parity (internlm2-1.8b full width, "
          f"{PAR_DECODE_LAYERS} layers, float32, TF32 off, "
          f"{PAR_TRAIN_TOKENS} tokens a rank): loss {a['loss']:.6f} vs one "
          f"rank on both sequences in 2 microbatches {a['ref_loss']:.6f} "
          f"(diff {dl:.3e}, tol {TRAIN_LOSS_TOL:g}); averaged gradients "
          f"max {a['grad_rel']:.3e} of scale, AdamW update {a['update_rel']:.3e}"
          f" (tol {TRAIN_GRAD_TOL:g}); ranks' parameters equal; simt flash "
          f"launches a rank {[t['simt_launches'] for t in tr]}; step "
          f"{[round(t['dp_s'], 3) for t in tr]} s, "
          f"{[t['dp_bytes'] for t in tr]} B to collectives a rank; with "
          f"compress: int8 codes equal, update equal to the formula on rank "
          f"0 (max |diff| {a['compress_update_max_abs']:g}); "
          f"{[round(t['seconds'], 1) for t in tr]} s")

    # 17c
    decode = {}
    for arch, mode in PAR_DECODE.items():
        want = refs[arch]
        per = [r["decode"][arch] for r in ranks]
        for i, d in enumerate(per):
            check(d["mode"] == mode, f"17c {arch}: rank {i} layout "
                                     f"{d['mode']} != {mode}")
            check(d["streams"] == want["engine"] == want["greedy"],
                  f"17c {arch}: rank {i} streams {d['streams']} vs one rank "
                  f"{want['engine']} / greedy_reference {want['greedy']}")
            check(d["launches"] == PAR_DECODE_LAYERS * d["steps"],
                  f"17c {arch}: rank {i} paged launches {d['launches']} != "
                  f"{PAR_DECODE_LAYERS} x {d['steps']} steps")
        diff = max(float(np.abs(d["logits"] - want["logits"]).max())
                   for d in per)
        check(diff <= LOGIT_TOL, f"17c {arch}: logits differ by {diff}")
        decode[arch] = [d["launches"] for d in per]
        print(f"17c paged decode under a (1, {PAR_WORLD}) mesh, {arch} "
              f"(full width, {PAR_DECODE_LAYERS} layers, float32), {mode} "
              f"layout: pools a rank {per[0]['pool']}; "
              f"{len(want['engine'])} streams equal the one-rank engine's "
              f"and greedy_reference's; prefill logits vs one rank max "
              f"{diff:.3e} (tol {LOGIT_TOL:g}); paged launches a rank "
              f"{decode[arch]} = {PAR_DECODE_LAYERS} x {per[0]['steps']} "
              f"steps; {[round(d['seconds'], 3) for d in per]} s to serve")
    # 17d
    tensor = {}
    for arch in PAR_TP:
        want = tp_refs[arch]
        per = [r["tensor"][arch] for r in ranks]
        for i, t in enumerate(per):
            check(t["simt"] == PAR_TP_LAUNCHES and not any(
                sum(v) for v in t["other_routes"].values()),
                f"17d {arch}: rank {i} flash launches simt {t['simt']} "
                f"(others {t['other_routes']}) != {PAR_TP_LAUNCHES}")
            dl = abs(t["loss"] - want["loss"])
            check(dl <= TRAIN_LOSS_TOL, f"17d {arch}: rank {i} loss "
                                        f"{t['loss']} vs one rank "
                                        f"{want['loss']}")
            for key, what in (("grad_rel", "gradients"),
                              ("mu_rel", "AdamW first moments"),
                              ("nu_rel", "AdamW second moments"),
                              ("update_rel", "AdamW update")):
                check(t[key] <= TRAIN_GRAD_TOL,
                      f"17d {arch}: rank {i} {what} {t[key]:.3e} of scale "
                      "from one rank's")
            dn = abs(t["grad_norm"] / want["grad_norm"] - 1)
            check(dn <= TRAIN_GRAD_TOL, f"17d {arch}: rank {i} gradient "
                                        f"norm {t['grad_norm']} vs one rank "
                                        f"{want['grad_norm']}")
        check(per[0]["replicated_sum"] == per[1]["replicated_sum"],
              f"17d {arch}: the ranks' replicated parameters differ")
        check(want["simt"] == PAR_TP_LAUNCHES,
              f"17d {arch}: one rank's simt launches {want['simt']}")
        cfg = par_cfg(arch)
        act = PAR_TRAIN_TOKENS * cfg.d_model * 4
        tensor[arch] = [t["simt"] for t in per]
        print(f"17d tensor parallelism on a (1, {PAR_WORLD}) mesh, {arch} "
              f"(full width, {PAR_DECODE_LAYERS} layers, float32, TF32 off, "
              f"one {PAR_TRAIN_TOKENS}-token sequence on both ranks): "
              f"heads a rank {per[0]['heads'][0]} / {per[0]['heads'][1]} of "
              f"{cfg.head_dim} ({per[0]['partial']} kv weights whole, their "
              f"gradients summed over model), vocab block "
              f"{per[0]['vocab_block']}; loss "
              f"{[round(t['loss'], 6) for t in per]} vs one rank "
              f"{want['loss']:.6f} (tol {TRAIN_LOSS_TOL:g}); gradient norm "
              f"{[t['grad_norm'] for t in per]} vs {want['grad_norm']}; "
              f"gradients {[format(t['grad_rel'], '.3e') for t in per]}, "
              f"AdamW moments "
              f"{[format(max(t['mu_rel'], t['nu_rel']), '.3e') for t in per]}"
              " "
              f"of scale, the update "
              f"{[format(t['update_rel'], '.3e') for t in per]} of scale "
              f"where |c g| >= {PAR_TP_UPDATE_MIN_EPS:g} eps "
              f"({per[0]['update_share']:.4f} of the elements), one float32 "
              f"spacing of the weight allowed (tol {TRAIN_GRAD_TOL:g}); "
              "replicated parameters "
              f"equal on both ranks; simt flash launches a rank "
              f"{tensor[arch]} (one rank {want['simt']}); s/step a rank "
              f"{[round(t['s'], 3) for t in per]} (one rank "
              f"{want['s']:.3f}); bytes to collectives a step a rank "
              f"{[t['bytes'] for t in per]} in {per[0]['calls']} calls "
              f"({per[0]['bytes'] / act:.3f} x a (1, {PAR_TRAIN_TOKENS}, "
              f"{cfg.d_model}) float32 activation); peak memory a rank "
              f"{[round(t['peak_gib'], 2) for t in per]} GiB ({card}; gloo "
              "on one card: no tensor-parallel speed)")
    t_par = time.perf_counter() - t0

    # 17b
    t1 = time.perf_counter()
    runs = par_launcher()
    t_launch = time.perf_counter() - t1
    p = PAR_LAUNCHER
    cfg = C.get_arch("internlm2-1.8b")
    want = (2 * p["layers"] * p["microbatches"] * p["steps"],
            p["layers"] * p["microbatches"] * p["steps"])
    for s in runs:
        check(s["world"] == PAR_WORLD and s["backend"] == "gloo",
              f"17b: rank {s['rank']} ran on {s['world']} ranks, "
              f"{s['backend']}")
        check(tuple(s["sm90_launches"]) == want
              and tuple(s["flash_launches"]) == want,
              f"17b: rank {s['rank']} flash launches {s['flash_launches']} "
              f"(sm90 {s['sm90_launches']}) != {want}")
        check(all(np.isfinite(s["losses"])) and all(np.isfinite(
            s["grad_norms"])), f"17b: rank {s['rank']} non-finite metrics")
    check(runs[0]["losses"] == runs[1]["losses"],
          "17b: the ranks report different losses")
    peak = sum(s["peak_gib"] for s in runs)
    check(peak < PAR_LAUNCHER_PEAK_GIB, f"17b: peak memory {peak:.2f} GiB")
    print(f"17b launcher, {PAR_WORLD} processes (--num-processes "
          f"{PAR_WORLD} --compress-grads; gloo: the ranks share a card), "
          f"{cfg.name} full "
          f"width, {p['layers']} of {cfg.num_layers} layers, bf16, fsdp on: "
          f"{p['steps']} steps of {TRAIN.GLOBAL_BATCH // PAR_WORLD} x 4096 "
          f"tokens a rank in {p['microbatches']} microbatches; losses "
          f"{[round(x, 4) for x in runs[0]['losses']]}; s/step a rank "
          f"{[[round(x, 3) for x in s['seconds']] for s in runs]} (first "
          f"includes warm-up); {runs[0]['tokens_per_s']:.1f} tokens/s of the "
          f"mesh after the first; peak memory a rank "
          f"{[round(s['peak_gib'], 2) for s in runs]} GiB (sum {peak:.2f}); "
          f"bytes to collectives a step a rank "
          f"{[s['comm_bytes_per_step'] for s in runs]}; sm90 flash launches "
          f"a rank {[s['sm90_launches'] for s in runs]}; {t_launch:.1f} s "
          f"with start-up ({card}; gloo stages every collective through the "
          "host, so these are this one-card arrangement's times, not a "
          "data-parallel speed)")
    print(f"phase 17 parts: one-rank references {t_ref:.1f} s (17d's "
          f"{t_tp:.1f} s), ranks (17a, 17c, 17d) {t_spawn:.1f} s (17d "
          f"{[round(r['tensor_seconds'], 1) for r in ranks]} s), launcher "
          f"(17b) {t_launch:.1f} s")
    return {"paged": decode, "simt": [t["simt_launches"] for t in tr],
            "tensor": tensor, "sm90": [s["sm90_launches"] for s in runs],
            "seconds": t_par + t_launch}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--sim-times"]:
        sim_times()
        return 0
    if sys.argv[1:] == ["--wkv-times"]:
        wkv_times()
        return 0
    if sys.argv[1:2] == ["--simt-wide-times"] and sys.argv[2:] in (
            [], ["--forward"]):
        simt_wide_times(forward_only=sys.argv[2:] == ["--forward"])
        return 0
    paths = train_paths()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        counting = pool.apply_async(host_counts, (paths,))
        return phases(card, paths, counting)


def phases(card: str, paths: dict, counting) -> int:
    """Phases 2-17, while ``counting`` (16b's counts) runs beside them."""
    t0 = time.perf_counter()
    _build.build_all(["paged_attention", "flash_attention",
                      "flash_attention_sm90", "flash_attention_d256",
                      "lru_scan", "sim_epilogue", "selective_scan", "wkv"])
    PA._lib(), FA._lib(), LS._lib(), SE._lib(), SS._lib(), WK._lib()
    FA._lib_bf16("sm90"), FA._lib_bf16("d256")    # d192 is d256's library
    print(f"kernel build (parallel): {time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_log.items():
        print(f"  {name}: {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")

    t0 = time.perf_counter()
    results, timed = phase_kernel()
    print(f"phase 3 (paged attention): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, serve_tokens = phase_serve()
    print(f"phase 4 (serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity()
    print(f"phase 5 (engine parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flash_timed = phase_flash()
    print(f"phase 6 (flash kernels): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, train7 = phase_train()
    print(f"phase 7 (train): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity_launches = phase_train_parity()
    print(f"phase 8 (train parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_parity = dict(zip(("simt_d256", "simt_d192"),
                           phase_wide_parity()))
    print(f"phase 8b (float32 parity above head_dim 128): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_train = phase_wide_train()
    print(f"phase 8c (float32 training above head_dim 128): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim = phase_sim()
    print(f"phase 9 (simulator): {time.perf_counter() - t0:.1f} s")
    t10 = t0 = time.perf_counter()
    cost = phase_cost_table()
    print(f"phase 10a (cost table): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    costed = phase_costed_serve(cost, serve_tokens)
    print(f"phase 10b (costed serving): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_fleet(cost)
    print(f"phase 10c (fleet): {time.perf_counter() - t0:.1f} s")
    print(f"phase 10 (costed serving and the fleet): "
          f"{time.perf_counter() - t10:.1f} s")
    t11 = t0 = time.perf_counter()
    gemma_serve = phase_gemma_serve()
    print(f"phase 11a (gemma3-1b serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gemma_parity()
    print(f"phase 11b (gemma3 parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma_train, train11c = phase_gemma_train()
    print(f"phase 11c (gemma3-1b train): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    variants = phase_variants()
    print(f"phase 11d (phi3, granite, internvl2): "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 11 (dense attention variants): "
          f"{time.perf_counter() - t11:.1f} s")
    t12 = t0 = time.perf_counter()
    moe_serve = phase_moe_serve()
    print(f"phase 12a ({GRANITE_MOE} serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_moe_parity()
    print(f"phase 12b (MoE and MLA parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_train, train12c = phase_moe_train()
    print(f"phase 12c ({GRANITE_MOE} train): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    deepseek = phase_deepseek()
    print(f"phase 12d ({DEEPSEEK}, 2 layers): "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 12 (mixture of experts and MLA): "
          f"{time.perf_counter() - t12:.1f} s")
    t13 = t0 = time.perf_counter()
    scan_timed = phase_scan_kernel()
    print(f"phase 13a (selective-scan kernels): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_jamba_parity()
    print(f"phase 13b (jamba parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jamba_serve = phase_jamba_serve()
    print(f"phase 13c ({JAMBA} serve cut): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jamba_train = phase_jamba_train()
    print(f"phase 13d ({JAMBA} train cut): {time.perf_counter() - t0:.1f} s")
    print(f"phase 13 (Mamba and the jamba hybrid): "
          f"{time.perf_counter() - t13:.1f} s")
    t14 = t0 = time.perf_counter()
    wkv_timed = phase_wkv_kernel()
    print(f"phase 14a (WKV kernels): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_rwkv_parity()
    print(f"phase 14b (rwkv parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rwkv_serve = phase_rwkv_serve()
    print(f"phase 14c ({RWKV} serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rwkv_train = phase_rwkv_train()
    print(f"phase 14d ({RWKV} train): {time.perf_counter() - t0:.1f} s")
    print(f"phase 14 (RWKV6): {time.perf_counter() - t14:.1f} s")
    t15 = t0 = time.perf_counter()
    phase_whisper_parity()
    print(f"phase 15a (whisper parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_serve = phase_whisper_serve()
    print(f"phase 15b ({WHISPER} serve): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_audio = phase_whisper_audio()
    print(f"phase 15c ({WHISPER} audio path): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_train = phase_whisper_train()
    print(f"phase 15d ({WHISPER} train): {time.perf_counter() - t0:.1f} s")
    print(f"phase 15 (whisper-tiny): {time.perf_counter() - t15:.1f} s")
    t0 = time.perf_counter()
    phase_roofline({"7": train7, "11c": train11c, "12c": train12c,
                    "12d": deepseek["train"], "13d": jamba_train["train"],
                    "14d": rwkv_train["train"], "15d": whisper_train["train"]},
                   card, paths, counting.get(timeout=600))
    print(f"phase 16 (roofline): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel = phase_parallel(card)
    print(f"phase 17 (parallel): {time.perf_counter() - t0:.1f} s")

    serve_t = timed["serve_bf16"]
    path_launches = {"sm90": train_launches, "simt": parity_launches,
                     "d256": gemma_train, "d192": deepseek["launches"]}
    flash_rows = [{
        "name": f"flash_attention_{route}_{direction}",
        "route": "cuda",
        "source": FLASH_SOURCES[route],
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": n,
        **{k: flash_timed[route][direction][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        # d256: gemma3's local layers (window 512) beside its global ones
        **{k: v for k, v in flash_timed[route][direction].items()
           if k.startswith("window")},
        # sm90: granite-moe's (12c), jamba's (13d) and whisper-tiny's
        # (15d) training beside internlm2's, and the kernels at
        # whisper's training call (phase 6)
        **({"granite_moe_train_launches": moe_train[direction == "bwd"],
            "jamba_train_launches": jamba_train["sm90"][direction == "bwd"],
            "whisper_train_launches":
                whisper_train["sm90"][direction == "bwd"],
            # phase 17b: the launcher's two ranks, each rank's launches
            "parallel_launcher_rank_launches": [
                s[direction == "bwd"] for s in parallel["sm90"]],
            **{f"whisper_{k}": flash_timed["whisper"][direction][k]
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}}
           if route == "sm90" else {}),
        # phase 17a: the data-parallel step's launches on each rank; 17d:
        # internlm2-1.8b's tensor-parallel step at 8 / 4 heads a rank
        **({"parallel_rank_launches": [
            t[direction == "bwd"] for t in parallel["simt"]],
            "tensor_parallel_rank_launches": [
            t[direction == "bwd"] for t in parallel["tensor"][
                "internlm2-1.8b"]]}
           if route == "simt" else {}),
    } for route in ROUTE_CASES
        for direction, n in zip(("fwd", "bwd"), path_launches[route])] + [{
        # the simt instantiations above head_dim 128 (NT 32, NT 24): 8c's
        # launches, 8b's beside them, timed at 8c's calls (phase 6)
        "name": f"flash_attention_{key}_{direction}",
        "route": "cuda",
        "source": FLASH_SOURCES["simt"],
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": wide_train[path][direction == "bwd"],
        "parity_launches": wide_parity[path][direction == "bwd"],
        **{k: flash_timed[key][direction][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "tflops")},
        **{k: v for k, v in flash_timed[key][direction].items()
           if k.startswith("window")},
        # 17d: gemma3-1b's tensor-parallel step at 2 / 1 heads a rank
        **({"tensor_parallel_rank_launches": [
            t[direction == "bwd"] for t in parallel["tensor"][GEMMA]]}
           if path == "simt_d256" else {}),
    } for key, (_, _, path) in SIMT_WIDE_CASES.items()
        for direction in ("fwd", "bwd")]
    print(json.dumps({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:37",
        "launches": launches,
        "max_abs_err": results["serve_bf16"]["max_abs_err"],
        "ms": serve_t["ms"],
        "plain_ms": serve_t["plain_ms"],
        "bound_ms": serve_t["bound_ms"],
        "bound_by": serve_t["bound_by"],
        "library_ms": serve_t["library_ms"],
        # phase 10b: phase 4's requests served translation-costed
        "costed_serve_launches": costed["launches"],
        "costed_mix_launches": costed["mix_launches"],
        # phase 11: gemma3-1b served (flat, radix), the 11d decodes, and
        # the kernel at gemma3's and granite-34b's decode shapes
        "gemma3_serve_launches": gemma_serve[BT.FLAT],
        "gemma3_radix_serve_launches": gemma_serve[BT.RADIX],
        **{f"{n.split('-')[0]}_decode_launches": v
           for n, v in variants.items()},
        # phase 12a: granite-moe-1b-a400m served (flat, radix)
        "granite_moe_serve_launches": moe_serve[BT.FLAT],
        "granite_moe_radix_serve_launches": moe_serve[BT.RADIX],
        # phase 13c: jamba-1.5-large's serve cut (flat, radix)
        "jamba_serve_launches": jamba_serve[BT.FLAT],
        "jamba_radix_serve_launches": jamba_serve[BT.RADIX],
        # phase 14c: rwkv6-3b served (flat, radix): no attention layer
        "rwkv_serve_launches": rwkv_serve[BT.FLAT],
        "rwkv_radix_serve_launches": rwkv_serve[BT.RADIX],
        # phase 15b: whisper-tiny served (flat, radix), and 15c's audio
        # path (prefill with the frames, then greedy decode)
        "whisper_serve_launches": whisper_serve[BT.FLAT],
        "whisper_radix_serve_launches": whisper_serve[BT.RADIX],
        "whisper_audio_launches": whisper_audio["launches"][BT.FLAT],
        "whisper_radix_audio_launches": whisper_audio["launches"][BT.RADIX],
        # phase 17c: the decode's mesh branch, each rank of a (1, 2) mesh
        # at the shard's heads (internlm2 kv heads split, gemma3-1b query
        # heads split)
        **{f"{n.split('-')[0]}_mesh_rank_launches": v
           for n, v in parallel["paged"].items()},
        **{f"{tag}_{k}": timed[f"{tag}_bf16"][k]
           for tag in ("gemma3_p16", "granite34b", "jamba", "whisper")
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }] + flash_rows + [{
        "name": f"selective_scan_{direction}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/mamba.py:96",
        # phase 13d: jamba's train cut (forward twice a step with the
        # recompute of activation checkpointing)
        "launches": jamba_train["scan"][direction == "bwd"],
        **scan_timed[direction],
    } for direction in ("fwd", "bwd")] + [{
        "name": f"wkv_{direction}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/models/rwkv.py:105",
        # phase 14d: rwkv6-3b's training (forward twice a step with the
        # recompute of activation checkpointing)
        "launches": rwkv_train["wkv"][direction == "bwd"],
        **wkv_timed[direction],
    } for direction in ("fwd", "bwd")] + [{
        "name": "lru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/sim/simulator.py:429",
        "launches": sim["launches"],
        "mismatches": sim["mismatches"],
        "max_abs_err": sim["max_abs_err"],
        # the ndp_machine(8) bucket's chunk; the cpu_machine(8) one beside
        **sim["timed"][("ndp", 8)]["lru_scan"],
        **{f"cpu8_{k}": v for k, v in
           sim["timed"][("cpu", 8)]["lru_scan"].items() if k.endswith("ms")},
        # banked memory (phase 9e): its launches and the same chunks
        **banked_keys(sim["banked"], "lru_scan"),
        # the sweeps and the search (9f, 9g)
        **sweep_search_keys(sim, "lru_scan"),
        # the cost table's derivation (10a), smoke and full presets
        "cost_model_launches": cost["smoke"]["launches"],
        "cost_model_full_launches": cost["full"]["launches"],
    }, {
        "name": "sim_epilogue",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sim_epilogue.cu",
        "replaces": "src/repro/sim/simulator.py:558",
        "launches": sim["ep_launches"],
        "mismatches": sim["ep_mismatches"],
        # the largest |kernel - plain| of the cycle sums
        "max_abs_err": sim["ep_max_abs_err"],
        "max_rel_err": sim["ep_max_rel_err"],
        **sim["timed"][("ndp", 8)]["sim_epilogue"],
        **{f"cpu8_{k}": v for k, v in
           sim["timed"][("cpu", 8)]["sim_epilogue"].items()
           if k.endswith("ms")},
        # every 9b bucket's chunk, and each instantiation's registers and
        # local (spill) bytes a thread (9a)
        **{f"{m}{c}_{k}": t["sim_epilogue"][k]
           for (m, c), t in sim["timed"].items() for k in ("ms", "bound_ms")},
        **sim["ep_build"],
        **banked_keys(sim["banked"], "sim_epilogue"),
        **sweep_search_keys(sim, "sim_epilogue"),
        "cost_model_launches": cost["smoke"]["ep_launches"],
        "cost_model_full_launches": cost["full"]["ep_launches"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
