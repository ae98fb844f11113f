"""ServeEngine: continuous-batching decode over the paged KV cache.

The port of ``repro.serving._engine``.  One unified step path: every live
slot advances one token per engine step.  Slots still consuming their
prompt are teacher-forced; slots past their prompt decode greedily, so
prompt feeding runs the same paged append path as decoding.

Requests are admitted with the pages of their prompt mapped; pages are
allocated by the scheduler as lengths grow (the OS role).  The kv table
mode is either pinned or occupancy-driven (the NDPage flatten decision).
On the card every attention layer of every step runs the hand-written
paged-attention kernel.  The greedy argmax is taken on the device, so a
step copies B token ids to the host, not the (B, vocab) logits.

A slot's recurrent state (a Mamba layer's ``conv`` and ``ssm``) is
zeroed when the slot admits a request.  The JAX engine does not reset
it: the state of the slot's previous request, advanced further while
the slot idled, carries into the next one, so a hybrid model's streams
there differ from ``greedy_reference`` once a slot is reused, and a
resumed request's re-prefill is not exact.  Here they equal it (the KV
caches need no reset: they are read only up to the sequence's length).

Translation-costed mode: pass ``cost_model`` (a
:class:`repro_torch.sim.cost_model.TranslationCostModel`) and every
scheduler step is priced under ALL simulated mechanisms at once — cache
hits at TLB-hit cost, misses at each mechanism's walk cost plus the
touched-PTE-line surcharge of the rebuilt row.  ONE decode loop serves
every mechanism; :meth:`ServeEngine.throughput` then reports the
SIMULATED machine's tokens/sec per mechanism (numpy host accounting,
equal to the JAX package's), not the card's wall clock.

Over a mesh (``mesh``, a ``DeviceMesh`` with ``data`` and ``model``
axes) an engine is one data shard's: its slots, its page allocator and
the requests it serves (:func:`shard_requests`) are this rank's, with
shard-local page ids, and the engines of the ``model`` ranks of one data
shard run in lockstep on the same requests, each holding its shard of
the pools; every attention layer of every step takes the paged decode's
mesh branch (``models/attention.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import block_table as BT
from repro_torch.core.kv_page_manager import KVPageManager
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models.model_zoo import Model, model_device
from repro_torch.models.transformer import reset_recurrent_state
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.context import axis_rank, axis_size, use_mesh
from repro_torch.serving._scheduler import BatchScheduler, Request
from repro_torch.util import resilience
from repro_torch.util.device import DeviceLike, resolve_device


def _on_device(params: Model, device: torch.device) -> None:
    have = model_device(params)
    if have.type != device.type or (device.index is not None
                                    and have != device):
        raise ValueError(f"model weights are on {have}, engine device is "
                         f"{device}")


class ServeEngine:
    def __init__(self, cfg, params: Model, *, max_batch: int = 8,
                 max_len: int = 256, page_size: int = 16,
                 table_mode: Optional[str] = None, cost_model=None,
                 device: DeviceLike = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        _on_device(params, self.device)
        self.cfg = cfg
        self.params = params
        max_pages_total = max_batch * (-(-max_len // page_size)) + 8
        self.kvm = KVPageManager(max_pages_total, page_size, max_batch,
                                 max_len, device=self.device)
        self.meter = None
        if cost_model is not None:
            from repro_torch.sim.cost_model import TranslationMeter
            self.meter = TranslationMeter(cost_model)
        self.sched = BatchScheduler(self.kvm, max_batch,
                                    table_mode=table_mode,
                                    meter=self.meter)
        self.max_batch = max_batch
        # the device KV pools must cover every physical page id the host
        # allocator can hand out
        with use_mesh(mesh):
            self.state = init_decode_state(
                cfg, max_batch, max_len, kv_mode=BT.FLAT,
                page_size=page_size, num_pages=max_pages_total,
                device=self.device)
        # per-slot prompt progress; _slot_prompt holds the stream being
        # teacher-forced (effective prompt snapshot taken at admission,
        # so a preempted request re-prefills prompt + prior tokens)
        self._prompt_pos = np.zeros(max_batch, np.int64)
        self._next_token = np.zeros(max_batch, np.int32)
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * max_batch
        # inactive slots write their (discarded) K/V into a scratch page so
        # they can never alias a live sequence's pages
        self._scratch_page = self.kvm.pool.allocate(1)[0]

    # -- public ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            self.sched.tick()
            for slot, req in self.sched.admit():
                reset_recurrent_state(self.state["stack"], slot)
                self._slot_prompt[slot] = req.effective_prompt()
                self._prompt_pos[slot] = 0
                self._next_token[slot] = int(self._slot_prompt[slot][0])
            if not self.sched.running and not self.sched.queue:
                break
            if not self.sched.running:
                continue
            finished.extend(self._engine_step())
        return finished

    def throughput(self) -> Dict:
        """Per-mechanism serving report (requires ``cost_model``): the
        simulated tokens/sec, accumulated translation cycles, the
        PER-STEP budget (mean/max over the meter's retained step
        window), and the hit/miss tallies — one decode run priced under
        every mechanism."""
        if self.meter is None:
            raise ValueError("ServeEngine was built without a cost_model;"
                             " pass cost_model= to enable throughput()")
        m = self.meter
        return {
            "tokens_per_sec": m.tokens_per_sec(),
            "translation_cycles": m.translation_cycles(),
            "per_step_cycles": m.per_step_cycles(),
            "tokens": m.tokens, "steps": m.steps,
            "tcache_hits": m.hits, "tcache_misses": m.misses,
        }

    # -- internals ------------------------------------------------------------
    def _engine_step(self) -> List[Request]:
        # injected mid-decode eviction (the evict_storm chaos plan)
        inj = resilience.fault_injector()
        if inj is not None and self.sched.running and inj.fires("evict"):
            self.sched.preempt(self.sched.pick_victim(), reason="fault")
            if not self.sched.running:
                return []
        mode, table, lens = self._build_tables()
        tokens = torch.tensor(self._next_token, device=self.device)
        state = dict(self.state)
        state["table"] = table
        state["lengths"] = lens
        with use_mesh(self.mesh):
            logits, self.state = decode_step(self.params, self.cfg, state,
                                             tokens, kv_mode=mode)
        # torch.argmax returns the first maximum, as np.argmax does
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()

        produced = {}
        for sid in self.sched.active_seqs():
            slot = self.sched.slot_of[sid]
            self._prompt_pos[slot] += 1
            pos = self._prompt_pos[slot]
            stream = self._slot_prompt[slot]
            if pos < len(stream):
                self._next_token[slot] = int(stream[pos])
            else:
                nxt = int(greedy[slot])
                self._next_token[slot] = nxt
                produced[sid] = nxt
        return self.sched.record_tokens(produced)

    def _build_tables(self):
        mode, rows, _ = self.sched.step_tables()
        flat = np.full((self.max_batch, self.kvm.max_pages),
                       self._scratch_page, np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        for row, sid in zip(rows, self.sched.active_seqs()):
            slot = self.sched.slot_of[sid]
            flat[slot] = row
            # the model writes the CURRENT token at cache index `lengths`
            lens[slot] = int(self._prompt_pos[slot])
        table = torch.tensor(flat, device=self.device)
        if mode == BT.RADIX:
            table = BT.radix_from_flat(table, leaf_size=self.kvm.leaf_size)
        return mode, table, torch.tensor(lens, device=self.device)


def shard_requests(requests: List[Request], mesh) -> List[Request]:
    """The requests of this rank's data shard: every ``dp``-th one from
    the shard's index (the batch axes' size ``dp``; all of them without
    batch axes)."""
    axes = SH.batch_axes(mesh)
    if not axes:
        return list(requests)
    return list(requests)[axis_rank(mesh, axes)::axis_size(mesh, axes)]


def greedy_reference(cfg, params: Model, prompt: np.ndarray,
                     new_tokens: int, kv_mode: str = "dense",
                     max_len: int = 256, page_size: int = 16,
                     device: DeviceLike = "cuda") -> List[int]:
    """Single-sequence greedy decode without the scheduler (oracle for
    engine tests)."""
    device = resolve_device(device)
    _on_device(params, device)
    tokens = torch.tensor(np.asarray(prompt, np.int32)[None], device=device)
    logits, state = prefill(params, cfg, tokens, kv_mode=kv_mode,
                            max_len=max_len, page_size=page_size)
    tok = int(torch.argmax(logits[0]))
    out = [tok]
    for _ in range(new_tokens - 1):
        step_tokens = torch.tensor([tok], dtype=torch.int32, device=device)
        logits, state = decode_step(params, cfg, state, step_tokens,
                                    kv_mode=kv_mode)
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
    return out
