"""Fault tolerance for the training loop (a copy of
``repro.train.fault_tolerance``, over the port's checkpoints).

  * periodic + emergency checkpointing (SIGTERM -> save before exit)
    through train.checkpoint's atomic commit protocol;
  * restart-exactness: the data pipeline is counter-based, so (params,
    opt, step) fully determine the continuation;
  * retry-with-backoff for transient step failures, with an escape to
    checkpoint-restore when a step keeps failing;
  * straggler accounting: per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are counted.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch.train import checkpoint as ckpt


@dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 3
    backoff_s: float = 0.05
    straggler_factor: float = 3.0


@dataclass
class FaultStats:
    retries: int = 0
    restores: int = 0
    emergency_saves: int = 0
    straggler_steps: int = 0
    step_ema_s: float = 0.0


class GuardedTrainer:
    """Wraps a train_step with checkpoint/restart + retry + straggler
    accounting.  ``state`` is a tree of tensors (see train.checkpoint)."""

    def __init__(self, cfg: FaultConfig, train_step: Callable,
                 state: Any, start_step: int = 0):
        self.cfg = cfg
        self.train_step = train_step
        self.state = state
        self.step = start_step
        self.stats = FaultStats()
        self._stop = False
        self._prev_sigterm = None

    # -- lifecycle -----------------------------------------------------------
    def install_signal_handler(self):
        def handler(signum, frame):
            self._stop = True
            self.stats.emergency_saves += 1
            ckpt.save(self.cfg.ckpt_dir, self.step, self.state,
                      extra={"emergency": True}, keep=self.cfg.keep)
        self._prev_sigterm = signal.signal(signal.SIGTERM, handler)

    def remove_signal_handler(self):
        """Hand SIGTERM back to the handler found at install."""
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def maybe_restore(self) -> bool:
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        self.state, _ = ckpt.restore(self.cfg.ckpt_dir, self.state)
        self.step = step
        self.stats.restores += 1
        return True

    # -- the guarded step ----------------------------------------------------
    def run_step(self, batch) -> Optional[Dict]:
        if self._stop:
            return None
        t0 = time.monotonic()
        last_err = None
        for attempt in range(self.cfg.max_retries):
            try:
                self.state, metrics = self.train_step(self.state, batch)
                break
            except Exception as e:  # transient failure path
                last_err = e
                self.stats.retries += 1
                time.sleep(self.cfg.backoff_s * (2 ** attempt))
        else:
            # persistent failure: restore last good checkpoint and re-raise
            self.maybe_restore()
            raise RuntimeError(
                f"step {self.step} failed {self.cfg.max_retries}x"
            ) from last_err

        dt = time.monotonic() - t0
        ema = self.stats.step_ema_s
        if ema > 0 and dt > self.cfg.straggler_factor * ema:
            self.stats.straggler_steps += 1
        self.stats.step_ema_s = 0.9 * ema + 0.1 * dt if ema else dt

        self.step += 1
        if self.step % self.cfg.ckpt_every == 0:
            ckpt.save(self.cfg.ckpt_dir, self.step, self.state,
                      extra={"data_step": self.step}, keep=self.cfg.keep)
        return metrics
