"""Fault-tolerant training driver.

The port of the reference's ``src/repro/train/trainer.py``:

  * **checkpoint/restart**: an async checkpointer at a step cadence; on
    any step exception the driver restores the latest complete checkpoint
    and replays (the data stream is counter-keyed, so replay is exact),
    up to ``max_restarts`` times;
  * **failure injection**: ``failure_hook(step)`` may raise to simulate a
    node loss; recovery takes the same path as a real failure;
  * **straggler detection**: each step's wall time (from the top of the
    step, hook and batch included) against the rolling median of the last
    32; steps beyond ``straggler_factor`` x the median are counted and
    handed to ``straggler_hook(step, factor)``.

The host waits on each step's loss (``float(metrics["loss"])``) where the
reference calls ``block_until_ready``, so a step's time is its device
time too.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step,
                                               restore_checkpoint)
from repro_torch.data.lm import SyntheticLM

__all__ = ["Trainer", "TrainerConfig"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    straggler_factor: float = 3.0
    max_restarts: int = 3


class Trainer:
    def __init__(self, train_step: Callable, init_state: dict,
                 data: SyntheticLM, tcfg: TrainerConfig,
                 failure_hook: Callable[[int], None] | None = None,
                 straggler_hook: Callable[[int, float], None] | None = None):
        self.train_step = train_step
        self.state = init_state
        self.data = data
        self.tcfg = tcfg
        self.failure_hook = failure_hook
        self.straggler_hook = straggler_hook
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        self.metrics_log: list[dict] = []
        self.restarts = 0
        self.straggler_steps = 0
        self.failures: list[str] = []       # each restart's cause

    def _current_step(self) -> int:
        return int(self.state["step"])

    def _maybe_restore(self) -> None:
        step = latest_step(self.tcfg.ckpt_dir)
        if step is not None:
            self.state, _ = restore_checkpoint(self.tcfg.ckpt_dir,
                                               self.state, step)

    def run(self) -> dict:
        times: list[float] = []
        while self._current_step() < self.tcfg.total_steps:
            step = self._current_step()
            try:
                # time from the top of the step: injected faults and input
                # stalls are exactly what straggler detection must see
                t0 = time.monotonic()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = self.data.batch_at(step)
                self.state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])        # waits for the step
                dt = time.monotonic() - t0
                times.append(dt)
                med = float(np.median(times[-32:]))
                if (len(times) > 4
                        and dt > self.tcfg.straggler_factor * med):
                    self.straggler_steps += 1
                    if self.straggler_hook is not None:
                        self.straggler_hook(step, dt / med)
                self.metrics_log.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "time_s": dt})
                nxt = self._current_step()
                if nxt % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(self.state, nxt)
            except Exception as exc:
                self.failures.append(f"step {step}: {exc!r}")
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                self.ckpt.wait()
                self._maybe_restore()
        self.ckpt.wait()
        return {"final_step": self._current_step(),
                "restarts": self.restarts,
                "straggler_steps": self.straggler_steps,
                "final_loss": (self.metrics_log[-1]["loss"]
                               if self.metrics_log else float("nan"))}
