"""Fault-tolerant trainer loop: checkpoint/restart + straggler watchdog
(port of ``repro/train/trainer.py``).

* **checkpoint/restart** — CheckpointManager saves (params, opt, step) every
  N steps atomically; ``Trainer.run`` always restores the latest checkpoint
  first, so killing the process at any step and re-running resumes exactly
  (the data stream is counter-based — no iterator state to lose).
* **straggler mitigation** — per-step wall time feeds an EWMA; a step slower
  than ``straggler_factor``× the EWMA is logged and counted.  The clock is
  injectable; on the card each step's time includes its device work
  (``torch.cuda.synchronize`` before the clock is read).
* **elastic restore** — restore returns logical CPU tensors, placed on the
  model's device with their dtypes.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import AdamW, AdamWState
from repro_torch.train.step import make_train_step
from repro_torch.util.tree import map_tree


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    save_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_warmup: int = 5       # steps before the EWMA is trusted
    ewma_beta: float = 0.9
    remat: str = "block"


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor — flags slow steps (hosts, on a cluster)."""

    factor: float = 3.0
    beta: float = 0.9
    warmup: int = 5
    ewma: float = 0.0
    count: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ewma = dt if self.ewma == 0 else (
                self.beta * self.ewma + (1 - self.beta) * dt)
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.flagged += 1
        else:  # stragglers must not poison the baseline
            self.ewma = self.beta * self.ewma + (1 - self.beta) * dt
        return slow


class Trainer:
    def __init__(
        self,
        model,
        optimizer: AdamW,
        lr_schedule,
        stream,
        cfg: TrainerConfig,
        *,
        step_fn: Callable | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.model = model
        self.optimizer = optimizer
        self.stream = stream
        self.cfg = cfg
        self.clock = clock
        self.step_fn = step_fn or make_train_step(
            model, optimizer, lr_schedule, remat=cfg.remat
        )
        self.ckpt = CheckpointManager(
            cfg.ckpt_dir, save_every=cfg.save_every
        )
        self.watchdog = StragglerWatchdog(
            factor=cfg.straggler_factor, beta=cfg.ewma_beta,
            warmup=cfg.straggler_warmup,
        )
        self.history: list[dict[str, Any]] = []

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ------------------------------------------------------------------ api
    def init_state(self, gen: torch.Generator) -> tuple[Any, Any, int]:
        params = self.model.init(gen)
        opt = self.optimizer.init(params)
        return params, opt, 0

    def restore_or_init(self, gen: torch.Generator):
        step, tree = self.ckpt.restore_latest()
        if tree is None:
            return self.init_state(gen)
        dev = self.model.device
        to_dev = lambda t: t.to(dev)
        opt = tree["opt"]
        if isinstance(opt, dict):
            # the step counter stays on the host (see optim/adamw.py)
            opt = AdamWState(step=opt["step"], mu=map_tree(to_dev, opt["mu"]),
                             nu=map_tree(to_dev, opt["nu"]))
        return map_tree(to_dev, tree["params"]), opt, int(step)

    def run(self, gen: torch.Generator, *,
            log: Callable[[str], None] | None = None):
        """Restore or init (from ``gen``, a generator on the model's
        device), then train to ``total_steps`` → (params, opt)."""
        params, opt, start = self.restore_or_init(gen)
        log = log or (lambda s: None)
        if start:
            log(f"restored checkpoint at step {start}")

        for step in range(start, self.cfg.total_steps):
            batch = self.stream.batch_at(step)
            self._sync()
            t0 = self.clock()
            params, opt, metrics = self.step_fn(params, opt, batch)
            self._sync()
            dt = self.clock() - t0

            if self.watchdog.observe(dt):
                log(f"step {step}: STRAGGLER {dt * 1e3:.1f} ms "
                    f"(ewma {self.watchdog.ewma * 1e3:.1f} ms)")
            if step % self.cfg.log_every == 0:
                log(f"step {step}: loss={float(metrics['loss']):.4f} "
                    f"lr={float(metrics['lr']):.2e} dt={dt * 1e3:.1f}ms")
            self.history.append(
                {"step": step, "loss": float(metrics["loss"]), "dt": dt}
            )
            self.ckpt.maybe_save(
                step + 1,
                {"params": params, "opt": opt._asdict()},
            )
        return params, opt
