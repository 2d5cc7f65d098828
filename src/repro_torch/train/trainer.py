"""Trainer: checkpointed, restartable training loop with a straggler
watchdog and deterministic data.

Port of ``repro.train.trainer``:
  * the data stream is a pure function of (seed, step), so a restart
    from a checkpoint replays the identical token stream;
  * checkpoints hold the params and the whole optimizer state in the
    reference's format (``{"params": ..., "opt": AdamWState}``), so
    either package's trainer resumes from the other's;
  * ``run()`` survives injected step failures: on an exception it
    reloads the latest checkpoint and goes on (bounded retries);
  * the watchdog tracks a step-time EMA and flags outliers.

Every step is timed on ``repro_torch.telemetry.monotonic``, its
metrics copied back to the host first, so ``dt`` holds the card's work.
"""
from __future__ import annotations

import torch

from repro_torch import telemetry as tm
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    restore_into,
)
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import make_train_step


class Watchdog:
    """Step-time EMA; flags steps slower than ``threshold`` x EMA."""

    def __init__(self, threshold: float = 2.0, decay: float = 0.9):
        self.ema = None
        self.threshold = threshold
        self.decay = decay
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        flagged = self.ema is not None and dt > self.threshold * self.ema
        if flagged:
            self.stragglers.append((step, dt))
        self.ema = dt if self.ema is None else \
            self.decay * self.ema + (1 - self.decay) * dt
        return flagged


class Trainer:
    """Trains ``cfg`` on ``dataset`` (anything with ``batch_at(step)`` ->
    (B, S+1) int tokens) on ``device`` (default the card; raises where
    there is none)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dataset,
                 ctx: ShardingCtx | None = None, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.dataset = cfg, tcfg, dataset
        self.ctx = ctx or ShardingCtx()
        self.watchdog = Watchdog()
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      async_save=tcfg.async_checkpoint)
        self._step = make_train_step(cfg, tcfg, self.ctx)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self) -> None:
        """Fresh params from ``torch.Generator(tcfg.seed)`` and a fresh
        optimizer state (the old state is dropped first, so the card
        never holds two)."""
        self.params = self.opt_state = None
        g = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = init_params(self.cfg, g, self.device)
        self.opt_state = adamw_init(
            self.params,
            use_error_feedback=self.tcfg.grad_compression == "int8_ef")
        self.step = 0

    def state(self) -> dict:
        """The checkpointed tree: ``{"params": ..., "opt": AdamWState}``."""
        return {"params": self.params, "opt": self.opt_state}

    def resume_or_init(self) -> bool:
        """Restore the latest checkpoint (True), else init (False).  The
        checkpoint is copied into the current state's tensors in place
        (an init first builds them where there are none)."""
        last = latest_step(self.tcfg.checkpoint_dir)
        if last is None:
            self.init_state()
            return False
        if self.params is None:
            self.init_state()
        restore_into(self.tcfg.checkpoint_dir, last, self.state())
        self.step = last
        return True

    def save(self) -> None:
        self.ckpt.save(self.step, self.state())

    # ------------------------------------------------------------------
    def _device_batch(self, step: int) -> dict:
        toks = self.dataset.batch_at(step)
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    def run(self, n_steps: int | None = None, fail_at=None,
            max_retries: int = 2) -> list[dict]:
        """Train for n_steps (default tcfg.total_steps).  ``fail_at`` is a
        test hook: a set of step numbers at which a simulated failure is
        raised before that step's update.  Returns the metrics log: each
        entry the step's metrics as floats, its ``step`` and ``dt``."""
        n_steps = n_steps or self.tcfg.total_steps
        retries = 0
        while self.step < n_steps:
            try:
                t0 = tm.monotonic()
                batch = self._device_batch(self.step)
                if fail_at and self.step in fail_at:
                    fail_at = set(fail_at) - {self.step}
                    raise RuntimeError(f"injected failure @ {self.step}")
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = tm.monotonic() - t0
                self.watchdog.observe(self.step, dt)
                self.step += 1
                if self.step % self.tcfg.log_every == 0 or \
                        self.step == n_steps:
                    self.metrics_log.append(dict(metrics, step=self.step,
                                                 dt=dt))
                if self.step % self.tcfg.checkpoint_every == 0:
                    self.save()
            except Exception:
                retries += 1
                if retries > max_retries:
                    raise
                # recovery: reload the latest checkpoint (or reinit)
                self.ckpt.wait()
                self.resume_or_init()
        self.ckpt.wait()
        return self.metrics_log
