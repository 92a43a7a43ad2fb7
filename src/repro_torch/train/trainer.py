"""The training loop: data -> step -> metrics -> checkpoint, restartable.

Port of ``repro/train/trainer.py``: ``fit`` composes the step factory
(``train_step.py``), AdamW (``adamw.py``) and the atomic checkpoints
(``checkpoint.py``), on ``device`` ("cuda" unless the caller asks for the
CPU).  The supervision layer is kept as the reference has it (the
reference's module imports jax, so the port keeps its own copies):
``HeartbeatMonitor`` tracks per-worker beat times and flags stragglers
by an EWMA z-score on step time, and ``run_with_restarts`` is the
checkpoint-restart loop — step, commit every ``ckpt_every`` steps,
restore the last commit on failure (onto the devices the state is on).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.train import adamw
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.train_step import make_train_step


@dataclass
class TrainReport:
    losses: list
    step_times: list
    final_step: int


def fit(cfg: ModelConfig, shape: InputShape, batches: Iterable[dict],
        n_steps: int, *, seed: int = 0, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, log_every: int = 10, micro_steps: int = 1,
        device="cuda") -> TrainReport:
    """Train fresh f32 params drawn from ``seed`` (or resume from
    ``ckpt_dir``'s last commit) for ``n_steps`` on ``batches`` (dicts of
    numpy arrays or tensors).  A step's time is the host clock up to the
    loss read back, which waits for the step."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, shape, micro_steps=micro_steps)
    params = init_params(M.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(seed))
    opt = adamw.init(params)

    start = 0
    if ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        (params, opt), start = CKPT.restore(ckpt_dir, (params, opt))

    losses, times = [], []
    it = iter(batches)
    for step in range(start, n_steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 next(it).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"{times[-1]*1e3:.0f} ms", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            CKPT.save(ckpt_dir, step + 1, (params, opt))
    if ckpt_dir:
        CKPT.save(ckpt_dir, n_steps, (params, opt))
    return TrainReport(losses, times, n_steps)


# ------------------------------------------------------------ supervision

@dataclass
class WorkerStats:
    """Per-worker heartbeat bookkeeping (EWMA step time + variance)."""

    last_beat: float = 0.0
    ewma: float = 0.0       # step-time EWMA
    ewvar: float = 0.0      # EWMA of squared deviation
    n: int = 0


class HeartbeatMonitor:
    """Detects dead workers (beat timeout) and stragglers (z-score)."""

    def __init__(self, n_workers: int, *, timeout_s: float = 10.0,
                 alpha: float = 0.2, z_thresh: float = 3.0):
        self.workers = {i: WorkerStats() for i in range(n_workers)}
        self.timeout_s = timeout_s
        self.alpha = alpha
        self.z_thresh = z_thresh

    def beat(self, worker: int, step_time_s: float,
             now: Optional[float] = None) -> None:
        """Record one worker heartbeat carrying its last step time."""
        w = self.workers[worker]
        w.last_beat = time.monotonic() if now is None else now
        if w.n == 0:
            w.ewma = step_time_s
        else:
            d = step_time_s - w.ewma
            w.ewma += self.alpha * d
            w.ewvar = (1 - self.alpha) * (w.ewvar + self.alpha * d * d)
        w.n += 1

    def dead(self, now: Optional[float] = None) -> list:
        """Workers whose last beat is older than the timeout."""
        now = time.monotonic() if now is None else now
        return [i for i, w in self.workers.items()
                if w.n > 0 and now - w.last_beat > self.timeout_s]

    def stragglers(self) -> list:
        """Workers whose EWMA step time is a z_thresh outlier vs the fleet."""
        live = [w.ewma for w in self.workers.values() if w.n >= 3]
        if len(live) < 3:
            return []
        mean = sum(live) / len(live)
        var = sum((x - mean) ** 2 for x in live) / len(live)
        sd = math.sqrt(var) + 1e-9
        return [i for i, w in self.workers.items()
                if w.n >= 3 and (w.ewma - mean) / sd > self.z_thresh]


@dataclass
class RestartReport:
    """What a supervised run did: progress, failures, restores."""

    steps_done: int
    n_failures: int
    n_restores: int
    history: list = field(default_factory=list)


def run_with_restarts(step_fn: Callable[[Any, int], Any], state: Any,
                      n_steps: int, *, ckpt_dir: str, ckpt_every: int = 10,
                      max_failures: int = 10) -> tuple:
    """Supervised training loop: step, checkpoint, restore-on-failure.

    ``step_fn(state, step) -> state`` may raise (fault injection or real
    device loss).  On failure the last committed checkpoint is restored
    (onto the devices of ``state``'s leaves) and the loop resumes from
    its step.
    """
    report = RestartReport(0, 0, 0)
    step = 0
    CKPT.save(ckpt_dir, step, state)
    failures = 0
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            report.steps_done = step
            if step % ckpt_every == 0 or step == n_steps:
                CKPT.save(ckpt_dir, step, state)
                report.history.append(("ckpt", step))
        except Exception as e:  # noqa: BLE001 — supervision boundary
            failures += 1
            report.n_failures = failures
            if failures > max_failures:
                raise
            state, step = CKPT.restore(ckpt_dir, state)
            report.n_restores += 1
            report.history.append(("restore", step, repr(e)[:60]))
    return state, report
