"""The training loop with hooks (port of df3d/train/loop.py).

One loop in place of the reference's trainers (pcdet's train_one_epoch,
det3d's torchie Trainer, mmcv's EpochBasedRunner): hooks by priority
before each epoch, after each step and after each epoch; every
`log_interval` steps a log line, a `train_log.jsonl` record and
TensorBoard scalars (`utils.tb_writer`) with the time spent waiting for
the batch (data ms) and in the step (step ms, the card synchronized
first); a checkpoint every `ckpt_interval_epochs` epochs with the newest
`max_ckpt_keep` kept; and a run resumed from the newest checkpoint.

The JAX package's `Runner.resume` restores the step but not the epoch, so
a resumed run starts again at epoch 0 and replays that epoch's data order;
here the checkpoint carries the epochs completed, and the run goes on from
the next one.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Callable, Iterable

import torch

from df3d_torch.train.checkpoint import (
    list_checkpoints, load_checkpoint, save_checkpoint,
)
from df3d_torch.utils.tb_writer import ScalarWriter


@dataclasses.dataclass(order=True)
class Hook:
    priority: int
    name: str = dataclasses.field(compare=False)
    before_epoch: Callable | None = dataclasses.field(default=None,
                                                      compare=False)
    after_iter: Callable | None = dataclasses.field(default=None,
                                                    compare=False)
    after_epoch: Callable | None = dataclasses.field(default=None,
                                                     compare=False)


def _sync(state) -> None:
    device = next(state.model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    """`run(data_iter_fn)` trains `state` with `train_step(state, batch) ->
    (state, logs)` for `max_epochs` epochs, `data_iter_fn()` giving one
    epoch's batches (its loader's epoch set from `runner.epoch`).

    After a run, `timings` holds (global step, data ms, step ms) of each
    logged step and `ckpt_seconds` each checkpoint's save time.

    Of the ranks of a data-parallel run, only the one with `main_process`
    writes: logs, TensorBoard events, checkpoints and profiler traces.
    Every rank resumes from the newest checkpoint and fires its hooks."""

    def __init__(self, train_step: Callable, state, work_dir: str,
                 max_epochs: int, log_interval: int = 50,
                 ckpt_interval_epochs: int = 1, max_ckpt_keep: int = 5,
                 logger: logging.Logger | None = None,
                 main_process: bool = True):
        self.train_step = train_step
        self.state = state
        self.work_dir = pathlib.Path(work_dir)
        self.main_process = main_process
        if main_process:
            self.work_dir.mkdir(parents=True, exist_ok=True)
        self.max_epochs = max_epochs
        self.log_interval = log_interval
        self.ckpt_interval = ckpt_interval_epochs
        self.max_ckpt_keep = max_ckpt_keep
        self.epoch = 0
        self.global_step = 0
        self.hooks: list[Hook] = []
        self.timings: list[tuple[int, float, float]] = []
        self.ckpt_seconds: list[float] = []
        self._own_logger = logger is None
        self.logger = logger or self._make_logger()
        self._profile_window = None
        self._profiler = None

    def _make_logger(self) -> logging.Logger:
        """A logger of this run alone: its work dir's log_train.txt and
        the console."""
        logger = logging.getLogger(f"df3d_torch.{self.work_dir.resolve()}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        if not self.main_process:
            logger.addHandler(logging.NullHandler())
            return logger
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        for h in (logging.FileHandler(self.work_dir / "log_train.txt"),
                  logging.StreamHandler()):
            h.setFormatter(fmt)
            logger.addHandler(h)
        return logger

    def register_hook(self, hook: Hook) -> None:
        self.hooks.append(hook)
        self.hooks.sort()

    def _fire(self, point: str) -> None:
        for h in self.hooks:
            fn = getattr(h, point)
            if fn is not None:
                fn(self)

    def resume(self) -> None:
        """Restore the newest checkpoint of `work_dir/ckpt`, if any: the
        state, the step and the epochs completed."""
        ckpts = list_checkpoints(self.work_dir / "ckpt")
        if not ckpts:
            return
        step, path = ckpts[-1]
        t0 = time.perf_counter()
        meta = load_checkpoint(path, self.state)
        _sync(self.state)
        self.restore_seconds = time.perf_counter() - t0
        self.global_step = step
        if meta["epoch"] is not None:
            self.epoch = meta["epoch"]
        self.logger.info(f"resumed from step {step}, epoch {self.epoch} "
                         f"({self.restore_seconds:.3f} s)")

    restore_seconds = None

    def profile_steps(self, start: int, num: int = 5) -> None:
        """Trace steps [start, start + num) with `torch.profiler` into
        work_dir/profile (a Chrome trace)."""
        self._profile_window = (start, start + num)

    def _maybe_profile(self) -> None:
        if self._profile_window is None:
            return
        lo, hi = self._profile_window
        if self.global_step == lo and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
        elif self.global_step == hi and self._profiler is not None:
            self._stop_profile(lo, hi)

    def _stop_profile(self, lo: int, hi: int) -> None:
        _sync(self.state)
        self._profiler.__exit__(None, None, None)
        out = self.work_dir / "profile"
        out.mkdir(exist_ok=True)
        self._profiler.export_chrome_trace(str(out / f"steps_{lo}_{hi}.json"))
        self._profiler = None
        self._profile_window = None
        self.logger.info(f"profiler trace written to {out}")

    def _log(self, logs: dict, t_data: float, t_step: float) -> None:
        logs = {k: float(v) for k, v in logs.items()}
        msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items())
        self.logger.info(
            f"epoch {self.epoch} step {self.global_step} {msg} "
            f"(data {t_data * 1e3:.0f}ms step {t_step * 1e3:.0f}ms)")
        self._jsonl.write(json.dumps(
            {"epoch": self.epoch, "step": self.global_step, **logs,
             "data_ms": t_data * 1e3, "step_ms": t_step * 1e3}) + "\n")
        self._jsonl.flush()
        for k, v in logs.items():
            self._tb.add_scalar(f"train/{k}", v, self.global_step)
        self._tb.flush()
        self.timings.append((self.global_step, t_data * 1e3, t_step * 1e3))

    def run(self, data_iter_fn: Callable[[], Iterable[dict]]):
        self.resume()
        main = self.main_process
        if main:
            self._jsonl = open(self.work_dir / "train_log.jsonl", "a")
            self._tb = ScalarWriter(self.work_dir / "tensorboard")
        try:
            for self.epoch in range(self.epoch, self.max_epochs):
                self._fire("before_epoch")
                it = iter(data_iter_fn())
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    t1 = time.perf_counter()
                    if main:
                        self._maybe_profile()
                    self.state, logs = self.train_step(self.state, batch)
                    if main and self.global_step % self.log_interval == 0:
                        _sync(self.state)
                        t2 = time.perf_counter()
                        self._log(logs, t1 - t0, t2 - t1)
                    self.global_step += 1
                    self._fire("after_iter")
                if main and (self.epoch + 1) % self.ckpt_interval == 0:
                    t0 = time.perf_counter()
                    save_checkpoint(self.work_dir / "ckpt", self.state,
                                    self.global_step, self.max_ckpt_keep,
                                    epoch=self.epoch + 1)
                    self.ckpt_seconds.append(time.perf_counter() - t0)
                self._fire("after_epoch")
            if self._profiler is not None:
                self._stop_profile(*self._profile_window)
        finally:
            if main:
                self._jsonl.close()
                self._tb.close()
            if self._own_logger:
                for h in list(self.logger.handlers):
                    h.close()
                    self.logger.removeHandler(h)
        return self.state
