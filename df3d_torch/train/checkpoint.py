"""Checkpoints of a training state (port of df3d/train/checkpoint.py:22-71).

As the reference trains: a checkpoint each epoch under `ckpt_dir`, named
`step_NNNNNNNN` after the steps taken, the newest `max_keep` kept, and a
run resumed from the newest. A checkpoint is one `torch.save` file, written
under a temporary name and renamed into place, so a reader never sees half
of one. It holds the model's `state_dict` (parameters and every buffer:
running statistics and their counters), the optimizer's moments and count,
the step and the epochs completed. It is read back with torch's
`weights_only` unpickler into an existing state of the same model, on that
state's device.

The JAX package saves orbax directories; the port does not read them. The
reference's own checkpoints go in through `train.torch_import`.
"""

from __future__ import annotations

import os
import pathlib
import re
import tempfile

import torch

from df3d_torch.train.trainer import TrainState

_NAME = re.compile(r"step_(\d+)")


def save_checkpoint(ckpt_dir, state: TrainState, step: int,
                    max_keep: int = 5, epoch: int | None = None
                    ) -> pathlib.Path:
    """Write `state` as `ckpt_dir/step_NNNNNNNN` (`epoch`: the epochs
    completed, for a resumed run), then keep the newest `max_keep`."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    blob = {"model": state.model.state_dict(),
            "mu": list(state.opt_state.mu), "nu": list(state.opt_state.nu),
            "count": state.opt_state.count, "step": state.step,
            "epoch": epoch}
    fd, tmp = tempfile.mkstemp(prefix="tmp_step_", dir=ckpt_dir)
    os.close(fd)
    try:
        torch.save(blob, tmp)
        out = ckpt_dir / f"step_{step:08d}"
        os.replace(tmp, out)
    except BaseException:
        os.remove(tmp)
        raise
    prune_checkpoints(ckpt_dir, max_keep)
    return out


def list_checkpoints(ckpt_dir) -> list[tuple[int, pathlib.Path]]:
    """[(step, path)] of the checkpoints in `ckpt_dir`, oldest first."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        m = _NAME.fullmatch(p.name)
        if m:
            steps.append((int(m.group(1)), p))
    return sorted(steps)


def prune_checkpoints(ckpt_dir, max_keep: int) -> None:
    for _, p in list_checkpoints(ckpt_dir)[:-max_keep]:
        p.unlink(missing_ok=True)


def load_checkpoint(path, state: TrainState) -> dict:
    """Read the checkpoint at `path` into `state` (its model, moments,
    count and step, on the model's device) -> {"step", "epoch"}."""
    device = next(state.model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(blob["model"])
    with torch.no_grad():
        for dst, src in zip(state.opt_state.mu + state.opt_state.nu,
                            blob["mu"] + blob["nu"], strict=True):
            dst.copy_(src)
    state.opt_state.count = blob["count"]
    state.step = blob["step"]
    return {"step": blob["step"], "epoch": blob["epoch"]}


def restore_checkpoint(path, state: TrainState):
    """Restore one `step_NNNNNNNN` checkpoint into `state` -> (state,
    step); the step comes from the name, as the JAX package takes it."""
    path = pathlib.Path(path)
    load_checkpoint(path, state)
    m = _NAME.fullmatch(path.name)
    return state, int(m.group(1)) if m else -1


def restore_latest(ckpt_dir, state: TrainState):
    """The newest checkpoint restored into `state` -> (state, step), or
    (None, -1) when there is none."""
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        return None, -1
    step, path = ckpts[-1]
    load_checkpoint(path, state)
    return state, step
