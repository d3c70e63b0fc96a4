"""The train CLI over several processes (`--nprocs`, `parallel/launch.py`,
the counterpart of the JAX CLI's device mesh, tools/train.py:244-256):
2 gloo CPU ranks against the one-process CLI at the same global batch.

Each step of the 2-rank run is held against the port's one-process step
taken from the same state on the same global batch (the first from the
seeded initial state, where the one-process CLI's own checkpoint equals
it bit for bit; the second from the 2-rank run's first checkpoint), with
tests/test_torch_parallel_steps.py's tolerances (PR 11): parameters 1e-4
* max|p| + 1e-6 plus Adam's first-step jump lr * |u(g + t) - u(g - t)|
(u(g) = g / (|g| + eps), t = 1e-4 * max|g| + 1e-6 * the step's largest
gradient entry: a bias ahead of a training norm has an exact gradient of
0, so its update's sign is rounding noise), batch statistics 1e-4 *
max|stat| + 1e-6, float logs rtol 1e-5, integer logs exact. No decision
is replayed: the 2-rank run is the CLI's own, in processes of its own,
and at this size its steps meet the tolerances as they are (a ReLU input
within rounding of 0 would move gradients upstream by a few percent and
could flip the sign of an update; chip_smoke.py phase 58 replays such
near ties at full width).

Also: one set of checkpoints, logs and events (rank 0's), a 2-rank run
resumed from the first checkpoint equal to the unbroken run bit for bit,
the loader's shards making up the one-process batches, Voxel R-CNN's RoI
noise cut as the batch is, and the launcher's placement of ranks."""

import json
import shutil

import numpy as np
import pytest
import torch

from df3d_torch.config import apply_preset_overrides, get_preset
from df3d_torch.data.nuscenes import NuScenesDataset
from df3d_torch.data.pipeline import PrefetchLoader, make_batch
from df3d_torch.models.build import build_detector
from df3d_torch.parallel import launch
from df3d_torch.tools import train as train_cli
from df3d_torch.train import checkpoint as ckpt
from df3d_torch.train.schedules import adam_onecycle, global_norm
from torch_port_helpers import (  # noqa: F401
    KITTI_SMALL_SETS, NUSC_SMALL_SETS, one_torch_thread, write_tiny_nuscenes,
)

MAX_POINTS = 1000
EPOCHS = 2  # of one step each: two samples, global batch 2


def _argv(root, info, work_dir, *extra):
    return ["--preset", "centerpoint_tiny_smoke", "--batch-size", "2",
            "--max-points", str(MAX_POINTS), "--device", "cpu",
            "--data-root", str(root), "--info-path", str(info),
            "--epochs", str(EPOCHS), "--steps-per-epoch", "1",
            "--log-interval", "1", "--work-dir", str(work_dir), *extra,
            "--set", *NUSC_SMALL_SETS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process CLI, the 2-rank CLI, and the 2-rank CLI resumed
    from a copy of the 2-rank run's first checkpoint."""
    root = tmp_path_factory.mktemp("cli_ranks")
    info = write_tiny_nuscenes(root, n=2)
    train_cli.main(_argv(root, info, root / "one"))
    assert train_cli.main(_argv(root, info, root / "two",
                                "--nprocs", "2")) is None
    (root / "resumed" / "ckpt").mkdir(parents=True)
    shutil.copy(root / "two" / "ckpt" / "step_00000001",
                root / "resumed" / "ckpt")
    train_cli.main(_argv(root, info, root / "resumed", "--nprocs", "2"))
    return root, info


def _preset():
    return apply_preset_overrides(get_preset("centerpoint_tiny_smoke"),
                                  NUSC_SMALL_SETS)


def _state(path=None):
    built = build_detector(_preset(), adam_onecycle(1e-3, EPOCHS),
                           device="cpu")
    if path is not None:
        ckpt.restore_checkpoint(path, built.state)
    return built.state, built.step


def _global_batch(root, info, epoch):
    """The one-process loader's batch of `epoch`."""
    loader = PrefetchLoader(NuScenesDataset(root, info), 2,
                            lambda s: make_batch(s, MAX_POINTS,
                                                 _preset().max_objs, 5))
    loader.epoch = epoch
    (batch,) = list(loader)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _snapshot(state):
    sd = state.model.state_dict()
    return {"params": {n: p.detach().clone() for n, p in
                       zip(state.param_names, state.params)},
            "stats": {k: v.clone() for k, v in sd.items()
                      if k.endswith(("running_mean", "running_var"))},
            "count": state.opt_state.count, "step": state.step}


def _reference_step(start, batch):
    """The one-process step from checkpoint `start` (None: the initial
    state) -> (the state after it, its gradients by name, its logs)."""
    state, step = _state(start)
    logs, grads = step.grads(state, batch)
    lr = float(state.tx.lr(state.opt_state.count))
    grads = dict(zip(state.param_names, grads))
    state = step.apply(state, list(grads.values()))
    return _snapshot(state), grads, logs, lr


def _misses(ref, grads, got, lr) -> list[str]:
    """The parameters and statistics of `got` off the reference step by
    more than PR 11's tolerances (the module docstring)."""
    out = []
    scale = max(g.abs().max().item() for g in grads.values())
    clip = min(1.0, 10.0 / float(global_norm(list(grads.values()))))

    def u(g):
        return g / (g.abs() + 1e-8)

    for name, g in grads.items():
        t = (1e-4 * g.abs().max().item() + 1e-6 * scale) * clip
        p = ref["params"][name]
        atol = (1e-4 * p.abs().max().item() + 1e-6
                + lr * (u(g * clip + t) - u(g * clip - t)).abs())
        if ((got["params"][name] - p).abs() > atol).any():
            out.append(f"parameter {name}")
    for k, r in ref["stats"].items():
        if ((got["stats"][k] - r).abs().max().item()
                > 1e-4 * r.abs().max().item() + 1e-6):
            out.append(f"statistic {k}")
    return out


def _logs(work_dir):
    lines = (work_dir / "train_log.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(line).items()
             if not k.endswith("_ms")} for line in lines]


@pytest.mark.parametrize("step", [1, 2])
def test_two_ranks_against_one_process(runs, step):
    """The 2-rank run's step `step` against the one-process step from the
    same state on the same global batch: parameters and statistics within
    PR 11's tolerances, logs within rtol 1e-5 (integers exact). The
    one-process CLI's first checkpoint equals the reference step bit for
    bit."""
    root, info = runs
    start = None if step == 1 else (root / "two" / "ckpt"
                                    / f"step_{step - 1:08d}")
    ref, grads, logs, lr = _reference_step(
        start, _global_batch(root, info, step - 1))
    got = _snapshot(_state(root / "two" / "ckpt" / f"step_{step:08d}")[0])
    assert (got["count"], got["step"]) == (ref["count"], ref["step"]) == (
        step, step)
    assert _misses(ref, grads, got, lr) == []
    jumped = sum(int(((got["params"][n] - p).abs()
                      > 1e-4 * p.abs().max().item() + 1e-6).sum())
                 for n, p in ref["params"].items())
    print(f"step {step}: {jumped} parameter elements past 1e-4 * max|p| "
          f"(the sign of Adam's update on gradients of rounding noise)")
    rec = _logs(root / "two")[step - 1]
    for k, v in logs.items():
        v = v.item()
        if k == "cap_overflow":
            assert rec[k] == v
        else:
            assert abs(rec[k] - v) <= 1e-5 * abs(v), k
    if step == 1:
        one = _snapshot(_state(root / "one" / "ckpt" / "step_00000001")[0])
        for kind in ("params", "stats"):
            for k, v in ref[kind].items():
                assert torch.equal(one[kind][k], v), k


def test_one_set_of_outputs_and_resume(runs):
    """Rank 0 alone wrote: two checkpoints, one log line a step, one
    TensorBoard file. A 2-rank run resumed from the first checkpoint ends
    equal to the unbroken one, bit for bit (parameters, buffers, moments,
    count, step), with the same second log line."""
    root, _ = runs
    two = root / "two"
    assert [s for s, _ in ckpt.list_checkpoints(two / "ckpt")] == [1, 2]
    assert len(_logs(two)) == EPOCHS
    assert len(list((two / "tensorboard").glob("events.*"))) == 1
    assert sorted(p.name for p in two.iterdir()) == [
        "ckpt", "log_train.txt", "tensorboard", "train_log.jsonl"]
    a, b = (torch.load(d / "ckpt" / "step_00000002", weights_only=True)
            for d in (two, root / "resumed"))
    assert a.keys() == b.keys()
    for k in ("model",):
        for name in a[k]:
            assert torch.equal(a[k][name], b[k][name]), name
    for k in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
    assert (a["count"], a["step"], a["epoch"]) == (b["count"], b["step"],
                                                   b["epoch"]) == (2, 2, 2)
    assert _logs(root / "resumed") == _logs(two)[1:]


def test_shards_make_up_the_global_batches(tmp_path):
    """Rank r's loader (shard r of N, batch B / N) holds at step k the
    one-process batch k's samples r, r + N, ...: their union is that
    batch, epoch by epoch; the CLI takes len(dataset) // B steps on every
    rank though the shards differ in length."""
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return i

    one = PrefetchLoader(Items(), 4, list)
    shards = [PrefetchLoader(Items(), 2, list, shard_id=r, num_shards=2)
              for r in range(2)]
    for epoch in range(2):
        for loader in [one] + shards:
            loader.epoch = epoch
        whole = list(one)
        parts = [list(s)[:len(whole)] for s in shards]
        assert len(whole) == 11 // 4
        for k, batch in enumerate(whole):
            assert sorted(parts[0][k] + parts[1][k]) == sorted(batch)
            assert parts[0][k] == batch[0::2] and parts[1][k] == batch[1::2]


def test_voxelrcnn_noise_cut_as_the_batch(monkeypatch):
    """Voxel R-CNN's rank step draws the global batch's RoI noise of the
    step and passes its rows rank, rank + N, ... (the rows its shard
    holds)."""
    seen = []

    class Recording:
        def __init__(self, step):
            self.step = step

        def grads(self, state, batch, noise=None):
            seen.append(noise)
            return self.step.grads(state, batch, noise=noise)

    monkeypatch.setattr(train_cli, "DataParallelTrainStep", Recording)
    args = train_cli.parse_args([
        "--preset", "voxel_rcnn_car_kitti", "--epochs", "1",
        "--steps-per-epoch", "1", "--device", "cpu", "--set",
        *KITTI_SMALL_SETS])
    preset = apply_preset_overrides(get_preset("voxel_rcnn_car_kitti"),
                                    KITTI_SMALL_SETS)
    state, step, cfg, _ = train_cli.build_model_and_step(
        args, preset, "cpu", rank=1, world=3)
    rng = np.random.RandomState(0)
    samples = [{"points": np.concatenate(
        [rng.uniform(0, 30, (300, 1)), rng.uniform(-14, 14, (300, 1)),
         rng.uniform(-2, 0.5, (300, 1)), rng.rand(300, 1)],
        1).astype(np.float32),
        "gt_boxes": np.array([[12.0, 1.0, -1.0, 4.0, 1.7, 1.5, 0.3]],
                             np.float32),
        "gt_classes": np.zeros(1, np.int32)} for _ in range(2)]
    step(state, {k: torch.from_numpy(v)
                 for k, v in make_batch(samples, 300, 4, 4).items()})
    want = train_cli.roi_noise(0, 6, cfg.train_post_nms)[1::3]
    assert torch.equal(seen[0], want)


def test_rank_placement_and_batch_check(tmp_path):
    """CPU ranks run gloo; with no card the default device raises; the
    global batch must divide over the ranks."""
    assert launch.rank_devices(3, "cpu") == (["cpu"] * 3, "gloo")
    with pytest.raises(ValueError, match="divide"):
        train_cli.main(["--preset", "centerpoint_tiny_smoke", "--synthetic",
                        "--device", "cpu", "--nprocs", "2", "--batch-size",
                        "3", "--work-dir", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.rank_devices(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--preset", "centerpoint_tiny_smoke", "--synthetic",
                        "--nprocs", "2", "--work-dir", str(tmp_path)])
