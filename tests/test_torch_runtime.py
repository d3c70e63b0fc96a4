"""The port's runtime: the TensorBoard writer against the JAX package's
(bytes), checkpoints (`df3d_torch/train/checkpoint.py`), the `Runner`
(`train/loop.py`), the train and test CLIs (`df3d_torch/tools/`) and the
fusion hook's augmentation inputs.

The CLIs are held against the port's own training step and eval loop
bodies, which the other port tests hold against the JAX package: the
parameters after the train CLI's steps equal that step applied to the
loader's batches, a run stopped after its first epoch and resumed equals
an unbroken run bit for bit, and the test CLI's metrics equal
`train.evaluate`'s on the same detections. Everything runs on the CPU at
`centerpoint_tiny_smoke` and `voxel_rcnn_car_kitti` narrowed by `--set`,
on tiny datasets written by the tests; no JAX program is compiled (the
hook's projection runs in eager JAX)."""

import json

import numpy as np
import pytest
import torch

from df3d_torch import entry
from df3d_torch.config import apply_preset_overrides, get_preset
from df3d_torch.data.nuscenes import NuScenesDataset
from df3d_torch.data.pipeline import PrefetchLoader, make_batch
from df3d_torch.models.build import build_detector
from df3d_torch.tools import test as test_cli
from df3d_torch.tools import train as train_cli
from df3d_torch.train import checkpoint as ckpt
from df3d_torch.train.evaluate import (
    kitti_metrics, kitti_records, nuscenes_metrics, nuscenes_records,
)
from df3d_torch.train.loop import Hook
from df3d_torch.train.schedules import adam_onecycle
from torch_port_helpers import (  # noqa: F401
    KITTI_SMALL_SETS, one_torch_thread, write_tiny_kitti,
    write_tiny_nuscenes,
)

# `centerpoint_tiny_smoke` narrowed to the multichip dry run's grid and two
# tasks (a step in ~0.6 s on one CPU thread, ~1.3 s as the preset is)
NUSC_SMALL_SETS = [
    "pc_range=[-16.0, -16.0, -2.4, 16.0, 16.0, 2.4]",
    "voxel_size=[0.5, 0.5, 0.2]", "grid_size=[24, 64, 64]",
    "max_voxels=512", "stage_caps=[512, 256, 128, 64]", "tasks=[1, 2]",
    "max_objs=8", "nms_pre_max_size=32", "nms_post_max_size=4",
    "post_center_range=[-20.0, -20.0, -4.0, 20.0, 20.0, 4.0]"]
NUSC_ARGS = ["--preset", "centerpoint_tiny_smoke", "--batch-size", "2",
             "--max-points", "1000", "--device", "cpu", "--set",
             *NUSC_SMALL_SETS]
KITTI_ARGS = ["--preset", "voxel_rcnn_car_kitti", "--batch-size", "2",
              "--max-points", "600", "--device", "cpu", "--set",
              *KITTI_SMALL_SETS]
RUN_ARGS = ["--epochs", "2", "--steps-per-epoch", "2", "--log-interval", "1"]
EVAL_ARGS = {"nusc": ["--preset", "centerpoint_tiny_smoke", "--max-points",
                      "1000", "--device", "cpu", "--set", *NUSC_SMALL_SETS],
             "kitti": ["--preset", "voxel_rcnn_car_kitti", "--max-points",
                       "600", "--device", "cpu", "--set",
                       *KITTI_SMALL_SETS]}


class Stop(Exception):
    """Stands for a run cut short after its first epoch."""


def _stop_after_first_epoch(runner):
    if runner.epoch == 0:
        raise Stop


def _state_tensors(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [t.clone() for t in state.opt_state.mu + state.opt_state.nu],
            state.opt_state.count, state.step)


def _assert_states_equal(a, b):
    (sd_a, mom_a, count_a, step_a), (sd_b, mom_b, count_b, step_b) = a, b
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert len(mom_a) == len(mom_b)
    assert all(torch.equal(x, y) for x, y in zip(mom_a, mom_b))
    assert (count_a, step_a) == (count_b, step_b)


def _log_records(work_dir):
    with open(work_dir / "train_log.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items()
                 if not k.endswith("_ms")} for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the dataset, an unbroken 2-epoch run of the train CLI
    (with a profiler window and two hooks), and the same run stopped after
    its first epoch's checkpoint and resumed."""
    out = {}
    for name, args, write in (("nusc", NUSC_ARGS, write_tiny_nuscenes),
                              ("kitti", KITTI_ARGS, write_tiny_kitti)):
        root = tmp_path_factory.mktemp(name)
        info = write(root, n=4)
        data = ["--data-root", str(root), "--info-path", str(info)]
        order = []
        hooks = [Hook(10, "late", after_iter=lambda r: order.append("late")),
                 Hook(0, "early", after_iter=lambda r: order.append("early"),
                      before_epoch=lambda r: r.profile_steps(1, 1))]
        whole = train_cli.main(args + data + RUN_ARGS + [
            "--work-dir", str(root / "whole")], hooks=hooks)
        with pytest.raises(Stop):
            train_cli.main(args + data + RUN_ARGS + [
                "--work-dir", str(root / "cut")],
                hooks=[Hook(0, "stop", after_epoch=_stop_after_first_epoch)])
        first_ckpt = ckpt.list_checkpoints(root / "cut" / "ckpt")
        resumed = train_cli.main(args + data + RUN_ARGS + [
            "--work-dir", str(root / "cut")])
        out[name] = dict(root=root, info=info, whole=whole, resumed=resumed,
                         order=order, first_ckpt=first_ckpt)
    return out


@pytest.mark.parametrize("name", ["nusc", "kitti"])
def test_resume_equals_unbroken_run(runs, name):
    """Four steps unbroken equal two steps, a resume from the checkpoint
    and two more steps, bit for bit: parameters, every buffer, the
    optimizer's moments and count, the step and the logs (Voxel R-CNN's
    RoI sampler noise drawn from the step count). Also the Runner's hooks
    by priority, its profiler trace, its TensorBoard file and its
    checkpoints."""
    r = runs[name]
    whole, resumed = r["whole"], r["resumed"]
    assert [s for s, _ in r["first_ckpt"]] == [2]
    assert whole.global_step == resumed.global_step == 4
    assert resumed.restore_seconds is not None
    assert [t[0] for t in resumed.timings] == [2, 3]
    _assert_states_equal(_state_tensors(whole.state),
                         _state_tensors(resumed.state))
    assert (_log_records(r["root"] / "whole")
            == _log_records(r["root"] / "cut"))
    assert r["order"] == ["early", "late"] * 4
    assert list((r["root"] / "whole" / "profile").glob("steps_1_2.json"))
    assert list((r["root"] / "whole" / "tensorboard").glob("events.*"))
    assert [s for s, _ in ckpt.list_checkpoints(
        r["root"] / "whole" / "ckpt")] == [2, 4]


def test_train_cli_equals_direct_steps(runs):
    """The train CLI's first two steps equal the port's CenterPoint step
    (built by `build_detector` at the CLI's schedule) applied directly to
    the loader's two batches of the first epoch."""
    r = runs["nusc"]
    preset = apply_preset_overrides(get_preset("centerpoint_tiny_smoke"),
                                    NUSC_SMALL_SETS)
    built = build_detector(preset, adam_onecycle(1e-3, 4), device="cpu")
    loader = PrefetchLoader(
        NuScenesDataset(r["root"], r["info"]), 2,
        lambda s: make_batch(s, 1000, preset.max_objs, 5))
    state = built.state
    for batch in loader:
        state, _ = built.step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    saved = build_detector(preset, adam_onecycle(1e-3, 4),
                           device="cpu").state
    ckpt.restore_checkpoint(r["first_ckpt"][0][1], saved)
    _assert_states_equal(_state_tensors(state), _state_tensors(saved))


def _direct_detections(name, r, profile="exact", tta=None):
    """The eval loop's records from the port's serving functions on the
    last checkpoint, batch 1, without the CLI."""
    from df3d_torch.data.kitti import KittiDataset
    from df3d_torch.serving import apply_profile
    from df3d_torch.train.trainer import make_centerpoint_eval_step

    if name == "nusc":
        preset = apply_preset_overrides(get_preset("centerpoint_tiny_smoke"),
                                        NUSC_SMALL_SETS)
    else:
        preset = apply_preset_overrides(get_preset("voxel_rcnn_car_kitti"),
                                        KITTI_SMALL_SETS)
    built = build_detector(preset, adam_onecycle(1e-3, 1), device="cpu")
    ckpt.restore_latest(r["root"] / "whole" / "ckpt", built.state)
    model = built.state.model.eval()
    apply_profile(model, profile)
    cfg = built.lidar_cfg
    recall, first, second = {}, [], []
    if name == "nusc":
        dataset = NuScenesDataset(r["root"], r["info"])
        step = make_centerpoint_eval_step(model, cfg, tta=tta)
    else:
        dataset = KittiDataset(r["root"], r["info"], training=False)
    for i in range(len(dataset)):
        s = dataset[i]
        batch = make_batch([s], 1000 if name == "nusc" else 600, 500,
                           cfg.num_point_features)
        arrays = {k: torch.from_numpy(v) for k, v in batch.items()}
        if name == "nusc":
            a, b = nuscenes_records(step(arrays), batch)
        else:
            det, _ = entry.infer_voxelrcnn(model.rpn, model.rcnn, cfg,
                                           arrays["points"],
                                           arrays["points_valid"])
            a, b = kitti_records(det, [s], ("Car",), recall)
        first += a
        second += b
    if name == "nusc":
        return nuscenes_metrics(first, second)
    return kitti_metrics(first, second, recall, ("Car",))


@pytest.mark.parametrize("name, extra", [
    ("nusc", []), ("nusc", ["--tta", "double_flip", "--serving-profile",
                            "tpu_v5e"]),
    ("kitti", [])], ids=["nusc", "nusc_tta_tpu_v5e", "kitti"])
def test_test_cli_metrics_equal_evaluate(runs, name, extra):
    """The test CLI's metrics JSON equals `train.evaluate`'s metrics of the
    same checkpoint's detections made without the CLI (double-flip TTA in
    "tpu_v5e" through `make_centerpoint_eval_step`)."""
    r = runs[name]
    out = r["root"] / f"metrics{len(extra)}.json"
    step = test_cli.main(
        EVAL_ARGS[name] + ["--data-root", str(r["root"]), "--info-path", str(r["info"]),
           "--ckpt", str(r["root"] / "whole" / "ckpt"), "--out", str(out)]
        + extra)
    assert step == 4
    got = json.loads(out.read_text())
    kw = dict(profile="tpu_v5e", tta="double_flip") if extra else {}
    want = json.loads(json.dumps(dict(_direct_detections(name, r, **kw),
                                      step=4), default=float))
    assert got == want


def test_synthetic_cli_runs_and_needs_a_device(tmp_path, monkeypatch):
    """`--synthetic --device cpu` trains, and the test CLI evaluates its
    checkpoint on a dataset on disk; without `--device cpu` and without a
    card, both CLIs raise, and the test CLI raises on an empty checkpoint
    directory."""
    info = write_tiny_nuscenes(tmp_path, n=2)
    runner = train_cli.main([
        "--preset", "centerpoint_tiny_smoke", "--synthetic", "--device",
        "cpu", "--epochs", "1", "--steps-per-epoch", "2", "--batch-size",
        "1", "--synthetic-points", "500", "--work-dir",
        str(tmp_path / "wd")])
    assert runner.global_step == 2
    for line in (tmp_path / "wd" / "train_log.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert np.isfinite(rec["loss"]) and rec["step_ms"] > 0
    eval_args = ["--preset", "centerpoint_tiny_smoke", "--data-root",
                 str(tmp_path), "--info-path", str(info), "--max-points",
                 "1000", "--ckpt", str(tmp_path / "wd" / "ckpt")]
    assert test_cli.main(eval_args + ["--device", "cpu"]) == 2
    with pytest.raises(SystemExit):
        test_cli.main(eval_args[:-1] + [str(tmp_path / "none"), "--device",
                                        "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--preset", "centerpoint_tiny_smoke", "--synthetic",
                        "--work-dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(eval_args)


def test_checkpoint_round_trip_and_pruning(tmp_path):
    """save_checkpoint writes step_NNNNNNNN files through a temporary name
    and keeps the newest five; restore_latest and restore_checkpoint give
    back the saved model (parameters and buffers), moments, count and step
    bit for bit, on a state that had moved on."""
    from df3d_torch.train.trainer import create_train_state

    model = torch.nn.Sequential(torch.nn.Linear(7, 5),
                                torch.nn.BatchNorm1d(5),
                                torch.nn.Linear(5, 3))
    model[0].requires_grad_(False)  # a frozen part: in the model, no moments
    state = create_train_state(model, adam_onecycle(1e-3, 10))
    saved = {}
    for s in range(1, 8):
        with torch.no_grad():
            for p in state.params:
                p.add_(0.01 * s)
            for m in state.opt_state.mu:
                m.add_(0.1)
        state.opt_state.count = state.step = s
        for name, b in state.model.named_buffers():
            if "running_mean" in name:
                b.add_(s)
        ckpt.save_checkpoint(tmp_path, state, s, epoch=s)
        saved[s] = _state_tensors(state)
    assert [s for s, _ in ckpt.list_checkpoints(tmp_path)] == [3, 4, 5, 6, 7]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{s:08d}" for s in range(3, 8)]
    with torch.no_grad():
        for p in state.params:
            p.mul_(-1)
    restored, got = ckpt.restore_latest(tmp_path, state)
    assert got == 7 and restored is state
    _assert_states_equal(_state_tensors(state), saved[7])
    _, got = ckpt.restore_checkpoint(tmp_path / "step_00000004", state)
    assert got == 4
    _assert_states_equal(_state_tensors(state), saved[4])
    meta = ckpt.load_checkpoint(tmp_path / "step_00000005", state)
    assert meta == {"step": 5, "epoch": 5}
    assert ckpt.restore_latest(tmp_path / "empty", state) == (None, -1)


def test_scalar_writer_bytes_equal(tmp_path, monkeypatch):
    """The port's event file equals the JAX package's byte for byte at the
    same wall time (crc32c framing, varint steps, float scalars)."""
    import df3d.utils.tb_writer as jtb
    import df3d_torch.utils.tb_writer as ttb

    files = []
    for mod, d in ((ttb, tmp_path / "port"), (jtb, tmp_path / "jax")):
        monkeypatch.setattr(mod.time, "time", lambda: 1760000000.25)
        w = mod.ScalarWriter(d)
        for step, (tag, v) in enumerate(
                [("train/loss", 3.5), ("train/lr", 1e-3),
                 ("train/loss", -0.125), ("x", float("inf"))] * 40):
            w.add_scalar(tag, v, step * 977)
        w.flush()
        w.close()
        files += list(d.iterdir())
    assert len(files) == 2 and files[0].name == files[1].name
    assert files[0].read_bytes() == files[1].read_bytes()
    assert len(files[0].read_bytes()) > 160 * 30


# ---------------------------------------------------------------------------
# the fusion hook's augmentation inputs

HOOK_VS, HOOK_PCR = (0.5, 0.5, 0.25), (-8.0, -8.0, -2.0, 8.0, 8.0, 2.0)
HOOK_GRID = (16, 32, 32)  # (z, y, x) at stride 1


def _hook():
    from df3d_torch.models.fusion.actr import ACTRConfig
    from df3d_torch.models.fusion.hooks import (
        ACTRFusionSpec, MultiCamACTRFusionHook,
    )

    torch.manual_seed(3)
    actr = ACTRConfig(d_model=16, n_heads=2, n_points=2, n_levels=1,
                      num_layers=1, dim_feedforward=16, model_name="ACTR")
    return MultiCamACTRFusionHook(
        ACTRFusionSpec(actr, 8), HOOK_VS, HOOK_PCR, (32, 48), 1, 16, (8,),
        mvx_channels=8).eval()


def _hook_inputs(rng, stride, n=40, flip_rows=False):
    from df3d_torch.ops import sparse as tsp

    z, y, x = (g // stride for g in HOOK_GRID)
    coords = np.stack([rng.randint(0, z, n), rng.randint(0, y, n),
                       rng.randint(0, x, n)], -1).astype(np.int32)
    coords[-4:] = -1
    if flip_rows:  # the y mirror of the grid: y -> -y exactly
        coords[:-4, 1] = y - 1 - coords[:-4, 1]
    feats = rng.randn(1, n, 8 if stride == 1 else 16).astype(np.float32)
    return tsp.SparseTensor(torch.from_numpy(feats),
                            torch.from_numpy(coords)[None], (z, y, x))


def _camera():
    from df3d_torch.utils.synth import camera_rig

    return camera_rig(1, (32, 48))


def test_hook_projection_with_augmentation_against_jax(monkeypatch):
    """At B = 1 (where the JAX package's `augmented_lidar_to_raw`
    broadcasts) the hook projects with the augmentation it is given, at
    MVX (stride 1) and at ACTR (stride 8), as JAX's
    `project_voxels_to_image` does eagerly; and a fused detector hands its
    forward's augmentation to the hook."""
    import jax.numpy as jnp

    from df3d.models.fusion import projection as jproj
    from df3d_torch.models.fusion import hooks as thooks

    seen = []

    def recording(*args, **kw):
        out = project(*args, **kw)
        seen.append((args, kw, out))
        return out

    project = thooks.project_voxels_to_image
    monkeypatch.setattr(thooks, "project_voxels_to_image", recording)
    hook = _hook()
    rng = np.random.RandomState(0)
    proj = torch.from_numpy(_camera())[None]
    image = [torch.from_numpy(rng.randn(1, 1, 8, 12, 8).astype(np.float32))]
    aug = dict(noise_rot=torch.tensor([0.4]), noise_scale=torch.tensor([1.07]),
               flip_x=torch.tensor([True]), flip_y=torch.tensor([True]))
    with torch.no_grad():
        for stride, stage in ((1, "conv1"), (8, "conv4")):
            st = _hook_inputs(rng, stride, n=200)
            hook(st, image, proj, stage=stage, **aug)
            args, kw, (uv, depth, mask) = seen[-1]
            assert kw["downsample"] == stride
            want = jproj.project_voxels_to_image(
                jnp.asarray(st.coords.numpy()), jnp.asarray(st.valid.numpy()),
                jnp.asarray(proj[:, 0].numpy()), (32, 48), HOOK_VS, HOOK_PCR,
                stride, *(jnp.asarray(v.numpy()) for v in aug.values()))
            # the undone rotation and scale round apart from JAX's by a few
            # ulps (1.7e-6 relative at most here); the masks are equal
            np.testing.assert_allclose(uv[:, 0].numpy(), np.asarray(want[0]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(depth[:, 0].numpy(),
                                       np.asarray(want[1]), atol=1e-4)
            np.testing.assert_array_equal(mask[:, 0].numpy(),
                                          np.asarray(want[2]))
            assert mask.any() and not mask.all()

    from df3d_torch.models.detectors.fused import CenterPoint3DDF

    model = CenterPoint3DDF(entry.mesh_cfg(), entry.dryrun_fused_config())
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    received = []
    inner = next(m for m in model.modules()
                 if isinstance(m, thooks.MultiCamACTRFusionHook))
    inner.register_forward_pre_hook(
        lambda m, a, kw: received.append(kw), with_kwargs=True)
    lidar, fused = entry.dryrun_batches(1)
    res = entry.voxelize_batch(
        torch.from_numpy(fused["points"]),
        torch.from_numpy(fused["points_valid"]), *(
            getattr(entry.mesh_cfg(), k) for k in (
                "voxel_size", "pc_range", "grid_size", "max_voxels",
                "max_points_per_voxel")))
    with torch.no_grad():
        model(res.features, res.coords, torch.from_numpy(fused["images"]),
              torch.from_numpy(fused["proj"]), **aug)
    assert received and all(kw[k] is v for kw in received
                            for k, v in aug.items())


def test_hook_undoes_augmentation():
    """The hook on y-mirrored voxels (the same rows, coords mirrored in a
    grid symmetric about y = 0) told of the flip gives exactly what it
    gives on the voxels as they were without augmentation inputs, at both
    fusion points; without the flip it gives something else. Rotation 0
    and scale 1 are passed too and change nothing."""
    hook = _hook()
    proj = torch.from_numpy(_camera())[None]
    rng = np.random.RandomState(1)
    image = [torch.from_numpy(rng.randn(1, 1, 8, 12, 8).astype(np.float32))]
    aug = dict(noise_rot=torch.tensor([0.0]), noise_scale=torch.tensor([1.0]),
               flip_x=torch.tensor([True]), flip_y=torch.tensor([False]))
    with torch.no_grad():
        for stride, stage in ((1, "conv1"), (8, "conv4")):
            seed = 10 + stride
            raw = _hook_inputs(np.random.RandomState(seed), stride)
            flipped = _hook_inputs(np.random.RandomState(seed), stride,
                                   flip_rows=True)
            want = hook(raw, image, proj, stage=stage).features
            got = hook(flipped, image, proj, stage=stage, **aug).features
            assert torch.equal(got, want)
            assert not torch.equal(
                hook(flipped, image, proj, stage=stage).features, want)
