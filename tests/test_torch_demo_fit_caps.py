"""The demo (`df3d_torch.tools.demo`, port of tools/demo.py) and the cap
fitter (`df3d_torch.tools.fit_caps`, port of tools/fit_caps.py), on the
CPU; no JAX program is compiled.

The demo's detections equal the test CLI's eval step (`tools.test.
build_eval`) on the same frame and checkpoint, bit for bit, and it prints
them in the JAX demo's format. fit_caps' per-stage occupancies equal an
independent numpy count of the same sites (the voxels, then each
strided conv's output sites: o = (i + pad - k) / 2 for every tap k where
that is a whole number inside the grid); the port's plans, which the
tool reads, are held bit for bit against the JAX package's in
tests/test_torch_sparse_conv.py."""

import argparse
import re

import numpy as np
import pytest
import torch

from df3d_torch.config import get_preset
from df3d_torch.data.nuscenes import NuScenesDataset
from df3d_torch.entry import random_points
from df3d_torch.models.build import build_detector
from df3d_torch.tools import demo
from df3d_torch.tools import fit_caps
from df3d_torch.tools import test as test_cli
from df3d_torch.train import checkpoint as ckpt
from df3d_torch.train.schedules import adam_onecycle
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import write_tiny_nuscenes


def _preset():
    return get_preset("centerpoint_tiny_smoke")


@pytest.fixture(scope="module")
def frame_and_ckpt(tmp_path_factory):
    """A 4-feature .bin and a train-CLI checkpoint of moved weights."""
    tmp = tmp_path_factory.mktemp("demo")
    pts = random_points(np.random.RandomState(0), 1, 1500, f=4)[0]
    pts.tofile(tmp / "frame.bin")
    state = build_detector(_preset(), adam_onecycle(1e-3, 1),
                           device="cpu").state
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in state.params:
            p.add_(1e-3 * torch.randn(p.shape, generator=g))
    ckpt.save_checkpoint(tmp / "ckpt", state, 3, epoch=1)
    return tmp, pts


def test_demo_equals_the_test_cli_eval_step(frame_and_ckpt, capsys):
    """The demo on the checkpoint (the .bin's 4 features padded with a
    zero time-lag column) gives the test CLI's eval step's detections on
    the same frame and weights, and prints those at or above the
    threshold as the JAX demo does."""
    tmp, pts = frame_and_ckpt
    got = demo.main(["--preset", "centerpoint_tiny_smoke", "--bin",
                     str(tmp / "frame.bin"), "--num-features", "4", "--ckpt",
                     str(tmp / "ckpt"), "--score-thresh", "0.1",
                     "--device", "cpu"])
    args = argparse.Namespace(image_shape=None, aux_loss=False, tta=None,
                              serving_profile="exact")
    state, eval_step, *_ = test_cli.build_eval(args, _preset(), "cpu")
    _, step = ckpt.restore_latest(tmp / "ckpt", state)
    padded = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    want = eval_step({"points": torch.from_numpy(padded[None]),
                      "points_valid": torch.ones(1, len(pts), dtype=bool)})
    for k in ("boxes", "scores", "labels", "valid"):
        assert np.array_equal(got[k], want[k][0].numpy()), k
    keep = got["valid"] & (got["scores"] >= 0.1)
    assert step == 3 and keep.sum() > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [f"loaded 1500 points from {tmp / 'frame.bin'}",
                         "restored checkpoint step 3",
                         f"{keep.sum()} detections (score >= 0.1):"]
    pat = re.compile(r"  cls=(\d+) score=(\d\.\d{3}) box=\[(.*)\]$")
    for line, b, s, l in zip(lines[3:], got["boxes"][keep],
                             got["scores"][keep], got["labels"][keep]):
        m = pat.fullmatch(line)
        assert m and int(m[1]) == l and m[2] == f"{s:.3f}"
        assert [float(v) for v in m[3].split(",")] == np.round(
            b, 2).tolist()
    assert len(lines) == 3 + keep.sum()


def test_demo_presets_and_device(frame_and_ckpt):
    """The demo serves the LiDAR-only CenterPoint presets only; without a
    card it raises unless `--device cpu`; an empty checkpoint directory
    raises."""
    tmp, _ = frame_and_ckpt
    for name in ("centerpoint_3ddf_nusc", "voxel_rcnn_car_kitti",
                 "transfusion_l_nusc"):
        with pytest.raises(ValueError, match="CenterPoint"):
            demo.main(["--preset", name, "--bin", str(tmp / "frame.bin"),
                       "--device", "cpu"])
    with pytest.raises(SystemExit):
        demo.main(["--preset", "centerpoint_tiny_smoke", "--bin",
                   str(tmp / "frame.bin"), "--num-features", "4", "--ckpt",
                   str(tmp / "none"), "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--preset", "centerpoint_tiny_smoke", "--bin",
                   str(tmp / "frame.bin")])


def _numpy_occupancy(cfg, points):
    """(4,) occupancy counted in numpy: the distinct voxels in range, then
    each strided conv's distinct output sites."""
    lo, hi = np.asarray(cfg.pc_range[:3]), np.asarray(cfg.pc_range[3:])
    vs = np.asarray(cfg.voxel_size)
    p = points[:, :3].astype(np.float64)
    ok = ((p >= lo) & (p < hi)).all(1)
    xyz = np.floor((p[ok] - lo) / vs).astype(np.int64)
    sites = np.unique(xyz[:, ::-1], axis=0)  # (z, y, x)
    shape = np.asarray(cfg.sparse_shape)
    occ = [len(sites)]
    taps = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    for pad in fit_caps.KZ_PADS:
        pad = np.asarray((pad,) * 3 if isinstance(pad, int) else pad)
        out_shape = (shape + 2 * pad - 3) // 2 + 1
        o = sites[:, None, :] + pad - taps[None]
        even = (o % 2 == 0).all(-1)
        o = o[even] // 2
        o = o[((o >= 0) & (o < out_shape)).all(-1)]
        sites, shape = np.unique(o, axis=0), out_shape
        occ.append(len(sites))
    return np.asarray(occ)


def test_fit_caps_occupancy_and_fit(tmp_path, capsys):
    """On a tiny nuScenes dataset: each frame's four occupancies equal
    the numpy count; the printed JSON holds each stage's maximum, mean,
    99th percentile and the fitted cap (the percentile x 1.05 rounded up
    to a multiple of 1024), for the frames asked."""
    import json

    info = write_tiny_nuscenes(tmp_path, n=3)
    out = fit_caps.main(["--preset", "centerpoint_tiny_smoke",
                         "--data-root", str(tmp_path), "--info-path",
                         str(info), "--frames", "3", "--max-points", "6000",
                         "--device", "cpu"])
    cfg = _preset()
    ds = NuScenesDataset(tmp_path, info)
    want = np.stack([_numpy_occupancy(cfg, ds[i]["points"])
                     for i in range(3)])
    assert np.array_equal(out["per_frame"], want)
    assert (want > 0).all()
    printed = json.loads(capsys.readouterr().out)
    assert printed == {k: v for k, v in out.items() if k != "per_frame"}
    assert printed["frames"] == 3
    for s, d in enumerate(printed["detail"]):
        v = want[:, s]
        assert (d["stage"], d["max"], d["mean"]) == (s + 1, v.max(),
                                                    v.mean())
        assert d["p99"] == np.percentile(v, 99)
        assert d["fitted_cap"] == int(np.ceil(d["p99"] * 1.05 / 1024) * 1024)
    assert printed["stage_caps"] == [d["fitted_cap"]
                                     for d in printed["detail"]]


def test_fit_caps_synthetic_frames_and_device(monkeypatch, tmp_path):
    """`--synthetic` measures frames 0..n-1 of the ray-cast generator with
    the preset's extra point features (a cheap stand-in here: one frame
    takes ~10 s to cast); without a card the tool raises unless `--device
    cpu`."""
    seen = []

    def frame(seed, n_points, extra):
        seen.append((seed, n_points, extra))
        return random_points(np.random.RandomState(seed), 1, 500,
                             3 + extra)[0]

    monkeypatch.setattr(fit_caps, "synthetic_frame", frame)
    out = fit_caps.main(["--preset", "centerpoint_tiny_smoke", "--synthetic",
                         "--frames", "2", "--max-points", "800", "--device",
                         "cpu"])
    assert seen == [(0, 800, 2), (1, 800, 2)]
    cfg = _preset()
    for i in range(2):
        assert np.array_equal(out["per_frame"][i], _numpy_occupancy(
            cfg, frame(i, 800, 2)))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_caps.main(["--preset", "centerpoint_tiny_smoke", "--synthetic",
                       "--frames", "1"])
