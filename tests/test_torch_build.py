"""`df3d_torch.models.build.build_detector` against the JAX package's
`df3d.models.build.build_detector`, preset by preset at full size.

The JAX `build_detector` runs under `jax.eval_shape` (tracing only, no
compile and no arrays: its `model.init` gives the variables' shapes), and
the port's builds on the meta device (its modules and their shapes, no
values to draw). For each of the eight presets: `family`, `fused`,
`num_cams` and `image_shape` are JAX's, the LiDAR config and every field
of the port's `FusedConfig` equal JAX's, and the JAX tree's every
parameter and batch statistic carries into the port's model through
`weights.state_dict_from_flax`, which raises on a leaf with no entry, an
entry no leaf fills, or a shape that disagrees (Voxel R-CNN: the "rpn"
tree into the first stage, "rcnn" into the head).

`centerpoint_tiny_smoke` is then served both ways: JAX's template with
seeded weights through the package's `make_centerpoint_eval_step` (one
jitted program), the port's `build_detector(...).infer` with the weights
carried across. Detections: the valid set and labels equal, boxes within
1e-4 and scores within 1e-5 (f32 in another summation order), with JAX's
top-k and NMS decisions replayed where the port's differ (at most 4
entries within 1e-4 of the score they replace; counted and printed)."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from df3d.config.presets import PRESETS as JPRESETS
from df3d.config.presets import get_preset as jget_preset
from df3d.models import build as jbuild
from df3d.train.trainer import make_centerpoint_eval_step
from df3d_torch.config import get_preset
from df3d_torch.entry import random_points
from df3d_torch.models.build import build_detector, preset_image_shape
from df3d_torch.models.detectors.centerpoint import centerpoint_predict
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.weights import state_dict_from_flax
from test_torch_slice import _hm_logits_moderate
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

MAX_REPLAYS, REPLAY_GAP = 4, 1e-4


@functools.lru_cache(maxsize=None)
def _jax_build(name: str):
    """The JAX package's `build_detector` on a preset, traced (once a
    preset): (its namespace, the params' and batch_stats' shapes)."""
    box = {}

    def run():
        ns = jbuild.build_detector(jget_preset(name), optax.identity())
        box["ns"] = ns
        return ns.state.params, ns.state.batch_stats

    params, stats = jax.eval_shape(run)
    return box["ns"], params, stats


def _meta(tree):
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tree)


def _carried(model, params, stats):
    """`model`'s state dict from a meta tree of the JAX shapes, checked
    entry by entry against the model's own."""
    sd = state_dict_from_flax(model, {"params": _meta(params),
                                      "batch_stats": _meta(stats)})
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape, k
    return sd


@pytest.mark.parametrize("name", sorted(JPRESETS))
def test_build_detector_matches_jax(name):
    jns, params, stats = _jax_build(name)
    with torch.device("meta"):
        ns = build_detector(get_preset(name), device="meta")
    for field in ("family", "fused", "num_cams", "image_shape"):
        assert getattr(ns, field) == getattr(jns, field), field
    assert (dataclasses.asdict(ns.lidar_cfg)
            == dataclasses.asdict(jns.lidar_cfg))
    if ns.fused:
        for f in dataclasses.fields(ns.fcfg):
            got, want = getattr(ns.fcfg, f.name), getattr(jns.fcfg, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name
    else:
        assert ns.fcfg is None and jns.fcfg is None
    assert not ns.model.training and callable(ns.infer)
    if ns.family == "voxelrcnn":
        assert type(ns.head).__name__ == type(jns.head).__name__
        _carried(ns.model, params["rpn"], stats["rpn"])
        _carried(ns.head, params["rcnn"], stats["rcnn"])
    else:
        assert ns.head is None and jns.head is None
        _carried(ns.model, params, stats)


def test_preset_image_shape():
    for preset, override in ((get_preset("voxel_rcnn_3ddf_kitti"), None),
                             (get_preset("centerpoint_nusc"), None),
                             (get_preset("centerpoint_3ddf_nusc"),
                              [256, 704])):
        assert preset_image_shape(preset, override) == \
            jbuild.preset_image_shape(preset, override)


def test_profile_with_optimizer_raises():
    """The bf16 conv body has no gradient: a trainer builds in "exact"
    only. With an optimizer the namespace adds the state and the step,
    the model in training mode."""
    preset = get_preset("centerpoint_tiny_smoke")
    tx = adam_onecycle(1e-3, 10)
    with pytest.raises(ValueError, match="exact"):
        build_detector(preset, tx, device="cpu", profile="tpu_v5e")
    ns = build_detector(preset, tx, device="cpu")
    assert ns.state.model is ns.model and ns.model.training
    assert ns.state.tx is tx and callable(ns.step)
    assert not hasattr(ns, "infer")
    served = build_detector(preset, device="cpu", profile="tpu_v5e")
    assert not hasattr(served, "state")
    convs = [m for m in served.model.modules() if hasattr(m, "min_channels")]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)


class _Recorded:
    """A flax module whose `apply`, as the eval step calls it, also keeps
    the head maps (no second trace of the model)."""

    def __init__(self, module, store):
        self.module, self.store = module, store

    def apply(self, *args, **kwargs):
        out = self.module.apply(*args, **kwargs)
        self.store["preds"] = out[0]
        return out


@pytest.fixture(scope="module")
def tiny_run():
    name = "centerpoint_tiny_smoke"
    rng = np.random.RandomState(0)
    points = random_points(rng, 1, 1500)
    valid = rng.rand(1, 1500) > 0.05
    batch = {"points": points, "points_valid": valid}

    jns, params, stats = _jax_build(name)
    variables = seeded_variables({"params": params, "batch_stats": stats},
                                 np.random.RandomState(1),
                                 _hm_logits_moderate)
    seen = {}
    step = make_centerpoint_eval_step(_Recorded(jns.model, seen),
                                      jns.lidar_cfg)

    @jax.jit  # one program: the package's eval step and its head maps
    def run(v, b):
        return step(SimpleNamespace(**v), b), seen["preds"]

    jdet, jpreds = jax.tree_util.tree_map(np.array, run(variables, batch))

    ns = build_detector(get_preset(name), device="cpu")
    ns.model.load_state_dict(state_dict_from_flax(ns.model, variables))
    # JAX's decisions: the port's decoding on JAX's maps
    store = []
    with chip_smoke.centerpoint_decisions(store, replay=False):
        jdet_port = centerpoint_predict(
            ns.lidar_cfg, [{k: torch.from_numpy(v) for k, v in p.items()}
                           for p in jpreds])
    with chip_smoke.centerpoint_decisions(store, replay=True) as replays:
        tdet, _ = ns.infer(torch.from_numpy(points), torch.from_numpy(valid))
    return dict(jdet=jdet, jdet_port=jdet_port, tdet=tdet, replays=replays)


def test_tiny_smoke_detections(tiny_run):
    r = tiny_run
    j, jp, t = r["jdet"], r["jdet_port"], r["tdet"]
    valid = j["valid"]
    assert valid.any()
    # the recorded decisions are JAX's: the port's decoding of JAX's maps
    # gives JAX's detections
    np.testing.assert_array_equal(jp["valid"].numpy(), valid)
    np.testing.assert_array_equal(jp["labels"].numpy()[valid],
                                  j["labels"][valid])
    print(f"replays: {r['replays']}")
    assert sum(n for _, n, _ in r["replays"]) <= MAX_REPLAYS
    assert all(gap <= REPLAY_GAP for _, _, gap in r["replays"])
    np.testing.assert_array_equal(t["valid"].numpy(), valid)
    np.testing.assert_array_equal(t["labels"].numpy()[valid],
                                  j["labels"][valid])
    box_gap = np.abs(t["boxes"].numpy()[valid] - j["boxes"][valid]).max()
    score_gap = np.abs(t["scores"].numpy() - j["scores"]).max()
    print(f"detections: box gap {box_gap:.3e}, score gap {score_gap:.3e}")
    assert box_gap <= 1e-4 and score_gap <= 1e-5
