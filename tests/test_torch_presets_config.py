"""The presets registry and the config module, df3d_torch against df3d:
every preset field by field (`dataclasses.asdict` of each config, the
fused presets' dict keys and values), `get_preset`'s error, `load_config`
on YAML files the test writes (`_base_` two levels deep, both spellings, a
list of bases, paths relative to the file), `apply_preset_overrides` and
`merge_overrides` against the JAX functions on the same inputs, their
errors included. Every comparison is exact. No JAX program runs."""

import dataclasses

import pytest

from df3d.config import config as jconfig
from df3d.config import presets as jpresets
from df3d_torch.config import config as tconfig
from df3d_torch.config import presets as tpresets
from torch_port_helpers import one_torch_thread  # noqa: F401

NAMES = sorted(jpresets.PRESETS)


def _plain(preset):
    """A preset as nested plain values: each config dataclass as (class
    name, its asdict), a fused preset's dict key by key."""
    if isinstance(preset, dict):
        return {k: _plain(v) for k, v in preset.items()}
    if dataclasses.is_dataclass(preset):
        return type(preset).__name__, dataclasses.asdict(preset)
    return preset


def test_registry_names():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    assert len(NAMES) == 8 and "centerpoint_tiny_smoke" in NAMES


@pytest.mark.parametrize("name", NAMES)
def test_preset_field_by_field(name):
    got, want = tpresets.get_preset(name), jpresets.get_preset(name)
    assert _plain(got) == _plain(want)
    # a fresh copy each call, as the JAX registry gives
    assert tpresets.get_preset(name) is not got


def test_unknown_preset_error():
    with pytest.raises(KeyError) as jerr:
        jpresets.get_preset("nope")
    with pytest.raises(KeyError) as terr:
        tpresets.get_preset("nope")
    assert str(terr.value) == str(jerr.value)


def _write(tmp_path, files: dict):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


# configs the tests write: `_base_` two levels deep (relative to each
# file), the pcdet spelling, a list of bases, and a base given as an
# absolute path
CONFIGS = {
    "base/common.yaml": "model:\n  head: {nms: 0.2, post: 83}\n"
                      "  voxel: [0.1, 0.1, 0.2]\ndata: {root: /data}\n",
    "base/mid.yaml": "_base_: common.yaml\nmodel:\n  head: {nms: 0.3}\n"
                     "optim: {lr: 0.001}\n",
    "two_levels.yaml": "_base_: base/mid.yaml\nmodel:\n  head: {post: 100}\n"
                       "data: {sweeps: 10}\n",
    "pcdet.yaml": "_BASE_CONFIG_: base/mid.yaml\noptim: {lr: 0.003}\n",
    "extra.yaml": "optim: {wd: 0.01}\nmodel: {voxel: [0.2, 0.2, 0.4]}\n",
    "listed.yaml": "_base_: [base/mid.yaml, extra.yaml]\n"
                   "data: null\n",
    "empty.yaml": "",
}


@pytest.mark.parametrize("name", ["two_levels.yaml", "pcdet.yaml",
                                  "listed.yaml", "empty.yaml",
                                  "absolute.yaml"])
def test_load_config(tmp_path, name):
    files = dict(CONFIGS)
    files["absolute.yaml"] = (f"_base_: {tmp_path / 'two_levels.yaml'}\n"
                              "model: {extra: 1}\n")
    _write(tmp_path, files)
    got = tconfig.load_config(tmp_path / name)
    want = jconfig.load_config(tmp_path / name)
    assert got == want and isinstance(got, tconfig.Config)
    if name == "two_levels.yaml":
        assert got.model.head.nms == 0.3 and got.model.head.post == 100
        assert got.data.root == "/data" and "_base_" not in got
    with pytest.raises(AttributeError):
        got.nothing_here


OVERRIDE_CASES = [
    ("centerpoint_nusc", ["max_voxels=90000", "score_threshold=0.2"]),
    # a tuple field set from a list
    ("centerpoint_nusc", ["stage_caps=[100, 50, 25, 12]",
                          "voxel_size=[0.1, 0.1, 0.2]"]),
    ("transfusion_l_nusc", ["head.num_proposals=300",
                            "head.small_classes=[7]"]),
    # nested fused paths
    ("centerpoint_3ddf_nusc", ["actr.d_model=64", "num_cams=1",
                               "image_shape=[384, 1280]",
                               "lidar.nms_post_max_size=50"]),
    ("voxel_rcnn_3ddf_kitti", ["lidar.rcnn.grid_size=4",
                               "actr.exact_ops=true",
                               "lidar.test_nms_thresh=0.5"]),
    # a value YAML does not parse stays a string
    ("transfusion_3ddf_swin_nusc", ["image_branch=swin",
                                    "actr.attn_layer=a: b: c"]),
]


@pytest.mark.parametrize("name, overrides", OVERRIDE_CASES)
def test_apply_preset_overrides(name, overrides):
    got = tconfig.apply_preset_overrides(tpresets.get_preset(name),
                                         overrides)
    want = jconfig.apply_preset_overrides(jpresets.get_preset(name),
                                          overrides)
    assert _plain(got) == _plain(want)
    assert _plain(got) != _plain(tpresets.get_preset(name))


@pytest.mark.parametrize("name, override, error", [
    ("centerpoint_nusc", "no_such_field=1", KeyError),
    ("centerpoint_3ddf_nusc", "nothing.d_model=64", KeyError),
    ("centerpoint_3ddf_nusc", "actr.d_model.bits=1", KeyError),
    ("voxel_rcnn_car_kitti", "rcnn.scales.radius=0.5", KeyError),
    ("transfusion_l_nusc", "head.num_proposals", ValueError),
])
def test_apply_preset_overrides_errors(name, override, error):
    with pytest.raises(error) as jerr:
        jconfig.apply_preset_overrides(jpresets.get_preset(name), [override])
    with pytest.raises(error) as terr:
        tconfig.apply_preset_overrides(tpresets.get_preset(name), [override])
    assert str(terr.value) == str(jerr.value)


MERGE_CASES = [
    ["model.head.nms=0.1", "model.head.new=[1, 2]", "data.sweeps=5"],
    # missing levels are made; a scalar in the way is replaced by a dict
    ["fresh.a.b=true", "data.root.sub=x", "optim.lr=1e-4"],
    {"model.head.post": "50", "optim.lr": 0.5, "flag": "on"},
]


@pytest.mark.parametrize("overrides", MERGE_CASES)
def test_merge_overrides(tmp_path, overrides):
    _write(tmp_path, CONFIGS)
    base = jconfig.load_config(tmp_path / "two_levels.yaml")
    got = tconfig.merge_overrides(tconfig.Config(base), overrides)
    want = jconfig.merge_overrides(base, overrides)
    assert got == want and isinstance(got, tconfig.Config)
    # the input is left as it was
    assert base == jconfig.load_config(tmp_path / "two_levels.yaml")


def test_merge_overrides_missing_equals():
    with pytest.raises(ValueError):
        jconfig.merge_overrides(jconfig.Config(), ["model.head.nms"])
    with pytest.raises(ValueError):
        tconfig.merge_overrides(tconfig.Config(), ["model.head.nms"])
