"""The port's reference-checkpoint importers (df3d_torch.train.torch_import,
import_centerpoint, import_voxelrcnn, import_transfusion) against the JAX
package's: the synthetic det3d, pcdet and mmdet3d state dicts of the JAX
package's importer tests, at their small widths, go through the JAX
importer into a flax tree (templates from `jax.eval_shape` and seeded
numpy: no flax init) and then `weights.state_dict_from_flax`; the port's
direct import of the same dict must give the same entries, bit for bit.
The direct import is strict both ways: a stray key or a missing one
raises and names itself. Nothing here compiles a JAX program."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.detectors.centerpoint import CenterPoint as JCenterPoint
from df3d.models.detectors.transfusion import TransFusionL as JTransFusionL
from df3d.models.detectors.voxel_rcnn import VoxelRCNN as JVoxelRCNN
from df3d.models.heads.voxelrcnn_head import VoxelRCNNHead as JHead
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train import import_centerpoint as jic
from df3d.train import import_transfusion as jit_
from df3d.train import import_voxelrcnn as jiv
from df3d.train import torch_import as jti
from df3d_torch import entry
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNN, VoxelRCNNConfig
from df3d_torch.models.heads.voxelrcnn_head import VoxelRCNNHead
from df3d_torch.train import torch_import as tti
from df3d_torch.train.import_centerpoint import import_centerpoint
from df3d_torch.train.import_transfusion import import_transfusion
from df3d_torch.train.import_voxelrcnn import (
    import_voxelrcnn, spconv_taps_auto,
)
from df3d_torch.weights import state_dict_from_flax
from test_import_centerpoint import TINY as CP_TINY
from test_import_centerpoint import _synth_det3d_sd
from test_import_transfusion import TINY as TF_TINY
from test_import_transfusion import _synth_mmdet3d_sd
from test_import_voxelrcnn import TINY as VR_TINY
from test_import_voxelrcnn import _synth_pcdet_sd
from torch_port_helpers import port_config, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)


def _voxel_shapes(cfg, n_feat):
    """Abstract voxelizer outputs of one sample of 300 points."""
    pts = jax.ShapeDtypeStruct((1, 300, n_feat), jnp.float32)
    valid = jax.ShapeDtypeStruct((1, 300), jnp.bool_)
    return jax.eval_shape(
        lambda p, v: jvoxelize_batch(p, v, cfg.voxel_size, cfg.pc_range,
                                     cfg.grid_size, cfg.max_voxels, 5),
        pts, valid)


def _template(shapes, seed):
    """A flax variables template: seeded numpy in the shapes of
    `jax.eval_shape(model.init ...)`."""
    return seeded_variables(shapes, np.random.RandomState(seed))


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _centerpoint():
    jmodel = JCenterPoint(CP_TINY)
    res = _voxel_shapes(CP_TINY, 4)
    variables = _template(jax.eval_shape(
        lambda f, c: jmodel.init(KEY, f, c, train=False), res.features,
        res.coords), 1)
    sd = _synth_det3d_sd(np.random.RandomState(0))
    want = jic.import_centerpoint(variables, sd)
    model = CenterPoint(port_config(CP_TINY, CenterPointConfig()))
    return dict(models=(model,), sd=sd, want=(want,),
                direct=lambda models, tsd: (import_centerpoint(models[0], tsd),))


def _voxelrcnn():
    jmodel = JVoxelRCNN(VR_TINY)
    jhead = JHead(VR_TINY.rcnn, VR_TINY.voxel_size, VR_TINY.pc_range)
    res = _voxel_shapes(VR_TINY, 4)
    r = VR_TINY.rcnn.roi_per_image

    def init(f, c):
        rpn_vars = jmodel.init(KEY, f, c, train=False)
        preds = jmodel.apply(rpn_vars, f, c, train=False)
        rois = jnp.zeros((1, r, 7), jnp.float32)
        return rpn_vars, jhead.init(KEY, rois, jnp.ones((1, r)), preds["ms"],
                                    train=False)

    rpn_shapes, rcnn_shapes = jax.eval_shape(init, res.features, res.coords)
    rpn_vars, rcnn_vars = _template(rpn_shapes, 1), _template(rcnn_shapes, 2)
    sd = _synth_pcdet_sd(np.random.RandomState(0), rpn_shapes, rcnn_shapes)
    want = jiv.import_voxelrcnn(rpn_vars, rcnn_vars, sd)
    cfg = port_config(VR_TINY, VoxelRCNNConfig())
    models = (VoxelRCNN(cfg),
              VoxelRCNNHead(cfg.rcnn, cfg.voxel_size, cfg.pc_range))
    return dict(models=models, sd=sd, want=want,
                direct=lambda models, tsd: import_voxelrcnn(*models, tsd))


def _transfusion():
    jmodel = JTransFusionL(TF_TINY)
    res = _voxel_shapes(TF_TINY, 5)
    shapes = jax.eval_shape(
        lambda f, c: jmodel.init(KEY, f, c, train=False), res.features,
        res.coords)
    variables = _template(shapes, 1)
    sd = _synth_mmdet3d_sd(np.random.RandomState(0), shapes)
    want = jit_.import_transfusion(variables, sd,
                                   num_heads=TF_TINY.head.num_heads)
    model = TransFusionL(port_config(TF_TINY, TransFusionConfig()))
    return dict(models=(model,), sd=sd, want=(want,),
                direct=lambda models, tsd: (import_transfusion(models[0], tsd),))


FAMILIES = {"centerpoint": _centerpoint, "voxelrcnn": _voxelrcnn,
            "transfusion": _transfusion}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return dict(FAMILIES[request.param](), name=request.param)


def test_direct_import_equals_the_jax_route(family):
    """JAX importer -> flax tree -> `state_dict_from_flax` == the port's
    direct import, entry for entry and bit for bit; the JAX route's tree
    is the whole model's, so the direct import fills every entry."""
    got = family["direct"](family["models"], _tensors(family["sd"]))
    for model, want_vars, sd in zip(family["models"], family["want"], got):
        want = state_dict_from_flax(model, want_vars)
        assert sorted(sd) == sorted(want) == sorted(model.state_dict())
        for k in want:
            assert sd[k].dtype == want[k].dtype, k
            assert torch.equal(sd[k], want[k]), k
        model.load_state_dict(sd)


def test_stray_and_missing_keys_raise(family):
    tsd = _tensors(family["sd"])
    stray = dict(tsd, **{"head.extra_branch.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="head.extra_branch.weight"):
        family["direct"](family["models"], stray)
    # BatchNorm's step counters are the one kind of key the port leaves
    counted = dict(tsd, **{"neck.x.num_batches_tracked": torch.tensor(7)})
    family["direct"](family["models"], counted)
    gone = sorted(tsd)[len(tsd) // 2]
    missing = {k: v for k, v in tsd.items() if k != gone}
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        family["direct"](family["models"], missing)
    bad = next(k for k in sorted(tsd) if k.endswith("running_var"))
    wrong = dict(tsd, **{bad: torch.ones(tsd[bad].numel() + 1)})
    with pytest.raises(ValueError, match="running_var"):
        family["direct"](family["models"], wrong)


@pytest.mark.parametrize("wrapper", ["model_state", "state_dict", "model",
                                     None])
def test_load_torch_checkpoint(tmp_path, wrapper):
    """pcdet's, det3d's and mmdet3d's wrappers and a bare state dict, each
    with DDP's 'module.' prefix on some keys; non-tensor entries drop."""
    sd = {"module.a.weight": torch.arange(6.0).view(2, 3),
          "b.running_var": torch.ones(4), "module.c.num_batches_tracked":
          torch.tensor(3), "d.meta": "not a tensor"}
    path = tmp_path / "ckpt.pth"
    ckpt = sd if wrapper is None else {wrapper: sd, "epoch": 12,
                                       "optimizer_state": {"lr": 1e-3}}
    torch.save(ckpt, path)
    got = tti.load_torch_checkpoint(str(path))
    assert sorted(got) == ["a.weight", "b.running_var",
                           "c.num_batches_tracked"]
    for k in got:
        src = sd.get(f"module.{k}", sd.get(k))
        assert isinstance(got[k], torch.Tensor) and torch.equal(got[k], src)


def test_layout_transposes():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(tti.conv2d(torch.from_numpy(w)).numpy(),
                                  jti.conv2d(w))
    lw = rng.randn(8, 4).astype(np.float32)
    np.testing.assert_array_equal(tti.linear(torch.from_numpy(lw)).numpy(),
                                  jti.linear(lw))
    cw = rng.randn(8, 4, 1).astype(np.float32)
    np.testing.assert_array_equal(tti.conv1d(torch.from_numpy(cw)).numpy(),
                                  jiv._conv1d(cw))
    bn = {f"b.{k}": rng.rand(3).astype(np.float32) for k in
          ("weight", "bias", "running_mean", "running_var")}
    want = {"params": {}, "stats": {}}
    jti.import_batchnorm(want, bn, "b")
    got = dict(zip(("params", "stats"), tti.batchnorm(
        {k: torch.from_numpy(v) for k, v in bn.items()}, "b")))
    for c in ("params", "stats"):
        assert sorted(got[c]) == sorted(want[c])
        for k in want[c]:
            np.testing.assert_array_equal(got[c][k].numpy(), want[c][k])
    tw = rng.randn(4, 8, 2, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tti.conv_transpose2d(torch.from_numpy(tw)).numpy(),
        tw.transpose(2, 3, 0, 1)[::-1, ::-1])
    w1 = rng.randn(3, 3, 3, 4, 8).astype(np.float32)
    w2 = np.ascontiguousarray(w1.transpose(4, 0, 1, 2, 3))
    for layout, wl in (("v1", w1), ("v2", w2)):
        got = tti.spconv_taps(torch.from_numpy(wl), layout).numpy()
        np.testing.assert_array_equal(got, jti.spconv_taps(wl, layout))
        np.testing.assert_array_equal(
            spconv_taps_auto(torch.from_numpy(wl)).numpy(),
            jiv.spconv_taps_auto(wl))
    w3 = rng.randn(3, 1, 1, 16, 32).astype(np.float32)
    np.testing.assert_array_equal(
        spconv_taps_auto(torch.from_numpy(w3)).numpy(),
        jiv.spconv_taps_auto(w3))
    with pytest.raises(ValueError):
        spconv_taps_auto(torch.zeros(5, 5, 5, 4, 8))
    with pytest.raises(ValueError):
        tti.spconv_taps(torch.zeros(27, 4, 8), "v1")


def test_mha_split_equals_jax():
    from df3d_torch.train.import_transfusion import _mha

    mha = torch.nn.MultiheadAttention(16, 4)
    sd = {f"a.{k}": v.detach() for k, v in mha.state_dict().items()}
    want = jit_._mha({k: v.numpy() for k, v in sd.items()}, "a", 4)
    got = _mha(sd, "a", 4)
    for name in ("query", "key", "value", "out"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf].numpy(),
                                          want[name][leaf])


class _Payload:
    """An object a checkpoint must not be able to pickle in."""


def test_load_torch_checkpoint_refuses_pickled_objects(tmp_path):
    """The loader unpickles with torch's `weights_only` loader: a file that
    pickles an object other than containers, numbers, strings and tensors
    is refused, not run."""
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {"a.weight": torch.ones(2)},
                "meta": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError, match="_Payload"):
        tti.load_torch_checkpoint(str(path))


def _other_spconv_layout(w):
    """A 5D spconv weight in the other layout: v1 (kz, ky, kx, in, out) <->
    v2 (out, kz, ky, kx, in)."""
    if w.ndim != 5:
        return w
    if all(d in (1, 3) for d in w.shape[:3]):
        return w.permute(4, 0, 1, 2, 3).contiguous()
    return w.permute(1, 2, 3, 4, 0).contiguous()


def test_spconv_layout_read_from_shape(family):
    """Every importer reads the spconv layout from each weight's shape: the
    same state dict with its sparse-conv weights in the other layout
    (det3d's v1 as v2; pcdet's and mmdet3d's as v1) imports to the same
    entries, bit for bit."""
    tsd = _tensors(family["sd"])
    flipped = {k: _other_spconv_layout(v) for k, v in tsd.items()}
    sparse = [k for k, v in tsd.items() if v.ndim == 5]
    assert sparse and all(flipped[k].shape != tsd[k].shape for k in sparse)
    want = family["direct"](family["models"], tsd)
    got = family["direct"](family["models"], flipped)
    for w_sd, g_sd in zip(want, got):
        assert sorted(g_sd) == sorted(w_sd)
        for k in w_sd:
            assert torch.equal(g_sd[k], w_sd[k]), k


def test_entry_builds_from_a_checkpoint(tmp_path, family):
    """`entry.build_*(..., checkpoint=path)` loads a reference .pth (det3d's
    state_dict wrapper, pcdet's model_state, mmdet3d's state_dict with
    'module.') through `load_torch_checkpoint` and the importer, and gives
    the direct import's weights, in eval mode."""
    name, tsd = family["name"], _tensors(family["sd"])
    want = family["direct"](family["models"], tsd)
    path = tmp_path / "ref.pth"
    if name == "voxelrcnn":
        torch.save({"model_state": tsd, "epoch": 80}, path)
        cfg = port_config(VR_TINY, VoxelRCNNConfig())
        built = entry.build_voxelrcnn(cfg, "cpu", checkpoint=str(path))
    elif name == "centerpoint":
        torch.save({"state_dict": tsd, "meta": {"epoch": 20}}, path)
        built = (entry.build_centerpoint(
            port_config(CP_TINY, CenterPointConfig()), "cpu",
            checkpoint=str(path)),)
    else:
        torch.save({"state_dict": {f"module.{k}": v for k, v in tsd.items()}},
                   path)
        built = (entry.build_transfusion(
            port_config(TF_TINY, TransFusionConfig()), "cpu",
            checkpoint=str(path)),)
    for module, sd in zip(built, want):
        assert not module.training
        got = module.state_dict()
        for k, v in sd.items():
            assert torch.equal(got[k], v), k


def test_port_config_carries_every_field():
    cfg = port_config(VR_TINY, VoxelRCNNConfig())
    assert cfg.rcnn.scales[2].nsample == VR_TINY.rcnn.scales[2].nsample
    assert dataclasses.asdict(cfg)["grid_size"] == VR_TINY.grid_size
