"""The Swin-T image branch and the `transfusion_3ddf_swin_nusc` preset:
df3d_torch's `SwinTransformer` and the "swin" `ImageBranch` (Swin-T + FPN)
against one jitted JAX `ImageBranch` at (48, 64) images, two cameras,
`swin_depths` (2, 2, 2, 2), `swin_dim` 24 (head width 8 at every stage),
two levels, flax variables filled from seeded numpy and carried across by
df3d_torch.weights. That size reaches every case of the JAX blocks: a
window padded to 7 (12x16 -> 14x21), a 6x6 shifted window on 6x8, a
dropped shift (3x4, window 3) and an odd patch merge (3x4 -> 2x2).
Tolerance per output 1e-5 * max|ref| + 1e-6.

Port only: the preset serves and takes a training step on the CPU
(`entry.build_transfusion3ddf`, `build_transfusion3ddf_trainer`) at a tiny
LiDAR config, through K2's plain version. The Swin importer: a seeded
mmdet-named state dict (`chip_smoke.mmdet_transfusion_swin_state_dict`)
gives, through `swin_name_map` and `fpn_name_map`, what `weights.py` makes
of the JAX package's name maps (numpy, no compile), strict both ways;
`resnet_name_map` against the JAX function on a seeded torchvision-named
dict."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parallel_ranks as R
from df3d.config import get_preset
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.fused import ImageBranch as JImageBranch
from df3d.models.image.swin import SwinTransformer as JSwin
from df3d.train import import_transfusion as jimport
from df3d.train import torch_import as jtorch_import
from df3d_torch import config as tconfig
from df3d_torch import entry
from df3d_torch.models.detectors.fused import (
    FusedConfig, ImageBranch, TransFusion3DDF,
)
from df3d_torch.ops import msda_kernel
from df3d_torch.train import import_transfusion, torch_import
from df3d_torch.weights import state_dict_from_flax
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

IMAGE = (48, 64)
SWIN = dict(image_shape=IMAGE, image_branch="swin", swin_depths=(2, 2, 2, 2),
            swin_dim=24, n_levels=2, num_cams=2)


def _tol(ref):
    return 1e-5 * np.abs(ref).max() + 1e-6


@pytest.fixture(scope="module")
def branch_run():
    jbranch = JImageBranch(JFusedConfig(**SWIN))
    images = np.random.RandomState(0).randn(2, *IMAGE, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jbranch.init(
        jax.random.PRNGKey(0), x, False), images)
    variables = seeded_variables(shapes, np.random.RandomState(1))

    @jax.jit
    def run(v, x):  # the Swin stages as the branch's forward makes them
        feats, inter = jbranch.apply(
            v, x, False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JSwin))
        return feats, inter["intermediates"]["swin"]["__call__"][0]

    feats, stages = jax.tree_util.tree_map(np.asarray, run(variables, images))
    branch = ImageBranch(FusedConfig(**SWIN))
    branch.load_state_dict(state_dict_from_flax(branch, variables))
    with torch.no_grad():
        x = torch.from_numpy(images)
        got_feats, got_stages = branch(x), branch.swin(x)
    return dict(branch=branch, feats=(feats, got_feats),
                stages=(stages, got_stages))


def test_swin_reaches_every_block_case(branch_run):
    """Stage 0 pads 12x16 to 7-windows, stage 1 shifts 6x6 windows by 3,
    stage 2 (3x4) drops the shift, and its odd map merges to 2x2."""
    swin = branch_run["branch"].swin
    blocks = [(getattr(swin, f"stage{si}_block1").hw,
               getattr(swin, f"stage{si}_block1").win,
               getattr(swin, f"stage{si}_block1").shift) for si in range(4)]
    assert blocks == [((12, 16), 7, 3), ((6, 8), 6, 3), ((3, 4), 3, 0),
                      ((2, 2), 2, 0)]
    assert swin.stage_channels == (24, 48, 96, 192)


@pytest.mark.parametrize("stage", range(4))
def test_swin_stages(branch_run, stage):
    want, got = branch_run["stages"]
    ref = want[stage]
    assert tuple(got[stage].shape) == ref.shape
    np.testing.assert_allclose(got[stage].numpy(), ref, rtol=0,
                               atol=_tol(ref))


@pytest.mark.parametrize("level", range(2))
def test_swin_image_branch(branch_run, level):
    """Swin-T + FPN, the first n_levels outputs (P2 and P3), 256 wide."""
    want, got = branch_run["feats"]
    assert len(got) == len(want) == 2
    ref = want[level]
    assert tuple(got[level].shape) == ref.shape and ref.shape[-1] == 256
    np.testing.assert_allclose(got[level].numpy(), ref, rtol=0,
                               atol=_tol(ref))


def test_swin_preset():
    """The port's preset is the JAX package's, and `fused_config` gives its
    Swin-T branch at JAX's defaults."""
    want = get_preset("transfusion_3ddf_swin_nusc")
    preset = tconfig.get_preset("transfusion_3ddf_swin_nusc")
    assert set(preset) == set(want)
    for k in ("image_branch", "image_shape", "num_cams", "max_ne_voxel"):
        assert preset[k] == want[k], k
    for k in ("lidar", "actr"):
        got = dataclasses.asdict(preset[k])
        assert got == {f: v for f, v in dataclasses.asdict(want[k]).items()
                       if f in got}, k
    fcfg = tconfig.fused_config(preset)
    assert (fcfg.image_branch, fcfg.swin_depths, fcfg.swin_dim,
            fcfg.n_levels, fcfg.num_cams) == (
                "swin", JFusedConfig.swin_depths, JFusedConfig.swin_dim, 1, 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.build_transfusion3ddf(preset["lidar"], fcfg)


def _tiny_swin():
    cfg, fcfg = R._transfusion_configs()
    return cfg, dataclasses.replace(
        fcfg, image_branch="swin", image_shape=IMAGE,
        swin_depths=(1, 1, 1, 1), swin_dim=24)


def test_swin_preset_serves_and_trains(monkeypatch):
    """The Swin TransFusion + 3D-DF serves (finite detections of every
    query) and takes a training step (finite loss, the frozen Swin branch
    unchanged, the rest moved), both through K2's plain version."""
    cfg, fcfg = _tiny_swin()
    calls = []
    plain = msda_kernel.msda_plain
    monkeypatch.setattr(msda_kernel, "msda_plain",
                        lambda *a: calls.append(1) or plain(*a))
    batch = R.tensors(R._nusc_batch(4, fcfg))
    model = entry.build_transfusion3ddf(cfg, fcfg, "cpu")
    det, _ = entry.infer_transfusion_fused(
        model, cfg, batch["points"], batch["points_valid"], batch["images"],
        batch["proj"])
    assert det["boxes"].shape[:2] == (2, cfg.head.num_proposals)
    assert all(torch.isfinite(v).all() for v in det.values()
               if v.is_floating_point())
    assert len(calls) == fcfg.actr.num_layers

    state, step = entry.build_transfusion3ddf_trainer(cfg, fcfg, "cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, logs = step(state, batch)
    assert torch.isfinite(logs["loss"]) and state.step == 1
    after = state.model.state_dict()
    branch = [k for k in after if k.startswith("image_branch.swin")]
    assert branch and all(torch.equal(after[k], before[k]) for k in branch)
    assert not torch.equal(after["detector.bbox_head.shared_conv.weight"],
                           before["detector.bbox_head.shared_conv.weight"])
    assert len(calls) == 2 * fcfg.actr.num_layers


@pytest.fixture(scope="module")
def swin_checkpoint():
    """A seeded TransFusion + Swin model, its mmdet-named state dict, and a
    second model of other weights to import into."""
    cfg, fcfg = _tiny_swin()
    source = TransFusion3DDF(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(3))
    sd = chip_smoke.mmdet_transfusion_swin_state_dict(source)
    target = TransFusion3DDF(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(4))
    return source, sd, target


def test_swin_import_equals_the_jax_name_maps(swin_checkpoint):
    """The port's `swin_name_map` and `fpn_name_map` give, carried into
    the image branch, what `weights.py` makes of the JAX package's maps of
    the same dict (numpy), bit for bit: the merge norms' and reductions'
    (C, 4) -> (4, C) permutations among them."""
    source, sd, target = swin_checkpoint
    branch = target.image_branch
    depths = branch.swin.depths
    np_sd = {k: v.numpy() for k, v in sd.items()}
    want = state_dict_from_flax(branch, {"params": {
        "swin": jimport.swin_name_map(np_sd, depths=depths),
        "swin_fpn": jimport.fpn_name_map(np_sd)}})
    windows = [getattr(branch.swin, f"stage{si}_block0").win
               for si in range(4)]
    got = state_dict_from_flax(branch, {"params": {
        "swin": import_transfusion.swin_name_map(sd, depths=depths,
                                                 windows=windows),
        "swin_fpn": import_transfusion.fpn_name_map(sd)}})
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for si in range(3):  # the permutation undoes the writer's
        assert torch.equal(got[f"swin.merge{si}.weight"],
                           source.image_branch.state_dict()[
                               f"swin.merge{si}.weight"])


def test_swin_merge_layout():
    """A reduction permuted by `_swin_merge_perm` reads the port's
    position-major merge as the unpermuted one reads mmdet's channel-major
    `nn.Unfold` layout."""
    c = 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 6, c, generator=g)
    b, h, w, _ = x.shape
    port = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    patches = [x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2],
               x[:, 1::2, 1::2]]  # pos = ih * 2 + iw
    unfold = torch.stack(patches, -1).reshape(b, h // 2, w // 2, 4 * c)
    kernel = torch.randn(4 * c, 3, generator=g)
    perm = import_transfusion._swin_merge_perm(kernel, c)
    torch.testing.assert_close(port @ perm, unfold @ kernel)


def test_swin_checkpoint_import(swin_checkpoint, tmp_path):
    """`entry.build_transfusion3ddf(..., checkpoint=)` of the mmdet dict
    gives the source's image branch and LiDAR detector exactly and keeps
    its own seeded fusion hook; a stray or a missing key raises."""
    source, sd, target = swin_checkpoint
    path = tmp_path / "swin.pth"
    torch.save({"state_dict": sd}, path)
    cfg, fcfg = _tiny_swin()
    built = entry.build_transfusion3ddf(cfg, fcfg, "cpu", seed=4,
                                        checkpoint=str(path))
    got, src = built.state_dict(), source.state_dict()
    own = target.state_dict()
    hook = [k for k in got if ".fusion_hook." in k]
    assert hook
    for k in got:
        if k.endswith("num_batches_tracked"):
            continue
        want = own[k] if k in hook else src[k]
        assert torch.equal(got[k], want), k
    with pytest.raises(KeyError, match="img_backbone.stray"):
        import_transfusion.import_transfusion_3ddf_swin(
            target, {**sd, "img_backbone.stray": torch.zeros(1)})
    missing = dict(sd)
    del missing["img_neck.fpn_convs.1.conv.bias"]
    with pytest.raises(KeyError, match="img_neck.fpn_convs.1.conv.bias"):
        import_transfusion.import_transfusion_3ddf_swin(target, missing)


def test_resnet_name_map_equals_jax():
    """The port's `resnet_name_map` against the JAX package's on a seeded
    torchvision-named ResNet (one block a stage, full widths)."""
    rng = np.random.RandomState(7)
    sd = {"backbone.conv1.weight": rng.randn(64, 3, 7, 7)}

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{s}"] = rng.randn(c)

    bn("backbone.bn1", 64)
    cin = 64
    for li, planes in enumerate((64, 128, 256, 512)):
        t = f"backbone.layer{li + 1}.0"
        for ci, (o, i, k) in enumerate(((planes, cin, 1), (planes, planes, 3),
                                        (planes * 4, planes, 1)), 1):
            sd[f"{t}.conv{ci}.weight"] = rng.randn(o, i, k, k)
            bn(f"{t}.bn{ci}", o)
        sd[f"{t}.downsample.0.weight"] = rng.randn(planes * 4, cin, 1, 1)
        bn(f"{t}.downsample.1", planes * 4)
        cin = planes * 4
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jtorch_import.resnet_name_map(None, sd, layers=(1, 1, 1, 1))
    got = torch_import.resnet_name_map(
        {k: torch.from_numpy(v) for k, v in sd.items()}, layers=(1, 1, 1, 1))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
