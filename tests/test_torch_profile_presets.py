"""The "tpu_v5e" serving profile on every target preset, df3d_torch
against df3d in its profile (the JAX package's globals set inside the
`jax_bf16` fixture, or a `try` in a fixture, that restores "exact", as
tests/test_torch_serving_profile.py does).

Dtypes, every preset, at small widths: the dtype at each stage boundary
equals JAX's, JAX's taken from one `jax.eval_shape` of `init_with_output`
(capture_intermediates, under the profile; no compile), or for the three
presets compared by value from their jitted runs, the port's from forward
hooks on the same modules. The boundaries: each backbone stage (conv1..conv4)
and the backbone's BEV map, the fusion hook's input and output at each
stage it runs at, K2's value table (the image branch's features, which
stay f32), the detector's maps, and Voxel R-CNN's RoI head: each scale's
input projection and pooled features, and its cls and reg.

Values, in two jitted JAX programs compiled in the fixtures: TransFusion-L
with TransFusion + 3D-DF (`transfusion_3ddf_nusc`, narrowed) in one, and
Voxel R-CNN (`voxel_rcnn_car_kitti`, narrowed) through the package's
`make_voxelrcnn_eval_step` in the other. `transfusion_3ddf_nusc` is the
fused preset compared by value: it shares `_fuse_dense_tail`, the hook
(`MultiCamACTRFusionHook`), IFAT, LT and ACTR with
`centerpoint_3ddf_nusc` and `transfusion_3ddf_swin_nusc`, and KITTI's
fused preset runs the same hook on `VoxelBackBone8x`'s sparse rows; the
dtype test holds those three at every boundary. Voxel coords, every conv
plan and every cap overflow match exactly.

Tolerances (`TOL`). The port's bf16 conv body and XLA's sum the same exact
bf16 products in f32 in other orders, so an output lands one bf16 ulp
apart where the f32 sum sits at a rounding boundary; every later bf16
layer re-rounds such differences, so their share grows with depth.
Measured on this file's inputs (CPU): Voxel R-CNN's bf16 stages equal bit
for bit and its maps, RoI head and detections within 3.5e-6 of their
largest value, held to 1e-3 of the elements and 1e-4 (its "exact" run
misses JAX's maps by more than 5x that, asserted); TransFusion-L's conv2
0.2% of the elements apart, conv3 2%, conv4 8%, the BEV map 20%, each
within 1.5 bf16 ulps of the stage's largest value, held to 25% and 2
ulps, its maps and detections within 3.7e-3 of their largest value, held
to 1e-2; with 3D-DF the hook's input carries those differences through
IFAT, LT and ACTR, so its BEV map lands 1.3e-2 and its heatmap 2.0e-2
apart, held to 5e-2, while the hook alone on JAX's own bf16 input agrees
to 1.8e-6 (held to 1e-5), so the gap is the upstream bf16 stages', not
the hook's. Detections: JAX's decisions replayed where the port's differ
(TransFusion's query top-k, Voxel R-CNN's proposal and final NMS and the
RoI head's neighbour searches), at most `MAX_REPLAYS` entries within
`REPLAY_GAP` of the choice they replace (none on these inputs), counted
and printed; labels and Voxel R-CNN's kept sets equal."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import df3d.models.backbones_3d as jbackbones
import df3d.models.detectors.fused as jfused
import test_torch_fused_slice as FS
import test_torch_slice as S
import test_torch_transfusion_slice as TS
import test_torch_voxelrcnn_slice as VS
from df3d import serving as jserving
from df3d.models.detectors.centerpoint import CenterPoint as JCenterPoint
from df3d.models.detectors.centerpoint import CenterPointConfig as JCPConfig
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.transfusion import TransFusionConfig as JTFConfig
from df3d.models.detectors.transfusion import TransFusionL as JTransFusionL
from df3d.models.detectors.transfusion import (
    transfusion_predict as jtransfusion_predict,
)
from df3d.models.detectors.voxel_rcnn import VoxelRCNN as JVoxelRCNN
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.models.heads.transfusion_head import TransFusionHeadCfg as JHeadCfg
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.trainer import make_voxelrcnn_eval_step
import df3d_torch.models.backbones_3d as tbackbones
from df3d_torch import serving
from df3d_torch.entry import (
    infer_transfusion, infer_transfusion_fused, infer_voxelrcnn,
)
from df3d_torch.models.detectors import fused as tfused
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNN, init_head_weights, proposal_layer, voxel_rcnn_post_processing,
)
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.fusion.msda_module import MSDeformAttnModule
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.utils.synth import camera_rig
from df3d_torch.weights import load_voxelrcnn
from test_torch_serving_profile import _ulps
from torch_port_helpers import load_flax, recorded_plans, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

# per run: the share of a bf16 stage's elements that may differ, their
# largest gap in bf16 ulps of the stage's largest value, and the gap of f32
# values downstream of bf16 stages over their largest value
TOL = {"lidar": dict(differ=0.25, ulps=2.0, f32=1e-2),
       "fused": dict(differ=0.25, ulps=2.0, f32=5e-2),
       "kitti": dict(differ=1e-3, ulps=1.0, f32=1e-4)}
MAX_REPLAYS, REPLAY_GAP = 4, 1e-4
STAGES = ("conv1", "conv2", "conv3", "conv4")
KEY = jax.random.PRNGKey(0)


@pytest.fixture
def jax_bf16():
    """The JAX package in its "tpu_v5e" profile for one test, "exact"
    again (its defaults) after it, whatever the test did."""
    jserving.apply_profile("tpu_v5e")
    try:
        yield
    finally:
        jserving.apply_profile("exact")


def _dt(x) -> str:
    return str(x.dtype).removeprefix("torch.")


# ---- the presets at small widths -----------------------------------------


def _tf_cfgs(pkg):
    cfg_cls, head_cls = ((JTFConfig, JHeadCfg) if pkg == "jax"
                         else (TransFusionConfig, TransFusionHeadCfg))
    return cfg_cls(head=head_cls(**TS.HEAD), **TS.CFG)


def _fcfg(pkg, actr, **fused):
    if pkg == "jax":
        return JFusedConfig(actr=JACTRConfig(**actr), **fused)
    return tfused.FusedConfig(actr=ACTRConfig(**actr), **fused)


def _points(rng, b, n, f, lo=-15.0, hi=15.0):
    return np.concatenate([rng.uniform(lo, hi, (b, n, 2)),
                           rng.uniform(-1.8, 1.8, (b, n, 1)),
                           rng.uniform(0, 1, (b, n, f - 3))],
                          -1).astype(np.float32)


def _case(name):
    """(JAX model, port model, JAX config, port config, inputs (numpy: the
    points, valid and, fused, images and proj), family) of a target preset
    at small widths: the configs of the slice tests."""
    rng = np.random.RandomState(0)
    if name.startswith("centerpoint"):
        fused = name == "centerpoint_3ddf_nusc"
        cfgs = FS.CFG if fused else S.CFG
        jcfg, tcfg = JCPConfig(**cfgs), CenterPointConfig(**cfgs)
        ins = [_points(rng, 1, 512, 5), np.ones((1, 512), bool)]
        if not fused:
            return (JCenterPoint(jcfg), CenterPoint(tcfg), jcfg, tcfg, ins,
                    "centerpoint")
        ins += [rng.randn(1, 2, 32, 48, 3).astype(np.float32),
                np.broadcast_to(camera_rig(2, (32, 48)), (1, 2, 3, 4)).copy()]
        return (jfused.CenterPoint3DDF(jcfg, _fcfg("jax", FS.ACTR,
                                                   **FS.FUSED)),
                tfused.CenterPoint3DDF(tcfg, _fcfg("torch", FS.ACTR,
                                                   **FS.FUSED)),
                jcfg, tcfg, ins, "centerpoint")
    if name.startswith("transfusion"):
        jcfg, tcfg = _tf_cfgs("jax"), _tf_cfgs("torch")
        ins = [_points(rng, 1, 500, 4), rng.rand(1, 500) > 0.05]
        if name == "transfusion_l_nusc":
            return (JTransFusionL(jcfg), TransFusionL(tcfg), jcfg, tcfg, ins,
                    "transfusion")
        fused = dict(TS.FUSED)
        if name == "transfusion_3ddf_swin_nusc":
            fused.update(image_branch="swin", image_shape=(48, 64),
                         swin_depths=(1, 1, 1, 1), swin_dim=24)
        h, w = fused["image_shape"]
        ins += [rng.randn(1, 2, h, w, 3).astype(np.float32),
                np.broadcast_to(camera_rig(2, (h, w)), (1, 2, 3, 4)).copy()]
        return (jfused.TransFusion3DDF(jcfg, _fcfg("jax", TS.ACTR, **fused)),
                tfused.TransFusion3DDF(tcfg, _fcfg("torch", TS.ACTR,
                                                   **fused)),
                jcfg, tcfg, ins, "transfusion")
    batch = VS._inputs()
    ins = [batch["points"], batch["points_valid"]]
    if name == "voxel_rcnn_car_kitti":
        return (JVoxelRCNN(VS.JCFG), VoxelRCNN(VS.TCFG), VS.JCFG, VS.TCFG,
                ins, "voxelrcnn")
    ins += [batch["images"], batch["proj"]]
    return (jfused.VoxelRCNN3DDF(VS.JCFG, JFusedConfig(
                actr=JACTRConfig(**VS.ACTR), mvx_early=True, **VS.FUSED)),
            tfused.VoxelRCNN3DDF(VS.TCFG, _fcfg("torch", VS.ACTR,
                                                **VS.FUSED)),
            VS.JCFG, VS.TCFG, ins, "voxelrcnn")


def _voxelize(cfg, points, valid, pkg):
    fn = jvoxelize_batch if pkg == "jax" else voxelize_batch
    return fn(points, valid, cfg.voxel_size, cfg.pc_range, cfg.grid_size,
              cfg.max_voxels, cfg.max_points_per_voxel)


def _backbone_key(tree):
    """The backbone's name in a (fused) detector's tree."""
    tree = tree.get("detector", tree)
    return tree, ("middle_encoder" if "middle_encoder" in tree
                  else "backbone")


# ---- dtypes at the boundaries --------------------------------------------


_FACTORIES = ("make_actr_fusion_hook", "make_multicam_actr_fusion_hook")


class _HookRecorder:
    """While the block runs, the JAX package's fusion hooks record, each
    time a model is traced, (stage, input dtype, output dtype) per call in
    `calls`, and the last call's input rows, coords and output features in
    `arrays` (tracers inside a jitted function, which may return them)."""

    def __init__(self):
        self.calls, self.arrays = [], {}
        self.factories = {n: getattr(jfused, n) for n in _FACTORIES}

    def __enter__(self):
        for name, factory in self.factories.items():
            setattr(jfused, name, self._wrap(factory))
        return self

    def __exit__(self, *exc):
        for name, factory in self.factories.items():
            setattr(jfused, name, factory)

    def _wrap(self, factory):
        def make(*args, **kwargs):
            hook = factory(*args, **kwargs)

            def recorded(parent, stage_tensors, train, stage=None, **kw):
                st = stage_tensors[-1]
                out = hook(parent, stage_tensors, train, stage=stage, **kw)
                if kw.get("image_feats") is not None:
                    self.calls.append((stage or "conv4",
                                       str(st.features.dtype),
                                       str(out.features.dtype)))
                    self.arrays.update(features=st.features,
                                       coords=st.coords, out=out.features)
                return out
            return recorded
        return make


def _named_dtypes(tree, name):
    """The output dtypes of every module called `name` in a captured
    intermediates tree."""
    for k, v in tree.items():
        if k == name:
            yield str(v["__call__"][0].dtype)
        elif isinstance(v, dict):
            yield from _named_dtypes(v, name)


def _jax_dtypes(inter, preds, hook_calls, head_inter=None, head_out=None):
    """{boundary: dtype} of the JAX package's run."""
    det, bb = _backbone_key(inter)
    bev, ms = det[bb]["__call__"][0][:2]
    out = {"bev": str(bev.dtype)}
    out.update({k: str(ms[k].features.dtype) for k in STAGES})
    for stage, din, dout in hook_calls:
        out[f"hook_{stage}_in"], out[f"hook_{stage}_out"] = din, dout
    values = set(_named_dtypes(det[bb], "value_proj"))
    if values:
        out["k2_value"] = values
    out["maps"] = {str(x.dtype) for x in jax.tree_util.tree_leaves(preds)
                   if jnp.issubdtype(x.dtype, jnp.floating)}
    if head_inter is not None:
        for k in ("conv2", "conv3", "conv4"):
            out[f"roi_{k}_in"] = str(
                head_inter[f"{k}_mlp_in"]["__call__"][0].dtype)
            out[f"roi_{k}_pooled"] = str(
                head_inter[f"{k}_bn_out"]["__call__"][0].dtype)
        out["roi_cls"], out["roi_reg"] = (str(x.dtype) for x in head_out)
    return out


# the modules whose outputs the JAX runs capture
_CAPTURED = {"middle_encoder", "backbone", "value_proj"} | {
    f"{k}_{m}" for k in STAGES[1:] for m in ("mlp_in", "bn_out")}


def _captured(mdl, method):
    return method == "__call__" and mdl.name in _CAPTURED


def _maps(preds):
    """The float head maps of a detector's predictions (Voxel R-CNN's
    stage features left out)."""
    if isinstance(preds, dict):
        preds = {k: v for k, v in preds.items() if k != "ms"}
    return preds


class _PortRecorder:
    """Forward hooks on the port's modules: {boundary: dtype} of one run,
    the same boundaries as `_jax_dtypes`."""

    def __init__(self, model, head=None):
        self.out, self.handles = {}, []
        det = getattr(model, "detector", model)
        bb = getattr(det, "middle_encoder", None) or det.backbone
        self._on(bb, self._backbone)
        if bb.fusion_hook is not None:
            self._on(bb.fusion_hook, self._hook)
            for m in bb.fusion_hook.modules():
                if isinstance(m, MSDeformAttnModule):
                    self._on(m.value_proj, lambda mod, a, kw, o: self.out
                             .setdefault("k2_value", set()).add(_dt(o)))
        self._on(model, lambda mod, a, kw, o: self.out.update(maps={
            _dt(x) for x in jax.tree_util.tree_leaves(_maps(o[0]))
            if x.is_floating_point()}))
        if head is not None:
            for k in ("conv2", "conv3", "conv4"):
                self._on(getattr(head, f"{k}_mlp_in"),
                         self._setter(f"roi_{k}_in"))
                self._on(getattr(head, f"{k}_bn_out"),
                         self._setter(f"roi_{k}_pooled"))
            self._on(head, lambda mod, a, kw, o: self.out.update(
                roi_cls=_dt(o[0]), roi_reg=_dt(o[1])))

    def _on(self, module, fn):
        self.handles.append(module.register_forward_hook(fn,
                                                         with_kwargs=True))

    def _setter(self, key):
        return lambda mod, a, kw, o: self.out.update({key: _dt(o)})

    def _backbone(self, mod, args, kwargs, output):
        bev, ms, _ = output
        self.out["bev"] = _dt(bev)
        self.out.update({k: _dt(ms[k].features) for k in STAGES})

    def _hook(self, mod, args, kwargs, output):
        stage = kwargs.get("stage") or "conv4"
        self.out[f"hook_{stage}_in"] = _dt(args[0].features)
        self.out[f"hook_{stage}_out"] = _dt(output.features)

    def remove(self):
        for h in self.handles:
            h.remove()


DTYPE_PRESETS = ["centerpoint_nusc", "centerpoint_3ddf_nusc",
                 "transfusion_l_nusc", "transfusion_3ddf_nusc",
                 "transfusion_3ddf_swin_nusc", "voxel_rcnn_car_kitti",
                 "voxel_rcnn_3ddf_kitti"]

# what the JAX package gives (asserted beside the port's, so that a change
# of either shows): the dense-tail hosts' hook takes bf16 rows and gives
# f32 (bf16 + the f32 fusion sum), KITTI's takes f32 rows at conv1 (16
# channels, under the gate) and bf16 at conv4, and its conv_out takes the
# hook's f32 rows back to bf16
WANT_BEV = {"centerpoint_nusc": "bfloat16", "transfusion_l_nusc": "bfloat16",
            "voxel_rcnn_car_kitti": "bfloat16",
            "voxel_rcnn_3ddf_kitti": "bfloat16"}


# presets whose dtypes the value fixtures record (one JAX program each)
VALUED = {"transfusion_l_nusc": ("tf_run", "lidar"),
          "transfusion_3ddf_nusc": ("tf_run", "fused"),
          "voxel_rcnn_car_kitti": ("vr_run", None)}


def _traced_dtypes(name):
    """(JAX's, the port's) {boundary: dtype} of a preset at small widths:
    JAX's from one abstract trace of `init_with_output` (no compile) in
    the JAX package's profile (the caller sets it), the port's from one
    forward of the model with seeded weights."""
    jmodel, tmodel, jcfg, tcfg, ins, family = _case(name)
    jin = [jnp.asarray(a) for a in ins]

    def fwd_inputs():
        r = _voxelize(jcfg, *jin[:2], "jax")
        return (r.features, r.coords, *jin[2:])

    with _HookRecorder() as hooks:
        # one trace: `init` runs the forward it builds the variables with
        out, variables = jax.eval_shape(lambda: jmodel.init_with_output(
            KEY, *fwd_inputs(), train=False, capture_intermediates=_captured))
    preds = out[0] if isinstance(out, tuple) else out
    head_inter = head_out = thead = None
    if family == "voxelrcnn":
        jhead = jrh.VoxelRCNNHead(jcfg.rcnn, jcfg.voxel_size, jcfg.pc_range)
        r = jcfg.test_post_nms
        rois = jnp.zeros((1, r, 7)).at[..., 3:6].set(1.0)
        head_out, hv = jax.eval_shape(lambda m: jhead.init_with_output(
            KEY, rois, jnp.ones((1, r), bool), m, train=False,
            capture_intermediates=_captured), preds["ms"])
        head_inter = hv["intermediates"]
        thead = init_head_weights(
            trh.VoxelRCNNHead(tcfg.rcnn, tcfg.voxel_size, tcfg.pc_range),
            torch.Generator().manual_seed(1)).eval()
    want = _jax_dtypes(variables["intermediates"], _maps(preds),
                       hooks.calls, head_inter, head_out)

    tmodel.init_weights(torch.Generator().manual_seed(0)).eval()
    serving.apply_profile(tmodel, "tpu_v5e")
    rec = _PortRecorder(tmodel, thead)
    tin = [torch.from_numpy(a) for a in ins]
    try:
        with torch.no_grad():
            if family == "voxelrcnn":
                infer_voxelrcnn(tmodel, thead, tcfg, *tin)
            else:
                res = _voxelize(tcfg, *tin[:2], "torch")
                tmodel(res.features, res.coords, *tin[2:])
    finally:
        rec.remove()
    return want, rec.out


@pytest.mark.parametrize("name", DTYPE_PRESETS)
def test_stage_dtypes(name, request):
    if name in VALUED:
        fixture, key = VALUED[name]
        run = request.getfixturevalue(fixture)
        want, got = run["dtypes"][key] if key else run["dtypes"]
    else:
        request.getfixturevalue("jax_bf16")
        want, got = _traced_dtypes(name)
    family = ("voxelrcnn" if name.startswith("voxel")
              else name.split("_")[0])
    print(name, want)
    assert got == want
    # the profile reached the model: a bf16 stage, and f32 maps
    assert "bfloat16" in {want[k] for k in STAGES}
    assert want["maps"] == {"float32"}
    assert want["bev"] == WANT_BEV.get(name, "float32")
    if "k2_value" in want:
        assert want["k2_value"] == {"float32"}
    if family == "voxelrcnn":
        assert {want[f"roi_{k}_pooled"] for k in STAGES[1:]} == {"float32"}
        fused = name.endswith("3ddf_kitti")
        assert [k for k in want if k.startswith("hook")] == (
            ["hook_conv1_in", "hook_conv1_out", "hook_conv4_in",
             "hook_conv4_out"] if fused else [])
    elif "3ddf" in name:
        assert (want["hook_conv4_in"], want["hook_conv4_out"]) == (
            "bfloat16", "float32")


# ---- values: TransFusion-L and TransFusion + 3D-DF ------------------------

HOOK_LEAVES = ("ifat", "actr", "actr_out_proj")


class _Recorded:
    """A flax module whose `apply`, as the eval step calls it, also keeps
    its outputs and the intermediates the test reads (`_captured` and the
    sows) in `store[key]` (no second trace of the model)."""

    def __init__(self, module, store, key):
        self.module, self.store, self.key = module, store, key

    def apply(self, variables, *args, **kwargs):
        out, inter = self.module.apply(
            variables, *args, **kwargs, capture_intermediates=_captured,
            mutable=["intermediates"])
        self.store[self.key] = (out, inter["intermediates"])
        return out


def _output_of(module, store: dict, key: str):
    return module.register_forward_hook(
        lambda mod, args, out: store.__setitem__(key, out))


def _jax_top_k(preds, bev_size):
    """The JAX head's query indices (label * H * W + y * W + x), from its
    query labels and positions."""
    h, w = bev_size
    xy = np.asarray(preds["query_pos_xy"]).astype(np.int64)
    return torch.from_numpy(np.asarray(preds["query_labels"]) * h * w
                            + xy[..., 1] * w + xy[..., 0])


@pytest.fixture(scope="module")
def tf_run():
    jmodel, tmodel, jcfg, tcfg, ins, _ = _case("transfusion_3ddf_nusc")
    jlidar, tlidar = JTransFusionL(jcfg), TransFusionL(tcfg)
    jin = [jnp.asarray(a) for a in ins]
    shapes = jax.eval_shape(lambda: jmodel.init(
        KEY, *_voxelize(jcfg, *jin[:2], "jax")[:2], *jin[2:], train=False))
    fused_vars = seeded_variables(shapes, np.random.RandomState(1))
    # TransFusion-L's tree is the fused detector's without the hook
    lidar_vars = {}
    for col, tree in fused_vars.items():
        det = tree["detector"]
        lidar_vars[col] = dict(det, middle_encoder={
            k: v for k, v in det["middle_encoder"].items()
            if k not in HOOK_LEAVES})
    plans = {"lidar": [], "fused": []}
    hooks = _HookRecorder()

    def run(fv, lv, p, val, im, pr):
        r = _voxelize(jcfg, p, val, "jax")
        outs = {}
        for key, model, v, cams in (("lidar", jlidar, lv, ()),
                                    ("fused", jmodel, fv, (im, pr))):
            with recorded_plans(jbackbones, plans[key]):
                (preds, _), inter = model.apply(
                    v, r.features, r.coords, *cams, train=False,
                    capture_intermediates=_captured,
                    mutable=["intermediates"])
            outs[key] = dict(preds=preds, inter=inter["intermediates"],
                             det=jtransfusion_predict(jcfg, preds),
                             plans=plans[key])
        outs["hook"] = dict(hooks.arrays)
        return r, outs

    # the profile is read while the program is traced
    jserving.apply_profile("tpu_v5e")
    try:
        with hooks:
            jres, jouts = jax.tree_util.tree_map(
                np.array, jax.jit(run)(fused_vars, lidar_vars, *jin))
    finally:
        jserving.apply_profile("exact")
    dtypes = {"lidar": [_jax_dtypes(jouts["lidar"]["inter"],
                                    jouts["lidar"]["preds"], [])],
              "fused": [_jax_dtypes(jouts["fused"]["inter"],
                                    jouts["fused"]["preds"], hooks.calls)]}

    tin = [torch.from_numpy(a) for a in ins]
    tres = _voxelize(tcfg, *tin[:2], "torch")
    runs = {}
    for key, model, v, cams in (("lidar", tlidar, lidar_vars, ()),
                                ("fused", tmodel, fused_vars, tin[2:])):
        model = load_flax(model, v)
        serving.apply_profile(model, "tpu_v5e")
        det_mod = getattr(model, "detector", model)
        seen = {}
        handles = [_output_of(det_mod.middle_encoder, seen, "bb"),
                   _output_of(model, seen, "model")]
        rec = _PortRecorder(model)
        infer = infer_transfusion_fused if cams else infer_transfusion
        store = [_jax_top_k(jouts[key]["preds"], TS.HEAD["bev_size"])]
        try:
            with recorded_plans(tbackbones, []) as tplans, \
                    chip_smoke.transfusion_decisions(store, True) as rep:
                det, _ = infer(model, tcfg, *tin[:2], *cams)
        finally:
            for h in handles:
                h.remove()
            rec.remove()
        dtypes[key].append(rec.out)
        preds, _, over = seen["model"]
        runs[key] = dict(preds=preds, bb=seen["bb"], over=over, det=det,
                         plans=tplans, replays=rep)
    # the port's hook on the JAX hook's bf16 input rows, with the port's
    # image features (f32, equal to JAX's to f32 rounding)
    images, proj = tin[2:]
    b, nc = images.shape[:2]
    jhook = jouts["hook"]
    with torch.no_grad():
        feats = [f.reshape(b, nc, *f.shape[1:]) for f in model.image_branch(
            images.reshape(b * nc, *images.shape[2:]))]
        st = tsp.SparseTensor(
            torch.from_numpy(np.asarray(jhook["features"], np.float32))
            .bfloat16(), torch.from_numpy(jhook["coords"]),
            tuple(runs["fused"]["bb"][1]["conv4"].features.shape[1:4]))
        runs["hook_out"] = model.detector.middle_encoder.fusion_hook(
            st, image_feats=feats, proj=proj).features
    return dict(jres=jres, jouts=jouts, tres=tres, runs=runs, dtypes=dtypes)


# ---- values: Voxel R-CNN ---------------------------------------------------


@pytest.fixture(scope="module")
def vr_run():
    batch = VS._inputs()
    batch = {k: batch[k] for k in ("points", "points_valid")}
    jmodel = JVoxelRCNN(VS.JCFG)
    jhead = jrh.VoxelRCNNHead(VS.JCFG.rcnn, VS.JCFG.voxel_size,
                              VS.JCFG.pc_range)
    seen = {}
    step = make_voxelrcnn_eval_step(_Recorded(jmodel, seen, "rpn"),
                                    _Recorded(jhead, seen, "rcnn"),
                                    VS.JCFG)
    res0 = jax.eval_shape(lambda b: _voxelize(
        VS.JCFG, b["points"], b["points_valid"], "jax"), batch)
    variables = VS._variables(jmodel, jhead, (res0.features, res0.coords),
                              10)
    plans = []

    @jax.jit  # one program: the eval step and what the test reads inside
    def run(v, b):
        with recorded_plans(jbackbones, plans):
            out = step(SimpleNamespace(**v), b)
        preds, inter = seen["rpn"]
        (cls, reg), head_inter = seen["rcnn"]
        return (_voxelize(VS.JCFG, b["points"], b["points_valid"], "jax"),
                dict(out=out, preds=preds, cls=cls, reg=reg, plans=plans,
                     inter=inter, head_inter=head_inter,
                     overflow={n: v[0] for n, v in inter["backbone"].items()
                               if n.startswith("cap_overflow")}))

    jserving.apply_profile("tpu_v5e")
    try:
        jres, jout = jax.tree_util.tree_map(np.array, run(variables, batch))
    finally:
        jserving.apply_profile("exact")

    cfg = VS.TCFG
    rpn = VoxelRCNN(cfg)
    head = trh.VoxelRCNNHead(cfg.rcnn, cfg.voxel_size, cfg.pc_range)
    load_voxelrcnn(rpn, head, variables["params"], variables["batch_stats"])
    rpn.eval(), head.eval()
    serving.apply_profile(rpn, "tpu_v5e")
    tin = [torch.from_numpy(batch[k]) for k in ("points", "points_valid")]
    tres = _voxelize(cfg, *tin, "torch")
    # JAX's decisions: the port's proposal layer on JAX's maps, its RoI
    # head's neighbour searches on JAX's RoIs (they read the RoIs and the
    # voxel coords, which are JAX's), its post-processing on JAX's head
    # outputs
    out = jout["out"]
    rois = torch.from_numpy(out["rois"])
    roi_mask = torch.from_numpy(out["roi_mask"])
    store = []
    with torch.no_grad(), chip_smoke.voxelrcnn_decisions(store, False):
        proposal_layer(cfg, {k: torch.from_numpy(jout["preds"][k])
                             for k in ("cls", "box", "dir")}, rpn.anchors)
        head(rois, roi_mask, rpn(tres.features, tres.coords)[0]["ms"])
        voxel_rcnn_post_processing(cfg, rois, roi_mask,
                                   torch.from_numpy(jout["cls"]),
                                   torch.from_numpy(jout["reg"]))
    got = {}
    handles = [_output_of(head, got, "head"), _output_of(rpn, got, "rpn")]
    rec = _PortRecorder(rpn, head)
    try:
        with recorded_plans(tbackbones, []) as tplans, \
                chip_smoke.voxelrcnn_decisions(store, True) as replays:
            det, _ = infer_voxelrcnn(rpn, head, cfg, *tin)
    finally:
        for h in handles:
            h.remove()
        rec.remove()
    preds, over = got["rpn"]
    dtypes = (_jax_dtypes(jout["inter"], _maps(jout["preds"]), [],
                          jout["head_inter"], (jout["cls"], jout["reg"])),
              rec.out)
    serving.apply_profile(rpn, "exact")
    with torch.no_grad():
        exact = rpn(tres.features, tres.coords)[0]
    return dict(jres=jres, jout=jout, tres=tres, preds=preds, over=over,
                plans=tplans, det=det, cls=got["head"][0],
                reg=got["head"][1], replays=replays, exact=exact,
                dtypes=dtypes)


# ---- the comparisons -------------------------------------------------------


def _rel_gap(t: torch.Tensor, j) -> float:
    """max |t - j| over max |j|."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def _check_stage(label, t: torch.Tensor, j, tol):
    """A stage's values within the run's tolerances (bf16 or f32 by the
    JAX value's dtype, which the port's must match)."""
    assert _dt(t) == str(j.dtype), label
    if t.dtype == torch.float32:
        gap = _rel_gap(t, j)
        print(f"{label}: max gap {gap:.3e} of the largest value")
        assert gap <= tol["f32"], label
        return
    jt = torch.from_numpy(np.asarray(j, np.float32)).bfloat16()
    d = _ulps(t, jt)
    top = float(np.abs(np.asarray(j, np.float32)).max())
    gap = float((t.float() - jt.float()).abs().max()) / _ulp(top)
    print(f"{label}: {(d > 0).mean():.2e} of the elements differ, at most "
          f"{d.max()} ulps, max gap {gap:.3f} ulps of the largest value")
    assert (d > 0).mean() <= tol["differ"], label
    assert gap <= tol["ulps"], label


def _check_replays(replays):
    print(f"replays: {replays}")
    assert sum(n for _, n, _ in replays) <= MAX_REPLAYS
    assert all(gap <= REPLAY_GAP for _, _, gap in replays)


def test_tf_voxels_plans_and_overflows(tf_run):
    r = tf_run
    np.testing.assert_array_equal(r["tres"].coords.numpy(),
                                  r["jres"].coords)
    np.testing.assert_array_equal(r["tres"].features.numpy(),
                                  r["jres"].features)
    for key in ("lidar", "fused"):
        run, jout = r["runs"][key], r["jouts"][key]
        assert len(run["plans"]) == len(jout["plans"]) > 0
        for t, j in zip(run["plans"], jout["plans"]):
            np.testing.assert_array_equal(t.numpy(), j)
        jinter = _backbone_key(jout["inter"])[0]["middle_encoder"]
        assert set(run["over"]) == {k for k in jinter
                                    if k.startswith("cap_overflow")}
        for name, t in run["over"].items():
            np.testing.assert_array_equal(t.numpy(), jinter[name][0])


@pytest.mark.parametrize("key", ["lidar", "fused"])
def test_tf_stage_values(tf_run, key):
    """TransFusion-L: every stage and the BEV map; with 3D-DF, the BEV map
    after the hook (the stages before it are TransFusion-L's)."""
    run, jout = tf_run["runs"][key], tf_run["jouts"][key]
    jbev, jms = _backbone_key(jout["inter"])[0]["middle_encoder"][
        "__call__"][0][:2]
    tbev, tms, _ = run["bb"]
    if key == "lidar":
        for k in STAGES:
            _check_stage(f"{key} {k}", tms[k].features, jms[k].features,
                         TOL[key])
    _check_stage(f"{key} bev", tbev, jbev, TOL[key])


def test_fused_hook_on_jax_input(tf_run):
    """The hook alone, on the JAX hook's bf16 input rows: the bf16 rows
    meet IFAT's and ACTR's f32 layers as flax promotes them, and the
    output is JAX's in f32 (the differences of the end-to-end run come
    from the bf16 stages upstream)."""
    got, want = tf_run["runs"]["hook_out"], tf_run["jouts"]["hook"]["out"]
    assert _dt(got) == str(want.dtype) == "float32"
    gap = _rel_gap(got, want)
    print(f"hook on JAX's input: max gap {gap:.3e} of the largest value")
    assert gap <= 1e-5


@pytest.mark.parametrize("key", ["lidar", "fused"])
def test_tf_detections(tf_run, key):
    run, jout = tf_run["runs"][key], tf_run["jouts"][key]
    for name in ("dense_heatmap", "center", "height", "dim", "rot"):
        gap = _rel_gap(run["preds"][name], jout["preds"][name])
        print(f"{key} {name}: gap {gap:.3e}")
        assert gap <= TOL[key]["f32"], name
    _check_replays(run["replays"])
    t, j = run["det"], jout["det"]
    for name in ("labels", "boxes", "scores"):
        print(f"{key} {name}: gap {_rel_gap(t[name], j[name]):.3e}")
    np.testing.assert_array_equal(t["labels"].numpy(), j["labels"])
    assert _rel_gap(t["boxes"], j["boxes"]) <= TOL[key]["f32"]
    assert _rel_gap(t["scores"], j["scores"]) <= TOL[key]["f32"]


def test_vr_voxels_plans_and_overflows(vr_run):
    r = vr_run
    np.testing.assert_array_equal(r["tres"].coords.numpy(),
                                  r["jres"].coords)
    assert len(r["plans"]) == len(r["jout"]["plans"]) == 8
    for t, j in zip(r["plans"], r["jout"]["plans"]):
        np.testing.assert_array_equal(t.numpy(), j)
    assert set(r["over"]) == set(r["jout"]["overflow"])
    for name, t in r["over"].items():
        np.testing.assert_array_equal(t.numpy(), r["jout"]["overflow"][name])


def test_vr_stage_values(vr_run):
    r = vr_run
    jms = r["jout"]["preds"]["ms"]
    for k in STAGES:
        np.testing.assert_array_equal(r["preds"]["ms"][k].coords.numpy(),
                                      jms[k].coords)
        _check_stage(f"voxel rcnn {k}", r["preds"]["ms"][k].features,
                     jms[k].features, TOL["kitti"])
    for k in ("cls", "box", "dir"):
        gap = _rel_gap(r["preds"][k], r["jout"]["preds"][k])
        exact_gap = _rel_gap(r["exact"][k], r["jout"]["preds"][k])
        print(f"rpn {k}: gap {gap:.3e}, 'exact' {exact_gap:.3e}")
        assert gap <= TOL["kitti"]["f32"], k
        # the comparison sees which profile ran
        assert exact_gap > 5 * TOL["kitti"]["f32"], k


def test_vr_detections(vr_run):
    r = vr_run
    _check_replays(r["replays"])
    out, det = r["jout"]["out"], r["det"]
    np.testing.assert_array_equal(det["roi_mask"].numpy(), out["roi_mask"])
    np.testing.assert_array_equal(det["valid"].numpy(), out["valid"])
    assert out["valid"].any()
    np.testing.assert_array_equal(det["labels"].numpy(), out["labels"])
    for name, t, j in (("cls", r["cls"], r["jout"]["cls"]),
                       ("reg", r["reg"], r["jout"]["reg"]),
                       ("rois", det["rois"], out["rois"]),
                       ("boxes", det["boxes"], out["boxes"]),
                       ("scores", det["scores"], out["scores"])):
        gap = _rel_gap(t, j)
        print(f"{name}: gap {gap:.3e}")
        assert gap <= TOL["kitti"]["f32"], name
