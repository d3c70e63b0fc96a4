"""Rules of the PyTorch port: df3d_torch (its training package, the
reference-checkpoint importers, the evaluators, the presets, configs and
`build_detector` too, PV-RCNN, PointPillars and the TransFusion LC
decoder), chip_smoke.py, k1_ablate.py, k2_ablate.py and
lidar_wall.py import nothing of JAX, optax or the JAX package, scipy only
in the host-side Hungarian assignment (df3d_torch/ops/assign.py, as the
JAX package and the reference assign with it), PyYAML only in the config
loader (df3d_torch/config/config.py, inside the functions that parse) and
Pillow only in the camera-image module (df3d_torch/data/images.py, inside
the functions that decode, resize, read an image's header and write a
JPEG); in the package only the reference
checkpoint loader (df3d_torch/train/torch_import.py) and the training
checkpoints (train/checkpoint.py) unpickle with `torch.load`, each with
torch's `weights_only` loader; no port module names the JAX package's
prebuilt point-loader library or builds anything next to csrc/'s sources;
with no CUDA device the entry
points and the command-line tools that run a model (train, over several
ranks too, test, demo, fit_caps) raise rather than fall back, and the K1
and K2 launchers (K1's input
gradient launch too) never answer with their plain versions. The ablation
scripts' source edits still apply to the kernels they copy."""

import ast
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from df3d_torch import entry as entry_mod
from df3d_torch.config import fused_config, get_preset
from df3d_torch.models.build import build_detector
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops import msda as tmsda
from df3d_torch.ops import msda_kernel as k2
from df3d_torch.ops import sparse_conv_kernel as k1
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "df3d", "scipy", "yaml",
             "PIL")
# the one module that may import scipy: the assignment runs on the host
SCIPY_ALLOWED = ROOT / "df3d_torch" / "ops" / "assign.py"
# the one module that may import PyYAML: the config loader (the card's
# machine is not known to have it)
YAML_ALLOWED = ROOT / "df3d_torch" / "config" / "config.py"
# the one module that may import Pillow: camera images are decoded and
# resized on the host (the card's machine is not known to have it)
PIL_ALLOWED = ROOT / "df3d_torch" / "data" / "images.py"
ALLOWED = {SCIPY_ALLOWED: "scipy", YAML_ALLOWED: "yaml", PIL_ALLOWED: "PIL"}
# the modules that may call torch.load: the reference checkpoints and the
# training checkpoints
TORCH_LOAD_ALLOWED = {ROOT / "df3d_torch" / "train" / "torch_import.py",
                      ROOT / "df3d_torch" / "train" / "checkpoint.py"}


def _port_files():
    files = sorted((ROOT / "df3d_torch").rglob("*.py"))
    assert {"schedules.py", "trainer.py", "torch_import.py",
            "import_centerpoint.py", "import_voxelrcnn.py",
            "import_transfusion.py", "evaluate.py"} <= {
        f.name for f in files if f.parent.name == "train"}
    assert {"checkpoint.py", "loop.py"} <= {
        f.name for f in files if f.parent.name == "train"}
    assert {"nuscenes_eval.py", "kitti_eval.py", "kitti.py", "native.py",
            "images.py", "nuscenes.py", "augment.py", "transforms.py",
            "pipeline.py"} <= {
        f.name for f in files if f.parent.name == "data"}
    assert {"train.py", "test.py", "create_data.py", "demo.py",
            "fit_caps.py"} <= {
        f.name for f in files if f.parent.name == "tools"}
    assert {"ddp.py", "launch.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert {"presets.py", "config.py"} <= {
        f.name for f in files if f.parent.name == "config"}
    assert ROOT / "df3d_torch" / "models" / "build.py" in files
    models = ROOT / "df3d_torch" / "models"
    assert {models / "pfe.py", models / "vfe.py",
            models / "heads" / "point_head.py",
            models / "heads" / "transfusion_lc.py",
            models / "detectors" / "pv_rcnn.py",
            models / "detectors" / "pointpillar.py",
            ROOT / "df3d_torch" / "core" / "ieee.py"} <= set(files)
    return files + [
        ROOT / "chip_smoke.py", ROOT / "k1_ablate.py",
        ROOT / "k2_ablate.py", ROOT / "lidar_wall.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    forbidden = set(FORBIDDEN) - {ALLOWED.get(path)}
    bad = sorted({m for m in _imported_roots(path) if m in forbidden})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    if path in ALLOWED:
        assert ALLOWED[path] in set(_imported_roots(path))


def _importing_functions(path, module):
    """(whether the module's top level imports `module`, the names of the
    functions that import it)."""
    tree = ast.parse(path.read_text())

    def imports(node):
        return (isinstance(node, ast.Import)
                and any(a.name.split(".")[0] == module for a in node.names)
                ) or (isinstance(node, ast.ImportFrom)
                      and (node.module or "").split(".")[0] == module)

    top = any(imports(n) for n in tree.body)
    inside = {f.name for f in ast.walk(tree)
              if isinstance(f, ast.FunctionDef)
              and any(imports(n) for n in ast.walk(f))}
    return top, inside


def test_yaml_imported_only_where_a_config_is_parsed():
    """PyYAML is imported inside `load_config` and `_parse_value`, never at
    the config module's top level, so importing the port needs no PyYAML."""
    tree = ast.parse(YAML_ALLOWED.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any(a.name == "yaml" for n in top
                   for a in getattr(n, "names", []))
    inside = {f.name for f in ast.walk(tree)
              if isinstance(f, ast.FunctionDef)
              and any(isinstance(n, ast.Import)
                      and any(a.name == "yaml" for a in n.names)
                      for n in ast.walk(f))}
    assert inside == {"load_config", "_parse_value"}


def test_pillow_imported_only_inside_image_functions():
    """Pillow is imported inside `decode_image`, `resize_normalize_pad`,
    `read_image_shape` and `write_jpeg` of the camera-image module, never
    at its top level, so importing the port needs no Pillow (nor does an
    image already at its target size)."""
    top, inside = _importing_functions(PIL_ALLOWED, "PIL")
    assert not top
    assert inside == {"decode_image", "resize_normalize_pad",
                      "read_image_shape", "write_jpeg"}


def test_no_prebuilt_point_loader_and_no_build_in_csrc():
    """No port file names the JAX package's prebuilt `libdf3dio.so` or runs
    `make`; the point loader's library is built under build/df3d_torch,
    from csrc/pointio.cc as it is."""
    from df3d_torch.data import native

    for path in _port_files():
        text = path.read_text()
        assert "libdf3dio" not in text, path
        assert '"make"' not in text and "'make'" not in text, path
    out = native.library_path()
    assert out.parent == ROOT / "build" / "df3d_torch"
    assert native.SOURCE == ROOT / "csrc" / "pointio.cc"
    assert "-march=native" not in native.CXX_FLAGS


def _torch_load_calls(path):
    """Lines that call `torch.load` (or a bare `load` imported from
    torch)."""
    tree = ast.parse(path.read_text(), str(path))
    bare = {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module == "torch"
            for a in node.names if a.name == "load"}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if ((isinstance(f, ast.Attribute) and f.attr == "load"
             and getattr(f.value, "id", None) == "torch")
                or (isinstance(f, ast.Name) and f.id in bare)):
            yield node.lineno


@pytest.mark.parametrize("path", sorted((ROOT / "df3d_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_torch_load_only_in_the_checkpoint_loader(path):
    calls = list(_torch_load_calls(path))
    if path in TORCH_LOAD_ALLOWED:
        assert len(calls) == 1
        assert "weights_only=True" in path.read_text()
    else:
        assert not calls, f"{path.relative_to(ROOT)}:{calls} calls torch.load"


@pytest.mark.parametrize("script, source",
                         [("k1_ablate.py", "sparse_conv.cu"),
                          ("k2_ablate.py", "msda.cu")])
def test_ablation_edits_apply(script, source):
    """Each variant's (old, new) edits find their text exactly once in the
    kernel source, as `build.build_variants` requires on the card."""
    text = (ROOT / "df3d_torch" / "csrc" / source).read_text()
    variants = runpy.run_path(str(ROOT / script))["VARIANTS"]
    assert "kernel" in variants and not variants["kernel"]
    for name, edits in variants.items():
        for old, new in edits:
            assert text.count(old) == 1, f"{script} {name}: {old!r}"
            assert old != new


def test_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_centerpoint(entry_mod.small_cfg())
    fn, (feats, coords) = entry_mod.entry(device="cpu")
    assert feats.device.type == "cpu"
    preset = get_preset("centerpoint_3ddf_nusc")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_centerpoint3ddf(preset["lidar"],
                                        fused_config(preset))


def test_trainer_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_centerpoint_trainer(entry_mod.small_cfg())
    state, step = entry_mod.build_centerpoint_trainer(entry_mod.small_cfg(),
                                                      device="cpu")
    assert state.model.training and state.step == 0
    assert all(not m.any() for m in state.opt_state.mu)


def test_transfusion_trainer_entries_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_transfusion_trainer(get_preset("transfusion_l_nusc"))
    preset = get_preset("transfusion_3ddf_nusc")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_transfusion3ddf_trainer(
            preset["lidar"], fused_config(preset))


def test_transfusion_entries_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_transfusion(get_preset("transfusion_l_nusc"))
    preset = get_preset("transfusion_3ddf_nusc")
    fcfg = fused_config(preset)
    assert fcfg.image_branch == "resnet_fpn" and fcfg.n_levels == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_transfusion3ddf(preset["lidar"], fcfg)


def test_voxelrcnn_entries_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_preset("voxel_rcnn_car_kitti")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_voxelrcnn(cfg)
    preset = get_preset("voxel_rcnn_3ddf_kitti")
    fcfg = fused_config(preset)
    assert (fcfg.num_cams, fcfg.image_shape, fcfg.image_branch,
            fcfg.n_levels) == (1, (384, 1280), "deeplabv3", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_voxelrcnn3ddf(preset["lidar"], fcfg)


def test_pvrcnn_entries_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from df3d_torch.models.detectors.pv_rcnn import PVRCNNConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_pvrcnn(PVRCNNConfig())
    model, head = entry_mod.build_pvrcnn(PVRCNNConfig(), device="cpu")
    assert not model.training and not head.training
    assert next(model.parameters()).device.type == "cpu"


def test_build_detector_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for name in ("centerpoint_tiny_smoke", "voxel_rcnn_car_kitti"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_detector(get_preset(name))
    from df3d_torch.train.schedules import adam_onecycle
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(get_preset("centerpoint_tiny_smoke"),
                       adam_onecycle(1e-3, 10))


@pytest.mark.parametrize("tool, argv", [
    ("train", ["--preset", "centerpoint_tiny_smoke", "--synthetic"]),
    ("train", ["--preset", "centerpoint_tiny_smoke", "--synthetic",
               "--nprocs", "2"]),
    ("test", ["--preset", "centerpoint_tiny_smoke", "--ckpt", "none"]),
    ("demo", ["--preset", "centerpoint_tiny_smoke", "--bin", "none.bin"]),
    ("fit_caps", ["--preset", "centerpoint_nusc", "--synthetic"])],
    ids=["train", "train_nprocs", "test", "demo", "fit_caps"])
def test_tools_without_cuda_raise(tool, argv, tmp_path):
    """Each command-line tool that runs a model takes the card unless
    `--device cpu` and raises before any work when there is none."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    main = importlib.import_module(f"df3d_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv + (["--work-dir", str(tmp_path)] if tool == "train"
                     else []))
    assert list(tmp_path.iterdir()) == []


def test_k1_launcher_raises_on_cpu_tensors():
    """The launcher never computes the plain version: that is reached only
    through the CPU-tensor branch of apply_sparse_conv."""
    f = torch.randn(1, 4, 5)
    idx = torch.full((1, 27 * 4), 4, dtype=torch.int32)
    w = torch.randn(27, 5, 3)
    before = k1.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        k1.sparse_conv_cuda(f, idx, w)
    assert k1.launches == before
    bwd_before = k1.bwd_launches
    with pytest.raises(RuntimeError, match="CUDA"):
        k1.sparse_conv_cuda_dx(f, idx, w)
    assert k1.bwd_launches == bwd_before
    plan = tsp.ConvPlan(idx, -torch.ones(1, 4, 3, dtype=torch.int32),
                        (1, 2, 2), (3, 3, 3))
    f.requires_grad_(True)
    out = tsp.apply_sparse_conv(f, plan, w)
    np.testing.assert_array_equal(out.detach().numpy(), np.zeros((1, 4, 3)))
    out.sum().backward()
    assert (k1.launches, k1.bwd_launches) == (before, bwd_before)


def test_k2_launcher_raises_on_cpu_tensors(monkeypatch):
    """The K2 launcher raises on CPU tensors and never reaches the plain
    version; only ops.msda.ms_deform_attn's CPU-tensor branch does."""
    rng = np.random.RandomState(0)
    shapes = ((3, 4), (2, 2))
    value = torch.from_numpy(rng.randn(1, 16, 2, 4).astype(np.float32))
    locs = torch.from_numpy(rng.rand(1, 5, 2, 2, 3, 2).astype(np.float32))
    w = torch.from_numpy(rng.rand(1, 5, 2, 2, 3).astype(np.float32))
    plain = k2.msda_plain
    want = plain(value, shapes, locs, w)

    def no_plain(*args):
        raise AssertionError("the launcher reached the plain version")

    monkeypatch.setattr(k2, "msda_plain", no_plain)
    before = k2.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        k2.msda_cuda(value, shapes, locs, w)
    assert k2.launches == before
    monkeypatch.setattr(k2, "msda_plain", plain)
    got = tmsda.ms_deform_attn(value, shapes, locs, w)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert k2.launches == before
