"""Rules of the PyTorch port: df3d_torch, chip_smoke.py, k1_ablate.py and
lidar_wall.py import nothing of JAX or of the JAX package; with no CUDA
device the entry points raise rather than fall back, and the K1 and K2
launchers never answer with their plain versions."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from df3d_torch import entry as entry_mod
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops import msda as tmsda
from df3d_torch.ops import msda_kernel as k2
from df3d_torch.ops import sparse_conv_kernel as k1

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "df3d")


def _port_files():
    return sorted((ROOT / "df3d_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "k1_ablate.py",
        ROOT / "lidar_wall.py"]


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
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_centerpoint(entry_mod.small_cfg())
    fn, (feats, coords) = entry_mod.entry(device="cpu")
    assert feats.device.type == "cpu"
    preset = entry_mod.centerpoint_3ddf_nusc()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.build_centerpoint3ddf(preset["lidar"],
                                        entry_mod.fused_config(preset))


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
    plan = tsp.ConvPlan(idx, -torch.ones(1, 4, 3, dtype=torch.int32),
                        (1, 2, 2), (3, 3, 3))
    out = tsp.apply_sparse_conv(f, plan, w)
    np.testing.assert_array_equal(out.numpy(), np.zeros((1, 4, 3)))
    assert k1.launches == before


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
