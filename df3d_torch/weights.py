"""Carry the JAX package's flax variables across to the port's modules.

`state_dict_from_flax(model, variables)` turns `{"params": ...,
"batch_stats": ...}` (nested dicts of numpy arrays, as the JAX package's
`model.init` gives them after `jax.tree_util.tree_map(np.asarray, ...)`)
into a `state_dict` for `model`:

* sparse conv taps `(K, Cin, Cout)` are kept as they are;
* flax conv kernels HWIO -> OIHW;
* flax `ConvTranspose` kernels `(kh, kw, in, out)` -> torch `(in, out, kh,
  kw)` with both spatial axes flipped;
* BatchNorm (over NHWC maps, masked voxel rows, or the last axis of
  (B, P, C)) scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var; LayerNorm and GroupNorm scale/bias ->
  weight/bias;
* Dense kernels `(in, out)` -> Linear `(out, in)`; the attention's
  `DenseGeneral` kernels `(in, heads, head_dim)` (query/key/value) and
  `(heads, head_dim, out)` (out), and a 1x1 Conv kernel `(1, 1, in, out)`
  that the port runs as a Linear, flatten to `(in, out)` first;
* the fusion hook's children (`mvx_proj`, `ifat`, `actr`,
  `actr_out_proj`), which flax puts under the backbone (CenterPoint's and
  Voxel R-CNN's `backbone`, TransFusion's `middle_encoder`), live under
  the backbone's `fusion_hook` module.

`load_voxelrcnn(rpn, head, params, batch_stats)` carries Voxel R-CNN's
two-part tree, `{"rpn": ..., "rcnn": ...}` in each collection (the tree the
JAX package's `build_detector` makes), into its two modules.

Flax names a module's children `<Class>_<i>` by creation order; the tables
below give each torch module's attribute for them. A leaf that maps to no
torch entry, a torch entry that no leaf fills, or a shape that disagrees
raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from df3d_torch.models.backbones_3d import (
    SparseEncoder, SpMiddleResNetFHD, VoxelBackBone8x,
)
from df3d_torch.models.fusion.actr import (
    ACTR, EncoderLayer, FusionEncoderLayer,
)
from df3d_torch.models.fusion.pointformer import PreNormEncoderLayer
from df3d_torch.models.heads.center_head import CenterHead, SepHeadBranch
from df3d_torch.models.heads.transfusion_head import (
    DecoderLayer, PositionEmbeddingLearned,
)
from df3d_torch.models.layers import (
    ConvBNReLU2d, DeconvBNReLU2d, FlaxBatchNorm, MaskedBatchNorm,
    SparseBasicBlock, SparseConv3d, SparseConvBNReLU, SubMConv3d,
)
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.train.trainer import create_train_state

_HOOK_CHILDREN = {name: f"fusion_hook.{name}"
                  for name in ("mvx_proj", "ifat", "actr", "actr_out_proj")}
_CHILD_NAMES = {
    SparseConvBNReLU: {"SubMConv3d_0": "conv", "SparseConv3d_0": "conv",
                       "MaskedBatchNorm_0": "bn"},
    SparseBasicBlock: {"SubMConv3d_0": "conv1", "MaskedBatchNorm_0": "bn1",
                       "SubMConv3d_1": "conv2", "MaskedBatchNorm_1": "bn2"},
    ConvBNReLU2d: {"Conv_0": "conv", "BatchNorm_0": "bn"},
    DeconvBNReLU2d: {"ConvTranspose_0": "deconv", "BatchNorm_0": "bn"},
    CenterHead: {"Conv_0": "shared_conv", "BatchNorm_0": "shared_bn"},
    SpMiddleResNetFHD: _HOOK_CHILDREN,
    SparseEncoder: _HOOK_CHILDREN,
    VoxelBackBone8x: _HOOK_CHILDREN,
    PositionEmbeddingLearned: {"Dense_0": "fc0", "Dense_1": "fc1"},
    DecoderLayer: {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                   "LayerNorm_2": "norm3", "Dense_0": "ff1", "Dense_1": "ff2"},
    PreNormEncoderLayer: {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                          "Dense_0": "ff1", "Dense_1": "ff2"},
    EncoderLayer: {"LayerNorm_0": "norm1", "Dense_0": "ff1",
                   "Dense_1": "ff2", "LayerNorm_1": "norm2"},
    FusionEncoderLayer: {"LayerNorm_0": "norm_attn", "LayerNorm_1": "norm_i",
                         "LayerNorm_2": "norm_p"},
}


def _child(module: nn.Module, name: str) -> tuple[nn.Module, str]:
    """The torch child (and its attribute path) that flax calls `name`."""
    if isinstance(module, SepHeadBranch):
        kind, i = name.rsplit("_", 1)
        i = int(i)
        if kind == "Conv":
            attr = f"convs.{i}" if i < len(module.convs) else "out"
        elif kind == "BatchNorm":
            attr = f"bns.{i}"
        else:
            raise KeyError(name)
    elif isinstance(module, CenterHead) and name.startswith("task"):
        task, branch = name[len("task"):].split("_", 1)
        attr = f"tasks.{int(task)}.{branch}"
    elif isinstance(module, BEVBackbone):
        attr = f"blocks.{name}"
    else:
        attr = _CHILD_NAMES.get(type(module), {}).get(name, name)
    return module.get_submodule(attr), attr


def _leaf(module: nn.Module, collection: str, name: str,
          value: np.ndarray) -> tuple[str, np.ndarray]:
    """(torch entry name, value in the torch layout) for one flax leaf."""
    if isinstance(module, (SubMConv3d, SparseConv3d)) and name == "kernel":
        return "weight", value
    if isinstance(module, (MaskedBatchNorm, FlaxBatchNorm, nn.BatchNorm2d)):
        table = {("params", "scale"): "weight", ("params", "bias"): "bias",
                 ("batch_stats", "mean"): "running_mean",
                 ("batch_stats", "var"): "running_var"}
        return table[(collection, name)], value
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return {"scale": "weight", "bias": "bias"}[name], value
    if isinstance(module, nn.Linear):
        if name == "kernel":
            return "weight", value.reshape(module.in_features,
                                           module.out_features).T
        if name == "bias":
            return "bias", value.reshape(-1)
    if isinstance(module, ACTR) and name == "level_embed":
        return "level_embed", value
    if isinstance(module, nn.ConvTranspose2d) and name == "kernel":
        return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        if name == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        if name == "bias":
            return "bias", value
    raise KeyError(f"{type(module).__name__} has no counterpart for {name}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _carry(model: nn.Module, variables) -> dict:
    """{torch entry: tensor} for every leaf of `variables`' "params" and
    "batch_stats" collections."""
    target = model.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            module, names = model, []
            try:
                for seg in path[:-1]:
                    module, attr = _child(module, seg)
                    names.append(attr)
                entry, value = _leaf(module, collection, path[-1], value)
            except (KeyError, AttributeError, ValueError) as e:
                raise KeyError(
                    f"flax leaf {collection}/{'/'.join(path)} has no torch "
                    f"counterpart: {e}") from None
            key = ".".join(names + [entry])
            if key not in target:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} -> "
                               f"{key}, which the model does not have")
            if tuple(target[key].shape) != value.shape:
                raise ValueError(
                    f"{key}: torch shape {tuple(target[key].shape)} vs "
                    f"carried {value.shape} from {'/'.join(path)}")
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def state_dict_from_flax(model: nn.Module, variables) -> dict:
    """flax variables -> `state_dict` of `model` (torch tensors on the CPU,
    float32). Raises on an unmapped leaf, an unfilled entry or a shape
    mismatch."""
    target = model.state_dict()
    out = _carry(model, variables)
    # BatchNorm2d's step counter has no flax counterpart and no effect in
    # eval mode
    missing = [k for k in target
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"torch entries no flax leaf fills: {missing}")
    for k in target:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long)
    return out


def load_voxelrcnn(rpn: nn.Module, head: nn.Module, params,
                   batch_stats) -> None:
    """Voxel R-CNN's flax variables, {"rpn": ..., "rcnn": ...} in `params`
    and in `batch_stats`, carried into the first stage `rpn` (`VoxelRCNN`
    or `VoxelRCNN3DDF`) and the `VoxelRCNNHead` (strictly, as
    `state_dict_from_flax`)."""
    for part, module in (("rpn", rpn), ("rcnn", head)):
        module.load_state_dict(state_dict_from_flax(
            module, {"params": params[part],
                     "batch_stats": batch_stats[part]}))


def params_from_flax(model: nn.Module, tree) -> dict:
    """A tree shaped like the flax params (the parameters, their gradients
    or an update) -> {parameter name: tensor} for every parameter of
    `model`, in the torch layout. Raises unless the tree fills each
    parameter exactly once."""
    out = _carry(model, {"params": tree})
    names = [name for name, _ in model.named_parameters()]
    if sorted(out) != sorted(names):
        raise KeyError("flax tree and model parameters differ: "
                       f"{sorted(set(out) ^ set(names))}")
    return out


def train_state_from_flax(model: nn.Module, params, batch_stats, tx):
    """A flax `TrainState`'s params and batch_stats carried into `model`
    (CenterPoint or TransFusion-L, or their 3D-DF detectors with the image
    branch's and IFAT's batch statistics; TransFusion's head with those of
    its heatmap branch, position embeddings and FFN branches; Voxel R-CNN's
    `VoxelRCNNTwoStage`, whose {"rpn": ..., "rcnn": ...} trees land in its
    `rpn` and `rcnn` modules as they are), and a port `TrainState` around
    it with the optimizer moments at zero (as `TrainState.create` leaves
    them). A frozen image branch's parameters are carried but are not in
    the state's `params`."""
    model.load_state_dict(state_dict_from_flax(
        model, {"params": params, "batch_stats": batch_stats}))
    return create_train_state(model, tx)
