"""Reference-checkpoint importers' shared machinery (port of
df3d/train/torch_import.py): torch .pth state dicts of the reference
(pcdet, det3d, mmdet3d) loaded straight into the port's
modules.

Each family's name map (`import_centerpoint`, `import_voxelrcnn`,
`import_transfusion`) turns the reference's names into the JAX package's
flax paths, with the JAX package's layouts:

  torch Conv2d   (out, in, kh, kw)      -> flax (kh, kw, in, out)
  torch Linear   (out, in)              -> flax (in, out)
  spconv v1      (kz, ky, kx, in, out)  -> taps (K, in, out)
  spconv v2      (out, kz, ky, kx, in)  -> taps (K, in, out)
  BatchNorm      weight/bias/running_*  -> scale/bias/mean/var

and `imported_state_dict` carries those trees into the port's entries
through `weights.py`'s tables, the one source of the flax -> torch naming.
The values stay tensors throughout. The import is strict both ways: a
reference key that no map reads (other than BatchNorm's
`num_batches_tracked`), a port entry that no key fills, or a shape that
disagrees raises and names itself.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from df3d_torch.weights import state_dict_from_flax


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Load a reference .pth checkpoint into a {name: tensor} state dict on
    the CPU. Handles the three wrappers (pcdet {'model_state': ...}, det3d
    and mmdet3d {'state_dict': ...}, {'model': ...}) and strips a DDP
    'module.' prefix; entries that are not tensors are dropped. Unpickles
    with torch's `weights_only` loader: the wrappers' other entries
    (epochs, versions, optimizer state, meta dicts) are plain containers,
    numbers and strings, and a file that pickles anything else is refused
    with torch's error naming the object."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state", "state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k.removeprefix("module."): v.detach()
            for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def conv2d(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def linear(w: torch.Tensor) -> torch.Tensor:
    return w.T


def conv1d(w: torch.Tensor) -> torch.Tensor:
    """torch Conv1d (out, in, 1) -> flax Dense (in, out)."""
    return w[:, :, 0].T


def conv_transpose2d(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d (in, out, kh, kw) -> flax (kh, kw, in, out)
    with both spatial axes flipped: flax's `ConvTranspose` runs a
    fractionally strided conv with the kernel as given, torch the
    gradient-derived transpose."""
    return w.permute(2, 3, 0, 1).flip(0, 1)


def spconv_taps(w: torch.Tensor, layout: str = "v2") -> torch.Tensor:
    """-> (K, in, out) row-major (z, y, x) taps (`ops.sparse`'s layout)."""
    if w.dim() != 5:
        raise ValueError(f"expected a 5D spconv weight, got {tuple(w.shape)}")
    if layout == "v1":  # (kz, ky, kx, in, out)
        kz, ky, kx, ci, co = w.shape
        return w.reshape(kz * ky * kx, ci, co)
    if layout == "v2":  # (out, kz, ky, kx, in)
        co, kz, ky, kx, ci = w.shape
        return w.permute(1, 2, 3, 4, 0).reshape(kz * ky * kx, ci, co)
    raise ValueError(layout)


def batchnorm(torch_sd: Mapping, prefix: str) -> tuple[dict, dict]:
    """A BatchNorm's (params, batch_stats) leaves, flax-named."""
    return ({"scale": torch_sd[f"{prefix}.weight"],
             "bias": torch_sd[f"{prefix}.bias"]},
            {"mean": torch_sd[f"{prefix}.running_mean"],
             "var": torch_sd[f"{prefix}.running_var"]})


def resnet_name_map(torch_sd: Mapping, layers=(3, 4, 6, 3),
                    torch_prefix: str = "backbone.") -> tuple[dict, dict]:
    """A torchvision or mmdet ResNet's names -> (params, batch_stats) trees
    in the JAX package's `ResNet` paths (conv1, bn1, layer{i}_{j} with
    conv1-3, bn1-3 and, where the checkpoint has one, the downsample conv
    and norm)."""
    params, stats = {}, {}
    p = torch_prefix
    params["conv1"] = {"kernel": conv2d(torch_sd[f"{p}conv1.weight"])}
    params["bn1"], stats["bn1"] = batchnorm(torch_sd, f"{p}bn1")
    for li, n in enumerate(layers):
        for j in range(n):
            t, f = f"{p}layer{li + 1}.{j}", f"layer{li + 1}_{j}"
            blk, blk_s = {}, {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = {
                    "kernel": conv2d(torch_sd[f"{t}.conv{ci}.weight"])}
            for ci in (1, 2, 3):
                blk[f"bn{ci}"], blk_s[f"bn{ci}"] = batchnorm(
                    torch_sd, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in torch_sd:
                blk["downsample_conv"] = {
                    "kernel": conv2d(torch_sd[f"{t}.downsample.0.weight"])}
                blk["downsample_bn"], blk_s["downsample_bn"] = batchnorm(
                    torch_sd, f"{t}.downsample.1")
            params[f], stats[f] = blk, blk_s
    return params, stats


def conv_bn_2d(torch_sd: Mapping, conv_key: str, bn_prefix: str,
               transpose: bool = False) -> tuple[dict, dict]:
    """A 2D conv (or a ConvTranspose2d) and its BatchNorm -> (params,
    batch_stats) of a neck block, flax-named."""
    if transpose:
        conv = {"ConvTranspose_0": {
            "kernel": conv_transpose2d(torch_sd[conv_key])}}
    else:
        conv = {"Conv_0": {"kernel": conv2d(torch_sd[conv_key])}}
    bnp, bns = batchnorm(torch_sd, bn_prefix)
    return {**conv, "BatchNorm_0": bnp}, {"BatchNorm_0": bns}


class TrackedStateDict(dict):
    """A state dict that records the keys read from it by `[]` (`in`
    reads nothing), so that an import can name the keys it left."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def unread(self) -> list[str]:
        """The keys no map read, BatchNorm's step counters aside."""
        return sorted(k for k in self if k not in self.accessed
                      and not k.endswith("num_batches_tracked"))


def imported_state_dict(model: nn.Module, torch_sd: TrackedStateDict,
                        params: dict, stats: dict,
                        keep: tuple[str, ...] = ()) -> dict:
    """The `state_dict` of `model` from a name map's flax-named trees of
    `torch_sd`'s tensors; the entries under the `keep` prefixes, which the
    reference does not hold, keep `model`'s values. Raises on a key of
    `torch_sd` the map did not read, and (`weights.state_dict_from_flax`)
    on a leaf with no entry, an entry with no leaf or a shape that
    disagrees."""
    unread = torch_sd.unread()
    if unread:
        raise KeyError(f"reference keys no entry of {type(model).__name__} "
                       f"takes: {unread}")
    return state_dict_from_flax(model, {"params": params,
                                        "batch_stats": stats}, keep=keep)
