"""CenterPoint (det3d) checkpoint importer (port of
df3d/train/import_centerpoint.py): a det3d state dict straight into the
port's `CenterPoint`.

det3d's names (SpMiddleResNetFHD's SparseSequential indices, the RPN's
blocks and deblocks, CenterHead's SepHead branches) map onto the JAX
package's flax paths, which `torch_import.imported_state_dict` carries into
the port's entries. det3d's published checkpoints store spconv v1 weights;
the layout is read from each weight's shape (`spconv_taps_auto`), as the
other two families' importers read it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from df3d_torch.models.detectors.centerpoint import CenterPoint
from df3d_torch.train.import_voxelrcnn import spconv_taps_auto
from df3d_torch.train.torch_import import (
    TrackedStateDict, batchnorm, conv2d, conv_bn_2d, imported_state_dict,
)


def centerpoint_name_map(model: CenterPoint, sd: Mapping
                         ) -> tuple[dict, dict]:
    """det3d names -> (params, batch_stats) trees in the JAX package's
    CenterPoint paths. The neck's block counts are `model`'s; the head's
    task count is read from the keys."""
    params: dict = {"backbone": {}, "neck": {}, "head": {}}
    stats: dict = {"backbone": {}, "neck": {}, "head": {}}
    bb_p, bb_s = params["backbone"], stats["backbone"]

    def taps(key):
        return spconv_taps_auto(sd[key])

    def sparse_cbr(name, conv_key, bn_prefix, subm):
        bnp, bns = batchnorm(sd, bn_prefix)
        conv = "SubMConv3d_0" if subm else "SparseConv3d_0"
        bb_p[name] = {conv: {"kernel": taps(conv_key)},
                      "MaskedBatchNorm_0": bnp}
        bb_s[name] = {"MaskedBatchNorm_0": bns}

    def basic_block(name, t):
        b0p, b0s = batchnorm(sd, f"{t}.bn1")
        b1p, b1s = batchnorm(sd, f"{t}.bn2")
        bb_p[name] = {"SubMConv3d_0": {"kernel": taps(f"{t}.conv1.weight")},
                      "SubMConv3d_1": {"kernel": taps(f"{t}.conv2.weight")},
                      "MaskedBatchNorm_0": b0p, "MaskedBatchNorm_1": b1p}
        bb_s[name] = {"MaskedBatchNorm_0": b0s, "MaskedBatchNorm_1": b1s}

    sparse_cbr("conv_input", "backbone.conv_input.0.weight",
               "backbone.conv_input.1", subm=True)
    basic_block("res1a", "backbone.conv1.0")
    basic_block("res1b", "backbone.conv1.1")
    for stage, (down, a, b) in enumerate(
            [("down2", "res2a", "res2b"), ("down3", "res3a", "res3b"),
             ("down4", "res4a", "res4b")], start=2):
        t = f"backbone.conv{stage}"
        sparse_cbr(down, f"{t}.0.weight", f"{t}.1", subm=False)
        basic_block(a, f"{t}.3")
        basic_block(b, f"{t}.4")
    sparse_cbr("extra_conv", "backbone.extra_conv.0.weight",
               "backbone.extra_conv.1", subm=False)

    # det3d's RPN: blocks.{i} = [ZeroPad2d, Conv2d (1), BN (2), ReLU,
    # (Conv2d, BN, ReLU) x layer_num]; deblock 0 a stride-1 Conv2d, deblock
    # 1 a ConvTranspose2d
    nk_p, nk_s = params["neck"], stats["neck"]

    for i, layer_num in enumerate(model.neck.layer_nums):
        t = f"neck.blocks.{i}"
        nk_p[f"block{i}_in"], nk_s[f"block{i}_in"] = conv_bn_2d(
            sd, f"{t}.1.weight", f"{t}.2")
        for j in range(layer_num):
            nk_p[f"block{i}_conv{j}"], nk_s[f"block{i}_conv{j}"] = conv_bn_2d(
                sd, f"{t}.{4 + 3 * j}.weight", f"{t}.{5 + 3 * j}")
    for k in range(2):
        t = f"neck.deblocks.{k}"
        nk_p[f"deblock{k}"], nk_s[f"deblock{k}"] = conv_bn_2d(
            sd, f"{t}.0.weight", f"{t}.1", transpose=(k == 1))

    # CenterHead: the shared conv, then per task a SepHead branch each
    hd_p, hd_s = params["head"], stats["head"]
    hd_p["Conv_0"] = {"kernel": conv2d(sd["bbox_head.shared_conv.0.weight"]),
                      "bias": sd["bbox_head.shared_conv.0.bias"]}
    hd_p["BatchNorm_0"], hd_s["BatchNorm_0"] = batchnorm(
        sd, "bbox_head.shared_conv.1")
    t = 0
    while f"bbox_head.tasks.{t}.reg.0.weight" in sd:
        for name in ("reg", "height", "dim", "rot", "vel", "hm"):
            tb = f"bbox_head.tasks.{t}.{name}"
            bnp, bns = batchnorm(sd, f"{tb}.1")
            hd_p[f"task{t}_{name}"] = {
                "Conv_0": {"kernel": conv2d(sd[f"{tb}.0.weight"]),
                           "bias": sd[f"{tb}.0.bias"]},
                "BatchNorm_0": bnp,
                "Conv_1": {"kernel": conv2d(sd[f"{tb}.3.weight"]),
                           "bias": sd[f"{tb}.3.bias"]},
            }
            hd_s[f"task{t}_{name}"] = {"BatchNorm_0": bns}
        t += 1
    return params, stats


def import_centerpoint(model: CenterPoint, torch_sd: Mapping
                       ) -> dict[str, torch.Tensor]:
    """A det3d CenterPoint state dict -> the `state_dict` of `model`
    (strict both ways, `torch_import.imported_state_dict`)."""
    sd = TrackedStateDict(torch_sd)
    params, stats = centerpoint_name_map(model, sd)
    return imported_state_dict(model, sd, params, stats)
