"""Voxel R-CNN (pcdet) checkpoint importer (port of
df3d/train/import_voxelrcnn.py): a pcdet state dict straight into the
port's first stage (`VoxelRCNN`) and RCNN head (`VoxelRCNNHead`).

pcdet's names map onto the JAX package's two flax trees:

  backbone_3d.conv_input/conv1/conv2../conv_out   -> backbone.{conv_input,
      conv1, down2, conv2a, conv2b, down3, ..., conv_out}
  backbone_2d.blocks/deblocks (BaseBEVBackbone)   -> neck.block*/deblock*
  dense_head.conv_cls/conv_box/conv_dir_cls       -> dense_head.conv_*
  roi_head.roi_grid_pool_layers.{k}.mlps_{in,pos,out}
                                                  -> {conv2,conv3,conv4}_mlp_*
  roi_head.{shared,cls,reg}_fc_layers + pred      -> shared_fc*/cls_*/reg_*

and `torch_import.imported_state_dict` carries each into its module. The
spconv layout is read from each weight's shape, as pcdet's
`_load_state_dict` tells v1 from v2.
"""

from __future__ import annotations

from typing import Mapping

import torch

from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNN
from df3d_torch.models.heads.voxelrcnn_head import VoxelRCNNHead
from df3d_torch.train.torch_import import (
    TrackedStateDict, batchnorm, conv1d, conv2d, conv_bn_2d,
    imported_state_dict, linear, spconv_taps,
)
from df3d_torch.weights import state_dict_from_flax


def spconv_taps_auto(w: torch.Tensor) -> torch.Tensor:
    """5D spconv weight -> (K, in, out) taps, v1 (kz, ky, kx, in, out) or
    v2 (out, kz, ky, kx, in) told apart by shape as pcdet does (kernel dims
    are 1 or 3 here, channel dims at least 4)."""
    if w.dim() != 5:
        raise ValueError(f"expected a 5D spconv weight, got {tuple(w.shape)}")
    if all(d in (1, 3) for d in w.shape[:3]):
        return spconv_taps(w, "v1")
    if all(d in (1, 3) for d in w.shape[1:4]):
        return spconv_taps(w, "v2")
    raise ValueError(f"cannot infer the spconv layout of {tuple(w.shape)}")


def _conv2d_1x1(w):  # torch Conv2d (out, in, 1, 1) -> Dense (in, out)
    return w[:, :, 0, 0].T


def voxelrcnn_name_map(rpn: VoxelRCNN, sd: Mapping
                       ) -> tuple[dict, dict, dict, dict]:
    """pcdet names -> (rpn params, rpn batch_stats, rcnn params, rcnn
    batch_stats) trees in the JAX package's paths. The neck's block counts
    are `rpn`'s."""
    params: dict = {"backbone": {}, "neck": {}, "dense_head": {}}
    stats: dict = {"backbone": {}, "neck": {}}
    bb_p, bb_s = params["backbone"], stats["backbone"]

    def sparse_cbr(name, conv_key, bn_prefix, subm):
        conv = "SubMConv3d_0" if subm else "SparseConv3d_0"
        bnp, bns = batchnorm(sd, bn_prefix)
        bb_p[name] = {conv: {"kernel": spconv_taps_auto(sd[conv_key])},
                      "MaskedBatchNorm_0": bnp}
        bb_s[name] = {"MaskedBatchNorm_0": bns}

    # VoxelBackBone8x (pcdet spconv_backbone.py SparseSequential indices:
    # stage.0 the strided conv, stage.1 and .2 the subm blocks)
    sparse_cbr("conv_input", "backbone_3d.conv_input.0.weight",
               "backbone_3d.conv_input.1", subm=True)
    sparse_cbr("conv1", "backbone_3d.conv1.0.0.weight",
               "backbone_3d.conv1.0.1", subm=True)
    for stage, (down, a, b) in enumerate(
            [("down2", "conv2a", "conv2b"), ("down3", "conv3a", "conv3b"),
             ("down4", "conv4a", "conv4b")], start=2):
        t = f"backbone_3d.conv{stage}"
        sparse_cbr(down, f"{t}.0.0.weight", f"{t}.0.1", subm=False)
        sparse_cbr(a, f"{t}.1.0.weight", f"{t}.1.1", subm=True)
        sparse_cbr(b, f"{t}.2.0.weight", f"{t}.2.1", subm=True)
    sparse_cbr("conv_out", "backbone_3d.conv_out.0.weight",
               "backbone_3d.conv_out.1", subm=False)

    # BaseBEVBackbone: blocks.{i} = [ZeroPad, Conv (1), BN (2), ReLU,
    # (Conv, BN, ReLU) x layer_num]; deblocks.{k} = [ConvTranspose, BN]
    nk_p, nk_s = params["neck"], stats["neck"]
    for i, ln in enumerate(rpn.neck.layer_nums):
        t = f"backbone_2d.blocks.{i}"
        nk_p[f"block{i}_in"], nk_s[f"block{i}_in"] = conv_bn_2d(
            sd, f"{t}.1.weight", f"{t}.2")
        for j in range(ln):
            nk_p[f"block{i}_conv{j}"], nk_s[f"block{i}_conv{j}"] = conv_bn_2d(
                sd, f"{t}.{4 + 3 * j}.weight", f"{t}.{5 + 3 * j}")
    for k in range(2):
        t = f"backbone_2d.deblocks.{k}"
        w = sd[f"{t}.0.weight"]
        if w.shape[2] == 1:
            # a stride-1 ConvTranspose (in, out, 1, 1) is the pointwise
            # conv (1, 1, in, out) the JAX package runs
            bnp, bns = batchnorm(sd, f"{t}.1")
            nk_p[f"deblock{k}"] = {"Conv_0": {"kernel": w.permute(2, 3, 0, 1)},
                                   "BatchNorm_0": bnp}
            nk_s[f"deblock{k}"] = {"BatchNorm_0": bns}
        else:
            nk_p[f"deblock{k}"], nk_s[f"deblock{k}"] = conv_bn_2d(
                sd, f"{t}.0.weight", f"{t}.1", transpose=True)

    # AnchorHeadSingle
    dh = params["dense_head"]
    for torch_name, flax_name in (("conv_cls", "conv_cls"),
                                  ("conv_box", "conv_box"),
                                  ("conv_dir_cls", "conv_dir")):
        key = f"dense_head.{torch_name}.weight"
        if key in sd:
            dh[flax_name] = {"kernel": conv2d(sd[key]),
                             "bias": sd[f"dense_head.{torch_name}.bias"]}

    # VoxelRCNNHead (roi_head): the masked norms of the pooling MLPs and
    # the FC stacks
    rcnn_p: dict = {}
    rcnn_s: dict = {}

    def masked_bn(name, prefix):
        rcnn_p[name], rcnn_s[name] = batchnorm(sd, prefix)

    for k, key in enumerate(("conv2", "conv3", "conv4")):
        t = f"roi_head.roi_grid_pool_layers.{k}"
        if f"{t}.mlps_in.0.0.weight" not in sd:
            continue
        rcnn_p[f"{key}_mlp_in"] = {
            "kernel": conv1d(sd[f"{t}.mlps_in.0.0.weight"])}
        masked_bn(f"{key}_bn_in", f"{t}.mlps_in.0.1")
        rcnn_p[f"{key}_mlp_pos"] = {
            "kernel": _conv2d_1x1(sd[f"{t}.mlps_pos.0.0.weight"])}
        masked_bn(f"{key}_bn_pos", f"{t}.mlps_pos.0.1")
        rcnn_p[f"{key}_mlp_out"] = {
            "kernel": conv1d(sd[f"{t}.mlps_out.0.0.weight"])}
        masked_bn(f"{key}_bn_out", f"{t}.mlps_out.0.1")

    def fc_stack_auto(name, torch_prefix):
        """Sequential [Linear, BN, ReLU(, Dropout)] x k: the next Linear at
        +3 without dropout, +4 with it; both strides probed."""
        i, idx = 0, 0
        while f"{torch_prefix}.{idx}.weight" in sd:
            rcnn_p[f"{name}_fc{i}"] = {
                "kernel": linear(sd[f"{torch_prefix}.{idx}.weight"])}
            masked_bn(f"{name}_bn{i}", f"{torch_prefix}.{idx + 1}")
            i += 1
            if f"{torch_prefix}.{idx + 3}.weight" in sd:
                idx += 3
            elif f"{torch_prefix}.{idx + 4}.weight" in sd:
                idx += 4
            else:
                break

    if "roi_head.shared_fc_layer.0.weight" in sd:
        fc_stack_auto("shared", "roi_head.shared_fc_layer")
        fc_stack_auto("cls", "roi_head.cls_fc_layers")
        fc_stack_auto("reg", "roi_head.reg_fc_layers")
        for name, torch_name in (("cls_pred", "roi_head.cls_pred_layer"),
                                 ("reg_pred", "roi_head.reg_pred_layer")):
            rcnn_p[name] = {"kernel": linear(sd[f"{torch_name}.weight"]),
                            "bias": sd[f"{torch_name}.bias"]}
    return params, stats, rcnn_p, rcnn_s


def import_voxelrcnn(rpn: VoxelRCNN, head: VoxelRCNNHead, torch_sd: Mapping
                     ) -> tuple[dict, dict]:
    """A pcdet Voxel R-CNN state dict -> the `state_dict`s of `rpn` and
    `head` (strict both ways over the two together)."""
    sd = TrackedStateDict(torch_sd)
    p, s, rp, rs = voxelrcnn_name_map(rpn, sd)
    return (imported_state_dict(rpn, sd, p, s),
            state_dict_from_flax(head, {"params": rp, "batch_stats": rs}))
