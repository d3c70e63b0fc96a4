"""TransFusion-L (mmdet3d) checkpoint importer (port of
df3d/train/import_transfusion.py:1-215): an mmdet3d state dict straight
into the port's `TransFusionL`.

mmdet3d's names (SparseEncoder's conv_input/encoder_layers/conv_out,
SECOND's blocks, SECONDFPN's deblocks, TransFusionHead's shared_conv,
heatmap_head, class_encoding, decoder and prediction_heads) map onto the
JAX package's flax paths, with torch's packed MultiheadAttention in_proj
split into query, key and value; `torch_import.imported_state_dict`
carries them into the port's entries. The Swin image branch's importer is
not ported.
"""

from __future__ import annotations

from typing import Mapping

import torch

from df3d_torch.models.detectors.transfusion import TransFusionL
from df3d_torch.train.import_voxelrcnn import spconv_taps_auto
from df3d_torch.train.torch_import import (
    TrackedStateDict, batchnorm, conv1d, conv2d, conv_bn_2d,
    imported_state_dict, linear,
)


def _mha(sd: Mapping, prefix: str, num_heads: int) -> dict:
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention:
    the packed (3d, d) in_proj split into query, key and value kernels (d,
    heads, head_dim), the out_proj into (heads, head_dim, d)."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    hd = d // num_heads
    out = {name: {"kernel": w[i * d:(i + 1) * d].T.reshape(d, num_heads, hd),
                  "bias": b[i * d:(i + 1) * d].reshape(num_heads, hd)}
           for i, name in enumerate(("query", "key", "value"))}
    out["out"] = {
        "kernel": sd[f"{prefix}.out_proj.weight"].T.reshape(num_heads, hd, d),
        "bias": sd[f"{prefix}.out_proj.bias"]}
    return out


def transfusion_name_map(model: TransFusionL, sd: Mapping
                         ) -> tuple[dict, dict]:
    """mmdet3d names -> (params, batch_stats) trees in the JAX package's
    TransFusionL paths. The encoder's stages, the neck's block counts and
    the attention's head count are `model`'s."""
    encoder_channels = model.middle_encoder.ENCODER_CHANNELS
    num_heads = model.cfg.head.num_heads
    params: dict = {"middle_encoder": {}, "pts_backbone": {}, "bbox_head": {}}
    stats: dict = {"middle_encoder": {}, "pts_backbone": {}, "bbox_head": {}}
    me_p, me_s = params["middle_encoder"], stats["middle_encoder"]

    def sparse_cbr(name, conv_key, bn_prefix, subm):
        conv = "SubMConv3d_0" if subm else "SparseConv3d_0"
        bnp, bns = batchnorm(sd, bn_prefix)
        me_p[name] = {conv: {"kernel": spconv_taps_auto(sd[conv_key])},
                      "MaskedBatchNorm_0": bnp}
        me_s[name] = {"MaskedBatchNorm_0": bns}

    def basic_block(name, t):
        b0p, b0s = batchnorm(sd, f"{t}.bn1")
        b1p, b1s = batchnorm(sd, f"{t}.bn2")
        me_p[name] = {
            "SubMConv3d_0": {"kernel": spconv_taps_auto(sd[f"{t}.conv1.weight"])},
            "SubMConv3d_1": {"kernel": spconv_taps_auto(sd[f"{t}.conv2.weight"])},
            "MaskedBatchNorm_0": b0p, "MaskedBatchNorm_1": b1p}
        me_s[name] = {"MaskedBatchNorm_0": b0s, "MaskedBatchNorm_1": b1s}

    enc = "pts_middle_encoder"
    sparse_cbr("conv_input", f"{enc}.conv_input.0.weight",
               f"{enc}.conv_input.1", subm=True)
    for i, blocks in enumerate(encoder_channels):
        t = f"{enc}.encoder_layers.encoder_layer{i + 1}"
        for j in range(len(blocks)):
            if j == len(blocks) - 1 and i != len(encoder_channels) - 1:
                sparse_cbr(f"stage{i}_down", f"{t}.{j}.0.weight",
                           f"{t}.{j}.1", subm=False)
            else:
                basic_block(f"stage{i}_block{j}", f"{t}.{j}")
    sparse_cbr("conv_out", f"{enc}.conv_out.0.weight", f"{enc}.conv_out.1",
               subm=False)

    # SECOND + SECONDFPN -> BEVBackbone: SECOND's blocks have no ZeroPad
    # (conv at 0, bn at 1, then every 3); a stride-1 deblock is a Conv2d
    nk_p, nk_s = params["pts_backbone"], stats["pts_backbone"]
    for i, ln in enumerate(model.pts_backbone.layer_nums):
        t = f"pts_backbone.blocks.{i}"
        nk_p[f"block{i}_in"], nk_s[f"block{i}_in"] = conv_bn_2d(
            sd, f"{t}.0.weight", f"{t}.1")
        for j in range(ln):
            nk_p[f"block{i}_conv{j}"], nk_s[f"block{i}_conv{j}"] = conv_bn_2d(
                sd, f"{t}.{3 + 3 * j}.weight", f"{t}.{4 + 3 * j}")
    for k in range(2):
        t = f"pts_neck.deblocks.{k}"
        nk_p[f"deblock{k}"], nk_s[f"deblock{k}"] = conv_bn_2d(
            sd, f"{t}.0.weight", f"{t}.1",
            transpose=sd[f"{t}.0.weight"].shape[2] != 1)

    # TransFusionHead
    hd_p, hd_s = params["bbox_head"], stats["bbox_head"]
    h = "pts_bbox_head"
    hd_p["shared_conv"] = {"kernel": conv2d(sd[f"{h}.shared_conv.weight"])}
    if f"{h}.shared_conv.bias" in sd:
        hd_p["shared_conv"]["bias"] = sd[f"{h}.shared_conv.bias"]
    hd_p["hm_conv0"] = {"kernel": conv2d(sd[f"{h}.heatmap_head.0.conv.weight"])}
    hd_p["hm_bn"], hd_s["hm_bn"] = batchnorm(sd, f"{h}.heatmap_head.0.bn")
    hd_p["hm_conv1"] = {"kernel": conv2d(sd[f"{h}.heatmap_head.1.weight"]),
                        "bias": sd[f"{h}.heatmap_head.1.bias"]}
    hd_p["class_encoding"] = {"kernel": conv1d(sd[f"{h}.class_encoding.weight"]),
                              "bias": sd[f"{h}.class_encoding.bias"]}

    # position embeddings: Conv1d(2 -> d) + BN1d + ReLU + Conv1d(d -> d)
    for torch_name, flax_name in (("self_posembed", "query_pos_embed"),
                                  ("cross_posembed", "key_pos_embed")):
        t = f"{h}.decoder.0.{torch_name}.position_embedding_head"
        bnp, bns = batchnorm(sd, f"{t}.1")
        hd_p[flax_name] = {
            "Dense_0": {"kernel": conv1d(sd[f"{t}.0.weight"]),
                        "bias": sd[f"{t}.0.bias"]},
            "bn": bnp,
            "Dense_1": {"kernel": conv1d(sd[f"{t}.3.weight"]),
                        "bias": sd[f"{t}.3.bias"]}}
        hd_s[flax_name] = {"bn": bns}

    dec = {"self_attn": _mha(sd, f"{h}.decoder.0.self_attn", num_heads),
           "cross_attn": _mha(sd, f"{h}.decoder.0.multihead_attn", num_heads)}
    for i, norm in enumerate(("norm1", "norm2", "norm3")):
        dec[f"LayerNorm_{i}"] = {"scale": sd[f"{h}.decoder.0.{norm}.weight"],
                                 "bias": sd[f"{h}.decoder.0.{norm}.bias"]}
    for i in range(2):
        dec[f"Dense_{i}"] = {
            "kernel": linear(sd[f"{h}.decoder.0.linear{i + 1}.weight"]),
            "bias": sd[f"{h}.decoder.0.linear{i + 1}.bias"]}
    hd_p["decoder0"] = dec

    # the prediction FFN branches; the reference's 'heatmap' branch is 'cls'
    for torch_name, flax_name in (("center", "center"), ("height", "height"),
                                  ("dim", "dim"), ("rot", "rot"),
                                  ("vel", "vel"), ("heatmap", "cls")):
        t = f"{h}.prediction_heads.0.{torch_name}"
        hd_p[f"{flax_name}_fc0"] = {"kernel": conv1d(sd[f"{t}.0.conv.weight"])}
        hd_p[f"{flax_name}_bn0"], hd_s[f"{flax_name}_bn0"] = batchnorm(
            sd, f"{t}.0.bn")
        hd_p[f"{flax_name}_fc1"] = {"kernel": conv1d(sd[f"{t}.1.weight"]),
                                    "bias": sd[f"{t}.1.bias"]}
    return params, stats


def import_transfusion(model: TransFusionL, torch_sd: Mapping
                       ) -> dict[str, torch.Tensor]:
    """An mmdet3d TransFusion-L state dict -> the `state_dict` of `model`
    (strict both ways)."""
    sd = TrackedStateDict(torch_sd)
    params, stats = transfusion_name_map(model, sd)
    return imported_state_dict(model, sd, params, stats)
