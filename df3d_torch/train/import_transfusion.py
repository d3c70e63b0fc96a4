"""TransFusion-L (mmdet3d) and TransFusion + Swin checkpoint importers
(port of df3d/train/import_transfusion.py): an mmdet3d state dict straight
into the port's `TransFusionL`, or an mmdet TransFusion + Swin-T one into
a `TransFusion3DDF` with the Swin image branch.

mmdet3d's names (SparseEncoder's conv_input/encoder_layers/conv_out,
SECOND's blocks, SECONDFPN's deblocks, TransFusionHead's shared_conv,
heatmap_head, class_encoding, decoder and prediction_heads) map onto the
JAX package's flax paths, with torch's packed MultiheadAttention in_proj
split into query, key and value; `torch_import.imported_state_dict`
carries them into the port's entries. mmdet's Swin (`img_backbone.*`) and
FPN (`img_neck.*`) names map onto the image branch's `swin` and
`swin_fpn` the same way (`swin_name_map`, `fpn_name_map`).
"""

from __future__ import annotations

from typing import Mapping

import torch

from df3d_torch.models.detectors.fused import TransFusion3DDF
from df3d_torch.models.detectors.transfusion import TransFusionL
from df3d_torch.models.image.swin import relative_index
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


# --- the Swin-T image branch (TransFusion-L + 3D-DF, Swin variant) ---------

def _swin_merge_perm(arr: torch.Tensor, c: int) -> torch.Tensor:
    """A leading 4C axis from mmdet's PatchMerging layout to the port's.
    mmdet's `nn.Unfold` sampler is channel-major (index c * 4 + pos, pos =
    ih * 2 + iw); the port's reshape-transpose merge is position-major
    (pos * C + c) over the same positions: a (C, 4) -> (4, C) transpose."""
    g = arr.reshape(c, 4, *arr.shape[1:])
    return g.transpose(0, 1).reshape(arr.shape)


def swin_name_map(sd: Mapping, prefix: str = "img_backbone.",
                  depths=(2, 2, 6, 2), windows=None) -> dict:
    """mmdet's SwinTransformer names -> the flax params tree of the JAX
    package's `SwinTransformer` (LayerNorms only: no batch statistics).
    The window attention's packed qkv is one Linear(3C), transposed; the
    relative position bias table is copied as it is; PatchMerging's norm
    and reduction are group-permuted (`_swin_merge_perm`). A checkpoint's
    `relative_position_index` buffer, when it carries one, must equal the
    port's index for the block's window (`windows[si]`, one per stage)."""
    p = prefix

    def ln(t):
        return {"scale": sd[f"{t}.weight"], "bias": sd[f"{t}.bias"]}

    def dense(t):
        return {"kernel": linear(sd[f"{t}.weight"]), "bias": sd[f"{t}.bias"]}

    out: dict = {
        "patch_embed": {"kernel": conv2d(sd[f"{p}patch_embed.projection.weight"]),
                        "bias": sd[f"{p}patch_embed.projection.bias"]},
        "LayerNorm_0": ln(f"{p}patch_embed.norm"),
    }
    for si, depth in enumerate(depths):
        for bi in range(depth):
            t = f"{p}stages.{si}.blocks.{bi}"
            a = f"{t}.attn.w_msa"
            index = f"{a}.relative_position_index"
            if index in sd and not torch.equal(
                    sd[index].long(), relative_index(windows[si])):
                raise ValueError(f"{index}: not the window-{windows[si]} "
                                 "relative position index")
            out[f"stage{si}_block{bi}"] = {
                "LayerNorm_0": ln(f"{t}.norm1"),
                "LayerNorm_1": ln(f"{t}.norm2"),
                "attn": {"qkv": dense(f"{a}.qkv"),
                         "rel_bias": sd[f"{a}.relative_position_bias_table"],
                         "proj": dense(f"{a}.proj")},
                "mlp0": dense(f"{t}.ffn.layers.0.0"),
                "mlp1": dense(f"{t}.ffn.layers.1"),
            }
        out[f"out_norm{si}"] = ln(f"{p}norm{si}")
        if si < len(depths) - 1:
            t = f"{p}stages.{si}.downsample"
            c = sd[f"{t}.norm.weight"].shape[0] // 4
            out[f"merge_norm{si}"] = {
                k: _swin_merge_perm(v, c) for k, v in ln(f"{t}.norm").items()}
            out[f"merge{si}"] = {"kernel": _swin_merge_perm(
                linear(sd[f"{t}.reduction.weight"]), c)}
    return out


def fpn_name_map(sd: Mapping, prefix: str = "img_neck.",
                 n_ins: int = 4) -> dict:
    """mmdet's FPN (lateral_convs, fpn_convs) -> the flax params tree of
    the JAX package's `FPN`."""
    out = {}
    for i in range(n_ins):
        for flax_name, torch_name in (("lateral", "lateral_convs"),
                                      ("fpn", "fpn_convs")):
            t = f"{prefix}{torch_name}.{i}.conv"
            out[f"{flax_name}{i}"] = {"kernel": conv2d(sd[f"{t}.weight"]),
                                      "bias": sd[f"{t}.bias"]}
    return out


def import_transfusion_3ddf_swin(model: TransFusion3DDF, torch_sd: Mapping
                                 ) -> dict[str, torch.Tensor]:
    """An mmdet TransFusion + Swin-T state dict (`img_backbone.*`,
    `img_neck.*`, `pts_*`) -> the `state_dict` of `model`, a
    `TransFusion3DDF` with the Swin image branch: the image branch and the
    LiDAR detector from the checkpoint, strict both ways; the fusion hook
    and an aux head, which the checkpoint does not hold, keep `model`'s
    weights (as the JAX package's `import_transfusion_3ddf_swin` merges
    into the variables it is given)."""
    sd = TrackedStateDict(torch_sd)
    swin = model.image_branch.swin
    windows = [getattr(swin, f"stage{si}_block0").win
               for si in range(len(swin.depths))]
    lidar_p, lidar_s = transfusion_name_map(model.detector, sd)
    params = {"detector": lidar_p, "image_branch": {
        "swin": swin_name_map(sd, depths=swin.depths, windows=windows),
        "swin_fpn": fpn_name_map(sd, n_ins=len(swin.depths))}}
    return imported_state_dict(
        model, sd, params, {"detector": lidar_s},
        keep=("detector.middle_encoder.fusion_hook.", "aux_seg."))
