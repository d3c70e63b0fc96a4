"""TransFusion's camera stage (port of df3d/models/heads/transfusion_lc.py):
the second decoder, whose object queries attend to the image features of
one camera each, and the image-guided query initialisation.

Each query attends to the last camera whose frustum holds it (the
reference keeps the last visible view): the logits over the keys of every
other camera take -1e9, and with a projected radius r per query and camera
the log of a gaussian of sigma (2r + 1) / 6 around the projected centre.
A second FFN stack predicts from [image query, LiDAR query]; queries that
no camera sees keep their first-stage predictions.
"""

from __future__ import annotations

import torch
from torch import nn

from df3d_torch.models.attention import LN_EPS, FlaxMultiHeadAttention
from df3d_torch.models.heads.transfusion_head import (
    BN_EPS, FFN_BN_MOMENTUM, PositionEmbeddingLearned, TransFusionHeadCfg,
)
from df3d_torch.models.layers import FlaxBatchNorm
from df3d_torch.utils import stages

_NEG = -1e9
# the refined predictions: (name, channels); "height" drops its last axis
BRANCHES = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2),
            ("vel", 2))


def collapse_image_init(bev_feat: torch.Tensor, img_feats: torch.Tensor,
                        layers) -> torch.Tensor:
    """Image-guided query initialisation: each view's features (B, nc, Hc,
    Wc, C), already at the hidden width, max over the image height, then
    one decoder layer per view (`layers[v]`, a `DecoderLayer`) refines the
    flattened BEV features (B, HW, C) against them, zero position
    embeddings on both sides."""
    collapsed = img_feats.amax(2)                       # (B, nc, Wc, C)
    for v in range(img_feats.shape[1]):
        kv = collapsed[:, v]
        bev_feat = layers[v](bev_feat, torch.zeros_like(bev_feat), kv,
                             torch.zeros_like(kv))
    return bev_feat


class TransFusionLCDecoder(nn.Module):
    """flax's names: `img_proj`, `key_pos`, `query_pos`, `img_cross_attn`,
    `LayerNorm_0` / `Dense_0` / `Dense_1` / `LayerNorm_1` (here `norm1`,
    `ff1`, `ff2`, `norm2`) and `<branch>_fc0`, `<branch>_bn0` and
    `<branch>_fc1` for each of `BRANCHES` and "cls"."""

    def __init__(self, cfg: TransFusionHeadCfg, img_channels: int,
                 num_cams: int = 6):
        super().__init__()
        self.cfg, self.num_cams = cfg, num_cams
        d = cfg.hidden_channel
        self.img_proj = nn.Linear(img_channels, d)
        self.key_pos = PositionEmbeddingLearned(2, d)
        self.query_pos = PositionEmbeddingLearned(2, d)
        self.img_cross_attn = FlaxMultiHeadAttention(d, cfg.num_heads)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ff1 = nn.Linear(d, cfg.ffn_channel)
        self.ff2 = nn.Linear(cfg.ffn_channel, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        for name, ch in BRANCHES + (("cls", cfg.num_classes),):
            setattr(self, f"{name}_fc0",
                    nn.Linear(2 * d, cfg.head_conv, bias=False))
            setattr(self, f"{name}_bn0",
                    FlaxBatchNorm(cfg.head_conv, BN_EPS, FFN_BN_MOMENTUM))
            setattr(self, f"{name}_fc1", nn.Linear(cfg.head_conv, ch))

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{name}_bn0")(getattr(self, f"{name}_fc0")(x))
        return getattr(self, f"{name}_fc1")(torch.relu(y))

    def forward(self, query_feat: torch.Tensor, query_pos_xy: torch.Tensor,
                first_preds: dict, img_feats: torch.Tensor,
                query_uv: torch.Tensor, query_vis: torch.Tensor,
                query_radius: torch.Tensor | None = None) -> dict:
        """query_feat (B, P, C) the LiDAR decoder's output; query_pos_xy
        (B, P, 2) BEV pixels; first_preds the first stage's predictions;
        img_feats (B, nc, Hc, Wc, Ci); query_uv (B, nc, P, 2) the projected
        centres in feature pixels; query_vis (B, nc, P) in-frustum;
        query_radius (B, nc, P) the projected corners' circumradius in
        feature pixels, or None for no gaussian term. -> the refined
        predictions (the first stage's keys)."""
        d = self.cfg.hidden_channel
        b, p, _ = query_feat.shape
        nc = self.num_cams
        hc, wc = img_feats.shape[2:4]
        hw = hc * wc
        kv = self.img_proj(img_feats).reshape(b, nc * hw, d)

        vis = query_vis.transpose(1, 2)                         # (B, P, nc)
        last = nc - 1 - vis.flip(-1).int().argmax(-1)
        any_vis = vis.any(-1)
        view = torch.where(any_vis, last, 0)
        cams = torch.arange(nc, device=vis.device)
        bias = torch.where(cams == view[..., None], 0.0, _NEG)  # (B, P, nc)
        bias = bias[..., None].expand(b, p, nc, hw)

        gy, gx = torch.meshgrid(
            torch.arange(hc, dtype=torch.float32, device=kv.device),
            torch.arange(wc, dtype=torch.float32, device=kv.device),
            indexing="ij")
        pix = torch.stack([gx, gy], -1).reshape(hw, 2) + 0.5
        if query_radius is not None:
            uv = query_uv.transpose(1, 2)[..., None, :]         # (B,P,nc,1,2)
            dist2 = ((uv - pix) ** 2).sum(-1)                   # (B,P,nc,HW)
            sigma = (2.0 * query_radius.transpose(1, 2) + 1.0) / 6.0
            bias = bias + (-dist2 / (2.0 * sigma[..., None] ** 2).clamp_min(
                1e-6))
        bias = bias.reshape(b, 1, p, nc * hw)

        img_pos = self.key_pos((pix - 0.5)[None].expand(b, hw, 2))
        kv_pos = img_pos.repeat(1, nc, 1)
        q_pos = self.query_pos(query_pos_xy)
        h = self.img_cross_attn(query_feat + q_pos, kv + kv_pos, bias=bias)
        q = self.norm1(query_feat + h)
        q = self.norm2(q + self.ff2(torch.relu(self.ff1(q))))
        q = torch.where(any_vis[..., None], q, 0.0)

        qq = torch.cat([q, query_feat], -1)
        refined = {name: self._branch(name, qq) for name, _ in BRANCHES}
        refined["center"] = refined["center"] + query_pos_xy
        refined["height"] = refined["height"][..., 0]
        refined["cls"] = self._branch("cls", qq)
        out = dict(first_preds)
        for k, v in refined.items():
            m = any_vis if v.dim() == 2 else any_vis[..., None]
            out[k] = torch.where(m, v, first_preds[k])
        stages.mark("lc_decoder")
        return out
