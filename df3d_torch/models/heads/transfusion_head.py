"""TransFusion-L's query-decoder head (port of
df3d/models/heads/transfusion_head.py), inference only.

dense heatmap -> 3x3 max-pool peaks (every pixel of a small class is a
peak) -> top-`num_proposals` queries over the class-major flattened peaks,
with a class embedding -> one transformer decoder layer over the BEV
features, with learned position embeddings of the BEV pixels -> FFN
branches -> `transfusion_get_bboxes`: all queries decoded, no NMS. The
Hungarian assignment and the losses wait for the training slice.

Where a literal PyTorch translation would differ from flax, kept here and
pinned by tests/test_torch_transfusion.py: ties in the top-k (all
non-peaks are exactly 0) go to the lower index first, as `jax.lax.top_k`
orders them (`core.nms.top_k_stable`); the peak test compares the heatmap
with its max-pool exactly, both padding with -inf; flax attention takes its
values from the key input (`models.attention`); BatchNorms over the last
axis of (B, P, C) and LayerNorms use flax's epsilons (1e-5, 1e-6).
Maps are channel-last at the public functions, as in the JAX package;
query and key positions are BEV pixels (x, y), x first; the keys are the
BEV pixels in y-major order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.core.box_coders import TransFusionBBoxCoder
from df3d_torch.core.nms import top_k_stable
from df3d_torch.models.attention import LN_EPS, FlaxMultiHeadAttention

BN_EPS = 1e-5  # flax BatchNorm default
HEATMAP_PRIOR = -2.19
# (name, out channels) of the FFN branches, in the JAX package's order
BRANCHES = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2),
            ("vel", 2))


@dataclasses.dataclass(frozen=True)
class TransFusionHeadCfg:
    """The inference fields of the JAX package's `TransFusionHeadCfg`
    (its assignment costs and loss weights wait for the training slice)."""

    num_classes: int = 10
    num_proposals: int = 200
    hidden_channel: int = 128
    num_heads: int = 8
    ffn_channel: int = 256
    nms_kernel_size: int = 3
    small_classes: tuple = (8, 9)  # pedestrian, traffic_cone: no maxpool NMS
    bev_size: tuple = (180, 180)
    out_size_factor: int = 8
    voxel_size: tuple = (0.075, 0.075)
    pc_range: tuple = (-54.0, -54.0)
    head_conv: int = 64  # FFN mid channels

    @property
    def coder(self) -> TransFusionBBoxCoder:
        return TransFusionBBoxCoder(
            pc_range=self.pc_range, voxel_size=self.voxel_size,
            out_size_factor=self.out_size_factor)


class LastAxisBatchNorm(nn.BatchNorm1d):
    """flax `BatchNorm` over the last axis of (..., C), eval path."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class PositionEmbeddingLearned(nn.Module):
    """Dense -> BatchNorm -> ReLU -> Dense over the point axis."""

    def __init__(self, in_dim: int, d_model: int):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, d_model)
        self.bn = LastAxisBatchNorm(d_model)
        self.fc1 = nn.Linear(d_model, d_model)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.relu(self.bn(self.fc0(xy))))


class DecoderLayer(nn.Module):
    """Self-attention over the queries, cross-attention to the BEV keys,
    FFN; a LayerNorm after each residual."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int):
        super().__init__()
        self.self_attn = FlaxMultiHeadAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = FlaxMultiHeadAttention(d_model, n_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(d_model, d_ffn)
        self.ff2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, q, q_pos, kv, kv_pos):
        qp = q + q_pos
        q = self.norm1(q + self.self_attn(qp, qp))
        # the values carry the key position embedding too (flax's inputs_v
        # defaults to inputs_k)
        q = self.norm2(q + self.cross_attn(q + q_pos, kv + kv_pos))
        h = self.ff2(torch.relu(self.ff1(q)))
        return self.norm3(q + h)


class TransFusionHead(nn.Module):
    def __init__(self, cfg: TransFusionHeadCfg, in_channels: int):
        super().__init__()
        self.cfg = c = cfg
        d = c.hidden_channel
        self.shared_conv = nn.Conv2d(in_channels, d, 3, padding=1)
        self.hm_conv0 = nn.Conv2d(d, d, 3, padding=1, bias=False)
        self.hm_bn = nn.BatchNorm2d(d, eps=BN_EPS)
        self.hm_conv1 = nn.Conv2d(d, c.num_classes, 3, padding=1)
        self.class_encoding = nn.Linear(c.num_classes, d)
        self.query_pos_embed = PositionEmbeddingLearned(2, d)
        self.key_pos_embed = PositionEmbeddingLearned(2, d)
        self.decoder0 = DecoderLayer(d, c.num_heads, c.ffn_channel)
        for name, ch in BRANCHES + (("cls", c.num_classes),):
            self.add_module(f"{name}_fc0",
                            nn.Linear(d, c.head_conv, bias=False))
            self.add_module(f"{name}_bn0", LastAxisBatchNorm(c.head_conv))
            self.add_module(f"{name}_fc1", nn.Linear(c.head_conv, ch))

    def _branch(self, name: str, q: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"{name}_bn0")(getattr(self, f"{name}_fc0")(q))
        return getattr(self, f"{name}_fc1")(torch.relu(h))

    def forward(self, bev: torch.Tensor) -> dict[str, torch.Tensor]:
        """bev (B, H, W, C_in) -> preds: per query (B, P, ...) branches,
        `query_labels`, `query_pos_xy`, `query_score` (the heatmap at the
        query's pixel, every class), and `dense_heatmap` logits (B, H, W,
        ncls)."""
        c = self.cfg
        b, hh, ww, _ = bev.shape
        d, ncls = c.hidden_channel, c.num_classes
        feat = self.shared_conv(bev.permute(0, 3, 1, 2))     # (B, d, H, W)
        h = torch.relu(self.hm_bn(self.hm_conv0(feat)))
        dense_heatmap = self.hm_conv1(h)                     # (B, ncls, H, W)

        heatmap = torch.sigmoid(dense_heatmap)
        k = c.nms_kernel_size
        # max_pool2d pads with -inf, as flax's max_pool does
        local_max = F.max_pool2d(heatmap, k, stride=1, padding=k // 2)
        is_peak = heatmap == local_max
        is_peak[:, list(c.small_classes)] = True
        peaks = torch.where(is_peak, heatmap, 0.0)
        _, top_idx = top_k_stable(peaks.reshape(b, -1), c.num_proposals)
        query_labels = torch.div(top_idx, hh * ww, rounding_mode="floor")
        pos_idx = top_idx % (hh * ww)
        ys = torch.div(pos_idx, ww, rounding_mode="floor").to(bev.dtype)
        xs = (pos_idx % ww).to(bev.dtype)

        feat_flat = feat.permute(0, 2, 3, 1).reshape(b, hh * ww, d)
        query_feat = feat_flat.gather(1, pos_idx[..., None].expand(-1, -1, d))
        one_hot = F.one_hot(query_labels, ncls).to(bev.dtype)
        query_feat = query_feat + self.class_encoding(one_hot)

        query_pos_xy = torch.stack([xs, ys], -1)            # (B, P, 2)
        q_pos = self.query_pos_embed(query_pos_xy)
        grid_y, grid_x = torch.meshgrid(
            torch.arange(hh, dtype=bev.dtype, device=bev.device),
            torch.arange(ww, dtype=bev.dtype, device=bev.device),
            indexing="ij")
        bev_xy = torch.stack([grid_x, grid_y], -1).reshape(1, hh * ww, 2)
        # per-pixel function of the position alone: one row serves the batch
        kv_pos = self.key_pos_embed(bev_xy).expand(b, -1, -1)

        q = self.decoder0(query_feat, q_pos, feat_flat, kv_pos)

        heat_flat = heatmap.permute(0, 2, 3, 1).reshape(b, hh * ww, ncls)
        return {
            "query_feat": q,
            "query_pos_xy": query_pos_xy,
            "center": self._branch("center", q) + query_pos_xy,
            "height": self._branch("height", q)[..., 0],
            "dim": self._branch("dim", q),
            "rot": self._branch("rot", q),
            "vel": self._branch("vel", q),
            "cls": self._branch("cls", q),
            "dense_heatmap": dense_heatmap.permute(0, 2, 3, 1),
            "query_labels": query_labels,
            "query_score": heat_flat.gather(
                1, pos_idx[..., None].expand(-1, -1, ncls)),
        }


def transfusion_get_bboxes(cfg: TransFusionHeadCfg, preds):
    """Every query decoded, no NMS: boxes (B, P, 9) gravity-centre 9-dof,
    scores = max class probability x the heatmap score at the query's
    label, labels = the argmax class."""
    dec = cfg.coder.decode(
        preds["center"], preds["height"], preds["dim"],
        preds["rot"][..., 0], preds["rot"][..., 1], preds["vel"])
    z = dec[..., 2] + 0.5 * dec[..., 5]  # bottom -> gravity centre
    dec = torch.cat([dec[..., :2], z[..., None], dec[..., 3:]], -1)
    cls_prob = torch.sigmoid(preds["cls"])
    hm_score = preds["query_score"].gather(
        -1, preds["query_labels"][..., None])[..., 0]
    # argmax takes the first of equal maxima, as jnp.argmax does
    return {"boxes": dec, "scores": cls_prob.amax(-1) * hm_score,
            "labels": cls_prob.argmax(-1)}
