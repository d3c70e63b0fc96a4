"""ACTR: dual-query deformable cross-attention from voxel queries onto
multi-scale camera features, the paper's core module (port of
df3d/models/fusion/actr.py).

Flax infers each layer's input width at its first call; here the widths
are constructor arguments: `query_dim` (voxel features), `image_query_dim`
(the per-voxel image query) and `image_channels` (one per camera level).
Norms use flax's eps (1e-6 for LayerNorm and GroupNorm). There is no
dropout, as in the JAX package's default. `ACTRConfig.exact_ops` (exact
FPS and ball query for checkpoint parity) is not ported: the port's ball
query is exact already, and its FPS follows the JAX package's default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.models.fusion.gates import GATES
from df3d_torch.models.fusion.msda_module import MSDeformAttnModule
from df3d_torch.models.fusion.pointformer import LN_EPS, LocalTransformer
from df3d_torch.models.fusion.position_encoding import (
    position_embedding_sine_2d, position_embedding_sine_depth,
    position_embedding_sine_sparse,
)
from df3d_torch.utils import stages


@dataclasses.dataclass(frozen=True)
class ACTRConfig:
    d_model: int = 64
    n_heads: int = 8
    n_points: int = 4
    n_levels: int = 3
    num_layers: int = 1
    dim_feedforward: int = 256
    model_name: str = "ACTRv2"        # 'ACTR' | 'ACTRv2' (with LT)
    hybrid: bool = True               # dual-query fusion layers
    q_method: Optional[str] = "gating"
    q_rep_place: tuple = ("weight",)
    attn_layer: str = "BiGateSum1D_2"
    pos_encode_method: str = "depth"  # 'image_coor' | 'depth'
    max_depth: float = 60.0
    # LocalTransformer cfg (ACTRv2)
    lt_npoint: int = 2048
    lt_radius: float = 2.0
    lt_nsample: int = 32
    lt_num_layers: int = 2
    lt_feat_agg: str = "replace"


class EncoderLayer(nn.Module):
    """Single-stream deformable encoder layer."""

    def __init__(self, cfg: ACTRConfig):
        super().__init__()
        c = cfg
        self.self_attn = MSDeformAttnModule(c.d_model, c.n_levels,
                                            c.n_heads, c.n_points)
        self.norm1 = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(c.d_model, c.dim_feedforward)
        self.ff2 = nn.Linear(c.dim_feedforward, c.d_model)
        self.norm2 = nn.LayerNorm(c.d_model, eps=LN_EPS)

    def forward(self, q_feat, q_i_feat, q_pos, ref_points, value, shapes,
                value_mask=None):
        attn_in = q_feat + q_pos if q_pos is not None else q_feat
        src2 = self.self_attn(attn_in, ref_points, value, shapes,
                              value_mask=value_mask)
        q_feat = self.norm1(q_feat + src2)
        h = self.ff2(torch.relu(self.ff1(q_feat)))
        return self.norm2(q_feat + h), q_i_feat


class FusionEncoderLayer(nn.Module):
    """Dual-query (hybrid) layer: MSDA with the gated query mix writes into
    the image-query stream, a bidirectional gate fuses the streams, then a
    separate FFN per stream."""

    def __init__(self, cfg: ACTRConfig):
        super().__init__()
        c = cfg
        self.self_attn = MSDeformAttnModule(
            c.d_model, c.n_levels, c.n_heads, c.n_points,
            q_method=c.q_method, q_rep_place=c.q_rep_place)
        self.norm_attn = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.gate = GATES[c.attn_layer](c.d_model)
        self.i_ffn0 = nn.Linear(c.d_model, c.dim_feedforward)
        self.i_ffn1 = nn.Linear(c.dim_feedforward, c.d_model)
        self.norm_i = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.p_ffn0 = nn.Linear(c.d_model, c.dim_feedforward)
        self.p_ffn1 = nn.Linear(c.dim_feedforward, c.d_model)
        self.norm_p = nn.LayerNorm(c.d_model, eps=LN_EPS)

    def forward(self, q_feat, q_i_feat, q_pos, ref_points, value, shapes,
                value_mask=None):
        def add_pos(t):
            return t + q_pos if q_pos is not None else t

        src2 = self.self_attn(add_pos(q_feat), ref_points, value, shapes,
                              i_query=add_pos(q_i_feat),
                              value_mask=value_mask)
        q_i_feat = self.norm_attn(q_i_feat + src2)
        q_feat, q_i_feat = self.gate(q_feat, q_i_feat)
        hi = self.i_ffn1(torch.relu(self.i_ffn0(q_i_feat)))
        q_i_feat = self.norm_i(q_i_feat + hi)
        hp = self.p_ffn1(torch.relu(self.p_ffn0(q_feat)))
        q_feat = self.norm_p(q_feat + hp)
        return q_feat, q_i_feat

    def image_only_parameters(self) -> list[nn.Parameter]:
        """The parameters that feed only the image-query output: the gate's
        image-side projection, the image FFN and its norm."""
        parts = (getattr(self.gate, self.gate.image_only), self.i_ffn0,
                 self.i_ffn1, self.norm_i)
        return [p for m in parts for p in m.parameters()]


class ACTR(nn.Module):
    """Top-level fusion module.

    Inputs (static shapes):
      q_feat       (B, Q, query_dim)        voxel (LiDAR) query features
      q_i_feat     (B, Q, image_query_dim)  image features at the voxels'
                                            projections
      q_ref_coors  (B, Q, 2)   normalized [0, 1] image-plane reference points
      q_lidar_grid (B, Q, 3)   metric voxel centers (x is the depth of the
                               position encoding; xyz feeds LT)
      q_mask       (B, Q)      valid-query mask
      i_feats      list of (B, H_l, W_l, C_l) camera feature maps
    Returns the enhanced voxel features (B, Q, d_model), zero where masked.
    """

    def __init__(self, cfg: ACTRConfig, query_dim: int,
                 image_query_dim: Optional[int],
                 image_channels: Sequence[int]):
        super().__init__()
        c = self.cfg = cfg
        if len(image_channels) != c.n_levels:
            raise ValueError("one image channel count per level")
        self.q_proj = nn.Linear(query_dim, c.d_model)
        self.uses_image_query = c.hybrid or c.q_method is not None
        if self.uses_image_query:
            self.i_input_proj = nn.Linear(image_query_dim, c.d_model)
        self.level_embed = nn.Parameter(torch.zeros(c.n_levels, c.d_model))
        for l, ch in enumerate(image_channels):
            # flax 1x1 Conv on a channel-last map == Linear
            self.add_module(f"input_proj{l}", nn.Linear(ch, c.d_model))
            self.add_module(f"input_gn{l}", nn.GroupNorm(
                min(32, c.d_model), c.d_model, eps=LN_EPS))
        layer_cls = FusionEncoderLayer if c.hybrid else EncoderLayer
        for i in range(c.num_layers):
            if c.model_name == "ACTRv2":
                self.add_module(f"lidar_attn{i}", LocalTransformer(
                    c.lt_npoint, c.lt_radius, c.lt_nsample, c.d_model,
                    c.lt_num_layers, feat_agg_method=c.lt_feat_agg))
            self.add_module(f"layer{i}", layer_cls(c))

    def forward(self, q_feat, q_i_feat, q_ref_coors, q_lidar_grid, q_mask,
                i_feats):
        c = self.cfg
        q = self.q_proj(q_feat)
        qi = self.i_input_proj(q_i_feat) if self.uses_image_query else None
        if c.pos_encode_method == "image_coor":
            q_pos = position_embedding_sine_sparse(q_ref_coors,
                                                   c.d_model // 2)
        else:  # depth sine on the forward distance
            q_pos = position_embedding_sine_depth(q_lidar_grid[..., 0],
                                                  c.d_model, c.max_depth)

        srcs, shapes = [], []
        for l, feat in enumerate(i_feats):
            b, h, w, _ = feat.shape
            s = getattr(self, f"input_proj{l}")(feat)
            gn = getattr(self, f"input_gn{l}")
            s = F.group_norm(s.permute(0, 3, 1, 2), gn.num_groups, gn.weight,
                             gn.bias, gn.eps).permute(0, 2, 3, 1)
            pos = position_embedding_sine_2d(h, w, c.d_model // 2,
                                             device=feat.device)
            s = s + pos[None] + self.level_embed[l]
            srcs.append(s.reshape(b, h * w, c.d_model))
            shapes.append((h, w))
        value = torch.cat(srcs, 1)
        shapes = tuple(shapes)
        ref = q_ref_coors[:, :, None, :].expand(-1, -1, c.n_levels, -1)

        for i in range(c.num_layers):
            if c.model_name == "ACTRv2":
                stages.mark("msda_actr")
                q = getattr(self, f"lidar_attn{i}")(q_lidar_grid, q, q_mask)
                stages.mark("lt")
            q, qi = getattr(self, f"layer{i}")(q, qi, q_pos, ref, value,
                                               shapes)
        return torch.where(q_mask[..., None], q, 0.0)

    def unreached_parameters(self) -> list[nn.Parameter]:
        """The parameters the output does not depend on: the last dual-query
        layer's image-only ones, whose image-query output nothing reads."""
        if not self.cfg.hybrid:
            return []
        last = getattr(self, f"layer{self.cfg.num_layers - 1}")
        return last.image_only_parameters()
