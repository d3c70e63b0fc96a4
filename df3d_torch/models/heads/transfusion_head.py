"""TransFusion-L's query-decoder head (port of
df3d/models/heads/transfusion_head.py).

dense heatmap -> 3x3 max-pool peaks (every pixel of a small class is a
peak) -> top-`num_proposals` queries over the class-major flattened peaks,
with a class embedding -> one transformer decoder layer over the BEV
features, with learned position embeddings of the BEV pixels -> FFN
branches -> `transfusion_get_bboxes` (serving: all queries decoded, no
NMS) or `transfusion_targets_and_loss` (training: Hungarian assignment of
the queries to the boxes, focal, L1 and Gaussian focal losses).

Where a literal PyTorch translation would differ from flax, kept here and
pinned by tests/test_torch_transfusion.py: ties in the top-k (all
non-peaks are exactly 0) go to the lower index first, as `jax.lax.top_k`
orders them (`core.nms.top_k_stable`); the peak test compares the heatmap
with its max-pool exactly, both padding with -inf; flax attention takes its
values from the key input (`models.attention`); BatchNorms over the last
axis of (B, P, C) and LayerNorms use flax's epsilons (1e-5, 1e-6), and in
training every BatchNorm keeps flax's biased running variance at flax's
momentum (0.9 for the position embeddings and the FFN branches, 0.99 for
the heatmap branch).
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
from df3d_torch.core.iou import iou_3d
from df3d_torch.core.nms import top_k_stable
from df3d_torch.core.target_utils import draw_gaussians, gaussian_radius
from df3d_torch.models.attention import LN_EPS, FlaxMultiHeadAttention
from df3d_torch.models.layers import FlaxBatchNorm, FlaxBatchNorm2d
from df3d_torch.models.losses import gaussian_focal_loss, sigmoid_focal_loss
from df3d_torch.ops.assign import hungarian_match
from df3d_torch.parallel import ddp
from df3d_torch.utils import stages

BN_EPS = 1e-5  # flax BatchNorm default
FFN_BN_MOMENTUM = 0.9  # the position embeddings' and FFN branches' norms
HEATMAP_PRIOR = -2.19
# (name, out channels) of the FFN branches, in the JAX package's order
BRANCHES = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2),
            ("vel", 2))


@dataclasses.dataclass(frozen=True)
class TransFusionHeadCfg:
    """The JAX package's `TransFusionHeadCfg`."""

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
    code_weights: tuple = (1.0,) * 8 + (0.2, 0.2)
    # assignment costs (HungarianAssigner3D)
    cls_cost_weight: float = 0.15
    reg_cost_weight: float = 0.25
    iou_cost_weight: float = 0.25
    # losses
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 0.25
    loss_heatmap_weight: float = 1.0
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    head_conv: int = 64  # FFN mid channels

    @property
    def coder(self) -> TransFusionBBoxCoder:
        return TransFusionBBoxCoder(
            pc_range=self.pc_range, voxel_size=self.voxel_size,
            out_size_factor=self.out_size_factor)


class PositionEmbeddingLearned(nn.Module):
    """Dense -> BatchNorm -> ReLU -> Dense over the point axis."""

    def __init__(self, in_dim: int, d_model: int):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, d_model)
        self.bn = FlaxBatchNorm(d_model, BN_EPS, FFN_BN_MOMENTUM)
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


def local_peaks(heatmap: torch.Tensor, cfg: TransFusionHeadCfg
                ) -> torch.Tensor:
    """The query candidates of a (B, ncls, H, W) heatmap: cells equal to
    the max of their `nms_kernel_size` window (max_pool2d pads with -inf,
    as flax's max_pool does), and every cell of the small classes."""
    k = cfg.nms_kernel_size
    local_max = F.max_pool2d(heatmap, k, stride=1, padding=k // 2)
    is_peak = heatmap == local_max
    is_peak[:, list(cfg.small_classes)] = True
    return is_peak


class TransFusionHead(nn.Module):
    def __init__(self, cfg: TransFusionHeadCfg, in_channels: int):
        super().__init__()
        self.cfg = c = cfg
        d = c.hidden_channel
        self.shared_conv = nn.Conv2d(in_channels, d, 3, padding=1)
        self.hm_conv0 = nn.Conv2d(d, d, 3, padding=1, bias=False)
        self.hm_bn = FlaxBatchNorm2d(d, BN_EPS)
        self.hm_conv1 = nn.Conv2d(d, c.num_classes, 3, padding=1)
        self.class_encoding = nn.Linear(c.num_classes, d)
        self.query_pos_embed = PositionEmbeddingLearned(2, d)
        self.key_pos_embed = PositionEmbeddingLearned(2, d)
        self.decoder0 = DecoderLayer(d, c.num_heads, c.ffn_channel)
        for name, ch in BRANCHES + (("cls", c.num_classes),):
            self.add_module(f"{name}_fc0",
                            nn.Linear(d, c.head_conv, bias=False))
            self.add_module(f"{name}_bn0", FlaxBatchNorm(
                c.head_conv, BN_EPS, FFN_BN_MOMENTUM))
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
        peaks = torch.where(local_peaks(heatmap, c), heatmap, 0.0)
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
        # (in training its batch statistics are those of the B equal rows
        # the JAX package normalises, up to rounding)
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


def _decoded_boxes(cfg: TransFusionHeadCfg, preds) -> torch.Tensor:
    """Every query's box, (B, P, 9) gravity-centre 9-dof."""
    dec = cfg.coder.decode(
        preds["center"], preds["height"], preds["dim"],
        preds["rot"][..., 0], preds["rot"][..., 1], preds["vel"])
    z = dec[..., 2] + 0.5 * dec[..., 5]  # bottom -> gravity centre
    return torch.cat([dec[..., :2], z[..., None], dec[..., 3:]], -1)


def assignment_cost(cfg: TransFusionHeadCfg, cls_logits: torch.Tensor,
                    boxes: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_classes: torch.Tensor) -> torch.Tensor:
    """The Hungarian cost of each (query, box) pair, (B, P, M):
    mmdet's FocalLossCost at the box's class, the L1 distance of the BEV
    centres normalised by the map's extent (BBoxBEVL1Cost), and minus the
    3D IoU (IoU3DCost), weighted. boxes (B, P, 9) the decoded queries,
    gt_boxes (B, M, 9), both gravity-centre."""
    hh, ww = cfg.bev_size
    eps = 1e-12
    pg = torch.sigmoid(cls_logits)
    neg_cost = -torch.log(1 - pg + eps) * 0.75 * pg ** 2
    pos_cost = -torch.log(pg + eps) * 0.25 * (1 - pg) ** 2
    cls_cost = (pos_cost - neg_cost).gather(
        2, gt_classes.long()[:, None, :].expand(-1, pg.shape[1], -1))
    pr = boxes.new_tensor(cfg.pc_range)
    extent = boxes.new_tensor(
        [cfg.voxel_size[0] * cfg.out_size_factor * ww,
         cfg.voxel_size[1] * cfg.out_size_factor * hh])
    p_xy = (boxes[..., :2] - pr) / extent
    g_xy = (gt_boxes[..., :2] - pr) / extent
    reg_cost = (p_xy[:, :, None, :] - g_xy[:, None, :, :]).abs().sum(-1)
    iou = iou_3d(boxes[..., :7], gt_boxes[..., :7])
    return (cfg.cls_cost_weight * cls_cost + cfg.reg_cost_weight * reg_cost
            + cfg.iou_cost_weight * (-iou))


def gaussian_heatmap_targets(cfg: TransFusionHeadCfg, gt_boxes, gt_classes,
                             gt_valid) -> torch.Tensor:
    """The dense heatmap's targets, (B, ncls, H, W): each valid box of
    positive BEV size renders a Gaussian of radius max(min_radius,
    floor(gaussian_radius(dy, dx, overlap))) in pixels at its centre, in
    its class's map (`core.target_utils.draw_gaussians`, which drops the
    cells off the map, also those left of it)."""
    hh, ww = cfg.bev_size
    vx, vy = cfg.voxel_size
    osf = cfg.out_size_factor
    dx_pix = gt_boxes[..., 3] / vx / osf
    dy_pix = gt_boxes[..., 4] / vy / osf
    radius = torch.floor(gaussian_radius(dy_pix, dx_pix,
                                         cfg.gaussian_overlap))
    radius = radius.clamp_min(cfg.min_radius)
    x_pix = (gt_boxes[..., 0] - cfg.pc_range[0]) / vx / osf
    y_pix = (gt_boxes[..., 1] - cfg.pc_range[1]) / vy / osf
    centers = torch.stack([x_pix, y_pix], -1)
    classes = torch.arange(cfg.num_classes, device=gt_boxes.device)
    ok = gt_valid & (dx_pix > 0) & (dy_pix > 0)
    sel = ok[:, None, :] & (gt_classes[:, None, :] == classes[:, None])
    return draw_gaussians(
        gt_boxes.new_zeros(gt_boxes.shape[0], cfg.num_classes, hh, ww),
        centers[:, None], radius[:, None], sel)


def transfusion_targets_and_loss(cfg: TransFusionHeadCfg, preds, gt_boxes,
                                 gt_classes, gt_valid):
    """Hungarian assignment and losses of one batch (the reference's
    get_targets_single and loss).

    gt_boxes (B, M, 9) gravity-centre 9-dof boxes, gt_classes (B, M),
    gt_valid (B, M). The cost is computed without gradients and assigned on
    the host (`ops.assign.hungarian_match`). A matched query's class target
    is its box's one-hot, every other query's all zeros; the focal loss on
    the classes and the code-weighted L1 on the encoded boxes (matched
    queries only) are divided by the matches over the batch (at least 1),
    the Gaussian focal loss on the dense heatmap by its peak cells (at
    least 1); both counts are over the global batch
    (`parallel.ddp.global_sum`). -> (total, logs: tf_cls_loss,
    tf_bbox_loss, tf_hm_loss, tf_matched, loss)."""
    coder = cfg.coder
    # the coder takes bottom-centre boxes
    gt_z = gt_boxes[..., 2] - 0.5 * gt_boxes[..., 5]
    gt_enc = coder.encode(torch.cat(
        [gt_boxes[..., :2], gt_z[..., None], gt_boxes[..., 3:]], -1))
    pred_box = torch.cat([preds["center"], preds["height"][..., None],
                          preds["dim"], preds["rot"], preds["vel"]], -1)

    with torch.no_grad():
        cost = assignment_cost(cfg, preds["cls"], _decoded_boxes(cfg, preds),
                               gt_boxes, gt_classes)
        matched = hungarian_match(cost, gt_valid)  # (B, P), -1 unmatched
    stages.mark("assign")

    pos_mask = matched >= 0
    safe_gt = matched.clamp_min(0)
    tgt_cls = gt_classes.long().gather(1, safe_gt)
    one_hot = (F.one_hot(tgt_cls, cfg.num_classes).to(pred_box.dtype)
               * pos_mask[..., None])
    num_pos = ddp.global_sum(
        pos_mask.sum().to(pred_box.dtype)).clamp_min(1.0)
    cls_loss = sigmoid_focal_loss(preds["cls"], one_hot,
                                  torch.ones_like(one_hot[..., 0])
                                  ).sum() / num_pos

    tgt_box = gt_enc.gather(1, safe_gt[..., None].expand(
        -1, -1, gt_enc.shape[-1]))
    bbox_l = (pred_box - tgt_box).abs() * pred_box.new_tensor(
        cfg.code_weights)
    bbox_loss = (bbox_l * pos_mask[..., None]).sum() / num_pos

    gt_hm = gaussian_heatmap_targets(cfg, gt_boxes, gt_classes, gt_valid)
    pred_hm = torch.clamp(torch.sigmoid(preds["dense_heatmap"]).permute(
        0, 3, 1, 2), 1e-4, 1 - 1e-4)
    hm_loss = gaussian_focal_loss(pred_hm, gt_hm).sum() / ddp.global_sum(
        (gt_hm == 1).sum().to(pred_hm.dtype)).clamp_min(1.0)

    total = (cfg.loss_cls_weight * cls_loss
             + cfg.loss_bbox_weight * bbox_loss
             + cfg.loss_heatmap_weight * hm_loss)
    return total, {
        "tf_cls_loss": cls_loss, "tf_bbox_loss": bbox_loss,
        "tf_hm_loss": hm_loss,
        "tf_matched": pos_mask.sum(dtype=torch.int32), "loss": total,
    }


def transfusion_get_bboxes(cfg: TransFusionHeadCfg, preds):
    """Every query decoded, no NMS: boxes (B, P, 9) gravity-centre 9-dof,
    scores = max class probability x the heatmap score at the query's
    label, labels = the argmax class."""
    cls_prob = torch.sigmoid(preds["cls"])
    hm_score = preds["query_score"].gather(
        -1, preds["query_labels"][..., None])[..., 0]
    # argmax takes the first of equal maxima, as jnp.argmax does
    return {"boxes": _decoded_boxes(cfg, preds),
            "scores": cls_prob.amax(-1) * hm_score,
            "labels": cls_prob.argmax(-1)}
