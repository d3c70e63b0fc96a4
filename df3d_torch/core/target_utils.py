"""CenterPoint heatmap targets on the device (port of df3d/core/target_utils.py).

Each ground-truth box renders a fixed (33, 33) gaussian window that is
scatter-maxed into its class's heatmap; every function here takes any
leading batch dims, where the JAX package vmaps one sample at a time.

One difference from the JAX package: a window cell left of the map (x < 0)
is dropped here, as every other off-map cell is. The JAX package sends it
to row H of a padded buffer, which is the last map row's far end
(`tests/test_torch_train_targets.py::test_draw_gaussians_left_edge`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from df3d_torch.core import ieee


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.5) -> torch.Tensor:
    """CornerNet radius such that any center within it keeps IoU >=
    min_overlap with the box (det3d center_utils.gaussian_radius)."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + ieee.sqrt((b1 ** 2 - 4 * c1).clamp_min(0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + ieee.sqrt((b2 ** 2 - 4 * 4.0 * c2).clamp_min(0.0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + ieee.sqrt((b3 ** 2 - 4 * a3 * c3).clamp_min(0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians(heatmap: torch.Tensor, centers: torch.Tensor,
                   radii: torch.Tensor, valid: torch.Tensor,
                   window: int = 33) -> torch.Tensor:
    """Scatter-max 2D gaussians into heatmaps.

    heatmap (..., H, W); centers (..., M, 2) float (x, y) in pixels; radii
    (..., M); valid (..., M) bool. Each gaussian (sigma = (2r + 1) / 6, the
    umich gaussian) is cut to |dx|, |dy| <= r inside a (window, window)
    patch around its rounded center; cells off the map are dropped."""
    h, w = heatmap.shape[-2:]
    lead = heatmap.shape[:-2]
    half = window // 2
    cx = torch.round(centers[..., 0]).to(torch.int64)
    cy = torch.round(centers[..., 1]).to(torch.int64)
    in_map = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & valid

    d = torch.arange(window, device=heatmap.device) - half
    dyy, dxx = torch.meshgrid(d, d, indexing="ij")   # (window, window)
    sigma = (2 * radii + 1) / 6.0
    s2 = (2 * sigma ** 2)[..., None, None]
    g = torch.exp(-(dxx ** 2 + dyy ** 2).to(heatmap.dtype) / s2)
    r = radii[..., None, None]
    keep = ((dxx.abs() <= r) & (dyy.abs() <= r) & in_map[..., None, None])

    ys = cy[..., None, None] + dyy
    xs = cx[..., None, None] + dxx
    keep &= (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    # dropped cells go to a spare slot at h * w
    flat = torch.where(keep, ys * w + xs, h * w).flatten(-3)
    vals = torch.where(keep, g, torch.zeros_like(g)).flatten(-3)
    out = heatmap.new_zeros(*lead, h * w + 1)
    out = out.scatter_reduce(-1, flat.expand(*lead, -1), vals.expand(
        *lead, -1), reduce="amax", include_self=True)
    return torch.maximum(heatmap, out[..., :h * w].view(*lead, h, w))


def assign_center_targets(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                          gt_valid: torch.Tensor, num_classes: int,
                          feature_size: tuple[int, int],
                          voxel_size: tuple[float, float],
                          pc_range: tuple[float, float],
                          out_size_factor: int, gaussian_overlap: float = 0.1,
                          min_radius: int = 2, max_objs: int = 500) -> dict:
    """CenterPoint targets of one task group (det3d AssignLabel).

    gt_boxes (..., M, 9) gravity-center boxes with velocity; gt_classes
    (..., M) in [0, num_classes); gt_valid (..., M). Returns heatmap
    (..., num_classes, H, W), anno_box (..., max_objs, 10) in the order
    (offset x, y, z, log dx, dy, dz, vx, vy, sin, cos), inds (..., max_objs)
    flat BEV index, mask (..., max_objs) and cats (..., max_objs)."""
    hh, ww = feature_size
    m = gt_boxes.shape[-2]
    if m > max_objs:
        raise ValueError(f"{m} boxes > max_objs {max_objs}")

    dx_pix = gt_boxes[..., 3] / voxel_size[0] / out_size_factor
    dy_pix = gt_boxes[..., 4] / voxel_size[1] / out_size_factor
    radius = gaussian_radius(dy_pix, dx_pix, gaussian_overlap)
    radius = torch.floor(radius).clamp_min(min_radius)

    x_pix = (gt_boxes[..., 0] - pc_range[0]) / voxel_size[0] / out_size_factor
    y_pix = (gt_boxes[..., 1] - pc_range[1]) / voxel_size[1] / out_size_factor
    xi = torch.floor(x_pix).to(torch.int64)
    yi = torch.floor(y_pix).to(torch.int64)
    ok = gt_valid & (dx_pix > 0) & (dy_pix > 0)
    ok &= (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)

    centers = torch.stack([x_pix, y_pix], -1)
    classes = torch.arange(num_classes, device=gt_boxes.device)
    sel = ok[..., None, :] & (gt_classes[..., None, :] == classes[:, None])
    heatmap = draw_gaussians(
        gt_boxes.new_zeros(*gt_boxes.shape[:-2], num_classes, hh, ww),
        centers[..., None, :, :], radius[..., None, :], sel)

    rot = gt_boxes[..., 6]
    log_dims = torch.log(gt_boxes[..., 3:6].clamp_min(1e-5))
    anno = torch.cat([
        torch.stack([x_pix - xi, y_pix - yi, gt_boxes[..., 2]], -1),
        log_dims, gt_boxes[..., 7:9],
        torch.stack([torch.sin(rot), torch.cos(rot)], -1)], -1)

    pad = max_objs - m
    inds = torch.where(ok, yi * ww + xi, torch.zeros_like(xi))
    cats = torch.where(ok, gt_classes.to(torch.int64), 0)
    return {
        "heatmap": heatmap,
        "anno_box": F.pad(anno, (0, 0, 0, pad)),
        "inds": F.pad(inds, (0, pad)),
        "mask": F.pad(ok, (0, pad)),
        "cats": F.pad(cats, (0, pad)),
    }
