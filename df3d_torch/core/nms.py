"""Rotated BEV NMS with static shapes (port of df3d/core/nms.py: `nms_bev`).

Fixed-size index buffers plus validity masks, like the JAX package. Every
function takes leading batch dims, so all (batch x task) problems of a
frame run through one call, as the JAX `vmap` does.
"""

from __future__ import annotations

import torch

from df3d_torch.core.iou import iou_bev, iou_bev_chunked

_NEG_INF = -1e9
_CHECK_EVERY = 8


def _greedy_suppress(mat: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS over candidates sorted by descending score.

    mat (..., K, K) pairwise overlap -> bool keep (..., K), the same set as
    the JAX package's sequential loop (candidate i, if kept, suppresses every
    later j with mat[i, j] > thresh).

    The loop runs on the device as a fixed-point iteration instead of K
    sequential steps: keep[j] = not any(keep[i] and over[i, j] for i < j)
    has exactly one solution (keep[j] depends only on earlier entries), and
    iterating it from all-kept fixes at least one more leading entry per
    round, so it reaches that solution in at most K rounds: as many as the
    longest chain of candidates that each overlap the next. Convergence is
    read back to the host once every `_CHECK_EVERY` rounds, not every round.
    """
    k = mat.shape[-1]
    upper = torch.ones(k, k, dtype=torch.bool, device=mat.device).triu(1)
    over = (mat > thresh) & upper
    keep = torch.ones(mat.shape[:-1], dtype=torch.bool, device=mat.device)
    for _ in range(0, k + 1, _CHECK_EVERY):
        prev = keep
        for _ in range(_CHECK_EVERY):
            keep = ~(over & keep[..., :, None]).any(-2)
        if torch.equal(keep, prev):
            break
    return keep


def top_k_stable(scores: torch.Tensor, k: int):
    """Top-k along the last dim, ties broken by the lower index first (the
    order of `jax.lax.top_k`; `torch.topk` promises no tie order)."""
    vals, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            pre_max_size: int, post_max_size: int,
            valid: torch.Tensor | None = None, chunk: int = 256):
    """Rotated BEV NMS.

    boxes (..., N, 7), scores (..., N) -> (indices (..., post_max_size),
    mask (..., post_max_size)). Indices point into the original boxes;
    the mask marks real detections. `valid` masks padding rows.
    """
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    k = min(pre_max_size, boxes.shape[-2])
    if k > chunk:
        k = (k // chunk) * chunk  # round down so the chunked IoU tiles evenly
    top_scores, order = top_k_stable(scores, k)
    cand = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    cand_valid = top_scores > _NEG_INF / 2

    if k % chunk == 0 and k > chunk:
        mat = iou_bev_chunked(cand, cand, chunk=chunk)
    else:
        mat = iou_bev(cand, cand)
    keep = _greedy_suppress(mat, thresh) & cand_valid

    # stable-select kept candidates into the first post_max_size slots;
    # slot post_max_size collects the rest and is dropped
    rank = torch.cumsum(keep.long(), -1) - 1
    pos = torch.where(keep & (rank < post_max_size), rank,
                      torch.full_like(rank, post_max_size))
    out_idx = torch.zeros(*order.shape[:-1], post_max_size + 1,
                          dtype=torch.long, device=order.device)
    out_idx.scatter_(-1, pos, order)
    slots = torch.arange(post_max_size, device=keep.device)
    out_mask = slots < keep.sum(-1, keepdim=True)
    return out_idx[..., :post_max_size], out_mask
