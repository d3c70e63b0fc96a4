"""Detection losses (port of df3d/models/losses.py): only what decode needs."""

from __future__ import annotations

import torch


def clamped_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)
