"""Dual-query bidirectional gates between the LiDAR-query and image-query
streams (port of df3d/models/fusion/gates.py).

Each is a pair of 1x1 projections to a scalar sigmoid gate; the `_2`
variants gate on the sum of the streams, the `Sum` variants add the gated
other stream instead of multiplying.
"""

from __future__ import annotations

import torch
from torch import nn


class _Gate(nn.Module):
    # the projection whose gate scales only the image-query output
    image_only = "b_gate"

    def __init__(self, channels: int):
        super().__init__()
        self.a_gate = nn.Linear(channels, 1)
        self.b_gate = nn.Linear(channels, 1)


class BiGate1D(_Gate):
    image_only = "a_gate"

    def forward(self, a: torch.Tensor, b: torch.Tensor):
        ga = torch.sigmoid(self.a_gate(a))  # from a, applied to b
        gb = torch.sigmoid(self.b_gate(b))
        return a * gb, b * ga


class BiGate1D_2(_Gate):
    def forward(self, a: torch.Tensor, b: torch.Tensor):
        fused = a + b
        ga = torch.sigmoid(self.a_gate(fused))
        gb = torch.sigmoid(self.b_gate(fused))
        return a * ga, b * gb


class BiGateSum1D(_Gate):
    def forward(self, a: torch.Tensor, b: torch.Tensor):
        ga = torch.sigmoid(self.a_gate(a))
        gb = torch.sigmoid(self.b_gate(b))
        return a + b * ga, b + a * gb


class BiGateSum1D_2(_Gate):
    def forward(self, a: torch.Tensor, b: torch.Tensor):
        fused = a + b
        ga = torch.sigmoid(self.a_gate(fused))
        gb = torch.sigmoid(self.b_gate(fused))
        return a + b * ga, b + a * gb


GATES = {
    "BiGate1D": BiGate1D,
    "BiGate1D_2": BiGate1D_2,
    "BiGateSum1D": BiGateSum1D,
    "BiGateSum1D_2": BiGateSum1D_2,
}
