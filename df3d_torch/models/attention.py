"""flax's `MultiHeadDotProductAttention` (no dropout), shared by LT's
encoder layers and TransFusion's decoder.

Two places where a literal PyTorch translation would differ from flax, both
kept here:

* flax takes the values from the key input when no separate value input is
  given, so `attn(q, kv)` projects `kv` for both keys and values; a caller
  that adds a position embedding to the key input adds it to the values too
  (TransFusion's `cross_attn(q + q_pos, kv + kv_pos)` does, as the
  reference TransFusion does);
* masked logits are filled with finfo(f32).min, so a query whose keys are
  all masked gets uniform weights instead of the NaN that -inf would give.

An additive `bias` (flax's `dot_product_attention(..., bias=)`: TransFusion
LC's view and log-gaussian bias) is added to the logits after the
1/sqrt(head_dim) scale and before the mask.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LN_EPS = 1e-6  # flax LayerNorm default


class FlaxMultiHeadAttention(nn.Module):
    """query/key/value/out projections with bias, logits over
    sqrt(head_dim)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, inputs_q: torch.Tensor,
                inputs_kv: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """inputs_q (..., Tq, C); inputs_kv (..., Tk, C), keys and values
        both (inputs_q when None); mask (..., Tk) True = valid key; bias
        broadcastable to the logits (..., heads, Tq, Tk)."""
        if inputs_kv is None:
            inputs_kv = inputs_q
        *lead, tq, c = inputs_q.shape
        tk = inputs_kv.shape[-2]
        h = self.num_heads
        hd = c // h
        q = self.query(inputs_q).view(*lead, tq, h, hd)
        k = self.key(inputs_kv).view(*lead, tk, h, hd)
        v = self.value(inputs_kv).view(*lead, tk, h, hd)
        q = q / math.sqrt(hd)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k)
        if bias is not None:
            logits = logits + bias
        if mask is not None:
            logits = logits.masked_fill(~mask[..., None, None, :],
                                        torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, -1)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(out.reshape(*lead, tq, c))
