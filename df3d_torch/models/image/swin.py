"""Swin Transformer backbone, Swin-Tiny by default (port of
df3d/models/image/swin.py): the image branch of `transfusion_3ddf_swin_nusc`.

A 4x4 stride-4 patch embedding and its LayerNorm, four stages of
(shifted) window attention blocks with a relative position bias, and a
patch merge between stages; each stage's output goes through its own
LayerNorm (`out_norm{i}`) to the FPN. Channel-last throughout, as the JAX
package. Plain PyTorch: no kernel of the JAX package computes any of it.

What the JAX package does, and so the port:

* a block pads its input to window multiples before its first norm; the
  padded tokens become the norm's bias and are attended to (only the
  shift mask exists), and the crop comes after the MLP;
* the window is min(window, h, w) of the block's input and the shift is
  dropped unless 0 < shift < window. The relative bias table is sized by
  that window, so the module is built for one input size (`image_hw`);
* the shift mask labels the nine regions of the padded map and fills
  -1e9 between different labels; the bias is added before it;
* the patch merge pads odd maps and is position-major: the 2x2
  neighbours' channels are concatenated as (ih * 2 + iw) * C + c, not
  official Swin's x0/x1/x2/x3 order;
* flax's `gelu` is the tanh approximation and its LayerNorm eps 1e-6.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.models.layers import same_pads

LN_EPS = 1e-6  # flax LayerNorm default
NUM_HEADS = (3, 6, 12, 24)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w * w, C) windows, batch-major."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_merge(win: torch.Tensor, w: int, h: int, ww: int,
                 b: int) -> torch.Tensor:
    """The inverse of `window_partition`."""
    c = win.shape[-1]
    x = win.reshape(b, h // w, ww // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, c)


def relative_index(window: int) -> torch.Tensor:
    """(T, T) index into the ((2w-1)^2, heads) bias table: for tokens at
    (i0, j0) and (i1, j1) of a window, (i0 - i1 + w - 1) * (2w - 1) +
    (j0 - j1 + w - 1)."""
    i, j = torch.meshgrid(torch.arange(window), torch.arange(window),
                          indexing="ij")
    coords = torch.stack([i, j], -1).reshape(-1, 2)
    diff = coords[:, None] - coords[None, :] + window - 1
    return diff[..., 0] * (2 * window - 1) + diff[..., 1]


def shift_mask(h: int, w: int, win: int, shift: int,
               device) -> torch.Tensor:
    """(nW, T, T) additive mask of a shifted block on the padded (h, w)
    map: 0 between tokens of one region, -1e9 between two."""
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[:, hs, ws] = cnt
            cnt += 1
    mw = window_partition(img, win)[..., 0]
    same = mw[:, None, :] == mw[:, :, None]
    return torch.where(same, 0.0, -1e9)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows of `window` x `window`
    tokens, with a learned relative position bias per head."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", relative_index(window),
                             persistent=False)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (nW * B, T, C) window tokens; mask (nW, T, T) additive."""
        t, nh = self.window * self.window, self.num_heads
        hd = self.dim // nh
        q, k, v = self.qkv(x).chunk(3, -1)

        def heads(z):
            return z.reshape(*z.shape[:-1], nh, hd).transpose(-3, -2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        attn = attn + self.rel_bias[self.index].permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(-1, nw, nh, t, t) + mask[None, :, None]
            attn = attn.reshape(-1, nh, t, t)
        attn = attn.softmax(-1)
        out = (attn @ v).transpose(-3, -2).reshape(*x.shape[:-1], self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    """A (shifted) window attention block and its MLP, built for an (h, w)
    input."""

    def __init__(self, dim: int, num_heads: int, hw: tuple[int, int],
                 window: int = 7, shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.hw = tuple(hw)
        self.win = min(window, *self.hw)
        self.shift = shift if 0 < shift < self.win else 0
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, self.win)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp1 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h0, w0, _ = x.shape
        if (h0, w0) != self.hw:
            raise ValueError(f"SwinBlock built for {self.hw}, given "
                             f"{(h0, w0)}")
        win, shift = self.win, self.shift
        ph, pw = (-h0) % win, (-w0) % win
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        h, w = h0 + ph, w0 + pw
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = shift_mask(h, w, win, shift, x.device)
        y = self.attn(window_partition(y, win), mask)
        y = window_merge(y, win, h, w, b)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y
        z = self.mlp1(F.gelu(self.mlp0(self.norm2(x)), approximate="tanh"))
        return (x + z)[:, :h0, :w0]


class SwinTransformer(nn.Module):
    """Swin-T stages at strides 4, 8, 16 and 32 for (B, H, W, 3) images of
    size `image_hw`: `forward` returns the four stages' normed outputs,
    channel-last, `stage_channels` wide."""

    def __init__(self, image_hw: Sequence[int], embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = NUM_HEADS, window: int = 7):
        super().__init__()
        self.depths = tuple(depths)
        self.image_hw = tuple(image_hw)
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        h, w = (-(-s // 4) for s in self.image_hw)  # SAME, stride 4
        dim, channels = embed_dim, []
        for si, depth in enumerate(self.depths):
            if dim % num_heads[si]:
                raise ValueError(f"stage {si}: width {dim} does not divide "
                                 f"over {num_heads[si]} heads")
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinBlock(
                    dim, num_heads[si], (h, w), window,
                    shift=0 if bi % 2 == 0 else window // 2))
            self.add_module(f"out_norm{si}", nn.LayerNorm(dim, eps=LN_EPS))
            channels.append(dim)
            if si < len(self.depths) - 1:
                self.add_module(f"merge_norm{si}",
                                nn.LayerNorm(4 * dim, eps=LN_EPS))
                self.add_module(f"merge{si}",
                                nn.Linear(4 * dim, 2 * dim, bias=False))
                h, w, dim = -(-h // 2), -(-w // 2), 2 * dim
        self.stage_channels = tuple(channels)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)
        pads = [same_pads(s, 4, 4) for s in x.shape[2:]]
        x = F.pad(x, (*pads[1], *pads[0]))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            outs.append(getattr(self, f"out_norm{si}")(x))
            if si < len(self.depths) - 1:  # patch merge (odd maps padded)
                b, h, w, c = x.shape
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                h, w = h + h % 2, w + w % 2
                x = x.reshape(b, h // 2, 2, w // 2, 2, c)
                x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2,
                                                        4 * c)
                x = getattr(self, f"merge{si}")(
                    getattr(self, f"merge_norm{si}")(x))
        return outs
