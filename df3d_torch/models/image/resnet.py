"""ResNet image backbone, the DeepLabV3 semantic branch and ResNet + FPN
(port of df3d/models/image/resnet.py).

NCHW inside, as PyTorch's convolutions want; `SemDeepLabV3` and
`ResNetFPN` take and return channel-last maps like the JAX package. Every
flax conv here pads symmetrically by an explicit amount, which
`nn.Conv2d(padding=...)` reproduces; the BatchNorms are flax defaults (eps
1e-5, running statistics in eval mode).

Under `jit` XLA drops what nobody reads; here it is not computed: DeepLabV3's
layer4, ASPP and classifier unless the caller asks for the logits, and the
FPN outputs past the levels the caller asks for. The parameters are there
either way, so every flax leaf has a home.

FPN's top-down upsampling is `jax.image.resize(..., "nearest")`, which
samples at half-pixel centres: torch's `mode="nearest-exact"`, not
`"nearest"` (4 -> 7 gives [0 0 1 2 2 3 3] against [0 0 1 1 2 2 3]). The
two agree where every ratio is 2, as at 448x800.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax BatchNorm default
FPN_CHANNELS = 256
FPN_OUTS = 5  # P2..P6


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(in_channels, out_ch, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = _bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return torch.relu(h + identity)


class ResNet(nn.Module):
    """Stage features {'layer1': C2, ..., 'layer4': C5} on NCHW input."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int | None = None):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if output_stride == 8:
            strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
        c = 64
        for i, (n, p) in enumerate(zip(self.layers, (64, 128, 256, 512))):
            for j in range(n):
                self.add_module(f"layer{i + 1}_{j}", Bottleneck(
                    c, p, stride=strides[i] if j == 0 else 1,
                    dilation=dilations[i], downsample=(j == 0)))
                c = p * 4

    def forward(self, x: torch.Tensor, num_stages: int = 4):
        """The first `num_stages` stages' outputs."""
        h = torch.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = {}
        for i in range(num_stages):
            for j in range(self.layers[i]):
                h = getattr(self, f"layer{i + 1}_{j}")(h)
            outs[f"layer{i + 1}"] = h
        return outs


class FPN(nn.Module):
    """mmdet-style FPN over C2..C5 -> P2..P6 (P6 the stride-2 subsample of
    P5), FPN_CHANNELS wide, NCHW."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        self.num_ins = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(c, FPN_CHANNELS, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(FPN_CHANNELS, FPN_CHANNELS,
                                                 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor],
                levels: int = FPN_OUTS) -> list[torch.Tensor]:
        """The first `levels` outputs."""
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:],
                mode="nearest-exact")
        outs = [getattr(self, f"fpn{i}")(laterals[i])
                for i in range(min(levels, self.num_ins))]
        while len(outs) < levels:  # extra levels: max-pool 1x1, stride 2
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class ResNetFPN(nn.Module):
    """mmdet ResNet-50 (output stride 32) + FPN: TransFusion's image
    branch."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.backbone = ResNet(layers)
        self.neck = FPN([256 * 2 ** i for i in range(4)])

    def forward(self, images: torch.Tensor,
                levels: int = FPN_OUTS) -> list[torch.Tensor]:
        """images (B, H, W, 3), already normalized -> the first `levels`
        FPN outputs, channel-last."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        outs = self.neck([feats[f"layer{i + 1}"] for i in range(4)], levels)
        return [o.permute(0, 2, 3, 1) for o in outs]


class ASPP(nn.Module):
    """DeepLabV3 atrous spatial pyramid pooling head, NCHW."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn0 = _bn(out_channels)
        self.rates = tuple(rates)
        for i, r in enumerate(self.rates):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                in_channels, out_channels, 3, padding=r, dilation=r,
                bias=False))
            self.add_module(f"bn{i + 1}", _bn(out_channels))
        self.gp_conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.gp_bn = _bn(out_channels)
        self.project = nn.Conv2d(out_channels * (len(self.rates) + 2),
                                 out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [torch.relu(self.bn0(self.conv0(x)))]
        for i in range(len(self.rates)):
            c = getattr(self, f"conv{i + 1}")(x)
            branches.append(torch.relu(getattr(self, f"bn{i + 1}")(c)))
        gp = x.mean(dim=(2, 3), keepdim=True)
        gp = torch.relu(self.gp_bn(self.gp_conv(gp)))
        branches.append(gp.expand(-1, -1, *x.shape[2:]))
        h = torch.cat(branches, 1)
        return torch.relu(self.project_bn(self.project(h)))


class SemDeepLabV3(nn.Module):
    """DeepLabV3 semantic branch with 1x1 channel-reduced taps on
    layer1..3 (output stride 8)."""

    def __init__(self, num_classes: int = 21,
                 feat_extract_layers: Sequence[str] = ("layer1", "layer2",
                                                       "layer3"),
                 reduce_channels: Sequence[int] = (32, 64, 128),
                 backbone_layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.feat_extract_layers = tuple(feat_extract_layers)
        self.backbone = ResNet(backbone_layers, output_stride=8)
        widths = {f"layer{i + 1}": 256 * 2 ** i for i in range(4)}
        for name, ch in zip(self.feat_extract_layers, reduce_channels):
            self.add_module(f"reduce_{name}",
                            nn.Conv2d(widths[name], ch, 1, bias=False))
            self.add_module(f"reduce_bn_{name}", _bn(ch))
        self.aspp = ASPP(widths["layer4"])
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, images: torch.Tensor, with_logits: bool = False):
        """images (B, H, W, 3), already normalized -> {'layer1', 'layer2',
        'layer3'} channel-last taps, plus 'logits' when asked for."""
        x = images.permute(0, 3, 1, 2)
        need = max(int(n[len("layer"):]) for n in self.feat_extract_layers)
        feats = self.backbone(x, 4 if with_logits else need)
        out = {}
        for name in self.feat_extract_layers:
            r = getattr(self, f"reduce_{name}")(feats[name])
            r = torch.relu(getattr(self, f"reduce_bn_{name}")(r))
            out[name] = r.permute(0, 2, 3, 1)
        if with_logits:
            h = self.aspp(feats["layer4"])
            out["logits"] = self.classifier(h).permute(0, 2, 3, 1)
        return out
