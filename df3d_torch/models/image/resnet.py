"""ResNet image backbone and the DeepLabV3 semantic branch (port of
df3d/models/image/resnet.py).

NCHW inside, as PyTorch's convolutions want; `SemDeepLabV3` takes and
returns channel-last maps like the JAX package. Every flax conv here pads
symmetrically by an explicit amount, which `nn.Conv2d(padding=...)`
reproduces; the BatchNorms are flax defaults (eps 1e-5, running
statistics in eval mode).

Only layer1..3 feed the fusion. Under `jit` XLA drops layer4, ASPP and the
classifier, whose results nobody reads; here they are computed only when
the caller asks for the logits. The parameters are there either way, so
every flax leaf has a home. The FPN branch (`ResNetFPN`) is not on the
CenterPoint + 3D-DF path and is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax BatchNorm default


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
