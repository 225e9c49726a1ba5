"""HRNet-16 trunk, the InverseForm backbone's network (counterpart of
``routeformer_tpu/models/video_backbone/hrnet.py``).

The reference's LightHRNet with the HR16 stage config: a stem of two
stride-2 3x3 convs to 64 channels (1/4 resolution); stage 1, two
Bottleneck blocks (64 -> 256); stages 2-4, parallel branches of (16, 32,
64, 128) channels with two BASIC blocks per branch per module, (1, 3, 2)
modules, and an all-to-all SUM fusion (a 1x1 conv and a bilinear upsample
from coarse to fine, chains of stride-2 3x3 convs from fine to coarse).
The output is all four branches resized to the finest and concatenated:
240 channels at 1/4 resolution.

Module names follow the flax paths (``transition1.mods.0.mods.0``,
``stage2.0.fuse_layers.0_1.1``, ...), so ``load_flax_params`` carries a JAX
trunk across and ``convert.load_hrnet_torch`` maps the torch checkpoint's
names. The convs run NCHW (cuDNN on the card); the trunk takes and returns
channel-last maps. BatchNorm is flax's (``patchtst.BatchNorm``, momentum
0.9, eps 1e-5): batch statistics and an update of the running ones (the
biased variance) in train mode, even while the trunk is frozen, the
running ones in eval; on a mesh with several data shards the global
batch's. The resizes are bilinear with half-pixel centres
(``F.interpolate(align_corners=False)``, antialiased where they shrink,
as ``jax.image.resize``).
"""

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.gps_backbone.patchtst import BatchNorm

BN_MOMENTUM = 0.9  # flax's momentum: torch's 0.1
HR16_CHANNELS = (16, 32, 64, 128)
HR16_MODULES = (1, 3, 2)  # stages 2, 3, 4


def _conv(c_in, c_out, kernel, stride):
    return nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=kernel // 2, bias=False)


def _bn(c):
    return BatchNorm(c, momentum=BN_MOMENTUM, eps=1e-5, axis=1)


def resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of an NCHW map, ``jax.image.resize``'s."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def _pair(conv, bn):
    return nn.ModuleDict({"0": conv, "1": bn})


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1)
        self.bn2 = _bn(planes)
        self.downsample = (_pair(_conv(inplanes, planes, 1, stride), _bn(planes))
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x
        if self.downsample is not None:
            residual = self.downsample["1"](self.downsample["0"](x))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = (_pair(_conv(inplanes, planes * 4, 1, stride), _bn(planes * 4))
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample is not None:
            residual = self.downsample["1"](self.downsample["0"](x))
        return F.relu(out + residual)


class ConvBnSeq(nn.Module):
    """(conv, bn[, relu]) steps under torch-style indices ``mods.{2i}`` and
    ``mods.{2i+1}``; ``specs``: (c_in, c_out, stride, relu) per step."""

    def __init__(self, specs):
        super().__init__()
        mods = {}
        self.relus = []
        for i, (c_in, c_out, stride, relu) in enumerate(specs):
            mods[str(2 * i)] = _conv(c_in, c_out, 3, stride)
            mods[str(2 * i + 1)] = _bn(c_out)
            self.relus.append(relu)
        self.mods = nn.ModuleDict(mods)

    def forward(self, x):
        for i, relu in enumerate(self.relus):
            x = self.mods[str(2 * i + 1)](self.mods[str(2 * i)](x))
            if relu:
                x = F.relu(x)
        return x


class HRModule(nn.Module):
    """One exchange unit: per-branch block chains and the all-to-all SUM
    fusion (``fuse_layers["i_j"]``: branch j's contribution to output i)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 2):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.ModuleList(BasicBlock(c, c) for _ in range(num_blocks)) for c in channels)
        fuse = {}
        for i in range(n):
            for j in range(n):
                if j > i:
                    fuse[f"{i}_{j}"] = _pair(_conv(channels[j], channels[i], 1, 1),
                                             _bn(channels[i]))
                elif j < i:
                    fuse[f"{i}_{j}"] = ConvBnSeq([
                        (channels[j], channels[i] if k == i - j - 1 else channels[j], 2,
                         k != i - j - 1) for k in range(i - j)])
        self.fuse_layers = nn.ModuleDict(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for branch, x in zip(self.branches, xs):
            for block in branch:
                x = block(x)
            outs.append(x)
        fused = []
        for i, y in enumerate(outs):
            h, w = y.shape[2:]
            for j, x in enumerate(outs):
                if j == i:
                    continue
                f = self.fuse_layers[f"{i}_{j}"]
                y = y + (resize_to(f["1"](f["0"](x)), h, w) if j > i else f(x))
            fused.append(F.relu(y))
        return fused


class Transition(nn.Module):
    """Branch-set transition: a conv where a branch changes width, a chain
    of stride-2 convs from the coarsest branch for each new one."""

    def __init__(self, pre: Sequence[int], cur: Sequence[int]):
        super().__init__()
        self.n_pre, self.n_cur = len(pre), len(cur)
        mods = {}
        for i in range(len(cur)):
            if i < len(pre):
                if cur[i] != pre[i]:
                    mods[str(i)] = ConvBnSeq([(pre[i], cur[i], 1, True)])
            else:
                mods[str(i)] = ConvBnSeq([
                    (pre[-1], cur[i] if j == i - len(pre) else pre[-1], 2, True)
                    for j in range(i + 1 - len(pre))])
        self.mods = nn.ModuleDict(mods)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i in range(self.n_cur):
            if str(i) in self.mods:
                out.append(self.mods[str(i)](xs[i] if i < self.n_pre else xs[-1]))
            else:
                out.append(xs[i])
        return out


class HighResolutionNet16(nn.Module):
    """The HR16 trunk: ``(N, H, W, 3) -> (N, H/4, W/4, 240)``."""

    def __init__(self):
        super().__init__()
        ch = HR16_CHANNELS
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = _bn(64)
        self.layer1 = nn.ModuleList([Bottleneck(64, 64, has_downsample=True),
                                     Bottleneck(256, 64)])
        self.transition1 = Transition((256,), ch[:2])
        self.stage2 = nn.ModuleList(HRModule(ch[:2]) for _ in range(HR16_MODULES[0]))
        self.transition2 = Transition(ch[:2], ch[:3])
        self.stage3 = nn.ModuleList(HRModule(ch[:3]) for _ in range(HR16_MODULES[1]))
        self.transition3 = Transition(ch[:3], ch)
        self.stage4 = nn.ModuleList(HRModule(ch) for _ in range(HR16_MODULES[2]))
        self.high_level_ch = sum(ch)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for block in self.layer1:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor, stop_before_stage4: bool = False) -> torch.Tensor:
        """``stop_before_stage4`` detaches the branches before stage 4: the
        reference's partial freeze, only stage 4 trains."""
        xs = self.transition1([self.stem(x.permute(0, 3, 1, 2))])
        for module in self.stage2:
            xs = module(xs)
        xs = self.transition2(xs)
        for module in self.stage3:
            xs = module(xs)
        xs = self.transition3(xs)
        if stop_before_stage4:
            xs = [f.detach() for f in xs]
        for module in self.stage4:
            xs = module(xs)
        h, w = xs[0].shape[2:]
        out = torch.cat([xs[0]] + [resize_to(f, h, w) for f in xs[1:]], dim=1)
        return out.permute(0, 2, 3, 1)
