"""CGNet transient-object mask network
(``crnerf_tpu/models/cgnet.py`` ``ContextGuidedNetwork`` with classes=1,
M=2, N=2, input_channel=3, and either norm: 'batch', the reference's, or
'group').

BatchNorm has eps = 1e-3 (the flax module's; torch's default is 1e-5). In
eval mode it uses its running statistics. In training mode it follows the
JAX train step, which maps CGNet over the grids of a step one image at a
time: every sample of the batch is normalised with its own statistics over
H x W (a plain ``BatchNorm2d`` over the batch would mix the grids), the
variance is the biased one, E[x^2] - E[x]^2, and the forward leaves the
running statistics alone. It adds each sample's statistics to a pending sum
instead; the train step moves the running statistics once per step by
their mean over all grids, through ``update_running_stats`` (flax momentum 0.9 = torch
momentum 0.1, and the running variance takes the biased batch variance,
where ``nn.BatchNorm2d`` would store the unbiased one).

GroupNorm (``norm='group'``) is flax's ``nn.GroupNorm`` as the JAX
``_Norm`` builds it: the first of 8, 4, 2, 1 groups that divides C, eps
1e-6, the statistics of each sample over its group's channels and H x W by
flax's formula, E[x^2] - E[x]^2 clamped at 0, and the same computation in
training and eval: no running statistics, nothing pending. Written out, not
``F.group_norm`` (Welford's variance, another computation); its backward is
broadcasts and reductions, no atomics, so it gives the same bits twice on
the card.

The depthwise 3x3 convs are ``groups=C`` convs with zero padding d and
dilation d. Child names follow the flax module (``Conv_0``,
``_Norm_0.BatchNorm_0`` or ``_Norm_0.GroupNorm_0``, ``PReLU_0``,
``FGlo_0``...) so the weight bridge is a rename.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from crnerf_tpu_torch.models.common import (
    IEEEConv2d,
    PReLU,
    linear,
    nchw,
    nhwc,
    resize_bilinear,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.1   # torch convention: new = 0.9 * old + 0.1 * batch
GN_EPS = 1e-6       # flax nn.GroupNorm's default
NORMS = ("batch", "group")


class _Norm(nn.Module):
    def __init__(self, channels: int, kind: str = "batch"):
        super().__init__()
        if kind not in NORMS:
            raise ValueError(f"norm {kind!r} is not one of {NORMS}")
        self.kind = kind
        if kind == "group":
            groups = next(g for g in (8, 4, 2, 1) if channels % g == 0)
            self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=GN_EPS)
            return
        self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=BN_EPS,
                                          momentum=BN_MOMENTUM)
        # sums over the samples seen since update_running_stats of their
        # (mean, variance), and how many samples: bounded however often
        # the forward runs
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None

    def forward(self, x):
        if self.kind == "group":
            return self._group(x)
        bn = self.BatchNorm_0
        if not self.training:
            return bn(x)
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=(2, 3), keepdim=True)
                              - mean * mean, 0.0)
        m_sum, v_sum, n = self.pending or (0.0, 0.0, 0)
        self.pending = (m_sum + mean.detach()[:, :, 0, 0].sum(0),
                        v_sum + var.detach()[:, :, 0, 0].sum(0),
                        n + x.shape[0])
        mul = torch.rsqrt(var + bn.eps) * bn.weight[None, :, None, None]
        return (x - mean) * mul + bn.bias[None, :, None, None]

    def _group(self, x):
        gn = self.GroupNorm_0
        n, c, h, w = x.shape
        g = gn.num_groups
        xg = x.reshape(n, g, c // g, h, w)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min((xg * xg).mean(dim=(2, 3, 4), keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + gn.eps) * gn.weight.view(1, g, c // g, 1, 1)
        y = (xg - mean) * mul + gn.bias.view(1, g, c // g, 1, 1)
        return y.reshape(n, c, h, w)


class ConvBNPReLU(nn.Module):
    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1,
                 norm: str = "batch"):
        super().__init__()
        self.Conv_0 = IEEEConv2d(n_in, n_out, k, stride, (k - 1) // 2,
                                bias=False)
        self._Norm_0 = _Norm(n_out, norm)
        self.PReLU_0 = PReLU(n_out)

    def forward(self, x):
        return self.PReLU_0(self._Norm_0(self.Conv_0(x)))


class BNPReLU(nn.Module):
    def __init__(self, channels: int, norm: str = "batch"):
        super().__init__()
        self._Norm_0 = _Norm(channels, norm)
        self.PReLU_0 = PReLU(channels)

    def forward(self, x):
        return self.PReLU_0(self._Norm_0(x))


def _depthwise(channels: int, dilation: int) -> IEEEConv2d:
    return IEEEConv2d(channels, channels, 3, padding=dilation,
                     dilation=dilation, groups=channels, bias=False)


class FGlo(nn.Module):
    """Squeeze-excite global gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        y = torch.mean(x, dim=(2, 3))
        y = torch.sigmoid(linear(self.Dense_1,
                                 torch.relu(linear(self.Dense_0, y))))
        return x * y[:, :, None, None]


class ContextGuidedBlockDown(nn.Module):
    """(Cin, H, W) -> (n_out, H/2, W/2)."""

    def __init__(self, n_in: int, n_out: int, dilation: int = 2,
                 reduction: int = 16, norm: str = "batch"):
        super().__init__()
        self.conv1x1 = ConvBNPReLU(n_in, n_out, 3, 2, norm)
        self.F_loc = _depthwise(n_out, 1)
        self.F_sur = _depthwise(n_out, dilation)
        self._Norm_0 = _Norm(2 * n_out, norm)
        self.PReLU_0 = PReLU(2 * n_out)
        self.reduce = IEEEConv2d(2 * n_out, n_out, 1, bias=False)
        self.FGlo_0 = FGlo(n_out, reduction)

    def forward(self, x):
        x = self.conv1x1(x)
        joi = torch.cat([self.F_loc(x), self.F_sur(x)], 1)
        joi = self.PReLU_0(self._Norm_0(joi))
        return self.FGlo_0(self.reduce(joi))


class ContextGuidedBlock(nn.Module):
    """Residual CG block."""

    def __init__(self, n_in: int, n_out: int, dilation: int = 2,
                 reduction: int = 16, add: bool = True, norm: str = "batch"):
        super().__init__()
        n = n_out // 2
        self.add = add
        self.conv1x1 = ConvBNPReLU(n_in, n, 1, 1, norm)
        self.F_loc = _depthwise(n, 1)
        self.F_sur = _depthwise(n, dilation)
        self.bn_prelu = BNPReLU(n_out, norm)
        self.FGlo_0 = FGlo(n_out, reduction)

    def forward(self, x):
        h = self.conv1x1(x)
        joi = self.bn_prelu(torch.cat([self.F_loc(h), self.F_sur(h)], 1))
        out = self.FGlo_0(joi)
        return x + out if self.add else out


class ContextGuidedNetwork(nn.Module):
    def __init__(self, classes: int = 1, M: int = 2, N: int = 2,
                 input_channel: int = 3, norm: str = "batch"):
        super().__init__()
        c_in = input_channel
        self.level1_0 = ConvBNPReLU(c_in, 32, 3, 2, norm)
        self.level1_1 = ConvBNPReLU(32, 32, 3, 1, norm)
        self.level1_2 = ConvBNPReLU(32, 32, 3, 1, norm)
        self.b1 = BNPReLU(32 + c_in, norm)
        self.level2_0 = ContextGuidedBlockDown(32 + c_in, 64, 2, 8, norm)
        self.level2 = [f"level2_{i + 1}" for i in range(M - 1)]
        for name in self.level2:
            self.add_module(name, ContextGuidedBlock(64, 64, 2, 8,
                                                     norm=norm))
        self.bn_prelu_2 = BNPReLU(128 + c_in, norm)
        self.level3_0 = ContextGuidedBlockDown(128 + c_in, 128, 4, 16, norm)
        self.level3 = [f"level3_{i + 1}" for i in range(N - 1)]
        for name in self.level3:
            self.add_module(name, ContextGuidedBlock(128, 128, 4, 16,
                                                     norm=norm))
        self.bn_prelu_3 = BNPReLU(256, norm)
        self.classifier = IEEEConv2d(256, classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) -> (N, H, W, classes) sigmoid mask."""
        in_hw = x.shape[1:3]
        x = nchw(x.to(self.classifier.weight.dtype))
        out0 = self.level1_2(self.level1_1(self.level1_0(x)))
        inp1 = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
        inp2 = F.avg_pool2d(inp1, 3, 2, 1, count_include_pad=True)
        cat0 = self.b1(torch.cat([out0, inp1], 1))
        out1_0 = self.level2_0(cat0)
        out1 = out1_0
        for name in self.level2:
            out1 = getattr(self, name)(out1)
        cat1 = self.bn_prelu_2(torch.cat([out1, out1_0, inp2], 1))
        out2_0 = self.level3_0(cat1)
        out2 = out2_0
        for name in self.level3:
            out2 = getattr(self, name)(out2)
        cat2 = self.bn_prelu_3(torch.cat([out2_0, out2], 1))
        logits = nhwc(self.classifier(cat2))
        return torch.sigmoid(resize_bilinear(logits, tuple(in_hw)))

    def norms(self) -> List[_Norm]:
        """The batch norms, the ones with running and pending statistics
        (none with ``norm='group'``)."""
        return [m for m in self.modules()
                if isinstance(m, _Norm) and m.kind == "batch"]

    @torch.no_grad()
    def update_running_stats(self) -> None:
        """Move every BatchNorm's running statistics by the mean, over all
        samples seen in training-mode forwards since the last call, of the
        per-sample batch statistics; then forget those. In place."""
        for m in self.norms():
            if m.pending is None:
                continue
            mean, var = m.pending[0] / m.pending[2], m.pending[1] / m.pending[2]
            bn = m.BatchNorm_0
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked += 1
            m.pending = None
