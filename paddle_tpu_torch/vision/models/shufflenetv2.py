"""ShuffleNetV2 (port of paddle_tpu/vision/models/shufflenetv2.py).

Parameter and buffer names are the reference's (``conv1.0.weight``,
``blocks.0.branch1.1._mean``, ``conv_last.0.weight``, ``fc.weight``,
...), so state dicts and .pdparams files cross unchanged. Construction
takes the port's ``device``, ``dtype`` and ``generator``, and
``data_format``: "NHWC" runs the network channels-last (input (N, H, W,
C)), the channel split and shuffle on the last axis.
"""
from __future__ import annotations

import torch

from ... import nn
from ...nn import functional as F

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}


def _act(name, f):
    return nn.Swish(**f) if name == "swish" else nn.ReLU(**f)


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, act="relu", data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.stride = stride
        self.data_format = fmt
        branch_features = oup // 2
        if self.stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp,
                          bias_attr=False, data_format=fmt, **f),
                nn.BatchNorm2D(inp, data_format=fmt, **f),
                nn.Conv2D(inp, branch_features, 1, bias_attr=False,
                          data_format=fmt, **f),
                nn.BatchNorm2D(branch_features, data_format=fmt, **f),
                _act(act, f),
            )
            branch2_in = inp
        else:
            self.branch1 = None
            branch2_in = inp // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(branch2_in, branch_features, 1, bias_attr=False,
                      data_format=fmt, **f),
            nn.BatchNorm2D(branch_features, data_format=fmt, **f),
            _act(act, f),
            nn.Conv2D(branch_features, branch_features, 3, stride=stride,
                      padding=1, groups=branch_features, bias_attr=False,
                      data_format=fmt, **f),
            nn.BatchNorm2D(branch_features, data_format=fmt, **f),
            nn.Conv2D(branch_features, branch_features, 1, bias_attr=False,
                      data_format=fmt, **f),
            nn.BatchNorm2D(branch_features, data_format=fmt, **f),
            _act(act, f),
        )

    def forward(self, x):
        ch = -1 if self.data_format == "NHWC" else 1
        if self.stride == 1:
            x1, x2 = torch.chunk(x, 2, dim=ch)
            out = torch.cat([x1, self.branch2(x2)], dim=ch)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=ch)
        return F.channel_shuffle(out, 2, data_format=self.data_format)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = fmt
        stage_out = _STAGE_OUT[scale]
        stage_repeats = [4, 8, 4]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, stage_out[0], 3, stride=2, padding=1,
                      bias_attr=False, data_format=fmt, **f),
            nn.BatchNorm2D(stage_out[0], data_format=fmt, **f),
            _act(act, f),
        )
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1, data_format=fmt,
                                     **f)
        blocks = []
        in_ch = stage_out[0]
        for stage, repeats in enumerate(stage_repeats):
            out_ch = stage_out[stage + 1]
            for i in range(repeats):
                blocks.append(InvertedResidual(
                    in_ch, out_ch, stride=2 if i == 0 else 1, act=act,
                    data_format=fmt, **f))
                in_ch = out_ch
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, stage_out[-1], 1, bias_attr=False,
                      data_format=fmt, **f),
            nn.BatchNorm2D(stage_out[-1], data_format=fmt, **f),
            _act(act, f),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.fc = nn.Linear(stage_out[-1], num_classes, **f)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.blocks(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(scale, act, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, "relu", pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, "swish", pretrained, **kwargs)
