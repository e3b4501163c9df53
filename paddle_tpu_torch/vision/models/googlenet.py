"""GoogLeNet, Inception v1 (port of paddle_tpu/vision/models/googlenet.py).

``forward`` returns ``(x, aux1, aux2)`` whenever ``num_classes > 0``, in
eval too, as the reference does, and ``x`` alone otherwise. Parameter
names are the reference's (``stem.0.weight``, ``inc3a.branch2.2.weight``,
``aux1.fc1.weight``, ...), so state dicts and .pdparams files cross
unchanged. Construction takes the port's ``device``, ``dtype`` and
``generator``, and ``data_format``: "NHWC" runs the network channels-last
(input (N, H, W, C)), each Inception block concatenating its branches on
the last axis; an aux head's pooled 4 x 4 map is flattened in the
reference's channel-first order, so its fc1 weights are the same in both
formats. The dropouts (0.7 in each aux head, 0.4 at the top) draw from
the layer's generator.
"""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["GoogLeNet", "googlenet"]


class Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj, data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self._axis = -1 if fmt == "NHWC" else 1

        def conv(cin, cout, k, **kw):
            return nn.Conv2D(cin, cout, k, data_format=fmt, **kw, **f)
        self.branch1 = nn.Sequential(conv(in_ch, c1, 1), nn.ReLU(**f))
        self.branch2 = nn.Sequential(
            conv(in_ch, c3r, 1), nn.ReLU(**f),
            conv(c3r, c3, 3, padding=1), nn.ReLU(**f))
        self.branch3 = nn.Sequential(
            conv(in_ch, c5r, 1), nn.ReLU(**f),
            conv(c5r, c5, 5, padding=2), nn.ReLU(**f))
        self.branch4 = nn.Sequential(
            nn.MaxPool2D(3, stride=1, padding=1, data_format=fmt, **f),
            conv(in_ch, proj, 1), nn.ReLU(**f))

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], dim=self._axis)


class _AuxHead(nn.Layer):
    def __init__(self, in_ch, num_classes, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self._nhwc = data_format == "NHWC"
        self.pool = nn.AdaptiveAvgPool2D(4, data_format=data_format, **f)
        self.conv = nn.Conv2D(in_ch, 128, 1, data_format=data_format, **f)
        self.relu = nn.ReLU(**f)
        self.fc1 = nn.Linear(128 * 16, 1024, **f)
        self.dropout = nn.Dropout(0.7, **f)
        self.fc2 = nn.Linear(1024, num_classes, **f)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        if self._nhwc:
            x = x.permute(0, 3, 1, 2)
        x = self.dropout(self.relu(self.fc1(x.flatten(1))))
        return self.fc2(x)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.num_classes = num_classes
        self.with_pool = with_pool

        def inception(*cfg):
            return Inception(*cfg, data_format=fmt, **f)

        def pool(stride):
            return nn.MaxPool2D(3, stride=stride, padding=1, data_format=fmt,
                                **f)
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, data_format=fmt, **f),
            nn.ReLU(**f), pool(2),
            nn.Conv2D(64, 64, 1, data_format=fmt, **f), nn.ReLU(**f),
            nn.Conv2D(64, 192, 3, padding=1, data_format=fmt, **f),
            nn.ReLU(**f), pool(2),
        )
        self.inc3a = inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = pool(2)
        self.inc4a = inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = pool(2)
        self.inc5a = inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4, **f)
            self.fc = nn.Linear(1024, num_classes, **f)
            self.aux1 = _AuxHead(512, num_classes, data_format=fmt, **f)
            self.aux2 = _AuxHead(528, num_classes, data_format=fmt, **f)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return GoogLeNet(**kwargs)
