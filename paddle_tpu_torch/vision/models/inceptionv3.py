"""Inception v3 (port of paddle_tpu/vision/models/inceptionv3.py).

Parameter and buffer names are the reference's (``stem.0.conv.weight``,
``blocks.0.b5x5_2.bn._mean``, ``fc.weight``, ...), so state dicts and
.pdparams files cross unchanged. Construction takes the port's
``device``, ``dtype`` and ``generator``, and ``data_format``: "NHWC" runs
the network channels-last (input (N, H, W, C)), each block concatenating
its branches on the last axis. The pooling branches'
``AvgPool2D(3, stride=1, padding=1)`` divide a border window by its count
of in-image elements (the reference's ``exclusive=True`` with explicit
padding). The top Dropout(0.5) draws from the layer's generator.
"""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["InceptionV3", "inception_v3"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias_attr=False,
                              data_format=data_format, **f)
        self.bn = nn.BatchNorm2D(out_ch, data_format=data_format, **f)
        self.relu = nn.ReLU(**f)

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Block(nn.Layer):
    """The factory, format and concat axis the Inception blocks share."""

    def __init__(self, data_format, factory):
        super().__init__(**factory)
        self._fmt = data_format
        self._axis = -1 if data_format == "NHWC" else 1

    def _conv(self, *args, **kw):
        return ConvBNLayer(*args, data_format=self._fmt, **kw,
                           **self.factory_kwargs())

    def _pool(self, kind, stride, padding=0):
        return kind(3, stride=stride, padding=padding,
                    data_format=self._fmt, **self.factory_kwargs())

    def _cat(self, parts):
        return torch.cat(parts, dim=self._axis)


class InceptionA(_Block):
    def __init__(self, in_ch, pool_features, data_format="NCHW", **factory):
        super().__init__(data_format, factory)
        c = self._conv
        self.b1x1 = c(in_ch, 64, 1)
        self.b5x5_1 = c(in_ch, 48, 1)
        self.b5x5_2 = c(48, 64, 5, padding=2)
        self.b3x3_1 = c(in_ch, 64, 1)
        self.b3x3_2 = c(64, 96, 3, padding=1)
        self.b3x3_3 = c(96, 96, 3, padding=1)
        self.pool = self._pool(nn.AvgPool2D, 1, 1)
        self.bpool = c(in_ch, pool_features, 1)

    def forward(self, x):
        return self._cat([
            self.b1x1(x),
            self.b5x5_2(self.b5x5_1(x)),
            self.b3x3_3(self.b3x3_2(self.b3x3_1(x))),
            self.bpool(self.pool(x)),
        ])


class InceptionB(_Block):
    """Grid reduction 35 -> 17."""

    def __init__(self, in_ch, data_format="NCHW", **factory):
        super().__init__(data_format, factory)
        c = self._conv
        self.b3x3 = c(in_ch, 384, 3, stride=2)
        self.bd_1 = c(in_ch, 64, 1)
        self.bd_2 = c(64, 96, 3, padding=1)
        self.bd_3 = c(96, 96, 3, stride=2)
        self.pool = self._pool(nn.MaxPool2D, 2)

    def forward(self, x):
        return self._cat([
            self.b3x3(x),
            self.bd_3(self.bd_2(self.bd_1(x))),
            self.pool(x),
        ])


class InceptionC(_Block):
    def __init__(self, in_ch, channels_7x7, data_format="NCHW", **factory):
        super().__init__(data_format, factory)
        c, c7 = self._conv, channels_7x7
        self.b1x1 = c(in_ch, 192, 1)
        self.b7_1 = c(in_ch, c7, 1)
        self.b7_2 = c(c7, c7, (1, 7), padding=(0, 3))
        self.b7_3 = c(c7, 192, (7, 1), padding=(3, 0))
        self.b7d_1 = c(in_ch, c7, 1)
        self.b7d_2 = c(c7, c7, (7, 1), padding=(3, 0))
        self.b7d_3 = c(c7, c7, (1, 7), padding=(0, 3))
        self.b7d_4 = c(c7, c7, (7, 1), padding=(3, 0))
        self.b7d_5 = c(c7, 192, (1, 7), padding=(0, 3))
        self.pool = self._pool(nn.AvgPool2D, 1, 1)
        self.bpool = c(in_ch, 192, 1)

    def forward(self, x):
        return self._cat([
            self.b1x1(x),
            self.b7_3(self.b7_2(self.b7_1(x))),
            self.b7d_5(self.b7d_4(self.b7d_3(self.b7d_2(self.b7d_1(x))))),
            self.bpool(self.pool(x)),
        ])


class InceptionD(_Block):
    """Grid reduction 17 -> 8."""

    def __init__(self, in_ch, data_format="NCHW", **factory):
        super().__init__(data_format, factory)
        c = self._conv
        self.b3_1 = c(in_ch, 192, 1)
        self.b3_2 = c(192, 320, 3, stride=2)
        self.b7_1 = c(in_ch, 192, 1)
        self.b7_2 = c(192, 192, (1, 7), padding=(0, 3))
        self.b7_3 = c(192, 192, (7, 1), padding=(3, 0))
        self.b7_4 = c(192, 192, 3, stride=2)
        self.pool = self._pool(nn.MaxPool2D, 2)

    def forward(self, x):
        return self._cat([
            self.b3_2(self.b3_1(x)),
            self.b7_4(self.b7_3(self.b7_2(self.b7_1(x)))),
            self.pool(x),
        ])


class InceptionE(_Block):
    def __init__(self, in_ch, data_format="NCHW", **factory):
        super().__init__(data_format, factory)
        c = self._conv
        self.b1x1 = c(in_ch, 320, 1)
        self.b3_1 = c(in_ch, 384, 1)
        self.b3_2a = c(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = c(384, 384, (3, 1), padding=(1, 0))
        self.b3d_1 = c(in_ch, 448, 1)
        self.b3d_2 = c(448, 384, 3, padding=1)
        self.b3d_3a = c(384, 384, (1, 3), padding=(0, 1))
        self.b3d_3b = c(384, 384, (3, 1), padding=(1, 0))
        self.pool = self._pool(nn.AvgPool2D, 1, 1)
        self.bpool = c(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.b3_1(x)
        b3d = self.b3d_2(self.b3d_1(x))
        # one concat of the six parts: the same tensor as the reference's
        # nested concats
        return self._cat([
            self.b1x1(x),
            self.b3_2a(b3), self.b3_2b(b3),
            self.b3d_3a(b3d), self.b3d_3b(b3d),
            self.bpool(self.pool(x)),
        ])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(*args, **kw):
            return ConvBNLayer(*args, data_format=fmt, **kw, **f)
        kw = {"data_format": fmt, **f}
        self.stem = nn.Sequential(
            c(3, 32, 3, stride=2),
            c(32, 32, 3),
            c(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2, data_format=fmt, **f),
            c(64, 80, 1),
            c(80, 192, 3),
            nn.MaxPool2D(3, stride=2, data_format=fmt, **f),
        )
        self.blocks = nn.Sequential(
            InceptionA(192, pool_features=32, **kw),
            InceptionA(256, pool_features=64, **kw),
            InceptionA(288, pool_features=64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, channels_7x7=128, **kw),
            InceptionC(768, channels_7x7=160, **kw),
            InceptionC(768, channels_7x7=160, **kw),
            InceptionC(768, channels_7x7=192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw),
            InceptionE(2048, **kw),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5, **f)
            self.fc = nn.Linear(2048, num_classes, **f)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return InceptionV3(**kwargs)
