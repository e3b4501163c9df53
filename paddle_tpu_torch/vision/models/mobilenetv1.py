"""MobileNetV1 (port of paddle_tpu/vision/models/mobilenetv1.py).

Parameter and buffer names are the reference's (``conv1._conv.weight``,
``dwsl.0._depthwise_conv._norm_layer._mean``, ``fc.weight``, ...), so
state dicts and .pdparams files cross unchanged. Construction takes the
port's ``device``, ``dtype`` and ``generator``, and ``data_format``:
"NHWC" runs the network channels-last (input (N, H, W, C)), as ResNet
does.
"""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, num_groups=1, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               groups=num_groups, bias_attr=False,
                               data_format=data_format, **f)
        self._norm_layer = nn.BatchNorm2D(out_channels,
                                          data_format=data_format, **f)
        self._act = nn.ReLU(**f)

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride=stride,
            padding=1, num_groups=int(num_groups * scale),
            data_format=data_format, **f)
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1,
            data_format=data_format, **f)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = fmt
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 data_format=fmt, **f)
        cfg = [
            # in, ch1, ch2, groups, stride
            (int(32 * scale), 32, 64, 32, 1),
            (int(64 * scale), 64, 128, 64, 2),
            (int(128 * scale), 128, 128, 128, 1),
            (int(128 * scale), 128, 256, 128, 2),
            (int(256 * scale), 256, 256, 256, 1),
            (int(256 * scale), 256, 512, 256, 2),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 512, 512, 1),
            (int(512 * scale), 512, 1024, 512, 2),
            (int(1024 * scale), 1024, 1024, 1024, 1),
        ]
        self.dwsl = nn.Sequential(*[
            DepthwiseSeparable(i, c1, c2, g, s, scale, data_format=fmt, **f)
            for (i, c1, c2, g, s) in cfg])
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes, **f)

    def forward(self, x):
        x = self.conv1(x)
        x = self.dwsl(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return MobileNetV1(scale=scale, **kwargs)
