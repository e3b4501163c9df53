"""MobileNetV2 (port of paddle_tpu/vision/models/mobilenetv2.py).

Parameter and buffer names are the reference's (``features.0.0.weight``,
``features.1.conv.0.1._mean``, ``classifier.1.weight``, ...), so state
dicts and .pdparams files cross unchanged. Construction takes the
port's ``device``, ``dtype`` and ``generator``, and ``data_format``:
"NHWC" runs the network channels-last (input (N, H, W, C)), as ResNet
does. The classifier's Dropout(0.2) draws from the layer's generator
(None: torch's default generator of the device).
"""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, data_format="NCHW", **factory):
        padding = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2D(in_planes, out_planes, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias_attr=False,
                      data_format=data_format, **factory),
            nn.BatchNorm2D(out_planes, data_format=data_format, **factory),
            nn.ReLU6(**factory),
        )


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = self.stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1,
                                     data_format=fmt, **f))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, data_format=fmt, **f),
            nn.Conv2D(hidden_dim, oup, 1, bias_attr=False, data_format=fmt,
                      **f),
            nn.BatchNorm2D(oup, data_format=fmt, **f),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = fmt
        input_channel = 32
        last_channel = 1280
        inverted_residual_setting = [
            # t, c, n, s
            [1, 16, 1, 1],
            [6, 24, 2, 2],
            [6, 32, 3, 2],
            [6, 64, 4, 2],
            [6, 96, 3, 1],
            [6, 160, 3, 2],
            [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, data_format=fmt,
                               **f)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1,
                    expand_ratio=t, data_format=fmt, **f))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, data_format=fmt, **f))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, **f),
                nn.Linear(self.last_channel, num_classes, **f),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return MobileNetV2(scale=scale, **kwargs)
