"""SqueezeNet 1.0 and 1.1 (port of paddle_tpu/vision/models/squeezenet.py).

Parameter names are the reference's (``features.0.weight``,
``features.3.expand3x3.weight``, ``classifier.1.weight``, ...), so state
dicts and .pdparams files cross unchanged. Construction takes the port's
``device``, ``dtype`` and ``generator``, and ``data_format``: "NHWC" runs
the network channels-last (input (N, H, W, C)), each Fire module
concatenating its expands on the last axis. The classifier's
Dropout(0.5) draws from the layer's generator.
"""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Layer):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes,
                 expand3x3_planes, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self._axis = -1 if data_format == "NHWC" else 1
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1,
                                 data_format=data_format, **f)
        self.relu = nn.ReLU(**f)
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1_planes, 1,
                                   data_format=data_format, **f)
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3_planes, 3,
                                   padding=1, data_format=data_format, **f)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1x1(x)),
                          self.relu(self.expand3x3(x))], dim=self._axis)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool

        def fire(*planes):
            return Fire(*planes, data_format=fmt, **f)

        def pool():
            return nn.MaxPool2D(3, stride=2, data_format=fmt, **f)
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, data_format=fmt, **f),
                nn.ReLU(**f), pool(),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), pool(),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256), pool(),
                fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, data_format=fmt, **f),
                nn.ReLU(**f), pool(),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64), pool(),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128), pool(),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256),
            )
        else:
            raise ValueError(f"unsupported version {version}")
        self.classifier = nn.Sequential(
            nn.Dropout(0.5, **f),
            nn.Conv2D(512, num_classes, 1, data_format=fmt, **f),
            nn.ReLU(**f),
            nn.AdaptiveAvgPool2D(1, data_format=fmt, **f),
        )

    def forward(self, x):
        return self.classifier(self.features(x)).flatten(1)


def _squeezenet(version, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return SqueezeNet(version=version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
