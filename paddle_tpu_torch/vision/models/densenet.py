"""DenseNet 121, 161, 169, 201 and 264 (port of
paddle_tpu/vision/models/densenet.py).

Parameter and buffer names are the reference's (``conv1.weight``,
``blocks.0.layers.3.norm2._mean``, ``classifier.weight``, ...), so state
dicts and .pdparams files cross unchanged. Construction takes the port's
``device``, ``dtype`` and ``generator``, and ``data_format``: "NHWC" runs
the network channels-last (input (N, H, W, C)); each dense layer then
concatenates on the last axis, so the concat of two channels_last maps
is channels_last and no BatchNorm or conv after it changes the layout.
A dense layer's dropout (``dropout`` > 0) draws from the layer's
generator.
"""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_ARCH = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(nn.Layer):
    def __init__(self, num_input_features, growth_rate, bn_size, dropout,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self._axis = -1 if fmt == "NHWC" else 1
        self.norm1 = nn.BatchNorm2D(num_input_features, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.conv1 = nn.Conv2D(num_input_features, bn_size * growth_rate, 1,
                               bias_attr=False, data_format=fmt, **f)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate, data_format=fmt,
                                    **f)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False, data_format=fmt,
                               **f)
        self.dropout = nn.Dropout(dropout, **f) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=self._axis)


class _DenseBlock(nn.Layer):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 dropout, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self.layers = nn.LayerList([
            _DenseLayer(num_input_features + i * growth_rate, growth_rate,
                        bn_size, dropout, data_format=data_format, **f)
            for i in range(num_layers)
        ])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Transition(nn.Layer):
    def __init__(self, num_input_features, num_output_features,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.norm = nn.BatchNorm2D(num_input_features, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.conv = nn.Conv2D(num_input_features, num_output_features, 1,
                              bias_attr=False, data_format=fmt, **f)
        self.pool = nn.AvgPool2D(2, stride=2, data_format=fmt, **f)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, data_format="NCHW", **factory):
        super().__init__(**factory)
        if layers not in _ARCH:
            raise ValueError(f"unsupported depth {layers}: choose from "
                             f"{sorted(_ARCH)}")
        f = self.factory_kwargs()
        fmt = data_format
        num_init_features, growth_rate, block_config = _ARCH[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                               bias_attr=False, data_format=fmt, **f)
        self.norm1 = nn.BatchNorm2D(num_init_features, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.pool1 = nn.MaxPool2D(3, stride=2, padding=1, data_format=fmt,
                                  **f)
        blocks = []
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            blocks.append(_DenseBlock(num_layers, num_features, bn_size,
                                      growth_rate, dropout, data_format=fmt,
                                      **f))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                blocks.append(_Transition(num_features, num_features // 2,
                                          data_format=fmt, **f))
                num_features //= 2
        self.blocks = nn.Sequential(*blocks)
        self.norm5 = nn.BatchNorm2D(num_features, data_format=fmt, **f)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=fmt, **f)
        if num_classes > 0:
            self.classifier = nn.Linear(num_features, num_classes, **f)

    def forward(self, x):
        x = self.pool1(self.relu(self.norm1(self.conv1(x))))
        x = self.relu(self.norm5(self.blocks(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
