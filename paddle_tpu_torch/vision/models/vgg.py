"""VGG (port of paddle_tpu/vision/models/vgg.py).

Parameter and buffer names are the reference's (``features.0.weight``,
``features.1._mean`` with ``batch_norm=True``, ``classifier.0.weight``,
...), so state dicts and .pdparams files cross unchanged. ``make_layers``
and the constructors take the port's ``device``, ``dtype`` and
``generator``, and ``data_format``: "NHWC" runs the features
channels-last (input (N, H, W, C)); the pooled 7 x 7 map is flattened in
the reference's channel-first order, so the classifier's weights are the
same in both formats. ``VGG`` reads the format from its keyword, which
must match the features'.
"""
from __future__ import annotations

from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, data_format="NCHW", **factory):
    layers = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, stride=2, data_format=data_format,
                                       **factory))
        else:
            layers.append(nn.Conv2D(in_ch, v, 3, padding=1,
                                    data_format=data_format, **factory))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, data_format=data_format,
                                             **factory))
            layers.append(nn.ReLU(**factory))
            in_ch = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7),
                                                data_format=data_format, **f)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **f),
                nn.ReLU(**f),
                nn.Dropout(**f),
                nn.Linear(4096, 4096, **f),
                nn.ReLU(**f),
                nn.Dropout(**f),
                nn.Linear(4096, num_classes, **f),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            if self.data_format == "NHWC":
                x = x.permute(0, 3, 1, 2)
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained, data_format="NCHW", device=None,
         dtype=None, generator=None, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    f = {"device": device, "dtype": dtype, "generator": generator}
    return VGG(make_layers(_CFGS[cfg], batch_norm=batch_norm,
                           data_format=data_format, **f),
               data_format=data_format, **kwargs, **f)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
