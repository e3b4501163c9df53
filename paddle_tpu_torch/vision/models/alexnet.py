"""AlexNet (port of paddle_tpu/vision/models/alexnet.py).

Parameter names are the reference's (``features.0.weight``,
``classifier.1.weight``, ...), so state dicts and .pdparams files cross
unchanged. Construction takes the port's ``device``, ``dtype`` and
``generator``, and ``data_format``: "NHWC" runs the network channels-last
(input (N, H, W, C)); the pooled 6 x 6 map is flattened in the
reference's channel-first order, so the classifier's weights are the
same in both formats. The classifier's dropouts draw from the layer's
generator.
"""
from __future__ import annotations

from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, data_format="NCHW", **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        fmt = data_format
        self.num_classes = num_classes
        self.data_format = fmt

        def conv(cin, cout, k, **kw):
            return nn.Conv2D(cin, cout, k, data_format=fmt, **kw, **f)

        def pool():
            return nn.MaxPool2D(3, stride=2, data_format=fmt, **f)
        self.features = nn.Sequential(
            conv(3, 64, 11, stride=4, padding=2), nn.ReLU(**f), pool(),
            conv(64, 192, 5, padding=2), nn.ReLU(**f), pool(),
            conv(192, 384, 3, padding=1), nn.ReLU(**f),
            conv(384, 256, 3, padding=1), nn.ReLU(**f),
            conv(256, 256, 3, padding=1), nn.ReLU(**f), pool(),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6), data_format=fmt, **f)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5, **f),
                nn.Linear(256 * 6 * 6, 4096, **f),
                nn.ReLU(**f),
                nn.Dropout(0.5, **f),
                nn.Linear(4096, 4096, **f),
                nn.ReLU(**f),
                nn.Linear(4096, num_classes, **f),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            if self.data_format == "NHWC":
                x = x.permute(0, 3, 1, 2)
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access); load "
            "a local checkpoint with paddle.load + set_state_dict")
    return AlexNet(**kwargs)
