"""ResNeXt (port of paddle_tpu/vision/models/resnext.py), over the port's
ResNet with ``groups=cardinality`` and ``width`` as its ``base_width``:
a bottleneck's 3 x 3 conv is then grouped, ``int(planes * width / 64) *
cardinality`` channels wide (128 at the first stage of 32x4d).

Parameter and buffer names are the reference's, so state dicts and
.pdparams files cross unchanged. The other keywords (``data_format``,
``stem``, ``fused_conv_bn``, ``device``, ``dtype``, ``generator``) are
ResNet's; with the fused conv + BN default the grouped convs run through
``ops.fused_conv_bn`` with ``groups=cardinality``.
"""
from __future__ import annotations

from .resnet import BottleneckBlock, ResNet

__all__ = ["ResNeXt", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class ResNeXt(ResNet):
    def __init__(self, depth=50, cardinality=32, width=4, num_classes=1000,
                 with_pool=True, **kwargs):
        self.cardinality = cardinality
        super().__init__(BottleneckBlock, depth=depth, width=width,
                         num_classes=num_classes, with_pool=with_pool,
                         groups=cardinality, **kwargs)


def _resnext(depth, cardinality, width, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network access)")
    return ResNeXt(depth=depth, cardinality=cardinality, width=width,
                   **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)
