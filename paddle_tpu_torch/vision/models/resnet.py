"""ResNet (port of paddle_tpu/vision/models/resnet.py).

Parameter and buffer names are the reference's (``conv1.weight``,
``layer1.0.downsample.0.weight``, ``bn1._mean``, ...), so state dicts and
.pdparams files cross unchanged. Construction takes ``device``, ``dtype``
and ``generator``, as the port's GPT and BERT do.

- ``data_format="NHWC"`` runs the whole network channels-last: each conv
  views its input as NCHW with channels_last strides, and the conv
  weights are kept in channels_last memory format, so cuDNN runs its NHWC
  kernels and no layer copies an activation to change its layout.
- ``stem="space_to_depth"`` computes conv1 (7 x 7, stride 2, pad 3) as
  the same convolution over 2 x 2 space-to-depth input (``_stem_space_to_
  depth``); ``conv1.weight`` stays (64, 3, 7, 7), so checkpoints are
  interchangeable with ``stem="conv"``.
- ``fused_conv_bn`` (None reads PADDLE_TPU_FUSED_CONV_BN, on by default,
  the reference's switch): each conv + BN pair of a block, and the stem's,
  runs through ``ops.fused_conv_bn``, whose backward keeps one activation
  tensor per layer instead of two. The decision is structural
  (``_fusable``) and reads no device value.
"""
from __future__ import annotations

import os

import torch

from ... import nn
from ...nn import functional as F

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]


def _fuse_default():
    return os.environ.get("PADDLE_TPU_FUSED_CONV_BN", "1") == "1"


def _fcb_raw(x, w, bn, act_in, *, stride, padding, dilation=1, groups=1,
             data_format="NCHW"):
    """[relu ->] conv2d(w) -> bn through the fused op; returns the
    PRE-activation output (the next layer fuses the ReLU with
    ``act_input=True``)."""
    from ...ops.fused_conv_bn import fused_conv_bn
    return fused_conv_bn(
        x, w, bn.weight, bn.bias, bn._mean, bn._variance,
        training=bn.training, momentum=bn._momentum, epsilon=bn._epsilon,
        stride=stride, padding=padding, dilation=dilation, groups=groups,
        data_format=data_format, act_input=act_in)


def _fcb(x, conv, bn, act_in):
    return _fcb_raw(x, conv.weight, bn, act_in, stride=conv._stride,
                    padding=conv._padding, dilation=conv._dilation,
                    groups=conv._groups, data_format=conv._data_format)


def _fusable(*pairs):
    """Every (conv, bn) pair of a block must qualify: the fused data flow
    hands PRE-activation tensors between layers, so fusion is
    all-or-nothing per block."""
    return all(isinstance(bn, nn.BatchNorm2D) and bn.weight is not None
               and conv.bias is None for conv, bn in pairs)


def _ds_fusable(ds):
    return (isinstance(ds, nn.Sequential) and len(ds) == 2
            and isinstance(ds[0], nn.Conv2D)
            and isinstance(ds[1], nn.BatchNorm2D)
            and _fusable((ds[0], ds[1])))


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", fused=False, **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        fmt = data_format
        self._fused = fused
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, data_format=fmt, **f)
        self.bn1 = norm_layer(planes, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=fmt, **f)
        self.bn2 = norm_layer(planes, data_format=fmt, **f)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        fused = (self._fused
                 and _fusable((self.conv1, self.bn1), (self.conv2, self.bn2))
                 and (self.downsample is None
                      or _ds_fusable(self.downsample)))
        identity = x
        if fused:
            p = _fcb(x, self.conv1, self.bn1, False)
            out = _fcb(p, self.conv2, self.bn2, True)
            if self.downsample is not None:
                identity = _fcb(x, self.downsample[0], self.downsample[1],
                                False)
        else:
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            if self.downsample is not None:
                identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", fused=False, **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        fmt = data_format
        self._fused = fused
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=fmt, **f)
        self.bn1 = norm_layer(width, data_format=fmt, **f)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups, dilation=dilation,
                               bias_attr=False, data_format=fmt, **f)
        self.bn2 = norm_layer(width, data_format=fmt, **f)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=fmt, **f)
        self.bn3 = norm_layer(planes * self.expansion, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        fused = (self._fused
                 and _fusable((self.conv1, self.bn1), (self.conv2, self.bn2),
                              (self.conv3, self.bn3))
                 and (self.downsample is None
                      or _ds_fusable(self.downsample)))
        identity = x
        if fused:
            p = _fcb(x, self.conv1, self.bn1, False)
            p = _fcb(p, self.conv2, self.bn2, True)
            out = _fcb(p, self.conv3, self.bn3, True)
            if self.downsample is not None:
                identity = _fcb(x, self.downsample[0], self.downsample[1],
                                False)
        else:
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            if self.downsample is not None:
                identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """Input must match ``data_format``: (N, 3, H, W) or (N, H, W, 3)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", stem="conv",
                 fused_conv_bn=None, **factory):
        super().__init__(**factory)
        f = self.factory_kwargs()
        self._fused = (_fuse_default() if fused_conv_bn is None
                       else bool(fused_conv_bn))
        layer_cfg = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        layers = layer_cfg[depth]
        fmt = data_format
        self.data_format = fmt
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"stem must be 'conv' or 'space_to_depth', "
                             f"got {stem!r}")
        self.stem = stem
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                               padding=3, bias_attr=False, data_format=fmt,
                               **f)
        self.bn1 = self._norm_layer(self.inplanes, data_format=fmt, **f)
        self.relu = nn.ReLU(**f)
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                                    data_format=fmt, **f)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=fmt, **f)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **f)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        fmt = self.data_format
        f = self.factory_kwargs()
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=fmt,
                          **f),
                norm_layer(planes * block.expansion, data_format=fmt, **f),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, norm_layer,
                        data_format=fmt, fused=self._fused, **f)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, data_format=fmt,
                                fused=self._fused, **f))
        return nn.Sequential(*layers)

    def _stem_space_to_depth(self, x):
        """conv1 (7 x 7, stride 2, pad 3) as the same 4 x 4, stride 1
        convolution over 2 x 2 space-to-depth input: H and W are zero-
        padded by (4, 2), each 2 x 2 block is folded into channels (order
        block-row, block-col, channel), and conv1's weight is zero-padded
        7 -> 8 at the start and folded the same way. The same math up to
        the order of the sums. Returns (input, weight) of that conv."""
        w = self.conv1.weight
        if self.data_format == "NHWC":
            n, h, ww, c = x.shape
            xp = F.pad(x, [4, 2, 4, 2], data_format="NHWC")
            hh, wh = (h + 6) // 2, (ww + 6) // 2
            xs = xp.reshape(n, hh, 2, wh, 2, c).permute(0, 1, 3, 2, 4, 5) \
                   .reshape(n, hh, wh, 4 * c)
        else:
            n, c, h, ww = x.shape
            xp = F.pad(x, [4, 2, 4, 2], data_format="NCHW")
            hh, wh = (h + 6) // 2, (ww + 6) // 2
            xs = xp.reshape(n, c, hh, 2, wh, 2).permute(0, 3, 5, 1, 2, 4) \
                   .reshape(n, 4 * c, hh, wh)
        o, ci, _, _ = w.shape
        wp = F.pad(w, [1, 0, 1, 0], data_format="NCHW")  # (o, ci, 8, 8)
        ws = wp.reshape(o, ci, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4) \
               .reshape(o, 4 * ci, 4, 4)
        return xs, ws

    def forward(self, x):
        fused = self._fused and _fusable((self.conv1, self.bn1))
        if self.stem == "space_to_depth":
            xs, ws = self._stem_space_to_depth(x)
            if fused:
                x = self.relu(_fcb_raw(xs, ws, self.bn1, False, stride=1,
                                       padding=0,
                                       data_format=self.data_format))
            else:
                x = F.conv2d(xs, ws, None, stride=1, padding=0,
                             data_format=self.data_format)
                x = self.relu(self.bn1(x))
        elif fused:
            x = self.relu(_fcb(x, self.conv1, self.bn1, False))
        else:
            x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, width=64, **kwargs):
    return ResNet(block, depth, width=width, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=128, **kwargs)
