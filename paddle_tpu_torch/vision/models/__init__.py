"""paddle.vision.models: every model of the reference (LeNet, AlexNet,
VGG, the ResNet and ResNeXt families, MobileNetV1/V2, DenseNet,
GoogLeNet, InceptionV3, SqueezeNet and ShuffleNetV2)."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .resnext import (ResNeXt, resnext50_32x4d, resnext50_64x4d,
                      resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                      resnext152_64x4d)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = [
    "LeNet", "AlexNet", "alexnet", "BasicBlock", "BottleneckBlock",
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2",
    "ResNeXt", "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
    "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
