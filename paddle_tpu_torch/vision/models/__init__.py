"""paddle.vision.models: LeNet, the ResNet family, MobileNetV1/V2 and
ShuffleNetV2. The other vision models of the reference come after the
rest of nn (ROADMAP A7)."""
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "MobileNetV1",
           "mobilenet_v1", "MobileNetV2", "mobilenet_v2", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "shufflenet_v2_swish"]
