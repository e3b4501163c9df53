"""ResNeXt-50 32x4d of the PyTorch/CUDA port against the JAX reference on
the host at 2 x 3 x 64 x 64, 10 classes (tests/test_torch_zoo_cases.py),
with the fused conv + BN op and without it: the bottlenecks' 3 x 3 convs
are grouped (cardinality 32, 128 channels wide at the first stage), so
the fused op's grouped path is held against the reference at a real
cardinality. The training step is held block by block (ZooBlocks): its
last stage's BatchNorms see 8 values a channel, where the whole model's
f32 loss moves by up to 1.7e-5 from f64. Also the other constructors' shapes."""
import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_cases import ZooBlocks


class TestResNeXt50(ZooBlocks):
    """Held block by block (ZooBlocks): the stem, its max pool, each
    bottleneck and the top."""
    FAMILY = "resnext50_32x4d"
    PORT_KW = [{"fused_conv_bn": True}, {"fused_conv_bn": False}]


def test_resnext_constructors_match_reference():
    for name in ("resnext50_64x4d", "resnext101_32x4d"):
        rm = getattr(ref.vision.models, name)(num_classes=0, with_pool=False)
        pm = getattr(pt.vision.models, name)(num_classes=0, with_pool=False,
                                             device="meta")
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in rm.state_dict().items()}, name
        assert pm.cardinality == rm.cardinality
    net = pt.vision.models.resnext50_32x4d(device="meta")
    assert net.layer1[0].conv2._groups == 32
    assert tuple(net.layer1[0].conv2.weight.shape) == (128, 4, 3, 3)
