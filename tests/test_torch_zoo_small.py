"""AlexNet, VGG-11 (with and without BatchNorm) and SqueezeNet 1.0 and 1.1
of the PyTorch/CUDA port against the JAX reference on the host, 10
classes (tests/test_torch_zoo_cases.py): AlexNet at the reference test's
2 x 3 x 224 x 224 for its eval logits (its AdaptiveAvgPool2D((6, 6))
then pools a 6 x 6 map) and at 64 x 64 for the rest (it upsamples a
1 x 1 map to 6 x 6); VGG at 32 x 32 (a 1 x 1 map upsampled to 7 x 7);
SqueezeNet at 64 x 64 (1.0's training step block by block,
tests/test_torch_zoo_cases.py's ZooBlocks). Also .pdparams written by either package load
into the other, and every constructor's shapes and pretrained refusal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_cases import Zoo, ZooBlocks, ref_state, rel_l2


class TestAlexNet(Zoo):
    FAMILY = "alexnet"


class TestVGG11(Zoo):
    FAMILY = "vgg11"


class TestVGG11BN(Zoo):
    FAMILY = "vgg11_bn"


class TestSqueezeNet10(ZooBlocks):
    """Held block by block: at this input a window of the last max pool
    holds a near-tie (ZooBlocks)."""
    FAMILY = "squeezenet1_0"


class TestSqueezeNet11(Zoo):
    FAMILY = "squeezenet1_1"


def test_alexnet_eval_at_224():
    ref.seed(0)
    rm = ref.vision.models.alexnet(num_classes=10)
    pm = pt.vision.models.alexnet(num_classes=10, device="cpu")
    assert pm.set_state_dict(ref_state(rm)) == ([], [])
    rm.eval()
    pm.eval()
    x = np.random.RandomState(0).randn(2, 3, 224, 224).astype("float32")
    want = np.asarray(rm(ref.to_tensor(x))._val)
    with torch.no_grad():
        got = pm(torch.tensor(x)).numpy()
    assert got.shape == (2, 10) and rel_l2(got, want) <= 1e-5


def test_pdparams_cross_both_ways(tmp_path):
    ref.seed(0)
    rm = ref.vision.models.squeezenet1_1(num_classes=10)
    ref.save(rm.state_dict(), str(tmp_path / "ref.pdparams"))
    pm = pt.vision.models.squeezenet1_1(num_classes=10, device="cpu")
    assert pm.set_state_dict(pt.load(str(tmp_path / "ref.pdparams"))) \
        == ([], [])
    for n, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref_state(rm)[n])
    pt.save(pm.state_dict(), str(tmp_path / "port.pdparams"))
    back = ref.vision.models.squeezenet1_1(num_classes=10)
    back.set_state_dict(ref.load(str(tmp_path / "port.pdparams")))
    for n, t in ref_state(back).items():
        np.testing.assert_array_equal(t, ref_state(rm)[n])


CONSTRUCTORS = ["alexnet", "vgg11", "vgg13", "vgg16", "vgg19",
                "squeezenet1_0", "squeezenet1_1", "googlenet",
                "inception_v3", "densenet121", "densenet161", "densenet169",
                "densenet201", "densenet264", "resnext50_32x4d",
                "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
                "resnext152_32x4d", "resnext152_64x4d"]


@pytest.mark.parametrize("name", ["vgg13", "vgg16", "vgg19"])
@pytest.mark.parametrize("bn", [False, True])
def test_vgg_constructors_match_reference(name, bn):
    rm = getattr(ref.vision.models, name)(batch_norm=bn, num_classes=0,
                                          with_pool=False)
    pm = getattr(pt.vision.models, name)(batch_norm=bn, num_classes=0,
                                         with_pool=False, device="meta")
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in rm.state_dict().items()}


def test_every_constructor_refuses_pretrained():
    for name in CONSTRUCTORS:
        with pytest.raises(NotImplementedError):
            getattr(pt.vision.models, name)(pretrained=True)
    with pytest.raises(ValueError, match="version"):
        pt.vision.models.SqueezeNet(version="2.0", device="cpu")
