"""DenseNet-121 of the PyTorch/CUDA port against the JAX reference on the
host at 2 x 3 x 64 x 64, 10 classes (tests/test_torch_zoo_cases.py), and
every DenseNet constructor's shapes, bn_size and dropout."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_cases import Zoo


class TestDenseNet121(Zoo):
    FAMILY = "densenet121"


def test_densenet_options_and_constructors():
    for depth in (161, 169, 201, 264):
        net = getattr(pt.vision.models, f"densenet{depth}")(
            num_classes=0, with_pool=False, device="meta")
        want = {121: 1024, 161: 2208, 169: 1664, 201: 1920, 264: 2688}
        assert net.norm5.weight.shape == (want[depth],), depth
        with pytest.raises(NotImplementedError):
            getattr(pt.vision.models, f"densenet{depth}")(pretrained=True)
    with pytest.raises(ValueError, match="depth"):
        pt.vision.models.DenseNet(layers=100, device="cpu")
    ref.seed(0)
    rm = ref.vision.models.DenseNet(layers=121, bn_size=2, dropout=0.2,
                                    num_classes=0, with_pool=False)
    pm = pt.vision.models.DenseNet(layers=121, bn_size=2, dropout=0.2,
                                   num_classes=0, with_pool=False,
                                   device="cpu")
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in rm.state_dict().items()}
    # a training forward draws a dense layer's dropout mask: two runs differ
    x = torch.tensor(np.random.RandomState(3).randn(2, 3, 64, 64)
                     .astype("float32"))
    a, b = pm(x), pm(x)
    assert a.shape == (2, 1024, 2, 2) and not torch.equal(a, b)
    pm.eval()
    with torch.no_grad():
        assert torch.equal(pm(x), pm(x))
