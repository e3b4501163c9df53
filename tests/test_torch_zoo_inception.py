"""InceptionV3 of the PyTorch/CUDA port against the JAX reference on the
host, 10 classes (tests/test_torch_zoo_cases.py), at the reference
test's 2 x 3 x 128 x 128: InceptionA runs at 13 x 13, InceptionC at 6 x
6 and InceptionE at 2 x 2, so many windows of the pooling branches'
AvgPool2D(3, stride=1, padding=1) lie on the border, where the reference
divides by the count of in-image elements (all of them at 2 x 2). Its
training step is held block by block (ZooBlocks): at 75 x 75, the
smallest input its stride-2 stages accept, InceptionE's BatchNorms see 2
values a channel, and on an H100 one of its conv grads sat at 0.85 of
chip_smoke.py's f32-noise bound; at 128 they see 8."""
import numpy as np
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_cases import ZooBlocks, rel_l2


class TestInceptionV3(ZooBlocks):
    """Held block by block (ZooBlocks): the stem's layers one by one, each
    Inception block, and the top."""
    FAMILY = "inception_v3"


def test_border_pool_counts_in_image_elements():
    """The pooling branch of an InceptionA block against the reference on
    a 4 x 4 map, where 12 of 16 windows lie on the border."""
    x = np.random.RandomState(0).randn(1, 8, 4, 4).astype("float32")
    rp = ref.nn.AvgPool2D(3, stride=1, padding=1)
    pp = pt.nn.AvgPool2D(3, stride=1, padding=1, device="cpu")
    want = np.asarray(rp(ref.to_tensor(x))._val)
    got = pp(torch.tensor(x)).numpy()
    assert rel_l2(got, want) <= 1e-6
    np.testing.assert_allclose(got[0, 0, 0, 0], x[0, 0, :2, :2].mean(),
                               rtol=1e-6)
