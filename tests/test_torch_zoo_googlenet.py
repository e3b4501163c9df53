"""GoogLeNet of the PyTorch/CUDA port against the JAX reference on the
host at 2 x 3 x 64 x 64, 10 classes (tests/test_torch_zoo_cases.py): its
three outputs (main, aux1, aux2) in eval and, block by block, in
training, the loss the main cross-entropy plus 0.3 of each aux head's; and ``x`` alone when
``num_classes`` is 0."""
import numpy as np
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_zoo_cases import ZooBlocks

class TestGoogLeNet(ZooBlocks):
    """Held block by block (ZooBlocks, googlenet_stages)."""
    FAMILY = "googlenet"


def test_headless_googlenet_returns_features_alone():
    pm = pt.vision.models.googlenet(num_classes=0, device="cpu")
    rm = ref.vision.models.googlenet(num_classes=0)
    assert sorted(pm.state_dict()) == sorted(rm.state_dict())
    pm.eval()
    with torch.no_grad():
        out = pm(torch.tensor(np.zeros((1, 3, 32, 32), "float32")))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 1024, 1, 1)
