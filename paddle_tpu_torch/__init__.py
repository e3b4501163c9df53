"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX reference. It imports torch and never jax
or paddle_tpu. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``. Every Pallas kernel of the reference on the
ported path is a CUDA kernel written by hand for Hopper (``csrc/``),
built with nvcc at first use, with its plain PyTorch version beside it.

GPT serves (prefill and KV-cached greedy decode) and trains
(``GPTForCausalLM(ids, labels=...)``, ``loss.backward()``, an ``optimizer``
step) through ``paddle_tpu_torch.text.models.gpt``; a step under
``jit.to_static`` is captured as one CUDA graph, with ``amp``, learning-
rate schedulers (``optimizer.lr``), grad clipping (``nn.ClipGradBy*``) and
recompute around it. ResNet (``vision.models.resnet50``, NCHW or NHWC
as channels_last, the space-to-depth stem, the fused conv + BN op) and
LeNet train and evaluate through ``paddle_tpu_torch.vision.models``.
Tensors are plain ``torch.Tensor``s: there is no paddle Tensor facade,
``loss.backward()`` is torch's, and ``no_grad`` is torch's.
"""
from torch import no_grad

from . import amp, distributed, jit, nn, optimizer, vision
from .core.device import CPUPlace, CUDAPlace
from .core.random import make_generator
from .framework.flags import get_flags, set_flags
from .framework.io_utils import load, load_numpy_state_dict, save

__all__ = ["CPUPlace", "CUDAPlace", "make_generator", "load",
           "load_numpy_state_dict", "save", "amp", "distributed", "jit",
           "nn", "optimizer", "vision", "no_grad", "get_flags", "set_flags"]
