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
Scripts train through the high-level API: ``Model(net).prepare(opt,
nn.CrossEntropyLoss(), metric.Accuracy())`` then ``fit``, ``evaluate``,
``predict``, ``save`` and ``load``, over ``io.DataLoader`` and the
``vision.datasets`` and ``vision.transforms``, with ``callbacks``.
Models serve through ``inference`` (``Config``, ``Predictor``: a CUDA
graph per input signature) and ``serving`` (``InferenceServer``: bounded
queue, admission control, shape-bucketed batching, replicas behind a
scheduler, and the continuous-batching ``DecodeEngine``).
Around them a script has the rest of the surface: every optimizer of the
reference (``optimizer``; multi-tensor passes, parameter groups,
``minimize``, sparse updates), ``ParamAttr`` and ``regularizer``,
``nn.Embedding(sparse=True)``, ``set_device`` and the functional tensor
API (``to_tensor``, ``concat``, ``gather``, ``topk``, ``einsum``, ...;
``tensor/``), exported here.
Tensors are plain ``torch.Tensor``s: there is no paddle Tensor facade,
``loss.backward()`` is torch's, and ``no_grad`` is torch's; the
reference's patched Tensor methods are functions here (``cast`` for
``astype``).
"""
from torch import no_grad

from . import (amp, callbacks, distributed, hapi, inference, io, jit,
               metric, nn, optimizer, regularizer, serving, tensor, vision)
from .core.device import (CPUPlace, CUDAPlace, device_count, get_device,
                          set_device)
from .core.random import make_generator, seed
from .framework.flags import get_flags, set_flags
from .framework.io_utils import load, load_numpy_state_dict, save
from .framework.param_attr import ParamAttr, Parameter
from .hapi import Model, flops, summary
from .tensor import *  # noqa: F401,F403

__all__ = ["CPUPlace", "CUDAPlace", "set_device", "get_device",
           "device_count", "make_generator", "seed", "load",
           "load_numpy_state_dict", "save", "amp", "callbacks",
           "distributed", "hapi", "inference", "io", "jit", "metric", "nn",
           "optimizer", "regularizer", "serving", "tensor", "vision",
           "Model", "summary", "flops", "no_grad", "get_flags", "set_flags",
           "ParamAttr", "Parameter", *tensor.__all__]
