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
The common surface every script touches is here too: the dtype names
(``paddle.float32`` is ``torch.float32``) and ``set_default_dtype``,
``paddle.Tensor`` (``torch.Tensor``, for ``isinstance`` and
annotations), ``create_parameter``, the grad-mode switches,
``get_cuda_rng_state``/``set_cuda_rng_state``, ``paddle.linalg`` and
``paddle.text``; the full ``nn.Layer`` API with ``set_state_dict``, every
activation, ``nn.functional``'s common functions and the initializers;
and MobileNetV1/V2 and ShuffleNetV2 in ``vision.models``.
Tensors are plain ``torch.Tensor``s: there is no paddle Tensor facade,
``loss.backward()`` is torch's, and ``no_grad`` is torch's; the
reference's patched Tensor methods are functions here (``cast`` for
``astype``).
"""
import torch
from torch import enable_grad, no_grad, set_grad_enabled

from . import (amp, callbacks, distributed, hapi, incubate, inference,
               io, jit, metric, nn, optimizer, regularizer, serving, tensor,
               text, vision)
from .core.device import (CPUPlace, CUDAPlace, Place, device_count,
                          get_device, set_device)
from .core.dtypes import (bfloat16, complex64, complex128, convert_dtype,
                          float16, float32, float64, get_default_dtype,
                          int8, int16, int32, int64, is_complex, is_floating,
                          is_integer, set_default_dtype, uint8)
from .core.dtypes import bool_ as bool  # noqa: A001
from .core.random import (get_cuda_rng_state, make_generator, seed,
                          set_cuda_rng_state)
from .distributed.parallel import DataParallel
from .framework.flags import get_flags, set_flags
from .framework.io_utils import (full_state_dict, load,
                                 load_numpy_state_dict, save)
from .framework.param_attr import ParamAttr, Parameter
from .hapi import Model, flops, summary
from .nn.functional.activation import tanh_
from .tensor import *  # noqa: F401,F403
# the tensor API's modules, as the reference's star import binds them
from .tensor import (attribute, creation, linalg, logic,  # noqa: F401
                     manipulation, math, random, search, stat)

Tensor = torch.Tensor
dtype = torch.dtype
# host memory the card reads directly; the reference names the host so
CUDAPinnedPlace = CPUPlace


def is_compiled_with_cuda():
    """True when torch was built with CUDA. The TPU reference answers
    False here; the port runs on the card (ROADMAP: a difference by
    design)."""
    return torch.version.cuda is not None


def is_compiled_with_tpu():
    return False


def is_grad_enabled():
    return torch.is_grad_enabled()


def in_dynamic_mode():
    """Always True: the port has no static-graph mode (ROADMAP A13)."""
    return True


def disable_static(place=None):
    """Return to dynamic mode, which the port never leaves."""
    return None


def enable_static():
    raise NotImplementedError(
        "enable_static: the static-graph mode (paddle.static) is not "
        "ported yet (ROADMAP A13); to_static captures steps instead")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     linewidth=None, sci_mode=None):
    """How tensors print (torch.set_printoptions)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A Parameter of ``shape`` and ``dtype`` on the current device: the
    attribute's initializer, else ``default_initializer``, else 0 for a
    bias and XavierNormal for a weight, drawn from torch's default
    generator."""
    from .core.device import resolve_device
    from .nn import initializer as I
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    value = init(list(shape), convert_dtype(dtype), resolve_device(), None)
    p = Parameter(value, requires_grad=attr.trainable)
    p.name = name or attr.name
    return p


def tolist(x):
    return x.tolist()


def batch(reader, batch_size, drop_last=False):
    """The fluid-style batch reader decorator: lists of ``batch_size``
    items from ``reader()``."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def check_shape(shape):
    """Raise TypeError for a shape entry that is neither an int nor a
    tensor."""
    if isinstance(shape, torch.Tensor):
        return
    for d in list(shape):
        if not isinstance(d, int) and not hasattr(d, "shape"):
            raise TypeError(f"invalid dim {d!r} in shape {shape!r}")


def disable_signal_handler():
    """No native signal handler is installed, so there is none to
    disable."""
    return None


__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "Place",
           "set_device", "get_device", "device_count", "make_generator",
           "seed", "load", "load_numpy_state_dict", "full_state_dict", "save",
           "amp",
           "callbacks", "distributed", "hapi", "inference", "io", "jit",
           "metric", "nn", "optimizer", "regularizer", "serving", "tensor",
           "text", "vision", "linalg", "Model", "summary", "flops",
           "DataParallel",
           "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "get_flags", "set_flags", "ParamAttr", "Parameter", "Tensor",
           "dtype", "bool", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "get_default_dtype", "set_default_dtype",
           "convert_dtype", "is_floating", "is_integer", "is_complex",
           "get_cuda_rng_state", "set_cuda_rng_state",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "in_dynamic_mode", "disable_static", "enable_static",
           "set_printoptions", "create_parameter", "tanh_", "tolist",
           "batch", "check_shape", "disable_signal_handler",
           *tensor.__all__]
