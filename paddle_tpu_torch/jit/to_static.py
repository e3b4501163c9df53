"""paddle.jit.to_static (port of paddle_tpu/jit/to_static.py's surface).

The decorator keeps paddle's call surface: it takes a function or a Layer
(whose forward it wraps), accepts ``input_spec`` and ``build_strategy``,
and binds per instance when it decorates a method. The wrapped function
runs eagerly, as written: PyTorch needs no trace to run a step, and each
call executes the Python body with its kernels launched on the current
stream. Capturing the whole step as a CUDA graph, the counterpart of the
reference's compiled programs (``jit/compiled_step.py``), comes with a
later slice (ROADMAP A2).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["to_static", "StaticFunction", "InputSpec"]


class InputSpec:
    """paddle.static.InputSpec: the shape and dtype of an input."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


class StaticFunction:
    """A function decorated by ``to_static``; calling it runs the function."""

    def __init__(self, fn, input_spec=None, build_strategy=None):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._input_spec = input_spec

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return StaticFunction(self._fn.__get__(instance, owner),
                              self._input_spec)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorate a function (or a Layer, whose forward is wrapped); usable
    bare (``@to_static``) or with arguments (``@to_static(input_spec=...)``).
    """

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(type(fn).forward.__get__(fn),
                                        input_spec)
            return fn
        return StaticFunction(fn, input_spec, build_strategy)

    if function is not None:
        return decorate(function)
    return decorate
