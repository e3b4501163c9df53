"""ParamAttr and Parameter (port of paddle_tpu/framework/param_attr.py
and of the reference's Parameter, core/tensor.py).

``ParamAttr`` is what a layer's ``weight_attr``/``bias_attr`` says about
the parameter it creates: its name, initializer, learning-rate factor
(kept in ``optimize_attr``; the reference's optimizers never read it,
and the port's raise for a factor other than 1.0: ROADMAP C-ref-14),
regularizer, whether it trains and whether gradient clipping applies to
it. ``Parameter`` is a ``torch.nn.Parameter`` that can carry those
attributes: torch's own tensors have a read-only ``name``, and a
parameter's attributes survive ``copy.deepcopy`` and pickling here,
which torch's Parameter drops. A write through ``p.data``, which torch's
version counter does not see, makes the degenerate-weight guard check
the parameter again (ops/_param_guard.py).
"""
from __future__ import annotations

import copy

import torch

from ..ops import _param_guard

__all__ = ["ParamAttr", "Parameter"]


def _rebuild(data, requires_grad, attrs):
    p = Parameter(data, requires_grad)
    p.__dict__.update(attrs)
    return p


_TENSOR_DATA = torch.Tensor.data


class Parameter(torch.nn.Parameter):
    # shadows the tensor's read-only ``name`` so that it can be set
    name = None

    @property
    def data(self):
        _param_guard.touch(self)
        return _TENSOR_DATA.__get__(self)

    @data.setter
    def data(self, value):
        _TENSOR_DATA.__set__(self, value)
        _param_guard.touch(self)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        return _rebuild, (self.data, self.requires_grad, dict(self.__dict__))


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> a default ParamAttr; a ParamAttr as it is; a string ->
        its name; False -> False (no parameter); anything else is an
        initializer."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr(initializer=attr)
