"""paddle.regularizer: L1Decay and L2Decay (port of
paddle_tpu/regularizer.py).

The optimizer adds ``grad_term(param)`` to a parameter's gradient before
its update, for a list of parameters at once (``grad_terms``, one
multi-tensor pass): a regularizer set through ``ParamAttr`` wins over the
optimizer's ``weight_decay`` (optimizer/optimizer.py ``_apply_decay``).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def grad_term(self, param):
        return self.grad_terms([param])[0]

    def grad_terms(self, params):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """coeff * param: the gradient of coeff / 2 * ||param||^2."""

    def grad_terms(self, params):
        return torch._foreach_mul(params, self._coeff)


class L1Decay(WeightDecayRegularizer):
    """coeff * sign(param): the gradient of coeff * ||param||_1."""

    def grad_terms(self, params):
        terms = torch._foreach_sign(params)
        torch._foreach_mul_(terms, self._coeff)
        return terms
