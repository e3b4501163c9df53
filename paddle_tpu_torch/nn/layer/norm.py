"""The norm layers (port of paddle_tpu/nn/layer/norm.py): LayerNorm, the
batch norms, SyncBatchNorm, GroupNorm, the instance norms,
LocalResponseNorm and SpectralNorm.

SyncBatchNorm normalises a training batch by the statistics of the whole
data-parallel batch: each rank's per-channel sums go through an
all-reduce over the mesh's data group, so every rank normalises by what
one process would compute on the global batch, which is what the
reference's data-parallel run computes (its batch axis is sharded inside
one compiled program). Outside a process group, and in eval, it is
BatchNorm. Its backward sums the gradients of the statistics over the
group as well, so the input's gradient is that of the ranks' summed
losses, as in torch's SyncBatchNorm; DataParallel's average of the
parameter gradients then gives the global batch's (ROADMAP C-ref-21).

The batch norms keep their running statistics in buffers named ``_mean``
and ``_variance``, as the reference's state dict does, in the layer's
dtype; ``model.bfloat16()`` casts them with the parameters, as the
reference's ``Layer.to`` does. The instance norms' affine parameters are
``scale`` and ``bias`` (both absent when either attr is False), and the
reference never reads their ``momentum``: anything but 0.9 raises
(ROADMAP C-ref-17). SpectralNorm's ``weight_u`` and ``weight_v`` are
parameters that take no gradient (every optimizer skips them) and are
written in place by each forward's power iteration."""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast
from .. import functional as F
from .. import initializer as I
from ..functional.norm import _bn_axes, update_running_stats
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, **factory):
        super().__init__(**factory)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, **factory):
        super().__init__(**factory)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=self._dtype, device=self._device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=self._dtype, device=self._device))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """fluid.dygraph.BatchNorm-compatible alias."""


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **factory):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         **factory)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **factory):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         **factory)



class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its adjoint sums the gradients over the group
    too (every rank's copy of the sum feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed.collective import all_reduce
        ctx.group = group
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        from ...distributed.collective import all_reduce
        return all_reduce(grad.clone(), group=ctx.group), None


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm over the whole data-parallel batch (module docstring,
    ROADMAP C-ref-21)."""

    def forward(self, x):
        from ...distributed.collective import _dist
        from ...distributed.mesh import get_mesh
        use_global = self._use_global_stats
        if use_global is None:
            use_global = not self.training
        if use_global or _dist() is None:
            return super().forward(x)
        group = get_mesh().group("data")
        ch, red, bshape = _bn_axes(x, self._data_format)
        x, weight, bias = amp_cast("batch_norm", x, self.weight, self.bias)
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        n_local = x.numel() // x.shape[ch]
        sums = _AllReduceSum.apply(torch.cat([
            xf.sum(dim=red), xf.new_full((1,), float(n_local))]), group)
        n = sums[-1]
        mean = sums[:-1] / n
        centred = xf - mean.reshape(bshape)
        var = _AllReduceSum.apply((centred * centred).sum(dim=red),
                                  group) / n
        out = centred * torch.rsqrt(var.reshape(bshape) + self._epsilon)
        update_running_stats(self._mean, self._variance, mean.detach(),
                             var.detach(), int(n.item()), self._momentum)
        out = out.to(x.dtype)
        if weight is not None:
            out = out * weight.reshape(bshape)
        if bias is not None:
            out = out + bias.reshape(bshape)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        SyncBatchNorm that shares its parameters and statistics."""
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            sync = cls.__new__(cls)
            Layer.__init__(sync)
            for k in ("_num_features", "_momentum", "_epsilon",
                      "_data_format", "_use_global_stats"):
                setattr(sync, k, getattr(layer, k))
            sync.weight, sync.bias = layer.weight, layer.bias
            sync.register_buffer("_mean", layer._mean)
            sync.register_buffer("_variance", layer._variance)
            sync.train(layer.training)
            return sync
        for name, sub in layer.named_children():
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer

class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, **factory):
        super().__init__(**factory)
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, **factory):
        super().__init__(**factory)
        if momentum != 0.9:
            raise NotImplementedError(
                f"momentum={momentum!r}: the reference's instance norms keep "
                f"no running statistics and never read it (ROADMAP "
                f"C-ref-17)")
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None, **factory):
        super().__init__(**factory)
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """weight / sigma, sigma the largest singular value of ``weight``
    seen as a (weight_shape[dim], -1) matrix, estimated by
    ``power_iters`` steps of power iteration from the stored ``u`` and
    ``v``. The iteration runs outside the gradient (sigma = u^T W v with
    u, v constants, as the reference's op differentiates it)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32", **factory):
        super().__init__(**factory)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = math.prod(s for i, s in enumerate(weight_shape) if i != dim)
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        weight, = amp_cast("spectral_norm", weight)
        dim = self._dim
        perm = (dim,) + tuple(i for i in range(weight.dim()) if i != dim)
        mat = weight.permute(perm).reshape(weight.shape[dim], -1)
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            fixed = mat.detach()
            for _ in range(self._power_iters):
                v = fixed.T @ u
                v = v / (torch.linalg.vector_norm(v) + self._eps)
                u = fixed @ v
                u = u / (torch.linalg.vector_norm(u) + self._eps)
            if self._power_iters:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return weight / (u @ mat @ v)
