"""Gradient clipping (port of paddle_tpu/nn/clip.py).

Each clip maps (param, grad) pairs to new pairs, as the reference's
``_dygraph_clip`` does; ``Optimizer(grad_clip=...)`` applies it before
the update, and ``p.grad`` itself is left as it was. A parameter with
``need_clip = False`` keeps its grad. The norms and scales stay tensors
on the device (no ``.item()``, no host branch on a device value), so a
step that clips can be captured as a CUDA graph; the squared norms are
summed in float32 whatever the grad's dtype.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _f32_norms(grads):
    """Each grad's L2 norm as an f32 0-d tensor."""
    return torch._foreach_norm([g if g.dtype == torch.float32 else g.float()
                                for g in grads])


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled by min(clip_norm / max(||g||, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        picked = [g for p, g in params_grads if _clipped(p, g)]
        if not picked:
            return params_grads
        scales = iter([torch.clamp(self.clip_norm / n.clamp_min(1e-12),
                                   max=1.0) for n in _f32_norms(picked)])
        return [(p, g * next(scales).to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad scaled by clip_norm / max(global_norm, clip_norm), the
    global norm taken over all clipped grads together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        picked = [g for p, g in params_grads if _clipped(p, g)]
        if not picked:
            return params_grads
        global_norm = torch.linalg.vector_norm(torch.stack(_f32_norms(picked)))
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, g * scale.to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]
