"""Places and devices: paddle's Place names over torch.device.

Port of paddle_tpu/core/device.py. ``CUDAPlace(i)`` is a real device here;
the default device is ``cuda:0``, and resolving it without a visible card
raises instead of falling back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "resolve_device"]


class Place:
    """Identifies a physical device."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        raise NotImplementedError

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"


class CPUPlace(Place):
    kind = "cpu"

    @property
    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    kind = "cuda"

    @property
    def torch_device(self):
        return torch.device("cuda", self.device_id)


def resolve_device(device=None):
    """torch.device for a Place, a torch.device, a string ("cpu", "cuda:1",
    paddle's "gpu:1") or None (the default device, cuda:0). A CUDA device
    without a visible card raises."""
    if device is None:
        device = CUDAPlace(0)
    if isinstance(device, Place):
        device = device.torch_device
    elif isinstance(device, str):
        device = torch.device(device.replace("gpu", "cuda"))
    else:
        device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{device} requested but no CUDA device is visible; pass "
            f"device='cpu' to run on the host")
    return device
