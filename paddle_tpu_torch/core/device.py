"""Places and devices: paddle's Place names over torch.device.

Port of paddle_tpu/core/device.py. ``CUDAPlace(i)`` is a real device here;
the default device is ``cuda:0`` until ``set_device`` names another, and
resolving a CUDA device without a visible card raises instead of falling
back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "resolve_device", "set_device",
           "get_device", "device_count"]

# the place set_device chose (None: cuda:0)
_current = None


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


def _place_of(device):
    """The Place named by a Place, a torch.device or a string ("cpu",
    "gpu", "gpu:1", "cuda:1")."""
    if isinstance(device, Place):
        return device
    d = torch.device(device.lower().replace("gpu", "cuda")
                     if isinstance(device, str) else device)
    if d.type == "cpu":
        return CPUPlace(0)
    if d.type == "cuda":
        return CUDAPlace(d.index or 0)
    raise ValueError(f"unknown device {device!r}")


def set_device(device):
    """paddle.device.set_device: the device that entry points and the
    tensor API's creation functions use when the caller names none.
    Returns its Place."""
    global _current
    _current = _place_of(device)
    return _current


def get_device():
    """The current device in paddle's spelling: "gpu:0" or "cpu"."""
    p = _current or CUDAPlace(0)
    return "cpu" if p.kind == "cpu" else f"gpu:{p.device_id}"


def device_count(kind="gpu"):
    """How many devices of ``kind`` ("gpu"/"cuda" or "cpu") are visible."""
    if kind in ("gpu", "cuda"):
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"unknown device kind {kind!r}")


def resolve_device(device=None):
    """torch.device for a Place, a torch.device, a string ("cpu", "cuda:1",
    paddle's "gpu:1") or None (the device ``set_device`` chose, cuda:0 by
    default). A CUDA device without a visible card raises."""
    if device is None:
        device = _current or CUDAPlace(0)
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
