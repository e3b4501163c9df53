"""Random state: seeds become explicit torch.Generators.

Port of paddle_tpu/core/random.py. The reference keeps one global JAX key;
here every entry point takes a ``torch.Generator`` (a caller that passes
none draws from torch's own default generator). A CPU generator draws the
same numbers wherever the tensors end up, so a model built from a seed has
the same weights on the host and on the card.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator"]


def make_generator(seed: int = 0, device="cpu"):
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))
