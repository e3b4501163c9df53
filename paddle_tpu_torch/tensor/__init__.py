"""The functional tensor API (port of paddle_tpu/tensor/__init__.py):
paddle's names and conventions over plain ``torch.Tensor``s, exported as
``paddle_tpu_torch.*``. torch.Tensor is not patched (the port has no
Tensor facade): what the reference reaches as a patched method that torch
lacks or names otherwise (``astype``, ``transpose(perm)``, ...) is a
function here (``cast``, ``transpose``)."""
from . import (attribute, creation, einsum as _einsum_mod, linalg,  # noqa: F401
               logic, manipulation, math, random, search, stat)
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import median, numel, quantile, std, var  # noqa: F401

__all__ = sorted({*attribute.__all__, *creation.__all__, "einsum",
                  *linalg.__all__, *logic.__all__, *manipulation.__all__,
                  *math.__all__, *random.__all__, *search.__all__, "median",
                  "numel", "quantile", "std", "var"})
