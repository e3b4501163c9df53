"""Linear algebra (port of paddle_tpu/tensor/linalg.py).

torch.linalg underneath, with the reference's conventions: ``norm``'s
``p`` ("fro", inf, -inf, 0 or a number), ``cross``'s default axis (the
first of size 3), ``lu``'s 1-based int32 pivots, ``lstsq``'s (solution,
residuals, rank, singular values) on every device, counts as int32.
"""
from __future__ import annotations

import torch

__all__ = ["matmul", "dot", "bmm", "mm", "mv", "t", "transpose", "norm",
           "dist", "cross", "cholesky", "inverse", "pinv", "solve",
           "triangular_solve", "cholesky_solve", "lstsq", "qr", "svd", "eig",
           "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank",
           "slogdet", "det", "multi_dot", "histogram", "bincount", "corrcoef",
           "cov", "lu", "lu_unpack", "householder_product", "inv", "cond"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y, name=None):
    """sum(x * y) over the last axis (batched over the others)."""
    return torch.sum(x * y, -1)


def bmm(x, y, name=None):
    return torch.matmul(x, y)


def mm(input, mat2, name=None):  # noqa: A002
    return torch.matmul(input, mat2)


def mv(x, vec, name=None):
    return torch.matmul(x, vec)


def t(input, name=None):  # noqa: A002
    """Every axis reversed (a 1-D or 0-d tensor is itself)."""
    return input.permute(*reversed(range(input.dim()))) \
        if input.dim() >= 2 else input


def transpose(x, perm, name=None):
    from .manipulation import transpose as _transpose
    return _transpose(x, perm)


def _dims(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    ax = _dims(axis)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.sqrt(torch.sum(torch.square(x), ax, keepdim=keepdim))
    if ax is None:
        ax = tuple(range(x.dim()))
    if p == float("inf"):
        return torch.amax(torch.abs(x), ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), ax, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, ax, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(x - y, p=p)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (9, paddle's default: the first
    axis of size 3)."""
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def inverse(x, name=None):
    return torch.linalg.inv(x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve x @ out = y (x.T @ out = y with ``transpose``) for a
    triangular x."""
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A @ out = x, where y is A's Cholesky factor."""
    return torch.cholesky_solve(x, y, upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), as numpy's lstsq
    gives them: the residuals' squared norms only for a full-rank tall x,
    else empty."""
    sol = torch.linalg.lstsq(x, y, rcond=rcond).solution
    sv = torch.linalg.svdvals(x)
    m, n = x.shape[-2], x.shape[-1]
    tol = (torch.finfo(x.dtype).eps * max(m, n) if rcond is None
           else rcond) * sv[..., :1]
    rank = (sv > tol).sum(-1).to(torch.int32)
    if m > n and bool((rank == n).all()):
        res = torch.sum(torch.square(x @ sol - y), -2)
    else:
        res = torch.zeros(0, dtype=x.dtype, device=x.device)
    return sol, res, rank, sv


def qr(x, mode="reduced", name=None):
    """(q, r), or r alone with mode "r"."""
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian).to(
        torch.int32)


def slogdet(x, name=None):
    """[sign, log|det|] stacked on a leading axis."""
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def det(x, name=None):
    return torch.linalg.det(x)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """int32 counts in ``bins`` equal bins over [min, max] (the data's
    range when both are 0), the last bin closed."""
    return torch.histc(input.float(), bins, min, max).to(torch.int32)


def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x.long(), weights, minlength)
    return out.to(weights.dtype if weights is not None else torch.int32)


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots) and, with ``get_infos``, a zero
    int32 info tensor."""
    packed, piv = torch.linalg.lu_factor(x, pivot=pivot)
    piv = piv.to(torch.int32)
    if get_infos:
        return packed, piv, torch.zeros(x.shape[:-2], dtype=torch.int32,
                                        device=x.device)
    return packed, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) with A = P @ L @ U from ``lu``'s packed LU and pivots."""
    P, L, U = torch.lu_unpack(x, y)
    if not unpack_ludata:
        return P, None, None
    if not unpack_pivots:
        return None, L, U
    return P, L, U


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)


def cond(x, p=None, name=None):
    return torch.linalg.cond(x, 2 if p is None else p)
