"""Linear algebra ops (cuBLAS and cuSOLVER through torch on the card).

Port of paddle_tpu/ops/linalg.py; `paddle_tpu_torch.linalg` re-exports
them. `svd` returns V (not V^H), `eigh` / `eigvalsh` read the `UPLO`
triangle and mirror it (so the gradient reaches that triangle only), and
`lu` gives 1-based int32 pivots, as the reference's.
"""
from __future__ import annotations

import torch

from ..core.dispatch import op
from ._helpers import public


def _mT(a):
    return a.transpose(-1, -2) if a.dim() > 1 else a


@op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x:
        x = _mT(x)
    if transpose_y:
        y = _mT(y)
    return torch.matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


@op("bmm")
def bmm(x, y, name=None):
    return torch.matmul(x, y)


@op("mv")
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


@op("dot")
def dot(x, y, name=None):
    return torch.sum(x * y, -1)


@op("inner")
def inner(x, y, name=None):
    return torch.inner(x, y)


@op("outer")
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


@op("cross")
def cross(x, y, axis=9, name=None):
    ax = axis
    if ax == 9:
        ax = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=ax)


@op("einsum")
def einsum(equation, *operands, name=None):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *operands)


@op("multi_dot")
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


@op("kron")
def kron(x, y, name=None):
    return torch.kron(x, y)


@op("cholesky")
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@op("qr")
def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


@op("svd")
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mH


@op("svdvals")
def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


@op("eig", n_diff=0)
def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


def _mirror(a, uplo):
    i = torch.arange(a.shape[-1], device=a.device)
    keep = i[:, None] >= i[None, :] if uplo == "L" else \
        i[:, None] <= i[None, :]
    return torch.where(keep, a, a.mT.conj())


@op("eigh")
def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_mirror(x, UPLO)))


@op("eigvals", n_diff=0)
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@op("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_mirror(x, UPLO))


@op("inverse")
def inverse(x, name=None):
    return torch.linalg.inv(x)


inv = inverse


@op("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@op("det")
def det(x, name=None):
    return torch.linalg.det(x)


@op("slogdet")
def slogdet(x, name=None):
    return tuple(torch.linalg.slogdet(x))


@op("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    if transpose:
        return torch.linalg.solve_triangular(
            x.mT, y, upper=not upper, unitriangular=unitriangular)
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@op("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@op("lstsq", n_diff=0)
def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), as jnp's: the
    minimum-norm solution, and the residuals ||y - x @ solution||^2 per
    column of y at every shape and rank (jnp returns them in all cases;
    a 1-D y gives one)."""
    s = torch.linalg.svdvals(x)
    rtol = rcond if rcond is not None else \
        torch.finfo(x.dtype).eps * max(x.shape[-2:])
    sol = torch.linalg.pinv(x, rtol=rtol) @ y
    rank = (s > rtol * s.amax(-1, keepdim=True)).sum(-1)
    est = x @ (sol if y.dim() > 1 else sol[:, None])
    res = torch.linalg.vector_norm((y if y.dim() > 1 else y[:, None]) - est,
                                   dim=-2) ** 2
    return sol, res, rank, s


@op("lu", n_diff=0)
def _lu(x):
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, piv.to(torch.int32)


def lu(x, pivot=True, get_infos=False, name=None):
    if not pivot:
        raise NotImplementedError(
            "lu(pivot=False): the factorization is always partial-pivoted, "
            "as the reference's")
    out = _lu(x)
    if get_infos:
        from .creation import zeros

        return out[0], out[1], zeros([1], dtype="int32")
    return out


@op("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


@op("matrix_rank", n_diff=0)
def matrix_rank(x, tol=None, hermitian=False, name=None):
    if tol is None:
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


@op("cond", n_diff=0)
def cond(x, p=None, name=None):
    return torch.linalg.cond(x, p)


@op("matrix_transpose")
def matrix_transpose(x, name=None):
    return x.transpose(-1, -2)


@op("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.mT)


@op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.mT, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@op("householder_product")
def householder_product(x, tau, name=None):
    """Q of the reflectors in x's columns and their taus (the reference's
    loop: H_i = I - tau_i v_i v_i^T, Q = H_0 ... H_{n-1})."""
    m, n = x.shape[-2], x.shape[-1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    rows = torch.arange(m, device=x.device)[:, None]
    q = eye.expand(x.shape[:-2] + (m, m))
    for i in range(n):
        v = torch.where(rows >= i, x[..., :, i:i + 1], 0.0)
        if v.dim() == 2:
            v = torch.where(rows == i, torch.ones_like(v), v)
        h = eye - tau[..., i][..., None, None] * (v @ v.mT)
        q = q @ h
    return q[..., :, :n]


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    from .reduction import norm as _n

    return _n(x, p=p, axis=axis, keepdim=keepdim)


def vector_norm(x, p=2, axis=None, keepdim=False, name=None):
    from .reduction import norm as _n

    return _n(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    from .reduction import norm as _n

    return _n(x, p=p, axis=axis, keepdim=keepdim)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    raise NotImplementedError("histogramdd is not implemented in the "
                              "reference either")


@op("pca_lowrank", n_diff=0)
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    if center:
        x = x - x.mean(-2, keepdim=True)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    k = q or min(x.shape[-2:])
    return u[..., :k], s[..., :k], vh.mT[..., :k]


__all__ = public(globals())
