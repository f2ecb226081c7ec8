"""paddle_tpu_torch.linalg: the linear algebra namespace (re-exports of
`ops.linalg` and the linalg ops of `ops.extras`), as
paddle_tpu/linalg.py."""
from .ops.extras import (  # noqa: F401
    cholesky_inverse, lu_unpack, ormqr, svd_lowrank)
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, householder_product, inv, lstsq, lu, matmul, matrix_norm,
    matrix_power, matrix_rank, matrix_transpose, multi_dot, norm, pca_lowrank,
    pinv, qr, slogdet, solve, svd, svdvals, triangular_solve, vector_norm)
