"""Matrix-product abstraction over dense and sparse (BCOO) data matrices.

The reference claims sparse support by genericity: its solvers touch X only
through ``mul!`` and elementwise loops, so Julia sparse matrices work
(SURVEY.md §2A "Genericity", reference README "Sparse NMF — Done").  Here the
same role is played by this module: every solver routes its X-products
through these functions, so any X supported here works in every solver.

Sparse design:

* ``X @ H'`` and ``W' X`` are sparse-dense matmuls (``bcoo_dot_general``);
* the divergence updater's quotient ``Q = X ./ (WH + delta)`` has **X's
  sparsity pattern** (0/y = 0), so it is an SDDMM: sample ``W @ H`` at X's
  indices (``bcoo_dot_general_sampled``), divide into X's values — the p x n
  dense WH is never formed;
* objectives use the expansion ``||X - WH||^2 = ||X||^2 - 2<X, WH> +
  <W'W, HH'>`` with the inner product sampled at nnz, and
  ``sum(WH) = colsum(W) . rowsum(H)`` for the KL mass term.

The CSR-order stores (``TiledCSR`` on one device, ``ShardedTiled`` on a
mesh) run their products through ``nmf_tpu.ops.tiled``: plain XLA, with the
SDDMM a Triton kernel on the GPU; another product can be slotted behind
``mm``/``mtm``/``sddmm`` without touching any solver.
"""

from __future__ import annotations

import jax.numpy as jnp

try:
    from jax.experimental import sparse as jsparse

    BCOO = jsparse.BCOO
except Exception:  # pragma: no cover
    jsparse = None
    BCOO = ()


def is_tiled(X) -> bool:
    from .sparse_format import TiledCSR

    return isinstance(X, TiledCSR)


def is_sharded_tiled(X) -> bool:
    from .sparse_shard import ShardedTiled

    return isinstance(X, ShardedTiled)

__all__ = [
    "is_sparse",
    "is_tiled",
    "is_sharded_tiled",
    "col_indices",
    "mm",
    "mtm",
    "sddmm",
    "scale_values",
    "sq_norm",
    "total_sum",
    "colsums",
    "rowsums",
    "nnz_values",
    "all_nonneg",
    "transpose",
    "mean",
]


def is_sparse(X) -> bool:
    if is_tiled(X) or is_sharded_tiled(X):
        return True
    return jsparse is not None and isinstance(X, jsparse.JAXSparse)


def _as_bcoo(X):
    if isinstance(X, BCOO):
        return X
    return X.to_bcoo() if hasattr(X, "to_bcoo") else X


def mm(X, D):
    """``X @ D`` for dense or sparse X (dense result)."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_mm

        return sharded_mm(X, D).astype(D.dtype)
    if is_tiled(X):
        from .tiled import tiled_mm

        return tiled_mm(X, D).astype(D.dtype)
    if is_sparse(X):
        return jsparse.bcoo_dot_general(
            _as_bcoo(X), D, dimension_numbers=(((1,), (0,)), ((), ()))
        )
    return X @ D


def mtm(D, X):
    """``D @ X`` with D dense (used as ``W.T @ X``; dense result)."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_mtm

        return sharded_mtm(X, D.T).T.astype(D.dtype)
    if is_tiled(X):
        from .tiled import tiled_mtm

        return tiled_mtm(X, D.T).T.astype(D.dtype)
    if is_sparse(X):
        # Contract X's axis 0 with D' directly: (n, k) = X'D', transposed.
        # (Avoids re-executing a bcoo_transpose index permutation on every
        # solve-loop iteration; measured within noise of the transpose form.)
        return jsparse.bcoo_dot_general(
            _as_bcoo(X), D.T, dimension_numbers=(((0,), (0,)), ((), ()))
        ).T
    return D @ X


def sddmm(W, H, X):
    """Values of ``(W @ H)`` sampled at X's nonzero positions, aligned with
    ``nnz_values(X)`` (only valid for sparse X).  Flat (nnz,) for one-device
    formats; the (R, C, L) entry layout for ``ShardedTiled``."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_sddmm

        return sharded_sddmm(X, W, H)
    if is_tiled(X):
        from .tiled import tiled_sddmm

        return tiled_sddmm(X, W, H)
    Xb = _as_bcoo(X)
    return jsparse.bcoo_dot_general_sampled(
        W, H, Xb.indices, dimension_numbers=(((1,), (0,)), ((), ()))
    )


def scale_values(X, new_values):
    """Sparse X with the same pattern but new values."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_scale_values

        return sharded_scale_values(X, new_values)
    if is_tiled(X):
        return X.with_values(new_values)
    Xb = _as_bcoo(X)
    return BCOO((new_values, Xb.indices), shape=Xb.shape)


def nnz_values(X):
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_nnz_values

        return sharded_nnz_values(X)
    if is_tiled(X):
        return X.values
    return _as_bcoo(X).data


def sq_norm(X):
    """``sum(X**2)``."""
    if is_tiled(X) or is_sharded_tiled(X):
        return X.stats[1]
    if is_sparse(X):
        v = nnz_values(X)
        return jnp.sum(v * v)
    return jnp.sum(X * X)


def total_sum(X):
    if is_tiled(X) or is_sharded_tiled(X):
        return X.stats[0]
    if is_sparse(X):
        return jnp.sum(nnz_values(X))
    return jnp.sum(X)


def mean(X):
    return total_sum(X) / (X.shape[0] * X.shape[1])


def colsums(X):
    """(n,) column sums."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_colsums

        return sharded_colsums(X)
    if is_tiled(X):
        return jnp.zeros((X.shape[1],), X.dtype).at[X.col_idx].add(X.values)
    if is_sparse(X):
        return jsparse.bcoo_reduce_sum(_as_bcoo(X), axes=(0,)).todense()
    return jnp.sum(X, axis=0)


def rowsums(X):
    """(p,) row sums."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_rowsums

        return sharded_rowsums(X)
    if is_tiled(X):
        return jnp.zeros((X.shape[0],), X.dtype).at[X.row_idx].add(X.values)
    if is_sparse(X):
        return jsparse.bcoo_reduce_sum(_as_bcoo(X), axes=(1,)).todense()
    return jnp.sum(X, axis=1)


def all_nonneg(X):
    if is_tiled(X) or is_sharded_tiled(X):
        return X.stats[2] >= 0
    if is_sparse(X):
        return jnp.all(nnz_values(X) >= 0)
    return jnp.all(X >= 0)


def transpose(X):
    if is_tiled(X) or is_sharded_tiled(X):
        return X.transpose()
    if is_sparse(X):
        return jsparse.bcoo_transpose(_as_bcoo(X), permutation=(1, 0))
    return X.T


def col_indices(X):
    """Column index of each stored value, aligned with ``nnz_values(X)``
    (sparse only)."""
    if is_sharded_tiled(X):
        from .sparse_shard import sharded_col_ids

        return sharded_col_ids(X)
    if is_tiled(X):
        return X.col_idx
    return _as_bcoo(X).indices[:, 1]
