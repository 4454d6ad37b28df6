"""Products over the CSR-order sparse store, in plain XLA.

A ``TiledCSR`` keeps its nonzeros as entries (row, col, value) sorted by
row, with the order that sorts them by column.  Its products are one
gather, scale and sorted segment-sum over the entries (:func:`csr_product`),
and its SDDMM one gather-gather-reduce (:func:`entries_sddmm`, a Triton
kernel on the GPU).  The per-device blocks of ``sparse_shard.ShardedTiled``
run the same two functions.  Every product is exact float32 elementwise
work, so no reduced-precision matmul mode (TF32) reaches it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sparse_format import TiledCSR

__all__ = [
    "csr_product",
    "sorted_entries",
    "tiled_mm",
    "tiled_mtm",
    "entries_sddmm",
    "tiled_sddmm",
]


def csr_product(rows, cols, vals, D, n_rows):
    """``X @ D`` over entries sorted by row: gather, scale and one
    segment-sum that is told its indices are sorted."""
    return jax.ops.segment_sum(
        vals[:, None] * jnp.take(D, cols, axis=0), rows,
        num_segments=n_rows, indices_are_sorted=True,
    )


def sorted_entries(rows, cols, vals, order):
    """The entries permuted by ``order`` (None: already in that order)."""
    if order is None:
        return rows, cols, vals
    return (jnp.take(rows, order), jnp.take(cols, order),
            jnp.take(vals, order))


def tiled_mm(X: TiledCSR, D):
    """``X @ D`` (p x k)."""
    return csr_product(
        *sorted_entries(X.row_idx, X.col_idx, X.values, X.row_order),
        D, X.shape[0])


def tiled_mtm(X: TiledCSR, D):
    """``X.T @ D`` (n x k)."""
    return csr_product(
        *sorted_entries(X.col_idx, X.row_idx, X.values, X.col_order),
        D, X.shape[1])


def entries_sddmm(rows, cols, W, Ht):
    """``W[rows[e]] . Ht[cols[e]]`` for every entry e.  Compiled for an
    NVIDIA GPU it runs the Triton kernel (``sddmm_kernel.sddmm_triton``,
    measured faster there); on every other platform the plain reference.
    The choice is made per lowering platform, never by interpreting."""
    from .sddmm_kernel import sddmm_reference, sddmm_triton

    def gpu(rows, cols, W, Ht):
        return sddmm_triton(rows, cols, W, Ht).astype(
            jnp.result_type(W.dtype, Ht.dtype))

    return jax.lax.platform_dependent(rows, cols, W, Ht, cuda=gpu,
                                      default=sddmm_reference)


def tiled_sddmm(X: TiledCSR, W, H):
    """Values of ``(W @ H)`` at X's nonzeros, (nnz,) in entry order."""
    return entries_sddmm(X.row_idx, X.col_idx, W, H.T)
