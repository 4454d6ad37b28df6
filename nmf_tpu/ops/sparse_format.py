"""Sparse store for one device: X's nonzeros as CSR-order entries.

A ``TiledCSR`` holds each nonzero once, as an entry (row, col, value) in
row-major order, plus the order that sorts the entries by column.  The
products (``nmf_tpu.ops.tiled``) are a gather, scale and sorted segment-sum
over the entries in one of the two orders, and the SDDMM samples ``W @ H``
at every entry.  Elementwise value updates (the divergence sweep's
``Q = X / (WH + delta)``) replace ``values`` and keep the pattern.

The host build sorts the COO input once (the native radix sort in
``nmf_tpu.io.loader`` when it is built, numpy otherwise).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..models.common import data_field, static_field

__all__ = [
    "TiledCSR",
    "build_tiled",
    "from_bcoo",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TiledCSR:
    """X (p x n) as CSR-order entries.

    ``row_order`` / ``col_order`` are (nnz,) int32 orders of the entries
    that sort them by row and by column; None means the entries already are
    in that order.  ``build_tiled`` sorts the entries by row, so
    ``row_order`` starts None; ``transpose()`` swaps the two.
    """

    row_idx: jax.Array = data_field()  # (nnz,) int32
    col_idx: jax.Array = data_field()  # (nnz,) int32
    values: jax.Array = data_field()  # (nnz,)
    shape: tuple[int, int] = static_field(default=(0, 0))
    # (sum, sum of squares, min) of the values, as ShardedTiled keeps them:
    # sq_norm/total_sum/all_nonneg read these instead of the values
    stats: jax.Array | None = data_field(default=None)
    row_order: jax.Array | None = data_field(default=None)
    col_order: jax.Array | None = data_field(default=None)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self):
        return self.values.shape[0]

    @property
    def ndim(self):
        return 2

    def with_values(self, new_values):
        """Same pattern, new values (in entry order)."""
        v32 = new_values.astype(jnp.float32)
        return dataclasses.replace(
            self,
            values=new_values,
            stats=jnp.stack([jnp.sum(v32), jnp.sum(v32 * v32), jnp.min(v32)]),
        )

    def transpose(self):
        return dataclasses.replace(
            self,
            row_idx=self.col_idx,
            col_idx=self.row_idx,
            row_order=self.col_order,
            col_order=self.row_order,
            shape=(self.shape[1], self.shape[0]),
        )


def value_stats(vals) -> np.ndarray:
    """(sum, sum of squares, min) of host values, accumulated in float64."""
    v = np.asarray(vals)
    return np.asarray(
        [v.sum(dtype=np.float64), (v.astype(np.float64) ** 2).sum(),
         v.min() if len(v) else 0.0],
        np.float64,
    )


def build_tiled(rows, cols, vals, shape) -> TiledCSR:
    """Build the store from COO data (deduplicated: duplicate coordinates
    would be summed by the products but counted twice by the SDDMM)."""
    from ..io.loader import gather3, stable_argsort

    p, n = shape
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    # == lexsort((cols, rows)); the fused-key stable argsort is ~10x faster
    so = stable_argsort(rows.astype(np.int64) * n + cols)
    rows, cols, vals = gather3(so, rows, cols, vals)
    # entries are (row, col)-sorted; the stable sort by column gives the
    # (col, row) order of the transposed products
    col_order = stable_argsort(cols.astype(np.int64)).astype(np.int32)
    return TiledCSR(
        jnp.asarray(rows),
        jnp.asarray(cols),
        jnp.asarray(vals),
        (p, n),
        stats=jnp.asarray(value_stats(vals), jnp.float32),
        col_order=jnp.asarray(col_order),
    )


def from_bcoo(X) -> TiledCSR:
    idx = np.asarray(X.indices)
    return build_tiled(idx[:, 0], idx[:, 1], np.asarray(X.data), X.shape)
