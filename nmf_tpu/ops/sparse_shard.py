"""Sharded sparse store: the multi-device sparse products.

2-D decomposition matching the canonical dense layout (X: P(rows, cols)):
device (i, j) owns the nonzeros whose row falls in row block i and column in
column block j, held as that block's own CSR-order entries in local
coordinates (the one-device layout of ``sparse_format.TiledCSR``), with the
order that sorts them by column.  Each device runs the one-device products
of ``nmf_tpu.ops.tiled`` on its block:

* ``X @ D`` (p x k): D is row-sharded over the mesh "cols" axis (each device
  holds exactly its column block), every device runs ``csr_product`` over
  its entries, and the partial results are psum-reduced over "cols": the
  output lands row-sharded, the canonical W sharding ``P("rows", None)``.
* ``X' @ D`` (n x k): the same over the column-sorted entries, D sharded over
  "rows", psum over "rows", output in the canonical H' layout
  ``P("cols", None)``.
* SDDMM: ``entries_sddmm`` on each block, W row-sharded and H
  column-sharded; no collective.

So each HALS/MU sweep on sparse X needs no resharding of the factors, and
one (local rows x k) psum per product.

Every device's entries are padded to one length L, so the stacked (R, C, L)
arrays are jit/shard_map friendly.  Padding entries sit at the block's last
local row and column with value 0: they keep both orders sorted and add
nothing.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.common import data_field, static_field
from ..parallel.mesh import COLS, ROWS
from .sparse_format import value_stats
from .tiled import csr_product, entries_sddmm, sorted_entries

__all__ = [
    "ShardedTiled",
    "shard_tiled",
    "sharded_mm",
    "sharded_mtm",
    "sharded_sddmm",
    "sharded_scale_values",
    "sharded_nnz_values",
    "sharded_col_ids",
    "sharded_colsums",
    "sharded_rowsums",
    "sharded_load_stats",
]

_BLOCK = P(ROWS, COLS, None)  # the (R, C, L) entry arrays


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedTiled:
    """2-D sharded sparse matrix for the mesh-parallel products.

    ``rows``/``cols``/``vals`` are (R, C, L): block (i, j)'s entries in
    local coordinates, sorted by row; ``col_order`` sorts each block's
    entries by column.  ``stats`` = (sum, sum of squares, min) of the values
    — enough for validation, mean() and the Gram-identity MSE objective.
    ``transposed`` flips the orientation logically (``transpose()`` is
    free).
    """

    rows: jax.Array = data_field()
    cols: jax.Array = data_field()
    vals: jax.Array = data_field()
    col_order: jax.Array = data_field()
    stats: jax.Array = data_field(default=None)
    shape: tuple[int, int] = static_field(default=(0, 0))
    mesh_shape: tuple[int, int] = static_field(default=(1, 1))
    transposed: bool = static_field(default=False)
    mesh: Mesh | None = static_field(default=None)
    local_rows: int = static_field(default=0)  # rows per block row
    local_cols: int = static_field(default=0)  # cols per block column
    # nonzeros per block ((R, C) nested tuple, agreed at build)
    block_nnz: tuple | None = static_field(default=None)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ndim(self):
        return 2

    def transpose(self):
        return dataclasses.replace(
            self,
            shape=(self.shape[1], self.shape[0]),
            transposed=not self.transposed,
        )


def _assemble(mesh, blocks, L, name):
    """Global (R, C, L) array from the per-block host arrays this process
    owns (``blocks[(i, j)][name]``)."""
    R, C = mesh.shape[ROWS], mesh.shape[COLS]

    def cb(index):
        key = (index[0].start or 0, index[1].start or 0)
        return blocks[key][name][None, None]

    return jax.make_array_from_callback(
        (R, C, L), NamedSharding(mesh, _BLOCK), cb
    )


def shard_tiled(rows, cols, vals, shape, mesh: Mesh, *,
                local: bool = False) -> ShardedTiled:
    """Build the 2-D sharded store from COO data (deduplicated) for ``mesh``.

    **Process-local**: each process sorts and materializes only the blocks
    owned by its own devices.  Cross-process agreement is two tiny
    allgathers (the per-block nonzero counts, which fix the padded length,
    and the value stats); the global arrays are assembled with
    ``jax.make_array_from_callback``.

    ``local=False`` (default): every process passes the full COO and keeps
    its share (the single-host path).  ``local=True``: each process passes
    only its own nonzeros (e.g. from its input-file shard); entries that
    belong to another process's blocks raise.
    """
    from ..io.loader import gather3, stable_argsort

    p, n = shape
    R, C = mesh.shape[ROWS], mesh.shape[COLS]
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    local_p = max(1, -(-p // R))
    local_n = max(1, -(-n // C))

    multiproc = jax.process_count() > 1
    pid = jax.process_index()
    dev_grid = np.asarray(mesh.devices)
    own = np.asarray([
        (not multiproc) or dev_grid[i, j].process_index == pid
        for i in range(R) for j in range(C)
    ])
    blk = (rows // local_p).astype(np.int64) * C + cols // local_n
    mine = own[blk]
    if not mine.all():
        if local:
            raise ValueError(
                "local=True: some nonzeros fall in blocks owned by other "
                "processes; pass each process only its own entries."
            )
        rows, cols, vals, blk = rows[mine], cols[mine], vals[mine], blk[mine]
    lr = (rows - (blk // C) * local_p).astype(np.int32)
    lc = (cols - (blk % C) * local_n).astype(np.int32)
    # one sort by (block, local row, local col) puts every block's entries
    # in CSR order, contiguous
    so = stable_argsort((blk * local_p + lr) * local_n + lc)
    lr, lc, sv = gather3(so, lr, lc, vals)
    counts = np.bincount(blk, minlength=R * C)
    starts = np.cumsum(counts) - counts

    stats = value_stats(vals)
    agree = counts.astype(np.int64)
    if multiproc:
        from jax.experimental import multihost_utils

        # each block is owned by exactly one process: the max assembles
        # the grid
        agree = multihost_utils.process_allgather(agree).reshape(
            -1, R * C).max(axis=0)
        if not len(vals):
            stats[2] = np.inf  # no values here: take no part in the min
        sg = multihost_utils.process_allgather(stats).reshape(-1, 3)
        stats = np.asarray([sg[:, 0].sum(), sg[:, 1].sum(), sg[:, 2].min()])
        if not np.isfinite(stats[2]):
            stats[2] = 0.0
    L = max(1, int(agree.max()))

    blocks = {}
    for b in np.flatnonzero(own):
        s, c = starts[b], counts[b]
        r = np.full(L, local_p - 1, np.int32)
        cc = np.full(L, local_n - 1, np.int32)
        v = np.zeros(L, np.float32)
        r[:c], cc[:c], v[:c] = lr[s:s + c], lc[s:s + c], sv[s:s + c]
        blocks[(b // C, b % C)] = dict(
            rows=r, cols=cc, vals=v,
            col_order=stable_argsort(cc.astype(np.int64)).astype(np.int32),
        )
    arrs = {nm: _assemble(mesh, blocks, L, nm)
            for nm in ("rows", "cols", "vals", "col_order")}
    return ShardedTiled(
        **arrs,
        stats=jnp.asarray(stats, jnp.float32),
        shape=(p, n),
        mesh_shape=(R, C),
        mesh=mesh,
        local_rows=local_p,
        local_cols=local_n,
        block_nnz=tuple(tuple(int(v) for v in row)
                        for row in agree.reshape(R, C)),
    )


@partial(jax.jit, static_argnames=("mesh", "transposed"))
def _sharded_matmul(X: ShardedTiled, D, mesh, transposed=False):
    """``X @ D`` of the stored orientation, or ``X' @ D`` when
    ``transposed``."""
    from jax import shard_map

    R, C = X.mesh_shape
    if transposed:
        axis_out, axis_red = COLS, ROWS
        n_in, n_out = X.local_rows * R, X.local_cols
    else:
        axis_out, axis_red = ROWS, COLS
        n_in, n_out = X.local_cols * C, X.local_rows
    Dp = jnp.pad(D, ((0, n_in - D.shape[0]), (0, 0)))

    def local_fn(r, c, v, o, Dl):
        r, c, v, o = r[0, 0], c[0, 0], v[0, 0], o[0, 0]
        if transposed:
            out = csr_product(*sorted_entries(c, r, v, o), Dl, n_out)
        else:
            out = csr_product(r, c, v, Dl, n_out)
        return jax.lax.psum(out, axis_red)

    out = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(_BLOCK,) * 4 + (P(axis_red, None),),
        out_specs=P(axis_out, None),
        check_vma=False,
    )(X.rows, X.cols, X.vals, X.col_order, Dp)
    # physical output length of this orientation (independent of any
    # logical transpose flag on X)
    phys_rows = X.shape[1] if (transposed != X.transposed) else X.shape[0]
    return out[:phys_rows]


def sharded_mm(X: ShardedTiled, D, mesh=None):
    """``X @ D`` -> (p, k), output sharded P("rows", None) (or the
    transposed product when X is logically transposed)."""
    return _sharded_matmul(X, D, mesh or X.mesh, X.transposed)


def sharded_mtm(X: ShardedTiled, D, mesh=None):
    """``X' @ D`` -> (n, k), output sharded P("cols", None)."""
    return _sharded_matmul(X, D, mesh or X.mesh, not X.transposed)


# ---------------------------------------------------------------------------
# Per-nonzero ops (SDDMM / value updates / index vectors)
#
# The "nnz vector" of a ShardedTiled is its (R, C, L) entry layout, sharded
# P("rows", "cols", None), padding entries holding 0.  sddmm / nnz_values /
# col_ids / scale_values all speak this layout, so solver code (multdiv's Q
# update, the KL objective, SPA's column normalization) composes them exactly
# like the flat (nnz,) one-device vectors.  Every op is local per device.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh",))
def _sharded_sddmm_impl(X: ShardedTiled, W, H, mesh):
    from jax import shard_map

    R, C = X.mesh_shape
    Wp = jnp.pad(W, ((0, X.local_rows * R - W.shape[0]), (0, 0)))
    Htp = jnp.pad(H.T, ((0, X.local_cols * C - H.shape[1]), (0, 0)))

    def local_fn(Wl, Htl, r, c):
        return entries_sddmm(r[0, 0], c[0, 0], Wl, Htl)[None, None]

    return shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(ROWS, None), P(COLS, None), _BLOCK, _BLOCK),
        out_specs=_BLOCK,
        check_vma=False,
    )(Wp, Htp, X.rows, X.cols)


def sharded_sddmm(X: ShardedTiled, W, H, mesh=None):
    """``(W @ H)`` sampled at X's nonzeros, in the (R, C, L) entry layout
    (aligned with ``sharded_nnz_values``)."""
    if X.transposed:
        # pattern of X' at (c, r) samples (W@H)[c, r] = (H' W')[r, c]
        W, H = H.T, W.T
    return _sharded_sddmm_impl(X, W, H, mesh or X.mesh)


def sharded_scale_values(X: ShardedTiled, new_values) -> ShardedTiled:
    """Same pattern, new values (entry layout).  ``stats`` are recomputed
    so ``matops.sq_norm``/``mean``/``all_nonneg`` stay correct (padding
    entries must hold 0, which leaves sum and sum of squares alone and
    ``min >= 0`` true exactly when it is over the real nonzeros)."""
    new_values = new_values.astype(X.vals.dtype)
    v32 = new_values.astype(jnp.float32)
    stats = jnp.stack([jnp.sum(v32), jnp.sum(v32 * v32), jnp.min(v32)])
    return dataclasses.replace(X, vals=new_values, stats=stats)


def sharded_nnz_values(X: ShardedTiled):
    """Values in the (R, C, L) entry layout; padding entries are 0."""
    return X.vals


def sharded_col_ids(X: ShardedTiled):
    """Global column index per entry (row index when X is logically
    transposed).  Padding entries carry an in-range index; every consumer
    weights by their zero value."""
    R, C = X.mesh_shape
    if X.transposed:
        ids = X.rows + (jnp.arange(R, dtype=jnp.int32) * X.local_rows)[
            :, None, None]
    else:
        ids = X.cols + (jnp.arange(C, dtype=jnp.int32) * X.local_cols)[
            None, :, None]
    return jnp.minimum(ids, X.shape[1] - 1)


def sharded_load_stats(X: ShardedTiled) -> dict:
    """Per-device load report: nonzeros per (row block, column block), the
    padded entry count every device runs, and the max/mean imbalance.  The
    sweep rate is set by the slowest device, i.e. by data skew across the
    block grid.  Read from the counts agreed at build time, so no device
    round-trip."""
    nnz = np.asarray(X.block_nnz, np.int64)
    mean = float(nnz.mean())
    return {
        "total_nnz": nnz,
        "padded_entries_per_device": int(X.vals.shape[2]),
        "imbalance_max_over_mean": float(nnz.max()) / mean if mean else 1.0,
    }


def sharded_colsums(X: ShardedTiled):
    ones = jnp.ones((X.shape[0], 1), X.dtype)
    return sharded_mtm(X, ones)[:, 0]


def sharded_rowsums(X: ShardedTiled):
    ones = jnp.ones((X.shape[1], 1), X.dtype)
    return sharded_mm(X, ones)[:, 0]
