"""Sharding layout for the NMF problem.

One layout serves every solver (SURVEY.md §2B / §7):

* ``X : P("rows", "cols")`` — the data matrix is 2-D block-sharded;
* ``W : P("rows", None)``   — row-parallel, k replicated;
* ``H : P(None, "cols")``   — column-parallel, k replicated;
* every k x k Gram (W'W, HH', P) and every k-vector is **replicated** —
  GSPMD materializes them via psum all-reduces over the mesh.

All solver code is sharding-agnostic jnp; placing the inputs with these
shardings is enough for GSPMD to insert the collectives:

* ``W' X``  (k x n, row-sharded contraction)  -> psum over "rows", result
  sharded P(None, "cols");
* ``X H'``  (p x k)                            -> psum over "cols", result
  sharded P("rows", None);
* ``W' W`` / ``H H'``                          -> psum to replicated k x k;
* elementwise factor updates stay local; the convergence test is two
  k-vector reductions + a scalar all-reduce.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import COLS, ROWS

__all__ = [
    "x_sharding",
    "w_sharding",
    "h_sharding",
    "replicated",
    "shard_problem",
    "constrain",
]


def x_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS, COLS))


def w_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS, None))


def h_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(None, COLS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_problem(mesh: Mesh, X, W, H):
    """Place (X, W, H) with the canonical layout.

    Sparse X is first-class (the reference's one-entry-point genericity
    contract, /root/reference/src/interf.jl:3-13): a ``TiledCSR`` or BCOO is
    rebuilt as a 2-D ``ShardedTiled`` over the mesh; a prebuilt
    ``ShardedTiled`` passes through (its mesh must match)."""
    from ..ops import matops

    if matops.is_sharded_tiled(X):
        if X.mesh is not None and X.mesh != mesh:
            raise ValueError(
                "X is a ShardedTiled built for a different mesh; rebuild it "
                "with shard_tiled(..., mesh) or pass its own mesh to nnmf."
            )
    elif matops.is_tiled(X):
        import numpy as np

        from ..ops.sparse_shard import shard_tiled

        X = shard_tiled(
            np.asarray(X.row_idx), np.asarray(X.col_idx), np.asarray(X.values),
            X.shape, mesh,
        )
    elif matops.is_sparse(X):  # BCOO
        import numpy as np

        from ..ops.sparse_shard import shard_tiled

        idx = np.asarray(X.indices)
        X = shard_tiled(idx[:, 0], idx[:, 1], np.asarray(X.data), X.shape, mesh)
    else:
        X = jax.device_put(X, x_sharding(mesh))
    W = jax.device_put(W, w_sharding(mesh))
    H = jax.device_put(H, h_sharding(mesh))
    return X, W, H


def constrain(mesh: Mesh, X=None, W=None, H=None):
    """``with_sharding_constraint`` helpers for use inside jitted bodies."""
    out = []
    if X is not None:
        out.append(jax.lax.with_sharding_constraint(X, x_sharding(mesh)))
    if W is not None:
        out.append(jax.lax.with_sharding_constraint(W, w_sharding(mesh)))
    if H is not None:
        out.append(jax.lax.with_sharding_constraint(H, h_sharding(mesh)))
    return tuple(out) if len(out) != 1 else out[0]
