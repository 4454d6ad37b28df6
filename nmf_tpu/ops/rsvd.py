"""Randomized SVD (Halko, Martinsson & Tropp 2011) — the device-side
replacement for ``RandomizedLinAlg.rsvd`` which the reference's NNDSVD
initialization calls (/root/reference/src/initialization.jl:83).

Design: sketch ``Y = X @ Omega`` is one big sharded matmul (the only pass
over X besides the optional power iterations); the tall-skinny QR is a
**distributed shifted CholeskyQR3** (``ops.tsqr``) — Gram psum + replicated
l x l Cholesky + local back-substitution, so the p-row panel is never
gathered — and only the small (l x n after projection) SVD runs replicated.
With X sharded (rows, cols) the sketch reduces over the column axis (one
all-reduce of a p x l panel per power iteration).  Oversampling and power
iterations default on (the reference's ``rsvd(X, k)`` uses none) — strictly
better singular triplets for the same init contract.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import matops
from .tsqr import cholesky_qr

__all__ = ["rsvd"]


@partial(jax.jit, static_argnums=(2, 3, 4))
def _rsvd_impl(X, key, k, oversample, n_iter):
    p, n = X.shape
    l = min(k + oversample, min(p, n))
    dt = X.dtype
    omega = jax.random.normal(key, (n, l), dtype=dt)
    Y = matops.mm(X, omega)  # (p, l) sketch
    Q = cholesky_qr(Y)
    Xt = matops.transpose(X)
    for _ in range(n_iter):
        Z = cholesky_qr(matops.mm(Xt, Q))
        Q = cholesky_qr(matops.mm(X, Z))
    B = matops.mtm(Q.T, X)  # (l, n)
    Ub, s, Vt = jnp.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    return U[:, :k], s[:k], Vt[:k, :].T


def rsvd(X, k: int, *, oversample: int = 10, n_iter: int = 2, key=None):
    """Rank-k randomized SVD of X.  Returns ``(U, s, V)`` with U (p x k),
    s (k,), V (n x k) — the slicing contract NNDSVD expects
    (src/initialization.jl:83)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if not matops.is_sparse(X):
        X = jnp.asarray(X)
    return _rsvd_impl(X, key, int(k), int(oversample), int(n_iter))
