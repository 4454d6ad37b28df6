"""Distributed tall-skinny QR: shifted CholeskyQR3.

``jnp.linalg.qr`` (Householder) is not distributed under GSPMD — on a
row-sharded (p, l) panel XLA gathers the whole panel onto one replica, which
at the 10M-row north-star scale defeats the sharded ``rsvd`` entirely
(VERDICT r2, missing #3).  CholeskyQR maps perfectly onto the mesh instead,
with exactly the collective pattern every solver already uses for its Grams:

* ``G = Y'Y``        — (l x l) Gram: sharded contraction, psum over "rows",
                       result replicated (l = k + oversample <= ~266);
* ``R = chol(G)``    — replicated l x l, every device redundantly;
* ``Q = Y @ R^-1``   — one (p,l)@(l,l) matmul, purely local per row shard.

One CholeskyQR pass loses orthogonality like eps * kappa(Y)^2, so we run
three passes (CholeskyQR2 + one more for rank-deficient safety), with a
small trace-relative shift added to each Gram (shifted CholeskyQR, Fukaya et
al. 2020): exact rank deficiency (an NNDSVD sketch of a low-rank X — e.g.
the laurberg fixture — has l > rank) would make the plain Cholesky fail;
the shift keeps it positive definite and the later passes restore
orthonormality of the completed basis.

The Q factor is basis-equivalent to Householder's (same column space), which
is all ``rsvd`` needs: its final (U, s, V) are invariant to the orthonormal
basis chosen for the sketch (the SVD of ``B = Q'X`` absorbs any rotation /
sign flip of Q's columns).

Behavioral reference: replaces the QR inside the reference's external
``RandomizedLinAlg.rsvd`` (/root/reference/src/initialization.jl:83).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["cholesky_qr"]


def _one_pass(Y, relshift):
    l = Y.shape[1]
    dt = Y.dtype
    # the Gram feeding Cholesky must be exact-f32/f64: reduced-precision
    # Grams can round to indefinite (see the note in models/projals.py)
    G = jnp.matmul(Y.T, Y, precision=jax.lax.Precision.HIGHEST)
    shift = jnp.asarray(relshift, dt) * jnp.trace(G)
    G = G + shift * jnp.eye(l, dtype=dt)
    R = jnp.linalg.cholesky(G, upper=True)
    # Q = Y @ R^-1 keeps the panel row-sharded: Rinv is a replicated l x l
    # triangular solve, the product is local per row block.
    Rinv = jax.scipy.linalg.solve_triangular(R, jnp.eye(l, dtype=dt), lower=False)
    return jnp.matmul(Y, Rinv, precision=jax.lax.Precision.HIGHEST)


def cholesky_qr(Y, *, passes: int = 3):
    """Orthonormal basis of the columns of a tall-skinny (p, l) panel ``Y``,
    computed without ever gathering the panel (row-sharded in, row-sharded
    out).  Returns Q (p, l) with the same column space as ``qr(Y).Q``."""
    l = Y.shape[1]
    eps = jnp.finfo(Y.dtype).eps
    relshift = float(l) * float(eps)
    Q = Y
    for _ in range(max(1, passes)):
        Q = _one_pass(Q, relshift)
    return Q
